"""Core geometry: SO(3)/SE(3)/Sim(3), Cal3Bundler cameras, epipolar
geometry and the Nister five-point solver, batched PyTorch."""
