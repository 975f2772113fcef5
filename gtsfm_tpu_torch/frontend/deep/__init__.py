"""Deep front-end models in PyTorch: SuperPoint, D2-Net and DISK (detectors),
LightGlue and SuperGlue (matchers), LoFTR (detector-free matching) and
NetVLAD (retrieval).

Each module loads the upstream torch checkpoint layout directly and carries
the JAX package's Flax parameters across with ``params_from_jax``."""

__all__ = ["d2net", "disk", "lightglue", "loftr", "netvlad", "superglue", "superpoint", "weights"]
