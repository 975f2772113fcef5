"""Benchmark of the PyTorch/CUDA port (gtsfm_tpu_torch): one cell per run,
driven by BENCHMARK.json and the files under this folder (see run.py)."""
