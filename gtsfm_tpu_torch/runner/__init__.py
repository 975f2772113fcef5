"""CLI runner (reference gtsfm/runner/): ``python -m gtsfm_tpu_torch.runner``."""
