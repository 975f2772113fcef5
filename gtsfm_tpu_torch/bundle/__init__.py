"""Bundle adjustment: LM with Schur-complement camera reduction (reference
gtsfm/bundle/bundle_adjustment.py, GTSAM factor graph + LM)."""
