"""Evaluation: metrics containers, pose metrics, reports (reference
gtsfm/evaluation/)."""
