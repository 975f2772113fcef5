"""Multi-view back end: view-graph filtering, rotation/translation averaging,
track formation, data association (reference gtsfm/multi_view_optimizer.py)."""
