"""Feature front end: the per-image feature record and the feature cache;
deep detectors and matchers under ``deep/``."""
