"""Feature front end: the per-image feature record and SIFT (``sift``), the
classical detectors with ORB and BRISK (``classical``), KAZE (``kaze``), the
detector-free keypoint aggregation (``aggregator``) and the feature cache;
deep detectors and matchers under ``deep/``."""

__all__ = ["aggregator", "cacher", "classical", "kaze", "sift"]
