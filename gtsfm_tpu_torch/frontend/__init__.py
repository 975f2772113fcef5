"""Feature front end: the SIFT detector and the per-image feature record
(``sift``), the feature cache; deep detectors and matchers under ``deep/``."""
