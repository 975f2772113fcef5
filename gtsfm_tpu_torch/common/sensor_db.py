"""Sensor-width database for EXIF focal -> pixel focal conversion.

Carried over from gtsfm_tpu/common/sensor_db.py (host-side, no arrays).

Feature parity with reference gtsfm/common/sensor_width_database.py: a
~3.6k-entry (maker, model) -> sensor-width-mm table
(gtsfm_tpu_torch/assets/sensor_database.csv, the same file as the JAX
package's copy, is the reference's
assets/camera_details/sensor_database.csv — a data table of published
camera constants) with the same normalized substring matching: maker
matched on its first token, model compared with spaces/dashes/maker name
stripped, exact-model matches win, ambiguous (2+) fuzzy matches and
no-match both fail the lookup. Implemented over the csv module (no pandas
dependency) with the rows parsed once per process.
"""

from __future__ import annotations

import csv
import functools
import os

_CSV_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "sensor_database.csv",
)


def _norm(s: str, maker: str = "") -> str:
    s = s.lower().replace(" ", "").replace("-", "")
    if maker:
        s = s.replace(maker, "")
    return s


@functools.lru_cache(maxsize=1)
def _rows() -> list[tuple[str, str, float]]:
    """(maker_lower, model_norm, width_mm) rows, parsed once."""
    out = []
    with open(_CSV_PATH, newline="") as f:
        reader = csv.reader(f)
        next(reader)  # header
        for row in reader:
            if len(row) < 3:
                continue
            maker = row[0].strip().lower()
            model = _norm(row[1], maker)
            try:
                width = float(row[2])
            except ValueError:
                continue
            out.append((maker, model, width))
    return out


def lookup(make: str, model: str) -> float | None:
    """Sensor width in mm, or None when not uniquely found.

    Matching mirrors the reference (sensor_width_database.py:27-72): maker
    first-token substring both ways; model substring both ways after
    normalization; exact model returns immediately; otherwise a UNIQUE
    fuzzy match is required (the reference raises LookupError on 0 or 2+
    matches — here None, the caller falls back to the FOV prior).
    """
    make_tokens = make.split() if make else []
    if not make_tokens or not model:
        return None
    q_make = _norm(make_tokens[0])
    q_model = _norm(model, q_make)
    match_count = 0
    width = None
    for db_make, db_model, db_width in _rows():
        if not (q_make in db_make or db_make in q_make):
            continue
        if not (q_model in db_model or db_model in q_model):
            continue
        if q_model == db_model:
            return db_width if db_width > 0 else None
        width = db_width
        match_count += 1
        if match_count > 1:
            return None
    if match_count == 1 and width is not None and width > 0:
        return width
    return None
