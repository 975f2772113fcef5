"""I/O: COLMAP text model read/write, PLY export (reference gtsfm/utils/io.py)."""
