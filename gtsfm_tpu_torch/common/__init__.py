"""Shared containers and utilities (image container, intrinsics guessing)."""
