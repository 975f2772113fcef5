"""Batched device ops: attention (hand-written Hopper kernel), descriptor
matching, RANSAC verification, homography fitting."""
