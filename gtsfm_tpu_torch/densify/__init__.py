"""Densification (MVS): plane-sweep or PatchmatchNet depth maps,
geometric-consistency fusion and voxel downsampling of the fused cloud.

Port of gtsfm_tpu/densify/ (reference gtsfm/densify/: the MVSBase API and
the PatchmatchNet engine)."""
