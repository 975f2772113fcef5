"""Visualization utilities (reference gtsfm/utils/viz.py +
visualization/view_scene.py): correspondence plots, pose trajectories,
scene scatter — matplotlib, saved to files (headless) — and the standalone
web viewer.

The plot functions resolve on first use: importing the package (for the
web viewer, which ``run`` always writes) does not import matplotlib, which
the card's machine may not have.
"""

_PLOTS = ("plot_correspondences", "plot_pose_graph", "plot_scene_3d")


def __getattr__(name):
    if name in _PLOTS:
        from gtsfm_tpu_torch.visualization import plots

        return getattr(plots, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
