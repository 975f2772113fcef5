"""Process-graph generation: the configured pipeline as DOT + SVG.

Port of gtsfm_tpu/ui/process_graph.py (host Python; the same DOT text for
the same configuration). Mirrors reference
gtsfm/ui/process_graph_generator.py:33 (pydot DOT/SVG dataflow diagram from
GTSFMProcess registry metadata). Here stage metadata is declared directly
and rendered to DOT; SVG via graphviz `dot` when present, with a
pure-python SVG fallback (layered layout) so no binary is required.
"""

from __future__ import annotations

import html
import os
import shutil
import subprocess
from dataclasses import dataclass, field


@dataclass
class Stage:
    name: str
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)


def pipeline_stages(config) -> list[Stage]:
    """Stage graph for the configured pipeline."""
    fe = config.frontend
    stages = [
        Stage("Loader", [], ["images", "intrinsics"]),
        Stage(f"Retriever ({config.retriever.regime})", ["images"], ["image pairs"]),
        Stage(f"Detector ({fe.feature_type})", ["images"], ["keypoints", "descriptors"]),
        Stage(f"Matcher ({fe.matcher_type})", ["descriptors", "image pairs"], ["correspondences"]),
        Stage("Two-view RANSAC + BA", ["correspondences", "intrinsics"], ["relative poses", "inliers"]),
        Stage("View-graph filter (cycles)", ["relative poses"], ["filtered edges"]),
        Stage("Rotation averaging (staircase)", ["filtered edges"], ["global rotations"]),
        Stage("Translation averaging (1dSFM)", ["filtered edges", "global rotations"], ["global translations"]),
        Stage("DSF tracks", ["inliers"], ["2d tracks"]),
        Stage("Triangulation (RANSAC)", ["2d tracks", "global rotations", "global translations"], ["3d points"]),
        Stage("Global bundle adjustment", ["3d points"], ["refined scene"]),
        Stage("COLMAP export + metrics", ["refined scene"], ["ba_output/", "result_metrics/"]),
    ]
    return stages


def to_dot(stages: list[Stage]) -> str:
    lines = [
        "digraph pipeline {",
        "  rankdir=TB; node [shape=box, style=rounded, fontname=Helvetica];",
    ]
    products = {}
    for s in stages:
        lines.append(f'  "{s.name}" [fillcolor="#e8f0fe", style="rounded,filled"];')
        for out in s.outputs:
            products[out] = s.name
    for s in stages:
        for inp in s.inputs:
            if inp in products:
                lines.append(f'  "{products[inp]}" -> "{s.name}" [label="{inp}", fontsize=9];')
    lines.append("}")
    return "\n".join(lines)


def _fallback_svg(stages: list[Stage]) -> str:
    """Simple layered SVG when graphviz isn't installed."""
    w, row_h = 460, 54
    h = row_h * len(stages) + 20
    parts = [f'<svg width="{w}" height="{h}" xmlns="http://www.w3.org/2000/svg">']
    for i, s in enumerate(stages):
        y = 10 + i * row_h
        parts.append(
            f'<rect x="60" y="{y}" width="340" height="36" rx="8" fill="#e8f0fe" stroke="#4878b0"/>'
            f'<text x="230" y="{y + 23}" text-anchor="middle" font-size="13" font-family="Helvetica">'
            f"{html.escape(s.name)}</text>"
        )
        if i:
            parts.append(
                f'<line x1="230" y1="{y - row_h + 46}" x2="230" y2="{y}" '
                'stroke="#666" marker-end="url(#a)"/>'
            )
    parts.insert(
        1,
        '<defs><marker id="a" markerWidth="8" markerHeight="8" refX="6" refY="3" '
        'orient="auto"><path d="M0,0 L6,3 L0,6 z" fill="#666"/></marker></defs>',
    )
    parts.append("</svg>")
    return "".join(parts)


def save_process_graph(config, out_dir: str) -> str:
    """Write pipeline DOT + SVG (reference saves plots/process_graph)."""
    os.makedirs(out_dir, exist_ok=True)
    stages = pipeline_stages(config)
    dot = to_dot(stages)
    dot_path = os.path.join(out_dir, "process_graph.dot")
    with open(dot_path, "w") as f:
        f.write(dot)
    svg_path = os.path.join(out_dir, "process_graph.svg")
    if shutil.which("dot"):
        try:
            subprocess.run(
                ["dot", "-Tsvg", dot_path, "-o", svg_path], check=True, timeout=30,
                capture_output=True,
            )
            return svg_path
        except Exception:
            pass
    with open(svg_path, "w") as f:
        f.write(_fallback_svg(stages))
    return svg_path
