"""SVG export of stroke sketches.

The port of ``sketch_rnn_tpu/sample/svg.py``: the stroke-3 polylines as
SVG paths, pen lifts splitting subpaths, by string assembly on the host
with no drawing library. Its output is byte for byte the JAX module's
(``tests/test_torch_sample.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from sketch_rnn_tpu_torch.data import strokes as S


def strokes_to_svg(stroke3: np.ndarray, factor: float = 0.2,
                   padding: float = 10.0, stroke_width: float = 1.0,
                   color: str = "black",
                   path: Optional[str] = None) -> str:
    """Render one stroke-3 sketch to an SVG document string.

    ``factor`` scales data units to pixels (canonical default 0.2 for
    QuickDraw-scale data). Writes to ``path`` as well when given.
    """
    lines = S.strokes_to_lines(np.asarray(stroke3, np.float32))
    pts = [p for line in lines for p in line]
    if not pts:
        pts = [(0.0, 0.0)]
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    min_x, max_x = min(xs), max(xs)
    min_y, max_y = min(ys), max(ys)
    sx = lambda x: (x - min_x) / factor + padding
    sy = lambda y: (y - min_y) / factor + padding
    w = (max_x - min_x) / factor + 2 * padding
    h = (max_y - min_y) / factor + 2 * padding

    parts = []
    for line in lines:
        if not line:
            continue
        x0, y0 = line[0]
        d = [f"M{sx(x0):.2f},{sy(y0):.2f}"]
        d += [f"L{sx(x):.2f},{sy(y):.2f}" for x, y in line[1:]]
        parts.append(
            f'<path d="{" ".join(d)}" fill="none" stroke="{color}" '
            f'stroke-width="{stroke_width}" stroke-linecap="round" '
            f'stroke-linejoin="round"/>')
    svg = (f'<svg xmlns="http://www.w3.org/2000/svg" '
           f'width="{w:.0f}" height="{h:.0f}" '
           f'viewBox="0 0 {w:.2f} {h:.2f}">\n'
           + "\n".join(parts) + "\n</svg>\n")
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(svg)
    return svg


def svg_grid(sketches: Sequence[np.ndarray], cols: int = 5,
             cell: float = 160.0,
             path: Optional[str] = None) -> str:
    """Render many sketches in a grid (the notebook's side-by-side view).

    Each sketch is auto-scaled to fit its cell (no ``factor``: grid cells
    normalize scale per sketch by design).
    """
    n = len(sketches)
    cols = max(1, min(cols, n))
    rows = (n + cols - 1) // cols
    w, h = cols * cell, rows * cell
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:.0f}" '
           f'height="{h:.0f}" viewBox="0 0 {w:.2f} {h:.2f}">']
    for i, sk in enumerate(sketches):
        lines = S.strokes_to_lines(np.asarray(sk, np.float32))
        pts = [p for line in lines for p in line]
        if not pts:
            continue
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        span = max(max(xs) - min(xs), max(ys) - min(ys), 1e-6)
        scale = (cell * 0.85) / span
        ox = (i % cols) * cell + cell * 0.075 - min(xs) * scale
        oy = (i // cols) * cell + cell * 0.075 - min(ys) * scale
        for line in lines:
            if not line:
                continue
            d = [f"M{line[0][0] * scale + ox:.2f},{line[0][1] * scale + oy:.2f}"]
            d += [f"L{x * scale + ox:.2f},{y * scale + oy:.2f}"
                  for x, y in line[1:]]
            out.append(f'<path d="{" ".join(d)}" fill="none" stroke="black" '
                       f'stroke-width="1.5" stroke-linecap="round"/>')
    out.append("</svg>\n")
    svg = "\n".join(out)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(svg)
    return svg
