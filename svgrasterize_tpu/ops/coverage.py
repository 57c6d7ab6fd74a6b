"""Anti-aliased signed-coverage rasterization (device, XLA).

This replaces the reference's scalar font-rs scanline loop
(/root/reference/svgrasterize.py:2213-2304) with a closed-form, branch-free
per-pixel formulation that maps directly onto dense vector hardware:

For an edge (a line segment) and a pixel cell (r, c), clip the edge to the
row slab [r, r+1] giving a linear function X(y) over [y_lo, y_hi].  The
edge's contribution to the pixel's winding-with-fractional-coverage is

    sign(dy) * (y_hi - y_lo) * mean_y clamp((c + 1) - X(y), 0, 1)

The mean of a clamped linear function has a closed form via the antiderivative
C(t) = 0 (t<=0) | t^2/2 (0<t<1) | t-1/2 (t>=1):  (C(g1) - C(g0)) / (g1 - g0).

Summing over all edges yields *exactly* the same value as the reference's
accumulate-then-cumsum algorithm (both compute the exact signed trapezoid
areas), but every (edge, pixel) pair is independent — a perfect fit for dense
vector hardware.  Work is O(S * H * W) per call, so callers tile by path bbox
(see render.py) or by canvas tiles (see ops/batch_exec.py) to keep S
small per region.

Boundary semantics match the reference: rows outside [0, H) are dropped,
columns clamp on the left (area left of column 0 counts fully) and drop on
the right.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.constants import DEVICE_FLOAT

# segments per scan step: bounds the (chunk, H, W) intermediate for
# typical bucketed path bboxes.
_CHUNK = 32


def clamp_antideriv(t):
    """Antiderivative of clamp(t, 0, 1)."""
    return jnp.where(t <= 0, 0.0, jnp.where(t >= 1, t - 0.5, 0.5 * t * t))


def _chunk_winding(lines, rows, cols):
    """Winding contribution of a chunk of edges.

    lines: (C, 4) rows [a0, a1, b0, b1] — endpoints in (row, col) coords.
    rows: (H, 1) row indices; cols: (W,) column indices.
    Returns (H, W).
    """
    a0, a1, b0, b1 = lines[:, 0], lines[:, 1], lines[:, 2], lines[:, 3]
    sign = jnp.sign(b0 - a0)[:, None, None]  # (C,1,1); 0 for horizontal
    y_lo_seg = jnp.minimum(a0, b0)
    y_hi_seg = jnp.maximum(a0, b0)
    x_at_lo = jnp.where(a0 <= b0, a1, b1)
    x_at_hi = jnp.where(a0 <= b0, b1, a1)
    dy_seg = y_hi_seg - y_lo_seg
    slope = (x_at_hi - x_at_lo) / jnp.where(dy_seg > 0, dy_seg, 1.0)

    # clip each edge to each row slab
    lo = jnp.maximum(y_lo_seg[:, None, None], rows)          # (C,H,1)
    hi = jnp.minimum(y_hi_seg[:, None, None], rows + 1.0)    # (C,H,1)
    dy = jnp.maximum(hi - lo, 0.0)                           # (C,H,1)
    x_lo = x_at_lo[:, None, None] + slope[:, None, None] * (lo - y_lo_seg[:, None, None])
    x_hi = x_at_lo[:, None, None] + slope[:, None, None] * (hi - y_lo_seg[:, None, None])

    # per-column clamped-mean of (c+1) - X(y)
    g0 = (cols + 1.0) - x_lo                                 # (C,H,W)
    g1 = (cols + 1.0) - x_hi
    den = g1 - g0
    safe = jnp.abs(den) > 1e-7
    mean = jnp.where(
        safe,
        (clamp_antideriv(g1) - clamp_antideriv(g0)) / jnp.where(safe, den, 1.0),
        jnp.clip(0.5 * (g0 + g1), 0.0, 1.0),
    )
    return jnp.sum(sign * dy * mean, axis=0)                 # (H,W)


def winding_impl(lines, height: int, width: int):
    """Traceable winding computation (see `winding`); call inside jit/shard_map."""
    lines = lines.astype(DEVICE_FLOAT)
    s = lines.shape[0]
    rows = jax.lax.broadcasted_iota(DEVICE_FLOAT, (height, 1), 0)
    cols = jax.lax.broadcasted_iota(DEVICE_FLOAT, (width,), 0)

    if s <= _CHUNK:
        return _chunk_winding(lines, rows, cols)

    chunks = lines.reshape(s // _CHUNK, _CHUNK, 4)

    def body(acc, chunk):
        return acc + _chunk_winding(chunk, rows, cols), None

    acc, _ = jax.lax.scan(body, jnp.zeros((height, width), DEVICE_FLOAT), chunks)
    return acc


@partial(jax.jit, static_argnums=(1, 2))
def winding(lines, height: int, width: int):
    """Exact AA winding field of a padded edge list.

    lines: (S, 4) float32, S a multiple of the chunk size; degenerate rows
    (all zeros / horizontal) contribute nothing.  Returns (height, width) f32.
    """
    return winding_impl(lines, height, width)


def pad_lines(lines, multiple: int = _CHUNK):
    """Host-side: pad an (S, 2, 2)/(S, 4) edge array to a chunk multiple."""
    import numpy as np

    lines = np.asarray(lines, dtype=DEVICE_FLOAT).reshape(-1, 4)
    s = lines.shape[0]
    target = max(multiple, ((s + multiple - 1) // multiple) * multiple)
    if target != s:
        lines = np.concatenate(
            [lines, np.zeros((target - s, 4), dtype=DEVICE_FLOAT)], axis=0
        )
    return lines


CHUNK = _CHUNK
