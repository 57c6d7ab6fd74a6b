"""Gradient paint servers evaluated on device (elementwise).

Linear gradients project pixel coordinates onto the gradient axis; radial
gradients solve the pixman two-circle interpolation equation
(/root/reference/svgrasterize.py:1544-1695).  The host precomposes all
coordinate-space transforms into a single affine matrix so the device only
sees: affine -> offset field -> spread -> piecewise-linear stop lookup.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.constants import DEVICE_FLOAT

SPREAD_PAD = "pad"
SPREAD_REPEAT = "repeat"
SPREAD_REFLECT = "reflect"


def pixel_grid(height: int, width: int, offset0: float, offset1: float):
    """Pixel-center coordinates (h, w, 2) for a viewport at (offset0, offset1)."""
    r = jax.lax.broadcasted_iota(DEVICE_FLOAT, (height, width), 0) + (offset0 + 0.5)
    c = jax.lax.broadcasted_iota(DEVICE_FLOAT, (height, width), 1) + (offset1 + 0.5)
    return jnp.stack([r, c], axis=-1)


def apply_affine(points, matrix):
    """Apply a 2x3 affine (rows of [a, b, t]) to (..., 2) points."""
    m = matrix[:, :2]
    t = matrix[:, 2]
    # pixel coordinates reach the thousands: a reduced-precision (TF32)
    # contraction would shift gradients visibly
    return jnp.matmul(points, m.T, precision=jax.lax.Precision.HIGHEST) + t


def spread(offsets, mode: str):
    if mode == SPREAD_PAD:
        return offsets
    if mode == SPREAD_REPEAT:
        # fractional part, sign-preserving (numpy modf semantics, ref :1665)
        return offsets - jnp.trunc(offsets)
    if mode == SPREAD_REFLECT:
        return jnp.abs(jnp.remainder(offsets + 1.0, 2.0) - 1.0)
    raise ValueError(f"invalid spread method: {mode}")


def interpolate_stops(offsets, stop_offsets, stop_colors):
    """Piecewise-linear RGBA lookup.

    offsets: (...); stop_offsets: (K,) ascending; stop_colors: (K, 4).
    Boundary/duplicate-stop semantics match the reference interpolator.
    """
    k = stop_offsets.shape[0]
    idx = jnp.clip(jnp.searchsorted(stop_offsets, offsets, side="left"), 1, k - 1)
    o0 = stop_offsets[idx - 1]
    o1 = stop_offsets[idx]
    c0 = stop_colors[idx - 1]
    c1 = stop_colors[idx]
    span = o1 - o0
    ratio = jnp.clip((offsets - o0) / jnp.where(span > 1e-12, span, 1.0), 0.0, 1.0)
    # duplicate offsets are a hard step at the stop position (the reference
    # pair loop skips empty (o, o] intervals, so values above the duplicate
    # take the later color immediately, svgrasterize.py:1680-1683)
    ratio = jnp.where(span > 1e-12, ratio, (offsets >= o1).astype(ratio.dtype))
    ratio = ratio[..., None]
    return (1.0 - ratio) * c0 + ratio * c1


@partial(jax.jit, static_argnames=("height", "width", "spread_method"))
def linear_fill(
    height: int,
    width: int,
    viewport_offset,
    affine,           # (2,3) device-pixel -> gradient space
    p0,               # (2,)
    p1,               # (2,)
    stop_offsets,     # (K,)
    stop_colors,      # (K,4)
    spread_method: str = SPREAD_PAD,
):
    pixels = pixel_grid(height, width, viewport_offset[0], viewport_offset[1])
    pixels = apply_affine(pixels, affine)
    vec = p1 - p0
    hi = jax.lax.Precision.HIGHEST
    t = jnp.matmul(pixels - p0, vec, precision=hi) / jnp.maximum(
        jnp.dot(vec, vec, precision=hi), 1e-30
    )
    return interpolate_stops(spread(t, spread_method), stop_offsets, stop_colors)


@partial(jax.jit, static_argnames=("height", "width", "spread_method", "has_focal"))
def radial_fill(
    height: int,
    width: int,
    viewport_offset,
    affine,
    center,           # (2,)
    radius,           # scalar
    fcenter,          # (2,) — equals center when has_focal=False
    fradius,          # scalar
    stop_offsets,
    stop_colors,
    spread_method: str = SPREAD_PAD,
    has_focal: bool = False,
):
    pixels = pixel_grid(height, width, viewport_offset[0], viewport_offset[1])
    pixels = apply_affine(pixels, affine)

    if not has_focal:
        rel = (pixels - center) / radius
        t = jnp.sqrt(jnp.sum(rel * rel, axis=-1))
        return interpolate_stops(spread(t, spread_method), stop_offsets, stop_colors)

    # two-circle (pixman) form: solve ||c(t) - p|| = r(t), keep the larger root
    cd = center - fcenter
    pd = pixels - fcenter
    rd = radius - fradius
    a = jnp.sum(cd * cd) - rd * rd
    b = jnp.sum(pd * cd, axis=-1) + fradius * rd
    c = jnp.sum(pd * pd, axis=-1) - fradius * fradius
    det = b * b - a * c
    valid = det >= 0
    sq = jnp.sqrt(jnp.maximum(det, 0.0))
    a_safe = jnp.where(jnp.abs(a) > 1e-30, a, 1e-30)
    t = jnp.maximum((b + sq) / a_safe, (b - sq) / a_safe)
    # exclude negative interpolated radius r(t)
    valid = jnp.where(
        jnp.abs(fradius - radius) > 1e-12,
        valid & (t > fradius / (fradius - radius)),
        valid,
    )
    out = interpolate_stops(spread(t, spread_method), stop_offsets, stop_colors)
    return jnp.where(valid[..., None], out, 0.0)


def affine_2x3(transform) -> np.ndarray:
    """Host helper: 2x3 device array from a Transform."""
    return np.asarray(transform.m[:2, :], dtype=DEVICE_FLOAT)
