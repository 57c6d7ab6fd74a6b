"""Gaussian blur (feGaussianBlur) as XLA convolutions.

The kernel is constructed in *user space* (so blurs rotate correctly with the
presentation transform — ref svgrasterize.py:1903-1944).  For axis-aligned
transforms the kernel is exactly separable and we run two 1D depthwise convs;
otherwise one 2D depthwise conv.  All convolutions are 'full' so the layer
grows by the kernel extent, matching scipy.signal.convolve semantics.
"""

from __future__ import annotations

import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.constants import DEVICE_FLOAT

# truncate the gaussian at this many sigmas (ref :1924)
_SIGMA_CUTOFF = 2.5


def gaussian_kernel(transform, sigma_user: tuple[float, float]) -> np.ndarray | None:
    """Build the device-space blur kernel for user-space sigmas; None if no-op."""
    sigma_x, sigma_y = sigma_user
    scale_x, scale_y = transform.scale_factors()
    if scale_x * sigma_x < 0.5 and scale_y * sigma_y < 0.5:
        return None  # sub-pixel blur is a no-op
    if scale_x * sigma_x < 0.5:
        sigma_x = 0.5 / scale_x
    elif scale_y * sigma_y < 0.5:
        sigma_y = 0.5 / scale_y

    # device-space bbox of the +-cutoff*sigma user-space box
    box = np.array(
        [
            [-_SIGMA_CUTOFF * sigma_x, -_SIGMA_CUTOFF * sigma_y],
            [-_SIGMA_CUTOFF * sigma_x, _SIGMA_CUTOFF * sigma_y],
            [_SIGMA_CUTOFF * sigma_x, _SIGMA_CUTOFF * sigma_y],
            [_SIGMA_CUTOFF * sigma_x, -_SIGMA_CUTOFF * sigma_y],
        ]
    )
    box = transform.apply_vectors(box)
    lo = box.min(axis=0).astype(int)
    hi = box.max(axis=0).astype(int)
    kh, kw = hi[0] - lo[0], hi[1] - lo[1]
    kh += ~kh & 1  # make odd
    kw += ~kw & 1
    if kh < 1 or kw < 1:
        return None

    # evaluate the user-space gaussian at device pixel centers
    r = np.arange(kh, dtype=np.float64) - kh / 2 + 0.5
    c = np.arange(kw, dtype=np.float64) - kw / 2 + 0.5
    grid = np.stack(np.meshgrid(r, c, indexing="ij"), axis=-1).reshape(-1, 2)
    inv = transform.invert
    user = inv.apply_vectors(grid)
    k = np.exp(-np.square(user) / (2 * np.square([sigma_x, sigma_y])))
    k = k.prod(axis=-1).reshape(kh, kw)
    return (k / k.sum()).astype(DEVICE_FLOAT)


@jax.jit
def convolve_full(image, kernel):
    """Full 2D depthwise convolution: (h, w, ch) * (kh, kw) -> grown image."""
    h, w, ch = image.shape
    kh, kw = kernel.shape
    x = jnp.moveaxis(image, -1, 0)[None]  # NCHW
    # true convolution = cross-correlation with the flipped kernel
    k = kernel[::-1, ::-1]
    k = jnp.broadcast_to(k[None, None], (ch, 1, kh, kw)).astype(image.dtype)
    out = jax.lax.conv_general_dilated(
        x,
        k,
        window_strides=(1, 1),
        padding=[(kh - 1, kh - 1), (kw - 1, kw - 1)],
        feature_group_count=ch,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return jnp.moveaxis(out[0], 0, -1)


def separate_kernel(kernel: np.ndarray):
    """(u, v) with kernel == outer(u, v), or None if not rank-1.

    Axis-aligned gaussian kernels factor exactly (row sums x column sums
    for a normalized kernel), turning a kh*kw-tap conv into kh + kw taps.
    """
    u = kernel.sum(axis=1)
    v = kernel.sum(axis=0)
    s = kernel.sum()
    if s <= 0:
        return None
    if not np.allclose(np.outer(u, v) / s, kernel, atol=1e-7):
        return None
    return u / s, v


@jax.jit
def _convolve_separable_conv(image, u, v):
    """Full separable depthwise convolution: rows by u, columns by v."""
    ch = image.shape[-1]
    kh = u.shape[0]
    kw = v.shape[0]
    x = jnp.moveaxis(image, -1, 0)[None]  # NCHW
    ku = jnp.broadcast_to(u[::-1][None, None, :, None], (ch, 1, kh, 1)).astype(image.dtype)
    kv = jnp.broadcast_to(v[::-1][None, None, None, :], (ch, 1, 1, kw)).astype(image.dtype)
    out = jax.lax.conv_general_dilated(
        x, ku, window_strides=(1, 1), padding=[(kh - 1, kh - 1), (0, 0)],
        feature_group_count=ch, dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    out = jax.lax.conv_general_dilated(
        out, kv, window_strides=(1, 1), padding=[(0, 0), (kw - 1, kw - 1)],
        feature_group_count=ch, dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return jnp.moveaxis(out[0], 0, -1)


def _band_matrix(taps, n_in: int):
    """(n_in + k - 1, n_in) full-convolution operator: B[o, i] = taps[o - i].

    Built on device from the k-tap vector (an (n_out, n_in) iota compare +
    gather), so the compiled program carries only the small tap constant,
    not an n^2 matrix per blur shape."""
    k = taps.shape[0]
    n_out = n_in + k - 1
    o = jax.lax.broadcasted_iota(jnp.int32, (n_out, n_in), 0)
    i = jax.lax.broadcasted_iota(jnp.int32, (n_out, n_in), 1)
    band = o - i
    inside = (band >= 0) & (band < k)
    return jnp.where(inside, jnp.asarray(taps)[jnp.clip(band, 0, k - 1)], 0.0)


@jax.jit
def _convolve_separable_banded(image, u, v):
    """Full separable convolution as two banded-operator matmuls.

    The same contraction as a depthwise conv with C=4, written as
    (h_out, h) @ (h, w*ch) and (h_out*ch, w) @ (w, w_out) matmuls.
    HIGHEST precision keeps f32-accurate taps so the golden parity
    thresholds (max diff 9/255) are unaffected."""
    h, w, ch = image.shape
    bu = _band_matrix(u, h).astype(image.dtype)
    bv = _band_matrix(v, w).astype(image.dtype)
    rows = jax.lax.dot(
        bu, image.reshape(h, w * ch), precision=jax.lax.Precision.HIGHEST
    )  # (h_out, w*ch)
    h_out = rows.shape[0]
    # contract w with the column operator: (h_out, w, ch) x (w_out, w) -> (h_out, w_out, ch)
    out = jax.lax.dot_general(
        rows.reshape(h_out, w, ch), bv,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # (h_out, ch, w_out) -- contracted dims removed, bv's batch dim last
    return jnp.moveaxis(out, 2, 1)


def convolve_separable(image, u, v):
    """Full separable convolution; SVGR_BLUR=conv selects the depthwise-conv
    path (the banded-matmul formulation is the default)."""
    if os.environ.get("SVGR_BLUR", "banded") == "conv":
        return _convolve_separable_conv(image, u, v)
    return _convolve_separable_banded(image, u, v)
