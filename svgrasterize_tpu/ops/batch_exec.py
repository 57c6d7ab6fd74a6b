"""Whole-scene batched rasterization: one device dispatch per scene.

This is the batched replacement for the reference's per-path interpreter
loop (svgrasterize.py:649-688).  The host lowers a scene into
a flat, z-ordered list of (tile, segments, paint) work items (see
render_plan.py); this module executes ALL of them in a single jitted program:

    1. winding + fill rule for every work item (vmapped dense coverage)
    2. paint evaluation (solid / linear gradient / radial gradient)
    3. per-tile Porter-Duff OVER composition via a *segmented* associative
       scan over the z-sorted item axis (log-depth, no host round trips)
    4. masked scatter of each tile's composite into the canvas

Work items are processed in fixed-size chunks inside a lax.scan to bound
device memory ((CHUNK, T, T, 4) intermediates instead of (N, ...)); chunk
boundaries may split a tile run, which is corrected by OVER-composing each
chunk's result onto the canvas (composition within a tile stays in z order).

Static shapes: tile size T, segments-per-item S, and the chunk size are
compile-time constants; the item count is padded to a chunk multiple, so one
compiled program serves every scene with the same (T, S) bucket.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.constants import DEVICE_FLOAT
from .coverage import winding_impl


def _winding(lines, t_size: int):
    """Winding for one work item's edge list (vmapped over items)."""
    return winding_impl(lines, t_size, t_size)

# paint kinds (must match render_plan.PAINT_*)
PAINT_SOLID = 0
PAINT_LINEAR = 1
PAINT_RADIAL = 2
PAINT_PATTERN = 3

# gradient-stop table cap: stop tables are packed to the SCENE's real
# maximum (render_plan k_bucket), so this only bounds the worst case —
# scenes beyond it fall back to the interpreter
MAX_STOPS = 64
CHUNK_ITEMS = 128  # work items rasterized per scan step
SMALL_SEGS = 64  # per-item segment budget in the main pass
CHUNK_BIG = 32  # heavy items rasterized per pre-pass scan step


def _interp_stops(t, offsets, colors):
    """Piecewise-linear stop lookup; offsets (K,), colors (K, 4), t (...).

    Telescoping form: color(t) = c0 + sum_k clip((t-o_{k-1})/(o_k-o_{k-1}))
    * (c_k - c_{k-1}).  Pure elementwise work: no per-pixel searchsorted or
    gather.
    """
    k = offsets.shape[0]
    out = jnp.broadcast_to(colors[0], (*t.shape, 4))
    for i in range(1, k):
        span = offsets[i] - offsets[i - 1]
        ratio = jnp.clip((t - offsets[i - 1]) / jnp.where(span > 1e-12, span, 1.0), 0.0, 1.0)
        # duplicate offsets (zero span) step at the stop position
        ratio = jnp.where(span > 1e-12, ratio, (t >= offsets[i]).astype(t.dtype))
        out = out + ratio[..., None] * (colors[i] - colors[i - 1])
    return out


def _spread(t, mode):
    """Spread by integer mode: 0 pad, 1 repeat, 2 reflect."""
    pad = t
    repeat = t - jnp.trunc(t)
    reflect = jnp.abs(jnp.remainder(t + 1.0, 2.0) - 1.0)
    return jnp.where(mode == 0, pad, jnp.where(mode == 1, repeat, reflect))


def _paint_item(item, tile_r, tile_c, t_size: int, pat_tex=None):
    """Evaluate one work item's paint over its tile -> (T, T, 4).

    item is a dict of per-item params; tile pixel centers are computed from
    the tile's canvas-space origin so gradients are evaluated in the same
    coordinates the host used to precompose the affines.  pat_tex, when
    given, is this item's pattern texture (TH, TW, 4) from the scene's
    pattern atlas; the affine maps pixels into pattern user space and the
    modular gather reproduces the reference's tiling (svgrasterize.py:
    1074-1094) exactly, including the int truncation.
    """
    rows = jax.lax.broadcasted_iota(DEVICE_FLOAT, (t_size, t_size), 0) + tile_r + 0.5
    cols = jax.lax.broadcasted_iota(DEVICE_FLOAT, (t_size, t_size), 1) + tile_c + 0.5
    # device pixel -> paint space (2x3 affine rows [a, b, t])
    m = item["affine"]
    gx = rows * m[0, 0] + cols * m[0, 1] + m[0, 2]
    gy = rows * m[1, 0] + cols * m[1, 1] + m[1, 2]

    # linear: project onto the gradient axis
    p0 = item["p0"]
    p1 = item["p1"]
    vec0 = p1[0] - p0[0]
    vec1 = p1[1] - p0[1]
    denom = jnp.maximum(vec0 * vec0 + vec1 * vec1, 1e-30)
    t_lin = ((gx - p0[0]) * vec0 + (gy - p0[1]) * vec1) / denom

    # radial: two-circle equation (focal form; fcenter==center when unused)
    center = item["center"]
    fc = item["fcenter"]
    radius = item["radius"]
    fradius = item["fradius"]
    cd0 = center[0] - fc[0]
    cd1 = center[1] - fc[1]
    pd0 = gx - fc[0]
    pd1 = gy - fc[1]
    rd = radius - fradius
    a = cd0 * cd0 + cd1 * cd1 - rd * rd
    b = pd0 * cd0 + pd1 * cd1 + fradius * rd
    c = pd0 * pd0 + pd1 * pd1 - fradius * fradius
    det = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(det, 0.0))
    a_safe = jnp.where(jnp.abs(a) > 1e-30, a, 1e-30)
    t_rad = jnp.maximum((b + sq) / a_safe, (b - sq) / a_safe)
    rad_valid = det >= 0
    lim = fradius / jnp.where(jnp.abs(rd) > 1e-12, fradius - radius, 1.0)
    rad_valid = jnp.where(jnp.abs(rd) > 1e-12, rad_valid & (t_rad > lim), rad_valid)

    kind = item["kind"]
    t = jnp.where(kind == PAINT_LINEAR, t_lin, t_rad)
    grad = _interp_stops(
        _spread(t, item["spread"]), item["stop_offsets"], item["stop_colors"]
    )
    grad = jnp.where(
        (kind == PAINT_RADIAL) & ~rad_valid[..., None], 0.0, grad
    )
    solid = jnp.broadcast_to(item["color"], (t_size, t_size, 4))
    out = jnp.where(kind == PAINT_SOLID, solid, grad)

    if pat_tex is not None:
        # pattern user space -> modular cell -> texture pixels (trunc + clamp)
        fwd = item["pat_fwd"]
        q0 = jnp.remainder(gx - item["pat_xy"][0], item["pat_wh"][0])
        q1 = jnp.remainder(gy - item["pat_xy"][1], item["pat_wh"][1])
        s0 = q0 * fwd[0, 0] + q1 * fwd[0, 1] + fwd[0, 2]
        s1 = q0 * fwd[1, 0] + q1 * fwd[1, 1] + fwd[1, 2]
        i0 = jnp.clip(s0.astype(jnp.int32) - item["pat_lo"][0], 0, item["pat_max"][0])
        i1 = jnp.clip(s1.astype(jnp.int32) - item["pat_lo"][1], 0, item["pat_max"][1])
        tw = pat_tex.shape[1]
        pat_val = pat_tex.reshape(-1, 4)[i0 * tw + i1]
        out = jnp.where(kind == PAINT_PATTERN, pat_val, out)
    return out


# SVG mask value = luminance x alpha; on premultiplied pixels that is just
# the luminance weights dotted with the premultiplied rgb.  numpy (not jnp):
# a module-level device constant would initialize the XLA backend at import,
# breaking jax.distributed.initialize for multi-host runs.
_MASK_LUM = np.asarray([0.2125, 0.7154, 0.072], DEVICE_FLOAT)


def _raster_item(item, t_size: int):
    """Finish one work item -> premultiplied RGBA tile.

    item is the per-item param dict plus private keys threaded in by the
    executor: "_wind" (the item's winding field) and, when the scene uses
    them, "_tex"/"_mask_tex" (gathered isolation-pass tiles) and
    "_pat_tex" (the item's pattern texture from the atlas).

    item["carry"] is the per-row winding offset carried into the tile by
    edges entirely to its left (host-precomputed exact row-clipped
    contributions); adding it to the winding field is equivalent to
    rasterizing those edges but costs O(T) instead of O(edges * T * T).
    "_clip_cov" is the item's precomputed clip coverage field (ones when
    unclipped) — fill rules and carries fold into it at lowering time.
    Texture items (tex_idx >= 0) paint a pre-rendered isolation-pass tile
    instead of a paint server; their fill carry is 1, so the mask reduces
    to clip x opacity.  "_mask_tex" (mask_idx >= 0) multiplies in an SVG
    mask pass's luminance-alpha.
    """
    def _coverage(wind, rule):
        nonzero = jnp.clip(jnp.abs(wind), 0.0, 1.0)
        evenodd = jnp.abs(jnp.remainder(wind + 1.0, 2.0) - 1.0)
        return jnp.where(rule == 0, nonzero, evenodd)

    mask = _coverage(item["_wind"] + item["carry"][:, None], item["fill_rule"])
    if "_clip_cov" in item:
        mask = mask * item["_clip_cov"]
    mask = jnp.where(mask < 1e-6, 0.0, mask) * item["opacity"]
    if "_mask_tex" in item:
        value = jnp.dot(
            item["_mask_tex"][..., :3], _MASK_LUM,
            precision=jax.lax.Precision.HIGHEST,
        )
        mask = mask * jnp.where(item["mask_idx"] >= 0, value, 1.0)
    paint = _paint_item(item, item["tile_r"], item["tile_c"], t_size, item.get("_pat_tex"))
    if "_tex" in item:
        paint = jnp.where(item["tex_idx"] >= 0, item["_tex"], paint)
    if "_field" in item:
        # collapsed-run items (render_plan._collapse_runs): the paint IS a
        # host-precomposed premultiplied RGBA field, composed at full
        # coverage (ones carry, no clip/opacity)
        paint = jnp.where(item["field_idx"] >= 0, item["_field"], paint)
    return mask[..., None] * paint


def _prepass_winding(arrays, t_size: int):
    """Winding fields for a tuple of padded edge-list arrays (M_c, S_c, 4).

    Each class is rasterized in CHUNK_BIG-row scan steps at its own padded
    segment width; results concatenate into one (M_total + 1, T, T) stack
    (scratch row last, for idx == -1 gathers).  Returns None when empty.
    """
    winds = []
    for arr in arrays:
        if arr is None or arr.shape[0] == 0:
            continue
        m = arr.shape[0]
        step = min(m, CHUNK_BIG)
        chunks = arr.reshape(m // step, step, *arr.shape[1:])
        winds.append(
            jax.lax.map(
                lambda chunk: jax.vmap(lambda l: _winding(l, t_size))(chunk), chunks
            ).reshape(m, t_size, t_size)
        )
    if not winds:
        return None
    winds.append(jnp.zeros((1, t_size, t_size), DEVICE_FLOAT))
    return jnp.concatenate(winds, axis=0)


def execute_items(
    items: dict, t_size: int, num_tiles: int, big_lines=(), pool=None,
    patterns=None, clip_cov=None,
):
    """Traceable whole-scene execution; see execute_plan for the contract.

    pool: (P, T, T, 4) texture tiles from earlier isolation passes, gathered
    by items["tex_idx"].  patterns: (Q, TH, TW, 4) pattern-tile atlas,
    gathered by items["pat_idx"].  clip_cov: (U, T, T) deduplicated
    per-(clip, tile) precomputed coverage fields, gathered by
    items["clip_idx"] (-1 gathers the appended all-ones row).
    """
    n = items["tile_id"].shape[0]
    items = dict(items)
    # the collapsed-run field stack is plan-global, not per-item — keep it
    # out of the per-item chunking and gather rows per chunk below
    field_stack = items.pop("field", None)
    chunk_items = min(n, CHUNK_ITEMS)  # small passes stay small
    num_chunks = n // chunk_items
    chunked = jax.tree_util.tree_map(
        lambda a: a.reshape(num_chunks, chunk_items, *a.shape[1:]), items
    )
    if field_stack is not None:
        field_padded = jnp.concatenate(
            [field_stack,
             jnp.zeros((1, t_size, t_size, 4), DEVICE_FLOAT)], axis=0
        )

    if big_lines is not None and not isinstance(big_lines, (tuple, list)):
        big_lines = (big_lines,)
    big_wind = _prepass_winding(tuple(big_lines or ()), t_size)
    if clip_cov is not None and clip_cov.shape[0]:
        # all-ones scratch row: clip_idx == -1 means full coverage
        clip_stack = jnp.concatenate(
            [clip_cov, jnp.ones((1, t_size, t_size), DEVICE_FLOAT)], axis=0
        )
    else:
        clip_stack = None

    if pool is not None:
        if pool.ndim == 3:
            # the whole-plan program keeps the pool channel-planar
            # (P+1, T, 4T) with the scratch row already appended; convert
            # back to interleaved tiles here
            pool = pool.reshape(-1, t_size, 4, t_size).transpose(0, 1, 3, 2)
            pool = pool[:-1]
        # scratch row so tex_idx == -1 gathers stay in bounds
        pool_padded = jnp.concatenate(
            [pool, jnp.zeros((1, t_size, t_size, 4), DEVICE_FLOAT)], axis=0
        )
    if patterns is not None:
        pats_padded = jnp.concatenate(
            [patterns, jnp.zeros((1, *patterns.shape[1:]), DEVICE_FLOAT)], axis=0
        )

    canvas0 = jnp.zeros((num_tiles + 1, t_size, t_size, 4), DEVICE_FLOAT)

    def step(canvas, chunk):
        wind = jax.vmap(lambda l: _winding(l, t_size))(chunk["lines"])
        if big_wind is not None:
            idx = chunk["big_idx"]
            gathered = big_wind[jnp.where(idx >= 0, idx, big_wind.shape[0] - 1)]
            wind = jnp.where((idx >= 0)[:, None, None], gathered, wind)
        merged = dict(chunk)
        merged["_wind"] = wind
        if clip_stack is not None:
            cidx = chunk["clip_idx"]
            merged["_clip_cov"] = clip_stack[
                jnp.where(cidx >= 0, cidx, clip_stack.shape[0] - 1)
            ]
        if pool is not None:
            tex_idx = chunk["tex_idx"]
            mask_idx = chunk["mask_idx"]
            merged["_tex"] = pool_padded[jnp.where(tex_idx >= 0, tex_idx, pool.shape[0])]
            merged["_mask_tex"] = pool_padded[jnp.where(mask_idx >= 0, mask_idx, pool.shape[0])]
        if patterns is not None:
            pat_idx = chunk["pat_idx"]
            merged["_pat_tex"] = pats_padded[
                jnp.where(pat_idx >= 0, pat_idx, patterns.shape[0])
            ]
        if field_stack is not None:
            fidx = chunk["field_idx"]
            merged["_field"] = field_padded[
                jnp.where(fidx >= 0, fidx, field_stack.shape[0])
            ]
        rgba = jax.vmap(lambda it: _raster_item(it, t_size))(merged)

        tile_id = chunk["tile_id"]  # (C,) int32, sorted
        starts = jnp.concatenate([jnp.array([True]), tile_id[1:] != tile_id[:-1]])
        ends = jnp.concatenate([tile_id[:-1] != tile_id[1:], jnp.array([True])])

        def seg_over(a, b):
            flag_a, img_a = a
            flag_b, img_b = b
            # if b starts a new segment, drop a's accumulation
            composed = img_b + img_a * (1.0 - img_b[..., -1:])
            return flag_a | flag_b, jnp.where(flag_b[:, None, None, None], img_b, composed)

        _, scanned = jax.lax.associative_scan(seg_over, (starts, rgba), axis=0)

        # compose each tile-run's result onto the canvas (once per run end)
        ids = jnp.where(ends, jnp.minimum(tile_id, num_tiles), num_tiles)
        current = canvas[ids]  # padding lanes read the scratch tile
        composed = scanned + current * (1.0 - scanned[..., -1:])
        canvas = canvas.at[ids].set(composed, mode="drop")
        # keep the scratch tile clean for the next chunk
        canvas = canvas.at[num_tiles].set(0.0)
        return canvas, None

    canvas, _ = jax.lax.scan(step, canvas0, chunked)
    return canvas[:num_tiles]


@partial(jax.jit, static_argnames=("t_size", "num_tiles"))
def execute_plan(
    items: dict, t_size: int, num_tiles: int, big_lines=(), pool=None,
    patterns=None, clip_cov=None,
):
    """Run a whole lowered scene; returns the canvas (num_tiles, T, T, 4).

    items: dict of per-item arrays, all with leading dim N (a multiple of
    CHUNK_ITEMS), z-sorted by (tile_id, z).  Padding items carry
    tile_id == num_tiles and are dropped by the scatter.

    Segment-class scheduling: every item's "lines" is capped at SMALL_SEGS
    edges; heavier items carry their full edge list in one of the
    `big_lines` class arrays ((M_c, S_c, 4), widths chosen per scene),
    rasterized once in a pre-pass and gathered by items["big_idx"] (a row
    into the concatenated class stack; -1 for small items).  This keeps
    per-item winding cost proportional to each item's real segment count
    instead of the scene's worst tile.

    Clip deduplication: per-(clip, tile) coverage fields (host-precomputed
    unions of the clip parts' rule coverages, render_plan._clip_tile) are
    stored once in `clip_cov` (U, T, T) and gathered by items["clip_idx"]
    — scenes where hundreds of draws share a clip pay for it once, and
    the executors just multiply the field into the item mask.
    """
    return execute_items(items, t_size, num_tiles, big_lines, pool, patterns, clip_cov)
