"""Batched execution of a dependency level's Gaussian-blur filter parts.

A filter-heavy scene lowers to dozens of isolation parts per dependency
level, each with a tiny single-`feGaussianBlur` chain (an icon sheet can
have one filtered part per icon).  Executing them one by one — even fused
into one jitted program — emits ~15 small HLO ops per part (gather,
reshape, transpose, crop, two band matmuls, merge, re-tile).  (Reference
behavior: svgrasterize.py's filter_feGaussianBlur + canvas compose loop,
executed per filter node.)

This module replaces the per-part op chains with ~9 large regular-access
ops per chunk of parts:

  1. whole-tile-row gather assembles each part's source span — one
     contiguous (T,T,4) block per tile, LUT resolved on the host;
  2. one shuffle re-tiles spans to channel-PLANAR (B, 4, H, W);
  3. alpha/colorspace conversion runs elementwise on the whole batch
     (pixels outside the crop window see garbage from sibling content in
     shared tiles; the band operators mask them out exactly);
  4. crop-shift, separable blur, AND out-span placement fold into ONE
     pair of batched banded-operator matmuls:
     out_span[b] = BH[b] @ span[b] @ BW[b]^T with
     BH[o, s] = u[(o + span_r0 - out_r) - (s - crop_r0)] masked to the
     part's real crop/output windows — a band matrix is closed under
     row/column shifts, so placement costs no extra op;
  5. the out spans shuffle back to (T,T,4) tiles and one whole-row
     gather reorders them into pool-row order.

Parts that are not a lone separable blur (rotated kernels, multi-
primitive chains, per-primitive subregions) keep the per-part path.
"""

from __future__ import annotations

import os

import numpy as np

from ..filter import FE_GAUSSIAN_BLUR
from ..utils.constants import DEVICE_FLOAT

# cap on B * max(span, out_span) pixels per chunk (~64 MB of f32 RGBA)
_CHUNK_ELEMS = 1 << 22


def enabled() -> bool:
    return os.environ.get("SVGR_BLUR_BATCH", "1") != "0"


def _part_spec(part, grid_w: int, viewport, t_size: int):
    """Host metadata for one batchable part, or None to keep it per-part.

    Mirrors the crop/offset arithmetic of the per-part path
    (render_plan._apply_part_filter + Layer.convolve) exactly: the
    reference's `int(x - k/2)` blur placement is truncation-sensitive,
    so both paths must feed the same origins to the same formula.
    """
    from ..ops import blur as blur_ops

    flt, transform, bbox = part["post"]
    if len(flt.filters) != 1:
        return None
    kind, attrs, inputs = flt.filters[0]
    if kind != FE_GAUSSIAN_BLUR or any(r is not None for r in flt.regions):
        return None
    if tuple(inputs) not in ((0,), (1,)):
        return None
    std_x, std_y = attrs
    std_y = std_x if std_y is None else std_y
    kernel = blur_ops.gaussian_kernel(transform, (std_x, std_y))
    if kernel is None:
        u = v = np.ones(1, np.float64)  # sub-pixel blur: exact identity
    else:
        uv = blur_ops.separate_kernel(np.asarray(kernel))
        if uv is None:
            return None  # rotated/non-separable kernel: per-part 2D conv
        u, v = uv

    T = t_size
    v0, v1 = int(viewport[0]), int(viewport[1])
    src_tiles = [int(t) for t in part["src_tiles"]]
    s_rows = [t // grid_w for t in src_tiles]
    s_cols = [t % grid_w for t in src_tiles]
    si0, sj0 = min(s_rows), min(s_cols)
    nsi = max(s_rows) - si0 + 1
    nsj = max(s_cols) - sj0 + 1
    or_, oc = si0 * T, sj0 * T  # span origin, canvas px
    r0 = max(bbox[0] - v0 - or_, 0)
    c0 = max(bbox[1] - v1 - oc, 0)
    r1 = min(bbox[2] - v0 - or_, nsi * T)
    c1 = min(bbox[3] - v1 - oc, nsj * T)
    if r1 <= r0 or c1 <= c0:
        return None  # empty crop: keep the per-part path's semantics
    kh, kw = len(u), len(v)
    crop_r, crop_c = or_ + r0, oc + c0  # crop origin, canvas px
    if kernel is None:
        out_r, out_c = crop_r, crop_c  # identity keeps the layer origin
    else:
        # reference truncation: int(x - k/2) on the ABSOLUTE origin
        out_r = int(v0 + crop_r - kh / 2) - v0
        out_c = int(v1 + crop_c - kw / 2) - v1
    out_tiles = [int(t) for t in part["out_tiles"]]
    o_rows = [t // grid_w for t in out_tiles]
    o_cols = [t % grid_w for t in out_tiles]
    oi0, oj0 = min(o_rows), min(o_cols)
    return {
        "u": u, "v": v,
        "r0": r0, "c0": c0,  # crop origin, span px
        "crop_h": r1 - r0, "crop_w": c1 - c0,
        "out_h": (r1 - r0) + kh - 1, "out_w": (c1 - c0) + kw - 1,
        # blurred row index = out-span row + od_r (span origin minus the
        # blurred image's origin)
        "od_r": oi0 * T - out_r, "od_c": oj0 * T - out_c,
        "nsi": nsi, "nsj": nsj,
        "noi": max(o_rows) - oi0 + 1, "noj": max(o_cols) - oj0 + 1,
        "span_tile": (si0, sj0),
        "out_local": [(r - oi0, c - oj0) for r, c in zip(o_rows, o_cols)],
        "src_tiles": src_tiles,
        "row_start": int(part["row_start"]),
        # final pool row of the part's first out tile; may be reassigned
        # by the caller (render_plan._plan_groups emission-order pool
        # numbering) before build_chunks consumes it
        "pool_base": part["pool_base"],
        "src_alpha": tuple(inputs) == (0,),
        "chain_linear": bool(flt.linear),
    }


def _band(taps, n_in_real: int, shift: int, dr: int,
          n_out: int, n_in: int) -> np.ndarray:
    """Band operator folding crop, full convolution, and placement:
    B[o, s] = taps[(o + dr) - (s - shift)] masked to the part's real
    crop columns (s - shift in [0, n_in_real)) and real output rows
    ((o + dr) in [0, n_in_real + k - 1))."""
    k = len(taps)
    m = np.zeros((n_out, n_in), DEVICE_FLOAT)
    o = np.arange(n_out)[:, None] + dr
    s = np.arange(n_in)[None, :]
    p = s - shift
    band = o - p
    inside = ((band >= 0) & (band < k) & (p >= 0) & (p < n_in_real)
              & (o >= 0) & (o < n_in_real + k - 1))
    m[inside] = np.asarray(taps, np.float64)[band[inside]]
    return m


def plan_level(parts, grid_w: int, viewport, t_size: int):
    """Partition a level's filtered parts into batchable chunk groups.

    Returns (chunk_groups: list of ([(pi, spec)], chain_linear),
    batched: set of part indices) — pool-independent metadata only, so
    the caller can assign pool rows in emission order (per-part outputs
    first, then each chunk's) BEFORE building the chunk tensors with
    build_chunks; the level's pool update then needs no device-side row
    permutation.  Chunks group parts with the same conversion signature,
    sorted by span area and split under _CHUNK_ELEMS so small crops
    never pad to the scene maximum.
    """
    if not enabled():
        return [], set()
    specs = {}
    for pi, part in enumerate(parts):
        if part["post"] is None:
            continue
        spec = _part_spec(part, grid_w, viewport, t_size)
        if spec is not None:
            specs[pi] = spec
    chunk_groups = []
    by_sig: dict = {}
    for pi, s in specs.items():
        by_sig.setdefault(s["chain_linear"], []).append((pi, s))
    spx = t_size * t_size

    def cost(items):
        si = max(t[1]["nsi"] for t in items) * max(t[1]["nsj"] for t in items)
        so = max(t[1]["noi"] for t in items) * max(t[1]["noj"] for t in items)
        return len(items) * max(si, so) * spx

    def dclass(s):
        # class of the part's largest tile dimension: chunk dims are the
        # max over members, so mixing 1x1 parts into a 6x6 chunk pads
        # every member to the max (icons.svg level 0: 36 parts, 15 of
        # them 1x1, padded to 6x6 — ~4x the real pixels through every
        # gather/convert/matmul/re-tile of the chunk).  EXACT max-dim
        # classes by default: pow2 classes padded every 5-6-tile part to
        # 8 (sprite atlas at cell 192: ~1.8x the pixels through the whole
        # chunk pipeline).  SVGR_CHUNK_POW2=1 restores pow2 classes when
        # bounding the compiled-shape count matters more than per-call
        # cost (one-shot renders of scenes with many distinct part sizes)
        d = max(s["nsi"], s["nsj"], s["noi"], s["noj"])
        if os.environ.get("SVGR_CHUNK_POW2", "0") != "0":
            p = 1
            while p < d:
                p *= 2
            return p
        return d

    for chain_linear, group in by_sig.items():
        by_class: dict = {}
        for pi, s in group:
            by_class.setdefault(dclass(s), []).append((pi, s))
        for _cl, sub in sorted(by_class.items()):
            sub.sort(key=lambda kv: max(
                kv[1]["nsi"] * kv[1]["nsj"], kv[1]["noi"] * kv[1]["noj"]
            ))
            cur: list = []
            for pi, s in sub:
                if cur and cost(cur + [(pi, s)]) > _CHUNK_ELEMS:
                    chunk_groups.append((cur, chain_linear))
                    cur = [(pi, s)]
                else:
                    cur = cur + [(pi, s)]
            if cur:
                chunk_groups.append((cur, chain_linear))
    return chunk_groups, set(specs)


def build_chunks(chunk_groups, grid_w: int, t_size: int):
    """Build device-ready chunk dicts; specs must carry final pool_base."""
    return [
        _build_chunk(group, grid_w, t_size, chain_linear)
        for group, chain_linear in chunk_groups
    ]


def plan_level_batches(parts, grid_w: int, viewport, t_size: int):
    """One-step plan for parts that already carry final pool rows."""
    chunk_groups, batched = plan_level(parts, grid_w, viewport, t_size)
    return build_chunks(chunk_groups, grid_w, t_size), batched


def _build_chunk(group, grid_w: int, t_size: int, chain_linear: bool) -> dict:
    B = len(group)
    nsi = max(s["nsi"] for _, s in group)
    nsj = max(s["nsj"] for _, s in group)
    noi = max(s["noi"] for _, s in group)
    noj = max(s["noj"] for _, s in group)
    T = t_size
    i32 = np.int32
    # span-position -> canvas-row LUT (row-major over the padded span)
    lut = np.full((B, nsi * nsj), -1, i32)
    for b, (_, s) in enumerate(group):
        si0, sj0 = s["span_tile"]
        for k, t in enumerate(s["src_tiles"]):
            di = t // grid_w - si0
            dj = t % grid_w - sj0
            lut[b, di * nsj + dj] = s["row_start"] + k
    # out-span position -> pool row (gather the listed out tiles only)
    out_idx, pool_idx = [], []
    for b, (_, s) in enumerate(group):
        for k, (di, dj) in enumerate(s["out_local"]):
            out_idx.append((b * noi + di) * noj + dj)
            pool_idx.append(s["pool_base"] + k)
    return {
        "B": B, "NSi": nsi, "NSj": nsj, "NOi": noi, "NOj": noj,
        "chain_linear": chain_linear,
        "lut": lut,
        "bh": np.stack([
            _band(s["u"], s["crop_h"], s["r0"], s["od_r"], noi * T, nsi * T)
            for _, s in group
        ]),
        "bw": np.stack([
            _band(s["v"], s["crop_w"], s["c0"], s["od_c"], noj * T, nsj * T)
            for _, s in group
        ]),
        "src_alpha": np.array([s["src_alpha"] for _, s in group], bool),
        "out_idx": np.array(out_idx, i32),
        "pool_idx": pool_idx,
    }


def _planar_convert(x, to_straight: bool, gamma: str | None, axis: int = 1):
    """Layer.convert math on channel-planar batches; the same piecewise
    formulas as core.color, with channels on `axis` (4 entries).

    All steps are channel-mask selects over the full batch instead of
    rgb/alpha slice + concatenate: the concat materialized a whole-batch
    copy per convert on device (206 us/call on the sprite-atlas trace),
    while the selects fuse into one elementwise loop.  The rgb formulas
    run on the alpha lane too and get masked out — fused elementwise is
    bandwidth-bound, so the extra 1/4 of lanes is free."""
    import jax.numpy as jnp
    from jax import lax

    cshape = [1] * x.ndim
    cshape[axis] = 4
    is_rgb = jnp.arange(4).reshape(cshape) < 3
    alpha = lax.slice_in_dim(x, 3, 4, axis=axis)  # broadcasts over `axis`
    if to_straight:
        pos = alpha > 0.0001
        safe = jnp.where(pos, alpha, 1.0)
        x = jnp.where(is_rgb & pos, x / safe, x)
        x = jnp.clip(x, 0, 1)  # reference clips rgb AND alpha here
    if gamma == "to_linear":
        g = jnp.where(
            x <= 0.04045,
            x / 12.92,
            jnp.power(jnp.maximum((x + 0.055) / 1.055, 1e-12), 2.4),
        )
        x = jnp.where(is_rgb, g, x)
    elif gamma == "to_srgb":
        g = jnp.where(
            x <= 0.0031308,
            x * 12.92,
            1.055 * jnp.power(jnp.maximum(x, 1e-12), 1.0 / 2.4) - 0.055,
        )
        x = jnp.where(is_rgb, g, x)
    if not to_straight:  # straight -> premultiplied
        x = jnp.where(is_rgb, x * alpha, x)
    return x


def _apply_chunk_folded(rows, ck: dict, t_size: int, linear_rgb: bool):
    """apply_chunk's math with the tiled->image de-interleave folded into
    the band matmuls (SVGR_CHUNK_FOLD experiment).

    Instead of materializing channel-planar (B, 4, H, W) images, the
    gathered rows stay in their tiled (B, NSi, NSj, Tr, c, Tc) form and
    the band operators contract (tile-index, in-tile) axis PAIRS —
    dot_general normalization then decides the relayout, which it can
    fuse into the matmul's operand reads instead of paying separate
    reshape/transpose copies.  Same taps, HIGHEST precision, same
    reduction elements as the image-form pair.
    """
    import jax
    import jax.numpy as jnp

    T = t_size
    B, NSi, NSj, NOi, NOj = ck["B"], ck["NSi"], ck["NSj"], ck["NOi"], ck["NOj"]
    hi = jax.lax.Precision.HIGHEST

    span = rows.reshape(B, NSi, NSj, T, 4, T)  # (b, si, sj, sr, c, sc)
    amask = jnp.asarray([0.0, 0.0, 0.0, 1.0], span.dtype)
    span = jnp.where(
        ck["src_alpha"][:, None, None, None, None, None],
        span * amask[:, None],
        span,
    )
    chain_linear = ck["chain_linear"]
    gamma_in = gamma_out = None
    if chain_linear != linear_rgb:
        gamma_in = "to_linear" if chain_linear else "to_srgb"
        gamma_out = "to_srgb" if chain_linear else "to_linear"
    span = _planar_convert(span, to_straight=True, gamma=gamma_in, axis=4)

    bh6 = jnp.asarray(ck["bh"]).reshape(B, NOi, T, NSi, T)
    bw6 = jnp.asarray(ck["bw"]).reshape(B, NOj, T, NSj, T)
    z = jax.lax.dot_general(  # -> (b, oi, or, sj, c, sc)
        bh6, span,
        dimension_numbers=(((3, 4), (1, 3)), ((0,), (0,))),
        precision=hi,
    )
    out = jax.lax.dot_general(  # -> (b, oj, oc, oi, or, c)
        bw6, z,
        dimension_numbers=(((3, 4), (3, 5)), ((0,), (0,))),
        precision=hi,
    )
    out = _planar_convert(out, to_straight=False, gamma=gamma_out, axis=5)
    tiles = (
        out.transpose(0, 3, 1, 4, 5, 2)  # (b, oi, oj, or, c, oc)
        .reshape(B * NOi * NOj, T, 4 * T)
    )
    return tiles[jnp.asarray(ck["out_idx"])]


def apply_chunk(canvas, ck: dict, t_size: int, linear_rgb: bool,
                planar: bool = False):
    """Run one batched-blur chunk: canvas rows -> pool rows ((n_out, T,
    T, 4), or channel-planar (n_out, T, 4T) when `planar` — then the
    canvas rows are planar too and the level needs no layout round trip).

    Traceable.  HIGHEST matmul precision keeps f32-accurate taps (the
    band matmuls replace exact-copy placement too; single-pass bf16
    would round every value)."""
    import jax
    import jax.numpy as jnp

    T = t_size
    B, NSi, NSj, NOi, NOj = ck["B"], ck["NSi"], ck["NSj"], ck["NOi"], ck["NOj"]
    H, W = NSi * T, NSj * T
    Ho, Wo = NOi * T, NOj * T
    hi = jax.lax.Precision.HIGHEST

    # 1. span assembly: whole-tile-row gather, one shuffle to channel-
    # planar images
    sent = canvas.shape[0]
    pad_row = (jnp.zeros((1, T, 4 * T), canvas.dtype) if planar
               else jnp.zeros((1, T, T, 4), canvas.dtype))
    rows = jnp.concatenate([canvas, pad_row], axis=0)[
        jnp.asarray(np.where(ck["lut"] < 0, sent, ck["lut"]))
    ]  # (B, S, T, T, 4) or planar (B, S, T, 4T)

    if planar and os.environ.get("SVGR_CHUNK_FOLD", "0") != "0":
        return _apply_chunk_folded(rows, ck, t_size, linear_rgb)
    if planar:
        span = (
            rows.reshape(B, NSi, NSj, T, 4, T)
            .transpose(0, 4, 1, 3, 2, 5)
            .reshape(B, 4, H, W)
        )
    else:
        span = (
            rows.reshape(B, NSi, NSj, T, T, 4)
            .transpose(0, 5, 1, 3, 2, 4)
            .reshape(B, 4, H, W)
        )

    # 2. conversions (Layer.convert(pre_alpha=False, linear_rgb=chain),
    # same formulas, same order as the per-part path)
    span = jnp.where(
        ck["src_alpha"][:, None, None, None],
        span * jnp.asarray([0.0, 0.0, 0.0, 1.0], span.dtype)[:, None, None],
        span,
    )
    chain_linear = ck["chain_linear"]
    gamma_in = gamma_out = None
    if chain_linear != linear_rgb:
        gamma_in = "to_linear" if chain_linear else "to_srgb"
        gamma_out = "to_srgb" if chain_linear else "to_linear"
    span = _planar_convert(span, to_straight=True, gamma=gamma_in)

    # 3. crop + blur + placement as one pair of banded matmuls.  The
    # channel axis rides as a FREE dim of the rhs (not a batch dim): a
    # batch dim would force the band matrices to broadcast per channel
    # (4x the operand traffic) and shrink each matmul's free extent 4x
    bh = jnp.asarray(ck["bh"])  # (B, Ho, H)
    bw = jnp.asarray(ck["bw"])  # (B, Wo, W)
    z = jax.lax.dot_general(  # (B, Ho, 4, W)
        bh, span, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        precision=hi,
    )
    out_span = jax.lax.dot_general(  # (B, Ho, 4, Wo)
        z, bw, dimension_numbers=(((3,), (2,)), ((0,), (0,))),
        precision=hi,
    )

    out_span = _planar_convert(out_span, to_straight=False, gamma=gamma_out,
                               axis=2)

    # 4. back to tiles; one whole-row gather into pool order
    if planar:
        tiles = (
            out_span.reshape(B, NOi, T, 4, NOj, T)
            .transpose(0, 1, 4, 2, 3, 5)
            .reshape(B * NOi * NOj, T, 4 * T)
        )
    else:
        tiles = (
            out_span.reshape(B, NOi, T, 4, NOj, T)
            .transpose(0, 1, 4, 2, 5, 3)
            .reshape(B * NOi * NOj, T, T, 4)
        )
    return tiles[jnp.asarray(ck["out_idx"])]  # (n_out, ...)
