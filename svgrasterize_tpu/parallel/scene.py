"""Multi-chip scene rendering: shard the tiled work-item plan across a mesh.

This is the framework's "spatial parallelism": the canvas tile grid is
partitioned into contiguous ranges along the mesh's "data" axis and each
device executes the full batched pipeline (winding, clips, paints, segmented
composition) for its range only — z-ordering is per tile, so tile ranges are
embarrassingly parallel and the only collective is the implicit all-gather
XLA inserts to assemble the sharded canvas.  Work items are balanced by
count, not tile count: device d gets an equal slice of the z-sorted item
stream, aligned to tile boundaries.
"""

from __future__ import annotations

import os

import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..ops import batch_exec
from ..ops.batch_exec import CHUNK_BIG, CHUNK_ITEMS
from ..utils.constants import DEVICE_FLOAT


def _pow2_pad(n: int, chunk: int) -> int:
    out = chunk
    while out < n:
        out *= 2
    return out


def _flatten_big_classes(bigs) -> np.ndarray:
    """Concatenate per-width big classes into one max-width array, keeping
    every class's padded row count so global big_idx rows stay valid."""
    arrays = list(bigs)
    if not arrays:
        return np.zeros((0, 0, 4), DEVICE_FLOAT)
    width = max(a.shape[1] for a in arrays)
    total = sum(a.shape[0] for a in arrays)
    out = np.zeros((total, width, 4), DEVICE_FLOAT)
    row = 0
    for a in arrays:
        out[row : row + a.shape[0], : a.shape[1]] = a
        row += a.shape[0]
    return out


def _assign_tiles(valid_tile_ids, num_tiles: int, n_devices: int,
                  tiles_per_dev: int):
    """(dev_of_tile, slot_of_tile, permuted): item-count-balanced tile split.

    The contiguous split (tile t -> device t // tiles_per_dev) keeps the
    canvas assembly a plain reshape but lets a scene whose heavy items
    cluster in one tile range idle most of the mesh (round-4 verdict §6).
    This assigns tiles to devices LPT-greedy by per-tile item count under
    the fixed tiles_per_dev capacity, so max/mean item skew stays near 1
    for any clustering; the canvas then needs a final row gather
    (sharded_render_plan applies it when `permuted`).  SVGR_BALANCE=0
    restores the contiguous split.
    """
    contiguous = (
        np.arange(num_tiles, dtype=np.int32) // tiles_per_dev,
        np.arange(num_tiles, dtype=np.int32) % tiles_per_dev,
        False,
    )
    if n_devices <= 1 or os.environ.get("SVGR_BALANCE", "1") == "0":
        return contiguous
    counts = np.bincount(valid_tile_ids, minlength=num_tiles)
    # heavy tiles first; zero-item tiles fill capacity at the end
    order = np.argsort(-counts, kind="stable")
    import heapq

    heap = [(0, d) for d in range(n_devices)]
    heapq.heapify(heap)
    used = np.zeros(n_devices, np.int64)
    dev_of_tile = np.zeros(num_tiles, np.int32)
    slot_of_tile = np.zeros(num_tiles, np.int32)
    for t in order:
        spill = []
        while True:
            load, d = heapq.heappop(heap)
            if used[d] < tiles_per_dev:
                break
            spill.append((load, d))
        for entry in spill:
            heapq.heappush(heap, entry)
        dev_of_tile[t] = d
        slot_of_tile[t] = used[d]
        used[d] += 1
        heapq.heappush(heap, (load + int(counts[t]), d))
    if (dev_of_tile == contiguous[0]).all() and (
        slot_of_tile == contiguous[1]
    ).all():
        return contiguous
    return dev_of_tile, slot_of_tile, True


def shard_balance(stacked: dict, tiles_per_dev: int) -> dict:
    """Per-device real-item balance of a partitioned plan.

    Returns {"counts": (n_devices,), "skew": max/mean} computed from the
    stacked tile_id (pads carry the device-local scratch id
    tiles_per_dev).  mean uses only devices with work; an all-empty plan
    reports skew 1.0.
    """
    tid = stacked["tile_id"]
    counts = (tid < tiles_per_dev).sum(axis=1)
    mean = counts.mean()
    skew = float(counts.max() / mean) if mean > 0 else 1.0
    return {"counts": counts, "skew": skew}


def _subselect_rows(stacked: dict, keys: tuple, n_devices: int):
    """Per-device referenced-row selection for a shared row stack.

    The shared stacks (isolation-pass pool, pattern atlas, clip coverage,
    collapse fields) were replicated to every device through round 3, so
    per-device memory scaled with scene complexity instead of
    1/n_devices.  Each shard references only the rows its items index, so
    this computes the (sorted, deduplicated) referenced-row list per
    device, remaps every index array in `keys` to sub-stack-local values
    IN PLACE, and returns the (n_devices, r_max) selection — the caller
    gathers those rows into a per-device sub-stack that shard_map splits
    along the device axis.  Returns None when nothing references the
    stack (callers keep the replicate path)."""
    arrs = [stacked[k] for k in keys if k in stacked]
    if not arrs or not any((a >= 0).any() for a in arrs):
        return None
    hi = max(int(a.max()) for a in arrs)
    rows_per_dev = []
    for d in range(n_devices):
        vals = np.concatenate([a[d][a[d] >= 0].ravel() for a in arrs])
        rows_per_dev.append(np.unique(vals).astype(np.int32))
    r_max = max(1, max(len(r) for r in rows_per_dev))
    sel = np.zeros((n_devices, r_max), np.int32)
    for d in range(n_devices):
        r = rows_per_dev[d]
        sel[d, : len(r)] = r
        remap = np.full(hi + 1, -1, np.int32)
        remap[r] = np.arange(len(r), dtype=np.int32)
        for k in keys:
            if k not in stacked:
                continue
            a = stacked[k][d]
            stacked[k][d] = np.where(a >= 0, remap[np.clip(a, 0, hi)], a)
    return sel


def partition_plan(items: dict, big_lines, num_tiles: int, n_devices: int,
                   patterns=None, clips=None):
    """Split a lowered plan into per-device shards.

    Returns (stacked_items, stacked_big, tiles_per_device) where every array
    gains a leading device axis; tile ids are remapped device-local and
    padding items carry the device-local scratch id.

    big_lines may be a tuple of per-width class arrays (see
    render_plan._pack); classes are flattened into one max-width array here
    — per-device big row counts vary anyway, so the class split would not
    change the padded shard shape.

    patterns/clips: the SCENE-STATIC shared row stacks.  When passed as
    host numpy arrays their per-device sub-stacks gather HERE, once per
    plan partition (like the collapse field stack), and ride the items
    dict as "_sub_pat"/"_sub_clip" — only the frame-dynamic pool keeps
    the per-call device gather in sharded_render_plan (an eager jnp.take
    per call is one more dispatch).
    """
    if isinstance(big_lines, (tuple, list)):
        big_lines = _flatten_big_classes(big_lines)
    tiles_per_dev = -(-num_tiles // n_devices)
    tile_id = items["tile_id"]
    valid = tile_id < num_tiles
    dev_of_tile, slot_of_tile, permuted = _assign_tiles(
        tile_id[valid], num_tiles, n_devices, tiles_per_dev
    )
    safe_tid = np.clip(tile_id, 0, num_tiles - 1)
    device_of = np.where(valid, dev_of_tile[safe_tid], n_devices)  # padding -> drop

    counts = [(device_of == d).sum() for d in range(n_devices)]
    max_count = max(max(counts), 1)
    n_dev = CHUNK_ITEMS * _pow2_pad(-(-max_count // CHUNK_ITEMS), 1)

    big_counts = []
    big_rows_per_dev = []
    for d in range(n_devices):
        sel = device_of == d
        rows = items["big_idx"][sel]
        rows = np.unique(rows[rows >= 0])
        big_rows_per_dev.append(rows)
        big_counts.append(len(rows))
    if big_lines.shape[0] and max(big_counts):
        m_dev = CHUNK_BIG * max(1, _pow2_pad(-(-max(big_counts) // CHUNK_BIG), 1))
        s_big = big_lines.shape[1]
    else:
        m_dev, s_big = 0, 0

    items = {k: v for k, v in items.items() if not k.startswith("_")}
    # the collapsed-run field stack (render_plan._collapse_runs) is
    # plan-global: replicate it per device (field_idx stays valid on every
    # shard), like the clip stack — never split it along the item axis
    field_stack = items.pop("field", None)
    # Padding rows must follow the single-chip pack's pad conventions
    # (render_plan._pack): index fields pad with -1 — a zero fill would make
    # every pad item read as "uses pattern/texture/mask row 0".
    pad_fill = {
        "big_idx": -1, "tex_idx": -1, "mask_idx": -1,
        "clip_idx": -1, "pat_idx": -1, "field_idx": -1,
        "stop_offsets": 1.0, "pat_wh": 1.0,
    }
    stacked = {
        k: np.full((n_devices, n_dev, *v.shape[1:]), pad_fill.get(k, 0), v.dtype)
        for k, v in items.items()
    }
    stacked_big = np.zeros((n_devices, m_dev, s_big, 4), DEVICE_FLOAT)

    for d in range(n_devices):
        sel = np.where(device_of == d)[0]
        if permuted and len(sel):
            # the executor's segmented compose requires each shard's
            # tile ids monotonic (runs contiguous in stream order); the
            # balanced assignment permutes slots, so re-sort the shard by
            # slot — z order within a tile is preserved (stable), and
            # tiles composite independently
            slots = slot_of_tile[np.clip(tile_id[sel], 0, num_tiles - 1)]
            sel = sel[np.argsort(slots, kind="stable")]
        k = len(sel)
        for key, value in items.items():
            shard = stacked[key][d]
            shard[:k] = value[sel]
            if key == "tile_id":
                shard[:k] = slot_of_tile[np.clip(value[sel], 0, num_tiles - 1)]
                shard[k:] = tiles_per_dev  # device-local scratch/drop id
            elif key == "big_idx" and k:
                rows = big_rows_per_dev[d]
                remap = np.full(big_lines.shape[0] + 1, -1, np.int32)
                remap[rows] = np.arange(len(rows), dtype=np.int32)
                shard[:k] = remap[np.where(shard[:k] >= 0, shard[:k], big_lines.shape[0])]
        if m_dev and len(big_rows_per_dev[d]):
            stacked_big[d, : len(big_rows_per_dev[d])] = big_lines[big_rows_per_dev[d]]

    # padding rows of tile_id default to 0 from np.zeros; fix them to drop
    for d in range(n_devices):
        k = (device_of == d).sum()
        stacked["tile_id"][d, k:] = tiles_per_dev

    if permuted:
        # canvas row position of every global tile: sharded_render_plan
        # gathers the assembled (n_devices*tiles_per_dev) canvas by this
        # to restore global tile order after the balanced split
        stacked["_pos"] = (
            dev_of_tile.astype(np.int64) * tiles_per_dev
            + slot_of_tile.astype(np.int64)
        )

    # shard the shared row stacks instead of replicating them
    # (SVGR_SHARD_POOL=0 restores full replication): index arrays remap to
    # sub-stack-local rows here; sharded_render_plan gathers the selected
    # rows per device so each shard's resident stack holds only what its
    # items reference
    subsel = os.environ.get("SVGR_SHARD_POOL", "1") != "0"
    if field_stack is not None:
        sel_f = _subselect_rows(stacked, ("field_idx",), n_devices) \
            if subsel else None
        if sel_f is not None:
            stacked["field"] = field_stack[sel_f]
        else:
            stacked["field"] = np.broadcast_to(
                field_stack[None], (n_devices, *field_stack.shape)
            ).copy()
    if subsel:
        static_stacks = {"pat": patterns, "clip": clips}
        for name, keys in (
            ("pool", ("tex_idx", "mask_idx")),
            ("pat", ("pat_idx",)),
            ("clip", ("clip_idx",)),
        ):
            sel = _subselect_rows(stacked, keys, n_devices)
            if sel is None:
                continue
            static = static_stacks.get(name)
            if static is not None and isinstance(static, np.ndarray):
                # scene-static: gather the sub-stack on host once
                stacked["_sub_" + name] = np.ascontiguousarray(static[sel])
            else:
                stacked["_sel_" + name] = sel

    return stacked, stacked_big, tiles_per_dev


def sharded_render_plan(
    mesh: Mesh, items: dict, big_lines, t_size: int, num_tiles: int,
    pool=None, patterns=None, clips=None,
):
    """Execute a partitioned plan over the mesh's "data" axis.

    items/big_lines must already carry the leading device axis from
    partition_plan.  pool (isolation-pass tiles), patterns (pattern atlas),
    and clips (deduplicated precomputed clip coverage fields) pass in
    full-size; when partition_plan attached a "_sel_*" selection (the
    default, SVGR_SHARD_POOL=1), the referenced rows are gathered into a
    per-device sub-stack here and sharded along the device axis — each
    shard's resident stack holds only the rows its items index (the
    matching index arrays were already remapped sub-stack-local), so
    per-device stack bytes scale with the shard's references instead of
    scene complexity.  Without a selection the stack replicates (any
    device may gather any row).  Returns the assembled canvas
    (n_devices * tiles_per_device, T, T, 4); callers slice to num_tiles.
    """
    import jax.numpy as jnp

    n_devices = items["tile_id"].shape[0]
    tiles_per_dev = -(-num_tiles // n_devices)
    has_big = big_lines.shape[1] > 0
    has_pool = pool is not None
    has_patterns = patterns is not None
    has_clips = clips is not None
    items = dict(items)
    pos_of_tile = items.pop("_pos", None)
    sels = {name: items.pop("_sel_" + name, None)
            for name in ("pool", "pat", "clip")}
    subs = {name: items.pop("_sub_" + name, None)
            for name in ("pool", "pat", "clip")}

    def _maybe_sub(stack, name):
        """(operand, spec, sharded?) for a shared row stack."""
        sub = subs[name]
        if sub is not None:
            # pre-gathered on host at partition_plan time (scene-static)
            return jnp.asarray(sub), P("data"), True
        sel = sels[name]
        if stack is None or sel is None:
            return stack, P(), False
        sub = jnp.take(
            jnp.asarray(stack), jnp.asarray(sel.reshape(-1)), axis=0
        ).reshape(n_devices, sel.shape[1], *stack.shape[1:])
        return sub, P("data"), True

    pool, pool_spec, pool_sub = _maybe_sub(pool, "pool")
    patterns, pat_spec, pat_sub = _maybe_sub(patterns, "pat")
    clips, clip_spec, clip_sub = _maybe_sub(clips, "clip")

    def local(items_l, big_l, *rest):
        local_items = {k: v[0] for k, v in items_l.items()}
        big = big_l[0] if has_big else None
        rest = list(rest)
        pool_l = rest.pop(0) if has_pool else None
        patterns_l = rest.pop(0) if has_patterns else None
        clips_l = rest.pop(0) if has_clips else None
        if pool_sub and pool_l is not None:
            pool_l = pool_l[0]
        if pat_sub and patterns_l is not None:
            patterns_l = patterns_l[0]
        if clip_sub and clips_l is not None:
            clips_l = clips_l[0]
        canvas = batch_exec.execute_items(
            local_items, t_size, tiles_per_dev, big, pool_l, patterns_l, clips_l
        )
        return canvas[None]

    spec_items = {k: P("data") for k in items}
    operands = [
        {k: jnp.asarray(v) for k, v in items.items()},
        jnp.asarray(big_lines),
    ]
    in_specs = [spec_items, P("data")]
    for stack, spec in ((pool, pool_spec), (patterns, pat_spec),
                        (clips, clip_spec)):
        if stack is not None:
            operands.append(stack)
            in_specs.append(spec)
    # check_vma off: scan carries inside execute_items start from shard-local
    # constants, which the varying-axes checker cannot type
    try:
        mapped = shard_map(
            local, mesh=mesh, in_specs=tuple(in_specs), out_specs=P("data"), check_vma=False
        )
    except TypeError:
        mapped = shard_map(
            local, mesh=mesh, in_specs=tuple(in_specs), out_specs=P("data"), check_rep=False
        )
    canvas = mapped(*operands)
    canvas = canvas.reshape(n_devices * tiles_per_dev, t_size, t_size, 4)
    if pos_of_tile is not None:
        # balanced split: restore global tile order (result is exactly
        # (num_tiles, T, T, 4); callers' [:num_tiles] slice is a no-op)
        canvas = jnp.take(canvas, jnp.asarray(pos_of_tile), axis=0)
    return canvas


def sharded_exec_fn(mesh: Mesh):
    """Plan executor for render_plan.execute_lowered that shards every
    program (isolation-pass groups and the main stream) over the mesh."""
    import jax.numpy as jnp

    n_devices = int(mesh.devices.size)

    def run(items, bigs, clips, num_tiles, pool, patterns, t_size):
        st_items, st_big, _tpd = partition_plan(
            items, bigs, num_tiles, n_devices,
            patterns=patterns if isinstance(patterns, np.ndarray) else None,
            clips=clips if isinstance(clips, np.ndarray) else None,
        )
        canvas = sharded_render_plan(
            mesh, st_items, st_big, t_size, num_tiles, pool, patterns,
            jnp.asarray(clips) if clips.shape[0] else None,
        )
        return canvas[:num_tiles]

    return run
