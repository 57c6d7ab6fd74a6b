"""Static-run collapse (render_plan._collapse_runs): equivalence + plumbing.

A run of z-consecutive same-tile solid items with no pool/pattern reads is
scene-static, so lowering precomposes it into one full-coverage "field"
item (a premultiplied RGBA plane gathered from the plan's field stack).
These tests pin: (a) the collapse actually fires, (b) plan output is
unchanged vs SVGR_COLLAPSE=0, (c) the interpreter oracle still agrees,
(d) the sharded path replicates the plan-global field stack correctly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from svgrasterize_tpu.core.transform import Transform
from svgrasterize_tpu.frontend.svg import scene_from_str
from svgrasterize_tpu.ops import batch_exec
from svgrasterize_tpu.parallel.scene import partition_plan, sharded_render_plan
from svgrasterize_tpu.render_plan import (
    execute_lowered, lower_scene, render_fast,
)

TR = Transform().matrix(0, 1, 0, 1, 0, 0)
_tiles = np.asarray  # execute_lowered returns the raw (num_tiles,T,T,4) canvas

# overlapping solids (several per tile), an opacity member, a clipped
# member, an evenodd member, and one gradient that must break the run
DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="160" height="120">
  <defs>
    <clipPath id="c"><rect x="10" y="10" width="120" height="90"/></clipPath>
    <linearGradient id="g"><stop offset="0" stop-color="red"/>
    <stop offset="1" stop-color="blue"/></linearGradient>
  </defs>
  <rect x="4" y="4" width="150" height="110" fill="#336699"/>
  <circle cx="50" cy="50" r="40" fill="#cc3344" opacity="0.7"/>
  <path d="M20 20 L140 30 L80 110 Z" fill="rgba(20,200,80,0.5)"/>
  <rect x="60" y="16" width="60" height="60" fill="#112233" fill-opacity="0.4"
        clip-path="url(#c)"/>
  <path d="M10 60 h80 v40 h-80 z M30 70 h40 v20 h-40 z" fill="#884422"
        fill-rule="evenodd"/>
  <rect x="100" y="60" width="50" height="50" fill="url(#g)"/>
  <rect x="104" y="64" width="40" height="40" fill="#eeddcc" opacity="0.8"/>
</svg>
"""


def _plan(doc, collapse, monkeypatch):
    # monkeypatch (not manual os.environ mutation) so any pre-existing
    # SVGR_COLLAPSE value is restored after the test
    monkeypatch.setenv("SVGR_COLLAPSE", collapse)
    scene, _ids, size = scene_from_str(doc)
    w, h = int(size[0]), int(size[1])
    try:
        return lower_scene(scene, TR, (0, 0, h, w), False), (w, h)
    finally:
        monkeypatch.delenv("SVGR_COLLAPSE", raising=False)


def _n_field(lowered):
    fidx = lowered.items.get("field_idx")
    return 0 if fidx is None else int((fidx >= 0).sum())


def test_collapse_fires_and_matches_uncollapsed(monkeypatch):
    low0, _ = _plan(DOC, "0", monkeypatch)
    low1, _ = _plan(DOC, "1", monkeypatch)
    assert _n_field(low0) == 0
    assert _n_field(low1) > 0
    a = _tiles(execute_lowered(low0, (0, 0), False))
    b = _tiles(execute_lowered(low1, (0, 0), False))
    # the host coverage batch runs in f32 (speed: ~2x the f64 lower-time
    # cost), so AA-edge coverage lands within ~1e-5 of the device's own
    # f32 winding rather than bit-equal; 1e-3 is still 30x below the
    # interpreter-oracle tolerance
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_collapse_matches_interpreter_oracle(monkeypatch):
    import svgrasterize_tpu.render_plan as rp

    low1, (w, h) = _plan(DOC, "1", monkeypatch)
    assert _n_field(low1) > 0
    scene, _ids, _size = scene_from_str(DOC)
    monkeypatch.setenv("SVGR_COLLAPSE", "1")
    fast, _hull = render_fast(scene, TR, (0, 0, h, w))
    monkeypatch.delenv("SVGR_COLLAPSE", raising=False)
    rp.HYBRID_ENABLED = False
    try:
        slow, _hull = scene.render(TR, viewport=(0, 0, h, w))
    finally:
        rp.HYBRID_ENABLED = True
    from svgrasterize_tpu.core.layer import merge_at

    canvas = jnp.zeros((h, w, 4), dtype=jnp.float32)
    canvas = merge_at(
        canvas,
        slow.convert(pre_alpha=True, linear_rgb=False).image,
        slow.offset,
    )
    np.testing.assert_allclose(
        np.asarray(fast.image), np.asarray(canvas), atol=2e-3
    )


@pytest.mark.parametrize("n_devices", [2, 8])
def test_collapse_sharded_replicates_field_stack(n_devices, monkeypatch):
    low1, _ = _plan(DOC, "1", monkeypatch)
    assert _n_field(low1) > 0
    items, bigs, clips = low1.items, low1.bigs, low1.clips
    gh, gw = low1.grid
    num_tiles = gh * gw
    ref = np.asarray(
        batch_exec.execute_plan(
            {k: jnp.asarray(v) for k, v in items.items()},
            low1.tile, num_tiles,
            tuple(jnp.asarray(b) for b in bigs),
            None, None,
            jnp.asarray(clips) if clips.shape[0] else None,
        )
    )
    st_items, st_big, _tpd = partition_plan(items, bigs, num_tiles, n_devices)
    assert "field" in st_items and st_items["field"].shape[0] == n_devices
    mesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("data",))
    out = np.asarray(
        sharded_render_plan(
            mesh, st_items, st_big, low1.tile, num_tiles,
            clips=jnp.asarray(clips) if clips.shape[0] else None,
        )
    )[:num_tiles]
    np.testing.assert_allclose(out, ref, atol=1e-6)


def _overlap_doc() -> str:
    body = []
    for i in range(40):
        x, y = (i * 61) % 560, (i * 37) % 120
        body.append(
            f'<rect x="{x}" y="{y}" width="90" height="70" '
            f'fill="#{(i * 37) % 256:02x}{(i * 91) % 256:02x}22" '
            'fill-opacity="0.6"/>'
            f'<rect x="{x + 10}" y="{y + 5}" width="70" height="50" '
            f'fill="#22{(i * 53) % 256:02x}{(i * 29) % 256:02x}" '
            'fill-opacity="0.5"/>'
        )
    return (
        '<svg xmlns="http://www.w3.org/2000/svg" width="640" height="192">'
        + "".join(body) + "</svg>"
    )


@pytest.mark.parametrize("which", ["mixed", "overlap"])
def test_collapsed_plan_at_tile32_matches_interpreter(which, monkeypatch):
    """Collapsed plans at tile 32 (many field items, several per tile run)
    served through the whole-plan program agree with the per-path
    interpreter."""
    import svgrasterize_tpu.render_plan as rp
    from svgrasterize_tpu.core.layer import merge_at

    doc = DOC if which == "mixed" else _overlap_doc()
    monkeypatch.setenv("SVGR_COLLAPSE", "1")
    scene, _ids, size = scene_from_str(doc)
    w, h = int(size[0]), int(size[1])
    compiled = rp.compile_scene(scene, TR, (0, 0, h, w), False, tile=32)
    assert _n_field(compiled._lowered) > (50 if which == "overlap" else 0)
    fast = np.asarray(compiled.render().image)
    rp.HYBRID_ENABLED = False
    try:
        slow, _hull = scene.render(TR, viewport=(0, 0, h, w))
    finally:
        rp.HYBRID_ENABLED = True
    canvas = jnp.zeros((h, w, 4), dtype=jnp.float32)
    canvas = merge_at(
        canvas, slow.convert(pre_alpha=True, linear_rgb=False).image,
        slow.offset,
    )
    np.testing.assert_allclose(fast, np.asarray(canvas), atol=2e-3)
