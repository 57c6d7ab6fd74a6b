"""The XLA executor (ops/batch_exec) vs the per-path interpreter (oracle).

Every scene family runs through the serving path (compile_scene at a
forced tile size, whole-plan program) at tiles 32, 64 and 128 — the
accelerator tile default is chosen from that range — and is compared
with scene.py's interpreter.  Tolerances follow tests/test_render_plan:
2e-3 on premultiplied float, 0.02 where group-level isolation (opacity
groups, masks) differs from per-draw compositing on AA edges.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import svgrasterize_tpu.render_plan as rp
from svgrasterize_tpu import scene_from_str
from svgrasterize_tpu.core.layer import merge_at
from svgrasterize_tpu.core.transform import Transform

TR = Transform().matrix(0, 1, 0, 1, 0, 0)
TILES = (32, 64, 128)

SVG = "<svg xmlns='http://www.w3.org/2000/svg' width='{w}' height='{h}'>{body}</svg>"


def _doc(body: str, w: int = 96, h: int = 64) -> str:
    return SVG.format(w=w, h=h, body=body)


def _random_featureful(seed: int) -> str:
    rng = np.random.default_rng(seed)
    defs = """<defs>
    <linearGradient id='lg'><stop offset='0' stop-color='#f00'/>
    <stop offset='1' stop-color='#00f'/></linearGradient>
    <radialGradient id='rg'><stop offset='0' stop-color='#fff'/>
    <stop offset='1' stop-color='#137'/></radialGradient>
    <clipPath id='c'><circle cx='48' cy='32' r='26'/></clipPath>
    <pattern id='p' width='6' height='6' patternUnits='userSpaceOnUse'>
    <rect width='3' height='3' fill='#d04020'/></pattern></defs>"""
    fills = ["url(#lg)", "url(#rg)", "url(#p)", "#20a040", "#a02060"]
    parts = []
    for _ in range(14):
        fill = fills[rng.integers(0, len(fills))]
        clip = " clip-path='url(#c)'" if rng.random() < 0.3 else ""
        op = rng.uniform(0.4, 1.0)
        if rng.random() < 0.5:
            x, y = rng.uniform(0, 70, 2)
            w, h = rng.uniform(6, 40, 2)
            parts.append(
                f"<rect x='{x:.1f}' y='{y:.1f}' width='{w:.1f}'"
                f" height='{h:.1f}' fill='{fill}' opacity='{op:.2f}'{clip}/>"
            )
        else:
            cx, cy = rng.uniform(10, 85, 2)
            r = rng.uniform(5, 22)
            parts.append(
                f"<circle cx='{cx:.1f}' cy='{cy:.1f}' r='{r:.1f}'"
                f" fill='{fill}' opacity='{op:.2f}'{clip}/>"
            )
    return _doc(defs + "".join(parts))


def _random_paths(seed: int) -> str:
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(12):
        kind = rng.integers(0, 3)
        color = "#%02x%02x%02x" % tuple(rng.integers(0, 256, 3))
        op = rng.uniform(0.3, 1.0)
        if kind == 0:
            x, y = rng.uniform(0, 80, 2)
            w, h = rng.uniform(5, 40, 2)
            parts.append(
                f"<rect x='{x:.1f}' y='{y:.1f}' width='{w:.1f}' height='{h:.1f}'"
                f" fill='{color}' opacity='{op:.2f}'/>"
            )
        elif kind == 1:
            cx, cy = rng.uniform(10, 85, 2)
            r = rng.uniform(4, 25)
            parts.append(
                f"<circle cx='{cx:.1f}' cy='{cy:.1f}' r='{r:.1f}'"
                f" fill='{color}' opacity='{op:.2f}'/>"
            )
        else:
            pts = rng.uniform(0, 96, (4, 2))
            d = "M" + " L".join(f"{p[0]:.1f} {p[1]:.1f}" for p in pts) + " Z"
            rule = "evenodd" if rng.random() < 0.5 else "nonzero"
            parts.append(
                f"<path d='{d}' fill='{color}' fill-rule='{rule}'"
                f" opacity='{op:.2f}'/>"
            )
    return _doc("".join(parts))


def _big_segment_classes() -> str:
    # 40-vertex polygons: heavy edge lists that form big segment classes
    rng = np.random.default_rng(7)
    parts = []
    for i in range(8):
        cx, cy = 20 + i * 40, 32
        pts = []
        for k in range(40):
            ang = 2 * np.pi * k / 40
            r = 14 + 6 * rng.random()
            pts.append(f"{cx + r * np.cos(ang):.2f} {cy + r * np.sin(ang):.2f}")
        parts.append(
            f"<path d='M{' L'.join(pts)} Z' fill='#2060c0' opacity='0.8'/>"
        )
    return _doc("".join(parts), w=336)


FAMILIES = {
    "solids_rules_opacity": (_doc(
        "<rect x='4' y='4' width='50' height='40' fill='#d04020'/>"
        "<circle cx='70' cy='32' r='20' fill='#2060c0' opacity='0.7'/>"
        "<path d='M10 50 L90 44 L50 62 Z M20 48 L80 48 L50 60 Z'"
        " fill='#20a040' fill-rule='evenodd'/>"
    ), 2e-3),
    "gradients_clips_carries": (_doc(
        "<defs><linearGradient id='lg' x1='0' y1='0' x2='1' y2='1'"
        " spreadMethod='reflect'><stop offset='0' stop-color='#ff0000'/>"
        "<stop offset='0.5' stop-color='#00ff00'/>"
        "<stop offset='1' stop-color='#0000ff'/></linearGradient>"
        "<radialGradient id='rg' cx='0.5' cy='0.5' r='0.5' fx='0.3' fy='0.3'>"
        "<stop offset='0' stop-color='#ffffff'/>"
        "<stop offset='1' stop-color='#204080'/></radialGradient>"
        "<clipPath id='c'><circle cx='30' cy='30' r='22'/></clipPath></defs>"
        "<rect x='4' y='4' width='50' height='40' fill='url(#rg)'"
        " clip-path='url(#c)'/>"
        "<rect x='56' y='6' width='36' height='20' fill='url(#lg)'/>"
        "<path d='M2 2 C 90 0, 4 60, 94 62 L 94 2 Z' fill='#208040'"
        " opacity='0.5'/>"
    ), 2e-3),
    "pool_tex_and_mask": (_doc(
        "<defs><mask id='m'><rect x='0' y='0' width='96' height='64'"
        " fill='#606060'/><circle cx='48' cy='32' r='18' fill='white'/>"
        "</mask></defs>"
        "<g opacity='0.6'><rect x='8' y='8' width='40' height='30'"
        " fill='#c03020'/><circle cx='40' cy='40' r='14' fill='#30a050'/></g>"
        "<rect x='30' y='10' width='60' height='44' fill='#2060c0'"
        " mask='url(#m)'/>"
    ), 0.02),
    "patterns": (_doc(
        "<defs><pattern id='p' width='8' height='8'"
        " patternUnits='userSpaceOnUse'>"
        "<rect x='0' y='0' width='4' height='4' fill='#d04020'/>"
        "<rect x='4' y='4' width='4' height='4' fill='#2060c0'/></pattern>"
        "</defs>"
        "<rect x='4' y='4' width='60' height='40' fill='url(#p)'/>"
        "<circle cx='75' cy='40' r='18' fill='url(#p)'/>"
        "<rect x='10' y='48' width='40' height='12' fill='#20a040'/>"
    ), 2e-3),
    "big_segment_classes": (_big_segment_classes(), 2e-3),
    "random_featureful_3": (_random_featureful(3), 2e-3),
    "random_featureful_4": (_random_featureful(4), 2e-3),
    "random_paths_0": (_random_paths(0), 2e-3),
    "random_paths_1": (_random_paths(1), 2e-3),
}


@functools.lru_cache(maxsize=None)
def _interpreter(name: str) -> np.ndarray:
    scene, _ids, size = scene_from_str(FAMILIES[name][0])
    w, h = int(size[0]), int(size[1])
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
    return np.asarray(canvas)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_executor_matches_interpreter(family, tile):
    doc, atol = FAMILIES[family]
    scene, _ids, size = scene_from_str(doc)
    w, h = int(size[0]), int(size[1])
    compiled = rp.compile_scene(scene, TR, (0, 0, h, w), False, tile=tile)
    assert compiled is not None and compiled.tile == tile
    got = np.asarray(compiled.render().image)
    np.testing.assert_allclose(got, _interpreter(family), atol=atol)


@pytest.mark.parametrize("tile", TILES)
def test_whole_plan_planar_pool_matches_per_stage(tile):
    """The serving (whole-plan) program keeps the isolation pool
    channel-planar end to end (one scratch row baked in, tight capacity);
    it must match the per-stage programs' interleaved pool."""
    doc = _doc(
        "<defs><mask id='m'><rect x='0' y='0' width='96' height='64'"
        " fill='#606060'/><circle cx='48' cy='32' r='18' fill='white'/>"
        "</mask><filter id='f'><feGaussianBlur stdDeviation='1.5'/>"
        "</filter></defs>"
        "<g opacity='0.6'><rect x='8' y='8' width='40' height='30'"
        " fill='#c03020'/><circle cx='40' cy='40' r='14' fill='#30a050'/></g>"
        "<rect x='30' y='10' width='60' height='44' fill='#2060c0'"
        " mask='url(#m)'/>"
        "<circle cx='76' cy='20' r='12' fill='#a0b020' filter='url(#f)'/>"
    )
    scene, _ids, _size = scene_from_str(doc)
    lowered = rp.lower_scene(scene, TR, (0, 0, 64, 96), False, tile=tile)
    assert lowered is not None and lowered.groups, "needs isolation passes"
    per_stage = np.asarray(rp.execute_lowered(lowered, (0, 0), False, whole=False))
    whole = np.asarray(rp.execute_lowered(lowered, (0, 0), False, whole=True))
    np.testing.assert_allclose(whole, per_stage, atol=1e-6)
