"""Batched blur-part execution (ops/filter_batch) vs the per-part path.

The batched path replaces each single-feGaussianBlur isolation part's op
chain with chunked batched band matmuls; it must match the per-part path
to float precision on every part shape it admits (separable blurs,
sub-pixel identity blurs, SourceAlpha inputs, both colorspaces) and must
leave inadmissible parts (non-separable kernels, multi-primitive chains)
to the per-part path.
"""

import os

import numpy as np
import pytest

import svgrasterize_tpu.render_plan as rp
from svgrasterize_tpu.core.transform import Transform
from svgrasterize_tpu.frontend.svg import scene_from_str

TR = Transform().matrix(0, 1, 0, 1, 0, 0)

BLURS = """<svg xmlns='http://www.w3.org/2000/svg' width='200' height='150'>
<defs>
 <filter id='b1'><feGaussianBlur stdDeviation='3'/></filter>
 <filter id='b2'><feGaussianBlur stdDeviation='1.5 4'/></filter>
 <filter id='b3'><feGaussianBlur stdDeviation='0.1'/></filter>
 <filter id='ba'><feGaussianBlur in='SourceAlpha' stdDeviation='2'/></filter>
</defs>
<rect x='10' y='10' width='60' height='40' fill='#c03030' filter='url(#b1)'/>
<circle cx='120' cy='40' r='25' fill='#3060c0' opacity='0.7' filter='url(#b2)'/>
<rect x='30' y='80' width='40' height='30' fill='#30a050' filter='url(#b3)'/>
<ellipse cx='140' cy='100' rx='30' ry='18' fill='#a050a0' filter='url(#ba)'/>
<rect x='80' y='120' width='100' height='20' fill='#806020' filter='url(#b1)'/>
</svg>"""

MIXED = """<svg xmlns='http://www.w3.org/2000/svg' width='160' height='120'>
<defs>
 <filter id='b'><feGaussianBlur stdDeviation='2'/></filter>
 <filter id='sh'><feDropShadow dx='3' dy='3' stdDeviation='2'/></filter>
</defs>
<rect x='10' y='10' width='50' height='40' fill='#c03030' filter='url(#b)'/>
<rect x='80' y='20' width='50' height='40' fill='#3060c0' filter='url(#sh)'/>
<circle cx='50' cy='90' r='20' fill='#108030' filter='url(#b)'/>
</svg>"""


def _render(doc: str, batch: bool, linear: bool = False):
    scene, _ids, size = scene_from_str(doc)
    viewport = (0, 0, int(size[1]), int(size[0]))
    prev = os.environ.get("SVGR_BLUR_BATCH")
    try:
        os.environ["SVGR_BLUR_BATCH"] = "1" if batch else "0"
        lowered = rp.lower_scene(scene, TR, viewport, linear)
        assert lowered is not None
        out = np.asarray(rp.execute_lowered(lowered, viewport[:2], linear))
    finally:
        if prev is None:
            os.environ.pop("SVGR_BLUR_BATCH", None)
        else:
            os.environ["SVGR_BLUR_BATCH"] = prev
    n_batched = sum(
        len(g.get("_blur_batch", ((), set()))[1]) for g in lowered.groups
    )
    return out, n_batched


@pytest.mark.parametrize("linear", [False, True], ids=["srgb", "linear"])
def test_batched_blurs_match_per_part(linear):
    ref, n0 = _render(BLURS, batch=False, linear=linear)
    got, n1 = _render(BLURS, batch=True, linear=linear)
    assert n0 == 0 and n1 == 5, (n0, n1)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_mixed_chains_partition():
    """Drop-shadow chains stay per-part; lone blurs batch; results agree."""
    ref, _ = _render(MIXED, batch=False)
    got, n1 = _render(MIXED, batch=True)
    assert n1 == 2, n1
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_folded_chunk_matches_default():
    """SVGR_CHUNK_FOLD (band matmuls contracting tiled axis pairs) must
    reproduce the image-form chunk math to float rounding."""
    import jax
    import jax.numpy as jnp

    from svgrasterize_tpu.ops import filter_batch as fb

    rng = np.random.default_rng(7)
    T = 32
    B, NSi, NSj, NOi, NOj = 3, 2, 3, 3, 2
    n_rows = 20
    canvas = jnp.asarray(rng.random((n_rows, T, 4 * T)), jnp.float32)
    lut = rng.integers(-1, n_rows, (B, NSi * NSj)).astype(np.int32)
    out_idx = []
    for b in range(B):
        for _ in range(2):
            di, dj = rng.integers(0, NOi), rng.integers(0, NOj)
            out_idx.append((b * NOi + di) * NOj + dj)
    u = rng.random(5)
    u /= u.sum()
    v = rng.random(3)
    v /= v.sum()
    ck = {
        "B": B, "NSi": NSi, "NSj": NSj, "NOi": NOi, "NOj": NOj,
        "chain_linear": True, "lut": lut,
        "bh": np.stack(
            [fb._band(u, 40, 3, -2, NOi * T, NSi * T) for _ in range(B)]
        ).astype(np.float32),
        "bw": np.stack(
            [fb._band(v, 70, 5, 1, NOj * T, NSj * T) for _ in range(B)]
        ).astype(np.float32),
        "src_alpha": np.array([True, False, False]),
        "out_idx": np.array(out_idx, np.int32),
        "pool_idx": list(range(len(out_idx))),
    }
    prev = os.environ.get("SVGR_CHUNK_FOLD")
    try:
        os.environ["SVGR_CHUNK_FOLD"] = "0"
        ref = jax.jit(
            lambda c: fb.apply_chunk(c, ck, T, False, planar=True)
        )(canvas)
        os.environ["SVGR_CHUNK_FOLD"] = "1"
        got = jax.jit(
            lambda c: fb.apply_chunk(c, ck, T, False, planar=True)
        )(canvas)
    finally:
        if prev is None:
            os.environ.pop("SVGR_CHUNK_FOLD", None)
        else:
            os.environ["SVGR_CHUNK_FOLD"] = prev
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("gamma", [False, True], ids=["nogamma", "gamma"])
def test_chunk_planar_matches_interleaved(gamma):
    """apply_chunk on a channel-planar canvas (the whole-plan program's
    layout) equals the interleaved-canvas path row for row — including
    1x1 spans, SourceAlpha members, and both gamma chains."""
    import jax.numpy as jnp

    from svgrasterize_tpu.ops import filter_batch as fb
    from svgrasterize_tpu.ops.layout import from_planar, to_planar

    rng = np.random.default_rng(11)
    T = 32
    for NSi, NSj, NOi, NOj, B in [(1, 1, 1, 1, 2), (2, 3, 3, 2, 3)]:
        S, O = NSi * NSj, NOi * NOj
        n_rows = 12
        canvas = jnp.asarray(rng.random((n_rows, T, T, 4)), jnp.float32)
        lut = rng.integers(-1, n_rows, (B, S)).astype(np.int32)
        u = rng.random(5)
        u /= u.sum()
        v = rng.random(3)
        v /= v.sum()
        out_idx = np.asarray(
            rng.permutation(B * O)[: B * O // 2 + 1], np.int32
        )
        ck = {
            "B": B, "NSi": NSi, "NSj": NSj, "NOi": NOi, "NOj": NOj,
            "chain_linear": gamma, "lut": lut,
            "bh": np.stack(
                [fb._band(u, NSi * T - 3, 1, -2, NOi * T, NSi * T)
                 for _ in range(B)]
            ).astype(np.float32),
            "bw": np.stack(
                [fb._band(v, NSj * T - 5, 2, 1, NOj * T, NSj * T)
                 for _ in range(B)]
            ).astype(np.float32),
            "src_alpha": np.arange(B) % 2 == 0,
            "out_idx": out_idx,
            "pool_idx": list(range(len(out_idx))),
        }
        ref = np.asarray(fb.apply_chunk(canvas, ck, T, False, planar=False))
        got = fb.apply_chunk(to_planar(canvas), ck, T, False, planar=True)
        assert ref.shape == (len(out_idx), T, T, 4)
        np.testing.assert_allclose(np.asarray(from_planar(got)), ref, atol=2e-6)
