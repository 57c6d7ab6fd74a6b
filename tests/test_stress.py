"""Pathological stress scene (slow lane): the anti-collapse worst case.

utils/stress.stress_doc builds thousands of small overlapping gradient/
clip items with scattered opacity passes — nothing collapses, tile runs
mix pass classes deeply.  Guards: (a) the plan must actually BE
pathological (almost no field items), (b) the serving executor still
matches the per-path interpreter on it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import svgrasterize_tpu.render_plan as rp
from svgrasterize_tpu import scene_from_str
from svgrasterize_tpu.core.layer import merge_at
from svgrasterize_tpu.core.transform import Transform
from svgrasterize_tpu.utils.stress import stress_doc

TR = Transform().matrix(0, 1, 0, 1, 0, 0)


@pytest.mark.slow
def test_stress_plan_resists_collapse_and_matches_oracle():
    doc = stress_doc(n_items=400, size=512)
    scene, _ids, size = scene_from_str(doc)
    w, h = int(size[0]), int(size[1])
    compiled = rp.compile_scene(scene, TR, (0, 0, h, w), False, tile=32)
    assert compiled is not None
    lowered = compiled._lowered
    n_real = int(
        (lowered.items["tile_id"] < lowered.grid[0] * lowered.grid[1]).sum()
    )
    fidx = lowered.items.get("field_idx")
    n_field = 0 if fidx is None else int((fidx >= 0).sum())
    # gradients + interleaved clips must leave the stack uncollapsible
    assert n_real > 300
    assert n_field <= n_real // 20, (n_field, n_real)
    got = np.asarray(compiled.render().image)
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
    # group clipping differs from per-draw clipping on AA edges
    np.testing.assert_allclose(got, np.asarray(canvas), atol=0.02)
