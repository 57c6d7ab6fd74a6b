"""8K-canvas robustness: 7680-wide material through the serving program.

At 7680² (59 Mpx) the canvas is 4x the area of the largest other tested
canvas; this pins that the whole-plan serving program survives it and
equals the per-stage execution path.

Slow lane: two 59 Mpx renders on the CPU backend (~minutes cold).
"""

from __future__ import annotations

import numpy as np
import pytest

from svgrasterize_tpu import scene_from_filepath
from svgrasterize_tpu.core.transform import Transform
from svgrasterize_tpu.render_plan import compile_scene, execute_lowered

DEMO = "/root/reference/demo/material-design.svg"


@pytest.mark.slow
def test_material_7680_whole_plan_matches_stages():
    import os

    if not os.path.isfile(DEMO):
        pytest.skip("reference demo assets not available")
    scene, _ids, size = scene_from_filepath(DEMO, width=7680)
    w, h = int(size[0]), int(size[1])
    assert w == 7680
    compiled = compile_scene(
        scene, Transform().matrix(0, 1, 0, 1, 0, 0), (0, 0, h, w), False
    )
    assert compiled is not None, "8K material must lower"
    whole = np.asarray(compiled.render_tiles_planar())
    assert np.isfinite(whole).all()
    staged = np.asarray(
        execute_lowered(
            compiled._lowered, (0, 0), False, whole=False, planar=True
        )
    )
    np.testing.assert_allclose(whole, staged, atol=1e-5)
    # the canvas really is 8K-scale
    gh, gw = compiled._lowered.grid
    assert gh * compiled.tile >= 7680
