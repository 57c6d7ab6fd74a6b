"""Cross-process serving cache: compiled scene programs survive restarts.

A fresh process rendering a previously-compiled scene must reuse the
persistent compilation cache (svgrasterize_tpu.__init__ wires it up in
JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache).

CPU's XLA AOT artifacts may fail their machine-feature check on reload
(upstream XLA quirk), so the CI assertions here are platform-safe: entries
are written, cache keys are stable across processes (the second run adds
no new entries), and outputs are identical.  Marked slow (two subprocess
compiles).
"""

import os
import subprocess
import sys

import pytest

SCRIPT = """
import sys, os
os.environ["JAX_COMPILATION_CACHE_DIR"] = sys.argv[1]
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import svgrasterize_tpu.render_plan as rp
from svgrasterize_tpu import scene_from_str
from svgrasterize_tpu.core.transform import Transform

svg = (
    "<svg xmlns='http://www.w3.org/2000/svg' width='96' height='64'>"
    "<defs><linearGradient id='lg'><stop offset='0' stop-color='#f00'/>"
    "<stop offset='1' stop-color='#00f'/></linearGradient></defs>"
    "<rect x='4' y='4' width='50' height='40' fill='url(#lg)'/>"
    "<circle cx='70' cy='40' r='18' fill='#20a040'/></svg>"
)
scene, _ids, _size = scene_from_str(svg)
out = rp.render_fast(scene, Transform().matrix(0, 1, 0, 1, 0, 0),
                     (0, 0, 64, 96), False)
print("SUM", float(np.asarray(out[0].image).sum()))
"""


@pytest.mark.slow
def test_cache_survives_process_restart(tmp_path):
    cache_dir = str(tmp_path / "cache")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}

    def run():
        proc = subprocess.run(
            [sys.executable, "-c", SCRIPT, cache_dir],
            env=env, capture_output=True, text=True, timeout=560,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = [l for l in proc.stdout.splitlines() if l.startswith("SUM")][0]
        return float(line.split()[1])

    sum1 = run()
    entries = set(os.listdir(cache_dir))
    assert entries, "first process wrote no cache entries"

    sum2 = run()
    assert sum2 == sum1
    # identical cache keys across processes: the warm run adds nothing new
    assert set(os.listdir(cache_dir)) == entries
