"""CompiledScene.render_many: k frames in one dispatch == k single renders.

Every serve call pays a dispatch; render_many chains k frames in one
jitted fori_loop.  Values must be IDENTICAL to the
single-frame program — the loop serializes with a zero-valued data
dependency only.
"""

import jax.numpy as jnp
import numpy as np

from svgrasterize_tpu.core.transform import Transform
from svgrasterize_tpu.frontend.svg import scene_from_str
from svgrasterize_tpu.render_plan import compile_scene

PLAIN_DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="256" height="192">
  <defs><linearGradient id="g"><stop offset="0" stop-color="#d04020"/>
    <stop offset="1" stop-color="#2040d0" stop-opacity="0.7"/></linearGradient></defs>
  <rect x="8" y="8" width="240" height="176" fill="url(#g)"/>
  <circle cx="128" cy="96" r="60" fill="#20a040" fill-opacity="0.8"/>
  <path d="M20 180 L128 20 L236 180 Z" fill="#202020" fill-opacity="0.4"/>
</svg>
"""

MULTIPASS_DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="256" height="192">
  <defs>
    <mask id="m"><rect x="16" y="16" width="224" height="160" fill="white"/>
      <circle cx="128" cy="96" r="40" fill="black"/></mask>
    <pattern id="p" width="16" height="16" patternUnits="userSpaceOnUse">
      <rect width="8" height="8" fill="#aa2200"/></pattern>
    <filter id="b"><feGaussianBlur stdDeviation="2"/></filter>
  </defs>
  <rect x="4" y="4" width="248" height="184" fill="url(#p)"/>
  <g opacity="0.5"><rect x="30" y="30" width="120" height="80" fill="blue"/></g>
  <rect x="60" y="24" width="160" height="140" fill="#00aa88" mask="url(#m)"/>
  <circle cx="60" cy="140" r="28" fill="purple" filter="url(#b)"/>
</svg>
"""


def _compiled(doc):
    scene, _ids, size = scene_from_str(doc)
    w, h = int(size[0]), int(size[1])
    compiled = compile_scene(
        scene, Transform().matrix(0, 1, 0, 1, 0, 0), (0, 0, h, w), False
    )
    assert compiled is not None
    return compiled


def test_render_many_plain_matches_single():
    compiled = _compiled(PLAIN_DOC)
    one = np.asarray(compiled.render_tiles_planar())
    many = np.asarray(compiled.render_tiles_many(3))
    np.testing.assert_array_equal(many, one)


def test_render_many_multipass_matches_single():
    compiled = _compiled(MULTIPASS_DOC)
    one = np.asarray(compiled.render_tiles_planar())
    many = np.asarray(compiled.render_tiles_many(4))
    np.testing.assert_array_equal(many, one)
    # k is a traced scalar: a second k reuses the compiled program
    many1 = np.asarray(compiled.render_tiles_many(1))
    np.testing.assert_array_equal(many1, one)


def test_render_many_layer_matches_render():
    compiled = _compiled(PLAIN_DOC)
    a = np.asarray(compiled.render().image)
    b = np.asarray(compiled.render_many(2).image)
    np.testing.assert_array_equal(b, a)
