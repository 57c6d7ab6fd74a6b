"""Device-facing setup: the compile-cache directory rule, the precision
of every float32 device contraction, and GPU-only checks (marked `gpu`,
skipped without a card)."""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import jax, svgrasterize_tpu
print("DIR", jax.config.jax_compilation_cache_dir)
"""


def _cache_dir(env_update: dict) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "SVGR_COMPILE_CACHE")}
    env.update(env_update, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], env=env, capture_output=True,
        text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return [line for line in proc.stdout.splitlines()
            if line.startswith("DIR")][0].split(" ", 1)[1]


def test_cache_dir_follows_env(tmp_path):
    target = str(tmp_path / "cache")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": target}) == target
    assert os.path.isdir(target)


def test_cache_dir_defaults_inside_checkout():
    assert _cache_dir({}) == os.path.join(REPO, ".jax_cache")


def test_cache_off_switch():
    assert _cache_dir({"SVGR_COMPILE_CACHE": "0"}) == "None"


def test_default_cache_dir_rule(monkeypatch):
    from svgrasterize_tpu import default_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert default_cache_dir() == os.path.join(REPO, ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/dir")
    assert default_cache_dir() == "/some/dir"


def _dot_precisions(fn, *args):
    """Precision of every dot_general in fn's jaxpr (nested jaxprs too)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _highest(precision) -> bool:
    hi = jax.lax.Precision.HIGHEST
    if isinstance(precision, tuple):
        return all(p == hi for p in precision)
    return precision == hi


def _mask_luminance():
    from svgrasterize_tpu.ops import batch_exec

    t = 8
    item = {
        "_wind": jnp.ones((t, t)), "carry": jnp.zeros((t,)),
        "fill_rule": jnp.int32(0), "opacity": jnp.float32(1.0),
        "_mask_tex": jnp.ones((t, t, 4)), "mask_idx": jnp.int32(0),
        "affine": jnp.eye(2, 3), "p0": jnp.zeros(2), "p1": jnp.ones(2),
        "center": jnp.zeros(2), "fcenter": jnp.zeros(2),
        "radius": jnp.float32(1), "fradius": jnp.float32(0),
        "kind": jnp.int32(0), "spread": jnp.int32(0),
        "stop_offsets": jnp.asarray([0.0, 1.0]),
        "stop_colors": jnp.ones((2, 4)), "color": jnp.ones(4),
        "tile_r": jnp.float32(0), "tile_c": jnp.float32(0),
    }
    return lambda it: batch_exec._raster_item(it, t), (item,)


def _gradient_affine():
    from svgrasterize_tpu.ops import gradient

    return gradient.apply_affine, (jnp.ones((4, 4, 2)), jnp.eye(2, 3))


def _linear_fill():
    from svgrasterize_tpu.ops import gradient

    def fn(aff):
        return gradient.linear_fill(
            8, 8, jnp.zeros(2), aff, jnp.zeros(2), jnp.ones(2),
            jnp.asarray([0.0, 1.0]), jnp.ones((2, 4)),
        )

    return fn, (jnp.eye(2, 3),)


def _color_matrix():
    from svgrasterize_tpu.core.layer import Layer

    def fn(img):
        return Layer(img, (0, 0), True, False).color_matrix(
            np.eye(4, 5), linear_rgb=False
        ).image

    return fn, (jnp.ones((4, 4, 4)),)


def _interpreter_mask():
    from svgrasterize_tpu import scene_from_str
    from svgrasterize_tpu.core.transform import Transform

    scene, _ids, _size = scene_from_str(
        "<svg xmlns='http://www.w3.org/2000/svg' width='16' height='16'>"
        "<defs><mask id='m'><rect width='16' height='8' fill='#808080'/>"
        "</mask></defs><rect width='16' height='16' fill='red'"
        " mask='url(#m)'/></svg>"
    )

    def fn(_x):
        return scene.render(
            Transform().matrix(0, 1, 0, 1, 0, 0), viewport=(0, 0, 16, 16)
        )[0].image

    return fn, (jnp.zeros(()),)


@pytest.mark.parametrize(
    "site",
    [_mask_luminance, _gradient_affine, _linear_fill, _color_matrix,
     _interpreter_mask],
    ids=["mask_luminance", "gradient_affine", "linear_projection",
         "color_matrix", "interpreter_mask"],
)
def test_device_contractions_ask_for_highest(site):
    """A float32 contraction without a precision may run in TF32 on a GPU;
    every one on the device path asks for HIGHEST."""
    fn, args = site()
    precisions = _dot_precisions(fn, *args)
    assert precisions, "the site should contract on the device"
    assert all(_highest(p) for p in precisions), precisions


@pytest.mark.gpu
def test_gpu_serve_matches_cpu_device(gpu):
    """The same plan on the GPU and on the CPU device agree to 2e-5."""
    import svgrasterize_tpu.render_plan as rp
    from svgrasterize_tpu import scene_from_str
    from svgrasterize_tpu.core.transform import Transform
    from svgrasterize_tpu.utils.stress import filter_doc, stress_doc

    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    for doc in (stress_doc(n_items=200, size=256),
                filter_doc(n_groups=8, width=320, height=96)):
        scene, _ids, size = scene_from_str(doc)
        viewport = (0, 0, int(size[1]), int(size[0]))
        with jax.default_device(gpu):
            got = np.asarray(
                rp.compile_scene(scene, tr, viewport, False, tile=64)
                .render().image
            )
        with jax.default_device(jax.devices("cpu")[0]):
            ref = np.asarray(
                rp.compile_scene(scene, tr, viewport, False, tile=64)
                .render().image
            )
        np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.gpu
def test_gpu_renders_are_bit_identical(gpu):
    """Two renders of one plan on the card give the same bits (the canvas
    scatter's duplicate ids are only the scratch tile)."""
    import svgrasterize_tpu.render_plan as rp
    from svgrasterize_tpu import scene_from_str
    from svgrasterize_tpu.core.transform import Transform
    from svgrasterize_tpu.utils.stress import stress_doc

    scene, _ids, size = scene_from_str(stress_doc(n_items=300, size=256))
    with jax.default_device(gpu):
        compiled = rp.compile_scene(
            scene, Transform().matrix(0, 1, 0, 1, 0, 0),
            (0, 0, int(size[1]), int(size[0])), False,
        )
        a = np.asarray(compiled.render().image)
        b = np.asarray(compiled.render().image)
    np.testing.assert_array_equal(a, b)
