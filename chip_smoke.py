#!/usr/bin/env python3
"""GPU smoke run: drive the rasterizer's main path once on one GPU.

    python chip_smoke.py          # cli, serve and tiles phases, one GPU
    python chip_smoke.py --four   # only the sharded path across 4 GPUs

Everything runs in this one process (a JAX process reserves most of the
card's memory).  Scenes are generated from seeds (utils/stress.py), so
no assets are needed.  Phases:

  cli    one-shot CLI renders (cli.main, in-process) of the stress scene
         and a text line, decoded back with core/png.read_png
  serve  compile_scene + CompiledScene.render() x3 + render_many(8) on
         the 1024^2 stress scene, a 3840^2 stress scene and a filter-heavy
         icon sheet
  tiles  the 1024^2 stress scene served at tiles 32, 64 and 128
  four   (--four) CompiledScene and render_atlas over a 4-device "data"
         mesh, compared with the same renders on one device

Every output is compared with two oracles: (a) the per-path interpreter
(scene.py) on the same card, and (b) the same plan executed on the CPU
device of this process.  One line per phase reports compile seconds,
warm ms per frame (host clock around block_until_ready, median), the
device's peak bytes in use so far, and each max abs difference beside
its tolerance.  The last line is one JSON object naming the device.
Exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# oracle (b) runs on this process's CPU device: keep the CPU backend
# available when the platform list is pinned
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import svgrasterize_tpu.render_plan as rp  # noqa: E402
from svgrasterize_tpu import cli, scene_from_str  # noqa: E402
from svgrasterize_tpu.core.layer import merge_at  # noqa: E402
from svgrasterize_tpu.core.png import read_png  # noqa: E402
from svgrasterize_tpu.core.transform import Transform  # noqa: E402
from svgrasterize_tpu.parallel.atlas import render_atlas  # noqa: E402
from svgrasterize_tpu.text.fonts import DEFAULT_FONTS, FontsDB  # noqa: E402
from svgrasterize_tpu.utils.constants import DEVICE_FLOAT  # noqa: E402
from svgrasterize_tpu.utils.stress import (  # noqa: E402
    filter_doc, icon_doc, stress_doc, text_doc,
)

TR = Transform().matrix(0, 1, 0, 1, 0, 0)
PRECISION = "HIGHEST"  # every float32 device contraction asks for it
TOL_INTERP = 2e-3  # executor vs interpreter, premultiplied float
TOL_INTERP_CLIP = 0.02  # per-draw vs group clipping differs on AA edges
TOL_CPU = 2e-5  # same plan on the GPU vs on the CPU device
TOL_PNG = 2.0 / 255  # extra slack after 8-bit straight-alpha encoding

# the full-size scenes; tests/test_chip_smoke.py runs the same phases
# at tiny sizes on the CPU
FULL = {
    "stress": {"n_items": 2000, "size": 1024},
    "stress_3840": {"n_items": 8000, "size": 3840},
    "filter": {"n_groups": 32, "width": 1114, "height": 286},
    "icons": 52,
    "icon_size": 48,
    "atlas_cell": 64,
    "tiles": (32, 64, 128),
    "frames": 3,
    "many": 8,
}


class SmokeError(AssertionError):
    """An output disagreed with its oracle."""


def card_line() -> str:
    """`nvidia-smi` name and power limit, from a child that never imports
    JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        text = out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        text = f"nvidia-smi unavailable ({type(exc).__name__})"
    return f"card: {text}"


def require_gpu():
    """The first device, which must be a GPU; exits 2 otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(
            f"chip_smoke: no GPU found (JAX platform {dev.platform!r}); "
            "this script runs only on a GPU\n"
        )
        raise SystemExit(2)
    return dev


def peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def warm_ms(fn, frames: int) -> float:
    """Median host-clock ms of `frames` calls, each ended by
    block_until_ready."""
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def report(phase: str, **fields) -> None:
    parts = [f"{k}={v}" for k, v in fields.items()]
    print(f"[{phase}] " + " ".join(parts), flush=True)


def check(name: str, diff: float, tol: float) -> str:
    if not diff <= tol:
        raise SmokeError(f"{name}: max abs diff {diff} > tolerance {tol}")
    return f"{diff:.3g}<={tol:.3g}"


def _scene(svg: str, fonts=None):
    scene, _ids, size = scene_from_str(svg, fonts=fonts)
    w, h = int(size[0]), int(size[1])
    return scene, (0, 0, h, w)


def interpreter_image(scene, viewport):
    """The per-path interpreter's premultiplied canvas (viewport-sized)."""
    rp.HYBRID_ENABLED = False
    try:
        result = scene.render(TR, viewport=viewport)
    finally:
        rp.HYBRID_ENABLED = True
    _v0, _v1, h, w = viewport
    canvas = jnp.zeros((h, w, 4), DEVICE_FLOAT)
    if result is not None:
        layer, _hull = result
        canvas = merge_at(
            canvas,
            layer.convert(pre_alpha=True, linear_rgb=False).image,
            layer.offset,
        )
    return np.asarray(canvas)


def _max_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise SmokeError(f"shape mismatch {a.shape} vs {b.shape}")
    if not np.isfinite(a).all():
        raise SmokeError("non-finite output")
    return float(np.abs(a - b).max()) if a.size else 0.0


def host_plan(lowered):
    """The same lowered plan without the device arrays and programs that
    rendering cached on it, so it can run again on another device."""
    def items(d):
        return {k: v for k, v in d.items() if not k.startswith("_")}

    return lowered._replace(
        items=items(lowered.items),
        groups=[
            dict({k: v for k, v in g.items() if k != "_post_program"},
                 items=items(g["items"]))
            for g in lowered.groups
        ],
    )


def serve_phase(name, svg, dev, cpu, frames, many, tile=None,
                interp=True, clip_edges=True, cpu_oracle=True):
    """compile_scene + render() x frames + render_many(many) on `dev`;
    returns the measurements (and raises SmokeError on a mismatch)."""
    scene, viewport = _scene(svg)
    t0 = time.perf_counter()
    with jax.default_device(dev):
        compiled = rp.compile_scene(scene, TR, viewport, False, tile=tile)
        if compiled is None:
            raise SmokeError(f"{name}: scene did not lower")
        lower_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        first = np.asarray(compiled.render().image)
        first_s = time.perf_counter() - t1
        ms = warm_ms(lambda: compiled.render().image, frames)
        again = np.asarray(compiled.render().image)
        t2 = time.perf_counter()
        many_img = np.asarray(compiled.render_many(many).image)
        many_first_s = time.perf_counter() - t2
        many_ms = warm_ms(lambda: compiled.render_many(many).image, 1) / many
    lowered = compiled._lowered
    out = {
        "tile": compiled.tile,
        "grid": "x".join(map(str, lowered.grid)),
        "items": int((lowered.items["tile_id"]
                      < lowered.grid[0] * lowered.grid[1]).sum()),
        "passes": len(lowered.groups),
        "lower_s": lower_s,
        "compile_s": first_s - ms / 1e3,
        "warm_ms": ms,
        "many_compile_s": many_first_s,
        "many_ms_per_frame": many_ms,
        "peak_bytes": peak_bytes(dev),
        "deterministic": bool(np.array_equal(first, again)),
    }
    if not out["deterministic"]:
        raise SmokeError(f"{name}: two renders on {dev} differ")
    out["many_vs_render"] = check(
        f"{name} render_many", _max_diff(many_img, first), TOL_CPU
    )
    if cpu_oracle:
        with jax.default_device(cpu):
            plan = rp.CompiledScene(host_plan(lowered), viewport, False)
            ref = np.asarray(plan.render().image)
        out["vs_cpu"] = check(f"{name} vs cpu", _max_diff(first, ref), TOL_CPU)
    if interp:
        tol = TOL_INTERP_CLIP if clip_edges else TOL_INTERP
        with jax.default_device(dev):
            oracle = interpreter_image(scene, viewport)
        out["vs_interp"] = check(
            f"{name} vs interpreter", _max_diff(first, oracle), tol
        )
    return out


def _png_premul(path: str) -> np.ndarray:
    with open(path, "rb") as file:
        img = np.asarray(read_png(file), np.float64) / 255.0
    return np.concatenate([img[..., :3] * img[..., 3:], img[..., 3:]], -1)


def cli_phase(name, svg, workdir, dev, cpu, fonts, clip_edges):
    """One-shot CLI render on `dev` (cold, then warm), the same CLI run on
    the CPU device, and the interpreter's render through the same PNG
    encoder; all three decoded with read_png and compared premultiplied."""
    src = os.path.join(workdir, f"{name}.svg")
    with open(src, "w", encoding="utf-8") as file:
        file.write(svg)
    out_gpu = os.path.join(workdir, f"{name}.png")
    out_cpu = os.path.join(workdir, f"{name}_cpu.png")
    out_ref = os.path.join(workdir, f"{name}_interp.png")
    times = []
    with jax.default_device(dev):
        for _ in range(2):
            t0 = time.perf_counter()
            rc = cli.main([src, out_gpu])
            times.append(time.perf_counter() - t0)
            if rc != 0:
                raise SmokeError(f"cli {name}: exit code {rc}")
    with jax.default_device(cpu):
        if cli.main([src, out_cpu]) != 0:
            raise SmokeError(f"cli {name}: CPU run failed")
    scene, viewport = _scene(svg, fonts)
    from svgrasterize_tpu.core.layer import Layer

    with jax.default_device(dev):
        canvas = interpreter_image(scene, viewport)
        with open(out_ref, "wb") as file:
            Layer(jnp.asarray(canvas), (0, 0), True, False).write_png(file)
    got = _png_premul(out_gpu)
    _v0, _v1, h, w = viewport
    if got.shape != (h, w, 4):
        raise SmokeError(f"cli {name}: PNG shape {got.shape}")
    tol_a = (TOL_INTERP_CLIP if clip_edges else TOL_INTERP) + TOL_PNG
    return {
        "png": f"{w}x{h}",
        "cold_s": times[0],
        "warm_s": times[1],
        "peak_bytes": peak_bytes(dev),
        "vs_cpu": check(f"cli {name} vs cpu",
                        _max_diff(got, _png_premul(out_cpu)), TOL_PNG),
        "vs_interp": check(f"cli {name} vs interpreter",
                           _max_diff(got, _png_premul(out_ref)), tol_a),
    }


def tiles_phase(svg, dev, tiles, frames):
    """The stress scene served at each tile size: lowering, compile and
    warm ms, the numbers that pick the accelerator tile default."""
    scene, viewport = _scene(svg)
    rows = {}
    ref = None
    for tile in tiles:
        with jax.default_device(dev):
            t0 = time.perf_counter()
            compiled = rp.compile_scene(scene, TR, viewport, False, tile=tile)
            lower_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            img = np.asarray(compiled.render().image)
            first_s = time.perf_counter() - t1
            ms = warm_ms(lambda: compiled.render().image, frames)
        row = {
            "lower_s": lower_s,
            "compile_s": first_s - ms / 1e3,
            "warm_ms": ms,
            "items": int((compiled._lowered.items["tile_id"]
                          < np.prod(compiled._lowered.grid)).sum()),
            "peak_bytes": peak_bytes(dev),
        }
        if ref is None:
            ref = img
        else:
            # tile sizes bin edges differently: interpreter-level agreement
            row["vs_first_tile"] = check(
                f"tile {tile} vs {tiles[0]}", _max_diff(img, ref),
                TOL_INTERP_CLIP,
            )
        rows[tile] = row
    return rows


def four_phase(cfg, devices):
    """CompiledScene and render_atlas over a 1-D "data" mesh of
    `devices`, each compared with the same render on devices[0]."""
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(devices), ("data",))
    results = {}
    for key in ("stress", "stress_3840"):
        scene, viewport = _scene(stress_doc(**cfg[key]))
        with jax.default_device(devices[0]):
            one = rp.compile_scene(scene, TR, viewport, False)
            ref = np.asarray(one.render().image)
            sharded = rp.CompiledScene(
                host_plan(one._lowered), viewport, False, mesh=mesh
            )
            t0 = time.perf_counter()
            got = np.asarray(sharded.render().image)
            first_s = time.perf_counter() - t0
            ms = warm_ms(lambda: sharded.render().image, cfg["frames"])
        results[key] = {
            "tile": one.tile,
            "first_s": first_s,
            "warm_ms": ms,
            "vs_one_device": check(f"four {key}", _max_diff(got, ref), TOL_CPU),
        }
    docs = []
    for seed in range(cfg["icons"]):
        scene, _ids, size = scene_from_str(icon_doc(seed, cfg["icon_size"]))
        docs.append((scene, (float(size[0]), float(size[1]))))
    with jax.default_device(devices[0]):
        ref = np.asarray(render_atlas(docs, cell=cfg["atlas_cell"]).image)
        t0 = time.perf_counter()
        got = np.asarray(
            render_atlas(docs, cell=cfg["atlas_cell"], mesh=mesh).image
        )
        first_s = time.perf_counter() - t0
    results["atlas"] = {
        "docs": len(docs),
        "shape": "x".join(map(str, got.shape)),
        "first_s": first_s,
        "vs_one_device": check("four atlas", _max_diff(got, ref), TOL_CPU),
    }
    results["peak_bytes_per_device"] = [peak_bytes(d) for d in devices]
    return results


def run_default(cfg, dev, cpu, workdir):
    fonts = FontsDB()
    fonts.register_file(DEFAULT_FONTS)
    stress = stress_doc(**cfg["stress"])
    for name, svg, clip in (("stress", stress, True),
                            ("text", text_doc(), False)):
        report(f"cli {name}", **cli_phase(name, svg, workdir, dev, cpu,
                                          fonts, clip))
    for name, svg in (
        ("stress", stress),
        ("filter", filter_doc(**cfg["filter"])),
        ("stress_3840", stress_doc(**cfg["stress_3840"])),
    ):
        report(f"serve {name}", **serve_phase(
            name, svg, dev, cpu, cfg["frames"], cfg["many"],
            # the 3840^2 interpreter run would take minutes; its oracle
            # (a) is the 1024^2 scene of the same generator
            interp=name != "stress_3840",
        ))
    for tile, row in tiles_phase(stress, dev, cfg["tiles"],
                                 cfg["frames"]).items():
        report(f"tiles {tile}", **row)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the sharded path across 4 GPUs",
    )
    opts = parser.parse_args(argv)
    dev = require_gpu()
    cpu = jax.devices("cpu")[0]
    print(card_line(), flush=True)
    report(
        "env", jax=jax.__version__, XLA_FLAGS=repr(os.environ.get("XLA_FLAGS", "")),
        compile_cache=repr(jax.config.jax_compilation_cache_dir),
        precision=PRECISION,
        tolerances=f"interp={TOL_INTERP}/{TOL_INTERP_CLIP}(clip),"
                   f"cpu={TOL_CPU},png=+{TOL_PNG:.4f}",
    )
    if opts.four:
        devices = jax.devices()[:4]
        if len(devices) < 4 or any(d.platform != "gpu" for d in devices):
            sys.stderr.write(f"chip_smoke --four: needs 4 GPUs, have {devices}\n")
            return 2
        res = four_phase(FULL, devices)
        for key, row in res.items():
            if isinstance(row, dict):
                report(f"four {key}", **row)
        report("four", peak_bytes_per_device=res["peak_bytes_per_device"])
    else:
        with tempfile.TemporaryDirectory() as workdir:
            run_default(FULL, dev, cpu, workdir)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
