"""Headline benchmark: full-scene render throughput on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "configs"}.
The headline metric is the reference's own flagship demo
(demo/material-design.svg, 1488x1488) rendered by the whole-scene XLA
executor; "configs" carries the rest of BASELINE.json's config matrix:

  material_1488_mpx_s  raw executor throughput (the headline)
  material_3840_mpx_s  the same scene at 4K (3840x3840, tile 64)
  icons_serve_ms       icons.svg (32 Gaussian blurs, 891 refs) per-call
                       CompiledScene serving latency, dispatch included
  prompt_serve_ms      prompt.svg (SVG-font text) serving latency
  sprite_atlas_mpx_s   13-icon sprite atlas batch via CompiledScene
  sprite_atlas_unique_mpx_s  52 DISTINCT docs (dedup cannot fire)
  icons_serve_many_ms  icons k-frame serving (render_many: one dispatch)
  stress_serve_ms      anti-collapse pathological scene (per-item floor)

The reference renders material-design in 2.08s (1.06 Mpx/s) on this
machine (BASELINE.md; it publishes no numbers of its own); vs_baseline is
the speedup over that.  Timing is the SLOPE between 1 and K chained
executions (each iteration data-depends on the previous), so dispatch
latency, transfers, and compile time cancel.  Serving latencies use
the per-call delta (t(n) - t(1)) / (n - 1) instead, which keeps the
per-call dispatch cost in the number (that IS the serving metric).

Falls back to a synthetic fill-batch kernel benchmark when the demo assets
are unavailable.
"""

from __future__ import annotations

import json
import os
import sys
import time

REFERENCE_SCENE_MPX_S = 1.06  # BASELINE.md: material-design.svg native size
REFERENCE_KERNEL_MPX_S = 1.34  # BASELINE.md: best measured reference rate
DEMO_DIR = "/root/reference/demo"
DEMO = os.path.join(DEMO_DIR, "material-design.svg")
# every refined timing point must span at least this much device work, so
# per-force jitter stays at the ~1-2% level
TARGET_CHAIN_S = float(os.environ.get("SVGR_BENCH_CHAIN_S", "0.2"))


def _quick_slope(run, k: int = 8) -> float:
    """One slope reading between 1 and 1+k chained executions.  Chained
    slopes cancel dispatch latency, transfers, and compile time.

    A short chain can read t(1+k) <= t(1) under jitter; retry with doubled
    chains until the slope is positive (a non-positive capture would ship
    an absurd value if the refine pass ever runs out of budget)."""
    for _ in range(6):
        t1 = run(1)
        tk = run(1 + k)
        if tk > t1:
            return (tk - t1) / k
        k *= 2
    return max((tk - t1) / k, 1e-9)


def _checked_slope(run, k: int = 4, tol: float = 0.3, attempts: int = 3,
                   errors: dict | None = None, key: str | None = None):
    """Self-checking capture reading: two chain lengths must agree within
    tol, else double and retry.  A single short-chain reading can be far
    off either way; requiring two independent chain lengths to agree
    bounds that failure mode even when the refine pass never runs.
    Returns the longer-chain slope (longer chains amortize per-force
    jitter).

    When every attempt disagrees the final reading still ships, but a
    `<key>_capture: "chains disagreed"` note lands in `errors` so artifact
    readers know the value never self-validated (a refine pass may still
    replace it with a spread-carrying median)."""
    s2 = None
    for _ in range(attempts):
        s1 = _quick_slope(run, k)
        s2 = _quick_slope(run, 2 * k)
        if abs(s1 - s2) <= tol * min(s1, s2):
            return s2
        k *= 2
    if errors is not None and key is not None:
        errors[key + "_capture"] = "chains disagreed"
    return s2


def _refine_slope(run, reps: int = 5, k: int = 8, max_k: int = 8192):
    """(median, slopes): adaptive-chain slope timing.

    Grows the chain length until one timing point spans TARGET_CHAIN_S of
    device work, then records `reps` slopes.  The median is the metric (the
    min of several slopes is biased fast: a slow t(1) deflates that rep's
    slope — observed a 0.6 ms reading for a 1.4 ms frame); the full sorted
    slope list is returned so the artifact carries the spread."""
    per = _quick_slope(run, k)
    while per * k < TARGET_CHAIN_S and k < max_k:
        k = min(max_k, max(2 * k, int(TARGET_CHAIN_S / per) + 1))
        per = _quick_slope(run, k)
    slopes = [per] + [_quick_slope(run, k) for _ in range(reps - 1)]
    slopes.sort()
    return slopes[len(slopes) // 2], slopes


def _material_runner(width: int | None):
    """Raw XLA-executor run(k) chain on material-design; returns
    (run, mpx, detail)."""
    import jax
    import jax.numpy as jnp

    from svgrasterize_tpu import render_plan as rp
    from svgrasterize_tpu import scene_from_filepath
    from svgrasterize_tpu.core.transform import Transform
    from svgrasterize_tpu.ops import batch_exec

    scene, _ids, size = scene_from_filepath(DEMO, width=width)
    w, h = int(size[0]), int(size[1])
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    t_lower = time.perf_counter()
    lowered = rp.lower_scene(scene, tr, (0, 0, h, w), False)
    assert not lowered.groups, "headline scene should lower to a single pass"
    t_lower = time.perf_counter() - t_lower
    # a cold first lowering inherits whatever transient machine load the
    # bench started under; time a second one so the tail reports both
    t_lower2 = time.perf_counter()
    rp.lower_scene(scene, tr, (0, 0, h, w), False)
    t_lower2 = time.perf_counter() - t_lower2
    gh, gw = lowered.grid
    items = lowered.items
    # the upload is cached per plan in serving (render_plan._device_plan),
    # so the per-frame figure starts at the executor — same contract
    cache = rp._device_plan(items, lowered.bigs, lowered.clips)

    @jax.jit
    def loop(dev, bigs, clips, iters):
        def body(_i, carry):
            d = dict(dev)
            d["opacity"] = dev["opacity"] + carry  # serialize iterations
            tiles = batch_exec.execute_items(
                d, lowered.tile, gh * gw, bigs, None, None, clips
            )
            return tiles[0, 0, 0, 0] * 0.0

        return jax.lax.fori_loop(0, iters, body, jnp.float32(0.0))

    def run_chain(k: int) -> float:
        start = time.perf_counter()
        # readback forces completion
        float(loop(cache["items"], cache["bigs"], cache["clips"], jnp.int32(k)))
        return time.perf_counter() - start

    run_chain(1)  # compile
    mpx = h * w / 1e6
    detail = (
        f"items={items['tile_id'].shape[0]} segs={items['lines'].shape[1]} "
        f"bigs={[b.shape for b in lowered.bigs]} clips={lowered.clips.shape} "
        f"tile={lowered.tile} lower={t_lower:.2f}s warm_lower={t_lower2:.2f}s"
    )
    return run_chain, mpx, detail


def _pipelined_runner(fn):
    """run(n): n pipelined invocations of fn, forcing only the tail — the
    slope between chain lengths is the amortized per-call latency with the
    per-call dispatch cost included (that IS the serving metric)."""
    import numpy as np

    def run(n: int) -> float:
        start = time.perf_counter()
        for _ in range(n):
            out = fn()
        float(np.asarray(out[(0,) * out.ndim]))  # force the tail call
        return time.perf_counter() - start

    run(1)  # compile
    return run


def _serve_runner(path: str, with_fonts: bool):
    """Per-call CompiledScene serving runner, dispatch included.  Measures
    the planar-tile entry point — the layout render() consumes
    (de-planarization rides the image-assembly shuffle)."""
    from svgrasterize_tpu import scene_from_filepath
    from svgrasterize_tpu.core.transform import Transform
    from svgrasterize_tpu.render_plan import compile_scene

    fonts = None
    if with_fonts:
        from svgrasterize_tpu.text.fonts import DEFAULT_FONTS, FontsDB

        fonts = FontsDB()
        fonts.register_file(DEFAULT_FONTS)
    scene, _ids, size = scene_from_filepath(path, fonts=fonts)
    w, h = int(size[0]), int(size[1])
    compiled = compile_scene(
        scene, Transform().matrix(0, 1, 0, 1, 0, 0), (0, 0, h, w), False
    )
    assert compiled is not None, f"{path} must lower"
    fn = getattr(compiled, "render_tiles_planar", compiled.render_tiles)
    return _pipelined_runner(fn)


def _many_runner(path: str):
    """Multi-frame serving runner: render_tiles_many(n) chains n frames
    in ONE dispatch, so the slope between frame counts is the pure device
    per-frame cost (compare against icons_serve_ms, which keeps per-call
    dispatch in)."""
    from svgrasterize_tpu import scene_from_filepath
    from svgrasterize_tpu.core.transform import Transform
    from svgrasterize_tpu.render_plan import compile_scene

    import numpy as np

    scene, _ids, size = scene_from_filepath(path)
    w, h = int(size[0]), int(size[1])
    compiled = compile_scene(
        scene, Transform().matrix(0, 1, 0, 1, 0, 0), (0, 0, h, w), False
    )
    assert compiled is not None, f"{path} must lower"

    def run(n: int) -> float:
        start = time.perf_counter()
        out = compiled.render_tiles_many(n)
        float(np.asarray(out[0, 0, 0]))  # readback forces completion
        return time.perf_counter() - start

    run(1)  # compile
    return run


def _runner_4k():
    """3840x3840 material served through the whole-plan CompiledScene
    program: one dispatch per frame is the serving contract, same as the
    icons/prompt configs."""
    from svgrasterize_tpu import scene_from_filepath
    from svgrasterize_tpu.core.transform import Transform
    from svgrasterize_tpu.render_plan import compile_scene

    scene, _ids, size = scene_from_filepath(DEMO, width=3840)
    w, h = int(size[0]), int(size[1])
    compiled = compile_scene(
        scene, Transform().matrix(0, 1, 0, 1, 0, 0), (0, 0, h, w), False
    )
    assert compiled is not None, "4K material must lower"
    fn = getattr(compiled, "render_tiles_planar", compiled.render_tiles)
    return _pipelined_runner(fn), w * h / 1e6


def _runner_atlas(replicate: int = 4, cell: int = 192):
    """Sprite-atlas batch: the 13 demo icons replicated into a >=2 Mpx
    atlas served via compile_atlas: amortizing per-call dispatch over a
    real batch is the design goal of this config (BASELINE.json).  Repeated
    documents (the workload's own definition: 13 unique icons x4) are
    deduplicated — each unique cell rasterizes once, duplicates serve as
    a device tile-gather (parallel/atlas.compile_atlas)."""
    from svgrasterize_tpu import scene_from_filepath
    from svgrasterize_tpu.parallel.atlas import compile_atlas

    icon_dir = os.path.join(DEMO_DIR, "icons")
    docs = []
    for name in sorted(os.listdir(icon_dir)):
        if not name.endswith(".svg"):
            continue
        scene, _ids, size = scene_from_filepath(os.path.join(icon_dir, name))
        if scene is not None:
            docs.append((scene, (float(size[0]), float(size[1]))))
    docs = docs * replicate
    srv = compile_atlas(docs, cell=cell)
    assert srv is not None, "atlas must lower"
    aw, ah = srv.size
    return _pipelined_runner(srv.render_tiles_planar), aw * ah / 1e6, len(docs)


def _runner_atlas_unique(variants: int = 4, cell: int = 192):
    """Sprite-atlas batch of DISTINCT documents: 13 demo icons x4 scale
    variants = 52 unique docs, so compile_atlas's duplicate-document
    tile-gather CANNOT fire and every cell rasterizes."""
    from svgrasterize_tpu import scene_from_filepath
    from svgrasterize_tpu.core.transform import Transform
    from svgrasterize_tpu.parallel.atlas import compile_atlas

    icon_dir = os.path.join(DEMO_DIR, "icons")
    base = []
    for name in sorted(os.listdir(icon_dir)):
        if not name.endswith(".svg"):
            continue
        scene, _ids, size = scene_from_filepath(os.path.join(icon_dir, name))
        if scene is not None:
            base.append((scene, (float(size[0]), float(size[1]))))
    docs = []
    for k in range(variants):
        s = 1.0 / (1.15**k)  # 1.0, 0.87, 0.76, 0.66 — distinct rasters
        for scene, size in base:
            docs.append((scene.transform(Transform().scale(s, s)),
                         (size[0] * s, size[1] * s)))
    srv = compile_atlas(docs, cell=cell)
    assert srv is not None, "unique atlas must lower"
    aw, ah = srv.size
    return _pipelined_runner(srv.render_tiles_planar), aw * ah / 1e6, len(docs)


def bench_scene():
    """Capture-then-refine over the 8-config matrix.

    Phase A captures ONE self-checked reading (_checked_slope: two chain
    lengths must agree) for every config unconditionally — a cold compile
    cache must never cost the artifact a config (rounds 2 AND 3 each
    shipped 1-of-5 after cold-compile overruns tripped the old budget
    guard).  Phase B re-measures with wall-time-targeted chains while
    budget remains, headline first, never overwriting a captured value
    with a skip.  Refined configs carry their slope spread ([min..max]
    in config units) in the "spread" field."""
    budget = float(os.environ.get("SVGR_BENCH_BUDGET", "480"))
    t_start = time.perf_counter()

    def remaining() -> float:
        return budget - (time.perf_counter() - t_start)

    configs = {}
    spread = {}
    errors = {}
    runners = {}
    details = []

    def build_material():
        run, mpx, detail = _material_runner(None)
        details.append(detail)
        return run, lambda per: round(mpx / per, 2)

    def build_icons():
        return (
            _serve_runner(os.path.join(DEMO_DIR, "icons.svg"), False),
            lambda per: round(per * 1e3, 3),
        )

    def build_icons_many():
        return (
            _many_runner(os.path.join(DEMO_DIR, "icons.svg")),
            lambda per: round(per * 1e3, 3),
        )

    def build_prompt():
        return (
            _serve_runner(os.path.join(DEMO_DIR, "prompt.svg"), True),
            lambda per: round(per * 1e3, 3),
        )

    def build_atlas():
        run, mpx, n_docs = _runner_atlas()
        configs["sprite_atlas_docs"] = n_docs
        return run, lambda per: round(mpx / per, 2)

    def build_atlas_unique():
        run, mpx, n_docs = _runner_atlas_unique()
        configs["sprite_atlas_unique_docs"] = n_docs
        return run, lambda per: round(mpx / per, 2)

    def build_4k():
        run, mpx = _runner_4k()
        return run, lambda per: round(mpx / per, 2)

    def build_8k():
        # opt-in (SVGR_BENCH_CONFIGS=material_7680_mpx_s): 59 Mpx serving
        # through the canvas-chunked whole-plan program — the 8K
        # robustness number (round-5; tests/test_8k.py is the CPU guard)
        from svgrasterize_tpu import scene_from_filepath
        from svgrasterize_tpu.core.transform import Transform
        from svgrasterize_tpu.render_plan import compile_scene

        scene, _ids, size = scene_from_filepath(DEMO, width=7680)
        w, h = int(size[0]), int(size[1])
        compiled = compile_scene(
            scene, Transform().matrix(0, 1, 0, 1, 0, 0), (0, 0, h, w), False
        )
        assert compiled is not None, "8K material must lower"
        fn = getattr(compiled, "render_tiles_planar", compiled.render_tiles)
        mpx = w * h / 1e6
        run = _pipelined_runner(fn)
        return run, lambda per: round(mpx / per, 2)

    def build_stress():
        # default since round 5 (the verdict: the per-item floor needs a
        # driver-tracked number): the anti-collapse pathological scene —
        # thousands of small gradient/clip items, deep pass mixes
        # (utils/stress.py); guards the per-item floor
        from svgrasterize_tpu import scene_from_str
        from svgrasterize_tpu.core.transform import Transform
        from svgrasterize_tpu.render_plan import compile_scene
        from svgrasterize_tpu.utils.stress import stress_doc

        scene, _ids, size = scene_from_str(stress_doc())
        w, h = int(size[0]), int(size[1])
        compiled = compile_scene(
            scene, Transform().matrix(0, 1, 0, 1, 0, 0), (0, 0, h, w), False
        )
        assert compiled is not None, "stress scene must lower"
        fn = getattr(compiled, "render_tiles_planar", compiled.render_tiles)
        return _pipelined_runner(fn), lambda per: round(per * 1e3, 3)

    # phase A: build + one self-checked reading per EVERY config, headline
    # first.  No budget skipping here: round 2 and 3 both shipped 1-of-5
    # artifacts because a stone-cold compile ate the budget and the guard
    # then dropped the remaining (cheap!) configs — an over-budget run
    # that captures everything beats an on-budget run that captures one
    # config.  Overruns are recorded, not acted on.
    # SVGR_BENCH_CONFIGS=key,key filters the matrix (debug / CPU smoke)
    only = os.environ.get("SVGR_BENCH_CONFIGS")
    only = {k.strip() for k in only.split(",")} if only else None
    for key, build in (
        ("material_1488_mpx_s", build_material),
        ("icons_serve_ms", build_icons),
        ("icons_serve_many_ms", build_icons_many),
        ("prompt_serve_ms", build_prompt),
        ("sprite_atlas_mpx_s", build_atlas),
        ("sprite_atlas_unique_mpx_s", build_atlas_unique),
        ("material_3840_mpx_s", build_4k),
        ("material_7680_mpx_s", build_8k),
        ("stress_serve_ms", build_stress),
    ):
        if only is not None and key not in only:
            continue
        if key == "material_7680_mpx_s" and only is None:
            continue  # opt-in: 59 Mpx compile is too heavy for the driver run
        if remaining() < 0:
            errors.setdefault(
                "budget", f"phase A over budget before {key}; capturing anyway"
            )
        try:
            run, to_value = build()
            configs[key] = to_value(_checked_slope(run, errors=errors, key=key))
            runners[key] = (run, to_value)
            print(f"[bench] captured {key}={configs[key]}", file=sys.stderr)
        except Exception as exc:  # record, never sink the other configs
            errors[key] = f"{type(exc).__name__}: {exc}"[:200]

    # phase B: refine with adaptive chains while budget remains (compiles
    # are already paid, so a refine pass costs ~2 s/config of device
    # time).  The HEADLINE refines first so the artifact's "value" always
    # carries a spread entry even when the budget dies mid-phase.
    for key in sorted(runners, key=lambda k: k != "material_1488_mpx_s"):
        run, to_value = runners[key]
        if remaining() < 20:
            errors[key + "_refine"] = "kept phase-A capture: budget exhausted"
            continue
        try:
            med, slopes = _refine_slope(run)
            configs[key] = to_value(med)
            spread[key] = sorted([to_value(slopes[0]), to_value(slopes[-1])])
        except Exception as exc:
            errors[key + "_refine"] = f"{type(exc).__name__}: {exc}"[:200]

    mpx_s = configs.get("material_1488_mpx_s", 0.0)
    result = {
        "metric": "material_design_scene_render",
        "value": mpx_s,
        "unit": "Mpx/s",
        "vs_baseline": round(mpx_s / REFERENCE_SCENE_MPX_S, 1),
        "configs": configs,
    }
    if spread:
        result["spread"] = spread
    if errors:
        result["errors"] = errors
    return result, " ".join(details)


def bench_kernel():
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _edge_batch
    from svgrasterize_tpu.ops import fill_rule as fill_rule_ops
    from svgrasterize_tpu.ops.coverage import winding_impl

    n_paths, n_segs, tile = 64, 64, 256
    lines_np, colors_np = _edge_batch(n_paths, n_segs, float(tile))
    lines = jnp.asarray(lines_np)
    colors = jnp.asarray(colors_np)

    @jax.jit
    def loop(lines, colors, iters):
        def fill(lines):
            def one(segs, color):
                mask = fill_rule_ops.apply(winding_impl(segs, tile, tile))
                return mask[..., None] * color[None, None, :]

            return jax.vmap(one)(lines, colors)

        def body(_i, carry):
            out = fill(lines + carry)
            return out[0, 0, 0, 0] * 0.0

        return jax.lax.fori_loop(0, iters, body, jnp.float32(0.0))

    def run_chain(k: int) -> float:
        start = time.perf_counter()
        float(loop(lines, colors, jnp.int32(k)))
        return time.perf_counter() - start

    run_chain(1)
    per_iter, _slopes = _refine_slope(run_chain)
    mpx = n_paths * tile * tile / 1e6
    return {
        "metric": "aa_fill_throughput",
        "value": round(mpx / per_iter, 2),
        "unit": "Mpx/s",
        "vs_baseline": round(mpx / per_iter / REFERENCE_KERNEL_MPX_S, 1),
    }, f"batch={n_paths}x{n_segs} tile={tile} per_iter={per_iter * 1e3:.2f}ms"


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)) or ".")
    import jax

    if os.path.isfile(DEMO):
        result, detail = bench_scene()
    else:
        result, detail = bench_kernel()
    print(json.dumps(result))
    print(f"[bench] device={jax.devices()[0]} {detail}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
