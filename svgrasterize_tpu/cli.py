"""Command-line interface: SVG (or raw .path data) -> PNG on GPU.

Flag-compatible with the reference CLI (svgrasterize.py:
3796-3883): positional svg/output, -bg/-fg colors, -w width, -id element,
-t extra transform, --linear-rgb, --fonts, --as-path.  Adds --profile for
compile/execute timing breakdown.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .core.layer import Layer, merge_at
from .core.transform import Transform
from .frontend.parsers import parse_color, parse_transform
from .frontend.svg import scene_from_filepath
from .geom.path import Path
from .scene import Scene
from .text.fonts import DEFAULT_FONTS, FontsDB
from .utils.constants import DEVICE_FLOAT


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="svgrasterize-tpu", description="GPU SVG rasterizer"
    )
    parser.add_argument("svg", help="input SVG file (or .path raw path data)")
    parser.add_argument("output", help="output PNG file ('-' for stdout)")
    parser.add_argument("-bg", type=parse_color, help="background color")
    parser.add_argument("-fg", type=parse_color, help="default foreground color")
    parser.add_argument("-w", "--width", type=int, help="output width in pixels")
    parser.add_argument("-id", help="render only the element with this id")
    parser.add_argument(
        "-t", "--transform", type=parse_transform, help="extra transform applied to the scene"
    )
    parser.add_argument("--linear-rgb", action="store_true", help="compose in linear RGB")
    parser.add_argument("--fonts", nargs="*", help="SVG files containing font definitions")
    parser.add_argument("--as-path", action="store_true", help="dump the scene as SVG path data")
    parser.add_argument("--profile", action="store_true", help="print timing breakdown to stderr")
    parser.add_argument(
        "--verbose", action="store_true",
        help="print full tracebacks for input errors (also: SVGR_DEBUG=1)",
    )
    parser.add_argument(
        "--platform",
        default=os.environ.get("SVGR_PLATFORM"),
        help="force a JAX platform (cpu, gpu); default: runtime's choice",
    )
    opts = parser.parse_args(argv)

    import jax

    if opts.platform:
        jax.config.update("jax_platforms", opts.platform)
    # One-shot renders are lower-bound, not execute-bound: the CPU
    # backend's serving default (tile 128, fewest dispatches per frame)
    # pays ~7x the host-lowering cost of tile 32 on material-design
    # (8.6 s vs 1.2 s — collapse field composition and binning scale
    # with tile area) while its single-frame execute saving is <1 s.
    # The CLI renders each scene exactly once, so default to tile 32
    # everywhere; SVGR_TILE still overrides.  The setting is restored on
    # return, so in-process callers keep their own tile default.
    prev_tile = os.environ.get("SVGR_TILE")
    os.environ["SVGR_TILE"] = prev_tile or "32"
    try:
        return _run(opts)
    finally:
        if prev_tile is None:
            os.environ.pop("SVGR_TILE", None)
        else:
            os.environ["SVGR_TILE"] = prev_tile


def _run(opts) -> int:
    import jax

    # the persistent compile cache itself is configured by the package
    # import (svgrasterize_tpu._setup_compile_cache); enable the XLA-level
    # caches on top for CLI one-shots — but NOT on the CPU backend, where
    # the per-kernel XLA cache entries embed host machine features that
    # fail the AOT load check on replay (42 silent load-failures +
    # recompiles per material render; the program-level cache alone loads
    # clean under the package's --xla_cpu_max_isa pin).  Gate on the
    # backend JAX resolved, not on the --platform flag: a run without the
    # flag can land on the CPU too.
    if (
        os.environ.get("SVGR_COMPILE_CACHE", "1") not in ("", "0")
        and jax.default_backend() != "cpu"
    ):
        jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

    if not os.path.exists(opts.svg):
        sys.stderr.write(f"[error] no such file: {opts.svg}\n")
        return 1

    fonts = FontsDB()
    for font_file in opts.fonts if opts.fonts is not None else [DEFAULT_FONTS]:
        fonts.register_file(font_file)

    # images are indexed (row, col) = (y, x): prepend the axis-swap transform
    transform = Transform() if opts.as_path else Transform().matrix(0, 1, 0, 1, 0, 0)
    if opts.transform is not None:
        transform = transform @ opts.transform

    t_parse = time.monotonic()
    try:
        if opts.svg.endswith(".path"):
            with open(opts.svg, encoding="utf-8") as file:
                path = Path.from_svg(file.read())
            opts.bg = parse_color("white") if opts.bg is None else opts.bg
            fg = parse_color("black") if opts.fg is None else opts.fg
            scene = Scene.fill(path, fg)
            ids, size = {}, None
        else:
            scene, ids, size = scene_from_filepath(
                opts.svg, opts.fg, opts.width, fonts
            )
    except (SyntaxError, ValueError, UnicodeDecodeError) as exc:
        # etree.ParseError is a SyntaxError subclass; report malformed
        # inputs cleanly instead of dumping a traceback.  The exception
        # class distinguishes genuine parse errors from internal bugs that
        # surface as ValueError deep in scene construction; --verbose (or
        # SVGR_DEBUG=1) prints the full traceback for the latter.
        sys.stderr.write(
            f"[error] cannot parse {opts.svg}: {type(exc).__name__}: {exc}\n"
        )
        if opts.verbose or os.environ.get("SVGR_DEBUG"):
            import traceback

            traceback.print_exc()
        return 1
    t_parse = time.monotonic() - t_parse

    if scene is None:
        sys.stderr.write("[error] nothing to render\n")
        return 0

    if opts.id is not None:
        size = None
        scene = ids.get(opts.id)
        if scene is None:
            sys.stderr.write(f"[error] no element with id: {opts.id}\n")
            return 1

    if opts.as_path:
        data = scene.to_path(transform).to_svg()
        if opts.output == "-":
            sys.stdout.write(data)
        else:
            with open(opts.output, "w", encoding="utf-8") as file:
                file.write(data)
        return 0

    start = time.monotonic()
    result = None
    if size is not None:
        from .render_plan import render_fast

        w, h = size
        viewport = (0, 0, int(h), int(w))
        # whole-scene batched path: one device dispatch when the scene lowers;
        # otherwise the interpreter batches lowerable group runs internally
        result = render_fast(scene, transform, viewport, linear_rgb=opts.linear_rgb)
        if result is None:
            result = scene.render(transform, viewport=viewport, linear_rgb=opts.linear_rgb)
    else:
        result = scene.render(transform, linear_rgb=opts.linear_rgb)
    if result is not None:
        result[0].image.block_until_ready()
    elapsed = time.monotonic() - start
    sys.stderr.write(f"[info] rendered in {elapsed:.2f}\n")
    if opts.profile:
        sys.stderr.write(f"[info] parse {t_parse:.2f}s render {elapsed:.2f}s\n")
    sys.stderr.flush()

    if result is None:
        sys.stderr.write("[error] nothing to render\n")
        return 1
    layer, _hull = result

    if size is not None:
        import jax.numpy as jnp

        w, h = size
        layer = layer.convert(pre_alpha=True, linear_rgb=opts.linear_rgb)
        canvas = jnp.zeros((int(h), int(w), 4), dtype=DEVICE_FLOAT)
        canvas = merge_at(canvas, layer.image, layer.offset)
        layer = Layer(canvas, (0, 0), pre_alpha=True, linear_rgb=opts.linear_rgb)

    if opts.bg is not None:
        layer = layer.background(opts.bg)

    if opts.output == "-":
        layer.write_png(sys.stdout.buffer)
    else:
        with open(opts.output, "wb") as file:
            layer.write_png(file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
