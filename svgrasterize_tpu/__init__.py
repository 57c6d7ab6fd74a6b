"""svgrasterize-tpu: an SVG rasterization framework on JAX/XLA.

Re-implements the capabilities of aslpavel/svgrasterize.py with a JAX/XLA
compute path: host-side scene compilation (XML, path data, fonts, stroke
geometry) and device-side pixel work (coverage, paint, composition,
filters), designed to scale across device meshes via jax.sharding.
"""

def default_cache_dir() -> str:
    """Persistent-compile-cache directory: JAX_COMPILATION_CACHE_DIR when
    set, else a fixed `.jax_cache` directory beside the package (the path
    is part of the cache key, so it must not move between runs)."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, ".jax_cache")


def _setup_compile_cache() -> None:
    """Persistent XLA compilation cache: compiled scene-shape programs
    survive restarts.  Disable with SVGR_COMPILE_CACHE=0."""
    import os

    # XLA:CPU stamps auto-tuning pseudo-features (+prefer-no-scatter,
    # +prefer-no-gather) into cached AOT results; at load time the host
    # feature check rejects them, so every cross-process "cache hit"
    # silently fell back to a full recompile.  Pinning the ISA ceiling
    # makes the stamped feature set host-compatible.  The flag only
    # affects the CPU backend.  Respect an explicit user setting.
    if "xla_cpu_max_isa" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX512"
        ).strip()

    if os.environ.get("SVGR_COMPILE_CACHE", "1") in ("", "0"):
        return
    try:
        import jax

        cache = default_cache_dir()
        os.makedirs(cache, exist_ok=True)
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", cache)
        # write every entry: a one-shot render compiles a handful of
        # small programs, and each cross-process hit saves its compile
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    except Exception:  # pragma: no cover - cache is best-effort
        return


_setup_compile_cache()

from .core.transform import Transform
from .core.layer import Layer, canvas_create
from .core import color, png
from .geom.path import Path, FILL_NONZERO, FILL_EVENODD
from .geom.hull import ConvexHull
from .paint import GradLinear, GradRadial, Pattern
from .scene import Scene
from .filter import Filter
from .frontend.svg import scene_from_filepath, scene_from_str, scene_from_xml
from .render_plan import CompiledScene, compile_scene
from .frontend.parsers import parse_color, parse_transform
from .text.fonts import DEFAULT_FONTS, Font, FontsDB, Glyph

__version__ = "0.1.0"
