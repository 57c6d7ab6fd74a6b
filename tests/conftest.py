"""Test configuration: force CPU JAX with a virtual 8-device mesh.

Tests run on the CPU backend; multi-device sharding tests use
xla_force_host_platform_device_count.  Tests that need a GPU carry the
`gpu` marker and take the `gpu` fixture, which skips them when JAX sees
no GPU.  On a machine with a card, run them with

    SVGR_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import os
import sys

# SVGR_TEST_GPU=1 leaves the GPU visible (the CPU backend stays available
# for the tests' CPU-side references)
os.environ["JAX_PLATFORMS"] = (
    "cuda,cpu" if os.environ.get("SVGR_TEST_GPU") == "1" else "cpu"
)
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import jax

# the package import configures the persistent compile cache by its own
# rule (JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache): compiled
# kernels survive across test runs (a first full run is compile-heavy)
import svgrasterize_tpu  # noqa: E402,F401

jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

import pytest

REFERENCE_DIR = "/root/reference"


@pytest.fixture(scope="session")
def reference():
    """The upstream numpy implementation, used as a golden oracle."""
    if not os.path.isdir(REFERENCE_DIR):
        pytest.skip("reference implementation not available")
    if REFERENCE_DIR not in sys.path:
        sys.path.insert(0, REFERENCE_DIR)
    import svgrasterize

    return svgrasterize


@pytest.fixture(scope="session")
def demo_dir():
    path = os.path.join(REFERENCE_DIR, "demo")
    if not os.path.isdir(path):
        pytest.skip("reference demo assets not available")
    return path


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees none.  Decided
    here, at run time — never while test modules are imported, so every
    xdist worker collects the same tests."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (SVGR_TEST_GPU=1 pytest -m gpu on a card)")
    return devices[0]
