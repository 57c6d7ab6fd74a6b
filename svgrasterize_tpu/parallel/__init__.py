"""Multi-chip scaling: device meshes, sharded rasterization, collectives.

The reference is strictly single-process/single-thread (SURVEY.md section 2);
this package provides the device parallelism it lacks: paths/tiles are
data-parallel across a mesh axis, segment lists are "tensor"-parallel across
a second axis (partial winding + psum), and composed canvases ride device
collectives instead of a host loop.

Multi-host: every entry point takes a jax.sharding.Mesh, so a multi-host
deployment only changes mesh construction.  distributed.py is the runnable
wiring — jax.distributed initialization, the global "data" mesh spanning
hosts (documents/tile ranges shard across hosts, per-tile work across the
devices of a host),
and a dryrun that spawns real coordinator-connected OS processes on virtual
CPU devices (tests/test_multihost.py runs it in CI):

    python -m svgrasterize_tpu.parallel.distributed --processes 2
"""

from .mesh import make_mesh
from .batch import fill_batch, sharded_fill_batch, sharded_render_step
from .distributed import global_mesh, initialize, spawn_local
