"""Multi-host (DCN) execution: jax.distributed wiring + a runnable dryrun.

The reference is single-process (SURVEY.md section 2); this module makes the
multi-host recipe in parallel/__init__ executable code:

  * `initialize()` wires jax.distributed so every process sees the global
    device set;
  * `global_mesh()` builds the one-axis "data" mesh spanning all hosts —
    canvas tile ranges (and therefore batch documents, which land in
    disjoint tile ranges) shard across processes over DCN, while each
    shard's pixel work stays on its own chips;
  * `worker()` is one process of the dryrun: lower a scene on every host
    (host-side lowering is deterministic, so global operands can be formed
    from identical process-local arrays) and execute it through
    parallel/scene.sharded_exec_fn over the global mesh;
  * `spawn_local()` launches N such workers as separate OS processes on
    virtual CPU devices — the same code path a real multi-host deployment
    runs, minus the hardware.

Run by hand:  python -m svgrasterize_tpu.parallel.distributed --processes 2
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

DRYRUN_DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="256" height="192">
  <defs>
    <linearGradient id="g"><stop offset="0" stop-color="red"/>
    <stop offset="1" stop-color="blue"/></linearGradient>
    <clipPath id="c"><circle cx="128" cy="96" r="80"/></clipPath>
  </defs>
  <rect x="8" y="8" width="240" height="176" fill="url(#g)"/>
  <g opacity="0.7"><circle cx="96" cy="96" r="60" fill="#ffaa00"/>
  <rect x="140" y="40" width="80" height="100" fill="teal"
        clip-path="url(#c)"/></g>
  <path d="M20 180 L128 20 L236 180 Z" fill="green"/>
</svg>"""

# multi-pass + pattern scene: group opacity and a mask force isolation
# passes (replicated pool rows over DCN), the pattern fill forces a
# replicated pattern atlas — the full operand-replication surface
MULTIPASS_DOC = """
<svg xmlns="http://www.w3.org/2000/svg" width="256" height="192">
  <defs>
    <mask id="m"><rect x="16" y="16" width="224" height="160" fill="white"/>
      <circle cx="128" cy="96" r="40" fill="black"/></mask>
    <pattern id="p" width="16" height="16" patternUnits="userSpaceOnUse">
      <rect width="8" height="8" fill="#aa2200"/></pattern>
  </defs>
  <rect x="8" y="8" width="240" height="176" fill="url(#p)"/>
  <g opacity="0.6"><rect x="40" y="40" width="120" height="80" fill="blue"/>
    <circle cx="170" cy="120" r="50" fill="red"/></g>
  <rect x="60" y="30" width="150" height="130" fill="#00aa88" mask="url(#m)"/>
</svg>"""


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """Wire jax.distributed; afterwards jax.devices() spans all hosts."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "data"):
    """One-axis mesh over the global device set (all processes)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def worker(coordinator: str, num_processes: int, process_id: int,
           full: bool = False) -> None:
    """One process of the multi-host dryrun; prints one `[distributed] ok`
    line on success (rank 0).  With full, also runs a multi-pass + pattern
    plan (pool/atlas replication over DCN) and a sharded sprite-atlas
    batch — the slow-lane 4-process test."""
    initialize(coordinator, num_processes, process_id)

    import jax
    import jax.numpy as jnp

    from .. import scene_from_str
    from ..core.transform import Transform
    from ..render_plan import execute_lowered, lower_scene
    from .scene import sharded_exec_fn

    mesh = global_mesh()
    n_global = int(mesh.devices.size)
    assert n_global >= num_processes, (
        f"global mesh has {n_global} devices for {num_processes} processes"
    )

    # every host lowers the same scene: host lowering is deterministic, so
    # the shard_map operands below are identical process-local arrays and
    # jit's implicit device_put can form the global sharded arrays
    scene, _ids, _size = scene_from_str(DRYRUN_DOC)
    tr = Transform().matrix(0, 1, 0, 1, 0, 0)
    lowered = lower_scene(scene, tr, (0, 0, 192, 256), False, tile=32)
    assert lowered is not None
    tiles = execute_lowered(lowered, (0, 0), False, exec_fn=sharded_exec_fn(mesh))
    tiles.block_until_ready()

    # a cross-host collective over the composed canvas: every process gets
    # the same global checksum (rides DCN between hosts, ICI within)
    total = float(jax.jit(jnp.sum)(tiles))
    finite = bool(jnp.isfinite(tiles).all())
    assert finite, "non-finite canvas on the global mesh"

    if not full:
        if process_id == 0:
            gh, gw = lowered.grid
            print(
                f"[distributed] ok processes={num_processes} "
                f"devices={n_global} grid={gh}x{gw} checksum={total:.2f}",
                flush=True,
            )
        return

    # stage 2: a MULTI-PASS plan with a pattern — isolation-pass pool rows
    # and the pattern atlas replicate to every process over DCN
    scene2, _ids2, _size2 = scene_from_str(MULTIPASS_DOC)
    lowered2 = lower_scene(scene2, tr, (0, 0, 192, 256), False, tile=32)
    assert lowered2 is not None and lowered2.groups, "stage 2 needs passes"
    assert lowered2.patterns is not None, "stage 2 needs a pattern atlas"
    tiles2 = execute_lowered(lowered2, (0, 0), False, exec_fn=sharded_exec_fn(mesh))
    tiles2.block_until_ready()
    assert bool(jnp.isfinite(tiles2).all())
    total2 = float(jax.jit(jnp.sum)(tiles2))

    # stage 3: a sharded sprite-atlas batch — batch documents land in
    # disjoint tile ranges, so tile sharding is document sharding
    from .atlas import render_atlas

    docs = []
    for color in ("#c03020", "#2060c0", "#20a040", "#a020c0"):
        d, _i, ds = scene_from_str(
            f"<svg xmlns='http://www.w3.org/2000/svg' width='48' height='48'>"
            f"<circle cx='24' cy='24' r='20' fill='{color}'/></svg>"
        )
        docs.append((d, (float(ds[0]), float(ds[1]))))
    atlas_layer = render_atlas(docs, cell=64, mesh=mesh)
    atlas_layer.image.block_until_ready()
    assert bool(jnp.isfinite(atlas_layer.image).all())
    total3 = float(jax.jit(jnp.sum)(atlas_layer.image))

    if process_id == 0:
        gh, gw = lowered.grid
        print(
            f"[distributed] ok processes={num_processes} devices={n_global} "
            f"grid={gh}x{gw} checksum={total:.2f} "
            f"multipass={total2:.2f} atlas={total3:.2f}",
            flush=True,
        )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_local(num_processes: int = 2, devices_per_process: int = 2,
                timeout: float = 600.0, full: bool = False) -> str:
    """Run the dryrun as real separate OS processes on virtual CPU devices.

    This exercises the full jax.distributed path (coordinator service, DCN
    collectives between process-local device sets) without accelerators.
    Returns rank 0's `[distributed] ok ...` line; raises on failure.
    """
    coordinator = f"127.0.0.1:{_free_port()}"
    env_base = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={devices_per_process}"
        ).strip(),
    }
    procs = []
    for pid in range(num_processes):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "svgrasterize_tpu.parallel.distributed",
                    "--worker", "--coordinator", coordinator,
                    "--processes", str(num_processes), "--id", str(pid),
                ] + (["--full"] if full else []),
                env=env_base,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    for pid, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise RuntimeError(f"distributed worker {pid} timed out")
        if proc.returncode != 0:
            raise RuntimeError(
                f"distributed worker {pid} failed rc={proc.returncode}:\n{err[-2000:]}"
            )
        outs.append(out)
    ok = next((line for line in outs[0].splitlines() if "[distributed] ok" in line), None)
    if ok is None:
        raise RuntimeError(f"rank 0 produced no ok line:\n{outs[0][-2000:]}")
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="multi-host render dryrun")
    parser.add_argument("--worker", action="store_true",
                        help="run as one rank (internal)")
    parser.add_argument("--full", action="store_true",
                        help="also run the multipass + atlas stages")
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--processes", type=int, default=2)
    parser.add_argument("--id", type=int, default=0)
    parser.add_argument("--devices-per-process", type=int, default=2)
    args = parser.parse_args(argv)

    if args.worker:
        worker(args.coordinator, args.processes, args.id, full=args.full)
        return 0
    print(spawn_local(args.processes, args.devices_per_process, full=args.full))
    return 0


if __name__ == "__main__":
    sys.exit(main())
