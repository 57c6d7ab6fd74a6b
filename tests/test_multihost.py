"""Multi-host path: real jax.distributed processes on CPU devices.

spawn_local launches separate OS processes, each with its own virtual
device set, wires them through a jax.distributed coordinator, and runs the
sharded lowered pipeline over the global mesh — the same code path a
multi-host deployment runs, minus the hardware (parallel/distributed.py).
"""

import re

from svgrasterize_tpu.parallel.distributed import spawn_local


def test_distributed_two_processes():
    line = spawn_local(num_processes=2, devices_per_process=2, timeout=560)
    match = re.search(r"processes=(\d+) devices=(\d+).*checksum=([\d.]+)", line)
    assert match, line
    assert int(match.group(1)) == 2
    assert int(match.group(2)) == 4
    assert float(match.group(3)) > 0


import pytest


@pytest.mark.slow
def test_distributed_four_processes():
    """4 processes x 2 devices over DCN: multi-pass pool + pattern-atlas
    replication and a sharded sprite-atlas batch (round-2 verdict #9)."""
    line = spawn_local(num_processes=4, devices_per_process=2, timeout=560,
                       full=True)
    match = re.search(
        r"processes=(\d+) devices=(\d+).*checksum=([\d.]+) "
        r"multipass=([\d.]+) atlas=([\d.]+)", line
    )
    assert match, line
    assert int(match.group(1)) == 4
    assert int(match.group(2)) == 8
    assert float(match.group(4)) > 0 and float(match.group(5)) > 0
