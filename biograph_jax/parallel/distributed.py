"""Multi-host initialization (single-controller jax.distributed).

The reference's control plane is a taskdb HTTP service + per-host worker
managers (modules/main/main.cpp:301, modules/mapred/taskdb.h:18).  This
build replaces both planes with jax.distributed: one coordinator, N host
processes, all bulk data moving over ICI/DCN collectives under the global
mesh.  This module is the bring-up path; it is exercised single-process the
way the reference tests its distributed framework through task_mgr_local
(modules/mapred/task_mgr.h:60) — same code path, one process.

Environment contract (mirrors the standard launcher variables):
  BGT_COORDINATOR   host:port of process 0 (default localhost:12421)
  BGT_NUM_PROCESSES world size                (default 1)
  BGT_PROCESS_ID    this process's id         (default 0)
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class DistContext:
    num_processes: int
    process_id: int
    initialized: bool  # whether jax.distributed was actually brought up


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> DistContext:
    """Bring up jax.distributed when running multi-host; no-op otherwise.

    Call once before any jax computation on every host.  Single-process runs
    (num_processes == 1) skip the coordinator entirely so the same pipeline
    code runs unchanged on one host."""
    import jax

    coordinator = coordinator or os.environ.get("BGT_COORDINATOR", "localhost:12421")
    num_processes = int(
        num_processes
        if num_processes is not None
        else os.environ.get("BGT_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id if process_id is not None else os.environ.get("BGT_PROCESS_ID", "0")
    )
    if num_processes <= 1:
        return DistContext(num_processes=1, process_id=0, initialized=False)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return DistContext(
        num_processes=jax.process_count(),
        process_id=jax.process_index(),
        initialized=True,
    )


def global_mesh(axis_shapes: dict[str, int] | None = None):
    """Build the global device mesh over all processes' devices.

    axis_shapes like {'data': -1, 'model': 4}: one axis may be -1 (inferred).
    Defaults to {'data': -1} (pure data parallel)."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    axis_shapes = dict(axis_shapes or {"data": -1})
    names = list(axis_shapes)
    sizes = list(axis_shapes.values())
    n = len(devs)
    fixed = 1
    for s in sizes:
        if s != -1:
            fixed *= s
    sizes = [n // fixed if s == -1 else s for s in sizes]
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    return Mesh(devs.reshape(sizes), tuple(names))
