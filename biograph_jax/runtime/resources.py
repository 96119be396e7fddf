"""Memory budgeting for device-resident stages (resource_manager analog).

The reference sizes every construction stage to a memory budget
(modules/mapred/resource_manager.h:7 scratch quotas;
modules/build_seqset/kmer_counter.h:29 multi-pass sizing;
modules/biograph/biograph_create.cpp:475 32 GiB warning).  The device
build's equivalent constraint is device memory: stages that materialize data proportional to
input size (the suffix sort above all) consult this budget and switch to
prefix-partitioned multi-pass execution when they would not fit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


# working-set size assumed on a host backend, which reports no memory stats
HOST_DEFAULT_BYTES = 8 << 30


@dataclass(frozen=True)
class MemoryBudget:
    """Device-memory budget in bytes for a single resident working set."""

    bytes: int

    @staticmethod
    def detect(fraction: float = 0.5) -> "MemoryBudget":
        """Budget from the active device's memory, overridable with
        BGT_HBM_BUDGET_BYTES.  `fraction` leaves headroom for XLA
        temporaries and double-buffering.

        A GPU must report its `bytes_limit`; a device that reports no
        memory statistics (the CPU backend) gets HOST_DEFAULT_BYTES."""
        env = os.environ.get("BGT_HBM_BUDGET_BYTES")
        if env:
            return MemoryBudget(bytes=int(env))
        import jax

        from biograph_jax.runtime.backend import backend

        stats = jax.devices()[0].memory_stats() or {}
        total = stats.get("bytes_limit")
        if not total:
            if backend() == "gpu":
                raise RuntimeError(
                    "the GPU reported no bytes_limit in memory_stats(); "
                    "set BGT_HBM_BUDGET_BYTES to size the build"
                )
            total = HOST_DEFAULT_BYTES
        return MemoryBudget(bytes=int(total * fraction))

    def fits(self, nbytes: int) -> bool:
        return nbytes <= self.bytes

    def passes_needed(self, nbytes: int) -> int:
        return max(1, -(-nbytes // self.bytes))
