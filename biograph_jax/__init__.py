"""biograph_jax — a JAX genomic sequence-analysis engine.

A from-scratch JAX/XLA rebuild of the capabilities of the BioGraph
platform (reference: spiralgenetics/biograph): raw sequencing reads are turned
into a compressed, device-resident, queryable read index (the *seqset*, a
BWT-like suffix-ordered read store, plus the *readmap* read annotation layer),
over which reference-guided local assembly discovers variants (SNP/indel/SV),
coverage evidence is computed, and calls are scored.

Design stance (accelerator-first, not a port):
  * The seqset is built by device-wide lexicographic sorts over 2-bit packed
    suffix arrays (``jax.lax.sort``) instead of external merge sorts
    (reference: modules/build_seqset/expand.h, builder.h).
  * Queries (find / push_front / overlap search) are *batched* rank queries —
    thousands of search frontiers advance per step as vectorized popcount
    gathers, instead of one pointer-chasing walk at a time
    (reference: modules/bio_base/seqset.h:20,207).
  * Scale-out uses jax.sharding Meshes + collectives instead of the reference's
    taskdb/worker-process fleet (reference: modules/mapred/, modules/main/).

Integer note: entry ids and k-mers need 64-bit integers, so x64 is enabled
globally.  Floating point stays f32 on the hot path.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)


def _compile_cache_dir(environ=_os.environ) -> str | None:
    """Where the persistent compilation cache lives.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins (this
    package then sets no directory of its own); otherwise a fixed directory
    inside the checkout, so a cached program is found again by the next
    run from the same tree.  BGT_NO_COMPILE_CACHE=1 turns the cache off."""
    if environ.get("BGT_NO_COMPILE_CACHE"):
        return None
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache")


_cache_dir = _compile_cache_dir()
if _cache_dir is not None:
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # sub-second compiles add up across the pipeline's shape buckets
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"


def version() -> str:
    """Package version (reference SDK `biograph.version()` analog)."""
    return __version__


def build_revision() -> str:
    """VCS revision of the build (reference `build_revision` analog)."""
    import os
    import subprocess

    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True,
            text=True,
            timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ).stdout.strip() or "unknown"
    except Exception:
        return "unknown"

from biograph_jax.core import dna  # noqa: E402
from biograph_jax.api import BioGraph, Sequence  # noqa: E402
from biograph_jax.index.seqset import Seqset, SeqsetRanges  # noqa: E402
from biograph_jax.index.readmap import Readmap  # noqa: E402
from biograph_jax.index.reference import Reference  # noqa: E402

__all__ = [
    "dna",
    "BioGraph",
    "Sequence",
    "Seqset",
    "SeqsetRanges",
    "Readmap",
    "Reference",
]
