"""The one backend dispatch: which JAX backend this process computes on.

Every decision that depends on the machine (batch widths, launch counts,
process pools) asks `backend()` and nothing else.  Two backends are
supported: "gpu" (NVIDIA, through XLA's CUDA plugin) and "cpu".  Any other
platform is an error rather than a silent default.
"""

from __future__ import annotations

import jax

SUPPORTED = ("gpu", "cpu")


def backend() -> str:
    """"gpu" or "cpu": the platform of the default JAX device."""
    platform = jax.default_backend()
    if platform not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX backend {platform!r}; expected one of {SUPPORTED}"
        )
    return platform


def describe() -> str:
    """One line naming the platform, device kind and device count."""
    devs = jax.devices()
    return (
        f"platform={devs[0].platform} device_kind={devs[0].device_kind} "
        f"count={len(devs)}"
    )
