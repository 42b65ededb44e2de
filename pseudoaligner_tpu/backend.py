"""Which devices JAX serves on, and refusing a silent CPU fallback.

When JAX finds no usable accelerator it quietly falls back to the CPU,
where the device subcommands still run, only orders of magnitude slower.
The CLI stops instead, unless the user asked for the CPU.
"""

from __future__ import annotations

import os

CPU_FALLBACK_MESSAGE = (
    "JAX found no accelerator and fell back to the CPU. Set "
    "JAX_PLATFORMS=cpu to run on the CPU on purpose."
)


def cpu_requested() -> bool:
    """True when JAX_PLATFORMS (or jax's platforms setting) names cpu."""
    import jax

    plats = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    return "cpu" in str(plats).lower().split(",")


def check_platform(platform: str, cpu_ok: bool) -> None:
    """Raise RuntimeError when `platform` is the CPU and `cpu_ok` is
    false."""
    if platform == "cpu" and not cpu_ok:
        raise RuntimeError(CPU_FALLBACK_MESSAGE)


def describe() -> dict:
    """{platform, kind, count} of jax's devices, as the JAX API names
    them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
