"""Device-report helpers for timings.

The reference times pipeline steps with `std::time::Instant` /
`time.perf_counter` (SURVEY.md section 5.1). JAX dispatch is asynchronous,
so a host-clock timing must end in `jax.block_until_ready`; otherwise it
measures the enqueue. Every timing is reported beside the device it ran on
(`device_line`) and, on a GPU, the card's name and power limit
(`gpu_card`): a card set below its maximum power runs slower under load.
"""

from __future__ import annotations

import subprocess

import jax


def gpu_card() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them, one
    line per card; "" where nvidia-smi is absent or fails. Runs in a child
    process that does not touch JAX."""
    try:
        res = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return res.stdout.strip() if res.returncode == 0 else ""


def device_line() -> str:
    """Platform, device kind and device count as JAX reports them."""
    devs = jax.devices()
    return (
        f"platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}"
    )


def require_gpu(min_count: int = 1) -> None:
    """Raise SystemExit unless JAX sees at least ``min_count`` GPUs: a
    measurement that finds no card fails instead of timing the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < min_count:
        raise SystemExit(
            f"needs {min_count} GPU(s); JAX reports {device_line()}"
        )
