"""Which accelerator a measurement runs on.

Every timing this repository reports comes from an NVIDIA GPU.  A
measurement entry point calls `require_gpu()` first and stops when JAX
finds no GPU: it never falls back to the CPU, whose times say nothing
about the card.  `describe()` is the device record printed beside every
number.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu():
    """jax.devices() when the first device is a GPU; RuntimeError
    otherwise."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this entry point measures the GPU "
            "only (the CPU tests are `JAX_PLATFORMS=cpu pytest tests/`)")
    return devs


def nvidia_smi_name_power():
    """`nvidia-smi --query-gpu=name,power.limit` for each card, as one
    string.  Runs in a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def describe(devs=None):
    """{platform, device_kind, device_count, card} of the devices."""
    devs = devs or jax.devices()
    return dict(platform=devs[0].platform,
                device_kind=devs[0].device_kind,
                device_count=len(devs),
                card=nvidia_smi_name_power())
