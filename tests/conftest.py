"""Test configuration: force an 8-device virtual CPU mesh before JAX
backends initialize, and enable x64.

This is the analogue of "multi-node testing without a cluster"
(SURVEY.md §4): sharding/collective tests run SPMD over 8 host devices.
Tests marked `gpu` take the `gpu` fixture, which skips them when JAX
finds no GPU.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# NO persistent compilation cache here.  The round-4 full-suite segfault
# was XLA:CPU's `deserialize_executable` (compilation_cache.py:238) dying
# after thousands of in-process cache reloads: the entry itself was fine
# (the same key deserialized ~45x successfully inside one check_totals FD
# loop before the crashing load), and XLA:CPU's cpu_aot_loader logs
# machine-feature mismatches ("+prefer-no-scatter ... could lead to
# execution errors such as SIGILL") on every reload on this host — CPU
# AOT reload is not trustworthy, so the suite compiles fresh.  The main
# reload amplifier (eager re-dispatch per FD perturbation) was fixed by
# jitting Simulator._restricted_eval, which also makes the suite faster
# without the cache than it ever was with it.

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual devices, got {len(devs)}"
    return devs[:8]


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when the test runs, never at
    import or collection time."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py runs these "
                    "checks on the card)")
    return devs[0]
