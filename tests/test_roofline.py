"""Roofline accounting (utils/roofline.py): the peak table, the
classification logic and the analytic block-Thomas cost models."""

from types import SimpleNamespace

import numpy as np
import pytest

from femo_tpu.utils.roofline import (
    CHIP_SPECS, bt_factor_cost, bt_sweep_cost, chip_spec, compiled_cost,
    roofline)

H100 = "NVIDIA H100 80GB HBM3"
SPEC = CHIP_SPECS[H100]


def _dev(platform, kind):
    return SimpleNamespace(platform=platform, device_kind=kind)


def test_roofline_classification():
    # compute-bound: time ~ flops/peak, flops-heavy (f32 non-tensor peak)
    r = roofline(1.0, 67e12, 1e9, SPEC)
    assert r["bound"] == "compute" and r["dtype"] == "float32"
    assert abs(r["flop_share"] - 1.0) < 1e-6
    # memory-bound: time ~ bytes/bw
    r = roofline(1.0, 1e9, 3.35e12, SPEC)
    assert r["bound"] == "memory"
    assert abs(r["bandwidth_share"] - 1.0) < 1e-6
    # far off both ideals with a critical path -> dependency
    r = roofline(10.0, 1e9, 1e9, SPEC, critical_steps=7000)
    assert r["bound"] == "dependency"
    assert r["critical_steps"] == 7000
    assert abs(r["per_step_us"] - 10.0 / 7000 * 1e6) < 1e-3
    # far off both ideals with no critical path -> latency
    r = roofline(10.0, 1e9, 1e9, SPEC)
    assert r["bound"] == "latency"
    # missing counts -> None
    assert roofline(1.0, None, 1e9, SPEC) is None
    assert roofline(0.0, 1e9, 1e9, SPEC) is None


def test_bt_cost_models_scale_correctly():
    f1 = bt_factor_cost(100, 128)
    f2 = bt_factor_cost(200, 128)
    assert f2["flops"] == 2 * f1["flops"]
    assert f2["critical_steps"] == 200
    # B^3 scaling of the factor
    f4 = bt_factor_cost(100, 256)
    assert abs(f4["flops"] / f1["flops"] - 8.0) < 1e-9
    # QR (general) path costs more than the SPD/Cholesky path
    assert bt_factor_cost(100, 128, spd=False)["flops"] > f1["flops"]
    s = bt_sweep_cost(100, 128, nrhs=1)
    assert s["critical_steps"] == 200  # 2 sweeps x nb
    # sweeps are B^2 (matvec), factor is B^3
    s4 = bt_sweep_cost(100, 256)
    assert abs(s4["flops"] / s["flops"] - 4.0) < 1e-9


def test_roofline_peak_follows_dtype():
    """The same flops against the bf16 tensor-core peak are a smaller
    share than against the f32 (non-tensor) peak."""
    f32 = roofline(1.0, 10e12, 1e9, SPEC, dtype="float32")
    bf16 = roofline(1.0, 10e12, 1e9, SPEC, dtype="bfloat16")
    f64 = roofline(1.0, 10e12, 1e9, SPEC, dtype=np.float64)
    assert abs(f32["flop_share"] - 10 / 67) < 1e-6
    assert abs(bf16["flop_share"] - 10 / 989) < 1e-6
    assert f64["dtype"] == "float64"
    with pytest.raises(KeyError):
        roofline(1.0, 1e12, 1e9, SPEC, dtype="int4")


@pytest.mark.parametrize("kind,ok", [
    (H100, True),
    ("NVIDIA H100 PCIe", False),
    ("NVIDIA A100-SXM4-80GB", False),
])
def test_chip_spec_table(kind, ok):
    """The H100 SXM resolves to its data-sheet peaks with their source;
    any other accelerator is an error, not a default."""
    if ok:
        spec = chip_spec(_dev("gpu", kind))
        assert spec["peak_flops"]["float64"] == 67e12
        assert spec["peak_flops"]["bfloat16"] == 989e12
        assert spec["hbm_bw"] == 3.35e12 and "data sheet" in spec["source"]
    else:
        with pytest.raises(ValueError, match="no peak table row"):
            chip_spec(_dev("gpu", kind))


def test_chip_spec_and_compiled_cost_on_cpu(devices8):
    # CPU: no spec -> callers skip roofline fields
    assert chip_spec() is None
    # compiled_cost returns floats (or None, None) without raising
    import jax
    import jax.numpy as jnp

    fn = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((64, 64))
    fl, by = compiled_cost(fn, x)
    assert fl is None or fl > 0
