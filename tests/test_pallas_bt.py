"""Pallas-Triton block-Thomas sweep kernels (ops/pallas_bt.py).

On the CPU they run in the Pallas interpreter, and only when a caller
asks for it (interpret=True); the compiled kernel on the card is checked
by chip_smoke.py (phase 4) and by the gpu-marked test below.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from chip_smoke import synthetic_factor
from femo_tpu.ops.block_tridiag import scan_sweeps
from femo_tpu.ops.pallas_bt import bt_sweep_solve


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("nb", [1, 3, 9])
def test_pallas_sweeps_match_scan(nb):
    mat, fac, b = synthetic_factor(nb, 128)
    x_scan = np.asarray(fac.solve(b))
    x_pl = np.asarray(fac.solve_pallas(b, interpret=True))
    assert _rel(x_pl, x_scan) < 1e-6
    # and it actually solves the system
    r = np.asarray(mat.matvec(jnp.asarray(x_pl))) - np.asarray(b)
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-4


@pytest.mark.parametrize("nb,B", [(5, 64), (2, 32)])
def test_pallas_sweeps_smaller_blocks(nb, B):
    mat, fac, b = synthetic_factor(nb, B)
    bb = mat.to_blocks(b)
    xk = bt_sweep_solve(fac.Sinv, mat.L, fac.C, bb, interpret=True)
    assert _rel(xk, scan_sweeps(fac.Sinv, mat.L, fac.C, bb)) < 1e-6


def test_pallas_sweep_direct_blocks():
    mat, fac, b = synthetic_factor(4, 128, seed=3)
    bb = mat.to_blocks(b)
    xb = bt_sweep_solve(fac.Sinv, mat.L, fac.C, bb, interpret=True)
    assert xb.shape == (4, 128) and xb.dtype == jnp.float32
    assert bool(jnp.all(jnp.isfinite(xb)))


@pytest.mark.parametrize("B", [96, 256])
def test_pallas_sweeps_reject_unsupported_block(B):
    """B must be a power of two (Triton) and at most 128 (one register
    tile): anything else raises rather than falling back."""
    Z = jnp.zeros((2, B, B), jnp.float32)
    with pytest.raises(ValueError, match="power of two <= 128"):
        bt_sweep_solve(Z, Z, Z, jnp.zeros((2, B), jnp.float32),
                       interpret=True)


def test_pallas_sweeps_never_interpret_unless_asked():
    """Off the GPU the kernel is compiled for the Triton route, which the
    CPU backend refuses: no silent interpreter fallback."""
    mat, fac, b = synthetic_factor(2, 128)
    with pytest.raises(Exception, match="(?i)interpret|triton|gpu|cuda"):
        jax.block_until_ready(fac.solve_pallas(b))


def test_pallas_sweeps_honour_factor_scale():
    """solve_pallas applies the factor's Jacobi scale exactly as solve()
    does (the FSI builders' equilibrated factors)."""
    from femo_tpu.ops.block_tridiag import BlockThomasFactor

    mat, _, b = synthetic_factor(3, 128, seed=5)
    smat, s = mat.jacobi_scaled()
    f = smat.factor()
    fac = BlockThomasFactor(mat, f.Sinv, f.C, scale=s, Lfac=smat.L)
    assert _rel(fac.solve_pallas(b, interpret=True), fac.solve(b)) < 1e-6


@pytest.mark.gpu
def test_sweep_kernel_compiled_on_gpu(gpu):
    import chip_smoke

    rows = chip_smoke.phase_sweep_kernel([(39, 128), (147, 128)], n_rep=2)
    assert all(r["rel_diff"] <= chip_smoke.SWEEP_BAR for r in rows)


@pytest.mark.parametrize("nb,B", [(39, 128), (20, 128), (147, 64)])
def test_pallas_sweeps_lower_for_cuda(nb, B):
    """The kernels lower through Pallas' Triton route for CUDA at the
    motor steps' block shapes (the route's lowering rules run here;
    Triton's own compilation needs the card)."""
    from functools import partial

    S = jax.ShapeDtypeStruct((nb, B, B), jnp.float32)
    b = jax.ShapeDtypeStruct((nb, B), jnp.float32)
    low = jax.jit(partial(bt_sweep_solve, interpret=False)).trace(
        S, S, S, b).lower(lowering_platforms=("cuda",))
    text = low.as_text()
    assert "bt_fwd_sweep" in text and "bt_bwd_sweep" in text
