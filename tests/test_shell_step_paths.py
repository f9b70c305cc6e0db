"""Parity across build_shell_jit_step solver configurations: every
production option (adjoint factor reuse, split programs, Jacobi
equilibration, f32 factor storage) must agree with the plain fused
block-Thomas step (f64 CPU)."""

import numpy as np
import pytest

from femo_tpu.models.shell import build_shell_jit_step


@pytest.fixture(scope="module")
def baseline():
    step, t0, info = build_shell_jit_step(n_shell=(6, 8))
    v, g = step(t0)
    return t0, float(v), np.asarray(g)


@pytest.mark.parametrize("kw,rtol", [
    (dict(adjoint="reuse_symmetric", pcg_iters=2), 1e-7),
    (dict(split_programs=True, pcg_iters=2), 1e-7),
    # f32-stored factor + PCG polish: mixed-precision envelope ~1e-5
    (dict(split_programs=True, pcg_iters=4,
          factor_store_dtype="float32"), 1e-4),
    (dict(jacobi_scale=True, pcg_iters=2), 1e-7),
    (dict(solve_mode="jit_dense"), 1e-7),
    # mixed-precision block inverses (f32 seed + f64 Newton-Schulz,
    # chain in f64 on the raw operator): near-f64 accurate, so tighter
    # than the f32 store
    (dict(split_programs=True, pcg_iters=4,
          factor_compute_dtype="mixed",
          factor_store_dtype="float32"), 1e-4),
    (dict(split_programs=True, pcg_iters=2,
          factor_compute_dtype="mixed"), 1e-6),
])
def test_step_path_parity(baseline, kw, rtol):
    t0, v_ref, g_ref = baseline
    step, t0b, _ = build_shell_jit_step(n_shell=(6, 8), **kw)
    v, g = step(t0b)
    np.testing.assert_allclose(float(v), v_ref, rtol=rtol)
    # norm-based gradient comparison (elementwise relative error is
    # meaningless on near-zero entries)
    rel = (np.linalg.norm(np.asarray(g) - g_ref)
           / np.linalg.norm(g_ref))
    assert rel < max(rtol, 1e-6), rel
