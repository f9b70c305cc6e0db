"""Preconditioners for device Krylov solvers.

SURVEY.md "hard part" #1 notes Chebyshev/Jacobi as the accelerator-friendly
preconditioning family (no sequential triangular solves, no dot products in
the application — pure fused matvecs).  The block-Thomas structured factor
(ops/block_tridiag.py) covers the direct/strong end; Chebyshev covers the
smoother/iterative end (and is the standard multigrid smoother for a future
GMG level hierarchy).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def estimate_lambda_max(matvec: Callable, diag_inv: jnp.ndarray,
                        iters: int = 15, seed: int = 0):
    """Power iteration for the largest eigenvalue of D^{-1} A (jittable)."""
    n = diag_inv.shape[0]
    key = jax.random.PRNGKey(seed)
    v = jax.random.normal(key, (n,), diag_inv.dtype)
    v = v / jnp.linalg.norm(v)

    def body(_, state):
        v, lam = state
        w = diag_inv * matvec(v)
        lam = jnp.linalg.norm(w)
        return (w / (lam + 1e-30), lam)

    v, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(1.0, v.dtype)))
    return lam


def chebyshev_preconditioner(matvec: Callable, diag: jnp.ndarray,
                             degree: int = 4, lam_max=None,
                             lam_min_ratio: float = 1 / 30.0,
                             eig_iters: int = 15):
    """Chebyshev polynomial preconditioner for SPD operators.

    Applies a degree-`degree` Chebyshev polynomial of the Jacobi-scaled
    operator targeting the eigenvalue interval
    [lam_min_ratio * lam_max, lam_max] — the classic smoother: fixed
    iteration count, zero reductions inside, fully fused matvecs.
    """
    d = jnp.where(jnp.abs(diag) > 1e-30, diag, 1.0)
    dinv = 1.0 / d
    if lam_max is None:
        lam_max = estimate_lambda_max(matvec, dinv, eig_iters)
    lam_max = 1.02 * lam_max
    lam_min = lam_min_ratio * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta

    def M(r):
        # Chebyshev acceleration (Saad, Alg. 12.1) on the Jacobi-scaled
        # operator B = D^{-1} A with rhs D^{-1} r, starting from x = 0
        res0 = dinv * r
        d0 = res0 / theta
        x0 = d0
        rho0 = 1.0 / sigma1

        def body(k, state):
            x, d_prev, rho_prev = state
            res = dinv * (r - matvec(x))
            rho = 1.0 / (2.0 * sigma1 - rho_prev)
            dk = rho * rho_prev * d_prev + (2.0 * rho / delta) * res
            return (x + dk, dk, rho)

        x, _, _ = jax.lax.fori_loop(1, degree, body, (x0, d0, rho0))
        return x

    return M
