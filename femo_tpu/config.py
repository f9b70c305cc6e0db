"""Global configuration for femo_tpu.

The reference framework (RuruX/femo) relies on PETSc option databases and
per-instance flags (`femo/fea/fea_dolfinx.py:87-98`).  Here configuration is a
single module-level registry with explicit setters, read at trace time.

Precision policy
----------------
PDE-constrained optimization needs tight gradients (FD-vs-adjoint parity to
~1e-8, see BASELINE.md).  We therefore default to float64 *accumulation*;
the hot compute (element kernels, SpMV) can be run in f32 with f64
reductions by setting ``compute_dtype``.
"""

from __future__ import annotations

import os

import jax

# Enable x64 as early as possible — before any tracing happens.
jax.config.update("jax_enable_x64", True)


class Config:
    """Module-level configuration registry."""

    def __init__(self) -> None:
        # dtype used for dof vectors, residuals, Krylov accumulation
        self.dtype = "float64"
        # dtype used inside element kernels / SpMV (may be lower precision)
        self.compute_dtype = "float64"
        # index dtype for dofmaps / connectivity
        self.index_dtype = "int32"
        # dense-direct solver threshold (n_dofs); above it, Krylov is used
        self.dense_direct_max_dofs = int(
            os.environ.get("FEMO_TPU_DENSE_DIRECT_MAX", "4096")
        )
        # default Krylov tolerances (SNES parity: atol/rtol 1e-13,
        # femo/fea/utils_dolfinx.py:377-379)
        self.krylov_rtol = 1e-12
        self.krylov_atol = 1e-14
        self.krylov_maxiter = 10000
        # Newton defaults (reference SNES: atol/rtol 1e-13 max_it 100)
        self.newton_rtol = 1e-12
        self.newton_atol = 1e-13
        self.newton_maxiter = 100
        # global verbosity (reference FEA.REPORT)
        self.report = False

    # -- helpers -----------------------------------------------------------
    @property
    def jdtype(self):
        import jax.numpy as jnp

        return jnp.dtype(self.dtype)

    @property
    def jidtype(self):
        import jax.numpy as jnp

        return jnp.dtype(self.index_dtype)


config = Config()


def set_precision(dtype: str, compute_dtype: str | None = None) -> None:
    """Set working precision ('float32' or 'float64').

    float32 also disables jax x64 mode: otherwise Python-literal promotion
    (jnp.eye, 0.5 * ..., etc.) silently upcasts kernels to f64.

    Every call sets Precision.HIGHEST as the default matmul precision, so
    no float32 product runs in a reduced-precision mode (TF32 on the
    GPU, ~5e-4 rel err per product), which compounds through the
    assembly/residual dots into a percent-level motor gradient error.
    Gradient quality is the product here (BASELINE.md parity bar)."""
    config.dtype = dtype
    config.compute_dtype = compute_dtype or dtype
    jax.config.update("jax_enable_x64", dtype == "float64")
    jax.config.update("jax_default_matmul_precision", "highest")
