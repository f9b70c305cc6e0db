"""Block-Thomas triangular sweeps as Pallas kernels for the GPU (Triton route).

The solve phase of the block-tridiagonal factorization (ops/block_tridiag
.py `BlockThomasFactor.solve`) is two length-nb sequential recurrences of
(B,B)@(B,) matvecs:

    fwd:  z_i = Sinv_i (b_i - L_i z_{i-1})
    bwd:  x_i = z_i - C_i x_{i+1}

As a `lax.scan`, XLA runs every step as its own few kernels plus the
loop's control, so the sweep pays a fixed per-step cost nb times over.
Here each sweep is ONE single-program kernel with the nb loop inside
(`lax.fori_loop`): the carry row stays in registers and each step only
streams its (B,B) blocks from device memory.  Blocks of a GPU grid run
in parallel and in no order, so nothing may be carried between programs;
the loop lives inside the one program instead.

A (1,B)@(B,B) product is below the tensor cores' tile, so the matvec is a
broadcast-multiply-sum in f32 FMA — the arithmetic of a float32 product
at Precision.HIGHEST, never TF32.  f32 only: callers cast the factor and
the right-hand side (the f64 paths keep the scan sweeps).

B <= 128 only: one (128,128) f32 tile is 64 KB, which 8 warps hold in
registers.  One program streaming larger blocks is bound by one SM's
bandwidth, and a row-chunked variant lost to the scan sweeps on the card
at B=256 and B=512 (PERF.md), so larger blocks keep the scan.

Replaces: the reference's MUMPS triangular solve phase
(femo/fea/utils_dolfinx.py:476-512 solveKSP_mumps) at the
latency-critical small/medium sizes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

MAX_B = 128


def _fwd_kernel(b_ref, L_ref, Sinv_ref, z_ref):
    nb, B = b_ref.shape

    def body(i, z):
        t = b_ref[i, :] - jnp.sum(L_ref[i, :, :] * z[None, :], axis=1)
        z = jnp.sum(Sinv_ref[i, :, :] * t[None, :], axis=1)
        z_ref[i, :] = z
        return z

    jax.lax.fori_loop(0, nb, body, jnp.zeros((B,), jnp.float32))


def _bwd_kernel(z_ref, C_ref, x_ref):
    nb, B = z_ref.shape

    def body(k, x):
        i = nb - 1 - k
        x = z_ref[i, :] - jnp.sum(C_ref[i, :, :] * x[None, :], axis=1)
        x_ref[i, :] = x
        return x

    jax.lax.fori_loop(0, nb, body, jnp.zeros((B,), jnp.float32))


@partial(jax.jit, static_argnames=("interpret",))
def bt_sweep_solve(Sinv, L, C, bb, interpret: bool = False):
    """Both triangular sweeps as Pallas-Triton kernels.

    Sinv/L/C: (nb, B, B);  bb: (nb, B) (RCM-block layout), all cast to
    f32.  Returns x blocks (nb, B) f32 — the scan sweeps' result up to f32
    summation order.  B must be a power of two (Triton's tensor shapes)
    and at most MAX_B; interpret=True runs the kernels in the Pallas
    interpreter (tests).
    """
    nb, B = bb.shape
    if B & (B - 1) or B > MAX_B:
        raise ValueError(f"block size B={B} is not a power of two <= "
                         f"{MAX_B}; use the scan sweeps")
    f32 = jnp.float32
    call = partial(
        pl.pallas_call,
        out_shape=jax.ShapeDtypeStruct((nb, B), f32),
        backend="triton",
        # 8 warps: 64 registers a thread for one (128,128) f32 tile; 4 and
        # 16 warps measured within 20% on the card (PERF.md)
        compiler_params=pl_triton.CompilerParams(num_warps=8, num_stages=1),
        interpret=interpret)
    z = call(_fwd_kernel, name="bt_fwd_sweep")(
        bb.astype(f32), L.astype(f32), Sinv.astype(f32))
    return call(_bwd_kernel, name="bt_bwd_sweep")(z, C.astype(f32))
