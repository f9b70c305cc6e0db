"""Roofline accounting for benchmark rows.

Answers, per measured stage, "how far from hardware limits is this, and
which limit?" so a slow number can be attributed to the right constraint:

* ``compute``    — measured time ~ flops / peak: a faster kernel needs
                   fewer flops (algorithm change).
* ``memory``     — measured time ~ bytes / memory bandwidth: fuse, shrink
                   the working set, or lower the storage precision.
* ``dependency`` — measured time >> both ideals AND the stage is a
                   sequential recursion (block-Thomas scans): the card is
                   idle waiting on the critical path; only a lower-depth
                   algorithm (cyclic reduction, more parallelism) helps.
* ``latency``    — measured time >> both ideals with no stated critical
                   path: launch / program-overhead bound.

Flops/bytes come from XLA's own cost model when a single jitted program
exists (``compiled_cost``), and from analytic models for the block-Thomas
stages (``bt_factor_cost`` / ``bt_sweep_cost``).

The peak a stage is held to is the card's peak for the dtype the stage
runs in (``roofline(..., dtype=)``): float32 means a float32 product at
Precision.HIGHEST, which runs outside the tensor cores, and "tfloat32"
is the tensor-core rate XLA's default float32 precision would use.
``calibrate()`` measures what a large bf16 product and a large copy
reach on the card, the practical ceilings beside the published ones.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

# Published peaks of one card (dense rates, no sparsity), keyed by the
# device_kind JAX reports.  A device that is not here is an error: an H100
# PCIe or any other card needs its own row before its numbers mean
# anything.
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": dict(
        chip="NVIDIA H100 SXM5 80GB",
        peak_flops={"float64": 67e12, "float32": 67e12,
                    "tfloat32": 495e12, "bfloat16": 989e12,
                    "float16": 989e12},
        hbm_bw=3.35e12, hbm_bytes=80e9,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 column "
               "(f64 tensor core, f32 non-tensor, dense TF32/bf16; "
               "rates at the 700 W power limit)"),
}


def chip_spec(device=None):
    """Peak table row for the given (default: first) device; None on the
    CPU, which has no row; ValueError for an accelerator not in the
    table."""
    if device is None:
        device = jax.devices()[0]
    if device.platform == "cpu":
        return None
    kind = device.device_kind
    if kind not in CHIP_SPECS:
        raise ValueError(
            f"no peak table row for device_kind {kind!r} "
            f"(known: {sorted(CHIP_SPECS)}); add it with its source")
    return dict(CHIP_SPECS[kind])


def compiled_cost(jitfn, *args):
    """(flops, bytes_accessed) from XLA's cost model for a jitted fn.

    ``jitfn.lower(*args).compile()`` reuses the compilation of the normal
    warm-up call.  Returns (None, None) when the backend exposes no cost
    analysis.
    """
    try:
        ca = jitfn.lower(*args).compile().cost_analysis()
    except Exception:
        return None, None
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else None
    if not isinstance(ca, dict):
        return None, None
    return ca.get("flops"), ca.get("bytes accessed")


def bt_factor_cost(nb, B, spd=True, op_bytes=8, store_bytes=4):
    """Analytic flops/bytes for the block-Thomas factor recursion
    (ops/block_tridiag.py _factor_step_fn), per full factorization.

    Per block (SPD/Cholesky path): S = D - L@C_prev (2B^3), chol(S)
    (B^3/3), triangular solve to L^-1 (B^3), Linv^T@Linv (2B^3),
    C = Sinv@U (2B^3)  ->  ~22/3 B^3.  General (LU) path: ~10 B^3.
    Bytes: read D,L,U (3 B^2 op_bytes) + write Sinv,C (2 B^2 store_bytes)
    + scan carry traffic C (2 B^2 op_bytes r/w).
    Critical path: nb sequential scan steps.
    """
    per_block = (22.0 / 3.0 if spd else 10.0) * B ** 3
    bytes_per_block = B * B * (3 * op_bytes + 2 * store_bytes + 2 * op_bytes)
    return dict(flops=nb * per_block, bytes=nb * bytes_per_block,
                critical_steps=nb)


def bt_sweep_cost(nb, B, nrhs=1, store_bytes=4, n_sweeps=2):
    """Analytic flops/bytes for the forward+backward triangular sweeps
    (one preconditioner application, nrhs right-hand sides).

    Per block per sweep: one (B,B)@(B,nrhs) gemm pair — forward reads
    L_i and Sinv_i (4 B^2 nrhs flops), backward reads C_i (2 B^2 nrhs).
    Bytes dominated by streaming the factor blocks once per sweep.
    Critical path: n_sweeps * nb sequential steps.
    """
    flops = nb * (4 + 2 * (n_sweeps - 1)) * B * B * nrhs
    bytes_ = nb * 3 * B * B * store_bytes  # Sinv + C + L streamed once
    return dict(flops=flops, bytes=bytes_, critical_steps=n_sweeps * nb)


def roofline(time_s, flops, bytes_accessed, spec=None, dtype="float32",
             critical_steps=None):
    """Classify a measured stage against the card's roofline for `dtype`
    (a key of the spec's peak_flops).

    Returns a JSON-ready dict (or None when no spec / no counts): the
    flop and bandwidth shares of peak, the two ideal times, and the
    binding constraint.
    """
    if spec is None:
        spec = chip_spec()
    if spec is None or not time_s or flops is None or bytes_accessed is None:
        return None
    dtype = dtype if isinstance(dtype, str) else jnp.dtype(dtype).name
    peak = spec["peak_flops"][dtype]
    t_comp = flops / peak
    t_mem = bytes_accessed / spec["hbm_bw"]
    ideal = max(t_comp, t_mem)
    if time_s > 3.0 * ideal:
        bound = "dependency" if critical_steps else "latency"
    elif t_comp >= t_mem:
        bound = "compute"
    else:
        bound = "memory"
    out = dict(
        chip=spec["chip"],
        dtype=dtype,
        flops=float(flops),
        bytes=float(bytes_accessed),
        flop_share=round(flops / time_s / peak, 6),
        bandwidth_share=round(bytes_accessed / time_s / spec["hbm_bw"], 6),
        t_compute_ideal_s=round(t_comp, 6),
        t_memory_ideal_s=round(t_mem, 6),
        bound=bound,
    )
    if critical_steps:
        out["critical_steps"] = int(critical_steps)
        out["per_step_us"] = round(time_s / critical_steps * 1e6, 3)
    return out


def _best_time(fn, *args, reps=5):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def calibrate(n=8192, copy_bytes=1 << 30):
    """What a large bf16 product (n x n x n, f32 accumulation) and a large
    device-to-device copy achieve on the default device: the practical
    ceilings a later roofline share can be read against.  Returns
    {bf16_matmul_tflops, copy_gbps} (copy counts bytes read + written).
    """
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    a = jax.random.normal(ka, (n, n), jnp.bfloat16)
    b = jax.random.normal(kb, (n, n), jnp.bfloat16)
    mm = jax.jit(lambda x, y: jnp.dot(x, y,
                                      preferred_element_type=jnp.float32))
    t_mm = _best_time(mm, a, b)
    x = jnp.ones((copy_bytes // 4,), jnp.float32)
    cp = jax.jit(lambda v: v + 1.0)  # one read + one write pass
    t_cp = _best_time(cp, x)
    return dict(bf16_matmul_tflops=2.0 * n ** 3 / t_mm / 1e12,
                copy_gbps=2.0 * copy_bytes / t_cp / 1e9)
