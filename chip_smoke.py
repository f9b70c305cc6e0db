"""Smoke test of the motor optimisation step on NVIDIA GPUs.

    python chip_smoke.py          # one card: phases 1-4
    python chip_smoke.py --multi  # four cards: phase 5 only

Drives the public builders at the sizes bench.py uses and checks each
result against a reference:

1. device: device kind, count, JAX version, compile cache, native host
   library; what a large bf16 product and a large copy reach.
2. motor refine=1 in f64 on the GPU against the same step on the CPU
   backend of this process (loss and gradient within 1e-8).
3. motor refine=4, the bench recipe (f32 at Precision.HIGHEST, block
   Thomas, pcg8, refactor_every=3): warm step time, loss against the f64
   oracle, gradient against the same recipe in f64 on the same card,
   memory analysis and peak memory.
4. the Pallas-Triton triangular-sweep kernel (ops/pallas_bt.py) against
   the lax.scan sweeps at B=128 and the motor steps' block counts nb.
5. (--multi) the dof-sharded halo motor step at refine=4 and the
   cells-sharded motor step at refine=2 on four cards against the
   one-card step, in f64.

Each phase is a function of its sizes, so the CPU tests rehearse them at
refine=0.5 with the kernel in interpret mode; main() refuses to run
without a GPU.  Every line before the last is a JSON record that names
the card (nvidia-smi's name and power limit); the last line is
{"ok": true, "device": {...}}.  Any failed check raises, and the script
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

MOTOR_KW = dict(design_space="edge_deltas", factorization="block_thomas",
                em_load_steps=3, mm_newton_iters=3, em_newton_iters=3)
# the bench recipe on top of MOTOR_KW (bench.py); pcg_iters=8 is the
# builder's default, spelled out here
RECIPE_KW = dict(MOTOR_KW, pcg_iters=8, refactor_every=3)
# converged Newton count of the halo step's 1e-8 parity test
# (tests/test_motor_halo.py): IFT gradients are algorithm-independent
# only at convergence
HALO_NEWTON = 6
GRAD_BAR_F64 = 1e-8  # BASELINE.md gradient bar
ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "experiments", "motor_latency_oracle.json")

_card = None


def log(phase, **fields):
    print(json.dumps(dict(phase=phase, card=_card, **fields)), flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def grad_vec(grads):
    gdv, giq = grads
    return np.concatenate([np.asarray(gdv, np.float64).ravel(),
                           [float(giq)]])


def time_step(step, args, n_rep):
    """Warm the step (compile + first run), then the mean of n_rep runs
    ending in block_until_ready (None when n_rep is 0)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(step(*args))
    first_s = time.perf_counter() - t0
    if not n_rep:
        return out, first_s, None
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = step(*args)
    jax.block_until_ready(out)
    return out, first_s, (time.perf_counter() - t0) / n_rep * 1e3


def phase_device(devs):
    import jax

    from femo_tpu import native
    from femo_tpu.utils.cache import cache_dir
    from femo_tpu.utils.roofline import calibrate, chip_spec

    log("device", platform=devs[0].platform,
        device_kind=devs[0].device_kind, device_count=len(devs),
        jax_version=jax.__version__,
        compile_cache=cache_dir(),
        native_lib_loaded=native.get_lib() is not None,
        peak_source=chip_spec(devs[0])["source"])
    log("calibration", **calibrate())


def phase_motor_f64_vs_cpu(refine, device, cpu):
    """The f64 step on `device` against the same step on the CPU
    backend, built separately under each default device."""
    import jax

    from femo_tpu.config import set_precision
    from femo_tpu.models.motor.model import build_motor_jit_step

    set_precision("float64")
    res = {}
    for name, dev in (("device", device), ("cpu", cpu)):
        with jax.default_device(dev):
            step, args, d = build_motor_jit_step(refine=refine, **MOTOR_KW)
            (val, grads), first_s, ms = time_step(step, args, n_rep=3)
        res[name] = (float(val), grad_vec(grads), first_s, ms)
    loss_err = abs(res["device"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    grad_err = rel(res["device"][1], res["cpu"][1])
    log("motor_f64_vs_cpu", refine=refine, nb=d["bt"], loss=res["device"][0],
        loss_rel_err=loss_err, grad_rel_err=grad_err, bar=GRAD_BAR_F64,
        first_call_s=res["device"][2], warm_step_ms=res["device"][3],
        cpu_warm_step_ms=res["cpu"][3])
    check(loss_err <= GRAD_BAR_F64 and grad_err <= GRAD_BAR_F64,
          f"f64 device vs CPU: loss {loss_err:.3e}, grad {grad_err:.3e}")
    return dict(nb=d["bt"], loss=res["device"][0])


# f32 bars of phase 3.  Every float32 product of the step runs at
# Precision.HIGHEST: set_precision("float32") sets
# jax_default_matmul_precision="highest", block_tridiag passes
# precision=HIGHEST to each einsum, and the Pallas sweeps are FMA.  So
# the f32 step differs from its f64 twin by f32 rounding alone: the CPU's
# true-f32 gradient differs from f64 by 1.1e-5 at refine=2
# (experiments/motor_f32_grad_structure.json).  TF32 products keep 10
# mantissa bits (~5e-4 per product) and would put the gradient near
# 1e-2, so the 1e-3 gradient bar separates the two.
GRAD_BAR_F32 = 1e-3
# loss vs the f64 oracle (re1, same Newton counts): the f32 rounding
# (~2e-7, same record) plus the shift refactor_every=3 gives the
# fixed-count Newton iterate, which is what this bar bounds
LOSS_BAR_F32 = 1e-3


def phase_motor_recipe(refine, device, n_rep=3):
    """The bench recipe in f32 on `device`, against the f64 oracle (loss)
    and the same recipe in f64 on the same device (gradient)."""
    import jax

    from femo_tpu.config import set_precision
    from femo_tpu.models.motor.model import build_motor_jit_step

    with open(ORACLE) as fh:
        oracle = json.load(fh)[str(float(refine))]
    out = {}
    with jax.default_device(device):
        for dtype in ("float32", "float64"):
            set_precision(dtype)
            step, args, d = build_motor_jit_step(refine=refine, **RECIPE_KW)
            (val, grads), first_s, ms = time_step(step, args, n_rep)
            out[dtype] = (float(val), grad_vec(grads), first_s, ms)
            if dtype == "float32":
                mem = step.lower(*args).compile().memory_analysis()
                stats = device.memory_stats() or {}
                log("motor_recipe_memory", refine=refine,
                    temp_bytes=getattr(mem, "temp_size_in_bytes", None),
                    argument_bytes=getattr(mem, "argument_size_in_bytes",
                                           None),
                    output_bytes=getattr(mem, "output_size_in_bytes", None),
                    code_bytes=getattr(mem, "generated_code_size_in_bytes",
                                       None),
                    peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    set_precision("float64")
    loss32, g32, first_s, ms = out["float32"]
    loss_err = abs(loss32 - oracle) / abs(oracle)
    loss_err_f64 = abs(loss32 - out["float64"][0]) / abs(out["float64"][0])
    grad_err = rel(g32, out["float64"][1])
    log("motor_recipe", refine=refine, nb=d["bt"],
        loss=loss32, oracle=oracle, loss_rel_err_oracle=loss_err,
        loss_rel_err_f64=loss_err_f64, grad_rel_err_f64=grad_err,
        loss_bar=LOSS_BAR_F32, grad_bar=GRAD_BAR_F32, first_call_s=first_s,
        warm_step_ms=ms, f64_warm_step_ms=out["float64"][3])
    check(loss_err <= LOSS_BAR_F32 and grad_err <= GRAD_BAR_F32,
          f"f32 recipe: loss vs oracle {loss_err:.3e}, "
          f"grad vs f64 {grad_err:.3e}")
    return dict(nb=d["bt"], loss=loss32, warm_step_ms=ms)


SWEEP_BAR = 1e-5  # f32 kernel vs f32 scan: summation order only


def synthetic_factor(nb, B, seed=0):
    """A symmetric block-tridiagonal matrix in f32, diagonally dominant at
    every B (the random parts scale as 1/sqrt(B)), and its block-Thomas
    factor."""
    import jax.numpy as jnp

    from femo_tpu.ops.block_tridiag import BlockTridiagonalMatrix

    rng = np.random.default_rng(seed)
    w = np.sqrt(128.0 / B)
    D = np.tile(np.eye(B) * 4.0, (nb, 1, 1)) \
        + 0.02 * w * rng.standard_normal((nb, B, B))
    D = 0.5 * (D + np.swapaxes(D, 1, 2))
    L = 0.1 * w * rng.standard_normal((nb, B, B))
    L[0] = 0
    U = np.swapaxes(np.roll(L, -1, axis=0), 1, 2).copy()
    U[-1] = 0
    n = nb * B
    mat = BlockTridiagonalMatrix(
        jnp.asarray(D, jnp.float32), jnp.asarray(L, jnp.float32),
        jnp.asarray(U, jnp.float32), np.arange(n), n)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)
    return mat, mat.factor(), b


def phase_sweep_kernel(shapes, interpret=False, n_rep=20):
    """The Pallas-Triton sweeps against the scan sweeps at each (nb, B):
    relative difference, residual of the kernel's solution, and the
    standalone time of each (one jitted solve each)."""
    import jax

    from femo_tpu.ops.block_tridiag import scan_sweeps
    from femo_tpu.ops.pallas_bt import bt_sweep_solve

    rows = []
    for nb, B in sorted(set(shapes)):
        mat, fac, b = synthetic_factor(nb, B)
        bb = mat.to_blocks(b)
        args = (fac.Sinv, mat.L, fac.C, bb)
        kern = jax.jit(lambda *a: bt_sweep_solve(*a, interpret=interpret))
        scan = jax.jit(scan_sweeps)
        xk, _, kern_us = time_step(kern, args, n_rep)
        xs, _, scan_us = time_step(scan, args, n_rep)
        diff = rel(xk, xs)
        x = mat.from_blocks(xk)
        resid = rel(mat.matvec(x), b)
        row = dict(nb=nb, B=B, rel_diff=diff, residual=resid,
                   kernel_us=kern_us * 1e3, scan_us=scan_us * 1e3)
        log("sweep_kernel", interpret=interpret, bar=SWEEP_BAR, **row)
        check(diff <= SWEEP_BAR and resid <= 1e-4,
              f"sweep kernel nb={nb} B={B}: rel {diff:.3e}, "
              f"residual {resid:.3e}")
        rows.append(row)
    return rows


def phase_multi(refine_halo, refine_cells, n_devices=4):
    """The dof-sharded halo motor step at refine_halo and the cells-
    sharded one at refine_cells on n_devices, each against the one-device
    block-Thomas step at its refine; all f64 at the converged Newton
    count.  The cells-sharded step assembles a replicated dense Jacobian
    and solves it by dense LU (models/motor/model.py), which at refine=4
    would be a 45 GB matrix on every card: it runs at a smaller refine."""
    from femo_tpu.config import set_precision
    from femo_tpu.models.motor.model import build_motor_jit_step
    from femo_tpu.parallel.halo_newton import build_motor_halo_step
    from femo_tpu.parallel.sharding import device_mesh

    set_precision("float64")
    dm = device_mesh(n_devices)
    check(len({d.id for d in dm.devices.flat}) == n_devices,
          f"mesh spans {dm.devices.size} distinct devices")
    # one run each (compile + run): the halo step at refine=4 takes tens
    # of seconds, and this phase checks agreement, not speed
    for name, refine, build in (
            ("cells", refine_cells, build_motor_jit_step),
            ("halo", refine_halo, build_motor_halo_step)):
        kw = dict(refine=refine, design_space="edge_deltas",
                  mm_newton_iters=HALO_NEWTON, em_newton_iters=HALO_NEWTON)
        step1, args, _ = build_motor_jit_step(
            factorization="block_thomas", **kw)
        (l1, g1), first1_s, _ = time_step(step1, args, n_rep=0)
        step, args_n, _ = build(device_mesh=dm, **kw)
        (ln, gn), first_s, _ = time_step(step, args_n, n_rep=0)
        on = sorted({d.id for d in ln.sharding.device_set})
        loss_err = abs(float(ln) - float(l1)) / abs(float(l1))
        grad_err = rel(grad_vec(gn), grad_vec(g1))
        log("multi_" + name, refine=refine, n_devices=n_devices,
            result_devices=on, loss=float(ln), loss_rel_err=loss_err,
            grad_rel_err=grad_err, bar=GRAD_BAR_F64, first_call_s=first_s,
            one_device_first_call_s=first1_s)
        check(loss_err <= GRAD_BAR_F64 and grad_err <= GRAD_BAR_F64,
              f"{name} step vs one device: loss {loss_err:.3e}, "
              f"grad {grad_err:.3e}")


def main(argv=None):
    global _card
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    from femo_tpu.utils.device import nvidia_smi_name_power, require_gpu

    devs = require_gpu()
    _card = nvidia_smi_name_power()
    print(f"card: {_card}", flush=True)

    import jax

    from femo_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache(devs[0])
    if args.multi:
        if len(devs) < 4:
            raise RuntimeError(f"--multi needs 4 GPUs, found {len(devs)}")
        devs = devs[:4]
        phase_multi(refine_halo=4, refine_cells=2, n_devices=4)
    else:
        devs = devs[:1]
        phase_device(devs)
        from femo_tpu.ops.pallas_bt import MAX_B

        # the kernel at B=128 and each motor system's nb (refine=4 picks
        # B=256/512, which the kernel does not take)
        shapes = []
        for r in (phase_motor_f64_vs_cpu(1, devs[0], jax.devices("cpu")[0]),
                  phase_motor_recipe(4, devs[0])):
            shapes += [(v["nb"], MAX_B) for v in r["nb"].values()]
        phase_sweep_kernel(shapes)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
