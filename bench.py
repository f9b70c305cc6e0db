"""Benchmark: EM-motor optimization iteration wall-clock (north-star metric).

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Measures one full opt iteration of the W5 motor workload, fully jitted on
device: mesh-motion solve (2 continuation steps x 3 Newton) + nonlinear
magnetostatics (3 load steps x 3 Newton, piecewise B-H law) + B-power
functionals + IFT adjoint through both states — exactly the reference's
per-iteration cost structure (BASELINE.md: >= 7 SNES solves x (FFCx
assembly + MUMPS LU) + dRdu/dRdf assembly + 2 MUMPS transpose solves on
the CPU reference stack).  Linear solves use the RCM block-tridiagonal
Thomas factorization (lax.scan recursions) polished by fixed-count PCG.
Runs on an NVIDIA GPU only: without one it exits with an error.

The design space is the reference's WIDE one: one (dx, dy) edge delta per
magnet-ring interface node scattered into uhat_bc (BoundaryInputModel,
preprocessor/boundary_input_model.py:34-71) — 576 dvs at refine=1, 2304 at
refine=4.  The IFT adjoint's cost is independent of the dv count; the JSON
records the 2-dof basis time alongside to demonstrate it.

vs_baseline: the reference publishes no perf numbers (BASELINE.md /
SURVEY.md section 6), so the denominator is a MEASURED same-machine CPU
proxy of the reference pipeline (eager per-iteration assembly + scipy splu
sparse-direct Newton/continuation + assembled IFT adjoint, f64, identical
mesh and continuation schedule) recorded in BASELINE_MEASURED.json by
bench_baseline.py.  CAVEAT (stated in the JSON): that proxy ran on ONE
CPU core; the stated reference target is 64 cores (BASELINE.md), so the
honest margin against the real target is smaller than vs_baseline.

Scale framing: refine=1 is 4,608 cells / 7,344 dofs; the ladder row at
refine=4 (73,728 cells / 112,320 dofs — the dof scale of the reference's
wing anchor) is also measured and reported under "ladder" unless
BENCH_QUICK=1 is set.
"""

import json
import os
import time


def _time_step(step, args, n_rep):
    val, grads = step(*args)  # compile + warmup
    val.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(n_rep):
        val, grads = step(*args)
    val.block_until_ready()
    return (time.perf_counter() - t0) / n_rep * 1e3, float(val)


def main():
    from femo_tpu.config import set_precision
    from femo_tpu.utils.cache import enable_persistent_cache
    from femo_tpu.utils.device import describe, require_gpu

    devs = require_gpu()
    enable_persistent_cache(devs[0])
    # float32 with every product at Precision.HIGHEST (set_precision), so
    # no float32 product runs in TF32.  Whether the cells should run f64,
    # which the GPU has natively, is open (ROADMAP speed item 3).
    set_precision("float32")

    from femo_tpu.models.motor.model import build_motor_jit_step

    # refactor_every=3: Shamanskii factor reuse — one factor scan per
    # load step, the stale factor kept as the fresh-operator PCG
    # preconditioner (experiments/motor_latency_oracle.json bounds the
    # loss it gives).
    kw = dict(em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
              factorization="block_thomas", refactor_every=3)
    # freeze_operator (classical Shamanskii): reuse iterations skip the
    # Jacobian fill too.  REFINE=1 ONLY: at refine>=2 the quasi-Newton
    # iteration with the load-step-stale operator diverges on the B-H
    # nonlinearity; the ladder rungs keep fresh-operator re3.  This
    # recipe was tuned on the earlier accelerator and is re-decided by
    # the first benchmark PR on the GPU.
    kw1 = dict(kw, freeze_operator=True)

    from femo_tpu.utils.roofline import chip_spec, compiled_cost, roofline

    spec = chip_spec(devs[0])

    def _roof(jitfn, args, time_s):
        # XLA flops/bytes via the AOT path (reuses the warm-up call's
        # compilation), against the f32 (non-tensor-core) peak
        f, b = compiled_cost(jitfn, *args)
        return roofline(time_s, f, b, spec, dtype="float32")

    # primary: refine=1, wide edge-delta design space
    step, (dv0, iq0), d = build_motor_jit_step(
        refine=1, design_space="edge_deltas", **kw1)
    dt_ms, loss = _time_step(step, (dv0, iq0), n_rep=10)
    roof1 = _roof(step, (dv0, iq0), dt_ms / 1e3)

    # IFT-win reference point: the 2-dof demo basis at the same mesh
    step_b, (dvb, iqb), _ = build_motor_jit_step(
        refine=1, design_space="basis", **kw1)
    dt_basis_ms, _ = _time_step(step_b, (dvb, iqb), n_rep=10)

    meas_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BASELINE_MEASURED.json")
    meas = None
    if os.path.exists(meas_path):
        with open(meas_path) as fh:
            meas = json.load(fh)

    ladder = []
    # CPU proxies of the ladder rungs from BASELINE_MEASURED.json, so a
    # re-measure updates the ladder margin automatically
    cpu_proxy_r4_ms = (meas or {}).get("baseline_ms_refine4")
    cpu_proxy_r2_ms = (meas or {}).get("baseline_ms_refine2")
    if os.environ.get("BENCH_QUICK", "0") != "1":
        # refine=2 rung: the margin-curve midpoint (the idealized-64-core
        # crossover is size-dependent; refine=1 loses, refine=4 wins)
        step2, (dv2, iq2), d2 = build_motor_jit_step(
            refine=2, design_space="edge_deltas", **kw)
        dt2_ms, loss2 = _time_step(step2, (dv2, iq2), n_rep=5)
        ladder.append({
            "refine": 2, "n_cells": int(d2["mesh"].n_cells),
            "n_dofs": int(d2["Vmm"].n_dofs + d2["Vem"].n_dofs),
            "n_dv": int(dv2.shape[0]) + 1, "ms": round(dt2_ms, 3),
            "roofline": _roof(step2, (dv2, iq2), dt2_ms / 1e3),
            "vs_64core_ideal": (round(cpu_proxy_r2_ms / 64 / dt2_ms, 3)
                                if cpu_proxy_r2_ms else None),
        })
        step4, (dv4, iq4), d4 = build_motor_jit_step(
            refine=4, design_space="edge_deltas", **kw)
        dt4_ms, loss4 = _time_step(step4, (dv4, iq4), n_rep=3)
        ladder.append({
            "refine": 4, "n_cells": int(d4["mesh"].n_cells),
            "n_dofs": int(d4["Vmm"].n_dofs + d4["Vem"].n_dofs),
            "n_dv": int(dv4.shape[0]) + 1, "ms": round(dt4_ms, 3),
            "roofline": _roof(step4, (dv4, iq4), dt4_ms / 1e3),
            # margin vs BASELINE.md's stated 64-core target: the 1-core
            # proxy / 64 assumes IDEAL strong scaling of the
            # FEniCSx+MUMPS reference (MUMPS factorization strong-scales
            # sublinearly, so this is the harshest denominator).  The
            # proxy is f64 while this step is f32.  null when the proxy
            # was never measured.
            "vs_64core_ideal": (round(cpu_proxy_r4_ms / 64 / dt4_ms, 3)
                                if cpu_proxy_r4_ms else None),
        })

    if meas is not None:
        baseline_ms = float(meas["baseline_ms"])
        provenance = meas["provenance"] + (
            "; proxy measured on ONE CPU core — the stated reference "
            "target is 64 cores (BASELINE.md), so the honest margin vs "
            "that target is smaller; proxy is f64 while this step is f32")
    else:
        # no measured baseline: report the margins as null rather than
        # manufacture one from an estimate (ADVICE r4)
        baseline_ms = None
        provenance = "estimate: no BASELINE_MEASURED.json (run bench_baseline.py)"
    print(json.dumps({
        "metric": "motor_opt_iter_ms",
        "value": round(dt_ms, 3),
        "unit": "ms",
        "vs_baseline": (round(baseline_ms / dt_ms, 3)
                        if baseline_ms else None),
        # 1-core proxy scaled by ideal 64-way strong scaling — the
        # harshest reading of BASELINE.md's 64-core target.  The proxy
        # is f64; this step is f32.  null when no measured baseline
        # exists.
        "vs_64core_ideal": (round(baseline_ms / 64 / dt_ms, 3)
                            if baseline_ms else None),
        "n_dofs": 7344, "n_cells": 4608,
        "n_dv": int(dv0.shape[0]) + 1,
        "design_space": "edge_deltas (per-interface-node, "
                        "boundary_input_model parity)",
        "basis_2dof_ms": round(dt_basis_ms, 3),
        "roofline": roof1,
        "ladder": ladder,
        "device": describe(devs),
        "baseline": {"ms": baseline_ms, "provenance": provenance},
    }))


if __name__ == "__main__":
    main()
