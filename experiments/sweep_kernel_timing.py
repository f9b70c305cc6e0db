"""Pallas-Triton triangular sweeps (ops/pallas_bt.py) against the lax.scan
sweeps inside the fused motor step on the GPU.

    python experiments/sweep_kernel_timing.py [--refines 1]
        [--out chiprun_out/sweep_kernel_timing.jsonl]

Runs the bench recipe (bench.py: f32 at HIGHEST, block Thomas, pcg8,
refactor_every=3, freeze_operator at refine=1) with sweeps="scan" and
sweeps="pallas", timed in turns (scan, pallas, pallas, scan) in one
process on one card, with the loss and gradient of the two compared.
Each record names the card.  GPU only.  The standalone times of the two
sweeps are chip_smoke.py's phase 4.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _ms(fn, args, n_rep):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_rep * 1e3, out


def e2e(refine, emit):
    from chip_smoke import grad_vec, rel
    from femo_tpu.config import set_precision
    from femo_tpu.models.motor.model import build_motor_jit_step

    set_precision("float32")
    kw = dict(design_space="edge_deltas", factorization="block_thomas",
              em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
              pcg_iters=8, refactor_every=3, freeze_operator=refine == 1)
    steps, outs = {}, {}
    for sweeps in ("scan", "pallas"):
        t0 = time.perf_counter()
        step, args, d = build_motor_jit_step(refine=refine, sweeps=sweeps,
                                             **kw)
        _, outs[sweeps] = _ms(step, args, 1)
        steps[sweeps] = (step, args, time.perf_counter() - t0)
    n_rep = 10 if refine <= 1 else 3
    times = {"scan": [], "pallas": []}
    for sweeps in ("scan", "pallas", "pallas", "scan"):
        step, args, _ = steps[sweeps]
        times[sweeps].append(_ms(step, args, n_rep)[0])
    (ls, gs), (lp, gp) = outs["scan"], outs["pallas"]
    emit(dict(kind="e2e", refine=refine, nb=d["bt"],
              scan_ms=times["scan"], pallas_ms=times["pallas"],
              build_and_first_s={k: v[2] for k, v in steps.items()},
              loss_scan=float(ls), loss_pallas=float(lp),
              loss_rel_diff=abs(float(lp) - float(ls)) / abs(float(ls)),
              grad_rel_diff=rel(grad_vec(gp), grad_vec(gs))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refines", default="1")
    ap.add_argument("--out", default="chiprun_out/sweep_kernel_timing.jsonl")
    a = ap.parse_args()

    from femo_tpu.utils.cache import enable_persistent_cache
    from femo_tpu.utils.device import nvidia_smi_name_power, require_gpu

    devs = require_gpu()
    enable_persistent_cache(devs[0])
    card = nvidia_smi_name_power()
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)

    def emit(rec):
        rec = dict(rec, card=card, device_kind=devs[0].device_kind)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(a.out, "a") as fh:
            fh.write(line + "\n")

    # one failed refine is recorded and the others still run
    failed = 0
    for refine in a.refines.split(","):
        try:
            e2e(float(refine), emit)
        except Exception as e:  # noqa: BLE001 — reported, exit code set
            failed += 1
            emit(dict(kind="e2e", refine=refine,
                      error=f"{type(e).__name__}: {str(e)[:500]}"))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
