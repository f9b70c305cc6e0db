"""f64 CPU oracle losses of the benchmarked motor step.

Runs the motor opt step (same mesh/continuation/Newton counts as bench.py,
edge-delta design space) in f64 on CPU with the Thomas block factorization
and pcg8, and records {refine: loss} to motor_latency_oracle.json, which
chip_smoke.py compares the f32 bench recipe with.

Usage: PYTHONPATH=. REFINES=0.5,1,2 python experiments/motor_latency_oracle.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main():
    from femo_tpu.models.motor.model import build_motor_jit_step

    refines = [float(x) for x in
               os.environ.get("REFINES", "0.5,1,2").split(",")]
    # merge-preserve: a partial re-measure (e.g. REFINES=4) must not
    # clobber the existing rungs
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "motor_latency_oracle.json")
    out = {}
    if os.path.exists(path):
        with open(path) as fh:
            out = json.load(fh)
    for refine in refines:
        step, (dv0, iq0), d = build_motor_jit_step(
            refine=refine, em_load_steps=3, mm_newton_iters=3,
            em_newton_iters=3, factorization="block_thomas",
            pcg_iters=8, design_space="edge_deltas")
        val, _ = step(dv0, iq0)
        out[str(refine)] = float(val)
        print(refine, float(val), flush=True)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "motor_latency_oracle.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
