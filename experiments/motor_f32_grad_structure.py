"""Structure of the f32 motor-gradient deviation.

A relative L2 gradient error of the f32 step against the f64 step can
mean two very different things for an optimizer:

  (a) a ~10% rotation of the descent direction (bad), or
  (b) noise concentrated in near-zero components of the 577-dim
      edge-delta gradient while the large components match (benign:
      descent quality and the active constraint set are set by the
      large components).

This probe decides which, on CPU (true f32 arithmetic against f64):
cosine similarity, error split by component magnitude decile, and the
error of the top-|g| components.  The record at refine=2 (1.1e-5) is the
f32 floor that chip_smoke.py's phase-3 gradient bar is set against.

Usage:
  PYTHONPATH=. JAX_PLATFORMS=cpu \
      python experiments/motor_f32_grad_structure.py [--refine 1]
Writes experiments/motor_f32_grad_structure.json.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def grad_in_subprocess(refine, dtype):
    """(loss, g) for the converged variant (n6, pcg16, re1) in one
    precision — subprocess so each run gets a clean x64/platform state."""
    path = os.path.join(tempfile.gettempdir(),
                        f"motor_gs_{dtype}_r{refine}.npz")
    code = (
        "import os\n"
        "import numpy as np\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from femo_tpu.config import set_precision\n"
        f"set_precision({dtype!r})\n"
        "from femo_tpu.models.motor.model import build_motor_jit_step\n"
        "step, (dv0, iq0), d = build_motor_jit_step(\n"
        f"    refine={refine!r}, em_load_steps=3, mm_newton_iters=6,\n"
        "    em_newton_iters=6, factorization='block_thomas',\n"
        "    pcg_iters=16, design_space='edge_deltas')\n"
        "loss, (g_dv, g_iq) = step(dv0, iq0)\n"
        f"np.savez({path!r}, loss=np.asarray(loss),\n"
        "         g_dv=np.asarray(g_dv), g_iq=np.asarray(g_iq))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=14400)
    return np.load(path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refine", type=float, default=1)
    args = ap.parse_args()
    refine = int(args.refine) if args.refine == int(args.refine) \
        else args.refine

    f64 = grad_in_subprocess(refine, "float64")
    f32 = grad_in_subprocess(refine, "float32")
    g64 = np.concatenate([f64["g_dv"], [float(f64["g_iq"])]])
    g32 = np.concatenate([f32["g_dv"], [float(f32["g_iq"])]]).astype(
        np.float64)
    d = g32 - g64
    n64 = np.linalg.norm(g64)
    cos = float(g32 @ g64 / (np.linalg.norm(g32) * n64))

    # error by |g64| decile: where does the L2 deviation live?
    order = np.argsort(-np.abs(g64))
    k = len(g64)
    deciles = []
    for i in range(10):
        sl = order[i * k // 10:(i + 1) * k // 10]
        deciles.append({
            "decile": i,
            "mean_abs_g": float(np.mean(np.abs(g64[sl]))),
            "err_l2_contrib": float(np.linalg.norm(d[sl]) / n64),
        })
    top16 = order[:16]
    out = {
        "refine": refine,
        "variant": "converged (n6, pcg16, re1), CPU f32 vs CPU f64",
        "loss_rel_err": float(abs(float(f32["loss"]) - float(f64["loss"]))
                              / abs(float(f64["loss"]))),
        "grad_rel_err_l2": float(np.linalg.norm(d) / n64),
        "cosine_similarity": cos,
        "g_iq_rel_err": float(abs(g32[-1] - g64[-1]) / abs(g64[-1])),
        "top16_rel_err": [float(abs(d[j]) / abs(g64[j])) for j in top16],
        "err_by_decile": deciles,
        "n_dv": int(k),
    }
    path = os.path.join(REPO, "experiments",
                        "motor_f32_grad_structure.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
