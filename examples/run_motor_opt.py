"""EM motor shape/current optimization (W5 north-star parity,
/root/reference/examples/em_motor_opt/run_motor_opt.py).

python examples/run_motor_opt.py --refine 0.5 --maxiter 10 \
    [--driver snopt] [--dash dash_motor]
"""

import argparse

import numpy as np

from femo_tpu.graph.optimizer import OptimizationProblem, SLSQP, SNOPT
from femo_tpu.graph.simulator import Simulator
from femo_tpu.models.motor import build_motor_model


def run_jit(args):
    """Full optimization over the fully-jitted device step: every
    (loss, grad) evaluation is ONE device program (continuation +
    Newton + IFT adjoint through both states), scipy only orchestrates
    — the device loop the bench measures per-iteration (f64, block
    Thomas)."""
    import time

    import jax
    from scipy.optimize import minimize

    from femo_tpu.models.motor.model import build_motor_jit_step

    mesh = _imported_mesh(args) if args.msh is not None else None
    step, (dv0, iq0), d = build_motor_jit_step(
        refine=args.refine, em_load_steps=3, mm_newton_iters=3,
        em_newton_iters=3, mesh=mesh,
        factorization="block_thomas")
    if d.get("bt"):
        print("RCM bandwidth (mm/em):", d["bt"])

    import jax.numpy as jnp

    history = []

    def fun(x):
        t0 = time.perf_counter()
        v, (gdv, giq) = step(jnp.asarray(x[:2]), jnp.asarray(x[2]))
        g = np.concatenate([np.asarray(gdv, float), [float(giq)]])
        history.append((float(v), time.perf_counter() - t0))
        return float(v), g

    x0 = np.concatenate([np.asarray(dv0, float), [float(iq0)]])
    scale = np.array([1e3, 1e3, 1e-5])  # O(1) scaling for scipy
    # valid (non-crushing) shape range and current window, as in the
    # eager example's design-variable bounds
    bounds = list(zip(np.array([-1e-3, -1e-3, 0.5e5]) * scale,
                      np.array([1e-3, 1e-3, 2.0e5]) * scale))

    def fun_s(y):
        v, g = fun(y / scale)
        return v, g / scale

    r = minimize(fun_s, x0 * scale, jac=True, method="L-BFGS-B",
                 bounds=bounds, options=dict(maxiter=args.maxiter))
    print("=" * 40)
    print(f"jit-mode optimization ({jax.devices()[0].platform} f64, "
          f"refine={args.refine}): {len(history)} evaluations")
    print(f"loss: {history[0][0]:.6e} -> {r.fun:.6e}")
    print(f"mean step wall-clock: "
          f"{np.mean([t for _, t in history[1:]]) * 1e3:.1f} ms")
    print("x* (dv0, dv1, iq):", r.x / scale)


def _imported_mesh(args):
    """Import-first path (reference run_motor_opt.py:51-59): load the
    mesh + .ini association table; --msh gen generates the unstructured
    .msh first (reference motor_data is git-LFS stubs)."""
    from femo_tpu.mesh.gmsh_io import import_mesh, read_association_table

    path = args.msh
    if path == "gen":
        import tempfile

        from femo_tpu.models.motor.unstructured import write_motor_msh

        path = tempfile.mktemp(suffix=".msh")
        write_motor_msh(path, refine=args.refine, seed=0)
    mesh = import_mesh(path)
    import os

    ini = os.path.splitext(path)[0] + ".ini"
    if os.path.exists(ini):
        table = read_association_table(ini)
        print(f"imported {mesh} with {len(table)}-entry association table")
    return mesh


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--refine", type=float, default=0.5)
    p.add_argument("--maxiter", type=int, default=10)
    p.add_argument("--msh", default=None,
                   help="run from an imported gmsh .msh instead of the "
                        "procedural mesh ('gen' generates the "
                        "unstructured motor mesh first); jit mode only")
    p.add_argument("--driver", choices=["slsqp", "snopt"], default="slsqp")
    p.add_argument("--dash", default=None,
                   help="directory for per-iteration dashboard PNG frames "
                        "(lsdo_dash parity, reference dash_pav.py)")
    p.add_argument("--jit", action="store_true",
                   help="drive the fully-jitted device opt step "
                        "(build_motor_jit_step) instead of the eager "
                        "graph — the device production loop")
    args = p.parse_args()

    if args.jit:
        run_jit(args)
        return

    model, d = build_motor_model(refine=args.refine, em_load_steps=3)
    # keep within the valid (non-crushing) shape range
    model.design_variables["shape_dv"].update(lower=-1e-3, upper=1e-3)
    model.add_constraint("magnet_area", lower=7e-4, scaler=1e3)
    sim = Simulator(model)
    sim["shape_dv"] = np.array([2e-4, 0.0])
    out = sim.run()
    print("initial loss_sum:", float(out["loss_sum"]))

    prob = OptimizationProblem(sim, "motor_opt")
    dash = None
    if args.dash:
        from femo_tpu.graph.dashboard import Dashboard

        dash = Dashboard(prob, outdir=args.dash)
    if args.driver == "snopt":
        # SNOPT binding hook (reference run_motor_opt.py:373-388); falls
        # back to SLSQP when no binding is installed
        r = SNOPT(prob, Major_iterations=args.maxiter,
                  Major_optimality=1e-8).solve()
    else:
        r = SLSQP(prob, ftol=1e-8, maxiter=args.maxiter).solve()
    if dash is not None:
        print("dashboard:", dash.finalize())
    print("=" * 40)
    print("final loss_sum:", float(sim.outputs["loss_sum"]),
          "| iters:", r.nit)
    print("shape_dv:", np.asarray(sim.values["shape_dv"]),
          "iq:", float(sim.values["iq"]))
    print("areas: magnet", float(sim.outputs["magnet_area"]),
          "winding", float(sim.outputs["winding_area"]))


if __name__ == "__main__":
    main()
