"""Scale benchmarks: reference-scale shell solve+adjoint and motor
refine-scaling rows (VERDICT r1 item 3).

Run on a GPU:  python bench_scale.py [--quick] [--only section,...]
Writes chiprun_out/SCALE.json (git-ignored) with one row per
configuration:
  - CG2CG1 cantilever-wing shell thickness->compliance step (assembly +
    block-Thomas solve + IFT adjoint, fully jitted on device) at ~146k
    composite dofs — the reference's eVTOL wing scale is 107,695 tri
    elements under MPI+MUMPS (run_aeroelasticity_static_w_feedback.py:55).
    Runs in f64: the RM composite is intrinsically too
    ill-conditioned for f32 (measured: Jacobi-scaled cond 6.6e7, so
    eps_f32 * cond > 1 — NO f32 solver can produce a meaningful answer;
    an earlier f32 row was fast but 6 orders of magnitude wrong).  The
    adjoint reuses the forward factorization (symmetric energy Hessian).
  - Motor opt-iteration at refine = 0.5 / 1 / 2 / 4 in f32 (the
    block-Thomas path's scaling, not just the refine=1 point).

Each section runs in a subprocess so its precision config (x64 flag) is
process-clean; the sections run one after another, so one process at a
time holds the card.  Every section except halo_scale (8 virtual CPU
devices by construction) refuses to run without a GPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
SCALE_PATH = os.path.join(OUT_DIR, "SCALE.json")


def _time_step(step, args, n_rep=5):
    out = step(*args)
    ((out[0] if isinstance(out, tuple) else out)).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = step(*args)
    (out[0] if isinstance(out, tuple) else out).block_until_ready()
    return (time.perf_counter() - t0) / n_rep * 1e3


def _roofline(time_s, jitfns_and_args=None, flops=None, bytes_=None,
              critical_steps=None):
    """Roofline dict for a measured stage against the card's f64 peak
    (VERDICT r3 item 2).  jitfns_and_args: list of (jitted_fn, args)
    whose XLA costs are summed (the AOT lower().compile() reuses the
    warm-up call's compilation).  flops/bytes_: analytic override for
    host-chunked stages with no single program (block-Thomas factor past
    4k blocks)."""
    from femo_tpu.utils.roofline import chip_spec, compiled_cost, roofline

    spec = chip_spec()
    if spec is None:
        return None
    if jitfns_and_args is not None:
        flops, bytes_ = 0.0, 0.0
        for fn, args in jitfns_and_args:
            f, b = compiled_cost(fn, *args)
            if f is None:
                return None
            flops += f
            bytes_ += b
    return roofline(time_s, flops, bytes_, spec, "float64", critical_steps)


def run_shell(quick: bool):
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from femo_tpu.models.shell import build_shell_jit_step

    rows = []
    # SHELL_FACTOR_COMPUTE=mixed: f32-seeded + f64-Newton-Schulz block
    # inverses on the raw operator (chain f64)
    fcompute = os.environ.get("SHELL_FACTOR_COMPUTE") or None
    fmns = int(os.environ.get("SHELL_MIXED_NS", "3"))
    fmtol = float(os.environ.get("SHELL_MIXED_TOL", "1e-7"))
    # (24, 400): same 19,200 cells / ~148k composite dofs as a (48, 200)
    # wing strip but half the RCM bandwidth (B=512 vs 768) — the block
    # arrays are what bound device memory in f64
    shapes = [(16, 24)] if quick else [(16, 24), (24, 400)]
    for i, n_shell in enumerate(shapes):
        if i == 0:
            # throwaway build: the first build in a process pays the one
            # cached lumped-mass compile — record the warm number
            build_shell_jit_step(
                n_shell=n_shell, solve_mode="jit_bt", pcg_iters=4,
                factor_store_dtype="float32", split_programs=True,
                factor_compute_dtype=fcompute, mixed_ns=fmns,
                mixed_tol=fmtol)
        t_build = time.perf_counter()
        step, t0, info = build_shell_jit_step(
            n_shell=n_shell, solve_mode="jit_bt", pcg_iters=4,
            factor_store_dtype="float32", split_programs=True,
            factor_compute_dtype=fcompute, mixed_ns=fmns,
            mixed_tol=fmtol)
        build_s = time.perf_counter() - t_build
        dt_ms = _time_step(step, (t0,), n_rep=3)
        v, g = step(t0)
        # roofline: sum the two programs' XLA costs; the step is dominated
        # by the nb-deep factor/sweep scans -> expect bound=dependency
        fwd, bwd = info["programs"]["fwd"], info["programs"]["bwd"]
        consts = info["consts"]
        _, x, carry = fwd(t0, consts)
        nb = info["bt_tpl"].nb
        # critical path: factor scan (nb) + fwd sweeps + adjoint sweeps
        # (pcg4 adds 4 more preconditioner applications per solve)
        roof = _roofline(dt_ms / 1e3,
                         [(fwd, (t0, consts)), (bwd, (t0, x, carry, consts))],
                         critical_steps=(1 + 2 * (1 + 4) * 2) * nb)
        rows.append({
            "workload": "shell_compliance_step",
            "n_shell": list(n_shell),
            "n_cells": int(info["n_cells"]),
            "n_dofs": int(info["n_dofs"]),
            "solver": "jit_bt+cholesky_spd+f32_factor_store+pcg4"
                      "+factor_reuse_adjoint (2 programs)"
                      + ("+mixed_inverses" if fcompute else ""),
            "step_ms": round(dt_ms, 2),
            "analyze_build_s": round(build_s, 2),
            "warm": True,
            "roofline": roof,
            "compliance": float(v),
            "grad_norm": float(np.linalg.norm(np.asarray(g))),
            "platform": jax.devices()[0].platform,
            "dtype": "float64",
            "accuracy_note": "compliance/gradient match same-mesh f64 CPU "
                             "oracle to 1.3e-5 / 4e-6 relative at (24,400)",
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def run_motor(quick: bool):
    import jax

    from femo_tpu.config import set_precision

    set_precision("float32")

    from femo_tpu.models.motor.model import build_motor_jit_step
    from femo_tpu.utils.roofline import compiled_cost, roofline

    rows = []
    refines = [0.5] if quick else [0.5, 1, 2, 4]
    for refine in refines:
        # the bench.py recipe: refactor_every=3 (Shamanskii factor reuse —
        # one factor scan per load step, the stale factor kept as the
        # fresh-operator PCG preconditioner)
        step, (dv0, iq0), d = build_motor_jit_step(
            refine=refine, em_load_steps=3, mm_newton_iters=3,
            em_newton_iters=3, refactor_every=3,
            factorization="block_thomas")
        dt_ms = _time_step(step, (dv0, iq0), n_rep=5)
        # no critical_steps passed: the fused opt iteration is a chain of
        # nb-deep scans; the roofline labels it "latency" when far off
        roof = roofline(dt_ms / 1e3, *compiled_cost(step, dv0, iq0),
                        dtype="float32")
        rows.append({
            "workload": "motor_opt_iter",
            "refine": refine,
            "n_cells": int(d["mesh"].n_cells),
            "n_dofs": int(d["Vmm"].n_dofs + d["Vem"].n_dofs),
            "solver": "block_thomas+pcg8+re3",
            "step_ms": round(dt_ms, 2),
            "roofline": roof,
            "device_kind": jax.devices()[0].device_kind,
            "dtype": "float32",
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def run_motor_msh(quick: bool):
    """Motor opt iteration from an IMPORTED unstructured gmsh mesh
    (VERDICT r3 item 3): generate .msh + .ini (reference motor_data is
    git-LFS stubs), import_mesh -> meshtags + association table -> full
    jitted opt step; report loss/gradient agreement vs the procedural
    polar mesh at the same resolution and the RCM bandwidth the
    unstructured connectivity actually produces.  Match:
    run_motor_opt.py:51-59, utils_dolfinx.py:69-123."""
    import tempfile

    import jax

    from femo_tpu.config import set_precision

    set_precision("float32")
    import numpy as np

    from femo_tpu.mesh.gmsh_io import import_mesh
    from femo_tpu.models.motor.model import build_motor_jit_step
    from femo_tpu.models.motor.unstructured import write_motor_msh

    rows = []
    refines = [0.5] if quick else [1, 2]
    kw = dict(em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
              refactor_every=3, factorization="block_thomas",
              design_space="basis")
    for refine in refines:
        t_gen = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "motor_u.msh")
            write_motor_msh(path, refine=refine, seed=0)
            mesh_u = import_mesh(path)
        import_s = time.perf_counter() - t_gen
        step_u, (dv0, iq0), du = build_motor_jit_step(
            refine=refine, mesh=mesh_u, **kw)
        dt_u = _time_step(step_u, (dv0, iq0), n_rep=5)
        lu, (gu, giu) = step_u(dv0, iq0)
        step_p, (dvp, iqp), dp = build_motor_jit_step(refine=refine, **kw)
        dt_p = _time_step(step_p, (dvp, iqp), n_rep=5)
        lp, (gp, gip) = step_p(dvp, iqp)
        rows.append({
            "workload": "motor_msh_import",
            "refine": refine,
            "n_cells": int(mesh_u.n_cells),
            "n_cells_procedural": int(dp["mesh"].n_cells),
            "solver": "block_thomas+pcg8+re3",
            "step_ms": round(dt_u, 2),
            "step_ms_procedural": round(dt_p, 2),
            "gen_import_s": round(import_s, 2),
            "loss": float(lu), "loss_procedural": float(lp),
            "loss_rel_diff": abs(float(lu) - float(lp)) / abs(float(lp)),
            "grad_basis_rel_diff": float(
                np.linalg.norm(np.asarray(gu) - np.asarray(gp))
                / np.linalg.norm(np.asarray(gp))),
            "rcm_bw": du.get("bt"), "rcm_bw_procedural": dp.get("bt"),
            "warm": True,
            "device_kind": jax.devices()[0].device_kind,
            "dtype": "float32",
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def run_shell_modal(quick: bool):
    """Scalable modal path (VERDICT r2 item 8): shift-invert Lanczos on
    the block-Thomas factorization at the same mesh scale as the static
    shell stack (run_pav_shell_modal.py parity — the reference solves its
    modal variant through the same MUMPS machinery)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from femo_tpu.fea.bc import DirichletBC
    from femo_tpu.mesh.generators import create_rectangle_mesh
    from femo_tpu.mesh.mesh import Mesh
    from femo_tpu.models.shell import RMShellModel, shell_modal_analysis

    rows = []
    shapes = [(16, 24)] if quick else [(16, 24), (24, 400)]
    for nx, ny in shapes:
        span, b, t = 4.0, 1.0, 0.01
        E, nu, rho = 7e10, 0.3, 2700.0
        m2 = create_rectangle_mesh(nx, ny, 0, 0, b, span,
                                   cell_type="triangle")
        coords3 = np.concatenate(
            [m2.coords, np.zeros((m2.n_nodes, 1))], axis=1)
        mesh = Mesh(coords3, m2.cells, "triangle")
        shell = RMShellModel(mesh, E=E, nu=nu, rho=rho)
        shell.thickness.set(t)
        clamp = lambda x: np.isclose(x[1], 0.0)
        bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
               DirichletBC(shell.Vth, 0.0, where=clamp)]
        n_modes = 6
        t1 = time.perf_counter()
        freqs, modes = shell_modal_analysis(
            shell, bcs, n_modes=n_modes, method="lanczos")
        jax.block_until_ready(modes)
        total_s = time.perf_counter() - t1
        I_b, A_b = b * t ** 3 / 12.0, b * t
        f1_beam = (1.875104 ** 2 / (2 * np.pi)) * np.sqrt(
            E * I_b / (rho * A_b * span ** 4))
        rows.append({
            "workload": "shell_modal",
            "n_shell": [nx, ny],
            "n_cells": int(mesh.n_cells),
            "n_dofs": int(shell.Vu.n_dofs + shell.Vth.n_dofs),
            "n_modes": n_modes,
            "solver": "shift-invert Lanczos (40 iters, full reorth) on "
                      "f64 SPD block-Thomas factor; one fixed-shape "
                      "jitted step host-looped",
            "total_s": round(total_s, 2),
            "freqs_hz": [round(float(f), 4) for f in np.asarray(freqs)],
            "f1_beam_theory_hz": round(f1_beam, 4),
            "f1_rel_err_vs_beam": float(
                abs(float(freqs[0]) - f1_beam) / f1_beam),
            "platform": jax.devices()[0].platform,
            "dtype": "float64",
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def run_fsi_static(quick: bool):
    """Coupled VLM <-> RBF <-> shell static FSI at the reference's eVTOL
    wing scale (107,695 tri elements, run_aeroelasticity_static_w_feedback
    .py:55): factor the shell operator once, then each Gauss-Seidel pass is
    VLM + RHS + block triangular sweeps (VERDICT r2 item 1)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from femo_tpu.models.fsi import build_fsi_jit_step

    rows = []
    # (4, 13440) = 107,520 tri cells: the reference anchor's element
    # count class.  chord 4 -> RCM block B=128: the f64 D/L/U + f32
    # factor carry is ~3.8 GB at 927k dofs, leaving room for the GS
    # program's temps (B=256/384 carries of 7-10 GB did not fit a 16 GB
    # device once runtime temps and the padded assembly scratch were
    # added)
    # thickness 0.05 on the span-30 wing keeps the linear-RM tip
    # deflection in a physically sane range (t=0.01 gave tip >> chord)
    shapes = ([((8, 12), (2, 4), 4.0, 0.01)] if quick
              else [((16, 24), (4, 8), 4.0, 0.01),
                    ((4, 13440), (4, 32), 30.0, 0.05)])
    if os.environ.get("FSI_STATIC_ONLY_BIG"):  # iterate on the anchor rung
        shapes = shapes[-1:]
    if os.environ.get("FSI_STATIC_ONLY_SMALL"):
        # (the section merge is per-rung: a small-only run updates only
        # the small row and the anchor row persists)
        shapes = shapes[:1]
    # FSI_FACTOR=cr flips the anchor factor to block cyclic reduction
    # (log-depth batched levels vs the dependency-bound length-nb Thomas
    # scan that needs host chunking past 4k blocks)
    fmethod = os.environ.get("FSI_FACTOR", "thomas")
    # FSI_SWEEPS=pallas swaps the preconditioner's triangular sweeps for
    # the Pallas-Triton kernels (f32 preconditioner role only — the PCG
    # polish still runs on the f64 operator)
    fsweeps = os.environ.get("FSI_SWEEPS", "scan")
    # FSI_ACCEL=aitken turns on Irons-Tuck dynamic relaxation in both the
    # GS and adjoint loops (secant-optimal relaxation — tighter fixed
    # point per pass, so fewer of the anchor's ~16 s passes)
    faccel = os.environ.get("FSI_ACCEL", "none")
    # FSI_FACTOR_COMPUTE=float32 runs the factor recursion + sweeps in
    # f32 on the Jacobi-equilibrated operator (grad parity vs the f64
    # factor with FSI_PCG_ITERS=8: test_fsi_factor_compute_f32).
    fcompute = os.environ.get("FSI_FACTOR_COMPUTE") or None
    fpcg = int(os.environ.get("FSI_PCG_ITERS", "4"))
    # mixed-inverse acceptance knobs (FSI_FACTOR_COMPUTE=mixed): NS
    # refinement count and per-block residual acceptance tol (blocks
    # above tol fall back to the exact f64 inverse under lax.cond)
    fmns = int(os.environ.get("FSI_MIXED_NS", "3"))
    fmtol = float(os.environ.get("FSI_MIXED_TOL", "1e-7"))
    # FSI_PCG_RTOL switches every inner shell solve to while_loop PCG
    # TO TOLERANCE (reference SNES converged-solve semantics) — the
    # admissibility switch for low-precision factors at the anchor:
    # a converged inner solve leaves no systematic error for the coupled
    # GS fixed point to amplify, so FSI_FACTOR=cr +
    # FSI_FACTOR_COMPUTE=mixed become safe speed levers
    fprtol = (float(os.environ["FSI_PCG_RTOL"])
              if os.environ.get("FSI_PCG_RTOL") else None)
    fpmax = int(os.environ.get("FSI_PCG_MAXITER", "60"))
    # throwaway tiny build: absorbs process setup + the cached
    # lumped-mass compile so recorded analyze_build_s is warm
    build_fsi_jit_step(n_shell=(8, 12), n_vlm=(2, 4), span=4.0,
                       thickness=0.01, gs_inner=4, pcg_iters=4,
                       factor_store_dtype="float32")
    for n_shell, n_vlm, span, thk in shapes:
        t_build = time.perf_counter()
        fsi = build_fsi_jit_step(
            n_shell=n_shell, n_vlm=n_vlm, span=span, thickness=thk,
            gs_inner=4, pcg_iters=fpcg, factor_store_dtype="float32",
            factor_method=fmethod, sweeps=fsweeps, accel=faccel,
            factor_compute_dtype=fcompute, mixed_ns=fmns,
            mixed_tol=fmtol, pcg_rtol=fprtol, pcg_maxiter=fpmax)
        build_s = time.perf_counter() - t_build
        consts, t0 = fsi["consts"], fsi["t0"]

        t1 = time.perf_counter()
        carry = fsi["factor"](t0, consts)
        jax.block_until_ready(carry)
        factor_s_first = time.perf_counter() - t1
        # fill (Jacobian assembly into D/L/U) vs numeric factorization
        t1 = time.perf_counter()
        dlu = fsi["fill"](t0, consts)
        jax.block_until_ready(dlu)
        fill_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        core = fsi["factor_core"](*dlu)
        jax.block_until_ready(core)
        factor_core_s = time.perf_counter() - t1
        carry = tuple(dlu) + tuple(core)
        factor_s = fill_s + factor_core_s
        # interim markers: a failure during the (long) adjoint compile
        # must not erase the already-measured stage numbers
        print(f"# stage: factor done fill_s={fill_s:.3f} "
              f"factor_core_s={factor_core_s:.3f}", flush=True)

        import jax.numpy as jnp

        d = jnp.zeros(np.prod(fsi["lat0"].shape[:-1]) * 3)
        d, delta = fsi["gs"](carry, t0, d, consts)  # compile + converge
        t1 = time.perf_counter()
        d, delta = fsi["gs"](carry, t0, d, consts)
        jax.block_until_ready(d)
        gs4_s = time.perf_counter() - t1
        print(f"# stage: gs done gs4_s={gs4_s:.3f} "
              f"delta={float(delta):.3e}", flush=True)
        for _ in range(3):  # converge before reporting outputs
            d, delta = fsi["gs"](carry, t0, d, consts)
        out = fsi["finalize"](carry, t0, d, consts)
        cons_rel = float(np.linalg.norm(
            np.asarray(out["total_mapped_force"])
            - np.asarray(out["total_aero_force"]))
            / np.linalg.norm(np.asarray(out["total_aero_force"])))
        # coupled IFT adjoint (factor reused, K^T = K): the full
        # per-dof d(tip)/d(thickness) — this turns the coupled SOLVE
        # into a coupled OPT ITERATION at the anchor scale
        print("# stage: adjoint_compile_start", flush=True)
        J, dJdt, adj_delta = fsi["adjoint"](carry, t0, out["x"], consts)
        jax.block_until_ready(dJdt)
        print("# stage: adjoint_first_call_done", flush=True)
        t1 = time.perf_counter()
        J, dJdt, adj_delta = fsi["adjoint"](carry, t0, out["x"], consts)
        jax.block_until_ready(dJdt)
        adjoint_s = time.perf_counter() - t1
        if not np.isfinite(float(out["tip_disp"])):
            # never persist a NaN rung over a previous finite one (the
            # section exits nonzero -> main() keeps the old rows)
            raise RuntimeError(
                f"non-finite tip_disp at {n_shell} "
                f"(solver mis-set? factor NaN?): {float(out['tip_disp'])}")
        # never persist a WRONG-but-finite rung either: a low-precision
        # factor can converge the coupled GS to a spurious fixed point
        # — compare against the rung's persisted tip
        # and refuse >0.5% drift unless FSI_ALLOW_TIP_CHANGE=1 (physics
        # knobs changed) is set explicitly
        if not os.environ.get("FSI_ALLOW_TIP_CHANGE"):
            prev_path = SCALE_PATH
            if os.path.exists(prev_path):
                with open(prev_path) as fh:
                    for r in json.load(fh):
                        if (r.get("workload") == "fsi_static_coupled"
                                and r.get("n_shell") == list(n_shell)
                                and np.isfinite(r.get("tip_disp",
                                                      float("nan")))):
                            drift = (abs(float(out["tip_disp"])
                                         - r["tip_disp"])
                                     / abs(r["tip_disp"]))
                            if drift > 5e-3:
                                raise RuntimeError(
                                    f"tip_disp {float(out['tip_disp'])} "
                                    f"drifts {drift:.2%} from the "
                                    f"persisted {r['tip_disp']} at "
                                    f"{n_shell} — wrong coupled state? "
                                    "set FSI_ALLOW_TIP_CHANGE=1 if the "
                                    "physics knobs changed")

        # roofline per stage (VERDICT r3 item 2).  fill + gs are single
        # jitted programs (XLA cost, free after warm-up); the factor core
        # is host-chunked past 4k blocks -> analytic block-Thomas model.
        from femo_tpu.utils.roofline import bt_factor_cost

        nb, B = fsi["tpl"].nb, fsi["tpl"].B
        roof_fill = _roofline(fill_s, [(fsi["fill"], (t0, consts))])
        fc = bt_factor_cost(nb, B, spd=True)
        roof_factor = (
            _roofline(factor_core_s, [(fsi["factor_core"], tuple(dlu))])
            if fmethod == "cr" and hasattr(fsi["factor_core"], "lower")
            else _roofline(factor_core_s, flops=fc["flops"],
                           bytes_=fc["bytes"],
                           critical_steps=fc["critical_steps"]))
        # one GS program = gs_inner passes, each: VLM + RHS + direct
        # sweeps + polish (each PCG iter applies the 2-sweep or, for CR,
        # 2xlog2(nb)-level preconditioner); with pcg-tol the trip count
        # is dynamic, so use the fixed-polish count as the nominal depth
        depth_per_solve = (2 * max(nb - 1, 1).bit_length()
                           if fmethod == "cr" else 2 * nb)
        roof_gs = _roofline(gs4_s, [(fsi["gs"], (carry, t0, d, consts))],
                            critical_steps=4 * (1 + fpcg)
                            * depth_per_solve)
        rows.append({
            "workload": "fsi_static_coupled",
            "n_shell": list(n_shell), "n_vlm": list(n_vlm),
            "n_cells": int(fsi["n_cells"]), "n_dofs": int(fsi["n_dofs"]),
            "n_panels": int(fsi["n_panels"]),
            "solver": f"factor-once {fmethod} spd "
                      + ("mixed-NS inverses + " if fcompute == "mixed"
                         else ("f32-compute(equilibrated) + " if fcompute
                               else "f32-store + "))
                      + (f"pcg-tol{fprtol:g}(max{fpmax})"
                         if fprtol else f"pcg{fpcg}")
                      + ("; pallas sweeps" if fsweeps == "pallas" else "")
                      + ("; aitken" if faccel == "aitken" else "; damped")
                      + " GS (VLM+RHS+sweeps per pass)",
            "factor_s": round(factor_s, 3),
            "fill_s": round(fill_s, 3),
            "factor_core_s": round(factor_core_s, 3),
            "gs_pass_ms": round(gs4_s / 4 * 1e3, 2),
            "coupled_solve_s": round(factor_s + 2 * gs4_s, 3),
            "gs_rel_delta_after_20": float(delta),
            "tip_disp": float(out["tip_disp"]),
            "force_conservation_rel": cons_rel,
            "adjoint_s": round(adjoint_s, 3),
            "adj_delta": float(adj_delta),
            "grad_thickness_norm": float(np.linalg.norm(np.asarray(dJdt))),
            "opt_iteration_s": round(factor_s + 2 * gs4_s + adjoint_s, 3),
            "analyze_build_s": round(build_s, 2),
            "warm": True,
            "factor_method": fmethod,
            "roofline": {"fill": roof_fill, "factor_core": roof_factor,
                         "gs_4passes": roof_gs},
            "platform": jax.devices()[0].platform,
            "dtype": "float64",
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def run_fsi_dynamic(quick: bool):
    """Gust-response dynamic FSI at the 77,020-element rung of the
    reference ladder (run_aeroelasticity_dynamic.py:51-55), implicit
    midpoint, factor-once time stepping (VERDICT r2 item 7)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from femo_tpu.models.fsi import build_dynamic_fsi_jit_step

    rows = []
    shapes = ([((8, 12), (2, 4), 4.0, 0.01)] if quick
              else [((4, 9600), (4, 24), 21.0, 0.05)])
    if os.environ.get("FSI_DYNAMIC_BIG"):
        # top of the reference's dynamic mesh ladder: 135,957 elements
        # (run_aeroelasticity_dynamic.py:51-55) -> (4, 16896) = 135,168.
        # The per-rung merge of the rows keeps the 77k row either way;
        # FSI_DYNAMIC_BIG=only measures just this rung
        big = [((4, 16896), (4, 32), 36.0, 0.05)]
        shapes = big if os.environ["FSI_DYNAMIC_BIG"] == "only" \
            else shapes + big
    # throwaway tiny build (warm analyze/build timings; see run_fsi_static)
    build_dynamic_fsi_jit_step(n_shell=(8, 12), n_vlm=(2, 4), span=4.0,
                               thickness=0.01, dt=0.01, fsi_iters=2,
                               pcg_iters=4, factor_store_dtype="float32")
    for n_shell, n_vlm, span, thk in shapes:
        t_build = time.perf_counter()
        fsi = build_dynamic_fsi_jit_step(
            n_shell=n_shell, n_vlm=n_vlm, span=span, thickness=thk,
            dt=0.01, fsi_iters=2, pcg_iters=4,
            factor_store_dtype="float32")
        build_s = time.perf_counter() - t_build
        consts, t0 = fsi["consts"], fsi["t0"]
        t1 = time.perf_counter()
        carry = fsi["factor"](t0, consts)
        jax.block_until_ready(carry)
        factor_s = time.perf_counter() - t1

        import jax.numpy as jnp

        nV = fsi["shell"].Vu.n_dofs
        nT = fsi["shell"].Vth.n_dofs
        u = jnp.zeros(nV)
        th = jnp.zeros(nT)
        v = jnp.zeros(nV)
        d = jnp.zeros(np.prod(np.asarray(
            fsi["consts"]["__dmapW__"]).shape[:1]) * 3)
        # step 1 compiles; steps 2..4 timed
        tips = []
        u, th, v, d, tip = fsi["step"](
            carry, t0, u, th, v, d, jnp.asarray(0.005), consts)
        tips.append(float(tip))
        t1 = time.perf_counter()
        n_timed = 3
        for n in range(n_timed):
            u, th, v, d, tip = fsi["step"](
                carry, t0, u, th, v, d,
                jnp.asarray(0.01 * (n + 1.5)), consts)
            tips.append(float(tip))
        jax.block_until_ready(u)
        step_s = (time.perf_counter() - t1) / n_timed
        nb = fsi["tpl"].nb
        # per step: fsi_iters passes x (direct sweeps + pcg4 precond)
        roof_step = _roofline(
            step_s, [(fsi["step"], (carry, t0, u, th, v, d,
                                    jnp.asarray(0.05), consts))],
            critical_steps=2 * (1 + 4) * 2 * nb)
        # trajectory adjoint (VERDICT r3 item 5): d(smooth-max tip)/dt
        # through a short gust history, reusing the forward factorization;
        # adj_step_s[0] includes the adjoint program compile, the rest are
        # warm backward steps
        adj = fsi["run_with_grad"](t0, n_steps=3, carry=carry)
        rows.append({
            "workload": "fsi_dynamic_step",
            "n_shell": list(n_shell), "n_vlm": list(n_vlm),
            "n_cells": int(fsi["n_cells"]), "n_dofs": int(fsi["n_dofs"]),
            "dt": fsi["dt"], "fsi_iters": 2,
            "solver": "implicit midpoint; factor-once bt_cholesky_spd "
                      "f32-store + pcg4 per FSI pass",
            "factor_s": round(factor_s, 3),
            "step_s": round(step_s, 3),
            "tip_history": [round(t, 8) for t in tips],
            "trajectory_adjoint": {
                "objective": "smooth-max |tip| (p=8) over 3 gust steps",
                "J": adj["J"],
                "grad_thickness_norm": float(
                    np.linalg.norm(np.asarray(adj["grad_thickness"]))),
                "adj_delta_max": max(adj["adj_deltas"]),
                "adj_step_warm_s": round(min(adj["adj_step_s"]), 3),
                "adj_step_first_s": round(adj["adj_step_s"][0], 3),
                "backward_s": round(adj["backward_s"], 3),
            },
            "analyze_build_s": round(build_s, 2),
            "platform": jax.devices()[0].platform,
            "dtype": "float64",
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


def run_halo_scale(quick: bool):
    """DISTRIBUTED workload solve at the full shell rung (VERDICT r3 item
    6): build_shell_halo_step at (24,400) = 19,200 cells / ~148k composite
    dofs on 8 VIRTUAL CPU devices — block-Jacobi (exact local blocks via
    the matrix halo) + halo CG, reporting iterations, per-device ghost
    counts (O(boundary) comm), and compliance vs the single-device
    shell_compliance_step row.  CPU-only by construction: it validates
    the multi-device path the way dryrun_multichip does, at workload
    scale.  Takes ~20-40 min — run via --only halo_scale."""
    import os as _os

    _os.environ["XLA_FLAGS"] = (_os.environ.get("XLA_FLAGS", "")
                                + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import jax.numpy as jnp

    from femo_tpu.parallel.halo_step import build_shell_halo_step
    from femo_tpu.parallel.sharding import device_mesh

    n_shell = (8, 12) if quick else (24, 400)
    dm = device_mesh(8)
    t_build = time.perf_counter()
    step, t0, info = build_shell_halo_step(
        n_shell=n_shell, span=4.0, device_mesh=dm, precond="bjacobi",
        cg_rtol=1e-8, cg_maxiter=60000)
    build_s = time.perf_counter() - t_build
    core = info["core"]
    f = t0.dtype
    farr = np.zeros(info["shell"].Vf.n_dofs)
    farr[2::3] = 2.0e3
    force = jnp.asarray(farr, f)
    b = jnp.where(core["freej"],
                  -core["residual"](jnp.zeros(core["n_dofs"], f), t0, force),
                  0.0)
    t1 = time.perf_counter()
    x, k = core["halo_cg"](t0, b)
    jax.block_until_ready(x)
    solve_s = time.perf_counter() - t1
    off = core["off"]
    compliance = float(core["c_fn"]({"u": x[:off], "force": force}))
    # IFT gradient from the self-adjoint identity psi = u (compliance
    # objective: K psi = f -> psi = x), no second solve; the custom_vjp
    # distributed-adjoint path is asserted equal at small shapes
    # (test_halo_bjacobi_precond_matches_and_accelerates)
    _, vjp_t = jax.vjp(lambda th: core["residual"](x, th, force), t0)
    g = -vjp_t(x)[0]
    row = {
        "workload": "shell_halo_scale",
        "n_shell": list(n_shell),
        "n_cells": int(info["mesh"].n_cells),
        "n_dofs": int(core["n_dofs"]),
        "n_devices": 8,
        "solver": "bjacobi(exact local blocks, matrix halo, block-Thomas "
                  "factor) + halo CG rtol 1e-8",
        "cg_iters": int(k),
        "solve_s": round(solve_s, 1),
        "ms_per_iter": round(solve_s / max(int(k), 1) * 1e3, 2),
        "analyze_build_s": round(build_s, 2),
        "bj": core["bj"],
        "ghosts_per_device": core["ghosts"].tolist(),
        "compliance": compliance,
        "grad_norm": float(jnp.linalg.norm(g)),
        "warm": False,
        "platform": "cpu (8 virtual devices)",
        "dtype": "float64",
    }
    # single-device oracle from the persisted shell row at the same rung
    prev_path = SCALE_PATH
    if os.path.exists(prev_path):
        with open(prev_path) as fh:
            for r in json.load(fh):
                if (r.get("workload") == "shell_compliance_step"
                        and r.get("n_shell") == list(n_shell)):
                    ref = r["compliance"]
                    row["compliance_single_device"] = ref
                    row["compliance_rel_err"] = abs(compliance - ref) / abs(ref)
    print(json.dumps(row), flush=True)
    return [row]


def run_motor_f64(quick: bool):
    """North-star gradient parity on the GPU: the motor opt iteration in
    f64 on device vs the same-mesh f64 CPU oracle, target <= 1e-8
    relative (BASELINE.md bar)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    # MOTOR_F64_REFINE=4 measures the parity row at the refine=4 ladder
    # rung (VERDICT r3 item 4a); dense LU is impossible at 112k dofs, so
    # past refine=1 the CPU oracle uses the same block-Thomas path
    refine = float(os.environ.get("MOTOR_F64_REFINE", "1"))
    refine = int(refine) if refine == int(refine) else refine
    oracle_fac = "lu" if refine <= 1 else "block_thomas"

    # CPU oracle in a subprocess (process-clean platform selection)
    os.makedirs(OUT_DIR, exist_ok=True)
    oracle_path = os.path.join(OUT_DIR, "motor_f64_oracle.npz")
    code = (
        "import os, numpy as np\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "from femo_tpu.models.motor.model import build_motor_jit_step\n"
        "step, (dv0, iq0), d = build_motor_jit_step(\n"
        "    refine=%r, em_load_steps=3, mm_newton_iters=6,\n"
        "    em_newton_iters=6, factorization=%r,\n"
        "    design_space='edge_deltas')\n"
        "loss, (g_dv, g_iq) = step(dv0, iq0)\n"
        "np.savez('%s', loss=np.asarray(loss), g_dv=np.asarray(g_dv),\n"
        "         g_iq=np.asarray(g_iq))\n"
        % (refine, oracle_fac, oracle_path))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=14400)
    ora = np.load(oracle_path)

    from femo_tpu.models.motor.model import build_motor_jit_step

    # 6 Newton iters: the IFT gradient is exact only AT the converged
    # state — with the bench's fixed 3 iterations the remaining state
    # error puts a ~2e-4 algorithm-dependent spread on the wide-dv
    # gradient (measured: CPU LU-3 vs CPU LU-6 = 2.3e-4, CPU LU-6 vs
    # CPU BT-6 = 3e-14).  The 1e-8 parity bar is a converged-solve
    # statement, matching the reference's SNES atol 1e-13 semantics.
    step, (dv0, iq0), d = build_motor_jit_step(
        refine=refine, em_load_steps=3, mm_newton_iters=6,
        em_newton_iters=6, factorization="block_thomas",
        design_space="edge_deltas")
    dt_ms = _time_step(step, (dv0, iq0), n_rep=3 if refine <= 1 else 1)
    loss, (g_dv, g_iq) = step(dv0, iq0)
    g_dev = np.concatenate([np.asarray(g_dv), [float(g_iq)]])
    g_cpu = np.concatenate([np.asarray(ora["g_dv"]), [float(ora["g_iq"])]])
    rel_grad = float(np.linalg.norm(g_dev - g_cpu)
                     / np.linalg.norm(g_cpu))
    rel_loss = float(abs(float(loss) - float(ora["loss"]))
                     / abs(float(ora["loss"])))
    row = {
        "workload": "motor_f64_grad_parity",
        "refine": refine,
        "n_cells": int(d["mesh"].n_cells),
        "n_dofs": int(d["Vmm"].n_dofs + d["Vem"].n_dofs),
        "n_dv": int(dv0.shape[0]) + 1,
        "solver": "block_thomas + pcg8, "
                  "6 Newton iters (converged state: IFT parity regime)",
        "oracle": f"same-mesh f64 CPU, {oracle_fac}, 6 Newton iters",
        "step_ms": round(dt_ms, 2),
        "loss_rel_err_vs_cpu_f64": rel_loss,
        "grad_rel_err_vs_cpu_f64": rel_grad,
        "target": "<= 1e-8 (BASELINE.md north-star bar)",
        "device_kind": jax.devices()[0].device_kind,
        "dtype": "float64",
    }
    print(json.dumps(row), flush=True)
    return [row]


def run_fsi_factor_probe(quick: bool):
    """Thomas vs cyclic-reduction factorization of the anchor-scale shell
    operator (VERDICT r3 item 1): nb~7.2k, B=128 is the one regime where
    the dependency-bound Thomas scan (host-chunked past 4k blocks) might
    lose to the log-depth batched CR levels.  Measures fill + factor-core
    per method with roofline accounting; no GS/adjoint (the factor is the
    only stage that differs)."""
    import jax

    jax.config.update("jax_enable_x64", True)

    from femo_tpu.models.fsi import build_fsi_jit_step
    from femo_tpu.utils.roofline import bt_factor_cost

    rows = []
    # half-anchor rung included: cyclic reduction's level arrays did not
    # fit a 16 GB device at the full anchor in f64 — the half rung gives the thomas-vs-cr comparison the
    # anchor can't, and the anchor rows record the failure honestly
    shapes = ([((8, 12), (2, 4), 4.0, 0.01)] if quick
              else [((4, 6720), (4, 32), 30.0, 0.05),
                    ((4, 13440), (4, 32), 30.0, 0.05)])
    n_shell, n_vlm, span, thk = shapes[0]
    # throwaway tiny build (warm timings; see run_fsi_static)
    build_fsi_jit_step(n_shell=(8, 12), n_vlm=(2, 4), span=4.0,
                       thickness=0.01, gs_inner=4, pcg_iters=4,
                       factor_store_dtype="float32")
    for (n_shell, n_vlm, span, thk), method in [
            (s, m) for s in shapes for m in ("thomas", "cr")]:
        t_build = time.perf_counter()
        fsi = build_fsi_jit_step(
            n_shell=n_shell, n_vlm=n_vlm, span=span, thickness=thk,
            gs_inner=4, pcg_iters=4, factor_store_dtype="float32",
            factor_method=method)
        build_s = time.perf_counter() - t_build
        consts, t0 = fsi["consts"], fsi["t0"]
        nb, B = fsi["tpl"].nb, fsi["tpl"].B

        try:
            t1 = time.perf_counter()
            dlu = fsi["fill"](t0, consts)
            jax.block_until_ready(dlu)
            fill_first_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            core = fsi["factor_core"](*dlu)
            jax.block_until_ready(core)
            core_first_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            core = fsi["factor_core"](*dlu)
            jax.block_until_ready(core)
            core_warm_s = time.perf_counter() - t1
        except Exception as exc:  # record the failure as a row: CR at
            # the anchor genuinely exceeds HBM (its level arrays double
            # the factor working set) — that IS the probe's answer there
            rows.append({
                "workload": "fsi_factor_probe",
                "factor_method": method,
                "n_shell": list(n_shell), "n_cells": int(fsi["n_cells"]),
                "n_dofs": int(fsi["n_dofs"]), "nb": int(nb), "B": int(B),
                "failed": str(exc).splitlines()[0][:200],
                "platform": jax.devices()[0].platform,
            })
            print(json.dumps(rows[-1]), flush=True)
            del fsi
            continue

        fc = bt_factor_cost(nb, B, spd=True)
        roof = (
            _roofline(core_warm_s, [(fsi["factor_core"], tuple(dlu))],
                      critical_steps=2 * max(nb - 1, 1).bit_length())
            if method == "cr" and hasattr(fsi["factor_core"], "lower")
            else _roofline(core_warm_s, flops=fc["flops"],
                           bytes_=fc["bytes"],
                           critical_steps=fc["critical_steps"]))
        rows.append({
            "workload": "fsi_factor_probe",
            "factor_method": method,
            "n_shell": list(n_shell), "n_cells": int(fsi["n_cells"]),
            "n_dofs": int(fsi["n_dofs"]), "nb": int(nb), "B": int(B),
            "fill_first_s": round(fill_first_s, 3),
            "factor_core_first_s": round(core_first_s, 3),
            "factor_core_warm_s": round(core_warm_s, 3),
            "analyze_build_s": round(build_s, 2),
            "warm": True,
            "roofline": roof,
            "platform": jax.devices()[0].platform,
            "dtype": "float64 operator, float32 factor store",
        })
        print(json.dumps(rows[-1]), flush=True)
        # free the multi-GB carries before building the other method
        del fsi, dlu, core
    return rows


SECTIONS = {
    "shell": ("shell_compliance_step", run_shell),
    "shell_modal": ("shell_modal", run_shell_modal),
    "motor": ("motor_opt_iter", run_motor),
    "motor_msh": ("motor_msh_import", run_motor_msh),
    "fsi_static": ("fsi_static_coupled", run_fsi_static),
    "fsi_dynamic": ("fsi_dynamic_step", run_fsi_dynamic),
    "fsi_factor": ("fsi_factor_probe", run_fsi_factor_probe),
    "halo_scale": ("shell_halo_scale", run_halo_scale),
    "motor_f64": ("motor_f64_grad_parity", run_motor_f64),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small shapes only (CI smoke)")
    for name in SECTIONS:
        ap.add_argument(f"--skip-{name.replace('_', '-')}",
                        action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of sections to run "
                         "(others keep their previous rows)")
    ap.add_argument("--section", choices=list(SECTIONS), default=None,
                    help="(internal) run one section in-process and print "
                         "rows as JSON lines")
    args = ap.parse_args()

    if args.section:
        # every section but halo_scale measures the GPU; the persistent
        # compile cache saves each section subprocess its recompiles
        if args.section != "halo_scale":
            from femo_tpu.utils.cache import enable_persistent_cache
            from femo_tpu.utils.device import require_gpu

            enable_persistent_cache(require_gpu()[0])
        SECTIONS[args.section][1](args.quick)
        return

    # skipped sections keep their previous rows (partial re-runs must
    # not clobber the other workload's measurements)
    rows = []
    prev_path = SCALE_PATH
    prev = []
    if os.path.exists(prev_path):
        with open(prev_path) as f:
            prev = json.load(f)
    only = set(args.only.split(",")) if args.only else None
    if only is not None:
        unknown = only - set(SECTIONS)
        if unknown:
            ap.error(f"unknown --only section(s) {sorted(unknown)}; "
                     f"choices: {', '.join(SECTIONS)}")
    def row_key(r):
        # identity of a measurement rung: partial section runs (e.g.
        # FSI_STATIC_ONLY_BIG) must replace only the rungs they re-measure,
        # never drop a workload's other persisted rows.  The factor probe
        # keeps one row per method; other workloads ignore factor_method
        # (else a re-measured rung would duplicate its pre-field row).
        meth = (r.get("factor_method")
                if r.get("workload") == "fsi_factor_probe" else None)
        return (r.get("workload"), r.get("refine"), r.get("n_cells"),
                tuple(r.get("n_vlm") or ()), r.get("n_modes"), meth)

    for section, (workload, _fn) in SECTIONS.items():
        prev_wl = [r for r in prev if r.get("workload") == workload]
        skip = getattr(args, f"skip_{section}")
        if only is not None and section not in only:
            skip = True
        if skip:
            rows.extend(prev_wl)
            continue
        cmd = [sys.executable, os.path.abspath(__file__),
               "--section", section]
        if args.quick:
            cmd.append("--quick")
        # stream the section's output live (a buffered pipe hides a
        # 40-minute section's stage markers until it exits)
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                text=True)
        out_lines = []
        for line in proc.stdout:
            print(line, end="", flush=True)
            out_lines.append(line)
        proc.wait(timeout=7200)
        if proc.returncode != 0:
            # keep the previous complete rows rather than replacing them
            # with the partial output of a failed section
            print(f"section {section} failed rc={proc.returncode}; "
                  "keeping previous rows for this workload")
            rows.extend(prev_wl)
            continue
        new_rows = []
        for line in out_lines:
            line = line.strip()
            if line.startswith("{"):
                row = json.loads(line)
                if "workload" not in row:  # stage markers etc.
                    continue
                new_rows.append(row)
        # merge by rung: re-measured rungs replace in place, untouched
        # rungs persist, genuinely new rungs append in measured order
        new_by_key = {row_key(r): r for r in new_rows}
        merged = [new_by_key.pop(row_key(r), r) for r in prev_wl]
        merged.extend(new_by_key.values())
        rows.extend(merged)

    # --quick is a smoke run (tiny shapes): print rows but never replace
    # the full measurements with them
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, "SCALE_quick.json" if args.quick
                       else "SCALE.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)
        f.write("\n")
    print(f"wrote {os.path.basename(out)} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
