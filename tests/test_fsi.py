"""W7/W8 parity: VLM aerodynamics, RBF coupling maps, fixed-point FSI, and
implicit-midpoint dynamics."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from femo_tpu.models.vlm import VLM, flat_wing_lattice
from femo_tpu.models.coupling import NodalMap, force_map_mass_weighted
from femo_tpu.graph.fixed_point import fixed_point_solve


def test_vlm_lifting_line():
    """Rectangular AR=10 wing at 5 deg vs lifting-line estimate."""
    span, chord, alpha = 10.0, 1.0, 5.0
    vlm = VLM(4, 16)
    nodes = flat_wing_lattice(span, chord, 4, 16, alpha_deg=alpha)
    CL, CDi, out = vlm.coefficients(nodes, jnp.array([1.0, 0.0, 0.0]))
    a = np.deg2rad(alpha)
    CL_llt = 2 * np.pi * a / (1 + 2 / (span / chord))
    assert abs(float(CL) - CL_llt) / CL_llt < 0.08
    # induced drag close to elliptic estimate CL^2/(pi AR)
    cdi_est = float(CL) ** 2 / (np.pi * span / chord)
    assert 0.5 * cdi_est < float(CDi) < 1.5 * cdi_est
    np.testing.assert_allclose(float(out["total"][1]), 0.0, atol=1e-10)


def test_vlm_differentiable_in_geometry():
    vlm = VLM(2, 6)
    nodes = flat_wing_lattice(6.0, 1.0, 2, 6, alpha_deg=3.0)

    # twist perturbation (chordwise-weighted z) — translation-invariant
    # rigid shifts have zero sensitivity, twist does not
    wx = nodes[..., 0] / jnp.max(nodes[..., 0])

    def lift(tw):
        n2 = nodes.at[..., 2].add(-tw * wx)
        out = vlm.solve(n2, jnp.array([1.0, 0.0, 0.0]))
        return out["total"][2]

    g = jax.grad(lift)(0.0)
    h = 1e-6
    fd = (lift(h) - lift(-h)) / (2 * h)
    assert abs(float(g)) > 1e-3
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-6)


def test_nodal_map_properties():
    rng = np.random.default_rng(0)
    xs = rng.uniform(size=(30, 3))
    xf = rng.uniform(size=(50, 3))
    nm = NodalMap(xs, xf, kind="gaussian")
    # partition of unity: constant displacement maps to constant
    ones = jnp.ones((30, 3))
    np.testing.assert_allclose(
        np.asarray(nm.map_displacements(ones)), 1.0, atol=1e-12)
    # conservative force map preserves total force
    f = jnp.asarray(rng.normal(size=(50, 3)))
    fs = nm.map_forces_conservative(f)
    np.testing.assert_allclose(
        np.asarray(fs.sum(axis=0)), np.asarray(f.sum(axis=0)), atol=1e-10)



def test_nodal_map_dense_source_coarse_target():
    """RBF width must track the coarser of source spacing and target
    offset: with a source cloud 1000x denser than the target offsets the
    kernel must not underflow into a zero map (the 107k-cell wing rung
    silently converged to zero traction this way)."""
    ys = np.linspace(0.0, 30.0, 13441)
    xs = np.stack([np.zeros_like(ys), ys, np.zeros_like(ys)], axis=1)
    # targets offset 0.0625 in x -- ~28 source spacings away
    yf = np.linspace(0.2, 29.8, 32)
    xf = np.stack([np.full_like(yf, 0.0625), yf, np.zeros_like(yf)], axis=1)
    nm = NodalMap(xs, xf, kind="gaussian")
    W = np.asarray(nm.W)
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-9)
    f = jnp.asarray(np.ones((32, 3)))
    fs = nm.map_forces_conservative(f)
    np.testing.assert_allclose(
        np.asarray(fs.sum(axis=0)), np.full(3, 32.0), rtol=1e-9)

def test_fixed_point_adjoint_linear_exact():
    """x = A x + b with known solution; adjoint vs analytic d(c.x)/db."""
    rng = np.random.default_rng(1)
    A = jnp.asarray(0.3 * rng.normal(size=(6, 6)) / np.sqrt(6))
    b0 = jnp.asarray(rng.normal(size=6))
    c = jnp.asarray(rng.normal(size=6))

    def obj(b):
        x = fixed_point_solve(
            lambda x, p: A @ x + p["b"], jnp.zeros(6), {"b": b},
            tol=1e-14, maxiter=500)
        return jnp.dot(c, x)

    g = jax.grad(obj)(b0)
    # analytic: x = (I-A)^{-1} b; dJ/db = (I-A)^{-T} c
    g_exact = np.linalg.solve(np.eye(6) - np.asarray(A).T, np.asarray(c))
    np.testing.assert_allclose(np.asarray(g), g_exact, rtol=1e-8)


@pytest.fixture(scope="module")
def wing_fsi():
    from femo_tpu.models.fsi import build_wing_fsi

    fsi = build_wing_fsi(n_shell=(4, 6), n_vlm=(2, 4))
    out = fsi["solve"](fsi["shell"].thickness.array, maxiter=40, relax=0.7)
    return fsi, out


def test_static_fsi_converges_and_conserves(wing_fsi):
    """Coupled solve: deflection under lift; total-force conservation
    through the RBF map (reference conservation check,
    run_pav_shell.py:433-438)."""
    fsi, out = wing_fsi
    tip = float(out["tip_disp"])
    assert 1e-3 < tip < 1.0, tip  # lifts up, finite
    np.testing.assert_allclose(
        np.asarray(out["total_mapped_force"]),
        np.asarray(out["total_aero_force"]), rtol=1e-10)


def test_dynamic_fsi_midpoint(wing_fsi):
    """Implicit-midpoint gust response: smooth growth from rest (W8)."""
    from femo_tpu.models.fsi import DynamicShellFSI

    fsi, _ = wing_fsi
    # reset state to zero
    fsi["shell"].u.set(0.0)
    fsi["shell"].theta.set(0.0)
    dyn = DynamicShellFSI(fsi, dt=0.01, fsi_iters=4)
    hist = dyn.run(3)
    tips = hist["tip_disp"]
    assert all(np.isfinite(tips))
    # starts from rest, grows monotonically under steady lift onset
    assert 0 < tips[0] < tips[1] < tips[2]


def test_dynamic_step_adjoint_fd(wing_fsi):
    """d(tip)/d(thickness) through one implicit-midpoint dynamic shell step
    (inertia + midpoint stiffness) vs central FD."""
    from femo_tpu.models.fsi import DynamicShellFSI

    fsi, _ = wing_fsi
    dyn = DynamicShellFSI(fsi, dt=0.02, fsi_iters=2)
    op, state = dyn.dyn_op, dyn.dyn_state
    shell = fsi["shell"]
    mesh = fsi["mesh"]
    nV = shell.Vu.n_dofs
    u_old = jnp.zeros(nV)
    th_old = jnp.zeros(shell.Vth.n_dofs)
    v_old = jnp.zeros(nV)
    tip = int(np.argmax(mesh.coords[:, 1]))
    f2 = np.zeros(shell.Vf.n_dofs)
    f2[2::3] = 100.0

    def step_tip(tarr):
        x = op({"u_old": u_old, "theta_old": th_old, "v_old": v_old,
                "thickness": tarr, "force": jnp.asarray(f2)},
               jax.lax.stop_gradient(state.current()))
        return state.split(x)["u"].reshape(-1, 3)[tip, 2]

    t0 = shell.thickness.array
    val, g = jax.value_and_grad(step_tip)(t0)
    h = 1e-6
    i = 2
    fd = (float(step_tip(t0.at[i].add(h)))
          - float(step_tip(t0.at[i].add(-h)))) / (2 * h)
    np.testing.assert_allclose(float(g[i]), fd, rtol=1e-4)


def test_w9_external_loads_restart_file(wing_fsi, tmp_path):
    """W9: dynamic FSI driven by a restart-file aero-load time series
    (reference run_aeroelasticity_vpm.py:15-25 reads VPM restart files).
    File-fed loads must reproduce the directly-passed callable exactly."""
    import h5py
    from femo_tpu.models.fsi import DynamicShellFSI, aero_forces_from_file

    fsi, _ = wing_fsi
    # aero loads live at the VLM panel points (force_map's "to" side)
    n_pts = np.asarray(fsi["force_map"].W).shape[0]

    times = np.linspace(0.0, 0.1, 6)
    rng = np.random.default_rng(7)
    base = rng.standard_normal((n_pts, 3)) * 0.05
    base[:, 2] += 1.0  # dominant lift
    series = base[None, :, :] * (1.0 + 5.0 * times)[:, None, None]

    fn_h5 = str(tmp_path / "vpm_restart.h5")
    with h5py.File(fn_h5, "w") as f:
        f.create_dataset("time", data=times)
        f.create_dataset("forces", data=series)
    fn_npz = str(tmp_path / "vpm_restart.npz")
    np.savez(fn_npz, time=times, forces=series)

    def direct(t):
        w = np.interp(float(t), times, np.ones_like(times)) * 0 + float(t)
        return base * (1.0 + 5.0 * np.clip(w, times[0], times[-1]))

    def run(fn):
        fsi["shell"].u.set(0.0)
        fsi["shell"].theta.set(0.0)
        dyn = DynamicShellFSI(fsi, dt=0.01, fsi_iters=4)
        return dyn.run(3, aero_forces_fn=fn)["tip_disp"]

    tips_h5 = run(aero_forces_from_file(fn_h5))
    tips_npz = run(aero_forces_from_file(fn_npz))
    tips_direct = run(direct)
    assert all(np.isfinite(tips_h5)) and tips_h5[2] != 0.0
    np.testing.assert_allclose(tips_h5, tips_npz, rtol=1e-12)
    np.testing.assert_allclose(tips_h5, tips_direct, rtol=1e-9)


def test_coupled_fsi_tip_thickness_gradient():
    """d(tip)/d(thickness) through the ACTUAL coupled VLM <-> RBF <-> shell
    Gauss-Seidel loop (reference validates the coupled totals by FD and
    dumps gradient fields, run_aeroelasticity_static_w_feedback.py:399-428).

    Two checks: (a) the fixed-point IFT (Neumann) adjoint matches
    differentiating an unrolled damped-Picard loop to ~1e-8 — the exact
    consistency check; (b) central differences on large-gradient
    components (FD of a while_loop-converged solve carries iteration-count
    quantization noise ~tol, so FD tolerance is looser)."""
    from femo_tpu.models.fsi import build_wing_fsi
    from femo_tpu.fea.project import lumped_mass
    from femo_tpu.models.coupling import force_map_mass_weighted

    fsi = build_wing_fsi(n_shell=(4, 6), n_vlm=(2, 4), thickness=0.01)
    solve, state, op, mesh = fsi["solve"], fsi["state"], fsi["op"], fsi["mesh"]
    vlm, lat0, vvec, dmap = fsi["vlm"], fsi["lat0"], fsi["v_inf"], fsi["disp_map"]
    area = lumped_mass(fsi["shell"].Vf)[0::3]
    fmap = force_map_mass_weighted(fsi["force_map"], area)
    ncv, nsv = 2, 4
    t0 = jnp.full(fsi["shell"].Vt.n_dofs, 0.01)

    def gs(d, tarr):
        nodes = lat0 + d.reshape(ncv + 1, nsv + 1, 3)
        aero = vlm.solve(nodes, vvec)
        farr = fmap(aero["forces"]).reshape(-1)
        x = op({"thickness": tarr, "force": farr},
               jax.lax.stop_gradient(state.current()))
        u_nodes = state.split(x)["u"].reshape(-1, 3)[: mesh.n_nodes]
        return dmap.map_displacements(u_nodes).reshape(-1)

    def tip_unrolled(tarr):
        d = jnp.zeros(fsi["n_lat"] * 3)
        for _ in range(100):
            d = 0.3 * d + 0.7 * gs(d, tarr)
        nodes = lat0 + d.reshape(ncv + 1, nsv + 1, 3)
        aero = vlm.solve(nodes, vvec)
        x = op({"thickness": tarr,
                "force": fmap(aero["forces"]).reshape(-1)},
               jax.lax.stop_gradient(state.current()))
        u_nodes = state.split(x)["u"].reshape(-1, 3)[: mesh.n_nodes]
        tip = jnp.argmax(jnp.asarray(mesh.coords[:, 1]))
        return u_nodes[tip, 2]

    def tip_ift(tarr):
        return solve(tarr, tol=1e-13, maxiter=300)["tip_disp"]

    g_true = jax.grad(tip_unrolled)(t0)
    tip, g_ift = jax.value_and_grad(tip_ift)(t0)
    assert float(tip) > 0.1  # wing actually deflects
    rel = float(jnp.linalg.norm(g_true - g_ift)
                / jnp.linalg.norm(g_true))
    assert rel < 1e-7, rel

    # FD spot check on the largest-gradient component
    i = int(jnp.argmax(jnp.abs(g_ift)))
    h = 1e-6
    fp = float(tip_ift(t0.at[i].add(h)))
    fm = float(tip_ift(t0.at[i].add(-h)))
    fd = (fp - fm) / (2 * h)
    np.testing.assert_allclose(float(g_ift[i]), fd, rtol=2e-4)


def test_fsi_jit_step_matches_eager():
    """The reference-scale jitted GS machinery (factor-once + triangular
    sweeps per pass, build_fsi_jit_step) must reproduce the eager coupled
    fixed point (build_wing_fsi) at small scale."""
    from femo_tpu.models.fsi import build_fsi_jit_step, build_wing_fsi

    kw = dict(n_shell=(4, 6), n_vlm=(2, 4), span=4.0, chord=1.0)
    eager = build_wing_fsi(**kw)
    out_e = eager["solve"](eager["shell"].thickness.array,
                           tol=1e-13, maxiter=200, relax=0.7)

    jit = build_fsi_jit_step(factor_store_dtype=None, pcg_iters=2,
                             gs_inner=10, relax=0.7, **kw)
    out_j = jit["solve"](jit["t0"], rounds=6)

    # the damped GS limit-cycles at the rounding floor of the map
    # (~1e-9 relative on the lattice displacement); converged well below
    # any physical tolerance
    assert float(out_j["rel_delta"]) < 1e-7
    np.testing.assert_allclose(
        float(out_j["tip_disp"]), float(out_e["tip_disp"]), rtol=1e-7)
    # conservative map: mapped structural total == VLM total exactly
    np.testing.assert_allclose(
        np.asarray(out_j["total_mapped_force"]),
        np.asarray(out_j["total_aero_force"]), rtol=1e-10)


def test_fsi_jit_step_aitken_accelerates():
    """accel="aitken" (Irons-Tuck dynamic relaxation) must converge to
    the same coupled solution as the fixed-damping GS, and reach a
    tighter fixed point in the SAME number of passes (the point of the
    acceleration: fewer 16-second GS passes at the 107k-cell anchor)."""
    from femo_tpu.models.fsi import build_fsi_jit_step

    kw = dict(n_shell=(4, 6), n_vlm=(2, 4), span=4.0, chord=1.0,
              factor_store_dtype=None, pcg_iters=2, gs_inner=4, relax=0.7)
    plain = build_fsi_jit_step(accel="none", **kw)
    aitk = build_fsi_jit_step(accel="aitken", **kw)

    # converged oracle from the plain loop
    out_ref = plain["solve"](plain["t0"], rounds=15)
    assert float(out_ref["rel_delta"]) < 1e-8

    # after only 2 rounds (8 passes) the Aitken loop must be at least as
    # converged as the plain loop and match the converged tip better
    out_p = plain["solve"](plain["t0"], rounds=2)
    out_a = aitk["solve"](aitk["t0"], rounds=2)
    tip_ref = float(out_ref["tip_disp"])
    err_p = abs(float(out_p["tip_disp"]) - tip_ref) / abs(tip_ref)
    err_a = abs(float(out_a["tip_disp"]) - tip_ref) / abs(tip_ref)
    assert err_a < err_p, (err_a, err_p)
    assert err_a < 1e-6, err_a

    # the accelerated adjoint must reproduce the plain adjoint's gradient
    out_gp = plain["solve_with_grad"](plain["t0"], rounds=6)
    out_ga = aitk["solve_with_grad"](aitk["t0"], rounds=6)
    np.testing.assert_allclose(
        np.asarray(out_ga["grad_thickness"]),
        np.asarray(out_gp["grad_thickness"]), rtol=1e-6)


def test_fsi_jit_step_pallas_sweeps_match_scan(monkeypatch):
    """sweeps="pallas" (Pallas-Triton triangular sweeps in the
    preconditioner role, here in the Pallas interpreter) must converge to
    the same coupled solution as the scan sweeps: the f64-operator PCG
    polish makes the preconditioner precision immaterial."""
    from femo_tpu.models.fsi import build_fsi_jit_step
    from femo_tpu.ops.block_tridiag import BlockThomasFactor

    solve_pallas = BlockThomasFactor.solve_pallas
    monkeypatch.setattr(
        BlockThomasFactor, "solve_pallas",
        lambda self, b: solve_pallas(self, b, interpret=True))

    kw = dict(n_shell=(4, 6), n_vlm=(2, 4), span=4.0, chord=1.0,
              factor_store_dtype="float32", pcg_iters=4, gs_inner=10,
              relax=0.7)
    out = {}
    for sw in ("scan", "pallas"):
        jit = build_fsi_jit_step(sweeps=sw, **kw)
        out[sw] = jit["solve"](jit["t0"], rounds=5)
    # the pallas preconditioner rounds L to f32 as well as Sinv/C, so
    # its GS limit cycle sits ~1 decade above the scan variant's (whose
    # einsum promotes the f32 store to f64); both are far below any
    # physical tolerance and the converged tips agree
    assert float(out["pallas"]["rel_delta"]) < 1e-4
    np.testing.assert_allclose(
        float(out["pallas"]["tip_disp"]), float(out["scan"]["tip_disp"]),
        rtol=1e-5)


def test_dynamic_fsi_jit_step_matches_eager():
    """Jitted factor-once dynamic stepping (build_dynamic_fsi_jit_step)
    vs the eager DynamicShellFSI time loop on the same gust problem."""
    from femo_tpu.models.fsi import (
        DynamicShellFSI, build_dynamic_fsi_jit_step, build_wing_fsi)

    kw = dict(n_shell=(4, 6), n_vlm=(2, 4))
    eager = build_wing_fsi(**kw)
    eager["shell"].u.set(0.0)
    eager["shell"].theta.set(0.0)
    dyn_e = DynamicShellFSI(eager, dt=0.01, fsi_iters=6)
    hist_e = dyn_e.run(3)

    jit = build_dynamic_fsi_jit_step(
        dt=0.01, fsi_iters=6, factor_store_dtype=None, pcg_iters=0, **kw)
    hist_j = jit["run"](jit["t0"], 3)

    np.testing.assert_allclose(
        hist_j["tip_disp"], hist_e["tip_disp"], rtol=1e-5)
    tips = hist_j["tip_disp"]
    assert 0 < tips[0] < tips[1] < tips[2]


def test_fsi_jit_adjoint_matches_unrolled_gradient():
    """The reference-scale coupled adjoint (build_fsi_jit_step's
    factor-reuse IFT through VLM <-> RBF <-> shell, solve_with_grad) must
    reproduce d(tip)/d(thickness) from differentiating an unrolled
    damped-Picard loop on the eager path — the same exact-consistency
    oracle as test_coupled_fsi_tip_thickness_gradient, here checking the
    FULL per-dof gradient vector of the anchor-scale machinery."""
    from femo_tpu.fea.project import lumped_mass
    from femo_tpu.models.fsi import build_fsi_jit_step, build_wing_fsi

    kw = dict(n_shell=(4, 6), n_vlm=(2, 4), span=4.0, chord=1.0)
    jit = build_fsi_jit_step(factor_store_dtype=None, pcg_iters=2,
                             gs_inner=10, relax=0.7, adj_passes=60, **kw)
    out = jit["solve_with_grad"](jit["t0"], rounds=12)
    assert float(out["rel_delta"]) < 1e-7
    assert float(out["adj_delta"]) < 1e-7
    g_jit = np.asarray(out["grad_thickness"])

    # oracle: unrolled damped Picard on the eager path, jax.grad through
    # the whole loop (no IFT shortcut)
    fsi = build_wing_fsi(thickness=0.01, **kw)
    vlm, lat0, vvec = fsi["vlm"], fsi["lat0"], fsi["v_inf"]
    state, op, mesh = fsi["state"], fsi["op"], fsi["mesh"]
    dmap = fsi["disp_map"]
    area = lumped_mass(fsi["shell"].Vf)[0::3]
    fmap = force_map_mass_weighted(fsi["force_map"], area)
    ncv, nsv = 2, 4

    def gs(d, tarr):
        nodes = lat0 + d.reshape(ncv + 1, nsv + 1, 3)
        aero = vlm.solve(nodes, vvec)
        farr = fmap(aero["forces"]).reshape(-1)
        x = op({"thickness": tarr, "force": farr},
               jax.lax.stop_gradient(state.current()))
        u_nodes = state.split(x)["u"].reshape(-1, 3)[: mesh.n_nodes]
        return dmap.map_displacements(u_nodes).reshape(-1)

    def tip_unrolled(tarr):
        d = jnp.zeros(fsi["n_lat"] * 3)
        for _ in range(100):
            d = 0.3 * d + 0.7 * gs(d, tarr)
        nodes = lat0 + d.reshape(ncv + 1, nsv + 1, 3)
        aero = vlm.solve(nodes, vvec)
        x = op({"thickness": tarr,
                "force": fmap(aero["forces"]).reshape(-1)},
               jax.lax.stop_gradient(state.current()))
        u_nodes = state.split(x)["u"].reshape(-1, 3)[: mesh.n_nodes]
        tip = jnp.argmax(jnp.asarray(mesh.coords[:, 1]))
        return u_nodes[tip, 2]

    g_true = np.asarray(jax.grad(tip_unrolled)(jit["t0"]))
    rel = np.linalg.norm(g_jit - g_true) / np.linalg.norm(g_true)
    assert rel < 1e-6, rel


def test_dynamic_fsi_trajectory_gradient_matches_unrolled():
    """Checkpointed trajectory adjoint (run_with_grad): d(smooth-max tip
    over the gust)/d(thickness) through the implicit-midpoint loop must
    match jax.grad through the WHOLE unrolled forward (factorization,
    inner FSI passes, warm-started lattice — the exact algorithm).  The
    backward sweep reuses the single forward factorization (A^T = A) and
    re-linearizes each step from host-checkpointed states."""
    from femo_tpu.models.fsi import build_dynamic_fsi_jit_step

    n_steps = 3
    jit = build_dynamic_fsi_jit_step(
        n_shell=(4, 6), n_vlm=(2, 4), dt=0.01, fsi_iters=8,
        factor_store_dtype=None, pcg_iters=0, adj_passes=10)
    out = jit["run_with_grad"](jit["t0"], n_steps)
    assert max(out["adj_deltas"]) < 1e-10  # per-step lambda converged
    assert out["tips"][-1] > out["tips"][0] > 0  # gust ramping up
    g_ift = np.asarray(out["grad_thickness"])

    consts, step, factor = jit["consts"], jit["step"], jit["factor"]
    nV, nT = jit["shell"].Vu.n_dofs, jit["shell"].Vth.n_dofs

    def J_unrolled(tarr):
        carry = factor(tarr, consts)
        u, th, v = jnp.zeros(nV), jnp.zeros(nT), jnp.zeros(nV)
        d = jnp.zeros(3 * 5 * 3)  # (ncv+1)(nsv+1)*3 lattice dofs
        tips = []
        for n in range(n_steps):
            t_mid = jnp.asarray((n + 0.5) * 0.01)
            u, th, v, d, tip = step(carry, tarr, u, th, v, d, t_mid,
                                    consts)
            tips.append(tip)
        return (jnp.mean(jnp.abs(jnp.stack(tips)) ** 8)) ** 0.125

    g_true = np.asarray(jax.grad(J_unrolled)(jit["t0"]))
    rel = np.linalg.norm(g_ift - g_true) / np.linalg.norm(g_true)
    assert rel < 1e-8, rel


def test_fsi_jit_step_cr_factor_matches_thomas():
    """factor_method='cr' (block cyclic reduction, the latency-optimal
    choice for the anchor's B=128 / nb~7k regime where the Thomas factor
    scan is dependency-bound) must reproduce the Thomas path: forward tip
    and coupled gradient, in f64 and with the f32 level store + PCG polish."""
    from femo_tpu.models.fsi import build_fsi_jit_step

    kw = dict(n_shell=(8, 12), n_vlm=(2, 4), thickness=0.01, gs_inner=4,
              relax=0.7, adj_passes=30)
    th = build_fsi_jit_step(factor_store_dtype=None, pcg_iters=2,
                            factor_method="thomas", **kw)
    ot = th["solve_with_grad"](th["t0"], rounds=5)
    for fsd, pcg, rtol in ((None, 2, 1e-7), ("float32", 4, 1e-5)):
        cr = build_fsi_jit_step(factor_store_dtype=fsd, pcg_iters=pcg,
                                factor_method="cr", **kw)
        oc = cr["solve_with_grad"](cr["t0"], rounds=5)
        np.testing.assert_allclose(float(oc["tip_disp"]),
                                   float(ot["tip_disp"]), rtol=rtol)
        rel = float(jnp.linalg.norm(
            oc["grad_thickness"] - ot["grad_thickness"])
            / jnp.linalg.norm(ot["grad_thickness"]))
        assert rel < 100 * rtol, (fsd, rel)


def test_fsi_jit_adjoint_compliance_objective():
    """objective='compliance' branch of the coupled adjoint (aeroelastic
    compliance: force recomputed from x inside J, so dJ/dx includes the
    VLM chain): directional FD check."""
    from femo_tpu.models.fsi import build_fsi_jit_step

    jit = build_fsi_jit_step(n_shell=(4, 6), n_vlm=(2, 4),
                             factor_store_dtype=None, pcg_iters=2,
                             gs_inner=10, relax=0.7, adj_passes=40,
                             objective="compliance")
    t0 = jit["t0"]
    out = jit["solve_with_grad"](t0, rounds=12)
    assert float(out["adj_delta"]) < 1e-8
    g = np.asarray(out["grad_thickness"])

    rng = np.random.default_rng(3)
    v = rng.normal(size=g.shape)
    v /= np.linalg.norm(v)
    eps = 1e-5
    Jp = float(jit["solve_with_grad"](jnp.asarray(np.asarray(t0) + eps * v),
                                      rounds=12)["objective"])
    Jm = float(jit["solve_with_grad"](jnp.asarray(np.asarray(t0) - eps * v),
                                      rounds=12)["objective"])
    fd = (Jp - Jm) / (2 * eps)
    np.testing.assert_allclose(float(g @ v), fd, rtol=2e-4)


@pytest.mark.slow
def test_fsi_factor_compute_f32_matches_f64_at_anchor_thickness():
    """factor_compute_dtype="float32" (r4 anchor speed lever): the whole
    factor recursion + sweeps run f32 on the Jacobi-EQUILIBRATED operator.
    At anchor thickness (t=0.05) with pcg8 polish on the f64 operator, J
    and the full thickness gradient match the f64-factor run to ~1e-8.  (At t=0.01
    the thin-shell equilibrated cond 6.6e7 makes even the equilibrated
    f32 factor plateau at ~1e-2 — that rung keeps the f64 recursion.)"""
    from femo_tpu.models.fsi import build_fsi_jit_step

    ref = None
    for fc, pcg in ((None, 4), ("float32", 8), ("mixed", 4)):
        fsi = build_fsi_jit_step(
            n_shell=(16, 24), n_vlm=(4, 8), span=4.0, thickness=0.05,
            gs_inner=4, pcg_iters=pcg, factor_store_dtype="float32",
            factor_compute_dtype=fc, accel="aitken")
        out = fsi["solve_with_grad"](fsi["t0"], rounds=6)
        J = float(out["objective"])
        g = np.asarray(out["grad_thickness"])
        if ref is None:
            ref = (J, g)
        else:
            assert abs(J - ref[0]) / abs(ref[0]) < 1e-7
            assert (np.linalg.norm(g - ref[1])
                    / np.linalg.norm(ref[1])) < 1e-7
            assert float(out["adj_delta"]) < 1e-6


def test_fsi_pcg_tol_makes_low_precision_factors_admissible():
    """pcg_rtol (solve-to-tolerance inner PCG, reference SNES semantics
    utils_dolfinx.py:377-379): with converged inner solves, the coupled
    GS fixed point must be INDEPENDENT of factor quality — cr+mixed and
    thomas+f32-store must match the exact-f64 thomas fixed point to the
    outer-GS convergence level, closing the anchor's wrong-fixed-point
    failure mode (tip 17.67/21.88 vs 16.56 under truncated polish)."""
    from femo_tpu.models.fsi import build_fsi_jit_step

    kw = dict(n_shell=(8, 12), n_vlm=(2, 4), thickness=0.01, gs_inner=4,
              relax=0.7, adj_passes=30)
    ref = build_fsi_jit_step(factor_store_dtype=None, pcg_iters=2,
                             factor_method="thomas", **kw)
    oref = ref["solve_with_grad"](ref["t0"], rounds=6)

    for fm, fcd, fsd in (("cr", "mixed", "float32"),
                         ("thomas", "mixed", "float32")):
        lo = build_fsi_jit_step(factor_store_dtype=fsd,
                                factor_method=fm, factor_compute_dtype=fcd,
                                pcg_rtol=1e-11, pcg_maxiter=80, **kw)
        olo = lo["solve_with_grad"](lo["t0"], rounds=6)
        np.testing.assert_allclose(float(olo["tip_disp"]),
                                   float(oref["tip_disp"]), rtol=1e-8)
        rel = float(jnp.linalg.norm(
            olo["grad_thickness"] - oref["grad_thickness"])
            / jnp.linalg.norm(oref["grad_thickness"]))
        assert rel < 1e-6, (fm, fcd, rel)


def test_w9_external_loads_jit_trajectory_gradient():
    """W9 differentiable restart-loads regime: the jitted dynamic
    trajectory driven by a PRESCRIBED (n_steps, n_pts, 3) load series
    (reference run_aeroelasticity_vpm.py:15-25 — but the reference's VPM
    loads sit outside its CSDL tape; here the checkpointed adjoint
    returns BOTH d J/d thickness and d J/d loads).  Central-FD parity on
    a thickness direction and on individual load components."""
    import jax.numpy as jnp
    from femo_tpu.config import config
    from femo_tpu.models.fsi import build_dynamic_fsi_jit_step

    n_steps = 4
    dyn = build_dynamic_fsi_jit_step(
        n_shell=(6, 10), n_vlm=(2, 4), span=4.0, thickness=0.01,
        dt=0.01, pcg_iters=8, factor_store_dtype=None,
        external_loads=True)
    rng = np.random.default_rng(3)
    series = rng.standard_normal(
        (n_steps, dyn["n_force_pts"], 3)) * 2.0
    series[:, :, 2] += 40.0  # dominant lift
    t0 = dyn["t0"]

    out = dyn["run_with_grad"](t0, n_steps, forces_series=series)
    assert np.all(np.isfinite(out["tips"])) and out["tips"][-1] != 0.0
    # external loads -> single exact adjoint solve per step
    assert max(out["adj_deltas"]) == 0.0

    def J_of(tarr, ser):
        tips = dyn["run"](tarr, n_steps, forces_series=ser)["tip_disp"]
        tips = jnp.asarray(np.asarray(tips), config.jdtype)
        return float((jnp.mean(jnp.abs(tips) ** 8)) ** 0.125)

    # thickness direction: dJ/dt . t0 vs central FD along t0
    g_dir = float(jnp.dot(out["grad_thickness"], t0))
    # h=1e-6 hits the f64 accumulation-noise floor (measured: FD error
    # 8e-8 abs = noise/(2h)); h=1e-4 keeps truncation at O(1e-8) rel
    # while lifting the signal 100x above the noise
    h = 1e-4
    jp = J_of(t0 * (1 + h), series)
    jm = J_of(t0 * (1 - h), series)
    fd_dir = (jp - jm) / (2 * h)
    np.testing.assert_allclose(g_dir, fd_dir, rtol=1e-5)

    # load components: dJ/d series[n, i, k] vs central FD
    gf = out["grad_forces"]
    assert gf.shape == series.shape
    for n, i, k in ((0, 1, 2), (n_steps - 1, 3, 2), (1, 0, 0)):
        hh = 1e-3
        sp = series.copy()
        sp[n, i, k] += hh
        sm = series.copy()
        sm[n, i, k] -= hh
        fd = (J_of(t0, sp) - J_of(t0, sm)) / (2 * hh)
        np.testing.assert_allclose(gf[n, i, k], fd, rtol=5e-6,
                                   atol=1e-12,
                                   err_msg=f"series[{n},{i},{k}]")
