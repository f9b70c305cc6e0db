"""Aeroelastic fluid-structure interaction: static fixed-point coupling and
implicit-midpoint dynamics (workloads W7/W8,
/root/reference/examples/aeroelasticity_vlm/).

Static (W7): VLM -> RBF force map -> RM shell solve -> RBF displacement map
-> lattice update, iterated as a damped Gauss-Seidel fixed point wrapped in
the differentiable fixed-point operator (reference couples via
csdl.NonlinearBlockGS, run_aeroelasticity_static_w_feedback.py:346-355).

Dynamic (W8): implicit midpoint time integration constructed on the shell
residual (run_aeroelasticity_dynamic.py:197-208): unknown u_{n+1} with
  v_new = 2 (u_new - u_old)/dt - v_old,
  R = rho t (v_new - v_old)/dt . w + dPsi(u_mid) . w - f_mid . w,
outer time loop x inner FSI fixed point, 1-cosine gust (reference :126-139).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..config import config
from ..utils.arrays import asdev
from ..fea.bc import DirichletBC
from ..fea.forms import FormDef, dx
from ..graph.fixed_point import fixed_point_solve, fixed_point_solve_jit
from ..mesh.generators import create_rectangle_mesh
from ..mesh.mesh import Mesh
from .coupling import NodalMap, force_map_mass_weighted
from .shell import RMShellModel
from .vlm import VLM, flat_wing_lattice


def build_wing_fsi(span=4.0, chord=1.0, n_shell=(8, 12), n_vlm=(3, 8),
                   E=7e10, nu=0.3, thickness=0.01, rho_air=1.225,
                   v_inf=(20.0, 0.0, 2.0), rho_s=2700.0,
                   solve_mode: str = "jit_dense"):
    """Static aeroelastic wing problem: cantilever plate wing + VLM.

    Wing midsurface in the x (chord) - y (span) plane, clamped at y=0
    (half-wing). Returns a problem dict with a differentiable
    `solve(thickness_arr) -> outputs` implementing the coupled fixed point.
    """
    ncs, nss = n_shell
    m2 = create_rectangle_mesh(ncs, nss, 0, 0, chord, span,
                               cell_type="triangle")
    coords3 = np.concatenate([m2.coords, np.zeros((m2.n_nodes, 1))], axis=1)
    mesh = Mesh(coords3, m2.cells, "triangle")
    shell = RMShellModel(mesh, E=E, nu=nu, rho=rho_s)
    shell.thickness.set(thickness)

    clamp = lambda x: np.isclose(x[1], 0.0)
    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]
    state = shell.make_state(bcs)
    from ..fea.composite import composite_implicit_op
    from ..solvers.linear import LinearSolver

    # linear shell: the jittable device paths (1 Newton) are exact and avoid
    # per-pass host round trips in the Gauss-Seidel loop; "jit_bt" is the
    # scalable block-Thomas default, "jit_dense" the small-problem dense LU
    if solve_mode in ("jit_dense", "jit_bt"):
        op = composite_implicit_op(
            state, ["thickness", "force"],
            newton_opts={"jit_newton_iters": 1}, mode=solve_mode)
    else:
        op = composite_implicit_op(
            state, ["thickness", "force"],
            linear_solver=LinearSolver(method="scipy"),
            newton_opts={"maxiter": 6})

    # VLM lattice over the same planform (y in [0, span])
    ncv, nsv = n_vlm
    lat0 = np.array(flat_wing_lattice(span, chord, ncv, nsv))
    lat0[..., 1] += span / 2  # shift to [0, span]
    lat0 = jnp.asarray(lat0)
    vlm = VLM(ncv, nsv, rho=rho_air)
    vvec = jnp.asarray(np.asarray(v_inf, config.dtype))

    # coupling maps: shell CG1 vertices <-> lattice nodes / force points
    shell_pts = mesh.coords  # (n_nodes, 3)
    lat_pts = np.asarray(lat0).reshape(-1, 3)
    disp_map = NodalMap(shell_pts, lat_pts, kind="gaussian")
    # force points = bound-vortex midpoints of the base lattice, computed
    # host-side (VLM.bound_midpoints_np == vlm.solve's "points"; no
    # eager device VLM solve at build time)
    fpts = VLM.bound_midpoints_np(lat_pts.reshape(ncv + 1, nsv + 1, 3))
    force_map = NodalMap(shell_pts, fpts, kind="gaussian")
    from ..fea.project import lumped_mass

    # per-node tributary area (slice on the host: a device [0::3] gather
    # is an eager compile)
    area_lump = jnp.asarray(np.asarray(lumped_mass(shell.Vf))[0::3])
    fmap = force_map_mass_weighted(force_map, area_lump)

    n_lat = lat_pts.shape[0]

    def gs_step(dlat_flat, params):
        """One Gauss-Seidel pass: aero(lattice+d) -> shell -> new d."""
        tarr = params["thickness"]
        nodes = lat0 + dlat_flat.reshape(ncv + 1, nsv + 1, 3)
        aero = vlm.solve(nodes, vvec)
        traction_nodes = fmap(aero["forces"])  # (n_shell_nodes, 3)
        farr = traction_nodes.reshape(-1)
        x = op({"thickness": tarr, "force": farr},
               jax.lax.stop_gradient(state.current()))
        parts = state.split(x)
        u_nodes = parts["u"].reshape(-1, 3)[: mesh.n_nodes]
        d_new = disp_map.map_displacements(u_nodes)
        return d_new.reshape(-1)

    def solve_coupled(thickness_arr, tol=1e-8, maxiter=60, relax=0.7):
        d0 = jnp.zeros(n_lat * 3, config.jdtype)
        params = {"thickness": thickness_arr}
        # device-resident Gauss-Seidel (lax.while_loop, no per-pass host
        # sync) when the inner solve is jittable; eager loop otherwise
        fp = (fixed_point_solve_jit if solve_mode.startswith("jit")
              else fixed_point_solve)
        d_star = fp(
            lambda d, p: gs_step(d, p), d0, params, tol=tol,
            maxiter=maxiter, relax=relax)
        # recompute converged quantities (cheap, differentiable)
        nodes = lat0 + d_star.reshape(ncv + 1, nsv + 1, 3)
        aero = vlm.solve(nodes, vvec)
        traction_nodes = fmap(aero["forces"])
        x = op({"thickness": thickness_arr,
                "force": traction_nodes.reshape(-1)},
               jax.lax.stop_gradient(state.current()))
        parts = state.split(x)
        u_nodes = parts["u"].reshape(-1, 3)[: mesh.n_nodes]
        tip = jnp.argmax(jnp.asarray(mesh.coords[:, 1]))
        return dict(
            disp_fluid=d_star, u=parts["u"], theta=parts["theta"],
            tip_disp=u_nodes[tip, 2],
            total_aero_force=aero["total"],
            total_mapped_force=jnp.sum(
                traction_nodes * area_lump[:, None], axis=0),
        )

    return dict(mesh=mesh, shell=shell, state=state, op=op, vlm=vlm,
                lat0=lat0, solve=solve_coupled, v_inf=vvec,
                disp_map=disp_map, force_map=force_map, n_lat=n_lat)


def one_cosine_gust(t, t0=0.1, duration=0.2, w_gust=2.0):
    """1-cosine vertical gust velocity profile (reference :126-139)."""
    s = (t - t0) / duration
    inside = (s >= 0) & (s <= 1)
    return jnp.where(inside,
                     0.5 * w_gust * (1 - jnp.cos(2 * jnp.pi * s)), 0.0)


def aero_forces_from_file(path: str, times_key: str = "time",
                          forces_key: str = "forces"):
    """Load a precomputed aero-load time series from disk and return an
    `aero_forces_fn(t) -> (n_pts, 3)` for DynamicShellFSI.run.

    Workload W9 parity: the reference's VPM variant feeds the dynamic FSI
    skeleton from external Vortex Particle Method restart files
    (/root/reference/examples/aeroelasticity_vpm/run_aeroelasticity_vpm.py:
    15-25, FSI_coupling.VPM_sim_handling).  Supports .h5/.hdf5 (h5py) and
    .npz, with datasets `time` (n_t,) and `forces` (n_t, n_pts, 3); values
    are linearly interpolated in time and held constant outside the range.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext in (".h5", ".hdf5"):
        import h5py

        with h5py.File(path, "r") as f:
            times = np.asarray(f[times_key])
            forces = np.asarray(f[forces_key])
    elif ext == ".npz":
        d = np.load(path)
        times, forces = np.asarray(d[times_key]), np.asarray(d[forces_key])
    else:
        raise ValueError(f"unsupported restart-file format: {path}")
    order = np.argsort(times)
    times, forces = times[order], forces[order]
    tj = jnp.asarray(times, config.jdtype)
    fj = jnp.asarray(forces, config.jdtype)

    def fn(t):
        i = jnp.clip(jnp.searchsorted(tj, t), 1, len(tj) - 1)
        t0, t1 = tj[i - 1], tj[i]
        w = jnp.clip((t - t0) / jnp.maximum(t1 - t0,
                                            jnp.finfo(tj.dtype).tiny),
                     0.0, 1.0)
        return (1.0 - w) * fj[i - 1] + w * fj[i]

    return fn


class DynamicShellFSI:
    """Implicit-midpoint dynamic aeroelasticity (W8).

    Each time step solves the dynamic shell residual (inertia + stiffness at
    the midpoint) with aero loads from the VLM evaluated at the midpoint
    configuration, via an inner fixed point (reference custom_solve time
    loop, run_aeroelasticity_dynamic.py:272-391).
    """

    def __init__(self, fsi: dict, dt: float, fsi_iters: int = 8,
                 gust=one_cosine_gust):
        self.fsi = fsi
        self.dt = dt
        self.gust = gust
        self.fsi_iters = fsi_iters
        shell = fsi["shell"]
        self.shell = shell
        state = fsi["state"]
        self.state = state

        # dynamic residual: inertial term added to the u-block
        rho_t = shell.rho

        def r_u_dyn(w, g):
            # (rho t / dt) (v_new - v_old) . w  with
            # v_new = 2 (u_new - u_old)/dt - v_old
            dt_ = self.dt
            accel = (2.0 / dt_**2) * (
                w.u.val - w.u_old.val) - (2.0 / dt_) * w.v_old.val
            return rho_t * w.thickness.val * jnp.dot(accel, w.v.val)

        from ..fea.space import Function

        self.u_old = Function(shell.Vu, "u_old")
        self.v_old = Function(shell.Vu, "v_old")
        inertial = FormDef(
            [dx(r_u_dyn, qdeg=4)],
            coeffs=[shell.u, self.u_old, self.v_old, shell.thickness],
            test=shell.Vu)
        # dynamic u-residual = static(u_mid) + inertia; we implement by
        # solving for u_new with the static residual evaluated at u_mid:
        # build a dedicated composite with modified forms
        self._make_dynamic_state(inertial)

    def _make_dynamic_state(self, inertial: FormDef):
        shell = self.shell
        from ..fea.composite import CompositeState, composite_implicit_op
        from ..solvers.linear import LinearSolver

        # static residuals evaluated at u_mid = (u_new + u_old)/2: we reuse
        # the static forms but pass u_mid by linearity of the energy terms?
        # RM is linear, so R_static(u_mid) = 0.5 R(u_new) + 0.5 R(u_old);
        # implement as 0.5-weighted forms plus an explicit old-state load.
        def half_ru(w, g):
            from .shell import local_frame, shell_energy_density

            frame = local_frame(g.J)
            uv = 0.5 * (w.u.val + w.u_old.val)
            ug = 0.5 * (w.u.grad + w.u_old.grad)
            tv = 0.5 * (w.theta.val + w.theta_old.val)
            tg = 0.5 * (w.theta.grad + w.theta_old.grad)

            def psi(a, b):
                return shell_energy_density(
                    a, b, tv, tg, w.thickness.val, frame,
                    shell.E, shell.nu, shell.drill)

            dpsi = jax.jvp(psi, (uv, ug), (w.v.val, w.v.grad))[1]
            return dpsi - jnp.dot(w.force.val, w.v.val)

        def half_rth(w, g):
            from .shell import local_frame, shell_energy_density

            frame = local_frame(g.J)
            uv = 0.5 * (w.u.val + w.u_old.val)
            ug = 0.5 * (w.u.grad + w.u_old.grad)
            tv = 0.5 * (w.theta.val + w.theta_old.val)
            tg = 0.5 * (w.theta.grad + w.theta_old.grad)

            def psi(a, b):
                return shell_energy_density(
                    uv, ug, a, b, w.thickness.val, frame,
                    shell.E, shell.nu, shell.drill)

            return jax.jvp(psi, (tv, tg), (w.v.val, w.v.grad))[1]

        from ..fea.space import Function

        self.theta_old = Function(shell.Vth, "theta_old")
        coeffs = [shell.u, shell.theta, self.u_old, self.theta_old,
                  self.v_old, shell.thickness, shell.force]
        res_u = FormDef([dx(half_ru, qdeg=4)] + inertial.integrals,
                        coeffs=coeffs, test=shell.Vu)
        res_th = FormDef([dx(half_rth, qdeg=4)], coeffs=coeffs,
                         test=shell.Vth)
        clamp = lambda x: np.isclose(x[1], 0.0)
        bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
               DirichletBC(shell.Vth, 0.0, where=clamp)]
        self.dyn_state = CompositeState(
            [shell.u, shell.theta], {"u": res_u, "theta": res_th}, bcs)
        # device-resident per-step solve: the midpoint residual is linear in
        # u_new (RM shell), so one block-Thomas Newton step is exact — no
        # host splu round trip per time step (VERDICT r1 item 5)
        self.dyn_op = composite_implicit_op(
            self.dyn_state,
            ["u_old", "theta_old", "v_old", "thickness", "force"],
            newton_opts={"jit_newton_iters": 1}, mode="jit_bt")

    def run(self, n_steps: int, thickness_arr=None, report: bool = False,
            aero_forces_fn=None):
        """Time march; returns tip-displacement history.

        aero_forces_fn(t) -> (n_force_points, 3): external precomputed aero
        load time series replacing the VLM (workload W9 parity — the
        reference's VPM variant reads restart files,
        run_aeroelasticity_vpm.py:15-25; loads are then motion-independent
        and the inner fixed point collapses to one pass)."""
        fsi = self.fsi
        shell = self.shell
        mesh = fsi["mesh"]
        vlm = fsi["vlm"]
        lat0 = fsi["lat0"]
        vvec = fsi["v_inf"]
        disp_map = fsi["disp_map"]
        from ..fea.project import lumped_mass

        area_lump = lumped_mass(shell.Vf)[0::3]
        fmap = force_map_mass_weighted(fsi["force_map"], area_lump)
        tarr = (thickness_arr if thickness_arr is not None
                else shell.thickness.array)

        nV = shell.Vu.n_dofs
        u_old = jnp.zeros(nV, config.jdtype)
        th_old = jnp.zeros(shell.Vth.n_dofs, config.jdtype)
        v_old = jnp.zeros(nV, config.jdtype)
        tip = int(np.argmax(mesh.coords[:, 1]))
        history = {"tip_disp": [], "time": []}
        x = self.dyn_state.current()
        dt = self.dt
        for n in range(n_steps):
            t_mid = (n + 0.5) * dt
            vg = self.gust(t_mid)
            v_now = vvec + jnp.array([0.0, 0.0, 1.0]) * vg
            # inner FSI fixed point at the midpoint configuration
            u_guess = self.dyn_state.split(x)["u"]
            inner_iters = 1 if aero_forces_fn is not None else self.fsi_iters
            for it in range(inner_iters):
                if aero_forces_fn is not None:
                    forces = jnp.asarray(aero_forces_fn(t_mid))
                else:
                    u_mid_nodes = (0.5 * (u_guess + u_old)).reshape(
                        -1, 3)[: mesh.n_nodes]
                    d_lat = disp_map.map_displacements(u_mid_nodes)
                    nodes = lat0 + d_lat.reshape(lat0.shape)
                    aero = vlm.solve(nodes, v_now)
                    forces = aero["forces"]
                farr = fmap(forces).reshape(-1)
                x = self.dyn_op(
                    {"u_old": u_old, "theta_old": th_old, "v_old": v_old,
                     "thickness": tarr, "force": farr},
                    jax.lax.stop_gradient(x))
                u_new = self.dyn_state.split(x)["u"]
                delta = float(jnp.linalg.norm(
                    jax.lax.stop_gradient(u_new - u_guess)))
                u_guess = u_new
                if delta < 1e-9:
                    break
            th_new = self.dyn_state.split(x)["theta"]
            v_new = 2.0 * (u_new - u_old) / dt - v_old
            u_old, th_old, v_old = u_new, th_new, v_new
            w_tip = float(u_new.reshape(-1, 3)[tip, 2])
            history["tip_disp"].append(w_tip)
            history["time"].append((n + 1) * dt)
            if report:
                print(f"  step {n + 1}: t={(n + 1) * dt:.3f} "
                      f"tip={w_tip:.5e} (fsi iters {it + 1})")
        return history


# ---------------------------------------------------------------------------
# Reference-scale coupled FSI (VERDICT r2 items 1/7)
#
# The reference's flagship scale anchors are the 107,695-element eVTOL wing
# (static, run_aeroelasticity_static_w_feedback.py:55) and the 77,020 ->
# 135,957-element dynamic ladder (run_aeroelasticity_dynamic.py:51-55),
# both solved under MPI + parallel MUMPS.  The builders below drive the
# coupled VLM <-> RBF <-> shell Gauss-Seidel loop at that element count on
# ONE device using the f64 shell recipe (block-Thomas, f32 factor store +
# PCG polish on the f64 operator, split jitted programs).
#
# The decisive structural win over per-pass MUMPS: the RM shell operator is
# LINEAR and thickness-fixed within a coupled solve, so the factorization
# is computed ONCE per design point and every Gauss-Seidel pass (and every
# dynamic time step -- the midpoint operator is also time-independent) is
# only a VLM solve + RHS assembly + block triangular sweeps.  The reference
# re-runs the full Newton + MUMPS pipeline on every pass
# (run_aeroelasticity_static_w_feedback.py:346-355 NonlinearBlockGS).
# ---------------------------------------------------------------------------


def _wing_shell_system(n_shell, span, chord, E, nu, rho_s):
    """Host-side setup shared by the reference-scale FSI builders:
    cantilever plate wing mesh + RM shell model + BC arrays."""
    ncs, nss = n_shell
    m2 = create_rectangle_mesh(ncs, nss, 0, 0, chord, span,
                               cell_type="triangle")
    coords3 = np.concatenate([m2.coords, np.zeros((m2.n_nodes, 1))], axis=1)
    mesh = Mesh(coords3, m2.cells, "triangle")
    shell = RMShellModel(mesh, E=E, nu=nu, rho=rho_s)
    clamp = lambda x: np.isclose(x[1], 0.0)
    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]
    state = shell.make_state(bcs)
    return mesh, shell, state


def _vlm_and_maps(mesh, shell, n_vlm, span, chord, rho_air, v_inf):
    """VLM lattice over the wing planform + RBF transfer matrices.

    Returns (vlm, lat0, consts) where consts holds the dense map matrices
    (passed as jit ARGUMENTS -- not multi-MB constants closed over by the
    program)."""
    from ..fea.project import lumped_mass

    ncv, nsv = n_vlm
    lat0 = np.array(flat_wing_lattice(span, chord, ncv, nsv))
    lat0[..., 1] += span / 2  # shift to [0, span] like the shell
    lat0 = jnp.asarray(lat0)
    vlm = VLM(ncv, nsv, rho=rho_air)
    vvec = jnp.asarray(np.asarray(v_inf, config.dtype))

    shell_pts = mesh.coords
    lat_np = np.asarray(lat0)
    lat_pts = lat_np.reshape(-1, 3)
    disp_map = NodalMap(shell_pts, lat_pts, kind="gaussian")
    # force points = bound-vortex (quarter-chord) midpoints, computed in
    # numpy (VLM.bound_midpoints_np): no eager device VLM solve at build
    # time
    fpts = VLM.bound_midpoints_np(lat_np)
    force_map = NodalMap(shell_pts, fpts, kind="gaussian")
    # per-node tributary area (one jitted assembly call); the map algebra
    # stays in numpy — no eager device programs at build time
    area_np = np.asarray(lumped_mass(shell.Vf))[0::3]
    consts = {
        # conservative mass-weighted force map: traction = (W^T f) / area
        "__fmapW__": jnp.asarray(force_map.W_np.T / area_np[:, None]),
        "__dmapW__": disp_map.W,
        "__area__": jnp.asarray(area_np),
    }
    return vlm, lat0, vvec, consts


def _composite_bt_template(ucf, tcf, off_th, n_dofs, free):
    """RCM block-tridiagonal template for the (u, theta) composite
    Jacobian: one proto MatBlock per (form, coefficient) pairing, shared
    by the static and dynamic FSI builders."""
    from ..fea.assemble import ElementMatrix, MatBlock
    from ..ops.block_tridiag import BlockTridiagTemplate

    proto_blocks = []
    for cf, roff in ((ucf, 0), (tcf, off_th)):
        for cname, coff in (("u", 0), ("theta", off_th)):
            for t in cf.terms:
                rows = np.asarray(t.gdofs0["__test__"]) + roff
                cols = np.asarray(t.gdofs0[cname]) + coff
                ne, nr = rows.shape
                nc = cols.shape[1]
                # broadcast view, not a materialized (ne, nr, nc) alloc:
                # the template only reads the pattern (shape/rows/cols)
                proto_blocks.append(MatBlock(
                    np.broadcast_to(np.float64(1.0), (ne, nr, nc)),
                    rows, cols))
    proto = ElementMatrix(proto_blocks, n_dofs, n_dofs)
    return BlockTridiagTemplate(proto, free=np.asarray(free))


def _bt_factor_programs(tpl, jac_blocks, fill_params, n_dofs, free, bv,
                        factor_store_dtype, factor_method: str = "thomas",
                        factor_compute_dtype=None, mixed_ns: int = 3,
                        mixed_tol: float = 1e-7):
    """fill + factor as SEPARATE jitted programs sharing a device-resident
    (D, L, U, Sinv, C) carry (one fused program's temps exceeded a 16 GB
    device at the 107k-element rung: 14.3 GB temp + 4.4 GB outputs, from
    XLA's memory analysis; whether the split still pays with 80 GB is
    ROADMAP design item 1).

    D/L/U stay f64 in the carry even when the factor store is f32 —
    rounding the OPERATOR to f32 is the regime the RM composite cannot
    tolerate (eps_f32 x cond > 1; measured: a tip deflection 70x wrong
    while the GS loop still "converged").  Only the preconditioner
    (Sinv, C) may be stored low-precision, with the f64-operator PCG
    polish recovering the accuracy.  The factor-core program returns ONLY
    (Sinv, C), not the multi-GB D/L/U as donated outputs.  Past ~4k
    blocks factor_chunked host-loops the sequential factor scan in
    ~2k-block chunks (bit-identical recursion), a guard against faults
    of the earlier accelerator's runtime on very long programs."""
    from ..fea.bc import apply_bc
    from ..ops.block_tridiag import (
        BlockCyclicFactor, BlockThomasFactor, BlockTridiagonalMatrix)

    sg = jax.lax.stop_gradient

    def _fill(tarr, consts):
        p = fill_params(tarr, consts)
        u0 = apply_bc(jnp.zeros(n_dofs, config.jdtype), free, bv)
        mat = tpl.matrix(jac_blocks(u0, p), dest=sg(consts["__bt_dest__"]))
        return mat.D, mat.L, mat.U

    def _bt_equil(D, L, U):
        """Symmetric Jacobi equilibration in block layout: returns the
        scaled blocks of S A S and the scale S (nb, B).  Mandatory before
        an f32 factor: raw-scaled RM blocks have cond ~1e9-1e10 (an
        unequilibrated f32 factor is garbage — measured: PCG plateaus at
        1e-2 no matter how many polish iterations); equilibrated cond is
        ~1e6-1e7, inside f32 preconditioner range."""
        dg = jnp.abs(jnp.diagonal(D, axis1=1, axis2=2))
        sb = jnp.where(dg > 0, 1.0 / jnp.sqrt(jnp.where(dg > 0, dg, 1.0)),
                       1.0)
        sm = jnp.roll(sb, 1, axis=0).at[0].set(0.0)
        sp = jnp.roll(sb, -1, axis=0).at[-1].set(0.0)
        Ds = D * sb[:, :, None] * sb[:, None, :]
        Ls = L * sb[:, :, None] * sm[:, None, :]
        Us = U * sb[:, :, None] * sp[:, None, :]
        return Ds, Ls, Us, sb

    _mixed = factor_compute_dtype == "mixed"

    def _fmat(D, L, U):
        # factor_compute_dtype="float32": the WHOLE factor recursion runs
        # f32 on the Jacobi-EQUILIBRATED operator, not just the store.
        # The factor only serves as the PCG-polish preconditioner on the
        # f64 operator, so f32 arithmetic costs preconditioner quality,
        # not solution accuracy.
        # factor_compute_dtype="mixed": the Schur CHAIN stays f64 on the
        # RAW operator, only each block INVERSE is seeded in f32 (on a
        # per-block diagonally-scaled copy, inside _inv_block_mixed) and
        # Newton-Schulz-refined in f64 matmuls, with the factor and solve
        # path bit-compatible with the exact-f64 production path.  The
        # earlier whole-operator equilibration + scale-conjugated solve
        # converged the anchor to a wrong coupled fixed point even though
        # the mixed inverses matched the exact recursion at the f32-store
        # floor — the conjugated preconditioner itself was the problem,
        # so mixed no longer equilibrates.
        if factor_compute_dtype is not None and not _mixed:
            Ds, Ls, Us, _ = _bt_equil(D, L, U)
            dt = jnp.dtype(factor_compute_dtype)
            D, L, U = Ds.astype(dt), Ls.astype(dt), Us.astype(dt)
        return BlockTridiagonalMatrix(D, L, U, tpl.perm_full, tpl.n)

    _store = (factor_store_dtype
              if factor_compute_dtype is None or _mixed else None)
    # per-block singularity rescue on the low-precision recursion: at
    # anchor scale (nb=7246) the plain f32 recursion drifted ONE Schur
    # block to singular-to-f32 and NaN'd the whole factor (measured:
    # factor_core 64.7 s -> 1.05 s but tip_disp NaN); the guard shift-
    # regularizes only the offending block (see _inv_block_guarded).
    # The mixed recursion has its own residual-checked f64 fallback.
    _guard = factor_compute_dtype is not None and not _mixed
    _mns = mixed_ns if _mixed else 0

    def _factor_core(D, L, U):
        fac = _fmat(D, L, U).factor(_store, spd=True, guard=_guard,
                                    mixed_ns=_mns, mixed_tol=mixed_tol)
        return fac.Sinv, fac.C

    def _factor_core_chunked(D, L, U):
        fac = _fmat(D, L, U).factor_chunked(_store, spd=True, chunk=2048,
                                            guard=_guard, mixed_ns=_mns,
                                            mixed_tol=mixed_tol)
        return fac.Sinv, fac.C

    def _factor_core_cr(D, L, U):
        # log2(nb)-level batched reduction: latency-optimal for the FSI
        # regime (B=128, nb~7k) where the Thomas scan is dependency-bound
        fac = _fmat(D, L, U).factor_cr(_store, spd=True, mixed_ns=_mns,
                                       mixed_tol=mixed_tol)
        return fac.levels, fac.Dinv_root

    def _factor_core_cr_chunked(D, L, U):
        # per-level programs with donated reduced operators: in the fused
        # whole-factor CR program every level's live set coexists, which
        # did not fit a 16 GB device at the anchor; host-chunking caps it
        # at one level's working set (~8 GB at level 0)
        fac = _fmat(D, L, U).factor_cr_chunked(
            _store, spd=True, mixed_ns=_mns, mixed_tol=mixed_tol)
        return fac.levels, fac.Dinv_root

    if factor_compute_dtype is not None and not _mixed \
            and factor_method == "cr":
        raise ValueError("factor_compute_dtype='float32' requires "
                         "factor_method='thomas' (the CR factor has no "
                         "equilibrated-scale solve path); "
                         "factor_compute_dtype='mixed' works with both")
    fill_jit = jax.jit(_fill)
    if factor_method == "cr":
        factor_core_jit = (jax.jit(_factor_core_cr) if tpl.nb <= 4096
                           else _factor_core_cr_chunked)
    elif tpl.nb <= 4096:
        factor_core_jit = jax.jit(_factor_core)
    else:
        factor_core_jit = _factor_core_chunked

    def factor_jit(tarr, consts):
        D, L, U = fill_jit(tarr, consts)
        return (D, L, U) + tuple(factor_core_jit(D, L, U))

    def unpack(carry):
        D, L, U = carry[:3]
        mat = BlockTridiagonalMatrix(D, L, U, tpl.perm_full, tpl.n)
        if factor_method == "cr":
            levels, Dinv_root = carry[3:]
            n2 = 1 << max(tpl.nb - 1, 0).bit_length()
            return mat, BlockCyclicFactor(mat, levels, Dinv_root, n2)
        Sinv, C = carry[3:]
        if factor_compute_dtype is None or _mixed:
            # mixed factors the RAW operator (per-block scaling lives
            # inside the block inverses) — plain sweeps, same as f64
            return mat, BlockThomasFactor(mat, Sinv, C)
        # recompute the equilibration scale + scaled lower blocks from
        # the carry (deterministic from D/L; XLA dead-code-eliminates
        # the unused scaled D/U)
        _, Ls, _, sb = _bt_equil(D, L, U)
        dt = jnp.dtype(factor_compute_dtype)
        return mat, BlockThomasFactor(
            mat, Sinv, C, sweep_dtype=factor_compute_dtype,
            scale=sb, Lfac=Ls.astype(dt))

    return fill_jit, factor_core_jit, factor_jit, unpack


def build_fsi_jit_step(n_shell=(16, 24), n_vlm=(4, 16), span=4.0,
                       chord=1.0, E=7e10, nu=0.3, thickness=0.01,
                       rho_air=1.225, v_inf=(20.0, 0.0, 2.0),
                       rho_s=2700.0, gs_inner=4, relax=0.7,
                       pcg_iters=4, factor_store_dtype="float32",
                       assembly_chunk: int | None = None,
                       sweeps: str = "scan", adj_passes: int = 24,
                       objective: str = "tip",
                       factor_method: str = "thomas",
                       factor_compute_dtype=None, mixed_ns: int = 3,
                       mixed_tol: float = 1e-7,
                       accel: str = "none",
                       pcg_rtol: float | None = None,
                       pcg_maxiter: int = 60):
    """Reference-scale static aeroelastic FSI, fully jitted on device.

    Three jitted programs sharing a device-resident factorization carry
    (the fused whole-loop program would hold factor + assembly buffers
    simultaneously, which exceeded a 16 GB device in f64 at the
    107k-element scale -- same split as build_shell_jit_step):

      factor(tarr, consts) -> carry          one block-Thomas factor
      gs(carry, tarr, d, consts)             gs_inner damped GS passes
          -> (d_new, rel_delta)                (VLM + RHS + triangular
                                               sweeps per pass; NO
                                               refactorization)
      finalize(carry, tarr, d, consts)       converged outputs + force-
          -> outputs dict                      conservation check

    Matches run_aeroelasticity_static_w_feedback.py:346-355 (NonlinearBlockGS
    over vlm -> force map -> shell -> disp map) at its :55 mesh scale.

    accel="aitken": Irons-Tuck dynamic relaxation on both the forward GS
    and the adjoint transpose iteration — a secant estimate of the
    optimal relaxation from two dot products per pass, converging in
    fewer of the anchor's 16-second passes than any fixed damping.

    pcg_rtol: when set, every inner shell solve (forward GS passes,
    finalize, adjoint transpose passes) runs PCG TO TOLERANCE
    (while_loop, capped at pcg_maxiter) instead of the fixed pcg_iters
    polish — the reference's converged-solve semantics (SNES atol/rtol
    1e-13, utils_dolfinx.py:377-379).  This is the admissibility switch
    for low-precision factors at the anchor: the coupled GS fixed point
    shifts under the systematic error of a TRUNCATED low-precision
    solve (tip 17.67/21.88 vs f64's 16.56 measured), but a converged
    inner solve leaves no bias, so factor_compute_dtype="mixed" and/or
    factor_method="cr" become safe speed levers.
    """
    from ..fea.assemble import compile_form
    from ..fea.bc import apply_bc, constrain_residual
    from ..ops.block_tridiag import pcg_fixed, pcg_tol

    if objective not in ("tip", "compliance"):
        raise ValueError(f"objective must be 'tip' or 'compliance', "
                         f"got {objective!r}")
    if factor_method not in ("thomas", "cr"):
        raise ValueError(f"factor_method must be 'thomas' or 'cr', "
                         f"got {factor_method!r}")
    if accel not in ("none", "aitken"):
        raise ValueError(f"accel must be 'none' or 'aitken', got {accel!r}")
    if sweeps == "pallas" and factor_method != "thomas":
        raise ValueError("sweeps='pallas' requires factor_method='thomas' "
                         "(the Pallas kernels implement the Thomas sweeps)")
    if sweeps == "pallas" and pcg_iters == 0 and pcg_rtol is None \
            and config.jdtype == jnp.float64:
        # see implicit.py: the f32 pallas sweeps are preconditioner-only
        # in f64 — without the PCG polish the truncated solve is final
        raise ValueError(
            "sweeps='pallas' in f64 requires pcg_iters > 0: the f32 "
            "sweep result must be polished against the f64 operator")
    mesh, shell, state = _wing_shell_system(
        n_shell, span, chord, E, nu, rho_s)
    if assembly_chunk is None and mesh.n_cells > 30000:
        # bound the vmapped-jacfwd assembly temporaries: XLA's tiled
        # layouts pad their small trailing dims 19-28x at O(10^5) cells
        # (measured 30 GB HBM for the whole-mesh 107k-cell Jacobian)
        assembly_chunk = 8192
    free, bv = state.free, state.bc_values
    off_th = shell.Vu.n_dofs
    n_dofs = state.n_dofs
    n_nodes = mesh.n_nodes

    ucf = compile_form(shell.res_u)
    tcf = compile_form(shell.res_th)
    ccf = compile_form(shell.compliance_form)

    vlm, lat0, vvec, consts = _vlm_and_maps(
        mesh, shell, n_vlm, span, chord, rho_air, v_inf)
    consts["__data_u__"] = ucf.term_data()
    consts["__data_th__"] = tcf.term_data()
    consts["__data_c__"] = ccf.term_data()

    sg = jax.lax.stop_gradient

    def _vals(x, p):
        return {"u": x[:off_th], "theta": x[off_th:],
                "thickness": p["thickness"], "force": p["force"]}

    def residual(x, p):
        vals = _vals(x, p)
        r_u = ucf.vector_from_data(vals, sg(p["__data_u__"]),
                                   chunk=assembly_chunk)
        r_t = tcf.vector_from_data(vals, sg(p["__data_th__"]),
                                   chunk=assembly_chunk)
        return jnp.concatenate([r_u, r_t])

    def jac_blocks(x, p):
        vals = _vals(x, p)
        blocks = []
        for cf, key, roff in ((ucf, "__data_u__", 0),
                              (tcf, "__data_th__", off_th)):
            datas = sg(p[key])
            for cname, coff in (("u", 0), ("theta", off_th)):
                for A, rows, cols in cf.matrix_blocks_from_data(
                        vals, cname, datas, chunk=assembly_chunk):
                    blocks.append((A, rows + roff, cols + coff))
        return blocks

    tpl = _composite_bt_template(ucf, tcf, off_th, n_dofs, free)
    consts["__bt_dest__"] = tpl.dest

    if pcg_rtol is not None:
        # sequential-depth guard: one GS program runs gs_inner passes,
        # each worst-casing pcg_maxiter iterations of 2 length-nb sweeps;
        # the earlier accelerator's runtime faulted past ~1M sequential
        # steps.  Clamp so the worst case stays under ~6e5 (whether the
        # GPU needs it is ROADMAP design item 1).
        cap = max(2, int(6e5 // (max(gs_inner, 1) * 2 * tpl.nb)))
        if pcg_maxiter > cap:
            print(f"[fsi] clamping pcg_maxiter {pcg_maxiter} -> {cap} "
                  f"(sequential-depth guard at nb={tpl.nb}, "
                  f"gs_inner={gs_inner})", flush=True)
            pcg_maxiter = cap
        if pcg_rtol < 1e-9:
            # attainable relative residual is ~eps_f64 * cond; the shell
            # composite sits at cond ~1e9, so tighter targets just run
            # every solve to maxiter (and re-trigger the depth fault)
            print(f"[fsi] pcg_rtol={pcg_rtol:g} is below the "
                  "f64-attainable floor at shell conditioning; solves "
                  "will stop on stagnation/maxiter instead", flush=True)

    zero_f = asdev(np.zeros(shell.Vf.n_dofs, config.dtype))
    tip_idx = int(np.argmax(mesh.coords[:, 1]))
    lshape = lat0.shape
    n_lat = int(np.prod(lshape[:-1]))

    def _fill_params(tarr, consts):
        p = dict(consts)
        p["thickness"] = tarr
        p["force"] = zero_f
        return p

    fill_jit, factor_core_jit, factor_jit, _unpack = _bt_factor_programs(
        tpl, jac_blocks, _fill_params, n_dofs, free, bv,
        factor_store_dtype, factor_method=factor_method,
        factor_compute_dtype=factor_compute_dtype, mixed_ns=mixed_ns,
        mixed_tol=mixed_tol)

    def _solve_shell(mat, fac, tarr, farr, consts):
        p = dict(consts)
        p["thickness"] = tarr
        p["force"] = farr
        u0 = apply_bc(jnp.zeros(n_dofs, config.jdtype), free, bv)
        Rc = constrain_residual(residual(u0, p), u0, free, bv)
        # sweeps="pallas": Pallas-Triton triangular sweeps (f32 — same
        # precision as the factor store) in the PRECONDITIONER role only;
        # the PCG polish runs on the f64 operator, so accuracy is
        # unchanged (ops/pallas_bt.py)
        slv = fac.solve_pallas if sweeps == "pallas" else fac.solve
        du = slv(-Rc)
        if pcg_rtol is not None:
            du, _, _ = pcg_tol(mat, None, -Rc, rtol=pcg_rtol,
                               maxiter=pcg_maxiter, x0=du, M=slv)
        elif pcg_iters > 0:
            du = pcg_fixed(mat, None, -Rc, pcg_iters, x0=du, M=slv)
        return apply_bc(u0 + du, free, bv)

    def _one_pass(mat, fac, tarr, d, consts):
        nodes = lat0 + d.reshape(lshape)
        aero = vlm.solve(nodes, vvec)
        traction = consts["__fmapW__"] @ aero["forces"]  # (n_nodes, 3)
        x = _solve_shell(mat, fac, tarr, traction.reshape(-1), consts)
        u_nodes = x[:off_th].reshape(-1, 3)[:n_nodes]
        return (consts["__dmapW__"] @ u_nodes).reshape(-1), x, aero, traction

    def _gs(carry, tarr, d, consts):
        mat, fac = _unpack(carry)

        if accel == "aitken":
            # Aitken dynamic relaxation (Irons-Tuck): om_k is the secant
            # estimate of the optimal relaxation for the fixed point
            # d <- G(d), updated from two residuals per pass at the cost
            # of two dot products — a jittable, JAX replacement
            # for the reference's fixed NonlinearBlockGS damping
            # (run_aeroelasticity_static_w_feedback.py:346-355).  The
            # Aitken state resets each gs() call (pass 1 of gs_inner uses
            # the base relax), so the program signature is unchanged.
            def body(i, c):
                dd, r_prev, om, _ = c
                g_new = _one_pass(mat, fac, tarr, dd, consts)[0]
                r = g_new - dd
                dr = r - r_prev
                denom = jnp.dot(dr, dr)
                om_a = -om * jnp.dot(r_prev, dr) / jnp.maximum(
                    denom, jnp.finfo(r.dtype).tiny)
                om_new = jnp.where(
                    (i > 0) & (denom > 0.0),
                    jnp.clip(om_a, 0.05, 1.95), om)
                delta = (jnp.linalg.norm(r)
                         / (jnp.linalg.norm(g_new) + 1e-30))
                return dd + om_new * r, r, om_new, delta

            d1, _, _, delta = jax.lax.fori_loop(
                0, gs_inner, body,
                (d, jnp.zeros_like(d), jnp.asarray(relax, config.jdtype),
                 jnp.asarray(0.0, config.jdtype)))
            return d1, delta

        def body(i, c):
            dd, _ = c
            d_new = _one_pass(mat, fac, tarr, dd, consts)[0]
            delta = (jnp.linalg.norm(d_new - dd)
                     / (jnp.linalg.norm(d_new) + 1e-30))
            return (1.0 - relax) * dd + relax * d_new, delta

        d1, delta = jax.lax.fori_loop(
            0, gs_inner, body, (d, jnp.asarray(0.0, config.jdtype)))
        return d1, delta

    def _finalize(carry, tarr, d, consts):
        mat, fac = _unpack(carry)
        _, x, aero, traction = _one_pass(mat, fac, tarr, d, consts)
        u_nodes = x[:off_th].reshape(-1, 3)[:n_nodes]
        compliance = ccf.scalar_from_data(
            {"u": x[:off_th], "force": traction.reshape(-1)},
            sg(consts["__data_c__"]))
        return dict(
            tip_disp=u_nodes[tip_idx, 2],
            total_aero_force=aero["total"],
            total_mapped_force=jnp.sum(
                traction * consts["__area__"][:, None], axis=0),
            compliance=compliance,
            x=x,
        )

    # -- coupled adjoint (IFT through the aeroelastic fixed point) --------
    # The converged composite state x* satisfies S(x, t) = 0 with
    #   S(x, t) = constrain(R_shell(x; t, force = trac(x)))
    #   trac(x) = fmapW @ VLM_forces(lat0 + dmapW @ u_nodes(x))
    # (the reference FD-checks exactly these coupled totals,
    # run_aeroelasticity_static_w_feedback.py:399-428).  Adjoint:
    # (dS/dx)^T lam = dJ/dx, then dJ/dt = -lam^T dS/dt.  dS/dx = Kc - E
    # where Kc is the factored constrained stiffness already in the GS
    # carry, so lam is solved by the SAME relaxed factor-reuse iteration
    # as the forward loop:  lam <- Kc^{-T} (g + E^T lam), with
    # E^T lam = Kc^T lam - (dS/dx)^T lam evaluated by one jax.vjp through
    # (chunked assembly + VLM solve + RBF maps).  Contraction factor
    # equals the forward GS map's spectral radius (transpose-similar).
    def _S(x, tarr, consts):
        u_nodes = x[:off_th].reshape(-1, 3)[:n_nodes]
        d = (consts["__dmapW__"] @ u_nodes).reshape(-1)
        nodes = lat0 + d.reshape(lshape)
        aero = vlm.solve(nodes, vvec)
        traction = consts["__fmapW__"] @ aero["forces"]
        p = dict(consts)
        p["thickness"] = tarr
        p["force"] = traction.reshape(-1)
        return constrain_residual(residual(x, p), x, free, bv)

    def _J(x, consts):
        if objective == "tip":
            return x[:off_th].reshape(-1, 3)[:n_nodes][tip_idx, 2]
        # aeroelastic compliance: force recomputed from x (differentiable)
        u_nodes = x[:off_th].reshape(-1, 3)[:n_nodes]
        d = (consts["__dmapW__"] @ u_nodes).reshape(-1)
        aero = vlm.solve(lat0 + d.reshape(lshape), vvec)
        traction = consts["__fmapW__"] @ aero["forces"]
        return ccf.scalar_from_data(
            {"u": x[:off_th], "force": traction.reshape(-1)},
            sg(consts["__data_c__"]))

    # Aero-coupling operator WITHOUT per-pass assembly: R_u is LINEAR in
    # the force coefficient, so Fm = dR_u/d(force) (the negative
    # mass-type load operator) is CONSTANT — purely geometric, independent
    # of x/t/f.  Assembled by its own jitted program, cached after the
    # first adjoint call, and passed into the adjoint program as element
    # blocks.  Each transpose pass is then
    #   E^T lam |_free = -(dT/dx)^T (Fm^T lam_u)
    # with T(x) the traction chain (VLM + RBF maps, a small dense vjp) —
    # vs. a full vjp through the RM-energy assembly per pass.
    # (E^T's only other nonzero block, -(I-P) K^T P lam, lives on
    # constrained rows; lam there never feeds back into the free
    # iteration nor into dJ/dt, whose constrained rows of dS/dt are zero.)
    def _fm_blocks(consts):
        zx = jnp.zeros(n_dofs, config.jdtype)
        vals0 = {"u": zx[:off_th], "theta": zx[off_th:],
                 "thickness": jnp.zeros(shell.Vt.n_dofs, config.jdtype),
                 "force": jnp.zeros(shell.Vf.n_dofs, config.jdtype)}
        return [
            (A.reshape(A.shape[0], rows.shape[1], cols.shape[1]),
             rows, cols)
            for A, rows, cols in ucf.matrix_blocks_from_data(
                vals0, "force", sg(consts["__data_u__"]),
                chunk=assembly_chunk)]

    fm_jit = jax.jit(_fm_blocks)
    _fm_cache: list = []

    def _fm(consts):
        if not _fm_cache:
            _fm_cache.append(fm_jit(consts))
        return _fm_cache[0]

    def _make_G(carry, x, consts, fm_blocks):
        """Adjoint pass operator G(lam, g) = Kc^{-1}(g + E^T lam) plus the
        PCG-polished inverse, traced inside each adjoint program."""
        from ..fea.assemble import ElementMatrix, MatBlock

        mat, fac = _unpack(carry)
        slv = fac.solve_pallas if sweeps == "pallas" else fac.solve

        def inv(b):  # K_c^{-1} b, PCG-polished like the forward solves
            z = slv(b)
            if pcg_rtol is not None:
                z, _, _ = pcg_tol(mat, None, b, rtol=pcg_rtol,
                                  maxiter=pcg_maxiter, x0=z, M=slv)
            elif pcg_iters > 0:
                z = pcg_fixed(mat, None, b, pcg_iters, x0=z, M=slv)
            return z

        Fm = ElementMatrix([MatBlock(*b) for b in fm_blocks],
                           off_th, shell.Vf.n_dofs)

        def trac_vec(xx):
            u_nodes = xx[:off_th].reshape(-1, 3)[:n_nodes]
            d = (consts["__dmapW__"] @ u_nodes).reshape(-1)
            aero = vlm.solve(lat0 + d.reshape(lshape), vvec)
            return (consts["__fmapW__"] @ aero["forces"]).reshape(-1)

        _, vjpT = jax.vjp(trac_vec, x)
        free_j = jnp.asarray(free)

        def _G(lam, g):
            lam_u = jnp.where(free_j, lam, 0.0)[:off_th]
            et_lam = -vjpT(Fm.rmatvec(lam_u))[0]
            return inv(g + et_lam)

        return inv, _G

    # The adjoint relaxation is split into host-looped chunk programs
    # (the factor_chunked pattern): adj_passes=24 passes in ONE program
    # is ~1.8M sequential scan steps at the anchor (10 nb-deep sweeps per
    # pass x nb=7246), which faulted the earlier accelerator's runtime,
    # while the forward GS programs (4 passes, ~300k steps) ran fine —
    # so past nb=4096 the adjoint runs gs_inner passes per program.
    def _adj_init(carry, x, consts, fm_blocks):
        inv, _ = _make_G(carry, x, consts, fm_blocks)
        g = jax.grad(_J)(x, consts)
        return g, inv(g)

    def _adj_chunk(n):
        def chunk(carry, x, consts, fm_blocks, g, lam, r_prev, om, i0):
            _, G = _make_G(carry, x, consts, fm_blocks)
            if accel == "aitken":
                # same Irons-Tuck secant relaxation as the forward loop;
                # the adjoint fixed point is linear in lam so Aitken is
                # exact on a dominant error mode per update
                def body(i, c):
                    lam, r_prev, om, _ = c
                    r = G(lam, g) - lam
                    dr = r - r_prev
                    denom = jnp.dot(dr, dr)
                    om_a = -om * jnp.dot(r_prev, dr) / jnp.maximum(
                        denom, jnp.finfo(r.dtype).tiny)
                    om_new = jnp.where(
                        (i0 + i > 0) & (denom > 0.0),
                        jnp.clip(om_a, 0.05, 1.95), om)
                    delta = (jnp.linalg.norm(r)
                             / (jnp.linalg.norm(lam + r) + 1e-30))
                    return lam + om_new * r, r, om_new, delta
            else:
                def body(i, c):
                    lam, r_prev, om, _ = c
                    lam_new = (1.0 - relax) * lam + relax * G(lam, g)
                    delta = (jnp.linalg.norm(lam_new - lam)
                             / (jnp.linalg.norm(lam_new) + 1e-30))
                    return lam_new, r_prev, om, delta

            return jax.lax.fori_loop(
                0, n, body,
                (lam, r_prev, om, jnp.asarray(0.0, config.jdtype)))

        return jax.jit(chunk)

    def _adj_fin(tarr, x, consts, lam):
        _, vjpS = jax.vjp(lambda xx, tt: _S(xx, tt, consts), x, tarr)
        _, dt = vjpS(lam)
        return _J(x, consts), -dt

    gs_jit = jax.jit(_gs)
    final_jit = jax.jit(_finalize)
    _adj_init_jit = jax.jit(_adj_init)
    _adj_fin_jit = jax.jit(_adj_fin)
    _adj_chunk_jits: dict = {}
    adj_chunk_size = adj_passes if tpl.nb <= 4096 else max(1, gs_inner)

    def adjoint(carry, tarr, x, consts):
        """Coupled IFT adjoint -> (J, dJ/d(thickness), adj_delta); the
        constant force-load operator is assembled once and cached.
        adj_delta is the relative lambda increment of the LAST pass —
        the adjoint analogue of the forward rel_delta.  (The raw
        residual ||(dS/dx)^T lam - g|| is NOT a usable diagnostic: it
        amplifies lambda error by ||K|| ~ 1e9 of the stiff RM operator,
        so even a 1e-10-accurate lam shows O(1) raw residual with the
        f32-store factor while the thickness gradient matches the f64
        factor to 1e-6 — measured on the (8,12) wing.)"""
        fmb = _fm(consts)
        g, lam = _adj_init_jit(carry, x, consts, fmb)
        r_prev = jnp.zeros_like(lam)
        om = jnp.asarray(relax, config.jdtype)
        adel = jnp.asarray(0.0, config.jdtype)
        done = 0
        while done < adj_passes:
            n = min(adj_chunk_size, adj_passes - done)
            if n not in _adj_chunk_jits:
                _adj_chunk_jits[n] = _adj_chunk(n)
            lam, r_prev, om, adel = _adj_chunk_jits[n](
                carry, x, consts, fmb, g, lam, r_prev, om,
                jnp.asarray(done))
            jax.block_until_ready(adel)
            done += n
        J, dJdt = _adj_fin_jit(tarr, x, consts, lam)
        return J, dJdt, adel

    def _solve_impl(tarr, rounds, report):
        carry = factor_jit(tarr, consts)
        d = jnp.zeros(n_lat * 3, config.jdtype)
        delta = None
        for r in range(rounds):
            d, delta = gs_jit(carry, tarr, d, consts)
            if report:
                print(f"  gs round {r + 1}: rel_delta={float(delta):.3e}")
        out = final_jit(carry, tarr, d, consts)
        out["rel_delta"] = delta
        return out, carry

    def solve_coupled(tarr, rounds=3, report=False):
        """Eager driver: factor once, run `rounds` x gs_inner GS passes
        (carry stays device-resident between program calls), finalize.
        The multi-GB factorization carry is NOT kept in the output."""
        out, _ = _solve_impl(tarr, rounds, report)
        return out

    def solve_with_grad(tarr, rounds=3, report=False):
        """One coupled OPT ITERATION: forward fixed point + IFT adjoint
        reusing the forward factorization (K^T = K).  Returns the
        forward outputs plus d(objective)/d(thickness) over the full
        per-dof thickness vector."""
        out, carry = _solve_impl(tarr, rounds, report)
        J, dJdt, adj_delta = adjoint(carry, tarr, out["x"], consts)
        out["objective"] = J
        out["grad_thickness"] = dJdt
        out["adj_delta"] = adj_delta
        return out

    t0 = asdev(np.full(shell.Vt.n_dofs, thickness, config.dtype))
    return dict(mesh=mesh, shell=shell, state=state, consts=consts,
                factor=factor_jit, fill=fill_jit,
                factor_core=factor_core_jit,
                gs=gs_jit, finalize=final_jit, adjoint=adjoint,
                solve=solve_coupled, solve_with_grad=solve_with_grad,
                t0=t0, n_dofs=n_dofs,
                n_cells=mesh.n_cells, n_panels=n_vlm[0] * n_vlm[1],
                lat0=lat0, tpl=tpl,
                # stage-level access for profiling/diagnostics
                residual=residual, vlm=vlm, vvec=vvec, ucf=ucf, tcf=tcf)


def build_dynamic_fsi_jit_step(n_shell=(16, 24), n_vlm=(4, 16), span=4.0,
                               chord=1.0, E=7e10, nu=0.3, thickness=0.01,
                               rho_air=1.225, v_inf=(20.0, 0.0, 2.0),
                               rho_s=2700.0, dt=0.01, fsi_iters=3,
                               pcg_iters=4,
                               factor_store_dtype="float32",
                               assembly_chunk: int | None = None,
                               gust=one_cosine_gust,
                               factor_method: str = "thomas",
                               factor_compute_dtype=None,
                               adj_passes: int = 6,
                               external_loads: bool = False):
    """Reference-ladder dynamic aeroelasticity (gust response), fully
    jitted per-step on device.

    external_loads=True is the W9 regime (VPM restart-file loads,
    reference run_aeroelasticity_vpm.py:15-25): the aero forces are a
    PRESCRIBED per-step (n_panels, 3) series instead of the coupled VLM,
    so the inner FSI fixed point collapses to one implicit-midpoint
    solve per step and the trajectory adjoint needs no aero fixed point
    — run/run_with_grad then take `forces_series` of shape
    (n_steps, n_panels, 3) sampled at the step midpoints, and
    run_with_grad additionally returns grad_forces = dJ/d(series)
    (d(objective)/d(restart loads) — beyond the reference, whose VPM
    loads are outside its CSDL tape).

    Implicit midpoint (run_aeroelasticity_dynamic.py:197-208): the dynamic
    operator A = (2 rho t / dt^2) M + K/2 is CONSTANT in time for fixed
    thickness/dt, so it is block-Thomas-factored ONCE and every time step
    (and every inner FSI pass within it) is VLM + RHS assembly + block
    triangular sweeps -- vs the reference's per-step per-pass Newton+MUMPS
    custom_solve loop (:272-391).  One gust run at the 77,020-element rung
    of the :51-55 mesh ladder is the VERDICT r2 item-7 target.

      factor(tarr, consts) -> carry
      step(carry, tarr, u_old, th_old, v_old, d, t_mid, consts)
          -> (u_new, th_new, v_new, d_new, tip_disp)
    """
    from ..fea.assemble import compile_form
    from ..fea.bc import apply_bc, constrain_residual
    from ..fea.space import Function
    from ..ops.block_tridiag import pcg_fixed
    from .shell import local_frame, shell_energy_density

    if factor_method not in ("thomas", "cr"):
        raise ValueError(f"factor_method must be 'thomas' or 'cr', "
                         f"got {factor_method!r}")
    mesh, shell, state = _wing_shell_system(
        n_shell, span, chord, E, nu, rho_s)
    if assembly_chunk is None and mesh.n_cells > 30000:
        # bound the vmapped-jacfwd assembly temporaries: XLA's tiled
        # layouts pad their small trailing dims 19-28x at O(10^5) cells
        # (measured 30 GB HBM for the whole-mesh 107k-cell Jacobian)
        assembly_chunk = 8192
    free, bv = state.free, state.bc_values
    off_th = shell.Vu.n_dofs
    n_dofs = state.n_dofs
    n_nodes = mesh.n_nodes

    u_old_f = Function(shell.Vu, "u_old")
    th_old_f = Function(shell.Vth, "theta_old")
    v_old_f = Function(shell.Vu, "v_old")
    rho_t = shell.rho
    E_, nu_, drill_ = shell.E, shell.nu, shell.drill
    dt_ = float(dt)

    # midpoint residual: R(u_new) = rho t (v_new - v_old)/dt . w
    #   + dPsi((u_new + u_old)/2) . w - f_mid . w,  v_new = 2(du)/dt - v_old
    def r_u_dyn(w, g):
        frame = local_frame(g.J)
        uv = 0.5 * (w.u.val + w.u_old.val)
        ug = 0.5 * (w.u.grad + w.u_old.grad)
        tv = 0.5 * (w.theta.val + w.theta_old.val)
        tg = 0.5 * (w.theta.grad + w.theta_old.grad)

        def psi(a, b):
            return shell_energy_density(
                a, b, tv, tg, w.thickness.val, frame, E_, nu_, drill_)

        dpsi = jax.jvp(psi, (uv, ug), (w.v.val, w.v.grad))[1]
        accel = (2.0 / dt_**2) * (w.u.val - w.u_old.val) \
            - (2.0 / dt_) * w.v_old.val
        inertia = rho_t * w.thickness.val * jnp.dot(accel, w.v.val)
        return dpsi + inertia - jnp.dot(w.force.val, w.v.val)

    def r_th_dyn(w, g):
        frame = local_frame(g.J)
        uv = 0.5 * (w.u.val + w.u_old.val)
        ug = 0.5 * (w.u.grad + w.u_old.grad)
        tv = 0.5 * (w.theta.val + w.theta_old.val)
        tg = 0.5 * (w.theta.grad + w.theta_old.grad)

        def psi(a, b):
            return shell_energy_density(
                uv, ug, a, b, w.thickness.val, frame, E_, nu_, drill_)

        return jax.jvp(psi, (tv, tg), (w.v.val, w.v.grad))[1]

    coeffs = [shell.u, shell.theta, u_old_f, th_old_f, v_old_f,
              shell.thickness, shell.force]
    res_u = FormDef([dx(r_u_dyn, qdeg=4)], coeffs=coeffs, test=shell.Vu)
    res_th = FormDef([dx(r_th_dyn, qdeg=4)], coeffs=coeffs, test=shell.Vth)
    ucf = compile_form(res_u)
    tcf = compile_form(res_th)

    vlm, lat0, vvec, consts = _vlm_and_maps(
        mesh, shell, n_vlm, span, chord, rho_air, v_inf)
    consts["__data_u__"] = ucf.term_data()
    consts["__data_th__"] = tcf.term_data()

    sg = jax.lax.stop_gradient

    def _vals(x, p):
        return {"u": x[:off_th], "theta": x[off_th:],
                "u_old": p["u_old"], "theta_old": p["theta_old"],
                "v_old": p["v_old"], "thickness": p["thickness"],
                "force": p["force"]}

    def residual(x, p):
        vals = _vals(x, p)
        r_u = ucf.vector_from_data(vals, sg(p["__data_u__"]),
                                   chunk=assembly_chunk)
        r_t = tcf.vector_from_data(vals, sg(p["__data_th__"]),
                                   chunk=assembly_chunk)
        return jnp.concatenate([r_u, r_t])

    def jac_blocks(x, p):
        vals = _vals(x, p)
        blocks = []
        for cf, key, roff in ((ucf, "__data_u__", 0),
                              (tcf, "__data_th__", off_th)):
            datas = sg(p[key])
            for cname, coff in (("u", 0), ("theta", off_th)):
                for A, rows, cols in cf.matrix_blocks_from_data(
                        vals, cname, datas, chunk=assembly_chunk):
                    blocks.append((A, rows + roff, cols + coff))
        return blocks

    tpl = _composite_bt_template(ucf, tcf, off_th, n_dofs, free)
    consts["__bt_dest__"] = tpl.dest

    zero_f = asdev(np.zeros(shell.Vf.n_dofs, config.dtype))
    zero_u = asdev(np.zeros(shell.Vu.n_dofs, config.dtype))
    zero_th = asdev(np.zeros(shell.Vth.n_dofs, config.dtype))
    tip_idx = int(np.argmax(mesh.coords[:, 1]))
    lshape = lat0.shape
    n_lat = int(np.prod(lshape[:-1]))

    def _params(tarr, u_old, th_old, v_old, farr, consts):
        p = dict(consts)
        p.update(thickness=tarr, u_old=u_old, theta_old=th_old,
                 v_old=v_old, force=farr)
        return p

    def _fill_params(tarr, consts):
        # the dynamic Jacobian is independent of the old state / loads
        return _params(tarr, zero_u, zero_th, zero_u, zero_f, consts)

    fill_jit, factor_core_jit, factor_jit, _dyn_unpack = _bt_factor_programs(
        tpl, jac_blocks, _fill_params, n_dofs, free, bv,
        factor_store_dtype, factor_method=factor_method,
        factor_compute_dtype=factor_compute_dtype)

    def _solve_once(carry, tarr, u_old, th_old, v_old, traction, consts):
        """One implicit-midpoint solve under a given nodal traction."""
        mat, fac = _dyn_unpack(carry)
        p = _params(tarr, u_old, th_old, v_old,
                    traction.reshape(-1), consts)
        u0 = apply_bc(jnp.zeros(n_dofs, config.jdtype), free, bv)
        Rc = constrain_residual(residual(u0, p), u0, free, bv)
        du = fac.solve(-Rc)
        if pcg_iters > 0:
            du = pcg_fixed(mat, None, -Rc, pcg_iters, x0=du,
                           M=fac.solve)
        return apply_bc(u0 + du, free, bv)

    def _step_ext(carry, tarr, u_old, th_old, v_old, d, f_mid, consts):
        # external loads are motion-independent: no inner FSI iterations
        traction = consts["__fmapW__"] @ f_mid
        x = _solve_once(carry, tarr, u_old, th_old, v_old, traction,
                        consts)
        u_new = x[:off_th]
        th_new = x[off_th:]
        v_new = 2.0 * (u_new - u_old) / dt_ - v_old
        tip = u_new.reshape(-1, 3)[:n_nodes][tip_idx, 2]
        return u_new, th_new, v_new, d, tip

    def _step(carry, tarr, u_old, th_old, v_old, d, t_mid, consts):
        mat, fac = _dyn_unpack(carry)
        v_now = vvec + jnp.array([0.0, 0.0, 1.0], config.jdtype) \
            * gust(t_mid)

        def one_pass(dd):
            nodes = lat0 + dd.reshape(lshape)
            aero = vlm.solve(nodes, v_now)
            traction = consts["__fmapW__"] @ aero["forces"]
            p = _params(tarr, u_old, th_old, v_old,
                        traction.reshape(-1), consts)
            u0 = apply_bc(jnp.zeros(n_dofs, config.jdtype), free, bv)
            Rc = constrain_residual(residual(u0, p), u0, free, bv)
            du = fac.solve(-Rc)
            if pcg_iters > 0:
                du = pcg_fixed(mat, None, -Rc, pcg_iters, x0=du,
                               M=fac.solve)
            x = apply_bc(u0 + du, free, bv)
            # lattice follows the MIDPOINT configuration
            u_mid = 0.5 * (x[:off_th] + u_old)
            d_new = (consts["__dmapW__"]
                     @ u_mid.reshape(-1, 3)[:n_nodes]).reshape(-1)
            return d_new, x

        def body(i, c):
            dd, _ = c
            return one_pass(dd)

        d_new, x = jax.lax.fori_loop(
            0, fsi_iters, body, (d, jnp.zeros(n_dofs, config.jdtype)))
        u_new = x[:off_th]
        th_new = x[off_th:]
        v_new = 2.0 * (u_new - u_old) / dt_ - v_old
        tip = u_new.reshape(-1, 3)[:n_nodes][tip_idx, 2]
        return u_new, th_new, v_new, d_new, tip

    step_jit = jax.jit(_step_ext if external_loads else _step)

    def run(tarr, n_steps, report=False, forces_series=None):
        """Time march; returns tip-displacement history.

        With external_loads, forces_series is the (n_steps, n_panels, 3)
        midpoint-sampled aero-load series (W9 restart-file regime)."""
        if external_loads and forces_series is None:
            raise ValueError("external_loads build requires forces_series "
                             "(n_steps, n_panels, 3)")
        carry = factor_jit(tarr, consts)
        u_old, th_old, v_old = zero_u, zero_th, zero_u
        d = jnp.zeros(n_lat * 3, config.jdtype)
        hist = {"time": [], "tip_disp": []}
        for n in range(n_steps):
            drive = (jnp.asarray(forces_series[n], config.jdtype)
                     if external_loads
                     else jnp.asarray((n + 0.5) * dt_, config.jdtype))
            u_old, th_old, v_old, d, tip = step_jit(
                carry, tarr, u_old, th_old, v_old, d, drive, consts)
            hist["time"].append((n + 1) * dt_)
            hist["tip_disp"].append(float(tip))
            if report:
                print(f"  step {n + 1}: t={(n + 1) * dt_:.3f} "
                      f"tip={hist['tip_disp'][-1]:.5e}")
        return hist

    # ---- trajectory adjoint (VERDICT r3 item 5) -------------------------
    # Checkpointed discrete adjoint of the implicit-midpoint gust loop
    # (reference runs the forward loop only, run_aeroelasticity_dynamic
    # .py:272-391; its CSDL totals would tape every pass).  Per-step state
    # equation at the converged inner fixed point:
    #   S_n(x_n; x_{n-1}, v_{n-1}, t) =
    #     constrain(residual(x_n, p(t, x_{n-1}, v_{n-1}, trac(u_mid))))
    # with u_mid = (u_n + u_{n-1})/2 driving the VLM traction, plus the
    # explicit update v_n = 2(u_n - u_{n-1})/dt - v_{n-1}.  The dynamic
    # operator A = (2 rho t/dt^2) M + K/2 is constant and symmetric, so
    # EVERY backward step reuses the forward factorization (A^{-T} =
    # A^{-1}); the aero coupling enters the adjoint fixed point exactly
    # as in the static case (fsi.py _adjoint), scaled by the midpoint 1/2
    # inside vjpT.  "Checkpointed" = the forward stores only the per-step
    # states (u, th, v) on host and each backward step re-linearizes from
    # them — O(n_steps) state memory, no taped assembly graph.
    def _S_dyn(x_new, x_old, v_old, tarr, t_mid, consts):
        v_now = vvec + jnp.array([0.0, 0.0, 1.0], config.jdtype) \
            * gust(t_mid)
        u_mid = 0.5 * (x_new[:off_th] + x_old[:off_th])
        dmid = (consts["__dmapW__"]
                @ u_mid.reshape(-1, 3)[:n_nodes]).reshape(-1)
        aero = vlm.solve(lat0 + dmid.reshape(lshape), v_now)
        traction = consts["__fmapW__"] @ aero["forces"]
        p = _params(tarr, x_old[:off_th], x_old[off_th:], v_old,
                    traction.reshape(-1), consts)
        return constrain_residual(residual(x_new, p), x_new, free, bv)

    def _fm_blocks_dyn(consts):
        # dR_u/d(force): constant (force enters linearly), assembled once
        vals0 = {"u": zero_u, "theta": zero_th, "u_old": zero_u,
                 "theta_old": zero_th, "v_old": zero_u,
                 "thickness": jnp.zeros(shell.Vt.n_dofs, config.jdtype),
                 "force": zero_f}
        return [
            (A.reshape(A.shape[0], rows.shape[1], cols.shape[1]),
             rows, cols)
            for A, rows, cols in ucf.matrix_blocks_from_data(
                vals0, "force", sg(consts["__data_u__"]),
                chunk=assembly_chunk)]

    fm_dyn_jit = jax.jit(_fm_blocks_dyn)
    _fm_cache: list = []

    def _fm(consts):
        if not _fm_cache:
            _fm_cache.append(fm_dyn_jit(consts))
        return _fm_cache[0]

    # tip = u[3*tip_idx + 2]: the per-step scalar the trajectory
    # functional consumes (linear in x, so its cotangent is a constant
    # basis vector)
    _tip_e = np.zeros(n_dofs)
    _tip_e[3 * tip_idx + 2] = 1.0
    tip_e = asdev(_tip_e.astype(config.dtype))

    def _adjoint_step(carry, tarr, x_new, x_old, v_old, t_mid,
                      xbar, vbar, consts, fm_blocks):
        from ..fea.assemble import ElementMatrix, MatBlock

        mat, fac = _dyn_unpack(carry)

        def inv(b):  # A^{-1} b, PCG-polished like the forward solves
            z = fac.solve(b)
            if pcg_iters > 0:
                z = pcg_fixed(mat, None, b, pcg_iters, x0=z, M=fac.solve)
            return z

        # fold the explicit v_n update into the x_n cotangent:
        # dv_n/du_n = 2/dt, dv_n/du_{n-1} = -2/dt, dv_n/dv_{n-1} = -1
        pad_v = jnp.concatenate(
            [vbar, jnp.zeros(n_dofs - off_th, config.jdtype)])
        xbar_eff = xbar + (2.0 / dt_) * pad_v
        _, vjpS = jax.vjp(
            lambda xn, xo, vo, tt: _S_dyn(xn, xo, vo, tt, t_mid, consts),
            x_new, x_old, v_old, tarr)
        Fm = ElementMatrix([MatBlock(*b) for b in fm_blocks],
                           off_th, shell.Vf.n_dofs)

        def trac_of_new(xn):
            u_mid = 0.5 * (xn[:off_th] + x_old[:off_th])
            dmid = (consts["__dmapW__"]
                    @ u_mid.reshape(-1, 3)[:n_nodes]).reshape(-1)
            v_now = vvec + jnp.array([0.0, 0.0, 1.0], config.jdtype) \
                * gust(t_mid)
            aero = vlm.solve(lat0 + dmid.reshape(lshape), v_now)
            return (consts["__fmapW__"] @ aero["forces"]).reshape(-1)

        _, vjpT = jax.vjp(trac_of_new, x_new)
        free_j = jnp.asarray(free)

        def _G(lam):
            lam_u = jnp.where(free_j, lam, 0.0)[:off_th]
            et_lam = -vjpT(Fm.rmatvec(lam_u))[0]
            return inv(xbar_eff + et_lam)

        lam0 = inv(xbar_eff)

        # Irons-Tuck relaxed fixed point (static-adjoint pattern); the
        # dynamic operator is mass-dominated so this converges in a few
        # passes per step
        def body(i, c):
            lam, r_prev, om, _ = c
            r = _G(lam) - lam
            dr = r - r_prev
            denom = jnp.dot(dr, dr)
            om_a = -om * jnp.dot(r_prev, dr) / jnp.maximum(
                denom, jnp.finfo(r.dtype).tiny)
            om_new = jnp.where((i > 0) & (denom > 0.0),
                               jnp.clip(om_a, 0.05, 1.95), om)
            delta = (jnp.linalg.norm(r)
                     / (jnp.linalg.norm(lam + r) + 1e-30))
            return lam + om_new * r, r, om_new, delta

        lam, _, _, adj_delta = jax.lax.fori_loop(
            0, adj_passes, body,
            (lam0, jnp.zeros_like(lam0), jnp.asarray(1.0, config.jdtype),
             jnp.asarray(0.0, config.jdtype)))
        _, xo_bar, vo_bar, t_bar = vjpS(lam)
        xbar_old = -(2.0 / dt_) * pad_v - xo_bar
        vbar_old = -vbar - vo_bar
        return xbar_old, vbar_old, -t_bar, adj_delta

    def _S_dyn_ext(x_new, x_old, v_old, tarr, f_mid, consts):
        # external-loads state equation: traction independent of x_new
        traction = consts["__fmapW__"] @ f_mid
        p = _params(tarr, x_old[:off_th], x_old[off_th:], v_old,
                    traction.reshape(-1), consts)
        return constrain_residual(residual(x_new, p), x_new, free, bv)

    def _adjoint_step_ext(carry, tarr, x_new, x_old, v_old, f_mid,
                          xbar, vbar, consts):
        """W9 backward step: no aero fixed point (dS/dx_new has no
        traction term), so lambda is ONE polished solve; vjpS also
        yields dJ/d(f_mid) — the restart-load sensitivity."""
        mat, fac = _dyn_unpack(carry)

        def inv(b):
            z = fac.solve(b)
            if pcg_iters > 0:
                z = pcg_fixed(mat, None, b, pcg_iters, x0=z, M=fac.solve)
            return z

        pad_v = jnp.concatenate(
            [vbar, jnp.zeros(n_dofs - off_th, config.jdtype)])
        xbar_eff = xbar + (2.0 / dt_) * pad_v
        _, vjpS = jax.vjp(
            lambda xn, xo, vo, tt, fm: _S_dyn_ext(xn, xo, vo, tt, fm,
                                                  consts),
            x_new, x_old, v_old, tarr, f_mid)
        lam = inv(xbar_eff)
        _, xo_bar, vo_bar, t_bar, f_bar = vjpS(lam)
        xbar_old = -(2.0 / dt_) * pad_v - xo_bar
        vbar_old = -vbar - vo_bar
        return xbar_old, vbar_old, -t_bar, -f_bar

    adjoint_step_jit = jax.jit(_adjoint_step_ext if external_loads
                               else _adjoint_step)

    def run_with_grad(tarr, n_steps, J_of_tips=None, report=False,
                      carry=None, forces_series=None):
        """Gradient of a trajectory functional J(tip_1..tip_N) w.r.t. the
        per-dof thickness, through the full gust time history.

        J_of_tips: jax function (n_steps,) -> scalar on the tip history;
        default is the smooth max (p-norm, p=8) of |tip| over the gust —
        the 'max tip deflection' objective of the reference's dynamic
        workload.  Pass `carry` to reuse an existing factorization.
        Returns dict with J, tips, grad_thickness, adj_deltas (per-step
        relative lambda increments, backward order) and stage timings
        (forward_s, backward_s, adj_step_s per backward step — the first
        entry includes the adjoint program's compile)."""
        import time as _time

        if J_of_tips is None:
            def J_of_tips(tips):
                return (jnp.mean(jnp.abs(tips) ** 8)) ** 0.125

        if external_loads and forces_series is None:
            raise ValueError("external_loads build requires forces_series "
                             "(n_steps, n_panels, 3)")
        if carry is None:
            carry = factor_jit(tarr, consts)
        t_fwd = _time.perf_counter()
        u_o, th_o, v_o = zero_u, zero_th, zero_u
        d = jnp.zeros(n_lat * 3, config.jdtype)
        states = [(np.asarray(u_o), np.asarray(th_o), np.asarray(v_o))]
        tips = []
        for n in range(n_steps):
            t_mid = (jnp.asarray(forces_series[n], config.jdtype)
                     if external_loads
                     else jnp.asarray((n + 0.5) * dt_, config.jdtype))
            u_o, th_o, v_o, d, tip = step_jit(
                carry, tarr, u_o, th_o, v_o, d, t_mid, consts)
            # host checkpoint: O(n_steps) state memory, frees HBM for the
            # backward re-linearization at the big rungs
            states.append(
                (np.asarray(u_o), np.asarray(th_o), np.asarray(v_o)))
            tips.append(float(tip))
            if report:
                print(f"  fwd step {n + 1}: tip={tips[-1]:.5e}")
        forward_s = _time.perf_counter() - t_fwd
        tips_j = jnp.asarray(np.asarray(tips), config.jdtype)
        J, tipbars = jax.value_and_grad(J_of_tips)(tips_j)
        tipbars = np.asarray(tipbars)

        t_bwd = _time.perf_counter()
        xbar = jnp.zeros(n_dofs, config.jdtype)
        vbar = jnp.zeros(off_th, config.jdtype)
        tbar = jnp.zeros_like(tarr)
        fmb = None if external_loads else _fm(consts)
        adj_deltas = []
        adj_step_s = []
        grad_forces = [None] * n_steps if external_loads else None
        for n in reversed(range(n_steps)):
            u_n, th_n, _ = states[n + 1]
            u_p, th_p, v_p = states[n]
            x_new = jnp.concatenate(
                [jnp.asarray(u_n), jnp.asarray(th_n)])
            x_old = jnp.concatenate(
                [jnp.asarray(u_p), jnp.asarray(th_p)])
            xbar = xbar + tipbars[n] * tip_e
            t_st = _time.perf_counter()
            if external_loads:
                f_mid = jnp.asarray(forces_series[n], config.jdtype)
                xbar, vbar, tinc, finc = adjoint_step_jit(
                    carry, tarr, x_new, x_old, jnp.asarray(v_p), f_mid,
                    xbar, vbar, consts)
                grad_forces[n] = np.asarray(finc)
                adel = 0.0  # single exact solve — no aero fixed point
            else:
                t_mid = jnp.asarray((n + 0.5) * dt_, config.jdtype)
                xbar, vbar, tinc, adel = adjoint_step_jit(
                    carry, tarr, x_new, x_old, jnp.asarray(v_p), t_mid,
                    xbar, vbar, consts, fmb)
            jax.block_until_ready(xbar)
            adj_step_s.append(_time.perf_counter() - t_st)
            tbar = tbar + tinc
            adj_deltas.append(float(adel))
            if report:
                print(f"  adj step {n + 1}: lambda rel-incr="
                      f"{adj_deltas[-1]:.3e} ({adj_step_s[-1]:.2f} s)")
        out = dict(J=float(J), tips=np.asarray(tips),
                   grad_thickness=tbar, adj_deltas=adj_deltas,
                   forward_s=forward_s,
                   backward_s=_time.perf_counter() - t_bwd,
                   adj_step_s=adj_step_s)
        if external_loads:
            out["grad_forces"] = np.asarray(grad_forces)
        return out

    t0 = asdev(np.full(shell.Vt.n_dofs, thickness, config.dtype))
    return dict(mesh=mesh, shell=shell, factor=factor_jit, step=step_jit,
                run=run, run_with_grad=run_with_grad,
                adjoint_step=adjoint_step_jit,
                consts=consts, t0=t0, n_dofs=n_dofs,
                n_cells=mesh.n_cells, dt=dt_, tpl=tpl,
                # external_loads series sizing: (n_steps, n_force_pts, 3)
                n_force_pts=int(np.asarray(consts["__fmapW__"]).shape[1]))
