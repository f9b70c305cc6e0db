"""Chained motor optimization model: shape dv + current -> mesh motion ->
magnetostatics -> losses (workload W5 north-star,
/root/reference/examples/em_motor_opt/run_motor_opt.py).

Graph order parity (run_motor_opt.py:332-347):
  boundary_input_model (shape dv -> uhat_bc scatter)
  -> fea_mm (uhat state, incremental continuation solve :109-166)
  -> source_tables_model (iq, angle -> magnet/winding tables)
  -> fea_em (A_z state, load-stepped continuation solve :231-250)
  -> B-influence outputs + areas -> power_loss_model -> loss_sum objective.

Both states chain through the same named variables, so the IFT adjoint flows
end-to-end (reference chains by registering the mesh-motion state function
as an EM input, run_motor_opt.py:299-304).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ...config import config
from ...utils.arrays import asdev
from ...fea import FEA, Function, FunctionSpace
from ...fea.forms import FormDef, GlobalCoefficient, dx
from ...graph.model import FEAModel
from ...solvers.linear import LinearSolver
from .mesh import MotorTags, RADII, create_motor_mesh
from .pde import (
    NTAGS, area_form, b_power_form, em_residual_form,
    mesh_motion_residual_form, power_losses, source_tables,
)
from .permeability import PiecewiseBHCurve

T = MotorTags


def boundary_displacement_basis(mesh, Vmm):
    """Two displacement basis fields on the magnet-ring interface nodes:
    radial expansion and tangential (rotation-like) shift.

    BoundaryInputModel parity (preprocessor/boundary_input_model.py:34-71):
    a sparse scatter from shape parameters into the full CG1 vector; here
    the scatter matrix is two precomputed basis vectors, so
    uhat_bc = dv[0] * radial + dv[1] * tangential (differentiable matmul).
    """
    coords = Vmm.scalar_dof_coords
    r = np.linalg.norm(coords, axis=1)
    on_iface = (np.isclose(r, RADII["r2"], atol=1e-9)
                | np.isclose(r, RADII["r3"], atol=1e-9))
    rad = np.zeros((Vmm.n_dofs,))
    tan = np.zeros((Vmm.n_dofs,))
    rr = np.where(r > 0, r, 1.0)
    nx, ny = coords[:, 0] / rr, coords[:, 1] / rr
    rad[0::2] = np.where(on_iface, nx, 0.0)
    rad[1::2] = np.where(on_iface, ny, 0.0)
    tan[0::2] = np.where(on_iface, -ny, 0.0)
    tan[1::2] = np.where(on_iface, nx, 0.0)
    return jnp.asarray(np.stack([rad, tan], axis=1), config.jdtype)


def edge_delta_design_space(mesh, Vmm):
    """Wide per-interface-node design space: the dv is a flat vector of
    (x, y) displacement deltas for EVERY magnet-ring interface node,
    scattered sparsely into the full CG1 uhat_bc vector.

    This is the reference's actual design chain (BoundaryInputModel,
    preprocessor/boundary_input_model.py:34-71: `edge_deltas` over all
    moving-interface nodes -> sparse scatter; the fine-mesh delta file has
    thousands of components).  The IFT adjoint's cost is independent of the
    dv count — one transpose solve yields the full wide gradient.

    Returns (scatter_fn, n_dv, iface_nodes, dofs): scatter_fn(dv) ->
    uhat_bc (Vmm.n_dofs,); dv layout is [dx_0, dy_0, dx_1, dy_1, ...]
    over interface nodes in index order, and `dofs` is the matching
    interleaved CG1 dof index array (the single source of truth for the
    dv <-> uhat_bc layout).
    """
    coords = Vmm.scalar_dof_coords
    r = np.linalg.norm(coords, axis=1)
    on_iface = (np.isclose(r, RADII["r2"], atol=1e-9)
                | np.isclose(r, RADII["r3"], atol=1e-9))
    iface_nodes = np.nonzero(on_iface)[0]
    dofs = np.stack([2 * iface_nodes, 2 * iface_nodes + 1],
                    axis=1).reshape(-1)
    dofs_j = jnp.asarray(dofs)
    n_dofs = Vmm.n_dofs

    def scatter(dv):
        return jnp.zeros(n_dofs, config.jdtype).at[dofs_j].set(dv)

    return scatter, int(dofs.size), iface_nodes, dofs_j


def ffd_shape_parameter_layer(mesh, Vmm, n_harmonics: int = 4):
    """Small smooth shape-parameter layer in front of the edge deltas
    (ffd_model.py:55-87 parity: dv -> shape params -> edge_deltas).

    Parameters are radial Fourier coefficients per interface ring:
    delta_r(theta) = sum_k a_k cos(k theta) + b_k sin(k theta), applied
    along the node normal.  Returns (to_deltas, n_params) with
    to_deltas(params) -> edge-delta vector consumable by
    edge_delta_design_space's scatter.
    """
    coords = Vmm.scalar_dof_coords
    r = np.linalg.norm(coords, axis=1)
    scatter, n_dv, iface_nodes, _ = edge_delta_design_space(mesh, Vmm)
    ci = coords[iface_nodes]
    ri = r[iface_nodes]
    th = np.arctan2(ci[:, 1], ci[:, 0])
    ring = (np.isclose(ri, RADII["r3"], atol=1e-9)).astype(int)  # 0=r2,1=r3
    # per-ring Fourier design matrix: (n_iface, 2 rings x (2K+1))
    cols = []
    for rg in (0, 1):
        mask = (ring == rg).astype(float)
        cols.append(mask)
        for k in range(1, n_harmonics + 1):
            cols.append(mask * np.cos(k * th))
            cols.append(mask * np.sin(k * th))
    B = np.stack(cols, axis=1)  # (n_iface, n_params)
    nx, ny = ci[:, 0] / ri, ci[:, 1] / ri
    # radial direction per node, interleaved into the dv layout
    Bd = np.zeros((n_dv, B.shape[1]))
    Bd[0::2] = B * nx[:, None]
    Bd[1::2] = B * ny[:, None]
    Bd = jnp.asarray(Bd, config.jdtype)

    def to_deltas(params):
        return Bd @ params

    return to_deltas, int(B.shape[1])


def make_min_detF(mesh, Vmm):
    """min over cells of det(F(uhat)) — element-inversion detector.

    P1 gradients are cell-constant; precomputed physical basis gradients
    make this one gather + einsum."""
    pts = mesh.coords[mesh.cells]  # (nc, 3, 2)
    e1 = pts[:, 1] - pts[:, 0]
    e2 = pts[:, 2] - pts[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    # inverse-transpose of [e1 e2] applied to reference gradients
    gx = np.stack([e2[:, 1], -e1[:, 1]], axis=1) / det[:, None]
    gy = np.stack([-e2[:, 0], e1[:, 0]], axis=1) / det[:, None]
    # physical gradients of the 3 P1 basis fns: (nc, 3, 2)
    g12 = np.stack([gx, gy], axis=2)  # (nc, 2, 2): rows=ref-basis 1,2
    g0 = -g12.sum(axis=1)
    gradN = np.concatenate([g0[:, None, :], g12], axis=1)
    gradN = jnp.asarray(gradN, config.jdtype)
    dofmap = jnp.asarray(Vmm.dofmap)

    def min_detF(uhat_arr):
        ue = uhat_arr[dofmap].reshape(-1, 3, 2)  # (nc, 3 nodes, 2 comps)
        G = jnp.einsum("cak,cai->cik", ue, gradN)  # grad uhat (nc, 2, 2)
        F00 = 1.0 + G[:, 0, 0]
        F11 = 1.0 + G[:, 1, 1]
        detF = F00 * F11 - G[:, 0, 1] * G[:, 1, 0]
        return jnp.min(detF)

    return min_detF


def make_incremental_mm_solver(min_cell: float, min_detF_fn=None):
    """Displacement-stepped continuation (run_motor_opt.py:109-166:
    STEPS = max(2, ceil(4 * max|delta| / min_cell)))."""

    def solve_incremental(op, inputs, u0):
        g = inputs["uhat_bc"]
        gmax = float(jnp.max(jnp.abs(jax.lax.stop_gradient(g))))
        steps = max(2, int(np.ceil(4.0 * gmax / min_cell)))
        u = u0
        for k in range(steps):
            scaled = dict(inputs)
            scaled["uhat_bc"] = g * ((k + 1) / steps)
            u, fac, info = op.newton(scaled, u, line_search="bt")
            if not info.converged and info.resnorm > 1e-6 * max(
                    info.resnorm0, 1.0):
                import warnings

                warnings.warn(
                    f"mesh-motion continuation step {k + 1}/{steps} did "
                    f"not converge (||R||={info.resnorm:.2e}); the "
                    "prescribed boundary displacement likely crushes the "
                    "mesh — results are unreliable")
        if min_detF_fn is not None:
            mdf = float(jax.lax.stop_gradient(min_detF_fn(u)))
            if mdf <= 0.0:
                import warnings

                warnings.warn(
                    f"mesh motion inverted elements (min det(F) = "
                    f"{mdf:.3e}); downstream EM/loss values are invalid")
        return u

    return solve_incremental


def make_incremental_em_solver(n_steps: int = 5, damping: float = 0.8):
    """Load-stepped EM continuation (run_motor_opt.py:231-250:
    JS_scaler = 1/5, SNES damping ~0.8)."""

    def solve_incremental(op, inputs, u0):
        u = u0
        for k in range(n_steps):
            s = (k + 1) / n_steps
            scaled = dict(inputs)
            scaled["Htable"] = inputs["Htable"] * s
            scaled["Jtable"] = inputs["Jtable"] * s
            u, fac, info = op.newton(scaled, u, damping=damping,
                                     line_search="bt")
            if not info.converged and info.resnorm > 1e-6 * max(
                    info.resnorm0, 1.0):
                import warnings

                warnings.warn(
                    f"EM load step {k + 1}/{n_steps} did not converge "
                    f"(||R||={info.resnorm:.2e})")
        return u

    return solve_incremental


def build_motor_model(refine: int = 1, iq0: float = 1.0e5,
                      angle0: float = 0.0, frequency: float = 300.0,
                      linear_solver: LinearSolver | None = None,
                      em_load_steps: int = 5, record: bool = False,
                      design_space: str = "basis",
                      ffd_harmonics: int | None = None,
                      mesh=None):
    """mesh=None uses the procedural polar mesh; pass an imported Mesh
    (e.g. mesh/gmsh_io.import_mesh of an unstructured .msh with the motor
    tag semantics) for the reference's import-first path
    (run_motor_opt.py:51-59)."""
    if mesh is None:
        mesh = create_motor_mesh(refine)
    Vmm = FunctionSpace(mesh, ("CG", 1), ncomp=2)
    Vem = FunctionSpace(mesh, ("CG", 1))

    uhat = Function(Vmm, "uhat")
    uhat_bc = Function(Vmm, "uhat_bc")
    A_z = Function(Vem, "A_z")
    Htable = GlobalCoefficient("Htable", asdev(np.zeros((NTAGS, 2))))
    Jtable = GlobalCoefficient("Jtable", asdev(np.zeros(NTAGS)))
    bh = PiecewiseBHCurve()

    res_mm = mesh_motion_residual_form(uhat, uhat_bc)
    res_em = em_residual_form(A_z, uhat, Htable, Jtable, bh)

    solver = linear_solver or LinearSolver(method="scipy")

    # -- mesh-motion problem ------------------------------------------------
    fea_mm = FEA(mesh)
    fea_mm.linear_solver = solver
    fea_mm.custom_solve = make_incremental_mm_solver(
        mesh.min_cell_size(), make_min_detF(mesh, Vmm))
    fea_mm.add_input("uhat_bc", uhat_bc, init_val=0.0)
    fea_mm.add_state("uhat", uhat, res_mm, ["uhat_bc"])
    on_rim = lambda x: (
        np.isclose(np.hypot(x[0], x[1]), RADII["r0"], atol=1e-9)
        | np.isclose(np.hypot(x[0], x[1]), RADII["r6"], atol=1e-9))
    fea_mm.add_strong_bc(0.0, [on_rim], Vmm)

    # -- EM problem (chained: uhat is an input here, run_motor:299-304) ------
    fea_em = FEA(mesh)
    fea_em.linear_solver = solver
    fea_em.custom_solve = make_incremental_em_solver(em_load_steps)
    fea_em.add_input("uhat", uhat)
    fea_em.add_input("Htable", Htable)
    fea_em.add_input("Jtable", Jtable)
    fea_em.add_state("A_z", A_z, res_em, ["uhat", "Htable", "Jtable"])
    fea_em.add_strong_bc(0.0, [lambda x: (
        np.isclose(np.hypot(x[0], x[1]), RADII["r0"], atol=1e-9)
        | np.isclose(np.hypot(x[0], x[1]), RADII["r6"], atol=1e-9))], Vem)

    # outputs
    steel = (T.ROTOR_STEEL, T.STATOR_STEEL)
    fea_em.add_output("B_influence_eddy_current", "scalar",
                      b_power_form(A_z, uhat, 2.0, steel), ["A_z", "uhat"])
    fea_em.add_output("B_influence_hysteresis", "scalar",
                      b_power_form(A_z, uhat, 1.76835, steel),
                      ["A_z", "uhat"])
    magnet_tags = tuple(range(T.MAGNET_FIRST, T.MAGNET_LAST + 1))
    winding_tags = tuple(range(T.WINDING_FIRST, T.WINDING_LAST + 1))
    fea_em.add_output("magnet_area", "scalar",
                      area_form(uhat, magnet_tags), ["uhat"])
    fea_em.add_output("winding_area", "scalar",
                      area_form(uhat, winding_tags), ["uhat"])
    fea_em.add_output("steel_area", "scalar",
                      area_form(uhat, steel), ["uhat"])
    from .pde import torque_form

    fea_em.add_output("torque", "scalar",
                      torque_form(A_z, uhat), ["A_z", "uhat"])
    # |B| field output (projected to CG1, recordable)
    from ...fea import FunctionSpace as _FS
    from .pde import b_field_output_form

    Vcg1 = _FS(mesh, ("CG", 1))
    fea_em.add_field_output(
        "B_magnitude", b_field_output_form(A_z, uhat, Vcg1),
        ["A_z", "uhat"], record=record)

    recorder = None
    if record:
        from ...io.xdmf import Recorder

        recorder = Recorder("records_motor")
    model = FEAModel(fea=[fea_mm, fea_em], recorder=recorder)

    # pre-models: shape dv -> [ffd ->] uhat_bc; (iq, angle) -> source tables
    Op = type(model.operations[0])
    pre_ops = []
    if design_space == "edge_deltas":
        scatter, n_dv, _, _ = edge_delta_design_space(mesh, Vmm)
        if ffd_harmonics:
            # dv -> shape params -> edge deltas -> scatter (the reference's
            # full chain: ffd_model.py -> boundary_input_model.py)
            to_deltas, n_par = ffd_shape_parameter_layer(
                mesh, Vmm, ffd_harmonics)
            pre_ops.append(Op("ffd_model", to_deltas,
                              ["shape_dv"], ["edge_deltas"]))
            pre_ops.append(Op("boundary_input_model", scatter,
                              ["edge_deltas"], ["uhat_bc"]))
            dv_shape = n_par
        else:
            pre_ops.append(Op("boundary_input_model", scatter,
                              ["shape_dv"], ["uhat_bc"]))
            dv_shape = n_dv
    elif design_space == "basis":
        basis = boundary_displacement_basis(mesh, Vmm)
        pre_ops.append(Op("boundary_input_model", lambda dv: basis @ dv,
                          ["shape_dv"], ["uhat_bc"]))
        dv_shape = 2
    else:
        raise ValueError(f"unknown design_space {design_space!r}")
    pre_ops.append(Op(
        "source_tables_model",
        lambda iq, angle: source_tables(iq, angle),
        ["iq", "angle"], ["Htable", "Jtable"]))
    model.operations[:0] = pre_ops

    # post-models: power losses + loss sum (power_loss_model.py parity)
    def loss_fn(be, bhyst):
        eddy, hyst = power_losses(be, bhyst, frequency=frequency)
        return eddy, hyst, eddy + hyst

    model.add_op("power_loss_model", loss_fn,
                 ["B_influence_eddy_current", "B_influence_hysteresis"],
                 ["eddy_current_loss", "hysteresis_loss", "loss_sum"])

    model.create_input("shape_dv", shape=dv_shape, val=0.0)
    model.create_input("iq", shape=(), val=iq0)
    model.create_input("angle", shape=(), val=angle0)
    model.add_design_variable("shape_dv", lower=-0.002, upper=0.002)
    model.add_design_variable("iq", lower=0.0, upper=5e5)
    model.add_objective("loss_sum")

    return model, dict(mesh=mesh, fea_mm=fea_mm, fea_em=fea_em, uhat=uhat,
                       A_z=A_z, Vmm=Vmm, Vem=Vem, bh=bh)


def build_motor_jit_step(refine: float = 1, em_load_steps: int = 3,
                         mm_newton_iters: int = 3, em_newton_iters: int = 3,
                         frequency: float = 300.0,
                         factorization: str = "lu", pcg_iters: int = 8,
                         factor_method: str = "thomas",
                         sweeps: str = "scan", refactor_every: int = 1,
                         device_mesh=None, design_space: str = "basis",
                         mesh=None, block_size: int | None = None,
                         freeze_operator: bool = False):
    """Fully-jittable motor opt iteration: (shape_dv, iq) -> (loss, grads).

    mesh=None uses the procedural polar mesh; pass an imported Mesh with
    the motor tag semantics to run the reference's import-first path
    (run_motor_opt.py:51-59) — the tag-table kernels and the block-Thomas
    pipeline are mesh-agnostic, and the returned dict's "bt" entry reports
    the RCM bandwidth the mesh actually produced.

    design_space: "basis" = 2-dof radial/tangential demo basis;
    "edge_deltas" = the reference's wide space (one (dx, dy) per
    magnet-ring interface node, O(10^2-10^3) dvs scattered into uhat_bc —
    boundary_input_model.py:34-71).  The IFT adjoint returns the full wide
    gradient from the same two transpose solves, so the iteration cost is
    independent of the dv count.

    Device-resident benchmark path: both implicit solves use dense LU (or
    the block-Thomas factorization) on the device with fixed Newton/load-
    step counts; the whole objective+adjoint is
    one jitted function (the reference's per-iteration cost to beat is
    7 SNES solves x (FFCx assembly + MUMPS LU) + 2 MUMPS transpose solves,
    BASELINE.md).

    With device_mesh set, residual/Jacobian/functional assembly is sharded
    over the mesh's cells axis (shard_map + psum replacing the reference's
    MPI assembly scatter, run_motor_opt.py:55 import_mesh on COMM_WORLD);
    the LU solve runs replicated.  Ignores `factorization` (dense LU).
    """
    from ...fea.assemble import compile_form
    from ...fea.bc import DirichletBC, bc_arrays
    from ...graph.implicit import implicit_solve_dense_jit

    if refactor_every != 1 and (factorization != "block_thomas"
                                or device_mesh is not None):
        # only the block-Thomas path implements Shamanskii reuse; fail
        # loudly rather than silently running every-iteration factors
        raise ValueError("refactor_every > 1 requires "
                         "factorization='block_thomas' without device_mesh")

    if mesh is None:
        mesh = create_motor_mesh(refine)
    Vmm = FunctionSpace(mesh, ("CG", 1), ncomp=2)
    Vem = FunctionSpace(mesh, ("CG", 1))
    uhat = Function(Vmm, "uhat")
    uhat_bc = Function(Vmm, "uhat_bc")
    A_z = Function(Vem, "A_z")
    Htable = GlobalCoefficient("Htable", asdev(np.zeros((NTAGS, 2))))
    Jtable = GlobalCoefficient("Jtable", asdev(np.zeros(NTAGS)))
    bh = PiecewiseBHCurve()

    mm_cf = compile_form(mesh_motion_residual_form(uhat, uhat_bc))
    em_cf = compile_form(em_residual_form(A_z, uhat, Htable, Jtable, bh))
    eddy_cf = compile_form(b_power_form(A_z, uhat, 2.0, (1, 2)))
    hyst_cf = compile_form(b_power_form(A_z, uhat, 1.76835, (1, 2)))

    on_rim = lambda x: (
        np.isclose(np.hypot(x[0], x[1]), RADII["r0"], atol=1e-9)
        | np.isclose(np.hypot(x[0], x[1]), RADII["r6"], atol=1e-9))
    free_mm, bv_mm = bc_arrays(
        [DirichletBC(Vmm, 0.0, where=on_rim)], Vmm.n_dofs)
    free_em, bv_em = bc_arrays(
        [DirichletBC(Vem, 0.0, where=on_rim)], Vem.n_dofs)

    from ...fea.assemble import ElementMatrix, MatBlock

    # dv -> uhat_bc chain; dv0 produces the SAME physical boundary
    # displacement in both spaces (so losses are comparable across spaces)
    basis = boundary_displacement_basis(mesh, Vmm)
    dv0_np = np.array([5e-4, 3e-4], config.dtype)
    dv0_basis = jnp.asarray(dv0_np)
    if design_space == "edge_deltas":
        to_bc, n_dv, _, iface_dofs = edge_delta_design_space(mesh, Vmm)
        # host-side: an eager device matmul here compiles a program
        dv0 = jnp.asarray((np.asarray(basis) @ dv0_np)[iface_dofs])
    elif design_space == "basis":
        to_bc = lambda dv: basis @ dv
        dv0 = dv0_basis
    else:
        raise ValueError(f"unknown design_space {design_space!r}")

    if device_mesh is not None:
        from ...parallel.sharding import (
            sharded_matrix_dense_fn, sharded_scalar_fn, sharded_vector_fn)

        rfn_mm = sharded_vector_fn(mm_cf, device_mesh)
        jfn_mm = sharded_matrix_dense_fn(mm_cf, device_mesh, "uhat")
        rfn_em = sharded_vector_fn(em_cf, device_mesh)
        jfn_em = sharded_matrix_dense_fn(em_cf, device_mesh, "A_z")
        eddy_fn = sharded_scalar_fn(eddy_cf, device_mesh)
        hyst_fn = sharded_scalar_fn(hyst_cf, device_mesh)

        solve_mm = implicit_solve_dense_jit(
            lambda u, p: rfn_mm({"uhat": u, "uhat_bc": p["uhat_bc"]}),
            lambda u, p: jfn_mm({"uhat": u, "uhat_bc": p["uhat_bc"]}),
            free_mm, bv_mm, newton_iters=mm_newton_iters, load_steps=2)

        def _em_vals(u, p):
            return {"A_z": u, "uhat": p["uhat"], "Htable": p["Htable"],
                    "Jtable": p["Jtable"]}

        def _em_scale(p, s):
            return {"uhat": p["uhat"], "Htable": p["Htable"] * s,
                    "Jtable": p["Jtable"] * s}

        solve_em = implicit_solve_dense_jit(
            lambda u, p: rfn_em(_em_vals(u, p)),
            lambda u, p: jfn_em(_em_vals(u, p)),
            free_em, bv_em, newton_iters=em_newton_iters,
            load_steps=em_load_steps, scale_inputs=_em_scale)

        def loss_of(dv, iq):
            uhat_bc_arr = to_bc(dv)
            uh = solve_mm({"uhat_bc": uhat_bc_arr},
                          jnp.zeros(Vmm.n_dofs, config.jdtype))
            Ht, Jt = source_tables(iq, jnp.asarray(0.0, config.jdtype))
            az = solve_em({"uhat": uh, "Htable": Ht, "Jtable": Jt},
                          jnp.zeros(Vem.n_dofs, config.jdtype))
            be = eddy_fn({"A_z": az, "uhat": uh})
            bhy = hyst_fn({"A_z": az, "uhat": uh})
            eddy, hyst = power_losses(be, bhy, frequency=frequency)
            return eddy + hyst

        step = jax.jit(jax.value_and_grad(loss_of, argnums=(0, 1)))
        iq0 = asdev(np.asarray(1e5, config.dtype))
        return step, (dv0, iq0), dict(mesh=mesh, Vmm=Vmm, Vem=Vem)

    def mm_blocks(u, p):
        raw = mm_cf.matrix({"uhat": u, "uhat_bc": p["uhat_bc"]}, "uhat")
        return [(b.A, b.rows, b.cols) for b in raw.blocks]

    def mm_jac(u, p):
        return mm_cf.matrix(
            {"uhat": u, "uhat_bc": p["uhat_bc"]}, "uhat").to_dense()

    bt_info = {}
    if factorization == "block_thomas":
        from ...graph.implicit import implicit_solve_bt_jit
        from ...ops.block_tridiag import BlockTridiagTemplate

        # pattern-only proto: the eager matrix() here ran hundreds of tiny
        # device ops at build time
        proto_mm = mm_cf.matrix_pattern("uhat")
        # block_size: larger blocks shorten the sequential scan chains
        # (nb ~ n/B) at O(B^2)-per-step cost — a latency/throughput
        # trade
        tpl_mm = BlockTridiagTemplate(proto_mm, free=free_mm,
                                      block=block_size)
        bt_info["mm"] = dict(nb=tpl_mm.nb, B=tpl_mm.B, bw=tpl_mm.bw)
        solve_mm = implicit_solve_bt_jit(
            lambda u, p: mm_cf.vector({"uhat": u, "uhat_bc": p["uhat_bc"]}),
            mm_blocks, tpl_mm, free_mm, bv_mm,
            newton_iters=mm_newton_iters, load_steps=2,
            pcg_iters=pcg_iters, factor_method=factor_method,
            sweeps=sweeps, refactor_every=refactor_every,
            freeze_operator=freeze_operator)
    else:
        solve_mm = implicit_solve_dense_jit(
            lambda u, p: mm_cf.vector(
                {"uhat": u, "uhat_bc": p["uhat_bc"]}),
            mm_jac, free_mm, bv_mm, newton_iters=mm_newton_iters,
            load_steps=2, factorization=factorization)

    def em_vals(u, p):
        return {"A_z": u, "uhat": p["uhat"], "Htable": p["Htable"],
                "Jtable": p["Jtable"]}

    def em_scale(p, s):
        return {"uhat": p["uhat"], "Htable": p["Htable"] * s,
                "Jtable": p["Jtable"] * s}

    if factorization == "block_thomas":
        from ...graph.implicit import implicit_solve_bt_jit
        from ...ops.block_tridiag import BlockTridiagTemplate

        proto_em = em_cf.matrix_pattern("A_z")
        tpl_em = BlockTridiagTemplate(proto_em, free=free_em,
                                      block=block_size)
        bt_info["em"] = dict(nb=tpl_em.nb, B=tpl_em.B, bw=tpl_em.bw)
        solve_em = implicit_solve_bt_jit(
            lambda u, p: em_cf.vector(em_vals(u, p)),
            lambda u, p: [(b.A, b.rows, b.cols) for b in em_cf.matrix(
                em_vals(u, p), "A_z").blocks],
            tpl_em, free_em, bv_em, newton_iters=em_newton_iters,
            load_steps=em_load_steps, scale_inputs=em_scale,
            pcg_iters=pcg_iters, factor_method=factor_method,
            sweeps=sweeps, refactor_every=refactor_every,
            freeze_operator=freeze_operator)
    else:
        solve_em = implicit_solve_dense_jit(
            lambda u, p: em_cf.vector(em_vals(u, p)),
            lambda u, p: em_cf.matrix(em_vals(u, p), "A_z").to_dense(),
            free_em, bv_em, newton_iters=em_newton_iters,
            load_steps=em_load_steps, scale_inputs=em_scale,
            factorization=factorization)

    def loss_of(dv, iq):
        uhat_bc_arr = to_bc(dv)
        uh = solve_mm({"uhat_bc": uhat_bc_arr},
                      jnp.zeros(Vmm.n_dofs, config.jdtype))
        Ht, Jt = source_tables(iq, jnp.asarray(0.0, config.jdtype))
        az = solve_em({"uhat": uh, "Htable": Ht, "Jtable": Jt},
                      jnp.zeros(Vem.n_dofs, config.jdtype))
        be = eddy_cf.scalar({"A_z": az, "uhat": uh})
        bhy = hyst_cf.scalar({"A_z": az, "uhat": uh})
        eddy, hyst = power_losses(be, bhy, frequency=frequency)
        return eddy + hyst

    step = jax.jit(jax.value_and_grad(loss_of, argnums=(0, 1)))
    iq0 = asdev(np.asarray(1e5, config.dtype))
    return step, (dv0, iq0), dict(mesh=mesh, Vmm=Vmm, Vem=Vem, bt=bt_info)
