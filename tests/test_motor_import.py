"""W5 import-first path: the motor running end-to-end from an IMPORTED
unstructured gmsh mesh (reference run_motor_opt.py:51-59 loads the mesh +
.ini association table via import_mesh, utils_dolfinx.py:69-123; its
motor_data files are git-LFS stubs, so the geometry is generated here).

Proves the tag-table EM kernel + block-Thomas pipeline are mesh-agnostic:
same tags, same BC/design-space predicates, irregular connectivity (the
RCM bandwidth is several x the procedural polar mesh's), and the full opt
step produces discretization-level-consistent loss/gradients.
"""

import numpy as np
import pytest

from femo_tpu.mesh.gmsh_io import import_mesh, read_association_table
from femo_tpu.models.motor.mesh import MotorTags, RADII
from femo_tpu.models.motor.unstructured import (
    generate_motor_mesh_arrays, region_names, write_motor_msh)

T = MotorTags


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("msh") / "motor_u.msh")
    ini = write_motor_msh(path, refine=0.5, seed=0)
    return import_mesh(path), read_association_table(ini)


def test_unstructured_mesh_valid_and_tagged(imported):
    mesh, table = imported
    # geometric validity: all CCW, no slivers below 1/50 of the mean size
    p = mesh.coords[mesh.cells]
    a2 = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
          - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
    assert a2.min() > 0
    assert a2.min() > a2.mean() / 50

    # genuinely unstructured: irregular vertex valences (a structured
    # polar grid has interior valence == 6 everywhere)
    val = np.bincount(mesh.cells.ravel())
    frac_not6 = (val != 6).mean()
    assert frac_not6 > 0.3

    # full 52-subdomain tag semantics survive the .msh round trip
    tags = set(np.unique(mesh.cell_tags).tolist())
    assert {T.ROTOR_STEEL, T.STATOR_STEEL, T.SHAFT, T.AIR} <= tags
    assert all(T.MAGNET_FIRST + i in tags for i in range(12))
    assert all(T.WINDING_FIRST + i in tags for i in range(36))
    ft = mesh.facet_tags
    assert (ft == T.INNER_BOUNDARY).sum() > 0
    assert (ft == T.OUTER_BOUNDARY).sum() > 0
    assert (ft == T.MAGNET_INTERFACE).sum() > 0

    # association table (.ini sidecar) matches the physical names, and
    # the in-file physical names landed on the mesh (tag -> name)
    assert table == region_names()
    assert mesh.region_names[T.MAGNET_FIRST] == "magnet_1"
    assert mesh.region_names[T.MAGNET_INTERFACE] == "magnet_interface"
    # interface nodes survive the ASCII round trip EXACTLY (the model's
    # rim/design-space predicates use atol=1e-9 on the radius)
    r = np.linalg.norm(mesh.coords, axis=1)
    for key in ("r0", "r2", "r3", "r6"):
        assert np.isclose(r, RADII[key], atol=1e-9).sum() > 15, key


def test_material_sectors_conforming(imported):
    """No triangle straddles a magnet/steel or copper/teeth sector
    boundary: every tagged cell's full triangle lies inside its sector."""
    mesh, _ = imported
    p = mesh.coords[mesh.cells]
    th = np.mod(np.arctan2(p[..., 1], p[..., 0]), 2 * np.pi)
    for first, last, n_sec in ((T.MAGNET_FIRST, T.MAGNET_LAST, 12),
                               (T.WINDING_FIRST, T.WINDING_LAST, 36)):
        sec = 2 * np.pi / n_sec
        sel = (mesh.cell_tags >= first) & (mesh.cell_tags <= last)
        sid = mesh.cell_tags[sel] - first
        # all three vertices within [0.125, 0.875] of the tagged sector
        # (tolerance for vertices exactly on the inserted boundary angle;
        # sector 0 starts at angle 0.125*sec > 0, so no 2pi wrap occurs)
        rel = (th[sel] - sid[:, None] * sec) / sec
        assert rel.min() > 0.125 - 1e-9
        assert rel.max() < 0.875 + 1e-9


def test_motor_step_on_imported_mesh_matches_procedural(imported):
    """Full jitted opt iteration (mesh motion -> EM -> losses -> IFT
    adjoint) on the imported mesh; loss/gradient agree with the
    procedural mesh at the same resolution to discretization accuracy,
    and the block-Thomas solver handles the genuinely larger RCM
    bandwidth (reported in the returned dict)."""
    from femo_tpu.models.motor.model import build_motor_jit_step

    mesh, _ = imported
    kw = dict(em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
              design_space="basis", factorization="block_thomas")
    step_u, (dv0, iq0), du = build_motor_jit_step(refine=0.5, mesh=mesh,
                                                  **kw)
    lu, (gu, giu) = step_u(dv0, iq0)
    step_p, (dvp, iqp), dp = build_motor_jit_step(refine=0.5, **kw)
    lp, (gp, gip) = step_p(dvp, iqp)

    lu, lp = float(lu), float(lp)
    assert np.isfinite(lu) and lu > 0
    # same physics, different discretizations of the same geometry: the
    # coarse refine=0.5 meshes agree to ~15% (measured 14.7%; shrinks
    # with refinement — bench_scale.py's motor_msh rows)
    assert abs(lu - lp) / abs(lp) < 0.25
    # 2-dof basis gradient: same space on both meshes -> comparable
    gu, gp = np.asarray(gu), np.asarray(gp)
    assert np.linalg.norm(gu - gp) / np.linalg.norm(gp) < 0.5
    assert np.sign(float(giu)) == np.sign(float(gip))

    # the unstructured mesh must actually stress RCM: measured bw ~3.5x
    # the polar mesh's (92 vs 27 on the EM pattern at refine=0.5)
    assert du["bt"]["em"]["bw"] > dp["bt"]["em"]["bw"]


def test_imported_mesh_adjoint_fd_parity(imported):
    """Central FD vs IFT adjoint ON THE IMPORTED MESH ITSELF (f64): a
    dofmap/tag/ordering bug specific to the import path (e.g. a wrong
    interface-node id in the edge-delta scatter, or a facet mis-tag that
    only occurs on irregular connectivity) would not show up in the
    cross-mesh band check above — it WOULD break FD parity here.

    Uses the wide edge-delta design space (the import-first reference
    workflow, run_motor_opt.py:51-59 + boundary_input_model.py:34-71) at
    near-converged Newton (n6: the IFT gradient assumes the converged
    state; at n6 the fixed-count state is converged to roundoff, CLAUDE.md
    round-5 note) so adjoint-vs-FD parity is tight."""
    from femo_tpu.models.motor.model import build_motor_jit_step

    mesh, _ = imported
    step, (dv0, iq0), d = build_motor_jit_step(
        refine=0.5, mesh=mesh, em_load_steps=3, mm_newton_iters=6,
        em_newton_iters=6, design_space="edge_deltas",
        factorization="block_thomas")
    v0, (gd, gi) = step(dv0, iq0)
    assert np.isfinite(float(v0))
    assert np.all(np.isfinite(np.asarray(gd))) and np.isfinite(float(gi))

    # iq (current) gradient: central FD
    h_iq = 1.0
    vp, _ = step(dv0, iq0 + h_iq)
    vm, _ = step(dv0, iq0 - h_iq)
    fd_iq = (float(vp) - float(vm)) / (2 * h_iq)
    assert abs(float(gi) - fd_iq) / abs(fd_iq) < 1e-6

    # shape gradient: central FD on a random subset of edge deltas
    rng = np.random.default_rng(1)
    h = 1e-7
    for i in rng.choice(dv0.shape[0], 3, replace=False):
        vp, _ = step(dv0.at[i].add(h), iq0)
        vm, _ = step(dv0.at[i].add(-h), iq0)
        fd = (float(vp) - float(vm)) / (2 * h)
        np.testing.assert_allclose(float(gd[i]), fd, rtol=1e-6,
                                   err_msg=f"edge_delta[{i}]")
