"""Assembly engine: gather -> vmapped element kernel -> segment-sum scatter.

JAX replacement for FFCx-generated element kernels + dolfinx assembly
scatter (SURVEY.md N1/N2; reference hot loops at
/root/reference/femo/fea/utils_dolfinx.py:169-202).

Design
------
* All topology/tabulation is precomputed host-side (numpy) into static-shape
  arrays closed over by jitted kernels.
* Element kernels are JAX-traced per quadrature point and vmapped over
  entities (cells/facets) — XLA fuses the whole gather/compute chain.
* Residual vectors: the integrand is linear in the test function, so the
  per-cell residual is `jax.grad` of the scalar cell integral with respect to
  the test dofs (exactly what UFL's test-function contraction produces, for
  free via AD).
* Jacobians / input partials: `jax.jacfwd` of the same kernel -> per-cell
  dense blocks, kept in "element-matrix" form (n_ent, nr, nc).  SpMV is then
  a batched einsum + segment-sum scatter — no CSR needed.
* Global scatter-add uses `jax.ops.segment_sum` (sorted ids not required).

Manifold cells (tdim < gdim, e.g. shells) are supported: gradients are
tangential via the Gram pseudo-inverse.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from types import SimpleNamespace
from typing import Callable, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..config import config
from ..elements.element import (
    CELL_FACETS, CELL_NUM_VERTICES, Element, geometry_element, map_facet_points,
)
from ..elements.quadrature import cell_rule
from ..mesh.mesh import Mesh
from .forms import FormDef, Integral, Q, QR
from .space import Function, FunctionSpace


def _segment_sum(vals, ids, n):
    return jax.ops.segment_sum(vals, ids, num_segments=n)


from ..utils.arrays import asdev as _asdev  # noqa: E402 (host->device rule)


# Dihedral symmetries of the reference quad facet, as assignments of the
# original corner index (tensor order: 0=(0,0) 1=(1,0) 2=(0,1) 3=(1,1)) to
# each parameter corner (c00, c10, c01, c11).  Diagonal pairs {0,3}/{1,2}
# are preserved, so each symmetry is a valid (bilinear) reparametrization.
_QUAD_SYMS = (
    (0, 1, 2, 3), (0, 2, 1, 3),
    (1, 0, 3, 2), (1, 3, 0, 2),
    (2, 0, 3, 1), (2, 3, 0, 1),
    (3, 1, 2, 0), (3, 2, 1, 0),
)
# parameter-corner adjacency (neighbors) and diagonal, by corner position
_QUAD_NB = np.array([[1, 2], [0, 3], [0, 3], [1, 2]])
_QUAD_DIAG = np.array([3, 2, 1, 0])


def _det_small(G):
    """Batched determinant of (..., d, d) for d in {1, 2, 3}, closed-form."""
    d = G.shape[-1]
    if d == 1:
        return G[..., 0, 0]
    if d == 2:
        return G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0]
    if d == 3:
        return (
            G[..., 0, 0] * (G[..., 1, 1] * G[..., 2, 2]
                            - G[..., 1, 2] * G[..., 2, 1])
            - G[..., 0, 1] * (G[..., 1, 0] * G[..., 2, 2]
                              - G[..., 1, 2] * G[..., 2, 0])
            + G[..., 0, 2] * (G[..., 1, 0] * G[..., 2, 1]
                              - G[..., 1, 1] * G[..., 2, 0])
        )
    raise NotImplementedError(d)


def _inv_small(G, detG=None):
    """Batched inverse of (..., d, d) for d in {1, 2, 3}, closed-form."""
    d = G.shape[-1]
    if detG is None:
        detG = _det_small(G)
    inv_det = 1.0 / detG
    if d == 1:
        return inv_det[..., None, None]
    if d == 2:
        a, b = G[..., 0, 0], G[..., 0, 1]
        c, e = G[..., 1, 0], G[..., 1, 1]
        row0 = jnp.stack([e, -b], axis=-1)
        row1 = jnp.stack([-c, a], axis=-1)
        return jnp.stack([row0, row1], axis=-2) * inv_det[..., None, None]
    if d == 3:
        cof = jnp.stack([
            jnp.stack([
                G[..., 1, 1] * G[..., 2, 2] - G[..., 1, 2] * G[..., 2, 1],
                G[..., 0, 2] * G[..., 2, 1] - G[..., 0, 1] * G[..., 2, 2],
                G[..., 0, 1] * G[..., 1, 2] - G[..., 0, 2] * G[..., 1, 1],
            ], axis=-1),
            jnp.stack([
                G[..., 1, 2] * G[..., 2, 0] - G[..., 1, 0] * G[..., 2, 2],
                G[..., 0, 0] * G[..., 2, 2] - G[..., 0, 2] * G[..., 2, 0],
                G[..., 0, 2] * G[..., 1, 0] - G[..., 0, 0] * G[..., 1, 2],
            ], axis=-1),
            jnp.stack([
                G[..., 1, 0] * G[..., 2, 1] - G[..., 1, 1] * G[..., 2, 0],
                G[..., 0, 1] * G[..., 2, 0] - G[..., 0, 0] * G[..., 2, 1],
                G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0],
            ], axis=-1),
        ], axis=-2)
        return cof * inv_det[..., None, None]
    raise NotImplementedError(d)


def _facet_quadrature(cell: str, qdeg: int):
    """Quadrature on the reference facet of `cell`: (pts (nq, d-1), wts)."""
    from ..elements.element import FACET_CELL

    fc = FACET_CELL[cell]
    if fc == "point":
        return np.zeros((1, 0)), np.ones(1)
    return cell_rule(fc, qdeg)


# ---------------------------------------------------------------------------
# Per-term precomputed data
# ---------------------------------------------------------------------------


@dataclass
class _SpaceTab:
    """Tabulation tables for one space on one term's quadrature points."""

    space: FunctionSpace
    # cell terms: N (nq, nsd), dN (nq, nsd, tdim)
    # facet terms: stacked over variants: (nvar, nq, nsd), (nvar, nq, nsd, tdim)
    N: jnp.ndarray
    dN: jnp.ndarray
    # second derivatives (nq, nsd, tdim, tdim) for Hermite-class elements
    d2N: jnp.ndarray | None = None


class _Term:
    """One compiled integral term."""

    def __init__(self, integral: Integral, form: "CompiledForm"):
        self.integral = integral
        self.form = form
        mesh = form.mesh
        self.domain = integral.domain
        spaces = form.spaces  # name -> FunctionSpace (includes test as "v")

        qdeg = integral.qdeg or form.default_qdeg
        geo = geometry_element(mesh.cell_type)
        f = config.jdtype

        if self.domain == "cell":
            qp, qw = cell_rule(mesh.cell_type, qdeg)
            self.qw = _asdev(qw, f)
            self.tabs = {}
            for name, V in spaces.items():
                N, dN = V.element.tabulate(qp)
                d2N = (_asdev(V.element.tabulate2(qp), f)
                       if V.element.has_hessian_tab() else None)
                self.tabs[name] = _SpaceTab(
                    V, _asdev(N, f), _asdev(dN, f), d2N)
            Ng, dNg = geo.tabulate(qp)
            self.Ng = _asdev(Ng, f)
            self.dNg = _asdev(dNg, f)
            # entity selection by subdomain tag
            if integral.tag is None:
                ents = np.arange(mesh.n_cells, dtype=np.int32)
            else:
                tags = mesh.cell_tags
                if tags is None:
                    raise ValueError("mesh has no cell tags")
                sel = np.isin(tags, np.atleast_1d(integral.tag))
                ents = np.nonzero(sel)[0].astype(np.int32)
            self.cells0 = ents  # owning cells == entities
            self.n_ent = len(ents)
            self.coords0 = _asdev(mesh.coords[mesh.cells[ents]], f)
            h = mesh.cell_sizes()[ents]
            self.h = _asdev(h, f)
            tags = mesh.cell_tags[ents] if mesh.cell_tags is not None \
                else np.zeros(len(ents), np.int32)
            self.tag = _asdev(tags)
            self.gdofs0 = {
                name: _asdev(V.dofmap[ents])
                for name, V in spaces.items()
            }
        else:
            # facet terms
            fqp, fqw = _facet_quadrature(mesh.cell_type, qdeg)
            self.qw = _asdev(fqw, f)
            nlf = len(CELL_FACETS[mesh.cell_type])
            # Variants enumerate the facet-parametrization symmetries so the
            # two sides of an interior facet integrate at matching physical
            # points: edges have 2 orientations; triangle facets (tet) have
            # all 6 vertex permutations; quad facets (hex) the 8 dihedral
            # symmetries; points have 1 (duplicated to keep lf*2 indexing).
            # Each variant is an AFFINE map of the reference facet into the
            # reference cell: pts = o + fqp @ T.  (Hex reference facets are
            # parallelograms and dihedral symmetries preserve the diagonal
            # pairing, so the bilinear term vanishes and affine is exact.)
            # T doubles as the reference-facet tangent frame used for the
            # per-qp physical normal/measure (see _facet_geom).
            from ..elements.element import REFERENCE_VERTICES

            rv = REFERENCE_VERTICES[mesh.cell_type]
            lfs_t = CELL_FACETS[mesh.cell_type]
            vmaps = []  # list of (origin (tdim,), T (fdim, tdim))
            if mesh.cell_type == "tet":
                from itertools import permutations

                self._tri_perms = list(permutations(range(3)))
                self.n_variants_per_lf = 6
                for lf in range(nlf):
                    verts = rv[list(lfs_t[lf])]
                    for p in self._tri_perms:
                        o = verts[p[0]]
                        vmaps.append((o, np.stack(
                            [verts[p[1]] - o, verts[p[2]] - o])))
            elif mesh.cell_type == "hex":
                self.n_variants_per_lf = 8
                for lf in range(nlf):
                    verts = rv[list(lfs_t[lf])]
                    for sym in _QUAD_SYMS:
                        o = verts[sym[0]]
                        vmaps.append((o, np.stack(
                            [verts[sym[1]] - o, verts[sym[2]] - o])))
            else:
                self.n_variants_per_lf = 2
                for lf in range(nlf):
                    verts = rv[list(lfs_t[lf])]
                    if mesh.tdim == 1:  # point facets
                        o = verts[0]
                        vmaps.append((o, np.zeros((0, 1))))
                        vmaps.append((o, np.zeros((0, 1))))
                    else:  # edges: forward + reversed parametrization
                        vmaps.append((verts[0], (verts[1] - verts[0])[None]))
                        vmaps.append((verts[1], (verts[0] - verts[1])[None]))
            variants = [o[None, :] + fqp @ T for (o, T) in vmaps]
            self.Tref = _asdev(np.stack([T for (_, T) in vmaps]), f)

            def tab_variants(el: Element):
                Ns, dNs = [], []
                for pts in variants:
                    N, dN = el.tabulate(pts)
                    Ns.append(N)
                    dNs.append(dN)
                return (_asdev(np.stack(Ns), f),
                        _asdev(np.stack(dNs), f))

            self.tabs = {
                name: _SpaceTab(V, *tab_variants(V.element))
                for name, V in spaces.items()
            }
            Ngs, dNgs = tab_variants(geo)
            self.Ng, self.dNg = Ngs, dNgs

            # facet entity selection
            if self.domain == "exterior_facet":
                fids = mesh.exterior_facets
            else:
                fids = mesh.interior_facets
            if integral.tag is not None:
                sel = np.isin(mesh.facet_tags[fids],
                              np.atleast_1d(integral.tag))
                fids = fids[sel]
            self.n_ent = len(fids)
            self.fids = fids

            fc = mesh.facet_cells[fids]  # (ne, 2)
            fl = mesh.facet_local[fids]
            fverts = mesh.facets[fids]  # sorted global vertex tuples

            def side_data(side):
                cells = fc[:, side]
                lf = fl[:, side]
                lfs = np.asarray(CELL_FACETS[mesh.cell_type])
                if mesh.cell_type == "tet":
                    # permutation taking this side's local facet-vertex
                    # global ids to the sorted facet key
                    gl = mesh.cells[cells[:, None], lfs[lf]]  # (ne, 3)
                    perm = np.argsort(gl, axis=1)  # (ne, 3)
                    perm_idx = np.array(
                        [self._tri_perms.index(tuple(p)) for p in perm],
                        np.int32)
                    variant = lf * 6 + perm_idx
                elif mesh.cell_type == "hex":
                    # dihedral symmetry taking this side's param-corner
                    # global ids to the canonical ordering (min id at (0,0),
                    # its smaller-id neighbor at (1,0)); both sides then
                    # integrate at identical physical points
                    gl = mesh.cells[cells[:, None], lfs[lf]]  # (ne, 4)
                    ne_ = len(gl)
                    m = np.argmin(gl, axis=1)
                    nbp = _QUAD_NB[m]  # (ne, 2) neighbor positions
                    nbi = np.take_along_axis(gl, nbp, axis=1)
                    swap = nbi[:, 0] > nbi[:, 1]
                    lo = np.where(swap, nbp[:, 1], nbp[:, 0])
                    hi = np.where(swap, nbp[:, 0], nbp[:, 1])
                    tgt_pos = np.stack([m, lo, hi, _QUAD_DIAG[m]], axis=1)
                    tgt = np.take_along_axis(gl, tgt_pos, axis=1)
                    sym_idx = np.full(ne_, -1, np.int32)
                    for k, sym in enumerate(_QUAD_SYMS):
                        hit = (gl[:, list(sym)] == tgt).all(axis=1)
                        sym_idx[hit] = k
                    assert (sym_idx >= 0).all()
                    variant = lf * 8 + sym_idx
                else:
                    # edges: orientation bit (reversed param)
                    local_first = mesh.cells[cells, lfs[lf, 0]]
                    orient = (local_first != fverts[:, 0]).astype(np.int32)
                    if mesh.tdim == 1:
                        orient = np.zeros_like(orient)
                    variant = lf * 2 + orient
                return cells.astype(np.int32), variant

            self.cells0, self.var0 = side_data(0)
            self.var0 = _asdev(self.var0)
            self.coords0 = _asdev(mesh.coords[mesh.cells[self.cells0]], f)
            self.gdofs0 = {
                name: _asdev(V.dofmap[self.cells0])
                for name, V in spaces.items()
            }
            h = mesh.cell_sizes()[self.cells0]
            self.h = _asdev(h, f)
            ftags = mesh.facet_tags[fids]
            self.tag = _asdev(ftags)
            # owning-cell subdomain tags (g.ctag): facet terms whose
            # coefficients are material-dispatched need the CELL subdomain,
            # not the facet marker (reference motor_pde.py:119-121 uses the
            # steel subdomain permeability in the boundary Nitsche term)
            ct = mesh.cell_tags
            self.ctag0 = _asdev(
                ct[self.cells0] if ct is not None
                else np.zeros(self.n_ent, np.int32))
            # centroids of side-0 cells for outward orientation
            self.cent0 = _asdev(
                mesh.coords[mesh.cells[self.cells0]].mean(axis=1), f
            )
            if self.domain == "interior_facet":
                cells1, var1 = side_data(1)
                self.cells1 = cells1
                self.var1 = _asdev(var1)
                self.coords1 = _asdev(
                    mesh.coords[mesh.cells[cells1]], f)
                self.gdofs1 = {
                    name: _asdev(V.dofmap[cells1])
                    for name, V in spaces.items()
                }
                self.ctag1 = _asdev(
                    ct[cells1] if ct is not None
                    else np.zeros(self.n_ent, np.int32))

    # -- kernel building ------------------------------------------------------

    def _geometry(self, coords_e, Ng, dNg):
        """Per-qp geometry: x (nq,gdim), detJ (nq,), K = Ginv@J^T (nq,tdim,gdim).

        Small-matrix det/inv are closed-form: explicit formulas fuse into
        the surrounding kernel.
        """
        J = jnp.einsum("ai,qat->qit", coords_e, dNg)  # (nq, gdim, tdim)
        G = jnp.einsum("qit,qis->qts", J, J)
        detG = _det_small(G)
        detJ = jnp.sqrt(detG)
        K = jnp.einsum("qts,qis->qti", _inv_small(G, detG), J)
        x = jnp.einsum("qa,ai->qi", Ng, coords_e)
        return x, detJ, K, J

    def _qp_values(self, tab: _SpaceTab, N, dNphys, u_eff, d2phys=None):
        """Q value at all qps. N (nq,nsd), dNphys (nq,nsd,gdim), u_eff (nd,)."""
        V = tab.space
        nsd, ncp = V.element.nscalar_dofs, V.element.ncomp
        if ncp == 1:
            val = N @ u_eff  # (nq,)
            gr = jnp.einsum("qsg,s->qg", dNphys, u_eff)
            hs = (None if d2phys is None
                  else jnp.einsum("qsij,s->qij", d2phys, u_eff))
        else:
            um = u_eff.reshape(nsd, ncp)
            val = jnp.einsum("qs,sc->qc", N, um)
            gr = jnp.einsum("qsg,sc->qcg", dNphys, um)
            hs = (None if d2phys is None
                  else jnp.einsum("qsij,sc->qcij", d2phys, um))
        return val, gr, hs

    def _scale_local(self, V: FunctionSpace, coords_e, u_e):
        """Apply per-cell dof scaling (Hermite derivative dofs)."""
        el = V.element
        if not el.has_dof_scaling():
            return u_e
        s = el.dof_scaling_scalar(coords_e)
        if el.ncomp > 1:
            s = jnp.repeat(s, el.ncomp)
        return u_e * s

    def _facet_geom(self, J, Tv, x, cent0):
        """Per-qp outward facet normal (nq, gdim) and measure scale (nq,).

        Computed from the cell geometry Jacobian J (nq, gdim, tdim) and the
        variant's reference-facet tangent frame Tv (fdim, tdim): physical
        facet tangents are J @ Tv^T, so the normal and the facet Jacobian
        |dX/d(facet params)| are exact per quadrature point — including
        distorted (non-parallelogram) bilinear hex facets, where a single
        vertex-based normal/area would be wrong, and edges of 2D manifold
        cells in 3D (shell boundaries), where the outward direction is the
        in-plane normal t x (J0 x J1).  Orientation: away from the side-0
        cell centroid (reference outward-normal convention,
        /root/reference/femo/fea/utils_dolfinx.py FacetNormal usage).
        """
        fdim = Tv.shape[0]
        nq = J.shape[0]
        if fdim == 0:  # point facet (interval cells)
            n = x - cent0[None, :]
            n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
            return n, jnp.ones(nq, J.dtype)
        t = jnp.einsum("qit,ft->qif", J, Tv)  # (nq, gdim, fdim)
        if fdim == 2:  # triangle/quad facet of a 3D cell
            nv = jnp.cross(t[:, :, 0], t[:, :, 1])
            a = jnp.linalg.norm(nv, axis=-1)
            n = nv / a[:, None]
        else:  # edge facet
            t1 = t[:, :, 0]
            a = jnp.linalg.norm(t1, axis=-1)
            if J.shape[1] == 2:
                n = jnp.stack([t1[:, 1], -t1[:, 0]], axis=-1) / a[:, None]
            else:
                # edge of a 2D manifold cell in 3D: in-plane outward normal
                npl = jnp.cross(J[:, :, 0], J[:, :, 1])
                nv = jnp.cross(t1, npl)
                n = nv / jnp.linalg.norm(nv, axis=-1, keepdims=True)
        sgn = jnp.sign(jnp.einsum("qi,qi->q", n, x - cent0[None, :]))
        return n * sgn[:, None], a

    def _build_w(self, names, qvals, qp_index, globals_=None):
        w = SimpleNamespace()
        for name in names:
            val, gr, hs = qvals[name]
            setattr(w, name, Q(val[qp_index], gr[qp_index],
                               None if hs is None else hs[qp_index]))
        for name, val in (globals_ or {}).items():
            setattr(w, name, Q(val))
        return w

    def make_entity_kernel(self, test_name: str | None,
                           coeff_names: Sequence[str]):
        """Build per-entity kernel.

        Returns fn(locals: dict name->(nd,), aux) -> scalar (no test) or
        (nd_test,) residual; for interior facets locals are (2, nd) stacked.
        Global coefficients appear in locals unchanged (no gather).
        """
        integral = self.integral
        gset = set(self.form.global_names)
        names = [n for n in coeff_names if n not in gset]
        gnames = [n for n in coeff_names if n in gset]
        tabs = self.tabs

        if self.domain == "cell":
            def kernel(locals_, coords_e, h_e, tag_e):
                x, detJ, K, Jg = self._geometry(
                    coords_e, self.Ng, self.dNg)
                all_names = set(names) | ({test_name} if test_name else set())
                dNphys = {
                    n: jnp.einsum("qst,qtg->qsg", tabs[n].dN, K)
                    for n in all_names
                }
                # physical hessian on affine cells: H = K^T d2N K (no
                # curvature correction; used by Hermite interval elements)
                d2phys = {
                    n: (None if tabs[n].d2N is None else jnp.einsum(
                        "qti,qstr,qrj->qsij", K, tabs[n].d2N, K))
                    for n in all_names
                }

                def total(v_e):
                    qvals = {}
                    for n in names:
                        u_eff = self._scale_local(
                            tabs[n].space, coords_e, locals_[n])
                        qvals[n] = self._qp_values(
                            tabs[n], tabs[n].N, dNphys[n], u_eff,
                            d2phys[n])
                    if test_name:
                        v_eff = self._scale_local(
                            tabs[test_name].space, coords_e, v_e)
                        qvals["v"] = self._qp_values(
                            tabs[test_name], tabs[test_name].N,
                            dNphys[test_name], v_eff, d2phys[test_name])
                    nq = self.qw.shape[0]

                    gvals = {n: locals_[n] for n in gnames}

                    def at_qp(q):
                        w = self._build_w(
                            names + (["v"] if test_name else []), qvals, q,
                            gvals)
                        # g.J: geometry Jacobian (gdim, tdim) — local frames
                        # on manifold cells (shells)
                        g = SimpleNamespace(x=x[q], h=h_e, tag=tag_e,
                                            ctag=tag_e, n=None, J=Jg[q])
                        r = integral.fn(w, g)
                        return r.val if isinstance(r, Q) else r

                    # vmap over quadrature points: one traced copy of the integrand
                    # instead of nq unrolled copies (compile-time lever)
                    vals = jax.vmap(at_qp)(jnp.arange(nq))
                    return jnp.sum(self.qw * detJ * vals)

                if test_name is None:
                    return total(None)
                nd = tabs[test_name].space.element.ndofs
                # seed derived from per-entity data so it is device-varying under
                # shard_map (a replicated seed would make grad insert a
                # cross-device psum in the new shard_map semantics)
                z = jnp.zeros(nd, config.jdtype) + 0.0 * h_e
                return jax.grad(total)(z)

            return kernel

        if self.domain == "exterior_facet":
            def kernel(locals_, coords_e, var_e, cent_e, h_e,
                       tag_e, ctag_e):
                Ng = self.Ng[var_e]
                dNg = self.dNg[var_e]
                x, _, K, Jg = self._geometry(coords_e, Ng, dNg)
                nrm, scale = self._facet_geom(
                    Jg, self.Tref[var_e], x, cent_e)
                dNphys = {
                    n: jnp.einsum(
                        "qst,qtg->qsg", tabs[n].dN[var_e], K)
                    for n in set(names) | ({test_name} if test_name else set())
                }

                def total(v_e):
                    qvals = {}
                    for n in names:
                        u_eff = self._scale_local(
                            tabs[n].space, coords_e, locals_[n])
                        qvals[n] = self._qp_values(
                            tabs[n], tabs[n].N[var_e], dNphys[n], u_eff)
                    if test_name:
                        v_eff = self._scale_local(
                            tabs[test_name].space, coords_e, v_e)
                        qvals["v"] = self._qp_values(
                            tabs[test_name], tabs[test_name].N[var_e],
                            dNphys[test_name], v_eff)
                    nq = self.qw.shape[0]

                    gvals = {n: locals_[n] for n in gnames}

                    def at_qp(q):
                        w = self._build_w(
                            names + (["v"] if test_name else []), qvals, q,
                            gvals)
                        g = SimpleNamespace(
                            x=x[q], h=h_e, tag=tag_e, ctag=ctag_e, n=nrm[q])
                        r = integral.fn(w, g)
                        return r.val if isinstance(r, Q) else r

                    # vmap over quadrature points: one traced copy of the integrand
                    # instead of nq unrolled copies (compile-time lever)
                    vals = jax.vmap(at_qp)(jnp.arange(nq))
                    return jnp.sum(self.qw * scale * vals)

                if test_name is None:
                    return total(None)
                nd = tabs[test_name].space.element.ndofs
                # seed derived from per-entity data so it is device-varying under
                # shard_map (a replicated seed would make grad insert a
                # cross-device psum in the new shard_map semantics)
                z = jnp.zeros(nd, config.jdtype) + 0.0 * h_e
                return jax.grad(total)(z)

            return kernel

        # interior facet
        def kernel(locals2, coords0_e, coords1_e, var0_e, var1_e,
                   cent_e, h_e, tag_e, ctag0_e, ctag1_e):
            Ng0, dNg0 = self.Ng[var0_e], self.dNg[var0_e]
            Ng1, dNg1 = self.Ng[var1_e], self.dNg[var1_e]
            x, _, K0, Jg0 = self._geometry(coords0_e, Ng0, dNg0)
            _, _, K1, _ = self._geometry(coords1_e, Ng1, dNg1)
            nrm, scale = self._facet_geom(
                Jg0, self.Tref[var0_e], x, cent_e)
            all_names = set(names) | ({test_name} if test_name else set())
            dN0 = {n: jnp.einsum("qst,qtg->qsg", tabs[n].dN[var0_e], K0)
                   for n in all_names}
            dN1 = {n: jnp.einsum("qst,qtg->qsg", tabs[n].dN[var1_e], K1)
                   for n in all_names}

            def total(v2):
                qv0, qv1 = {}, {}
                for n in names:
                    u0 = self._scale_local(
                        tabs[n].space, coords0_e, locals2[n][0])
                    u1 = self._scale_local(
                        tabs[n].space, coords1_e, locals2[n][1])
                    qv0[n] = self._qp_values(
                        tabs[n], tabs[n].N[var0_e], dN0[n], u0)
                    qv1[n] = self._qp_values(
                        tabs[n], tabs[n].N[var1_e], dN1[n], u1)
                if test_name:
                    v0 = self._scale_local(
                        tabs[test_name].space, coords0_e, v2[0])
                    v1 = self._scale_local(
                        tabs[test_name].space, coords1_e, v2[1])
                    qv0["v"] = self._qp_values(
                        tabs[test_name], tabs[test_name].N[var0_e],
                        dN0[test_name], v0)
                    qv1["v"] = self._qp_values(
                        tabs[test_name], tabs[test_name].N[var1_e],
                        dN1[test_name], v1)
                nq = self.qw.shape[0]

                def at_qp(q):
                    w = SimpleNamespace()
                    for n in names + (["v"] if test_name else []):
                        vp, gp, _ = qv0[n]
                        vm, gm, _ = qv1[n]
                        setattr(w, n, QR(Q(vp[q], gp[q]), Q(vm[q], gm[q])))
                    for n in gnames:
                        setattr(w, n, Q(locals2[n]))
                    g = SimpleNamespace(x=x[q], h=h_e, tag=tag_e,
                                        ctag0=ctag0_e, ctag1=ctag1_e,
                                        n=nrm[q])
                    r = integral.fn(w, g)
                    return r.val if isinstance(r, Q) else r

                # vmap over quadrature points: one traced copy of the integrand
                # instead of nq unrolled copies (compile-time lever)
                vals = jax.vmap(at_qp)(jnp.arange(nq))
                return jnp.sum(self.qw * scale * vals)

            if test_name is None:
                return total(None)
            nd = tabs[test_name].space.element.ndofs
            z = jnp.zeros((2, nd), config.jdtype) + 0.0 * h_e
            return jax.grad(total)(z)

        return kernel

    # -- assembled entry points ------------------------------------------------

    def gather_locals(self, values: dict, d=None):
        """Gather per-entity local dof values for each field coefficient;
        global (scalar) coefficients pass through unchanged."""
        d = d or self
        g = self.form.global_names
        if self.domain == "interior_facet":
            return {
                n: (values[n] if n in g else jnp.stack(
                    [values[n][d.gdofs0[n]], values[n][d.gdofs1[n]]],
                    axis=1))  # (ne, 2, nd)
                for n in values
            }
        return {n: (values[n] if n in g else values[n][d.gdofs0[n]])
                for n in values}

    def locals_axes(self, values: dict):
        """vmap in_axes for gathered locals: 0 for fields, None for
        globals (broadcast across entities)."""
        g = self.form.global_names
        return {n: (None if n in g else 0) for n in values}

    def scalar(self, values: dict, data=None) -> jnp.ndarray:
        d = data or self
        names = list(values.keys())
        kern = self.make_entity_kernel(None, names)
        locals_ = self.gather_locals(values, d)
        lax_ = self.locals_axes(values)
        if self.domain == "cell":
            vals = jax.vmap(kern, in_axes=(lax_, 0, 0, 0))(
                locals_, d.coords0, d.h, d.tag)
        elif self.domain == "exterior_facet":
            vals = jax.vmap(kern, in_axes=(lax_,) + (0,) * 6)(
                locals_, d.coords0, d.var0, d.cent0,
                d.h, d.tag, d.ctag0)
        else:
            vals = jax.vmap(kern, in_axes=(lax_,) + (0,) * 9)(
                locals_, d.coords0, d.coords1, d.var0, d.var1,
                d.cent0, d.h, d.tag, d.ctag0, d.ctag1)
        mask = getattr(d, "mask", None)
        if mask is not None:
            vals = vals * mask
        return jnp.sum(vals)

    def residual_contrib(self, values: dict, test_name: str, data=None,
                         chunk: int | None = None):
        """(flat contributions, flat row ids) for segment-sum.

        chunk: lax.map batching of the cell loop (see matrix_blocks) —
        the residual kernel's AD temporaries carry small trailing dims
        that XLA pads ~28x at O(1e5) cells."""
        d = data or self
        names = list(values.keys())
        kern = self.make_entity_kernel(test_name, names)
        locals_ = self.gather_locals(values, d)
        lax_ = self.locals_axes(values)
        if self.domain == "cell" and chunk is not None:
            statics = {n: v for n, v in locals_.items() if lax_[n] is None}
            moving = {n: v for n, v in locals_.items() if lax_[n] == 0}

            def one(batch):
                loc, c0, h, tg = batch
                return kern({**loc, **statics}, c0, h, tg)

            contrib = jax.lax.map(
                one, (moving, d.coords0, d.h, d.tag),
                batch_size=int(chunk))  # (ne, nd)
            rows = d.gdofs0[test_name]
            mask = getattr(d, "mask", None)
            if mask is not None:
                contrib = contrib * mask[:, None]
            return contrib.reshape(-1), rows.reshape(-1)
        if self.domain == "cell":
            contrib = jax.vmap(kern, in_axes=(lax_, 0, 0, 0))(
                locals_, d.coords0, d.h, d.tag)  # (ne, nd)
            rows = d.gdofs0[test_name]
        elif self.domain == "exterior_facet":
            contrib = jax.vmap(kern, in_axes=(lax_,) + (0,) * 6)(
                locals_, d.coords0, d.var0, d.cent0,
                d.h, d.tag, d.ctag0)
            rows = d.gdofs0[test_name]
        else:
            contrib = jax.vmap(kern, in_axes=(lax_,) + (0,) * 9)(
                locals_, d.coords0, d.coords1, d.var0, d.var1,
                d.cent0, d.h, d.tag, d.ctag0,
                d.ctag1)  # (ne, 2, nd)
            contrib = contrib.reshape(contrib.shape[0], -1)
            rows = jnp.concatenate(
                [d.gdofs0[test_name], d.gdofs1[test_name]], axis=1)
        mask = getattr(d, "mask", None)
        if mask is not None:
            contrib = contrib * mask[:, None]
        return contrib.reshape(-1), rows.reshape(-1)

    def matrix_blocks(self, values: dict, test_name: str, wrt: str,
                      data=None, chunk: int | None = None):
        """Element-matrix block: (A (ne, nr, nc), rows, cols).

        chunk: process entities in lax.map batches of this size instead
        of one whole-mesh vmap.  The vmapped-jacfwd temporaries carry
        small trailing dims ((nq, ncomp, nsd, ...)), and at O(10^5) cells
        XLA's tiled layouts pad them catastrophically (measured 19-28x
        expansion -> 30 GB HBM for a 107k-cell CG2CG1 Jacobian);
        chunking bounds the live temp to chunk/ne of that at ~zero
        throughput cost (the factor, not assembly, dominates the step).

        CONTRACT CHANGE with chunk set: A is returned FLAT, (ne, nr*nc)
        C-order, not (ne, nr, nc).  A materialized (ne, 18, 18) f64
        output array tiles its two minor dims to (24, 128) — 7x padding,
        2.6 GB per block at 107k cells; the flat layout pads nr*nc to the
        next lane multiple only (~1.2x).  The block-tridiagonal fill (the
        chunked path's consumer) flattens A anyway; entry order is
        identical.
        """
        d = data or self
        names = list(values.keys())
        kern = self.make_entity_kernel(test_name, names)

        if self.domain == "interior_facet":
            def res_wrt(u_loc, locals_, args):
                l2 = dict(locals_)
                l2[wrt] = u_loc
                return kern(l2, *args)

            locals_ = self.gather_locals(values, d)
            lax_ = self.locals_axes(values)
            args = (d.coords0, d.coords1, d.var0, d.var1,
                    d.cent0, d.h, d.tag, d.ctag0, d.ctag1)

            def per_ent(locals_e, *args_e):
                u0 = locals_e[wrt]
                return jax.jacfwd(
                    lambda u: res_wrt(u, locals_e, args_e))(u0)

            Ae = jax.vmap(per_ent, in_axes=(lax_,) + (0,) * len(args))(
                locals_, *args)  # (ne, 2, nr, 2, nc)
            ne = Ae.shape[0]
            Ae = Ae.reshape(ne, Ae.shape[1] * Ae.shape[2], -1)
            rows = jnp.concatenate(
                [d.gdofs0[test_name], d.gdofs1[test_name]], axis=1)
            cols = jnp.concatenate(
                [d.gdofs0[wrt], d.gdofs1[wrt]], axis=1)
            mask = getattr(d, "mask", None)
            if mask is not None:
                Ae = Ae * mask[:, None, None]
            return Ae, rows, cols

        locals_ = self.gather_locals(values, d)
        lax_ = self.locals_axes(values)
        if self.domain == "cell":
            args = (d.coords0, d.h, d.tag)
        else:
            args = (d.coords0, d.var0, d.cent0,
                    d.h, d.tag, d.ctag0)

        def per_ent(locals_e, *args_e):
            def res(u):
                l2 = dict(locals_e)
                l2[wrt] = u
                return kern(l2, *args_e)

            return jax.jacfwd(res)(locals_e[wrt])

        if chunk is not None:
            statics = {n: v for n, v in locals_.items() if lax_[n] is None}
            moving = {n: v for n, v in locals_.items() if lax_[n] == 0}

            def one(batch):
                loc, args_e = batch
                return per_ent({**loc, **statics}, *args_e).reshape(-1)

            Ae = jax.lax.map(one, (moving, args), batch_size=int(chunk))
        else:
            Ae = jax.vmap(per_ent, in_axes=(lax_,) + (0,) * len(args))(
                locals_, *args)  # (ne, nr, nc)
        mask = getattr(d, "mask", None)
        if mask is not None:
            Ae = Ae * mask.reshape((-1,) + (1,) * (Ae.ndim - 1))
        return Ae, d.gdofs0[test_name], d.gdofs0[wrt]


# ---------------------------------------------------------------------------
# Element-matrix (assembled Jacobian) representation
# ---------------------------------------------------------------------------


@dataclass
class MatBlock:
    A: jnp.ndarray  # (ne, nr, nc)
    rows: jnp.ndarray  # (ne, nr)
    cols: jnp.ndarray  # (ne, nc)


class ElementMatrix:
    """Sparse matrix in unassembled element form.

    SpMV = batched small matvecs (einsum) + segment-sum scatter — the
    JAX SpMV replacing PETSc Mat (SURVEY.md N4).
    """

    def __init__(self, blocks: list[MatBlock], n_rows: int, n_cols: int):
        self.blocks = blocks
        self.shape = (n_rows, n_cols)

    def matvec(self, x):
        y = jnp.zeros(self.shape[0], x.dtype)
        for b in self.blocks:
            xe = x[b.cols]  # (ne, nc)
            ye = jnp.einsum("eij,ej->ei", b.A, xe)
            y = y + _segment_sum(
                ye.reshape(-1), b.rows.reshape(-1), self.shape[0])
        return y

    def rmatvec(self, y):
        """Transpose matvec A^T y (adjoint solves, utils_dolfinx.py:241-245)."""
        x = jnp.zeros(self.shape[1], y.dtype)
        for b in self.blocks:
            ye = y[b.rows]
            xe = jnp.einsum("eij,ei->ej", b.A, ye)
            x = x + _segment_sum(
                xe.reshape(-1), b.cols.reshape(-1), self.shape[1])
        return x

    def diagonal(self):
        d = jnp.zeros(self.shape[0], self.blocks[0].A.dtype)
        for b in self.blocks:
            if b.rows.shape[1] != b.cols.shape[1]:
                continue
            diag = jnp.einsum("eii->ei", b.A)
            same = (b.rows == b.cols)
            d = d + _segment_sum(
                (diag * same).reshape(-1), b.rows.reshape(-1), self.shape[0])
        return d

    def to_dense(self):
        M = jnp.zeros(self.shape, self.blocks[0].A.dtype)
        for b in self.blocks:
            ne, nr, nc = b.A.shape
            ridx = jnp.broadcast_to(b.rows[:, :, None], (ne, nr, nc))
            cidx = jnp.broadcast_to(b.cols[:, None, :], (ne, nr, nc))
            M = M.at[ridx.reshape(-1), cidx.reshape(-1)].add(
                b.A.reshape(-1))
        return M

    def to_scipy_csr(self, pattern_only: bool = False):
        """Host CSR (for the sparse-direct fallback solver).

        pattern_only=True skips the values (int8 ones) — used by
        BlockTridiagTemplate, which needs only the sparsity graph for the
        RCM ordering; at reference scale the f64 value ravel is ~40 s of
        host time and 300+ MB of traffic for nothing."""
        import scipy.sparse as sp

        rows, cols, vals = [], [], []
        for b in self.blocks:
            ne, nr, nc = b.A.shape
            rows.append(np.broadcast_to(
                np.asarray(b.rows)[:, :, None], (ne, nr, nc)).ravel())
            cols.append(np.broadcast_to(
                np.asarray(b.cols)[:, None, :], (ne, nr, nc)).ravel())
            if not pattern_only:
                vals.append(np.asarray(b.A).ravel())
        rows = np.concatenate(rows)
        data = (np.ones(len(rows), np.int8) if pattern_only
                else np.concatenate(vals))
        M = sp.coo_matrix(
            (data, (rows, np.concatenate(cols))), shape=self.shape)
        return M.tocsr()


# ---------------------------------------------------------------------------
# Compiled form
# ---------------------------------------------------------------------------


class CompiledForm:
    """A FormDef compiled against its mesh: precomputed terms + jitted entry
    points (cached on first use)."""

    def __init__(self, form: FormDef):
        self.form = form
        self.global_names = list(getattr(form, "globals", {}).keys())
        spaces = {name: f.space for name, f in form.coeffs.items()}
        meshes = {id(V.mesh) for V in spaces.values()}
        if form.test is not None:
            spaces["__test__"] = form.test
            meshes.add(id(form.test.mesh))
        if len(meshes) > 1:
            raise ValueError("all spaces in a form must share one mesh")
        self.spaces = spaces
        some_space = next(iter(spaces.values()))
        self.mesh: Mesh = some_space.mesh
        self.default_qdeg = max(
            max((V.element.degree * 2) for V in spaces.values()), 2
        )
        if any(V.element.family == "Hermite" for V in spaces.values()):
            self.default_qdeg = max(self.default_qdeg, 6)
        self.terms = [_Term(i, self) for i in form.integrals]
        self.coeff_names = list(form.coeffs.keys())
        self.all_names = self.coeff_names + self.global_names
        self._jit_cache: dict = {}

    # -- raw (unjitted) entry points -------------------------------------------
    def scalar(self, values: dict) -> jnp.ndarray:
        vals = {n: values[n] for n in self.all_names}
        return sum(t.scalar(vals) for t in self.terms)

    def vector(self, values: dict) -> jnp.ndarray:
        assert self.form.test is not None, "vector assembly needs a test space"
        n = self.form.test.n_dofs
        vals = {k: values[k] for k in self.all_names}
        out = jnp.zeros(n, config.jdtype)
        for t in self.terms:
            contrib, rows = t.residual_contrib(vals, "__test__")
            out = out + _segment_sum(contrib, rows, n)
        return out

    def matrix(self, values: dict, wrt: str) -> ElementMatrix:
        assert self.form.test is not None
        vals = {k: values[k] for k in self.all_names}
        blocks = []
        for t in self.terms:
            A, rows, cols = t.matrix_blocks(vals, "__test__", wrt)
            blocks.append(MatBlock(A, rows, cols))
        ncols = self.form.coeffs[wrt].space.n_dofs
        return ElementMatrix(blocks, self.form.test.n_dofs, ncols)

    def matrix_pattern(self, wrt: str) -> ElementMatrix:
        """Pattern-only ElementMatrix: rows/cols from the precomputed
        dofmaps, values a broadcast-zero dummy.  Use this (not the eager
        `matrix()`) to build BlockTridiagTemplate prototypes — it runs
        ZERO element kernels, while the unjitted matrix() path executes
        hundreds of tiny eager ops at build time.  The pattern includes mask-zeroed entries, exactly like
        the value path's scatter (they contribute explicit zeros)."""
        assert self.form.test is not None
        blocks = []
        for t in self.terms:
            rows = np.asarray(t.gdofs0["__test__"])
            cols = np.asarray(t.gdofs0[wrt])
            if t.domain == "interior_facet":
                rows = np.concatenate(
                    [rows, np.asarray(t.gdofs1["__test__"])], axis=1)
                cols = np.concatenate(
                    [cols, np.asarray(t.gdofs1[wrt])], axis=1)
            A = np.broadcast_to(
                np.zeros((), config.dtype),
                (rows.shape[0], rows.shape[1], cols.shape[1]))
            blocks.append(MatBlock(A, rows, cols))
        ncols = self.form.coeffs[wrt].space.n_dofs
        return ElementMatrix(blocks, self.form.test.n_dofs, ncols)

    # -- data-as-arguments entry points ------------------------------------------
    # Per-entity term data (dofmaps, coords, tags) is normally closed over
    # by jitted kernels as constants.  At reference scale those constants
    # are tens of MB per program, so these variants extract the data as a
    # pytree the caller threads through jit ARGUMENTS instead.
    _DATA_KEYS = ("coords0", "h", "tag", "ctag0", "ctag1", "var0",
                  "cent0", "coords1", "var1")

    def term_data(self) -> list[dict]:
        """Extract each term's entity data as a pytree of arrays."""
        trees = []
        for t in self.terms:
            d = {k: getattr(t, k) for k in self._DATA_KEYS if hasattr(t, k)}
            d["gdofs0"] = dict(t.gdofs0)
            if hasattr(t, "gdofs1"):
                d["gdofs1"] = dict(t.gdofs1)
            trees.append(d)
        return trees

    def scalar_from_data(self, values: dict, datas: list) -> jnp.ndarray:
        vals = {n: values[n] for n in self.all_names if n in values}
        return sum(t.scalar(vals, SimpleNamespace(**d))
                   for t, d in zip(self.terms, datas))

    def vector_from_data(self, values: dict, datas: list,
                         chunk: int | None = None) -> jnp.ndarray:
        n = self.form.test.n_dofs
        vals = {k: values[k] for k in self.all_names if k in values}
        out = jnp.zeros(n, config.jdtype)
        for t, d in zip(self.terms, datas):
            contrib, rows = t.residual_contrib(
                vals, "__test__", SimpleNamespace(**d), chunk=chunk)
            out = out + _segment_sum(contrib, rows, n)
        return out

    def matrix_blocks_from_data(self, values: dict, wrt: str, datas: list,
                                chunk: int | None = None):
        """[(A, rows, cols), ...] with data passed as traced arguments."""
        vals = {k: values[k] for k in self.all_names if k in values}
        out = []
        for t, d in zip(self.terms, datas):
            out.append(t.matrix_blocks(
                vals, "__test__", wrt, SimpleNamespace(**d), chunk=chunk))
        return out

    # -- jitted cached wrappers -------------------------------------------------
    def scalar_jit(self):
        if "scalar" not in self._jit_cache:
            self._jit_cache["scalar"] = jax.jit(
                lambda values: self.scalar(values))
        return self._jit_cache["scalar"]

    def vector_jit(self):
        if "vector" not in self._jit_cache:
            self._jit_cache["vector"] = jax.jit(
                lambda values: self.vector(values))
        return self._jit_cache["vector"]

    def matrix_blocks_jit(self, wrt: str):
        key = ("mat", wrt)
        if key not in self._jit_cache:
            def f(values):
                m = self.matrix(values, wrt)
                return [(b.A, b.rows, b.cols) for b in m.blocks]

            self._jit_cache[key] = jax.jit(f)
        return self._jit_cache[key]


def compile_form(form: FormDef) -> CompiledForm:
    if form._assembler is None:
        form._assembler = CompiledForm(form)
    return form._assembler


# ---------------------------------------------------------------------------
# Public assembly API (reference utils_dolfinx.py assemble* parity)
# ---------------------------------------------------------------------------


def assemble_scalar(form: FormDef, values: dict | None = None) -> float:
    cf = compile_form(form)
    v = form.values()
    if values:
        v.update(values)
    return cf.scalar_jit()(v)


def assemble_vector(form: FormDef, values: dict | None = None) -> jnp.ndarray:
    cf = compile_form(form)
    v = form.values()
    if values:
        v.update(values)
    return cf.vector_jit()(v)


def assemble_matrix(form: FormDef, wrt: str,
                    values: dict | None = None) -> ElementMatrix:
    cf = compile_form(form)
    v = form.values()
    if values:
        v.update(values)
    blocks = cf.matrix_blocks_jit(wrt)(v)
    ncols = form.coeffs[wrt].space.n_dofs
    return ElementMatrix(
        [MatBlock(*b) for b in blocks], form.test.n_dofs, ncols)
