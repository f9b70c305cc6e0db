"""Function spaces, dofmaps, and Functions.

JAX replacement for `dolfinx.fem.FunctionSpace` / `Function`
(SURVEY.md N2/N3).  A FunctionSpace is: an Element + a host-built dofmap
(cell -> global dof indices, one int32 array, static shape) + dof coordinates
for boundary-condition location and interpolation.  A Function is a named
handle around a flat jax dof array (`function.x.array` parity:
/root/reference/femo/fea/fea_dolfinx.py:100-127 stores functions by name).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import config
from ..elements.element import Element, CELL_NUM_VERTICES
from ..mesh.mesh import Mesh

_FAMILY_ALIASES = {"CG": "P", "Lagrange": "P", "P": "P", "DG": "DG",
                   "Hermite": "Hermite"}


class FunctionSpace:
    """A finite element space over a mesh.

    Parameters
    ----------
    mesh : Mesh
    spec : ("CG", 1) style tuple, or an Element
    ncomp : vector components (shape parity with dolfinx VectorFunctionSpace)
    """

    def __init__(self, mesh: Mesh, spec, ncomp: int = 1):
        self.mesh = mesh
        if isinstance(spec, Element):
            self.element = spec
        else:
            family, degree = spec
            self.element = Element(
                mesh.cell_type, _FAMILY_ALIASES[family], int(degree), ncomp
            )
        self._build_dofmap()

    # -- dofmap construction (host, numpy) ------------------------------------
    def _build_dofmap(self):
        mesh, el = self.mesh, self.element
        per = el.entity_dofs  # scalar dofs per (vertex, edge, [face], [cell])
        nv = CELL_NUM_VERTICES[mesh.cell_type]
        nc = mesh.n_cells

        if el.family == "DG":
            nsd = el.nscalar_dofs
            scalar_map = (
                np.arange(nc, dtype=np.int64)[:, None] * nsd
                + np.arange(nsd)[None, :]
            )
            n_scalar = nc * nsd
        else:
            blocks = []
            offset = 0
            pv = per[0]
            if pv:
                vm = mesh.cells.astype(np.int64)  # (nc, nv)
                blk = vm[:, :, None] * pv + np.arange(pv)[None, None, :]
                blocks.append(blk.reshape(nc, nv * pv))
                offset += mesh.n_nodes * pv
            pe = per[1] if len(per) > 1 else 0
            if pe:
                em = mesh.cell_edge_map.astype(np.int64)
                blk = offset + em[:, :, None] * pe + np.arange(pe)[None, None, :]
                blocks.append(blk.reshape(nc, -1))
                offset += len(mesh.edges) * pe
            # interior cell dofs (e.g. Q2 center)
            n_listed = sum(b.shape[1] for b in blocks)
            n_interior = el.nscalar_dofs - n_listed
            if n_interior > 0:
                blk = (
                    offset
                    + np.arange(nc, dtype=np.int64)[:, None] * n_interior
                    + np.arange(n_interior)[None, :]
                )
                blocks.append(blk)
                offset += nc * n_interior
            scalar_map = np.concatenate(blocks, axis=1)
            n_scalar = offset

        self.n_scalar_dofs = int(n_scalar)
        ncp = el.ncomp
        if ncp == 1:
            dofmap = scalar_map
        else:
            dofmap = (
                scalar_map[:, :, None] * ncp + np.arange(ncp)[None, None, :]
            ).reshape(nc, -1)
        self.dofmap = dofmap.astype(np.int32)
        self.n_dofs = int(n_scalar * ncp)

        # scalar-dof coordinates (vertex -> vertex coords, edge -> midpoint,
        # interior -> centroid); Hermite derivative dofs share vertex coords.
        coords = np.zeros((n_scalar, mesh.gdim))
        kind = np.zeros(n_scalar, np.int8)  # 0 point-eval, 1 derivative
        if el.family == "DG":
            cent = mesh.coords[mesh.cells].mean(axis=1)
            if el.nscalar_dofs == 1:
                coords[:] = cent
            else:  # DG1: vertex positions per cell
                coords = mesh.coords[mesh.cells].reshape(-1, mesh.gdim)
        else:
            pv = per[0]
            if pv:
                for k in range(pv):
                    coords[np.arange(mesh.n_nodes) * pv + k] = mesh.coords
                    if el.family == "Hermite" and k == 1:
                        kind[np.arange(mesh.n_nodes) * pv + k] = 1
            off = mesh.n_nodes * pv
            pe = per[1] if len(per) > 1 else 0
            if pe:
                mids = mesh.coords[mesh.edges].mean(axis=1)
                for k in range(pe):
                    coords[off + np.arange(len(mesh.edges)) * pe + k] = mids
                off += len(mesh.edges) * pe
            if off < n_scalar:
                n_int = (n_scalar - off) // nc
                cent = mesh.coords[mesh.cells].mean(axis=1)
                for k in range(n_int):
                    coords[off + np.arange(nc) * n_int + k] = cent
        self.scalar_dof_coords = coords
        self.scalar_dof_kind = kind

    # -- public helpers --------------------------------------------------------
    @property
    def ncomp(self) -> int:
        return self.element.ncomp

    @property
    def shape(self) -> int:
        """Flat dof-vector length (reference `shape` parity)."""
        return self.n_dofs

    def dof_coords(self) -> np.ndarray:
        """(n_dofs, gdim) coordinate of each dof (components share coords)."""
        c = self.scalar_dof_coords
        if self.ncomp == 1:
            return c
        return np.repeat(c, self.ncomp, axis=0)

    def locate_dofs_geometrical(self, predicate, component=None) -> np.ndarray:
        """Dof indices whose node satisfies predicate(x: (gdim, n)) -> bool.

        Parity: dolfinx.fem.locate_dofs_geometrical used in every example,
        e.g. run_poisson_opt.py:123-131. Predicate takes coords transposed
        (gdim, n_points) to match the reference's `lambda x: x[0] == 0` style.
        Derivative dofs (Hermite) at matching nodes are included, matching
        the reference's clamped-beam usage.
        """
        mask = np.asarray(predicate(self.scalar_dof_coords.T), bool)
        scalar_ids = np.nonzero(mask)[0]
        if self.ncomp == 1:
            return scalar_ids.astype(np.int32)
        if component is None:
            return (
                (scalar_ids[:, None] * self.ncomp + np.arange(self.ncomp)[None, :])
                .reshape(-1)
                .astype(np.int32)
            )
        return (scalar_ids * self.ncomp + component).astype(np.int32)

    def new_array(self, val: float = 0.0) -> jnp.ndarray:
        from ..utils.arrays import asdev
        return asdev(np.full((self.n_dofs,), val, config.dtype))

    def __repr__(self):
        e = self.element
        return (
            f"FunctionSpace({e.family}{e.degree}"
            + (f"^{e.ncomp}" if e.ncomp > 1 else "")
            + f" on {self.mesh}, n_dofs={self.n_dofs})"
        )


class _XShim:
    """`function.x.array` compatibility shim (dolfinx API parity)."""

    def __init__(self, f: "Function"):
        self._f = f

    @property
    def array(self):
        return np.asarray(self._f.array)

    @array.setter
    def array(self, v):
        self._f.array = jnp.asarray(np.broadcast_to(v, (self._f.space.n_dofs,)),
                                    dtype=config.jdtype)


class Function:
    """A named dof vector in a FunctionSpace.

    Mutable `.array` makes chained problems natural: the motor workload
    registers the *same* Function as mesh-motion state and EM input
    (/root/reference/examples/em_motor_opt/run_motor_opt.py:299-304); here the
    shared object identity plays the same role in the graph layer.
    """

    def __init__(self, space: FunctionSpace, name: str | None = None,
                 array=None):
        self.space = space
        self.name = name or "f"
        self.array = (
            space.new_array() if array is None
            else jnp.asarray(array, dtype=config.jdtype)
        )
        self.x = _XShim(self)

    def rename(self, name: str, *_):
        self.name = name

    def copy(self) -> "Function":
        return Function(self.space, self.name, self.array)

    def set(self, val: float):
        self.array = self.space.new_array(val)

    def interpolate(self, fn, deriv_fn=None):
        """Interpolate fn(x: (gdim, n)) -> values at point-evaluation dofs.

        Parity: Function.interpolate / add_exact_solution
        (fea_dolfinx.py:163-167). For vector spaces fn returns (ncomp, n).
        For Hermite spaces, deriv_fn supplies derivative-dof values.
        """
        V = self.space
        vals = np.asarray(fn(V.scalar_dof_coords.T))
        arr = np.zeros(V.n_dofs)
        if V.ncomp == 1:
            arr[:] = vals if vals.ndim == 1 else vals[0]
        else:
            for c in range(V.ncomp):
                arr[c:: V.ncomp] = vals[c]
        if (V.scalar_dof_kind == 1).any():
            dmask = np.repeat(V.scalar_dof_kind == 1, V.ncomp)
            if deriv_fn is not None:
                dvals = np.asarray(deriv_fn(V.scalar_dof_coords.T))
                arr[dmask] = dvals[V.scalar_dof_kind == 1]
            else:
                arr[dmask] = 0.0
        self.array = jnp.asarray(arr, dtype=config.jdtype)
        return self

    @property
    def vector(self):
        return self.array

    def __repr__(self):
        return f"Function('{self.name}', {self.space})"


class TestFunction:
    """Marker for the test space of a residual form (UFL TestFunction parity)."""

    def __init__(self, space: FunctionSpace):
        self.space = space
