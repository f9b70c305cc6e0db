"""Device-friendly mesh representation and topology derivation.

JAX replacement for the dolfinx C++ mesh core (SURVEY.md N2): the mesh
is plain arrays — vertex coordinates plus cell->vertex connectivity — with
derived topology (edges, facets, facet->cell incidence) computed once
host-side in numpy and reused by dofmap construction and facet assembly.

Unlike dolfinx there is no distributed IndexMap here: distribution happens at
the assembly level by sharding *cells* over the device mesh (see
femo_tpu/parallel/), with dof vectors held replicated or sharded by pjit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..elements.element import CELL_FACETS, CELL_EDGES, CELL_DIM


@dataclass
class MeshTopology:
    """Derived topology, computed lazily from cell->vertex connectivity."""

    # unique edges as sorted vertex pairs, (n_edges, 2)
    edges: np.ndarray | None = None
    # per-cell edge indices, (n_cells, n_local_edges)
    cell_edges: np.ndarray | None = None
    # unique facets as sorted vertex tuples, (n_facets, nv_facet)
    facets: np.ndarray | None = None
    # per-facet incident cells / local facet indices, -1 when absent:
    # (n_facets, 2) each
    facet_cells: np.ndarray | None = None
    facet_local: np.ndarray | None = None
    # boolean mask of exterior (boundary) facets
    exterior_mask: np.ndarray | None = None
    # per-cell facet indices (n_cells, n_local_facets)
    cell_facets: np.ndarray | None = None


class Mesh:
    """An unstructured single-cell-type mesh.

    Parameters
    ----------
    coords : (n_nodes, gdim) float array of vertex coordinates
    cells : (n_cells, n_cell_vertices) int array of vertex indices
    cell_type : one of "interval", "triangle", "quad", "tet", "hex"
    cell_tags : optional (n_cells,) int subdomain markers
    facet_tags : optional dict mapping facet key tuple -> tag, or array
    """

    def __init__(self, coords, cells, cell_type, cell_tags=None):
        self.coords = np.ascontiguousarray(coords, dtype=np.float64)
        self.cells = np.ascontiguousarray(cells, dtype=np.int32)
        self.cell_type = cell_type
        self.cell_tags = (
            None if cell_tags is None else np.asarray(cell_tags, dtype=np.int32)
        )
        self._facet_tag_array: np.ndarray | None = None  # (n_facets,) int
        self._topo = MeshTopology()

    # -- basic sizes ---------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def gdim(self) -> int:
        return self.coords.shape[1]

    @property
    def tdim(self) -> int:
        return CELL_DIM[self.cell_type]

    # -- topology ------------------------------------------------------------
    def _build_edges(self):
        if self._topo.edges is not None:
            return
        led = CELL_EDGES[self.cell_type]
        if not led:
            self._topo.edges = np.zeros((0, 2), np.int32)
            self._topo.cell_edges = np.zeros((self.n_cells, 0), np.int32)
            return
        pairs = np.sort(
            self.cells[:, np.asarray(led)].reshape(-1, 2), axis=1
        )  # (n_cells*n_led, 2)
        edges, inv = np.unique(pairs, axis=0, return_inverse=True)
        self._topo.edges = edges.astype(np.int32)
        self._topo.cell_edges = inv.reshape(self.n_cells, len(led)).astype(np.int32)

    def _build_facets(self):
        if self._topo.facets is not None:
            return
        lfs = CELL_FACETS[self.cell_type]
        nlf = len(lfs)
        nvf = len(lfs[0])
        keys = np.sort(
            self.cells[:, np.asarray(lfs)].reshape(-1, nvf), axis=1
        )  # (n_cells*nlf, nvf)
        facets, inv = np.unique(keys, axis=0, return_inverse=True)
        nf = len(facets)
        facet_cells = np.full((nf, 2), -1, np.int32)
        facet_local = np.full((nf, 2), -1, np.int32)
        cell_idx = np.repeat(np.arange(self.n_cells, dtype=np.int32), nlf)
        local_idx = np.tile(np.arange(nlf, dtype=np.int32), self.n_cells)
        # stable fill: first incidence in slot 0, second in slot 1
        order = np.argsort(inv, kind="stable")
        inv_s, cell_s, loc_s = inv[order], cell_idx[order], local_idx[order]
        first = np.ones(nf, bool)
        starts = np.searchsorted(inv_s, np.arange(nf))
        counts = np.bincount(inv_s, minlength=nf)
        facet_cells[:, 0] = cell_s[starts]
        facet_local[:, 0] = loc_s[starts]
        two = counts == 2
        facet_cells[two, 1] = cell_s[starts[two] + 1]
        facet_local[two, 1] = loc_s[starts[two] + 1]
        self._topo.facets = facets.astype(np.int32)
        self._topo.facet_cells = facet_cells
        self._topo.facet_local = facet_local
        self._topo.exterior_mask = counts == 1
        self._topo.cell_facets = inv.reshape(self.n_cells, nlf).astype(np.int32)

    @property
    def edges(self):
        self._build_edges()
        return self._topo.edges

    @property
    def cell_edge_map(self):
        self._build_edges()
        return self._topo.cell_edges

    @property
    def facets(self):
        self._build_facets()
        return self._topo.facets

    @property
    def facet_cells(self):
        self._build_facets()
        return self._topo.facet_cells

    @property
    def facet_local(self):
        self._build_facets()
        return self._topo.facet_local

    @property
    def exterior_facets(self) -> np.ndarray:
        """Indices of boundary facets."""
        self._build_facets()
        return np.nonzero(self._topo.exterior_mask)[0].astype(np.int32)

    @property
    def interior_facets(self) -> np.ndarray:
        self._build_facets()
        return np.nonzero(~self._topo.exterior_mask)[0].astype(np.int32)

    @property
    def n_facets(self) -> int:
        return len(self.facets)

    # -- facet tags ----------------------------------------------------------
    @property
    def facet_tags(self) -> np.ndarray:
        """(n_facets,) int tag array (0 = untagged)."""
        if self._facet_tag_array is None:
            self._facet_tag_array = np.zeros(self.n_facets, np.int32)
        return self._facet_tag_array

    def mark_facets(self, tag: int, predicate) -> int:
        """Tag facets whose *all* vertices satisfy predicate(x).

        predicate takes coords transposed (gdim, n_pts) -> bool array,
        matching the reference's `lambda x: np.isclose(x[0], 0)` style
        (dolfinx `locate_entities_boundary`). Returns count marked.
        """
        fverts = self.facets  # (n_facets, nvf)
        ok = np.asarray(
            predicate(self.coords[fverts.reshape(-1)].T)
        ).reshape(fverts.shape)
        mask = ok.all(axis=1)
        self.facet_tags[mask] = tag
        return int(mask.sum())

    def mark_boundary_facets(self, tag: int, predicate=None) -> int:
        ext = self.exterior_facets
        fverts = self.facets[ext]
        if predicate is None:
            mask = np.ones(len(ext), bool)
        else:
            ok = np.asarray(
                predicate(self.coords[fverts.reshape(-1)].T)
            ).reshape(fverts.shape)
            mask = ok.all(axis=1)
        self.facet_tags[ext[mask]] = tag
        return int(mask.sum())

    def mark_cells(self, tag: int, predicate) -> int:
        """Tag cells whose centroid satisfies predicate(x)."""
        if self.cell_tags is None:
            self.cell_tags = np.zeros(self.n_cells, np.int32)
        cents = self.coords[self.cells].mean(axis=1)
        mask = predicate(cents.T)
        self.cell_tags[mask] = tag
        return int(mask.sum())

    # -- geometry helpers ----------------------------------------------------
    def cell_sizes(self) -> np.ndarray:
        """Characteristic cell size (max vertex-pair distance per cell)."""
        pts = self.coords[self.cells]  # (nc, nv, gdim)
        d = np.linalg.norm(pts[:, :, None, :] - pts[:, None, :, :], axis=-1)
        return d.max(axis=(1, 2))

    def cell_volumes(self) -> np.ndarray:
        pts = self.coords[self.cells]
        ct = self.cell_type
        if ct == "interval":
            return np.linalg.norm(pts[:, 1] - pts[:, 0], axis=-1)
        if ct == "triangle":
            a = pts[:, 1] - pts[:, 0]
            b = pts[:, 2] - pts[:, 0]
            return 0.5 * np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
        if ct == "quad":
            a = pts[:, 1] - pts[:, 0]
            b = pts[:, 2] - pts[:, 0]
            c = pts[:, 3] - pts[:, 0]
            t1 = 0.5 * np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
            t2 = 0.5 * np.abs(
                (c - a)[:, 0] * (c - b)[:, 1] - (c - a)[:, 1] * (c - b)[:, 0]
            )
            return t1 + t2
        if ct == "tet":
            a = pts[:, 1] - pts[:, 0]
            b = pts[:, 2] - pts[:, 0]
            c = pts[:, 3] - pts[:, 0]
            return np.abs(np.einsum("ij,ij->i", a, np.cross(b, c))) / 6.0
        if ct == "hex":
            # exact trilinear volume: detJ is degree <= 2 per variable, so
            # a 2x2x2 Gauss rule integrates it exactly
            from ..elements.element import geometry_element
            from ..elements.quadrature import cell_rule

            qp, qw = cell_rule("hex", 3)
            _, dNg = geometry_element("hex").tabulate(qp)  # (nq, 8, 3)
            J = np.einsum("cai,qat->cqit", pts, dNg)
            return np.abs(np.linalg.det(J)) @ qw
        raise NotImplementedError(ct)

    def min_cell_size(self) -> float:
        return float(self.cell_sizes().min())

    def __repr__(self) -> str:
        return (
            f"Mesh({self.cell_type}, {self.n_cells} cells, "
            f"{self.n_nodes} nodes, gdim={self.gdim})"
        )
