"""Dof-sharded SPMD operators with halo exchange.

The full analogue of dolfinx/PETSc distributed vectors (SURVEY.md N7):
where `parallel/sharding.py` keeps dof vectors replicated (cheap at small
scale), this mode shards *dofs* across devices — each device owns a
contiguous block of renumbered dofs plus ghost copies of its partition
boundary — and reproduces both directions of PETSc's `ghostUpdate`
(/root/reference/femo/fea/utils_dolfinx.py:167,200,271):

  forward  (INSERT): owner values -> ghost copies        before gathers
  reverse  (ADD):    ghost partial sums -> owner slots   after scatters

Both are `jax.lax.all_to_all` exchanges of precomputed, padded send lists —
communication is O(partition boundary), not O(n), over the device
interconnect inside shard_map.  Krylov dot products are psum-reduced
partial dots over owned dofs.  Cell ownership comes from the native RCB partitioner, so partition
boundaries are spatially small.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh as DeviceMesh, PartitionSpec as P

from ..config import config
from ..fea.assemble import ElementMatrix

AXIS = "cells"


@dataclass
class HaloLayout:
    """Per-device index maps (stacked over the device axis)."""

    ndev: int
    n_owned: np.ndarray  # (ndev,) actual owned counts
    L: int  # padded owned slots per device
    G: int  # padded ghost slots per device
    S: int  # padded exchange slots per (src, dst) pair
    owned_global: np.ndarray  # (ndev, L) global dof id per owned slot (-pad)
    # forward exchange: device o sends x_local[send_slot[o, r, s]] to r,
    # which stores it at ghost slot s of segment o
    send_slot: np.ndarray  # (ndev, ndev, S) owned-slot index or 0
    send_mask: np.ndarray  # (ndev, ndev, S)
    recv_ghost_slot: np.ndarray  # (ndev, ndev, S) ghost slot or 0
    recv_mask: np.ndarray  # (ndev, ndev, S)
    owner_of: np.ndarray  # (n,) owning device of each global dof
    local_of: np.ndarray  # (n,) owned slot of each global dof on its owner


def build_halo_layout(dofmap: np.ndarray, n_dofs: int, cell_part: np.ndarray,
                      ndev: int) -> HaloLayout:
    """Derive ownership, ghosts, and exchange lists from a cell partition."""
    nc, nd = dofmap.shape
    # dof owner = min partition index among touching cells (deterministic)
    flat = dofmap.reshape(-1)
    cell_of_entry = np.repeat(np.arange(nc), nd)
    order = np.argsort(flat, kind="stable")
    fsort = flat[order]
    csort = cell_part[cell_of_entry[order]]
    first = np.searchsorted(fsort, np.arange(n_dofs))
    # min partition among all touching cells (deterministic, balanced enough)
    owner = np.minimum.reduceat(
        csort, np.clip(first, 0, len(csort) - 1)).astype(np.int32)

    owned_lists = [np.nonzero(owner == d)[0] for d in range(ndev)]
    L = max(max(len(o) for o in owned_lists), 1)
    owned_global = np.zeros((ndev, L), np.int64)
    local_of = np.zeros(n_dofs, np.int32)
    n_owned = np.zeros(ndev, np.int64)
    for d, o in enumerate(owned_lists):
        owned_global[d, : len(o)] = o
        local_of[o] = np.arange(len(o))
        n_owned[d] = len(o)

    # ghosts per device: dofs of local cells not owned locally
    ghost_lists = []
    for d in range(ndev):
        dofs = np.unique(dofmap[cell_part == d].reshape(-1))
        ghost_lists.append(dofs[owner[dofs] != d])
    G = max(max(len(g) for g in ghost_lists), 1)

    # exchange lists
    S = 1
    pair_dofs = {}
    for r in range(ndev):
        g = ghost_lists[r]
        for o in range(ndev):
            sel = g[owner[g] == o]
            pair_dofs[(o, r)] = sel
            S = max(S, len(sel))
    send_slot = np.zeros((ndev, ndev, S), np.int32)
    send_mask = np.zeros((ndev, ndev, S), bool)
    recv_ghost_slot = np.zeros((ndev, ndev, S), np.int32)
    recv_mask = np.zeros((ndev, ndev, S), bool)
    ghost_index = [dict() for _ in range(ndev)]
    for r in range(ndev):
        for k, gd in enumerate(ghost_lists[r]):
            ghost_index[r][gd] = k
    for (o, r), sel in pair_dofs.items():
        k = len(sel)
        send_slot[o, r, :k] = local_of[sel]
        send_mask[o, r, :k] = True
        recv_ghost_slot[r, o, :k] = [ghost_index[r][gd] for gd in sel]
        recv_mask[r, o, :k] = True

    return HaloLayout(ndev, n_owned, L, G, S, owned_global,
                      send_slot, send_mask, recv_ghost_slot, recv_mask,
                      owner, local_of)


class HaloShardedOperator:
    """Dof-sharded element-form operator over a 1D device mesh.

    Vectors are (ndev, L) arrays sharded on axis 0 (owned slots, padded).
    matvec performs: forward halo -> local gather/einsum/segment_sum ->
    reverse halo (add ghost partials to owners).
    """

    def __init__(self, emat: ElementMatrix, dofmap: np.ndarray, n_dofs: int,
                 dmesh: DeviceMesh, free=None):
        from .. import native

        ndev = dmesh.devices.size
        self.dmesh = dmesh
        self.n = n_dofs
        b = emat.blocks[0]
        A_e = np.asarray(b.A)
        rows = np.asarray(b.rows)
        cols = np.asarray(b.cols)
        # extra blocks folded in by concatenation (same dofmap family)
        for blk in emat.blocks[1:]:
            A_e = np.concatenate([A_e, np.asarray(blk.A)])
            rows = np.concatenate([rows, np.asarray(blk.rows)])
            cols = np.concatenate([cols, np.asarray(blk.cols)])
        # partition elements by their first-row dof index order (proxy for
        # geometry when coords are unavailable at this level)
        part = native.rcb_partition(
            rows[:, :1].astype(np.float64), ndev)
        lay = build_halo_layout(rows, n_dofs, part, ndev)
        self.layout = lay

        # local element arrays per device (padded to equal count)
        CE = max(int(np.bincount(part, minlength=ndev).max()), 1)
        nr = rows.shape[1]
        A_l = np.zeros((ndev, CE) + A_e.shape[1:], A_e.dtype)
        r_l = np.zeros((ndev, CE, nr), np.int32)
        c_l = np.zeros((ndev, CE, cols.shape[1]), np.int32)
        m_l = np.zeros((ndev, CE), A_e.dtype)

        def to_local(d, gdofs):
            """Global dof -> local slot: owned -> [0, L); ghost -> L + slot."""
            out = np.zeros_like(gdofs, np.int32)
            own = lay.owner_of[gdofs] == d
            out[own] = lay.local_of[gdofs[own]]
            gh = ~own
            gidx = {g: k for k, g in enumerate(self._ghosts(d))}
            out[gh] = lay.L + np.array(
                [gidx[g] for g in gdofs[gh]], np.int32)
            return out

        self._ghost_cache = {}
        self._lay_for_ghosts = (rows, part, ndev)
        for d in range(ndev):
            sel = np.nonzero(part == d)[0]
            k = len(sel)
            A_l[d, :k] = A_e[sel]
            m_l[d, :k] = 1.0
            r_l[d, :k] = to_local(d, rows[sel])
            c_l[d, :k] = to_local(d, cols[sel])
        f = config.jdtype
        self.A_l = jnp.asarray(A_l, f)
        self.r_l = jnp.asarray(r_l)
        self.c_l = jnp.asarray(c_l)
        self.m_l = jnp.asarray(m_l, f)
        self.free_l = (None if free is None
                       else self.scatter_vector(np.asarray(free, float)))

        lay_j = lambda a: jnp.asarray(a)
        self.send_slot = lay_j(lay.send_slot)
        self.send_mask = lay_j(lay.send_mask.astype(f))
        self.recv_ghost_slot = lay_j(lay.recv_ghost_slot)
        self.recv_mask = lay_j(lay.recv_mask.astype(f))
        self._build_fns()

    def _ghosts(self, d):
        if d not in self._ghost_cache:
            rows, part, ndev = self._lay_for_ghosts
            lay = self.layout
            dofs = np.unique(rows[part == d].reshape(-1))
            self._ghost_cache[d] = dofs[lay.owner_of[dofs] != d]
        return self._ghost_cache[d]

    # -- vector scatter/gather ---------------------------------------------------
    def scatter_vector(self, x) -> jnp.ndarray:
        """Global (n,) -> sharded-owned (ndev, L)."""
        lay = self.layout
        xp = np.zeros((lay.ndev, lay.L), np.asarray(x).dtype)
        for d in range(lay.ndev):
            k = int(lay.n_owned[d])
            xp[d, :k] = np.asarray(x)[lay.owned_global[d, :k]]
        return jnp.asarray(xp)

    def gather_vector(self, xl) -> jnp.ndarray:
        """Sharded-owned (ndev, L) -> global (n,)."""
        lay = self.layout
        out = np.zeros(self.n, np.asarray(xl).dtype)
        xl = np.asarray(xl)
        for d in range(lay.ndev):
            k = int(lay.n_owned[d])
            out[lay.owned_global[d, :k]] = xl[d, :k]
        return jnp.asarray(out)

    # -- SPMD kernels --------------------------------------------------------------
    def _build_fns(self):
        lay = self.layout
        L, G, S = lay.L, lay.G, lay.S
        n_loc = L + G

        def fwd_halo(x_own, send_slot, send_mask, recv_slot, recv_mask):
            """Owner values -> ghost slots (INSERT). Inside shard_map, all
            args are this device's rows: x_own (L,), maps (ndev, S)."""
            send = x_own[send_slot] * send_mask  # (ndev, S)
            recv = jax.lax.all_to_all(send, AXIS, 0, 0, tiled=False)
            ghosts = jnp.zeros(G, x_own.dtype)
            ghosts = ghosts.at[recv_slot.reshape(-1)].add(
                (recv * recv_mask).reshape(-1))
            return ghosts

        def rev_halo(gh_partial, send_slot, send_mask, recv_slot, recv_mask):
            """Ghost partials -> owner slots (ADD): reverse of fwd_halo."""
            send = gh_partial[recv_slot] * recv_mask  # (ndev, S)
            recv = jax.lax.all_to_all(send, AXIS, 0, 0, tiled=False)
            add = jnp.zeros(L, gh_partial.dtype)
            add = add.at[send_slot.reshape(-1)].add(
                (recv * send_mask).reshape(-1))
            return add

        def local_mv(x_own, A, r, c, m, ss, sm, rs, rm):
            # shard_map blocks keep the sharded leading axis (size 1)
            x_own, A, r, c, m = x_own[0], A[0], r[0], c[0], m[0]
            ss, sm, rs, rm = ss[0], sm[0], rs[0], rm[0]
            ghosts = fwd_halo(x_own, ss, sm, rs, rm)
            x_loc = jnp.concatenate([x_own, ghosts])
            xe = x_loc[c]
            ye = jnp.einsum("eij,ej->ei", A, xe) * m[:, None]
            y_loc = jax.ops.segment_sum(
                ye.reshape(-1), r.reshape(-1), num_segments=n_loc)
            y_own = y_loc[:L] + rev_halo(y_loc[L:], ss, sm, rs, rm)
            return y_own[None]

        self._mv_smapped = shard_map(
            local_mv, mesh=self.dmesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                      P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=P(AXIS),
        )

        def dot(xl, yl):
            def local(x, y):
                return jax.lax.psum(jnp.vdot(x[0], y[0]), AXIS)

            return shard_map(local, mesh=self.dmesh,
                             in_specs=(P(AXIS), P(AXIS)),
                             out_specs=P())(xl, yl)

        self.dot = dot

    def matvec(self, xl):
        """Sharded matvec on (ndev, L) owned vectors (padding slots = 0).

        With BCs: the constrained operator P A P + (I - P), matching the
        single-device convention (zero rows AND columns, unit diagonal)."""
        x_in = xl
        if self.free_l is not None:
            x_in = jnp.where(self.free_l > 0.5, xl, 0.0)
        y = self._mv_smapped(x_in, self.A_l, self.r_l, self.c_l, self.m_l,
                             self.send_slot, self.send_mask,
                             self.recv_ghost_slot, self.recv_mask)
        if self.free_l is not None:
            y = jnp.where(self.free_l > 0.5, y, xl)
        return y

    # -- diagonal (for local Jacobi preconditioning, no communication) -----------
    def diagonal(self):
        """Owned-slot diagonal of the constrained operator, (ndev, L)."""
        if not hasattr(self, "_diag"):
            ndev, CE = self.A_l.shape[:2]
            d = np.zeros((ndev, self.layout.L + self.layout.G))
            A = np.asarray(self.A_l)
            r = np.asarray(self.r_l)
            c = np.asarray(self.c_l)
            m = np.asarray(self.m_l)
            nr = r.shape[2]
            for dev in range(ndev):
                for i in range(nr):
                    same = r[dev, :, i] == c[dev, :, i]
                    np.add.at(d[dev], r[dev, :, i],
                              A[dev, :, i, i] * m[dev] * same)
            # ghost-slot partials belong to owners: fold back on host
            own = d[:, : self.layout.L]
            gl = self.gather_vector(jnp.asarray(own))
            # add ghost contributions
            for dev in range(ndev):
                gh = self._ghosts(dev)
                gl = gl.at[jnp.asarray(gh)].add(
                    jnp.asarray(d[dev, self.layout.L :
                                  self.layout.L + len(gh)]))
            dl = np.array(self.scatter_vector(gl))
            dl[np.abs(dl) < 1e-30] = 1.0
            if self.free_l is not None:
                dl = np.where(np.asarray(self.free_l) > 0.5, dl, 1.0)
            self._diag = jnp.asarray(dl)
        return self._diag

    # -- sharded CG ------------------------------------------------------------------
    def cg(self, bl, rtol=1e-10, maxiter=2000, jacobi=True):
        """Jacobi-preconditioned CG on sharded vectors with psum dots.

        The preconditioner is device-local (owned diagonal) — zero extra
        communication per iteration."""
        Minv = 1.0 / self.diagonal() if jacobi else None

        def prec(r):
            return r * Minv if jacobi else r

        x = jnp.zeros_like(bl)
        r = bl - self.matvec(x)
        z = prec(r)
        p = z
        rz = self.dot(r, z)
        b2 = self.dot(bl, bl)

        def cond(state):
            x, r, z, p, rz, k = state
            return (self.dot(r, r) > rtol**2 * b2) & (k < maxiter)

        def body(state):
            x, r, z, p, rz, k = state
            Ap = self.matvec(p)
            alpha = rz / self.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = self.dot(r, z)
            p = z + (rz_new / rz) * p
            return (x, r, z, p, rz_new, k + 1)

        x, r, z, p, rz, k = jax.lax.while_loop(
            cond, body, (x, r, z, p, rz, jnp.asarray(0)))
        return x, k, jnp.sqrt(self.dot(r, r))
