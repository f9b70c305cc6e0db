"""Block-tridiagonal operators and the block-Thomas direct solver.

The scalable MUMPS replacement (SURVEY.md N5, "hard part" #1).
After RCM reordering (femo_tpu.native), a FEM matrix has bandwidth b; with
block size B >= b (rounded up to a multiple of 128) the matrix is
exactly block-tridiagonal:

    A = tridiag(L_i, D_i, U_i),   B x B dense blocks.

* matvec: three batched (B,B)@(B,) products — dense block work, no
  gathers (this layout removes the gathers of a general sparse SpMV).
* factor/solve: block Thomas — a lax.scan of block inverses and matmuls,
  O(n B^2) memory and O(n_blocks B^3) flops (linear in n, vs n^3 for the
  dense LU), all dense block work.  No inter-block pivoting (standard for
  elliptic FEM operators; intra-block solves pivot normally).

Everything is jittable; the factorization is a pytree and slots into the
custom_vjp implicit ops (forward solve reused transposed for the adjoint).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import config

# All dots in this module run at HIGHEST matmul precision: a reduced-
# precision f32 product (TF32 on the GPU, ~5e-4 rel err per product)
# compounds through the sequential Schur/sweep recursions into singular
# factor blocks at anchor nb.  For f64 inputs the flag is a no-op.
_HI = jax.lax.Precision.HIGHEST


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _inv_block_guarded(S, shift: float, cap: float):
    """Single-block inverse with a singularity rescue for low-precision
    recursions.  The f32 Schur recursion can drift one block out of 7246
    to singular-to-f32 at anchor scale (measured: one NaN inverse poisons
    the whole factor); a shift large enough to prevent it GLOBALLY swamps
    the shell's ~1e-8-of-diag physical modes (measured: PCG stagnates).
    Fix: detect the bad block (non-finite or ||Sinv||_max > cap) and
    recompute ONLY that block's inverse with a relative diagonal shift —
    one block of thousands carries a locally blunted preconditioner, the
    f64-operator PCG polish absorbs it.  lax.cond executes one branch, so
    healthy steps pay only the isfinite/max reduction."""
    X = jnp.linalg.inv(S)
    bad = jnp.logical_or(~jnp.all(jnp.isfinite(X)),
                         jnp.max(jnp.abs(X)) > cap)

    def rescue(_):
        s0 = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(S))),
                         jnp.asarray(1.0, S.dtype))
        return jnp.linalg.inv(
            S + (shift * s0) * jnp.eye(S.shape[-1], dtype=S.dtype))

    return jax.lax.cond(bad, rescue, lambda _: X, None)


def _inv_block_mixed(S, spd: bool, ns: int, tol: float = 1e-7):
    """Mixed-precision single-block inverse for f64 recursions: f32
    Cholesky-inverse seed + `ns` f64 Newton-Schulz refinements, so the
    f64 work is matmuls only:
    X_{k+1} = X_k + X_k (I - S X_k), error (eps_f32 * cond_b)^{2^ns}.
    It was written for an accelerator whose f64 factorizations were
    emulated; whether it pays on the GPU is ROADMAP design item 1.

    The f32 seed is computed on the PER-BLOCK symmetrically diagonal-
    scaled copy Ss = Ds S Ds (Ds = diag(1/sqrt(|diag S|))) and unscaled
    back (S^-1 = Ds Ss^-1 Ds) — raw FEM Schur blocks carry diagonal
    dynamic range ~1e9 that overflows/degrades a plain f32 Cholesky,
    and scaling inside the INVERSE keeps the Schur chain AND the solve
    path in the raw operator space, bit-compatible with the exact-f64
    production path.  (An earlier design equilibrated the whole operator
    and solved through a scale-conjugated factor; even the EXACT f64
    recursion on the equilibrated operator preconditioned the coupled
    FSI to a wrong fixed point.)

    Unlike f32 factor STORAGE (which never feeds back), the accepted
    inverse error feeds the downstream Schur chain, so the acceptance
    tol defaults to 1e-7 ~ the f32-store floor; blocks whose refinement
    cannot reach it (non-finite f32 Cholesky or final residual > tol)
    fall back to the exact f64 inverse under lax.cond — rare, so the
    amortized per-step cost stays at the mixed rate."""
    B = S.shape[-1]
    dg = jnp.abs(jnp.diagonal(S, axis1=-2, axis2=-1))
    s = jnp.where(dg > 0, 1.0 / jnp.sqrt(jnp.where(dg > 0, dg, 1.0)), 1.0)
    Ss32 = (S * s[..., :, None] * s[..., None, :]).astype(jnp.float32)
    if spd:
        Lc32 = jnp.linalg.cholesky(Ss32)
        Linv = jax.scipy.linalg.solve_triangular(
            Lc32, jnp.eye(B, dtype=jnp.float32), lower=True)
        Xs = jnp.matmul(Linv.T, Linv, precision=_HI)
    else:
        Xs = jnp.linalg.inv(Ss32)
    X = (Xs.astype(S.dtype) * s[..., :, None] * s[..., None, :])
    X = jnp.where(jnp.isfinite(X), X, jnp.zeros_like(X))
    eye = jnp.eye(B, dtype=S.dtype)
    for _ in range(max(ns, 1)):
        R = eye - jnp.matmul(S, X, precision=_HI)
        X = X + jnp.matmul(X, R, precision=_HI)
    if spd:
        X = 0.5 * (X + jnp.swapaxes(X, -1, -2))
    R = eye - jnp.matmul(S, X, precision=_HI)
    bad = jnp.logical_or(~jnp.all(jnp.isfinite(R)),
                         jnp.max(jnp.abs(R)) > tol)
    return jax.lax.cond(bad, lambda _: jnp.linalg.inv(S),
                        lambda _: X, None)


def _inv_blocks_mixed(S, spd: bool, ns: int, tol: float = 1e-7):
    """BATCHED mixed-precision block inverses (the batched analogue of
    _inv_block_mixed, for the cyclic-reduction levels): per-block
    symmetric diagonal scaling inside an f32 Cholesky seed + `ns` f64
    Newton-Schulz refinements (batched matmuls).

    Per-block lax.cond fallback would be vmapped into select (both
    branches run for EVERY block, destroying the speedup), so the
    residual check is GLOBAL: if any block's final residual exceeds tol
    (or is non-finite), the whole level recomputes with the exact f64
    inverse under one lax.cond — rare by construction (ns=3 reaches the
    f32-store floor on the FSI anchor blocks), so the amortized cost
    stays at the mixed rate."""
    B = S.shape[-1]
    dg = jnp.abs(jnp.diagonal(S, axis1=-2, axis2=-1))
    s = jnp.where(dg > 0, 1.0 / jnp.sqrt(jnp.where(dg > 0, dg, 1.0)), 1.0)
    Ss32 = (S * s[..., :, None] * s[..., None, :]).astype(jnp.float32)
    eye32 = jnp.broadcast_to(jnp.eye(B, dtype=jnp.float32), S.shape)
    if spd:
        Lc32 = jnp.linalg.cholesky(Ss32)
        Linv = jax.scipy.linalg.solve_triangular(Lc32, eye32, lower=True)
        Xs = jnp.matmul(jnp.swapaxes(Linv, -1, -2), Linv, precision=_HI)
    else:
        Xs = jnp.linalg.inv(Ss32)
    X = Xs.astype(S.dtype) * s[..., :, None] * s[..., None, :]
    X = jnp.where(jnp.isfinite(X), X, jnp.zeros_like(X))
    eye = jnp.broadcast_to(jnp.eye(B, dtype=S.dtype), S.shape)
    for _ in range(max(ns, 1)):
        R = eye - jnp.matmul(S, X, precision=_HI)
        X = X + jnp.matmul(X, R, precision=_HI)
    if spd:
        X = 0.5 * (X + jnp.swapaxes(X, -1, -2))
    R = eye - jnp.matmul(S, X, precision=_HI)
    bad = jnp.logical_or(~jnp.all(jnp.isfinite(R)),
                         jnp.max(jnp.abs(R)) > tol)
    return jax.lax.cond(bad, lambda _: jnp.linalg.inv(S),
                        lambda _: X, None)


def _cr_invs(S, spd, mixed_ns, mixed_tol):
    if mixed_ns:
        return _inv_blocks_mixed(S, spd, mixed_ns, mixed_tol)
    return jnp.linalg.inv(S)


def _factor_step_fn(spd, store_dtype, guard, mixed_ns=0, mixed_tol=1e-7):
    def step(C_prev, blocks):
        D_i, L_i, U_i = blocks
        S = D_i - jnp.matmul(L_i, C_prev, precision=_HI)
        if mixed_ns:
            Sinv = _inv_block_mixed(S, spd, mixed_ns, mixed_tol)
        elif guard:
            Sinv = _inv_block_guarded(S, shift=1e-4, cap=1e7)
        else:
            Sinv = jnp.linalg.inv(S)
        C = jnp.matmul(Sinv, U_i, precision=_HI)
        out = ((Sinv.astype(store_dtype), C.astype(store_dtype))
               if store_dtype is not None else (Sinv, C))
        return C, out

    return step


@partial(jax.jit, static_argnames=("spd", "store_dtype", "guard",
                                   "mixed_ns", "mixed_tol"))
def _factor_chunk_program(C_prev, Dc, Lc, Uc, spd, store_dtype,
                          guard=False, mixed_ns=0, mixed_tol=1e-7):
    """One chunk of the factor recursion (see factor_chunked).  Module-
    level so the jit cache persists across factor_chunked calls: a fresh
    per-call wrapper re-traced/recompiled its ~2k-step scan programs on
    EVERY factorization."""
    return jax.lax.scan(
        _factor_step_fn(spd, store_dtype, guard, mixed_ns, mixed_tol),
        C_prev, (Dc, Lc, Uc))


def _cr_level(D, L, U, spd, store_dtype, mixed_ns=0, mixed_tol=1e-7):
    """One cyclic-reduction level: eliminate the odd block rows.

    Returns (stored_level, D_next, L_next, U_next) — the pure algebra
    shared by factor_cr (traced whole) and factor_cr_chunked (one jitted
    program per level)."""
    dt = D.dtype
    mm = partial(jnp.einsum, "kij,kjl->kil",
                 preferred_element_type=dt, precision=_HI)
    De, Do = D[0::2], D[1::2]
    Le, Lo = L[0::2], L[1::2]
    Ue, Uo = U[0::2], U[1::2]
    Dinv_o = _cr_invs(Do, spd, mixed_ns, mixed_tol)
    stored = (Dinv_o, Le, Ue, Lo, Uo)
    if store_dtype is not None:
        stored = tuple(a.astype(store_dtype) for a in stored)
    # eliminate odd rows: even row 2k couples to odd rows 2k-1, 2k+1
    Dinv_prev = jnp.roll(Dinv_o, 1, axis=0).at[0].set(0.0)
    alpha = mm(Le, Dinv_prev)   # L_{2k} D_{2k-1}^{-1}
    beta = mm(Ue, Dinv_o)       # U_{2k} D_{2k+1}^{-1}
    Uo_prev = jnp.roll(Uo, 1, axis=0).at[0].set(0.0)
    Lo_prev = jnp.roll(Lo, 1, axis=0).at[0].set(0.0)
    D2 = De - mm(alpha, Uo_prev) - mm(beta, Lo)
    L2 = -mm(alpha, Lo_prev)
    U2 = -mm(beta, Uo)
    return stored, D2, L2, U2


@partial(jax.jit, donate_argnums=(0, 1, 2),
         static_argnames=("spd", "store_dtype", "mixed_ns", "mixed_tol"))
def _cr_level_program(D, L, U, spd, store_dtype, mixed_ns=0,
                      mixed_tol=1e-7):
    """One CR level as a standalone program with the level's reduced
    operator donated (see factor_cr_chunked).  Module-level so the jit
    cache persists across factorizations."""
    return _cr_level(D, L, U, spd, store_dtype, mixed_ns, mixed_tol)


@partial(jax.jit, donate_argnums=(0, 1, 2),
         static_argnames=("spd", "store_dtype", "mixed_ns", "mixed_tol"))
def _cr_tail_program(D, L, U, spd, store_dtype, mixed_ns=0,
                     mixed_tol=1e-7):
    """All remaining small CR levels down to the root in one program."""
    levels = []
    while D.shape[0] > 1:
        stored, D, L, U = _cr_level(
            D, L, U, spd, store_dtype, mixed_ns, mixed_tol)
        levels.append(stored)
    Dinv_root = _cr_invs(D, spd, mixed_ns, mixed_tol)[0]
    if store_dtype is not None:
        Dinv_root = Dinv_root.astype(store_dtype)
    return tuple(levels), Dinv_root


class BlockTridiagonalMatrix:
    """Block-tridiagonal form of a sparse matrix after RCM reordering.

    Built host-side from an ElementMatrix (or scipy CSR).  Stores the
    new-to-old permutation so callers work in original dof ordering.
    """

    def __init__(self, D, L, U, perm, n: int):
        self.D = D  # (nb, B, B)
        self.L = L  # (nb, B, B)  L[0] unused
        self.U = U  # (nb, B, B)  U[-1] unused
        # keep the permutation as HOST numpy: under jit tracing,
        # jnp-converted copies become tracers and poison later host use
        self.perm = np.asarray(perm, np.int64)
        self.n = n
        self.nb, self.B = D.shape[0], D.shape[1]
        inv = np.zeros(len(self.perm), np.int32)
        inv[self.perm] = np.arange(len(self.perm), dtype=np.int32)
        self.iperm = jnp.asarray(inv)
        self.perm_j = jnp.asarray(self.perm.astype(np.int32))

    # -- construction -----------------------------------------------------------
    @classmethod
    def from_element_matrix(cls, emat, free=None, block: int | None = None):
        """Build from ElementMatrix; optional BC row/col masking
        (constrained operator: identity on fixed dofs)."""
        import scipy.sparse as sp

        from .. import native

        A = emat.to_scipy_csr()
        n = A.shape[0]
        if free is not None:
            fr = np.asarray(free)
            P = sp.diags(fr.astype(A.dtype))
            A = (P @ A @ P + sp.diags((~fr).astype(A.dtype))).tocsr()
        perm = native.rcm_order(A.indptr.astype(np.int64),
                                A.indices.astype(np.int32))
        Ap = A[perm][:, perm].tocoo()
        bw = int(np.abs(Ap.row - Ap.col).max()) if Ap.nnz else 1
        if block is None:
            block = max(128, _round_up(bw, 128))
        B = block
        n_pad = _round_up(n, B)
        nb = n_pad // B
        D = np.zeros((nb, B, B), np.asarray(Ap.data).dtype)
        Lb = np.zeros_like(D)
        Ub = np.zeros_like(D)
        bi = Ap.row // B
        bj = Ap.col // B
        li = Ap.row % B
        lj = Ap.col % B
        for arr, sel in ((D, bi == bj), (Lb, bi == bj + 1),
                         (Ub, bi + 1 == bj)):
            arr[(bi[sel] if arr is not Ub else bi[sel]),
                li[sel], lj[sel]] = Ap.data[sel]
        if not np.all((np.abs(bi - bj) <= 1)):
            raise ValueError(
                f"bandwidth {bw} exceeds block {B}: not block-tridiagonal")
        # identity on padding rows
        for i in range(n, n_pad):
            D[i // B, i % B, i % B] = 1.0
        perm_full = np.concatenate(
            [np.asarray(perm, np.int64), np.arange(n, n_pad)])
        f = config.jdtype
        return cls(jnp.asarray(D, f), jnp.asarray(Lb, f), jnp.asarray(Ub, f),
                   perm_full, n)

    # -- vector permutation helpers ----------------------------------------------
    def to_blocks(self, x):
        n_pad = self.nb * self.B
        xp = jnp.zeros(n_pad, x.dtype).at[: self.n].set(x)
        return xp[self.perm_j].reshape(self.nb, self.B)

    def from_blocks(self, xb):
        xp = xb.reshape(-1)[self.iperm]
        return xp[: self.n]

    # -- matvec --------------------------------------------------------------------
    def matvec(self, x):
        xb = self.to_blocks(x)
        y = jnp.einsum("bij,bj->bi", self.D, xb,
                       preferred_element_type=xb.dtype, precision=_HI)
        xm = jnp.roll(xb, 1, axis=0).at[0].set(0.0)
        xp = jnp.roll(xb, -1, axis=0).at[-1].set(0.0)
        y = y + jnp.einsum("bij,bj->bi", self.L, xm,
                           preferred_element_type=xb.dtype, precision=_HI)
        y = y + jnp.einsum("bij,bj->bi", self.U, xp,
                           preferred_element_type=xb.dtype, precision=_HI)
        return self.from_blocks(y)

    def matvec_t(self, x):
        """Transpose matvec A^T x (same three batched matmuls)."""
        xb = self.to_blocks(x)
        y = jnp.einsum("bji,bj->bi", self.D, xb,
                       preferred_element_type=xb.dtype, precision=_HI)
        xm = jnp.roll(xb, 1, axis=0).at[0].set(0.0)
        xp = jnp.roll(xb, -1, axis=0).at[-1].set(0.0)
        # (A^T)_{i,i-1} = U_{i-1}^T ; (A^T)_{i,i+1} = L_{i+1}^T
        Um = jnp.roll(self.U, 1, axis=0)
        Lp = jnp.roll(self.L, -1, axis=0)
        y = y + jnp.einsum("bji,bj->bi", Um, xm,
                           preferred_element_type=xb.dtype, precision=_HI)
        y = y + jnp.einsum("bji,bj->bi", Lp, xp,
                           preferred_element_type=xb.dtype, precision=_HI)
        return self.from_blocks(y)

    # -- block Thomas factorization ---------------------------------------------
    def factor(self, store_dtype=None, spd: bool = False,
               guard: bool = False, mixed_ns: int = 0,
               mixed_tol: float = 1e-7):
        """Forward elimination: S_i = D_i - L_i C_{i-1}; stores S_i^{-1}
        and C_i = S_i^{-1} U_i.  One lax.scan of block inverses/matmuls.

        store_dtype: optionally down-cast the stored factor (e.g. f32 in
        an f64 solve) — the Schur recursion still runs at full precision,
        only the retained Sinv/C lose bits; halves factor memory and leaves
        the fixed-count PCG polish to absorb the storage roundoff (the
        mixed-precision direct-solver pattern).
        spd: declare the operator SPD (used by the mixed inverses'
        Cholesky seed).
        guard: per-block singularity rescue for low-precision recursions
        (see _inv_block_guarded).
        mixed_ns: >0 computes each block inverse from an f32 Cholesky
        seed + mixed_ns f64 Newton-Schulz refinements while the Schur
        CHAIN stays f64 (see _inv_block_mixed)."""

        B = self.B
        C0 = jnp.zeros((B, B), self.D.dtype)
        _, (Sinv, C) = jax.lax.scan(
            _factor_step_fn(spd, store_dtype, guard, mixed_ns, mixed_tol),
            C0, (self.D, self.L, self.U))
        return BlockThomasFactor(self, Sinv, C)

    def factor_t(self, store_dtype=None, spd: bool = False):
        """Factorization of A^T (for adjoint solves)."""
        return self._transposed().factor(store_dtype, spd)

    def factor_chunked(self, store_dtype=None, spd: bool = False,
                       chunk: int = 2048, guard: bool = False,
                       mixed_ns: int = 0, mixed_tol: float = 1e-7):
        """Block-Thomas factor split into host-looped jitted programs.

        Bit-identical recursion to factor() (same Schur sequence, same
        order) — the length-nb sequential scan is simply cut into
        ceil(nb/chunk) separately executed device programs with the
        running coupling block C_{i-1} (B x B) carried between them.
        Exists because one multi-thousand-step sequential scan is a
        single very long-running device program, which faulted on the
        earlier accelerator at nb ~ 7k blocks; whether the GPU needs the
        split is ROADMAP design item 1.  np.array_split
        yields at most two distinct chunk lengths, so at most two
        compilations — and the chunk program is a module-level cached
        jit, so repeated factorizations (every opt iteration) reuse the
        compiled programs instead of re-tracing.
        """
        nb, B = self.nb, self.B
        if nb <= chunk:
            return self.factor(store_dtype, spd, guard=guard,
                               mixed_ns=mixed_ns, mixed_tol=mixed_tol)

        C_prev = jnp.zeros((B, B), self.D.dtype)
        Sinv_parts, C_parts = [], []
        for ix in np.array_split(np.arange(nb), -(-nb // chunk)):
            a, b = int(ix[0]), int(ix[-1]) + 1
            C_prev, (Sc, Cc) = _factor_chunk_program(
                C_prev, self.D[a:b], self.L[a:b], self.U[a:b],
                spd, store_dtype, guard, mixed_ns, mixed_tol)
            jax.block_until_ready(C_prev)
            Sinv_parts.append(Sc)
            C_parts.append(Cc)
        Sinv = jnp.concatenate(Sinv_parts, axis=0)
        C = jnp.concatenate(C_parts, axis=0)
        return BlockThomasFactor(self, Sinv, C)

    def factor_spd(self, store_dtype=None):
        """Cholesky-storage block Thomas for SPD operators.

        Stores (Lc_i, C_i) with S_i = Lc_i Lc_i^T and C_i = S_i^{-1} U_i
        computed by two triangular solves — ~1.75x fewer factor flops
        than the explicit-inverse path, and no backend branching
        (Cholesky lowers on every backend).  A^T = A, so the same factor
        serves adjoint solves.

        Per-sweep triangular solves add latency, and on the earlier
        accelerator this path was slower than the inverse-storage factor
        despite its lower flop count; it is not measured on the GPU.  The
        inverse-storage factor stays the production default; this
        variant is kept as the flop-minimal option (verified to machine
        precision in test_block_tridiag).
        """
        from jax.scipy.linalg import solve_triangular

        def step(C_prev, blocks):
            D_i, L_i, U_i = blocks
            S = D_i - jnp.matmul(L_i, C_prev, precision=_HI)
            Lc = jnp.linalg.cholesky(S)
            Y = solve_triangular(Lc, U_i, lower=True)
            C = solve_triangular(Lc, Y, lower=True, trans=1)
            out = ((Lc.astype(store_dtype), C.astype(store_dtype))
                   if store_dtype is not None else (Lc, C))
            return C, out

        B = self.B
        C0 = jnp.zeros((B, B), self.D.dtype)
        _, (Lc, C) = jax.lax.scan(step, C0, (self.D, self.L, self.U))
        return BlockCholeskyFactor(self, Lc, C)

    def _transposed(self):
        return BlockTridiagonalMatrix(
            jnp.swapaxes(self.D, 1, 2),
            # A^T lower block i = U_{i-1}^T
            jnp.roll(jnp.swapaxes(self.U, 1, 2), 1, axis=0),
            jnp.roll(jnp.swapaxes(self.L, 1, 2), -1, axis=0),
            self.perm, self.n)

    # -- symmetric Jacobi scaling ------------------------------------------
    def jacobi_scaled(self):
        """Symmetrically equilibrated copy: A' = S A S with
        S = diag(1/sqrt(|diag A|)), plus the block-layout scale s (nb, B).

        Mixed-field composites (RM shell: displacement vs rotation dofs
        differ by ~E t^2 in diagonal scale) are far too ill-conditioned
        for an f32 factorization — measured at 146k dofs the raw
        block-Thomas+PCG solve was ~6 orders of magnitude wrong while the
        equilibrated factor used as the PCG preconditioner converges.
        Identity padding/BC rows have unit diagonal and keep s = 1.
        """
        d = jnp.einsum("bii->bi", self.D)
        # dtype-aware floor: 1e-300 flushes to 0.0 in f32 mode, producing
        # inf scales exactly where the guard is needed
        s = 1.0 / jnp.sqrt(jnp.maximum(jnp.abs(d), jnp.finfo(d.dtype).tiny))
        sm = jnp.roll(s, 1, axis=0).at[0].set(0.0)
        sp = jnp.roll(s, -1, axis=0).at[-1].set(0.0)
        D2 = self.D * s[:, :, None] * s[:, None, :]
        L2 = self.L * s[:, :, None] * sm[:, None, :]
        U2 = self.U * s[:, :, None] * sp[:, None, :]
        return (BlockTridiagonalMatrix(D2, L2, U2, self.perm, self.n), s)

    def scale_vector(self, x, s):
        """Apply the block-layout diagonal scale s to a dof vector."""
        return self.from_blocks(self.to_blocks(x) * s)

    # -- block cyclic reduction ----------------------------------------------
    def _cr_padded(self):
        """Zero-padded power-of-two (D, L, U) with CR boundary blocks."""
        nb, B = self.nb, self.B
        n2 = 1 << max(nb - 1, 0).bit_length()
        dt = self.D.dtype
        eye = jnp.eye(B, dtype=dt)
        D = jnp.concatenate(
            [self.D, jnp.broadcast_to(eye, (n2 - nb, B, B))]) \
            if n2 > nb else self.D
        L = jnp.concatenate(
            [self.L, jnp.zeros((n2 - nb, B, B), dt)]) if n2 > nb else self.L
        U = jnp.concatenate(
            [self.U, jnp.zeros((n2 - nb, B, B), dt)]) if n2 > nb else self.U
        # boundary blocks must be zero for the reduction algebra
        L = L.at[0].set(0.0)
        U = U.at[-1].set(0.0)
        return D, L, U, n2

    def factor_cr(self, store_dtype=None, spd: bool = False,
                  mixed_ns: int = 0, mixed_tol: float = 1e-7):
        """Block cyclic (odd-even) reduction factorization.

        Block Thomas is a length-nb sequential lax.scan; cyclic reduction
        eliminates all ODD block rows at once per level — ceil(log2 nb)
        levels of BATCHED inverses/matmuls — at ~3x the flops.  It is the
        latency-optimal choice when the blocks are SMALL (B ~ 128, large
        nb) so the scan is dependency-bound.

        Caveat: at large B each Thomas step is already heavy, CR's extra
        flops cost more than its depth saves, and its reduced systems
        amplify f32 roundoff enough to break the PCG-polished solve on
        the ill-conditioned shell operator.  Thomas stays the default
        everywhere; prefer CR only for small-B/large-nb operators in f64
        (verified to machine precision in test_block_tridiag) — the
        FSI-anchor regime (B=128, nb~7k), where the Thomas factor is a
        dependency-bound length-7k scan.  Which wins on the GPU is
        ROADMAP speed item 5.

        `spd`: every CR level's reduced matrix is a Schur complement of
        an (even/odd-permuted) SPD matrix onto the even rows, hence SPD —
        the mixed inverses may seed from an f32 Cholesky.
        `store_dtype`: cast the STORED level arrays (the reduction
        recursion itself stays in the operator dtype, like the Thomas
        factor_store_dtype) — halves factor memory; pair with a PCG
        polish against the f64 operator.
        `mixed_ns`: >0 computes the batched per-level block inverses via
        the f32-seed + f64 Newton-Schulz refinement (_inv_blocks_mixed);
        the Schur reduction chain stays f64 on the raw operator.
        """
        D, L, U, n2 = self._cr_padded()
        levels = []
        while D.shape[0] > 1:
            stored, D, L, U = _cr_level(
                D, L, U, spd, store_dtype, mixed_ns, mixed_tol)
            levels.append(stored)
        Dinv_root = _cr_invs(D, spd, mixed_ns, mixed_tol)[0]
        if store_dtype is not None:
            Dinv_root = Dinv_root.astype(store_dtype)
        return BlockCyclicFactor(self, levels, Dinv_root, n2)

    def factor_cr_chunked(self, store_dtype=None, spd: bool = False,
                          mixed_ns: int = 0, mixed_tol: float = 1e-7,
                          tail: int = 256):
        """Cyclic reduction with each level dispatched as its OWN jitted
        program (host loop), the reduced (D, L, U) donated level-to-level.

        Bit-identical to factor_cr for the exact recursion (same
        per-level algebra, same order; with mixed_ns the per-level
        programs fuse the f32 seed differently — equal to fp
        reassociation).  Exists for device memory: in the fused whole-
        factor CR program at the FSI anchor (nb=7246 -> n2=8192, B=128,
        f64) every level's reduced systems, stored arrays and Schur
        temporaries coexist in one program's live range, which did not
        fit a 16 GB device.  Per-level programs cap the live set at one
        level's working set (~8 GB at level 0) and free each reduced
        operator by donation.
        Levels at or below `tail` blocks run in one tail program (the
        small-shape levels are compile-count, not memory).

        NOT usable inside jit (host loop) — mirror of factor_chunked."""
        D, L, U, n2 = self._cr_padded()
        if D is self.D:
            # nb an exact power of two: _cr_padded returned the matrix's
            # own D — copy before the first level DONATES it (donating
            # self.D would invalidate the operator the PCG polish needs)
            D = jnp.array(D)
        levels = []
        while D.shape[0] > tail and D.shape[0] > 1:
            stored, D, L, U = _cr_level_program(
                D, L, U, spd=spd, store_dtype=store_dtype,
                mixed_ns=mixed_ns, mixed_tol=mixed_tol)
            jax.block_until_ready(stored[0])
            levels.append(stored)
        tail_levels, Dinv_root = _cr_tail_program(
            D, L, U, spd=spd, store_dtype=store_dtype,
            mixed_ns=mixed_ns, mixed_tol=mixed_tol)
        levels.extend(tail_levels)
        return BlockCyclicFactor(self, levels, Dinv_root, n2)

    def factor_t_cr(self):
        return self._transposed().factor_cr()


@dataclass
class BlockThomasFactor:
    mat: BlockTridiagonalMatrix
    Sinv: jnp.ndarray  # (nb, B, B)
    C: jnp.ndarray  # (nb, B, B)
    # run the triangular sweeps in this dtype (None = the rhs dtype).
    # f32 sweeps on an f64 operator are the preconditioner-role fast
    # path: the factor is only PCG-polish input — set by the FSI
    # builders' factor_compute_dtype
    sweep_dtype: object = None
    # symmetric Jacobi equilibration used at factor time: the factor is
    # of S A S (S = diag scale in block layout, (nb, B)), so the solve
    # applies x = S F'^{-1} S b.  Mandatory companion of an f32 factor
    # on raw-scaled stiff operators (raw cond ~1e9-1e10 makes an
    # unequilibrated f32 factor garbage; equilibrated cond ~1e6-1e7 is
    # inside f32's preconditioner-quality range)
    scale: object = None
    # the SCALED lower blocks S_i L_i S_{i-1} the forward sweep needs
    # when scale is set (m.L holds the raw operator)
    Lfac: object = None

    def solve_refined(self, b, refine: int = 0):
        """Solve with optional iterative refinement.

        In f64 the direct solve is accurate (refine=0).  In f32 the
        sequential block elimination can lose enough accuracy that
        refinement DIVERGES (||I - F^-1 A|| > 1 for stiff operators) —
        use the factor as a Krylov preconditioner instead (measured: PCG
        converges in ~18 iterations at 16.6k dofs where refinement fails)."""
        x = self.solve(b)
        for _ in range(refine):
            r = b - self.mat.matvec(x)
            x = x + self.solve(r)
        return x

    def _apply(self, b, sweep_dtype, sweeps):
        m = self.mat
        bb = m.to_blocks(b)
        out_dtype = bb.dtype
        if self.scale is not None:
            bb = bb * self.scale
        L = self.Lfac if self.scale is not None else m.L
        Sinv, C = self.Sinv, self.C
        if sweep_dtype is not None:
            dt = jnp.dtype(sweep_dtype)
            bb, L = bb.astype(dt), L.astype(dt)
            Sinv, C = Sinv.astype(dt), C.astype(dt)
        xr = sweeps(Sinv, L, C, bb).astype(out_dtype)
        if self.scale is not None:
            xr = xr * self.scale
        return m.from_blocks(xr)

    def solve(self, b):
        return self._apply(b, self.sweep_dtype, scan_sweeps)

    def solve_pallas(self, b, interpret: bool = False):
        """solve() with both sweeps as single-program Pallas-Triton GPU
        kernels (ops/pallas_bt.py), in f32.  interpret=True runs them in
        the Pallas interpreter, which is how the CPU tests reach them."""
        from .pallas_bt import bt_sweep_solve

        return self._apply(b, jnp.float32,
                           partial(bt_sweep_solve, interpret=interpret))


def scan_sweeps(Sinv, L, C, bb):
    """The block-Thomas triangular sweeps as two lax.scans: the plain
    reference for the Pallas kernels (ops/pallas_bt.py)."""

    def fwd(z_prev, args):
        b_i, L_i, Sinv_i = args
        z = jnp.einsum("ij,j->i", Sinv_i,
                       b_i - jnp.einsum("ij,j->i", L_i, z_prev,
                                        precision=_HI),
                       precision=_HI)
        return z, z

    B = bb.shape[1]
    _, z = jax.lax.scan(fwd, jnp.zeros(B, bb.dtype), (bb, L, Sinv))

    def bwd(x_next, args):
        z_i, C_i = args
        x = z_i - jnp.einsum("ij,j->i", C_i, x_next, precision=_HI)
        return x, x

    _, xr = jax.lax.scan(bwd, jnp.zeros(B, bb.dtype), (z, C), reverse=True)
    return xr


@dataclass
class BlockCholeskyFactor:
    """Solve phase of the Cholesky-storage block Thomas (factor_spd)."""

    mat: BlockTridiagonalMatrix
    Lc: jnp.ndarray  # (nb, B, B) lower Cholesky of S_i
    C: jnp.ndarray  # (nb, B, B) S_i^{-1} U_i

    def solve(self, b):
        from jax.scipy.linalg import solve_triangular

        m = self.mat
        bb = m.to_blocks(b)
        dt = bb.dtype

        def fwd(z_prev, args):
            b_i, L_i, Lc_i = args
            rhs = b_i - jnp.einsum("ij,j->i", L_i, z_prev,
                                   preferred_element_type=dt,
                                   precision=_HI)
            y = solve_triangular(Lc_i.astype(dt), rhs, lower=True)
            z = solve_triangular(Lc_i.astype(dt), y, lower=True, trans=1)
            return z, z

        z0 = jnp.zeros(m.B, dt)
        _, z = jax.lax.scan(fwd, z0, (bb, m.L, self.Lc))

        def bwd(x_next, args):
            z_i, C_i = args
            x = z_i - jnp.einsum("ij,j->i", C_i.astype(dt), x_next,
                                 preferred_element_type=dt,
                                 precision=_HI)
            return x, x

        _, xr = jax.lax.scan(bwd, jnp.zeros(m.B, dt), (z, self.C),
                             reverse=True)
        return m.from_blocks(xr)


@dataclass
class BlockCyclicFactor:
    """Solve phase of block cyclic reduction (see factor_cr).

    Per level stores (Dinv_odd, L_even, U_even, L_odd, U_odd); the b
    transform reuses t = Dinv_odd @ b_odd (also needed by back-
    substitution), so no extra multiplier matrices are kept.
    """

    mat: BlockTridiagonalMatrix
    levels: list
    Dinv_root: jnp.ndarray
    n2: int

    def solve(self, b):
        m = self.mat
        dt = b.dtype
        mv = partial(jnp.einsum, "kij,kj->ki", preferred_element_type=dt,
                     precision=_HI)
        bb = m.to_blocks(b)
        if self.n2 > m.nb:
            bb = jnp.concatenate(
                [bb, jnp.zeros((self.n2 - m.nb, m.B), dt)])
        # downward sweep: reduce b level by level, stashing t per level
        stack = []
        for (Dinv_o, Le, Ue, Lo, Uo) in self.levels:
            be, bo = bb[0::2], bb[1::2]
            t = mv(Dinv_o, bo)
            stack.append((t, bo))
            t_prev = jnp.roll(t, 1, axis=0).at[0].set(0.0)
            bb = be - mv(Le, t_prev) - mv(Ue, t)
        x = jnp.matmul(self.Dinv_root, bb[0], precision=_HI)[None, :]
        # upward sweep: recover odd unknowns, interleave
        for (Dinv_o, Le, Ue, Lo, Uo), (t, bo) in zip(
                reversed(self.levels), reversed(stack)):
            xe = x
            x_next = jnp.roll(xe, -1, axis=0).at[-1].set(0.0)
            xo = mv(Dinv_o, bo - mv(Lo, xe) - mv(Uo, x_next))
            x = jnp.stack([xe, xo], axis=1).reshape(-1, m.B)
        return m.from_blocks(x[: m.nb])


class BlockTridiagFactorization:
    """Factorization-interface adapter (solvers.linear.Factorization)."""

    def __init__(self, emat, free, refine: int = 0):
        self.mat = BlockTridiagonalMatrix.from_element_matrix(emat, free)
        self._f = self.mat.factor()
        self._ft = None
        self._mat_t = None
        self.refine = refine

    def solve(self, b):
        return self._f.solve_refined(b, self.refine)

    def solve_t(self, b):
        if self._ft is None:
            self._mat_t = BlockTridiagonalMatrix(
                jnp.swapaxes(self.mat.D, 1, 2),
                jnp.roll(jnp.swapaxes(self.mat.U, 1, 2), 1, axis=0),
                jnp.roll(jnp.swapaxes(self.mat.L, 1, 2), -1, axis=0),
                self.mat.perm, self.mat.n)
            self._ft = self._mat_t.factor()
        x = self._ft.solve(b)
        for _ in range(self.refine):
            r = b - self._mat_t.matvec(x)
            x = x + self._ft.solve(r)
        return x


class BlockTridiagTemplate:
    """Symbolic/numeric factorization split (MUMPS analyze/factorize parity).

    The sparsity of a Newton Jacobian is fixed across iterations: RCM
    ordering, block layout, and the element-entry -> (D|L|U, block, i, j)
    destination map are computed ONCE host-side from an ElementMatrix
    prototype.  `fill(element_blocks)` is then a single jittable
    segment-sum, so refill + block-Thomas factor + solve can all live
    inside a jitted Newton/adjoint step — the scalable replacement for
    the dense path in implicit_solve_dense_jit.
    """

    def __init__(self, emat, free=None, block: int | None = None):
        import scipy.sparse as sp

        from .. import native

        # prototype sparsity pattern (values irrelevant; pattern + BC mask
        # matter): native count/fill/finalize passes straight from the
        # element block id arrays when available (the expanded COO id
        # arrays — 39M entries at the FSI anchor — never materialize),
        # scipy coo_tocsr fallback
        n = emat.shape[0]
        self.n = n
        self.free = None if free is None else np.asarray(free)
        pat = native.csr_pattern_from_blocks(
            [(b.rows, b.cols) for b in emat.blocks], n)
        if pat is not None:
            indptr, indices = pat
        else:
            A = emat.to_scipy_csr(pattern_only=True)
            indptr, indices = A.indptr.astype(np.int64), A.indices
        perm = native.rcm_order(indptr, indices)
        iperm = np.zeros(n, np.int64)
        iperm[perm] = np.arange(n)
        bw = native.csr_bandwidth(indptr, indices, iperm)
        if bw is None:  # numpy fallback
            if len(indices):
                rowids = np.repeat(np.arange(n, dtype=np.int64),
                                   np.diff(indptr))
                bw = int(np.abs(iperm[rowids] - iperm[indices]).max())
            else:
                bw = 1
        bw = max(int(bw), 1)
        self.bw = bw  # raw RCM bandwidth (pre block-rounding) — reported
        # by benches to compare structured vs imported unstructured meshes
        B = block or max(128, _round_up(bw, 128))
        if bw > B:
            raise ValueError(f"bandwidth {bw} > block {B}")
        n_pad = _round_up(n, B)
        nb = n_pad // B
        self.B, self.nb = B, nb

        # destination id for every element-matrix entry
        # dest tensor flattened: which = 0(D),1(L),2(U); id =
        # ((which*nb + blk)*B + li)*B + lj ; masked-out entries -> dump slot
        self.dest_size = 3 * nb * B * B + 1
        dump = self.dest_size - 1

        dest_parts = []
        for b in emat.blocks:
            # fused native pass (one C++ loop per block); the vectorized-
            # numpy path below is the fallback and the oracle — ~40
            # full-array passes over ne*nr*nc temporaries (125 s at the
            # 39M-entry FSI anchor on one core vs seconds in C++)
            d_nat = native.bt_dest_map(
                np.asarray(b.rows), np.asarray(b.cols), iperm,
                self.free, B, nb, dump)
            if d_nat is not None:
                dest_parts.append(d_nat)
                continue
            ne, nr, nc = b.A.shape
            gr = np.broadcast_to(np.asarray(b.rows)[:, :, None],
                                 (ne, nr, nc)).reshape(-1)
            gc = np.broadcast_to(np.asarray(b.cols)[:, None, :],
                                 (ne, nr, nc)).reshape(-1)
            pr = iperm[gr]
            pc = iperm[gc]
            bi, li = pr // B, pr % B
            bj, lj = pc // B, pc % B
            which = np.full(len(gr), -1, np.int64)
            which[bi == bj] = 0
            which[bi == bj + 1] = 1
            which[bi + 1 == bj] = 2
            d = ((which * nb + bi) * B + li) * B + lj
            # BC masking: rows or cols on fixed dofs -> dump (identity
            # added separately); off-tridiagonal (impossible after bw
            # check) -> dump
            bad = which < 0
            if self.free is not None:
                fr = self.free
                bad |= ~fr[gr] | ~fr[gc]
            d[bad] = dump
            dest_parts.append(d)
        dest = np.concatenate(dest_parts)
        # dest as int32 when it fits: half the constant footprint of int64
        # (cast on the host — a device astype compiles an eager program
        # at build time)
        if self.dest_size < 2**31:
            dest = dest.astype(np.int32)
        self.dest = jnp.asarray(dest)

        # constant identity contributions: fixed dofs + padding — kept as a
        # SMALL index list (a dense base vector of dest_size floats would be
        # a multi-MB constant embedded in every jitted program)
        diag_ids = []
        if self.free is not None:
            fixed = np.nonzero(~self.free)[0]
            pf = iperm[fixed]
            diag_ids.append(((0 * nb + pf // B) * B + pf % B) * B + pf % B)
        pad = np.arange(n, n_pad)
        diag_ids.append(((0 * nb + pad // B) * B + pad % B) * B + pad % B)
        self.diag_ids = jnp.asarray(
            np.concatenate(diag_ids).astype(np.int32))
        self.perm_full = np.concatenate([perm.astype(np.int64),
                                         np.arange(n, n_pad)])

    # -- jittable numeric phase ---------------------------------------------------
    def fill(self, emat_blocks, dest=None):
        """element blocks [(A, rows, cols), ...] -> (D, L, U), jittable.

        `dest` may be passed as a traced argument (instead of the stored
        constant) so large destination maps ride as jit ARGUMENTS instead
        of huge constants embedded in the program.
        """
        vals = jnp.concatenate(
            [jnp.asarray(A).reshape(-1) for A, r, c in emat_blocks])
        d = self.dest if dest is None else dest
        # masked-out entries contribute 0.0 to slot 0 instead of a real
        # dump slot: avoids a full-size [:-1] slice COPY of the (possibly
        # multi-GB) accumulator — peak memory matters at reference scale
        dump = self.dest_size - 1
        keep = d != dump
        acc = jax.ops.segment_sum(
            jnp.where(keep, vals, 0.0), jnp.where(keep, d, 0),
            num_segments=self.dest_size - 1)
        acc = acc.at[self.diag_ids].add(1.0)
        nb, B = self.nb, self.B
        T = acc.reshape(3, nb, B, B)
        return T[0], T[1], T[2]

    def matrix(self, emat_blocks, dest=None) -> "BlockTridiagonalMatrix":
        D, L, U = self.fill(emat_blocks, dest)
        return BlockTridiagonalMatrix(D, L, U, self.perm_full, self.n)

    def factor(self, emat_blocks, dest=None) -> "BlockThomasFactor":
        return self.matrix(emat_blocks, dest).factor()


def pcg_fixed(mat: BlockTridiagonalMatrix, fac: BlockThomasFactor | None,
              b, iters: int, x0=None, transpose: bool = False, M=None):
    """Fixed-iteration preconditioned CG: A = mat.matvec, M = fac.solve
    (or an explicit preconditioner callable, e.g. the Jacobi-equilibrated
    factor solve).

    Jittable (static iteration count, no convergence branch) — the f32
    robustness wrapper around the rough block-Thomas factor (the factor
    alone loses accuracy at larger bandwidths; ~8-16 PCG iterations recover
    it, each one block matvec + one block solve)."""
    if transpose:
        mv = lambda v: mat.matvec_t(v)
    else:
        mv = mat.matvec
    M = M or fac.solve
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - mv(x)
    z = M(r)
    p = z
    rz = jnp.vdot(r, z)

    def body(k, state):
        x, r, z, p, rz = state
        Ap = mv(p)
        denom = jnp.vdot(p, Ap)
        alpha = rz / jnp.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = z + beta * p
        return (x, r, z, p, rz_new)

    x, r, z, p, rz = jax.lax.fori_loop(0, iters, body, (x, r, z, p, rz))
    return x


def pcg_tol(mat: BlockTridiagonalMatrix, fac, b, rtol: float = 1e-10,
            maxiter: int = 100, x0=None, transpose: bool = False, M=None,
            atol: float = 0.0):
    """Solve-to-TOLERANCE preconditioned CG (lax.while_loop).

    The reference's converged-solve semantics (SNES atol/rtol 1e-13,
    utils_dolfinx.py:377-379) as a jittable inner solve: iterate until
    ||r||_2 <= max(rtol * ||b||_2, atol) or maxiter.  This decouples
    SOLUTION accuracy from FACTOR quality — a low-precision factor
    (f32 store, mixed Newton-Schulz inverses, cyclic reduction) only
    changes the iteration count, never the answer.  That is what makes
    cheap factors admissible inside the coupled-FSI Gauss-Seidel: its
    fixed point shifts under the SYSTEMATIC component of a truncated
    inner solve's error (measured at the 107k-cell anchor: every
    fixed-count low-precision variant converged to a wrong tip, 17.67 /
    21.88 vs f64's 16.56), while a converged inner solve leaves no bias
    to amplify.

    Returns (x, iters, relres).  Not reverse-differentiable (dynamic
    trip count) — callers on AD paths keep pcg_fixed; the FSI/IFT
    adjoints are hand-written and unaffected."""
    mv = (lambda v: mat.matvec_t(v)) if transpose else mat.matvec
    M = M or fac.solve
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - mv(x)
    z = M(r)
    p = z
    rz = jnp.vdot(r, z)
    bnorm = jnp.linalg.norm(b)
    stop = jnp.maximum(rtol * bnorm, atol)

    def cond(state):
        _, r, _, _, _, k = state
        return jnp.logical_and(k < maxiter, jnp.linalg.norm(r) > stop)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = mv(p)
        denom = jnp.vdot(p, Ap)
        alpha = rz / jnp.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    x, r, _, _, _, k = jax.lax.while_loop(
        cond, body, (x, r, z, p, rz, jnp.asarray(0, jnp.int32)))
    return x, k, jnp.linalg.norm(r) / jnp.where(bnorm == 0, 1.0, bnorm)
