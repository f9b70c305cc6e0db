"""Native (C++) runtime components with ctypes bindings.

The compiled library provides host-side mesh/runtime primitives (SURVEY.md
N2 equivalents): RCB cell partitioning for SPMD sharding, RCM dof ordering,
greedy cell coloring, and sort-based facet extraction.  Pure-numpy fallbacks
keep everything working if the toolchain is unavailable.

The library is built on demand with g++ (no pip deps) and cached next to
this file under a name keyed by the source and the host, so a library
copied from another machine or an older source is rebuilt, never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "femo_native.cpp")


def _so_path():
    with open(_SRC, "rb") as fh:
        key = hashlib.sha256(fh.read())
    key.update("|".join(platform.uname()).encode())
    return os.path.join(_DIR, f"libfemo_native.{key.hexdigest()[:16]}.so")


_SO = _so_path()

_lib = None
_build_failed = False


def _build() -> bool:
    # build to a private name, then rename: concurrent processes (test
    # workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if not os.path.exists(_SO):
        if not _build():
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        _build_failed = True
        return None
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_f64p = ctypes.POINTER(ctypes.c_double)
    lib.rcb_partition.argtypes = [c_f64p, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int32, c_i32p]
    lib.rcm_order.argtypes = [c_i64p, c_i32p, ctypes.c_int64, c_i32p]
    lib.greedy_color.argtypes = [c_i32p, ctypes.c_int64, ctypes.c_int32,
                                 ctypes.c_int64, c_i32p]
    lib.greedy_color.restype = ctypes.c_int32
    lib.unique_facets.argtypes = [c_i32p, ctypes.c_int64, ctypes.c_int32,
                                  c_i64p]
    lib.unique_facets.restype = ctypes.c_int64
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bt_dest_map.argtypes = [c_i64p, c_i64p, ctypes.c_int64,
                                ctypes.c_int32, ctypes.c_int32, c_i64p,
                                c_u8p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, c_i64p]
    lib.csr_pattern.argtypes = [c_i32p, c_i32p, ctypes.c_int64,
                                ctypes.c_int64, c_i64p, c_i32p]
    lib.csr_pattern.restype = ctypes.c_int64
    lib.csr_block_count.argtypes = [c_i32p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, c_i64p]
    lib.csr_block_fill.argtypes = [c_i32p, c_i32p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64, c_i64p,
                                   c_i32p]
    lib.csr_pattern_finalize.argtypes = [c_i64p, c_i32p, ctypes.c_int64,
                                         c_i64p, c_i32p]
    lib.csr_pattern_finalize.restype = ctypes.c_int64
    lib.csr_bandwidth.argtypes = [c_i64p, c_i32p, c_i64p, ctypes.c_int64]
    lib.csr_bandwidth.restype = ctypes.c_int64
    _lib = lib
    return lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Partition points into nparts balanced spatial blocks (RCB).

    Native C++ when available; numpy recursive fallback otherwise.
    """
    centroids = np.ascontiguousarray(centroids, np.float64)
    n, dim = centroids.shape
    out = np.empty(n, np.int32)
    lib = get_lib()
    if lib is not None:
        lib.rcb_partition(_ptr(centroids, ctypes.c_double), n, dim,
                          nparts, _ptr(out, ctypes.c_int32))
        return out

    def rec(idx, p0, np_):
        if np_ == 1:
            out[idx] = p0
            return
        span = centroids[idx].max(0) - centroids[idx].min(0)
        axis = int(np.argmax(span))
        order = idx[np.argsort(centroids[idx, axis], kind="stable")]
        mid = len(order) // 2
        rec(order[:mid], p0, np_ // 2)
        rec(order[mid:], p0 + np_ // 2, np_ - np_ // 2)

    rec(np.arange(n), 0, nparts)
    return out


def rcm_order(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (new-to-old) of a CSR graph."""
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    out = np.empty(n, np.int32)
    lib = get_lib()
    if lib is not None:
        lib.rcm_order(_ptr(indptr, ctypes.c_int64),
                      _ptr(indices, ctypes.c_int32), n,
                      _ptr(out, ctypes.c_int32))
        return out
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = csr_matrix((np.ones(len(indices)), indices, indptr), shape=(n, n))
    return reverse_cuthill_mckee(A).astype(np.int32)


def greedy_color(cell_dofs: np.ndarray, n_dofs: int):
    """Greedy conflict-free cell coloring; returns (colors, n_colors)."""
    cell_dofs = np.ascontiguousarray(cell_dofs, np.int32)
    nc, nd = cell_dofs.shape
    out = np.full(nc, -1, np.int32)
    lib = get_lib()
    if lib is not None:
        k = lib.greedy_color(_ptr(cell_dofs, ctypes.c_int32), nc, nd,
                             n_dofs, _ptr(out, ctypes.c_int32))
        return out, int(k)
    # numpy fallback
    dof_cells = [[] for _ in range(n_dofs)]
    for c in range(nc):
        for d in cell_dofs[c]:
            dof_cells[d].append(c)
    k = 0
    for c in range(nc):
        used = {out[nb] for d in cell_dofs[c] for nb in dof_cells[d]
                if nb < c}
        col = 0
        while col in used:
            col += 1
        out[c] = col
        k = max(k, col + 1)
    return out, k


def unique_facets(keys: np.ndarray):
    """Map each sorted facet-vertex key row to a unique facet id.

    Returns (ids (n_keys,), n_unique). Native lexicographic sort — the hot
    O(n log n) step of mesh topology derivation for large meshes.
    """
    keys = np.ascontiguousarray(keys, np.int32)
    nk, nvf = keys.shape
    out = np.empty(nk, np.int64)
    lib = get_lib()
    if lib is not None:
        nu = lib.unique_facets(_ptr(keys, ctypes.c_int32), nk, nvf,
                               _ptr(out, ctypes.c_int64))
        return out, int(nu)
    _, ids = np.unique(keys, axis=0, return_inverse=True)
    return ids.astype(np.int64), int(ids.max()) + 1


def bt_dest_map(rows, cols, iperm, free_mask, B, nb, dump):
    """Fused destination-id pass for BlockTridiagTemplate (one element-
    matrix block): per (e, i, j) entry the flat (D, L, U) accumulator id,
    or `dump` when BC-masked/off-tridiagonal.  Returns int64 (ne*nr*nc,),
    or None when the native library is unavailable (caller falls back to
    the vectorized-numpy path — same result, ~40 full-array passes)."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    iperm = np.ascontiguousarray(iperm, np.int64)
    ne, nr = rows.shape
    nc = cols.shape[1]
    out = np.empty(ne * nr * nc, np.int64)
    fmp = None
    if free_mask is not None:
        fm = np.ascontiguousarray(np.asarray(free_mask).astype(np.uint8))
        fmp = fm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib.bt_dest_map(_ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
                    ne, nr, nc, _ptr(iperm, ctypes.c_int64), fmp,
                    int(B), int(nb), int(dump),
                    _ptr(out, ctypes.c_int64))
    return out


def csr_pattern(gr, gc, n):
    """Deduplicated CSR sparsity pattern from COO entry id lists.

    Returns (indptr int64 (n+1,), indices int32 (nnz,)), or None when the
    native library is unavailable (caller falls back to scipy coo/tocsr).
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "csr_pattern"):
        return None
    gr = np.ascontiguousarray(gr, np.int32)
    gc = np.ascontiguousarray(gc, np.int32)
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(len(gr), np.int32)
    nnz = lib.csr_pattern(_ptr(gr, ctypes.c_int32), _ptr(gc, ctypes.c_int32),
                          len(gr), n, _ptr(indptr, ctypes.c_int64),
                          _ptr(indices, ctypes.c_int32))
    return indptr, indices[:nnz].copy()


def csr_pattern_from_blocks(blocks, n):
    """Deduplicated CSR pattern straight from element (rows, cols) block
    id arrays [( (ne,nr), (ne,nc) ), ...] — the expanded n_entries COO id
    arrays are never materialized (C++ count/fill/finalize passes).

    Returns (indptr int64 (n+1,), indices int32 (nnz,)), or None when the
    native library is unavailable.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "csr_block_count"):
        return None
    blocks = [(np.ascontiguousarray(r, np.int32),
               np.ascontiguousarray(c, np.int32)) for r, c in blocks]
    count = np.zeros(n + 1, np.int64)
    for r, c in blocks:
        ne, nr = r.shape
        nc = c.shape[1]
        lib.csr_block_count(_ptr(r, ctypes.c_int32), ne, nr, nc,
                            _ptr(count, ctypes.c_int64))
    off = np.cumsum(count)  # (n+1,), off[0]=0: pair offsets w/ duplicates
    cols_buf = np.empty(off[-1], np.int32)
    cur = off[:-1].copy()
    for r, c in blocks:
        ne, nr = r.shape
        nc = c.shape[1]
        lib.csr_block_fill(_ptr(r, ctypes.c_int32), _ptr(c, ctypes.c_int32),
                           ne, nr, nc, _ptr(cur, ctypes.c_int64),
                           _ptr(cols_buf, ctypes.c_int32))
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(len(cols_buf), np.int32)
    nnz = lib.csr_pattern_finalize(_ptr(off, ctypes.c_int64),
                                   _ptr(cols_buf, ctypes.c_int32), n,
                                   _ptr(indptr, ctypes.c_int64),
                                   _ptr(indices, ctypes.c_int32))
    return indptr, indices[:nnz].copy()


def csr_bandwidth(indptr, indices, iperm):
    """max |iperm[r] - iperm[c]| over the pattern, or None w/o the lib."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "csr_bandwidth"):
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    iperm = np.ascontiguousarray(iperm, np.int64)
    return int(lib.csr_bandwidth(_ptr(indptr, ctypes.c_int64),
                                 _ptr(indices, ctypes.c_int32),
                                 _ptr(iperm, ctypes.c_int64),
                                 len(indptr) - 1))
