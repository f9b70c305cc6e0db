"""RBF nodal transfer maps for fluid-structure coupling.

Parity with the reference's NodalMap (a local copy of FSI_coupling's math,
/root/reference/examples/test_shell_m3l/shell_pde.py:436-501): radial-basis
influence matrices between non-matching point clouds with Gaussian, Bump, or
ThinPlateSpline kernels, row-normalized for displacement transfer; force
transfer uses the transpose (virtual-work conservative), optionally
mass-matrix weighted (`fmap` solves M w = G^T, shell_module.py:302-308).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import config


def rbf_kernel_matrix(x_to: np.ndarray, x_from: np.ndarray,
                      kind: str = "gaussian", eps: float = 1.0):
    """Influence matrix G[i, j] = phi(|x_to_i - x_from_j|).

    All three kernels are functions of the SQUARED distance, so the matrix
    is built from the gemm identity d2 = |a|^2 + |b|^2 - 2 a.b^T — one
    BLAS call instead of an (n_to, n_from, 3) broadcast temporary + norm
    (which dominated the host build of the coupling maps at the 107k-cell
    FSI anchor)."""
    d2 = (np.sum(x_to**2, axis=1)[:, None]
          + np.sum(x_from**2, axis=1)[None, :]
          - 2.0 * (x_to @ x_from.T))
    np.maximum(d2, 0.0, out=d2)  # clip gemm roundoff
    e2d2 = (eps * eps) * d2
    if kind == "gaussian":
        G = np.exp(-e2d2)
    elif kind == "bump":
        arg = np.where(e2d2 < 1.0, 1.0 - e2d2, 1.0)
        G = np.where(e2d2 < 1.0, np.exp(-1.0 / np.maximum(arg, 1e-14)),
                     0.0)
    elif kind == "thin_plate":
        # r^2 log r = 0.5 r^2 log(r^2)
        r2 = np.maximum(d2, 1e-28)
        G = 0.5 * r2 * np.log(r2)
    else:
        raise ValueError(kind)
    return G


class NodalMap:
    """Row-normalized RBF interpolation from source to target points.

    Displacement transfer: d_to = W @ d_from (per component).
    Conservative force transfer: f_from = W^T @ f_to (virtual work).
    """

    def __init__(self, x_from: np.ndarray, x_to: np.ndarray,
                 kind: str = "gaussian", eps: float | None = None):
        x_from = np.asarray(x_from, float)
        x_to = np.asarray(x_to, float)
        if eps is None:
            # Support must span a few spacings of the COARSER scale in
            # play: the source spacing AND the target-to-nearest-source
            # distance.  Source spacing alone underflows the kernel when
            # the source cloud is much denser than the target offsets
            # (107k-cell wing: shell dy 2e-3, VLM force points 6e-2 away
            # -> every weight < 1e-37, the rowsum floor zeroed the map
            # and the coupled loop silently converged to zero traction).
            from scipy.spatial import cKDTree

            tree = cKDTree(x_from)
            dd, _ = tree.query(x_from, k=min(2, len(x_from)))
            h = float(np.mean(dd[:, -1])) if len(x_from) > 1 else 1.0
            d_to, _ = tree.query(x_to, k=1)
            h = max(h, float(np.mean(d_to)))
            eps = 1.0 / max(3.0 * h, 1e-12)
        G = rbf_kernel_matrix(x_to, x_from, kind, eps)
        rowsum = G.sum(axis=1, keepdims=True)
        # host-side numpy W (W_np); normalizing/casting on device would
        # compile tiny eager programs at build time.  The device copy is
        # LAZY: map-algebra
        # consumers (fsi._vlm_and_maps) never need it, and it is ~57 MB
        # f64 per map at the 107k-cell anchor.
        self.W_np = (G / np.maximum(rowsum, 1e-14)).astype(config.dtype)
        self._W_dev = None
        self.eps = eps

    @property
    def W(self) -> jnp.ndarray:
        if self._W_dev is None:
            W = jnp.asarray(self.W_np)
            if isinstance(W, jax.core.Tracer):
                # first access happened under a jit trace: the "array" is
                # a staged constant — valid in this trace only.  Caching
                # it would leak the tracer; return without caching.
                return W
            self._W_dev = W
        return self._W_dev

    def map_displacements(self, d_from: jnp.ndarray) -> jnp.ndarray:
        """(n_from, k) or (n_from,) -> (n_to, ...)."""
        return self.W @ d_from

    def map_forces_conservative(self, f_to: jnp.ndarray) -> jnp.ndarray:
        """Transpose map: conserves total force and virtual work."""
        return self.W.T @ f_to


def force_map_mass_weighted(nodal_map: NodalMap, lumped_mass: jnp.ndarray):
    """fmap parity (shell_module.py:302-308): solve M w = W^T f with the
    structural (lumped) mass so mapped forces are consistent nodal loads.
    Returns fn(f_to) -> per-area nodal traction on the structure."""

    def fmap(f_to):
        return (nodal_map.W.T @ f_to) / lumped_mass[:, None]

    return fmap
