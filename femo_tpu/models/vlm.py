"""Differentiable fixed-wake Vortex Lattice Method.

Minimal VLM standing in for the external VAST solver used by the FSI
workloads (SURVEY.md §2.5: "implement a minimal fixed-wake VLM for FSI
workloads"; reference couples VAST VLM via FSI_coupling,
run_aeroelasticity_static_w_feedback.py:258-355).

Everything is jnp: the AIC system is a dense device solve, and forces are
differentiable in the lattice node positions — so aeroelastic adjoints flow
through the aerodynamics with no special handling.

Lattice convention: nodes (nc+1, ns+1, 3), chordwise index first, x roughly
streamwise. Horseshoe vortices: bound segment at panel quarter chord,
trailing legs to +x infinity. Collocation at panel 3/4-chord center.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

EPS = 1e-10


def _biot_savart_segment(p, a, b):
    """Induced velocity at p of a unit vortex segment a->b (Biot-Savart)."""
    r1 = p - a
    r2 = p - b
    r1n = jnp.linalg.norm(r1) + EPS
    r2n = jnp.linalg.norm(r2) + EPS
    cr = jnp.cross(r1, r2)
    denom = r1n * r2n * (r1n * r2n + jnp.dot(r1, r2)) + EPS
    return cr * (r1n + r2n) / (4 * jnp.pi * denom)


def _semi_inf(p, a, direction):
    """Induced velocity of a semi-infinite vortex from a along direction."""
    r = p - a
    rn = jnp.linalg.norm(r) + EPS
    d = direction / jnp.linalg.norm(direction)
    cr = jnp.cross(d, r)
    crn2 = jnp.sum(cr**2) + EPS
    return cr / (4 * jnp.pi * crn2) * (1.0 + jnp.dot(d, r) / rn)


def _horseshoe_velocity(p, qA, qB, wake_dir):
    """Unit-strength horseshoe: trailing-in at qA, bound qA->qB,
    trailing-out at qB."""
    v = _biot_savart_segment(p, qA, qB)
    v = v - _semi_inf(p, qA, wake_dir)  # inbound leg (reversed)
    v = v + _semi_inf(p, qB, wake_dir)
    return v


class VLM:
    """Fixed-wake VLM over a (nc, ns) panel lattice.

    solve(nodes, v_inf) -> dict with panel circulations, forces at bound
    vortex midpoints, total force, CL/CDi (induced from Trefftz-free simple
    KJ forces).
    """

    def __init__(self, nc: int, ns: int, rho: float = 1.0):
        self.nc, self.ns = nc, ns
        self.rho = rho

    @staticmethod
    def bound_midpoints_np(nodes):
        """Bound-vortex (quarter-chord) midpoints in HOST numpy — the
        locations of solve()'s KJ forces ("points").  The FSI builders
        build their RBF force maps at these points at build time; a host
        twin avoids an eager device VLM solve (one small device program
        per op at build time).  MUST stay in sync with
        _geometry's qA/qB."""
        import numpy as np

        lat = np.asarray(nodes)
        qA = lat[:-1, :-1] + 0.25 * (lat[1:, :-1] - lat[:-1, :-1])
        qB = lat[:-1, 1:] + 0.25 * (lat[1:, 1:] - lat[:-1, 1:])
        return (0.5 * (qA + qB)).reshape(-1, 3)

    def _geometry(self, nodes):
        # NOTE: qA/qB below have a host twin in bound_midpoints_np —
        # change both together
        nc, ns = self.nc, self.ns
        n00 = nodes[:-1, :-1]
        n10 = nodes[1:, :-1]
        n01 = nodes[:-1, 1:]
        n11 = nodes[1:, 1:]
        # bound vortex at quarter chord (chordwise direction = axis 0)
        qA = n00 + 0.25 * (n10 - n00)
        qB = n01 + 0.25 * (n11 - n01)
        # collocation at 3/4 chord, mid span
        c0 = n00 + 0.75 * (n10 - n00)
        c1 = n01 + 0.75 * (n11 - n01)
        colloc = 0.5 * (c0 + c1)
        # panel normal
        d1 = n11 - n00
        d2 = n01 - n10
        nrm = jnp.cross(d1, d2)
        nrm = nrm / (jnp.linalg.norm(nrm, axis=-1, keepdims=True) + EPS)
        return (qA.reshape(-1, 3), qB.reshape(-1, 3),
                colloc.reshape(-1, 3), nrm.reshape(-1, 3))

    def solve(self, nodes, v_inf):
        """nodes (nc+1, ns+1, 3); v_inf (3,). Returns dict of results."""
        qA, qB, colloc, nrm = self._geometry(nodes)
        wake = v_inf / jnp.linalg.norm(v_inf)

        def aic_row(p, n):
            vs = jax.vmap(lambda a, b: _horseshoe_velocity(p, a, b, wake))(
                qA, qB)
            return vs @ n

        AIC = jax.vmap(aic_row)(colloc, nrm)  # (np, np)
        rhs = -(nrm @ v_inf)  # no-penetration: (v_inf + v_ind) . n = 0
        gamma = jnp.linalg.solve(AIC, rhs)

        # Kutta-Joukowski forces at bound-vortex midpoints:
        # F = rho * (V x l) * gamma, with V = freestream + induced (from all
        # other horseshoes) at the bound midpoint
        mid = 0.5 * (qA + qB)
        lvec = qB - qA

        def vel_at(p):
            vs = jax.vmap(lambda a, b: _horseshoe_velocity(p, a, b, wake))(
                qA, qB)
            return v_inf + gamma @ vs

        vmid = jax.vmap(vel_at)(mid)
        forces = self.rho * jnp.cross(vmid, lvec) * gamma[:, None]
        total = forces.sum(axis=0)
        return dict(gamma=gamma, forces=forces, points=mid, total=total,
                    colloc=colloc, normals=nrm)

    def coefficients(self, nodes, v_inf, s_ref=None):
        out = self.solve(nodes, v_inf)
        V = jnp.linalg.norm(v_inf)
        if s_ref is None:
            # projected planform area
            qA, qB, colloc, nrm = self._geometry(nodes)
            s_ref = self._planform_area(nodes)
        q = 0.5 * self.rho * V**2 * s_ref
        # lift: perpendicular to freestream in the x-z plane
        vhat = v_inf / V
        lift_dir = jnp.array([-vhat[2], 0.0, vhat[0]])
        lift_dir = lift_dir / jnp.linalg.norm(lift_dir)
        CL = jnp.dot(out["total"], lift_dir) / q
        CDi = jnp.dot(out["total"], vhat) / q
        return CL, CDi, out

    def _planform_area(self, nodes):
        n00 = nodes[:-1, :-1]
        n10 = nodes[1:, :-1]
        n01 = nodes[:-1, 1:]
        n11 = nodes[1:, 1:]
        d1 = (n11 - n00)[..., [0, 1]]
        d2 = (n01 - n10)[..., [0, 1]]
        area = 0.5 * jnp.abs(
            d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0])
        return area.sum()


def flat_wing_lattice(span: float, chord: float, nc: int, ns: int,
                      alpha_deg: float = 0.0):
    """Rectangular planform lattice at incidence alpha (rotated about y)."""
    x = np.linspace(0, chord, nc + 1)
    y = np.linspace(-span / 2, span / 2, ns + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    Z = np.zeros_like(X)
    a = np.deg2rad(alpha_deg)
    Xr = X * np.cos(a)
    Zr = -X * np.sin(a)
    return jnp.asarray(np.stack([Xr, Y, Zr], axis=-1))
