"""Motor PDE kernels: nonlinear magnetostatics in a deformed configuration,
hyperelastic mesh motion with Nitsche interface BCs, and B-power outputs.

Behavior parity with /root/reference/examples/em_motor_opt/motor_pde.py,
re-designed for batched device execution: instead of one UFL term per subdomain (216 separate
``dx(i)`` measures, motor_pde.py:99-106), a SINGLE fused cell kernel gathers
per-cell material properties from tag-indexed tables (steel B-H curve,
magnet remanence vectors, winding current densities) — one vmapped kernel
over all cells, no per-subdomain assembly loop.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ...fea.forms import (
    FormDef, GlobalCoefficient, dx, ds, dS, grad, dot, defF, detF,
)
from ...fea.assemble import _inv_small, _det_small
from .mesh import MotorTags, N_MAGNETS, N_WINDINGS
from .permeability import PiecewiseBHCurve

T = MotorTags
VACUUM_PERM = 4e-7 * np.pi
EPS = 3e-16
NTAGS = 64  # table size >= max subdomain tag + 1


def source_tables(iq, angle, Hc=838.0e3):
    """Tag-indexed magnet-H and winding-current tables.

    Parity with motor_pde.py JS(:47-88): magnet i gets alternating-polarity
    remanent field H at its pole angle; windings carry the three-phase
    pattern [B-, A+, C-] / sign-alternating per pole.  Differentiable in
    (iq, angle). Returns (Htable (NTAGS,2), Jtable (NTAGS,))."""
    p = N_MAGNETS
    base = 2 * jnp.pi / p / 2
    sweep = 2 * jnp.pi / p
    i = jnp.arange(p)
    flux_angle = base + i * sweep + angle * 2 / p
    sgn = (-1.0) ** i
    Hx = sgn * Hc * jnp.cos(flux_angle)
    Hy = sgn * Hc * jnp.sin(flux_angle)
    Htable = jnp.zeros((NTAGS, 2))
    Htable = Htable.at[T.MAGNET_FIRST + i, 0].set(Hx)
    Htable = Htable.at[T.MAGNET_FIRST + i, 1].set(Hy)

    iA = iq * jnp.sin(angle) + EPS
    iB = iq * jnp.sin(angle - 2 * jnp.pi / 3) + EPS
    iC = iq * jnp.sin(angle + 2 * jnp.pi / 3) + EPS
    Jtable = jnp.zeros(NTAGS)
    coils_per_pole = 3
    for pole in range(p):
        start = T.WINDING_FIRST + pole * coils_per_pole
        s = (-1.0) ** pole
        Jtable = Jtable.at[start].set(-s * iB)
        Jtable = Jtable.at[start + 1].set(s * iA)
        Jtable = Jtable.at[start + 2].set(-s * iC)
    return Htable, Jtable


def relative_permeability(tag, B_norm, bh: PiecewiseBHCurve):
    """Tag-dispatched mu_r (motor_pde.py RelativePermeability :12-35)."""
    steel = (tag == T.ROTOR_STEEL) | (tag == T.STATOR_STEEL)
    magnet = (tag >= T.MAGNET_FIRST) & (tag <= T.MAGNET_LAST)
    return jnp.where(steel, bh(B_norm), jnp.where(magnet, 1.05, 1.0))


def em_residual_form(A_z, uhat, Htable, Jtable, bh: PiecewiseBHCurve,
                     test_space=None):
    """Magnetostatics residual: div(1/(mu0 mur) gradx A_z) = J_s on the
    deformed configuration (motor_pde.py pdeResEM :93-133), fused kernel."""

    uname, hname = A_z.name, uhat.name

    def em(w, g):
        Fh = defF(getattr(w, hname))
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        gu = dot(grad(getattr(w, uname)), Finv)
        gv = dot(grad(w.v), Finv)
        Bn = jnp.sqrt(gu[0] ** 2 + gu[1] ** 2 + EPS)
        mur = relative_permeability(g.tag, Bn, bh)
        res = (1.0 / VACUUM_PERM) * (1.0 / mur) * dot(gu, gv) * Jh
        # magnet source: inner(H, curl v)
        H = w.Htable.val[g.tag]
        curl_v = jnp.stack([gv[1], -gv[0]])
        res = res - dot(H, curl_v) * Jh
        # winding source
        res = res - w.Jtable.val[g.tag] * w.v * Jh
        return res

    return FormDef([dx(em, qdeg=2)], coeffs=[A_z, uhat, Htable, Jtable],
                   test=test_space or A_z.space)


def em_nitsche_boundary_form(A_z, uhat, bh: PiecewiseBHCurve,
                             g_bc: float = 0.0, sym: bool = True,
                             beta: float = 1e6, tags=(1000, 1001),
                             test_space=None):
    """Nitsche weak enforcement of A_z = g on exterior boundaries in the
    DEFORMED configuration (motor_pde.py pdeResEM nitsche branch :109-131):
    the boundary normal and area element transform by Nanson's formula
    ds_x n_x = J F^{-T} n ds_X."""
    uname, hname = A_z.name, uhat.name
    sgn = 1.0 if sym else -1.0

    def bdry(w, g):
        Fh = defF(getattr(w, hname))
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        # Nanson: deformed-area-weighted normal (not unit!)
        nans = Jh * (Finv.T @ g.n)
        gu = dot(grad(getattr(w, uname)), Finv)
        gv = dot(grad(w.v), Finv)
        Bn = jnp.sqrt(gu[0] ** 2 + gu[1] ** 2 + EPS)
        # material coefficient dispatches on the boundary CELL's subdomain
        # tag (g.ctag), not the facet marker: on the stator-steel outer rim
        # the consistency term must use the steel permeability (reference
        # motor_pde.py:119-121)
        coeff = (1.0 / VACUUM_PERM) / relative_permeability(g.ctag, Bn, bh)
        u_g = getattr(w, uname) - g_bc
        r = coeff * (-dot(gu, nans) * w.v
                     - sgn * dot(gv, nans) * u_g)
        if sym:
            norm_nans = jnp.sqrt(jnp.sum(nans**2) + EPS)
            r = r + beta / g.h * coeff * norm_nans * w.v * u_g
        return r

    return FormDef([ds(bdry, tag=tuple(tags), qdeg=2)],
                   coeffs=[A_z, uhat], test=test_space or A_z.space)


def _pk1(G):
    """First Piola-Kirchhoff stress of the stiffened fictitious material
    (motor_pde.py pdeResMM :141-157): K = mu = det(F)^-3."""
    I = jnp.eye(2)
    F = I + G
    detF = F[0, 0] * F[1, 1] - F[0, 1] * F[1, 0]
    E = 0.5 * (F.T @ F - I)
    K = 1.0 / detF**3
    mu = 1.0 / detF**3
    trE = jnp.trace(E)
    S = K * trE * I + 2.0 * mu * (E - trE * I / 3.0)
    return F @ S, detF


def mesh_motion_residual_form(uhat, uhat_bc, beta: float = 5e3,
                              sym: bool = True,
                              interface_tag: int = T.MAGNET_INTERFACE,
                              test_space=None):
    """Fictitious-hyperelasticity mesh motion with Nitsche enforcement of
    uhat = uhat_bc on interior interface facets (motor_pde.py :137-183).

    Exterior boundaries are handled by strong BCs in the model.
    The consistency term's linearized stress dP(uhat; v) is a `jax.jvp` of
    the traced stress kernel — replacing `ufl.derivative` (:172).
    """

    hname, bname = uhat.name, uhat_bc.name

    def interior(w, g):
        P, _ = _pk1(grad(getattr(w, hname)))
        return jnp.sum(P * grad(w.v))

    def nitsche(w, g):
        total = 0.0
        for side, nsgn in (("+", 1.0), ("-", -1.0)):
            uh = getattr(w, hname)(side)
            vv = w.v(side)
            gb = getattr(w, bname)(side)
            n = nsgn * g.n
            Gu = uh.grad
            P, detFh = _pk1(Gu)
            # consistency
            total = total - dot(dot(P, n), vv.val)
            # adjoint-consistency: dP(uhat; v) . n . (uhat - g)
            dP = jax.jvp(lambda G: _pk1(G)[0], (Gu,), (vv.grad,))[1]
            sgn = 1.0 if sym else -1.0
            total = total + sgn * dot(dot(dP, n), uh.val - gb.val)
            if sym:
                b = beta / detFh**3
                total = total + b / g.h * dot(vv.val, uh.val - gb.val)
        return total

    return FormDef(
        [dx(interior, qdeg=3), dS(nitsche, tag=interface_tag, qdeg=3)],
        coeffs=[uhat, uhat_bc], test=test_space or uhat.space)


def b_power_form(A_z, uhat, n_exp: float, subdomains=(1, 2)):
    """int |B|^n J(uhat) over tagged subdomains (motor_pde.py :186-197)."""

    uname, hname = A_z.name, uhat.name

    def integrand(w, g):
        Fh = defF(getattr(w, hname))
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        gA = dot(grad(getattr(w, uname)), Finv)
        Bn = jnp.sqrt(gA[0] ** 2 + gA[1] ** 2 + EPS)
        return Bn**n_exp * Jh

    return FormDef([dx(integrand, tag=tuple(subdomains), qdeg=2)],
                   coeffs=[A_z, uhat])


def area_form(uhat, subdomains):
    """Deformed-configuration subdomain area (motor_pde.py area_form)."""

    hname = uhat.name

    def integrand(w, g):
        return detF(getattr(w, hname))

    return FormDef([dx(integrand, tag=tuple(subdomains), qdeg=2)],
                   coeffs=[uhat])


def power_losses(B_eddy, B_hyst, frequency=1000.0, motor_length=0.07,
                 hysteresis_coeff=55.0):
    """Loss post-model (postprocessor/power_loss_model.py:58-85):
    eddy = 2 pi^2 f^2 L * B_infl_eddy * 0.07;
    hysteresis = 2 pi f * k_h * L * B_infl_hyst."""
    eddy = 2 * np.pi**2 * frequency**2 * motor_length * B_eddy * 0.07
    hyst = 2 * np.pi * frequency * hysteresis_coeff * motor_length * B_hyst
    return eddy, hyst


def b_field_output_form(A_z, uhat, V_cg1):
    """1-form projecting |B| = |gradx A_z| onto CG1 (field output for
    recorders/visualization — the reference records A_z/uhat via XDMF,
    fea_dolfinx.py:228-234; |B| is the quantity engineers inspect)."""
    uname, hname = A_z.name, uhat.name

    def integrand(w, g):
        Fh = defF(getattr(w, hname))
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        gA = dot(grad(getattr(w, uname)), Finv)
        Bn = jnp.sqrt(gA[0] ** 2 + gA[1] ** 2 + EPS)
        return Bn * w.v

    return FormDef([dx(integrand, qdeg=2)], coeffs=[A_z, uhat],
                   test=V_cg1)


def torque_form(A_z, uhat, gap_tags=(T.AIR,), r_in: float | None = None,
                r_out: float | None = None, length: float = 0.07):
    """Electromagnetic torque by Arkkio's method: integrate the Maxwell
    stress r*B_r*B_theta / (mu0 (r_out - r_in)) over the air-gap annulus.

    The reference delegates torque to the external electric_motor_mdo
    package; this is the standard in-FEM formulation, differentiable in
    all inputs (B from gradx A_z in the deformed configuration)."""
    from .mesh import RADII

    r_in = RADII["r3"] if r_in is None else r_in
    r_out = RADII["r4"] if r_out is None else r_out
    uname, hname = A_z.name, uhat.name

    def integrand(w, g):
        uh = getattr(w, hname)
        Fh = defF(uh)
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        gA = dot(grad(getattr(w, uname)), Finv)
        # B = (dA/dy, -dA/dx)
        Bx, By = gA[1], -gA[0]
        # radius / radial decomposition / annulus gate in the DEFORMED
        # configuration (B and the area element Jh live there; shape dvs
        # displace the r3 circle, so uhat != 0 in the gap)
        xd = g.x + uh.val
        r = jnp.sqrt(xd[0] ** 2 + xd[1] ** 2 + EPS)
        cx, cy = xd[0] / r, xd[1] / r
        Br = Bx * cx + By * cy
        Bt = -Bx * cy + By * cx
        # restrict to the air-gap annulus (the AIR tag also covers other
        # regions; gate by radius)
        in_gap = (r > r_in) & (r < r_out)
        w_gap = jnp.where(in_gap, 1.0, 0.0)
        return (length / (VACUUM_PERM * (r_out - r_in))) \
            * w_gap * r * Br * Bt * Jh

    return FormDef([dx(integrand, tag=tuple(gap_tags), qdeg=2)],
                   coeffs=[A_z, uhat])
