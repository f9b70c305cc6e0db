"""Form language: quadrature-point values, operators, and form definitions.

JAX replacement for UFL + FFCx codegen (SURVEY.md N1, N11).  Instead
of a symbolic form compiler, integrands are plain Python functions evaluated
*per quadrature point* on JAX values — the user's math IS the traced kernel.
Derivatives that UFL obtained symbolically (`ufl.derivative`,
/root/reference/femo/fea/utils_dolfinx.py:313-314) come from `jax.grad` /
`jax.jacfwd` of these same traced kernels.

An integrand has signature ``fn(w, g)`` where

* ``w`` — namespace of coefficient values at the quadrature point.  Each is a
  :class:`Q` carrying ``val`` and ``grad`` (physical/tangential gradient);
  the test function appears as ``w.v`` and the form must be linear in it.
* ``g`` — geometry namespace: ``g.x`` (position), ``g.n`` (outward unit
  normal, facet integrals), ``g.h`` (cell diameter, CellDiameter parity),
  ``g.tag`` (subdomain marker of the entity).

Example (Poisson interior residual, reference run_poisson_opt.py:31-37)::

    def interior(w, g):
        return dot(grad(w.u), grad(w.v)) - w.f * w.v

    res = FormDef(test=V, coeffs=[u, f], integrals=[dx(interior)])
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Optional, Sequence

import jax.numpy as jnp

from .space import Function, FunctionSpace, TestFunction


def _v(x):
    """Coerce Q -> value array."""
    return x.val if isinstance(x, Q) else x


class Q:
    """A coefficient's value at a quadrature point.

    ``val``: () or (ncomp,); ``grad``: (gdim,) or (ncomp, gdim).
    Arithmetic operators coerce to raw jnp arrays so expressions read like
    UFL: ``w.u - u_ex``, ``w.f * w.v``, ``w.u**3``.
    """

    __slots__ = ("val", "_grad", "_hess")

    def __init__(self, val, grad=None, hess=None):
        self.val = val
        self._grad = grad
        self._hess = hess

    @property
    def grad(self):
        if self._grad is None:
            raise ValueError("gradient not available for this quantity")
        return self._grad

    @property
    def hess(self):
        if self._hess is None:
            raise ValueError(
                "hessian not tabulated for this element (supported for "
                "Hermite/interval families)")
        return self._hess

    # component access keeps gradient rows attached
    def __getitem__(self, i):
        g = None if self._grad is None else self._grad[i]
        h = None if self._hess is None else self._hess[i]
        return Q(self.val[i], g, h)

    # arithmetic — results are plain arrays
    def __add__(self, o): return self.val + _v(o)
    def __radd__(self, o): return _v(o) + self.val
    def __sub__(self, o): return self.val - _v(o)
    def __rsub__(self, o): return _v(o) - self.val
    def __mul__(self, o): return self.val * _v(o)
    def __rmul__(self, o): return _v(o) * self.val
    def __truediv__(self, o): return self.val / _v(o)
    def __rtruediv__(self, o): return _v(o) / self.val
    def __pow__(self, p): return self.val ** p
    def __neg__(self): return -self.val
    def __abs__(self): return jnp.abs(self.val)


class GlobalCoefficient:
    """A named scalar/small-vector parameter entering integrands uniformly
    (not a field): currents, angles, time-step sizes.  Differentiable like
    any coefficient; reference passes these as CSDL scalars (e.g. iq in
    run_motor_opt.py)."""

    def __init__(self, name: str, value=0.0):
        self.name = name
        import jax.numpy as _jnp

        from ..config import config as _config

        self.array = _jnp.asarray(value, _config.jdtype)

    def rename(self, name, *_):
        self.name = name


class QR:
    """Two-sided (interior-facet) restriction of a coefficient: u('+')/u('-')."""

    __slots__ = ("p", "m")

    def __init__(self, p: Q, m: Q):
        self.p = p
        self.m = m

    def __call__(self, side: str) -> Q:
        return self.p if side == "+" else self.m


# --- vector/tensor calculus helpers (UFL operator parity) -------------------

def grad(u):
    return u.grad if isinstance(u, Q) else u


def hess(u):
    """Second-derivative tensor (gdim, gdim) — for 4th-order forms like the
    Euler-Bernoulli beam (div(grad(u)) in reference
    run_thickness_opt_cantilever_beam.py:72-79)."""
    return u.hess if isinstance(u, Q) else u


def div_grad(u):
    """Laplacian tr(hess(u)) — ufl div(grad(u)) parity for scalar fields."""
    return jnp.trace(hess(u))


def div(u):
    g = u.grad if isinstance(u, Q) else u
    return jnp.trace(g)


def curl2d(u):
    """Scalar curl of a 2D vector field / rotated gradient for scalar."""
    g = grad(u)
    if g.ndim == 1:  # scalar field: perp gradient
        return jnp.stack([g[1], -g[0]])
    return g[1, 0] - g[0, 1]


def dot(a, b):
    a, b = _v(a), _v(b)
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim == 1 and b.ndim == 1:
        return jnp.dot(a, b)
    return jnp.matmul(a, b)


def inner(a, b):
    a, b = jnp.asarray(_v(a)), jnp.asarray(_v(b))
    return jnp.sum(a * b)


def outer(a, b):
    return jnp.outer(jnp.asarray(_v(a)), jnp.asarray(_v(b)))


def cross(a, b):
    return jnp.cross(jnp.asarray(_v(a)), jnp.asarray(_v(b)))


def sym(a):
    a = jnp.asarray(_v(a))
    return 0.5 * (a + a.T)


def skew(a):
    a = jnp.asarray(_v(a))
    return 0.5 * (a - a.T)


def tr(a):
    return jnp.trace(jnp.asarray(_v(a)))


def dev(a):
    a = jnp.asarray(_v(a))
    d = a.shape[-1]
    return a - (jnp.trace(a) / d) * jnp.eye(d, dtype=a.dtype)


def Identity(d: int):
    return jnp.eye(d)


def det(a):
    return jnp.linalg.det(jnp.asarray(_v(a)))


def inv(a):
    return jnp.linalg.inv(jnp.asarray(_v(a)))


def transpose(a):
    return jnp.asarray(_v(a)).T


def sqrt(a):
    return jnp.sqrt(_v(a))


def exp(a):
    return jnp.exp(_v(a))


def ln(a):
    return jnp.log(_v(a))


def sin(a):
    return jnp.sin(_v(a))


def cos(a):
    return jnp.cos(_v(a))


def conditional(cond, a, b):
    """ufl.conditional parity (piecewise material laws, motor_pde.py:16-26)."""
    return jnp.where(cond, _v(a), _v(b))


def lt(a, b): return _v(a) < _v(b)
def gt(a, b): return _v(a) > _v(b)
def le(a, b): return _v(a) <= _v(b)
def ge(a, b): return _v(a) >= _v(b)


def avg(u):
    if isinstance(u, QR):
        return 0.5 * (u.p.val + u.m.val)
    return 0.5 * (u("+") + u("-"))


def jump(u, n=None):
    if isinstance(u, QR):
        d = u.p.val - u.m.val
    else:
        d = u("+") - u("-")
    if n is None:
        return d
    return jnp.outer(d, n) if jnp.asarray(d).ndim else d * n


# --- deformed-configuration operators (utils_dolfinx.py:34-66 parity) -------

def defF(uhat):
    """Deformation gradient F = I + grad(uhat)."""
    g = grad(uhat)
    return jnp.eye(g.shape[-1]) + g


def detF(uhat):
    """J = det(F(uhat)) — integration-measure scaling of the deformed
    configuration (reference `J`)."""
    from .assemble import _det_small

    return _det_small(defF(uhat))


def gradx(f, uhat):
    """Gradient in the deformed configuration: grad(f) @ inv(F(uhat))."""
    from .assemble import _inv_small

    return dot(grad(f), _inv_small(defF(uhat)))


# --- integral / form definitions --------------------------------------------

@dataclass
class Integral:
    fn: Callable
    domain: str = "cell"  # "cell" | "exterior_facet" | "interior_facet"
    tag: Optional[object] = None  # int, tuple of ints, or None (everywhere)
    qdeg: Optional[int] = None


def dx(fn, tag=None, qdeg=None) -> Integral:
    """Cell integral (UFL ``dx`` measure parity)."""
    return Integral(fn, "cell", tag, qdeg)


def ds(fn, tag=None, qdeg=None) -> Integral:
    """Exterior-facet integral (UFL ``ds``)."""
    return Integral(fn, "exterior_facet", tag, qdeg)


def dS(fn, tag=None, qdeg=None) -> Integral:
    """Interior-facet integral (UFL ``dS``)."""
    return Integral(fn, "interior_facet", tag, qdeg)


class FormDef:
    """A sum of integrals over named coefficients.

    Parameters
    ----------
    integrals : list of Integral
    coeffs : list of Function — named coefficients; the integrand accesses
        them as ``w.<name>``.
    test : FunctionSpace or TestFunction — if present, this is a residual
        (1-form); the integrand must be linear in ``w.v``.
    """

    def __init__(self, integrals: Sequence[Integral],
                 coeffs: Sequence[Function] = (),
                 test: FunctionSpace | TestFunction | None = None):
        self.integrals = list(integrals)
        self.coeffs: dict[str, Function] = {}
        self.globals: dict[str, GlobalCoefficient] = {}
        for f in coeffs:
            target = (self.globals if isinstance(f, GlobalCoefficient)
                      else self.coeffs)
            if f.name in self.coeffs or (
                    f.name in self.globals
                    and self.globals.get(f.name) is not f):
                if target.get(f.name) is not f:
                    raise ValueError(
                        f"duplicate coefficient name '{f.name}'")
            target[f.name] = f
        if isinstance(test, TestFunction):
            test = test.space
        self.test: FunctionSpace | None = test
        self._assembler = None  # cache, built by assemble module

    def __add__(self, other: "FormDef") -> "FormDef":
        if other is None or other == 0:
            return self
        test = self.test or other.test
        if self.test is not None and other.test is not None \
                and self.test is not other.test:
            raise ValueError("cannot add forms with different test spaces")
        coeffs = {**self.coeffs, **other.coeffs,
                  **self.globals, **other.globals}
        out = FormDef(self.integrals + other.integrals,
                      coeffs.values(), test)
        return out

    __radd__ = __add__

    def values(self) -> dict[str, jnp.ndarray]:
        """Current coefficient arrays (defaults for assembly)."""
        out = {k: f.array for k, f in self.coeffs.items()}
        out.update({k: f.array for k, f in self.globals.items()})
        return out
