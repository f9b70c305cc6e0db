"""Composite (multi-field) implicit states: block residuals and Jacobians.

JAX replacement for mixed elements (the reference's RM shell uses a
basix mixed CG2/CG1 element via shell_analysis_fenicsx,
/root/reference/examples/test_shell_m3l/shell_pde.py:219-235).  Instead of a
monolithic mixed element, a CompositeState concatenates independent fields
(each with its own FunctionSpace) into one state vector; residual blocks are
ordinary 1-forms against each field's test space, and the block Jacobian is
an ElementMatrix whose row/col indices carry the field offsets — the same
batched-einsum SpMV and dense-LU machinery applies unchanged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..config import config
from .assemble import CompiledForm, ElementMatrix, MatBlock, compile_form
from .bc import DirichletBC, bc_arrays
from .forms import FormDef
from .space import Function


class CompositeState:
    """Fields stacked into one monolithic state vector.

    Parameters
    ----------
    fields : list of Function — the sub-states, in stacking order
    residuals : dict field_name -> FormDef (1-form against that field's
        space); each form may reference every field plus extra inputs.
    bcs : list of DirichletBC on any field's space.
    """

    def __init__(self, fields: Sequence[Function],
                 residuals: dict[str, FormDef],
                 bcs: Sequence[DirichletBC] = ()):
        self.fields = list(fields)
        self.names = [f.name for f in fields]
        self.offsets: dict[str, int] = {}
        off = 0
        for f in fields:
            self.offsets[f.name] = off
            off += f.space.n_dofs
        self.n_dofs = off
        self.residual_forms = {k: residuals[k] for k in self.names}
        self.cforms: dict[str, CompiledForm] = {
            k: compile_form(v) for k, v in self.residual_forms.items()}

        free = np.ones(self.n_dofs, bool)
        vals = np.zeros(self.n_dofs)
        for bc in bcs:
            for f in self.fields:
                if bc.space is f.space:
                    o = self.offsets[f.name]
                    free[o + bc.dofs] = False
                    vals[o + bc.dofs] = bc.values
        self.free = jnp.asarray(free)
        self.bc_values = jnp.asarray(vals, config.jdtype)
        self._jit = {}

    # -- split/concat -------------------------------------------------------------
    def split(self, x) -> dict[str, jnp.ndarray]:
        out = {}
        for f in self.fields:
            o = self.offsets[f.name]
            out[f.name] = x[o : o + f.space.n_dofs]
        return out

    def concat(self, parts: dict[str, jnp.ndarray]) -> jnp.ndarray:
        return jnp.concatenate([parts[f.name] for f in self.fields])

    def current(self) -> jnp.ndarray:
        return self.concat({f.name: f.array for f in self.fields})

    def push(self, x):
        """Write a solution back into the field Functions."""
        parts = self.split(x)
        for f in self.fields:
            f.array = parts[f.name]

    # -- assembly ------------------------------------------------------------------
    def _values(self, x, inputs: dict):
        vals = {}
        for cf in self.cforms.values():
            form = cf.form
            for name, fobj in {**form.coeffs, **form.globals}.items():
                vals.setdefault(name, fobj.array)
        vals.update(inputs or {})
        vals.update(self.split(x))  # state fields always win
        return vals

    def residual(self, x, inputs: dict | None = None):
        vals = self._values(x, inputs or {})
        parts = []
        for name in self.names:
            cf = self.cforms[name]
            # jitted+cached assembly — tracing each Newton call would
            # dominate runtime for the big shell kernels
            parts.append(cf.vector_jit()(
                {k: vals[k] for k in cf.all_names}))
        return jnp.concatenate(parts)

    def jacobian(self, x, inputs: dict | None = None) -> ElementMatrix:
        vals = self._values(x, inputs or {})
        blocks = []
        for rname in self.names:
            cf = self.cforms[rname]
            roff = self.offsets[rname]
            for cname in self.names:
                if cname not in cf.form.coeffs:
                    continue
                coff = self.offsets[cname]
                raw = cf.matrix_blocks_jit(cname)(
                    {k: vals[k] for k in cf.all_names})
                for A, rows, cols in raw:
                    blocks.append(MatBlock(A, rows + roff, cols + coff))
        return ElementMatrix(blocks, self.n_dofs, self.n_dofs)

    def jacobian_pattern(self) -> ElementMatrix:
        """Pattern-only composite Jacobian (host dofmaps + broadcast-zero
        values, offsets applied): BlockTridiagTemplate prototypes without
        running any device assembly at build time."""
        blocks = []
        for rname in self.names:
            cf = self.cforms[rname]
            roff = self.offsets[rname]
            for cname in self.names:
                if cname not in cf.form.coeffs:
                    continue
                coff = self.offsets[cname]
                for b in cf.matrix_pattern(cname).blocks:
                    blocks.append(MatBlock(
                        b.A, np.asarray(b.rows) + roff,
                        np.asarray(b.cols) + coff))
        return ElementMatrix(blocks, self.n_dofs, self.n_dofs)


def composite_implicit_op(state: CompositeState, arg_names: Sequence[str],
                          linear_solver=None, newton_opts=None,
                          custom_solve=None, mode: str = "eager"):
    """ImplicitSolveOp over a CompositeState (same IFT custom_vjp)."""
    from ..graph.implicit import ImplicitSolveOp

    op = ImplicitSolveOp.__new__(ImplicitSolveOp)
    from ..solvers.linear import LinearSolver

    op.cform = None
    op.state_name = "+".join(state.names)
    op.arg_names = list(arg_names)
    op.free = state.free
    op.bc_values = state.bc_values
    op.linear_solver = linear_solver or LinearSolver()
    op.newton_opts = dict(newton_opts or {})
    op.custom_solve = custom_solve
    op._fac_stash = {}
    op._stash_ctr = 0
    op.n_dofs = state.n_dofs
    op.mode = mode

    # override residual/jacobian with the composite versions
    op.residual = lambda u, inputs: state.residual(u, inputs)
    op.jacobian = lambda u, inputs: state.jacobian(u, inputs)

    if mode == "jit_dense":
        from ..graph.implicit import implicit_solve_dense_jit

        iters = op.newton_opts.get("jit_newton_iters", 1)
        op._solve = implicit_solve_dense_jit(
            op.residual, lambda u, p: op.jacobian(u, p).to_dense(),
            op.free, op.bc_values, newton_iters=iters)
    elif mode == "jit_bt":
        # scalable device path: RCM block-tridiagonal Thomas factorization
        # (analyze once host-side, refill+factor per Newton step inside the
        # jit) — the production MUMPS replacement for shells/FSI at scale
        # (VERDICT r1 item 5; reference solves everything through
        # PETSc/MUMPS, utils_dolfinx.py:476-493)
        from ..graph.implicit import implicit_solve_bt_jit
        from ..ops.block_tridiag import BlockTridiagTemplate

        iters = op.newton_opts.get("jit_newton_iters", 1)
        pcg = op.newton_opts.get("pcg_iters", 0)
        proto = state.jacobian_pattern()
        tpl = BlockTridiagTemplate(proto, free=np.asarray(state.free))
        op._solve = implicit_solve_bt_jit(
            op.residual,
            lambda u, p: [(b.A, b.rows, b.cols)
                          for b in state.jacobian(u, p).blocks],
            tpl, op.free, op.bc_values, newton_iters=iters, pcg_iters=pcg)
    else:
        op._solve = op._build()
    return op
