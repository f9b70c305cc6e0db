"""Implicit-function-theorem adjoint around PDE solves.

JAX replacement for the reference's CSDL ``CustomImplicitOperation``
(StateOperation, /root/reference/femo/csdl_opt/state_model.py:52-218): instead
of a class with evaluate_residuals / compute_derivatives /
apply_inverse_jacobian methods, the whole implicit-function theorem is a
`jax.custom_vjp` wrapper around the Newton solve:

    forward:  solve R(u, p) = 0  ->  u*
    backward: solve A_c^T psi = ubar,  pbar = -psi^T dR/dp   (one transpose
              solve + one VJP of the traced residual kernel)

Because the adjoint only sees the *converged* state, continuation/load
stepping in the forward solve (reference custom_solve patterns,
run_motor_opt.py:109-166) does not complicate gradients at all.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..config import config
from ..fea.assemble import CompiledForm, ElementMatrix, MatBlock
from ..fea.bc import apply_bc, constrain_residual
from ..solvers.linear import LinearSolver
from ..solvers.newton import newton_solve, newton_solve_jit


class ImplicitSolveOp:
    """A differentiable implicit solve u(p) defined by R(u, p) = 0.

    Parameters
    ----------
    cform : CompiledForm of the residual (test space = state space)
    state_name : coefficient name of the state u in the form
    arg_names : names of differentiable input coefficients p
    free, bc_values : strong-BC masking arrays
    linear_solver : LinearSolver used for Newton steps and the adjoint
    newton_opts : dict of newton_solve options
    custom_solve : optional callable (op, inputs: dict, u0) -> u replacing the
        default Newton loop (continuation hooks; reference
        fea_dolfinx.py:178-189). It may use op.newton(...) internally.
    """

    def __init__(self, cform: CompiledForm, state_name: str,
                 arg_names: list[str], free, bc_values,
                 linear_solver: LinearSolver | None = None,
                 newton_opts: dict | None = None,
                 custom_solve: Callable | None = None,
                 mode: str = "eager"):
        self.cform = cform
        self.state_name = state_name
        self.arg_names = list(arg_names)
        self.free = free
        self.bc_values = bc_values
        self.linear_solver = linear_solver or LinearSolver()
        self.newton_opts = dict(newton_opts or {})
        self.custom_solve = custom_solve
        self._fac_stash = {}  # id -> Factorization (host-side reuse)
        self._stash_ctr = 0
        self.n_dofs = cform.form.test.n_dofs
        self.mode = mode

        if mode == "jit_dense":
            # fully-jittable dense-LU path (fixed Newton count); lets the
            # whole optimization graph be jitted end-to-end
            iters = self.newton_opts.get("jit_newton_iters", 1)
            self._solve = implicit_solve_dense_jit(
                lambda u, p: self.residual(u, p),
                lambda u, p: self.jacobian(u, p).to_dense(),
                free, bc_values, newton_iters=iters)
        else:
            self._solve = self._build()

    # -- residual / jacobian helpers -------------------------------------------
    def _values(self, u, inputs: dict):
        vals = {self.state_name: u}
        # fixed coefficients (exact solutions, material fields) default to
        # their Function arrays; differentiable inputs come from `inputs`
        form = self.cform.form
        for name, fobj in {**form.coeffs, **form.globals}.items():
            if name == self.state_name:
                continue
            vals[name] = inputs.get(name, fobj.array)
        return vals

    def residual(self, u, inputs: dict):
        return self.cform.vector_jit()(self._values(u, inputs))

    def jacobian(self, u, inputs: dict) -> ElementMatrix:
        blocks = self.cform.matrix_blocks_jit(self.state_name)(
            self._values(u, inputs))
        return ElementMatrix(
            [MatBlock(*b) for b in blocks], self.n_dofs, self.n_dofs)

    def newton(self, inputs: dict, u0, **overrides):
        """Run the default Newton loop (usable from custom_solve hooks)."""
        opts = {**self.newton_opts, **overrides}
        opts.pop("jit_newton_iters", None)  # jit_dense-mode-only knob
        res_fn = lambda u: self.residual(u, inputs)
        jac_fn = lambda u: self.jacobian(u, inputs)
        return newton_solve(res_fn, jac_fn, u0, self.free, self.bc_values,
                            self.linear_solver, **opts)

    # -- custom_vjp construction ------------------------------------------------
    def _build(self):
        @jax.custom_vjp
        def solve(inputs: dict, u0):
            u, _, _ = self._forward(inputs, u0)
            return u

        def fwd(inputs, u0):
            u, fac, _ = self._forward(inputs, u0)
            key = self._stash_ctr
            self._stash_ctr += 1
            self._fac_stash[key] = fac
            return u, (u, inputs, key)

        def bwd(res, ubar):
            u, inputs, key = res
            fac = self._fac_stash.pop(key, None)
            if fac is None:
                fac = self.linear_solver.factor(
                    self.jacobian(u, inputs), self.free)
            psi = fac.solve_t(ubar)
            psi_f = jnp.where(self.free, psi, 0.0)
            # pbar = -psi^T dR/dp via VJP of the traced residual
            _, vjp_fn = jax.vjp(lambda p: self.residual(u, p), inputs)
            (pbar,) = vjp_fn(-psi_f)
            return pbar, jnp.zeros_like(u)

        solve.defvjp(fwd, bwd)
        return solve

    def _forward(self, inputs, u0):
        if self.custom_solve is not None:
            u = self.custom_solve(self, inputs, u0)
            fac = self.linear_solver.factor(
                self.jacobian(u, inputs), self.free)
            return u, fac, None
        u, fac, info = self.newton(inputs, u0)
        # warn only on a real miss, not a roundoff-floor near-miss of the
        # strict tolerance
        near = 100.0 * max(self.newton_opts.get("atol", 1e-13),
                           1e-12 * max(info.resnorm0, 1e-300))
        if not info.converged and info.resnorm > near:
            import warnings

            warnings.warn(
                f"Newton did not converge for state '{self.state_name}': "
                f"||R||={info.resnorm:.3e} after {info.iters} iters")
        return u, fac, info

    def __call__(self, inputs: dict, u0=None):
        if u0 is None:
            u0 = jnp.zeros(self.n_dofs, config.jdtype)
        u0 = jax.lax.stop_gradient(u0)
        return self._solve(inputs, u0)


def implicit_solve_dense_jit(residual_fn: Callable, jac_dense_fn: Callable,
                             free, bc_values, newton_iters: int = 1,
                             load_steps: int = 1,
                             scale_inputs: Callable | None = None,
                             factorization: str = "lu"):
    """Fully-jittable implicit solve with dense LU on the device.

    The MUMPS replacement for small/medium systems: the
    BC-constrained Jacobian is densified and LU-factored on device; the
    factorization from the last Newton step is saved in the custom_vjp
    residuals and reused for the adjoint transpose solve (reference caches
    the MUMPS ksp the same way, state_model.py:157-158).

    residual_fn(u, inputs) -> R;  jac_dense_fn(u, inputs) -> (n, n) dense.
    newton_iters is static (1 for linear problems).

    load_steps > 1 unrolls a continuation schedule inside the jit: at step k
    the inputs are `scale_inputs(inputs, (k+1)/load_steps)` (defaults to
    tree-scaling all inputs) — the jittable analogue of the reference's
    incremental custom solvers (run_motor_opt.py:109-166, 231-250). The
    adjoint uses only the final-step factorization, as the IFT requires.

    factorization: "lu" (stable, sequential triangular solves) or "inv"
    (explicit inverse; solves become dense matvecs, at ~1 ulp-of-cond
    extra error).
    """

    def _default_scale(inputs, s):
        return jax.tree.map(lambda x: x * s, inputs)

    scale = scale_inputs or _default_scale

    use_inv = factorization == "inv"

    def _factor(A):
        if use_inv:
            return jnp.linalg.inv(A)
        return jax.scipy.linalg.lu_factor(A)

    def _solve(fac, b, trans=0):
        if use_inv:
            return (fac.T if trans else fac) @ b
        return jax.scipy.linalg.lu_solve(fac, b, trans=trans)

    def _constrained_dense(A):
        fr = free.astype(A.dtype)
        A = A * fr[:, None] * fr[None, :]
        return A + jnp.diag(1.0 - fr)

    def _newton_once(u, p):
        Rc = constrain_residual(residual_fn(u, p), u, free, bc_values)
        A = _constrained_dense(jac_dense_fn(u, p))
        fac = _factor(A)
        du = _solve(fac, -Rc)
        return apply_bc(u + du, free, bc_values), fac

    def _forward(inputs, u0):
        u = apply_bc(u0, free, bc_values)
        total = load_steps * newton_iters

        # fori_loop keeps ONE traced copy of the assembly+LU body instead of
        # load_steps*newton_iters unrolled copies — the compile-time lever
        # that makes the jitted continuation practical
        def body(k, u):
            s = (k // newton_iters + 1).astype(u.dtype) / load_steps
            p = inputs if load_steps == 1 else scale(inputs, s)
            return _newton_once(u, p)[0]

        if total > 1:
            u = jax.lax.fori_loop(0, total - 1, body, u)
        # final iterate outside the loop so the factorization is available
        # for the adjoint (at full load s = 1)
        u, lu = _newton_once(u, inputs)
        return u, lu

    @jax.custom_vjp
    def solve(inputs, u0):
        u, _ = _forward(inputs, u0)
        return u

    def fwd(inputs, u0):
        u, lu = _forward(inputs, u0)
        return u, (u, inputs, lu)

    def bwd(res, ubar):
        u, inputs, lu = res
        psi = _solve(lu, ubar, trans=1)
        psi = jnp.where(free, psi, 0.0)
        _, vjp_p = jax.vjp(lambda p: residual_fn(u, p), inputs)
        (pbar,) = vjp_p(-psi)
        return pbar, jnp.zeros_like(u)

    solve.defvjp(fwd, bwd)
    return solve


def implicit_solve_jit(residual_fn: Callable, free, bc_values,
                       newton_opts: dict | None = None):
    """Fully-jittable implicit solve: matrix-free Newton-Krylov forward,
    CG/BiCGStab transpose adjoint. For the on-device benchmark path.

    residual_fn(u, inputs: dict) -> R. Returns solve(inputs, u0) -> u.
    """
    opts = dict(newton_opts or {})
    kr = opts.pop("krylov", "cg")
    krylov_rtol = opts.pop("krylov_rtol", 1e-10)
    krylov_maxiter = opts.pop("krylov_maxiter", 2000)

    from ..solvers.krylov import cg, bicgstab

    solver = cg if kr == "cg" else bicgstab

    @jax.custom_vjp
    def solve(inputs, u0):
        u, _, _ = newton_solve_jit(
            lambda u: residual_fn(u, inputs), u0, free, bc_values,
            krylov=kr, krylov_rtol=krylov_rtol,
            krylov_maxiter=krylov_maxiter, **opts)
        return u

    def fwd(inputs, u0):
        u = solve(inputs, u0)
        return u, (u, inputs)

    def bwd(res, ubar):
        u, inputs = res

        def Rc(uu):
            return constrain_residual(
                residual_fn(uu, inputs), uu, free, bc_values)

        def jtv(w):
            wf = jnp.where(free, w, 0.0)
            _, vjp_fn = jax.vjp(Rc, u)
            (Jtw,) = vjp_fn(wf)
            return jnp.where(free, Jtw, w)

        r = solver(jtv, ubar, rtol=krylov_rtol, maxiter=krylov_maxiter)
        psi = jnp.where(free, r.x, 0.0)
        _, vjp_p = jax.vjp(lambda p: residual_fn(u, p), inputs)
        (pbar,) = vjp_p(-psi)
        return pbar, jnp.zeros_like(u)

    solve.defvjp(fwd, bwd)
    return solve


def implicit_solve_bt_jit(residual_fn: Callable, jac_blocks_fn: Callable,
                          template, free, bc_values, newton_iters: int = 1,
                          load_steps: int = 1,
                          scale_inputs: Callable | None = None,
                          pcg_iters: int = 0,
                          factor_method: str = "thomas",
                          adjoint: str = "refactor",
                          jacobi_scale: bool = False,
                          factor_store_dtype=None,
                          spd: bool = False,
                          sweeps: str = "scan",
                          refactor_every: int = 1,
                          freeze_operator: bool = False):
    """Jittable implicit solve using the block-tridiagonal structured
    factorization (ops/block_tridiag.BlockTridiagTemplate).

    The scalable counterpart of implicit_solve_dense_jit: O(nb B^3) factor
    instead of O(n^3), with the MUMPS-style analyze-once / factorize-per-
    iteration split.  jac_blocks_fn(u, p) -> [(A_e, rows, cols), ...].

    factor_method: "thomas" (sequential lax.scan elimination) or "cr"
    (block cyclic reduction — batched log2(nb)-level elimination; the
    latency-optimal choice when nb is large, see
    BlockTridiagonalMatrix.factor_cr).

    sweeps: "scan" (lax.scan triangular sweeps) or "pallas" (single-
    program Pallas-Triton GPU kernels, ops/pallas_bt.py — f32 Thomas
    only).

    adjoint: "refactor" re-assembles and transpose-factors the Jacobian at
    the converged state (exact IFT for any residual).  "reuse_symmetric"
    stashes the forward factorization in the custom_vjp residuals and
    solves the adjoint with it directly — EXACT (not an approximation)
    when the residual is linear in u (Jacobian state-independent) and the
    operator is symmetric (an energy Hessian, A^T = A), e.g. the RM shell
    composite; skips one full assembly + fill + factorization per
    gradient.  Requires newton_iters = load_steps = 1 and Thomas.

    refactor_every: Shamanskii-style factorization reuse — factor only on
    Newton iterations where k % refactor_every == 0 and keep the carried
    factor as the preconditioner in between.  The residual and the PCG
    polish always use the FRESHLY assembled operator, so the Newton fixed
    point is unchanged; only the per-iteration contraction depends on
    preconditioner staleness (requires pcg_iters > 0 to bound the error
    of intermediate steps).  The per-iteration factor scan is the
    dominant sequential depth at small block counts (the motor's B=128
    latency floor), so e.g. refactor_every=newton_iters factors once per
    load step.  Thomas only.

    freeze_operator: classical Shamanskii — on non-refactor iterations
    skip the JACOBIAN FILL too and run the PCG polish against the frozen
    operator (a quasi-Newton step with J from the last refactor point).
    Only the residual is assembled fresh, so the iteration still targets
    the true root; the per-step contraction drops from quadratic to the
    frozen-J linear rate, which matters only through the fixed-iteration-
    count band.  It pays where the Jacobian fill, not the factor scan,
    dominates an iteration.  Requires refactor_every > 1.
    """

    def _default_scale(inputs, s):
        return jax.tree.map(lambda x: x * s, inputs)

    scale = scale_inputs or _default_scale
    cr = factor_method == "cr"
    pallas_sweeps = sweeps == "pallas"
    if pallas_sweeps and cr:
        raise ValueError("sweeps='pallas' requires factor_method='thomas'")
    if pallas_sweeps and pcg_iters == 0 and config.jdtype == jnp.float64:
        # the pallas sweeps run in f32 only; without the
        # f64-operator PCG polish the f32-truncated solve IS the final
        # answer — the documented-catastrophic regime for ill-conditioned
        # composites (eps_f32 * cond > 1, 70x-wrong tip deflections)
        raise ValueError(
            "sweeps='pallas' in f64 requires pcg_iters > 0: the f32 "
            "sweep result must be polished against the f64 operator")
    sym_reuse = adjoint == "reuse_symmetric"
    if sym_reuse:
        if load_steps * newton_iters != 1 or cr:
            raise ValueError(
                "adjoint='reuse_symmetric' requires a single linear solve "
                "(newton_iters=load_steps=1) and factor_method='thomas'")
    refactor_every = int(refactor_every)
    if refactor_every < 1:
        raise ValueError(f"refactor_every must be >= 1, got {refactor_every}")
    if freeze_operator and refactor_every == 1:
        raise ValueError("freeze_operator requires refactor_every > 1 "
                         "(with refactor_every=1 nothing is frozen)")
    if refactor_every > 1:
        if cr:
            raise ValueError("refactor_every > 1 requires "
                             "factor_method='thomas' (the reuse carry is "
                             "the Thomas factor's (L, Sinv, C) arrays)")
        if pcg_iters == 0:
            raise ValueError(
                "refactor_every > 1 requires pcg_iters > 0: intermediate "
                "Newton steps solve with a stale factor and need the "
                "fresh-operator PCG polish to bound their error")

    def _precond(mat, transpose=False):
        """Factor (optionally the symmetrically equilibrated operator) and
        return (preconditioner solve M, factor).  With jacobi_scale, M(b) =
        S F'^{-1} S b where F' factors A' = S A S — equilibration is what
        makes f32 factorization usable on mixed-field composites (see
        BlockTridiagonalMatrix.jacobi_scaled)."""
        if jacobi_scale:
            smat, s = mat.jacobi_scaled()
        else:
            smat, s = mat, None
        if transpose:
            fac = (smat.factor_t_cr() if cr
                   else smat.factor_t(factor_store_dtype, spd))
        else:
            fac = (smat.factor_cr() if cr
                   else smat.factor(factor_store_dtype, spd))
        fsolve = fac.solve_pallas if pallas_sweeps else fac.solve
        if s is None:
            return fsolve, fac
        M = lambda b: mat.scale_vector(
            fsolve(mat.scale_vector(b, s)), s)
        return M, fac

    def _newton_once(u, p):
        Rc = constrain_residual(residual_fn(u, p), u, free, bc_values)
        # "__bt_dest__" in the inputs dict passes the template's (large)
        # destination map as a traced argument instead of an embedded
        # constant (program size at reference scale)
        dest = p.get("__bt_dest__") if isinstance(p, dict) else None
        mat = template.matrix(jac_blocks_fn(u, p), dest=dest)
        M, _ = _precond(mat)
        du = M(-Rc)
        if pcg_iters > 0:
            # polish the rough f32 factor with fixed-count PCG
            from ..ops.block_tridiag import pcg_fixed

            du = pcg_fixed(mat, None, -Rc, pcg_iters, x0=du, M=M)
        return apply_bc(u + du, free, bc_values)

    def _forward(inputs, u0):
        u = apply_bc(u0, free, bc_values)
        total = load_steps * newton_iters
        if total == 0:
            return u
        if refactor_every == 1:
            def body(k, u):
                s = (k // newton_iters + 1).astype(u.dtype) / load_steps
                p = inputs if load_steps == 1 else scale(inputs, s)
                return _newton_once(u, p)

            return jax.lax.fori_loop(0, total, body, u)

        # Shamanskii reuse: the factor arrays ride the loop carry; the
        # lax.cond refactor branch (the length-nb factor scan) only
        # executes on iterations where k % refactor_every == 0
        from ..ops.block_tridiag import (
            BlockThomasFactor, BlockTridiagonalMatrix, pcg_fixed)

        nb, B = template.nb, template.B
        fdt = factor_store_dtype or config.jdtype

        if freeze_operator:
            # classical Shamanskii: fill AND factor only on refactor
            # iterations (the fill runs inside the cond branch, so reuse
            # iterations skip the whole Jacobian assembly); D/L/U ride
            # the carry and serve as both preconditioner and PCG operator
            def body(k, c):
                u, Df, Lf, Uf, Sinv, C, s = c
                sload = (k // newton_iters + 1).astype(u.dtype) / load_steps
                p = inputs if load_steps == 1 else scale(inputs, sload)
                Rc = constrain_residual(residual_fn(u, p), u, free,
                                        bc_values)
                dest = (p.get("__bt_dest__")
                        if isinstance(p, dict) else None)

                def refactor(_):
                    m = template.matrix(jac_blocks_fn(u, p), dest=dest)
                    if jacobi_scale:
                        sm, snew = m.jacobi_scaled()
                    else:
                        sm, snew = m, s
                    fac = sm.factor(factor_store_dtype, spd)
                    return (m.D, sm.L, m.U, fac.Sinv, fac.C, snew)

                Df, Lf, Uf, Sinv, C, s = jax.lax.cond(
                    k % refactor_every == 0, refactor,
                    lambda _: (Df, Lf, Uf, Sinv, C, s), None)
                mfroz = BlockTridiagonalMatrix(
                    Df, Lf, Uf, template.perm_full, template.n)
                fac = BlockThomasFactor(mfroz, Sinv, C)
                fsolve = fac.solve_pallas if pallas_sweeps else fac.solve
                if jacobi_scale:
                    M = lambda b: mfroz.scale_vector(
                        fsolve(mfroz.scale_vector(b, s)), s)
                else:
                    M = fsolve
                du = pcg_fixed(mfroz, None, -Rc, pcg_iters,
                               x0=M(-Rc), M=M)
                return (apply_bc(u + du, free, bc_values),
                        Df, Lf, Uf, Sinv, C, s)

            c0 = (u,
                  jnp.zeros((nb, B, B), config.jdtype),
                  jnp.zeros((nb, B, B), config.jdtype),
                  jnp.zeros((nb, B, B), config.jdtype),
                  jnp.zeros((nb, B, B), fdt),
                  jnp.zeros((nb, B, B), fdt),
                  jnp.ones((nb, B), config.jdtype))
            return jax.lax.fori_loop(0, total, body, c0)[0]

        def body(k, c):
            u, Lf, Sinv, C, s = c
            sload = (k // newton_iters + 1).astype(u.dtype) / load_steps
            p = inputs if load_steps == 1 else scale(inputs, sload)
            Rc = constrain_residual(residual_fn(u, p), u, free, bc_values)
            dest = p.get("__bt_dest__") if isinstance(p, dict) else None
            mat = template.matrix(jac_blocks_fn(u, p), dest=dest)

            def refactor(_):
                if jacobi_scale:
                    smat, snew = mat.jacobi_scaled()
                else:
                    smat, snew = mat, s
                fac = smat.factor(factor_store_dtype, spd)
                return smat.L, fac.Sinv, fac.C, snew

            Lf, Sinv, C, s = jax.lax.cond(
                k % refactor_every == 0, refactor,
                lambda _: (Lf, Sinv, C, s), None)
            mprox = BlockTridiagonalMatrix(mat.D, Lf, mat.U,
                                           template.perm_full, template.n)
            fac = BlockThomasFactor(mprox, Sinv, C)
            fsolve = fac.solve_pallas if pallas_sweeps else fac.solve
            if jacobi_scale:
                M = lambda b: mat.scale_vector(
                    fsolve(mat.scale_vector(b, s)), s)
            else:
                M = fsolve
            du = pcg_fixed(mat, None, -Rc, pcg_iters, x0=M(-Rc), M=M)
            return (apply_bc(u + du, free, bc_values), Lf, Sinv, C, s)

        c0 = (u,
              jnp.zeros((nb, B, B), config.jdtype),
              jnp.zeros((nb, B, B), fdt),
              jnp.zeros((nb, B, B), fdt),
              jnp.ones((nb, B), config.jdtype))
        return jax.lax.fori_loop(0, total, body, c0)[0]

    @jax.custom_vjp
    def solve(inputs, u0):
        return _forward(inputs, u0)

    def fwd(inputs, u0):
        if not sym_reuse:
            u = _forward(inputs, u0)
            return u, (u, inputs, None)
        # single linear solve with the factorization kept for the adjoint
        from ..ops.block_tridiag import pcg_fixed

        u = apply_bc(u0, free, bc_values)
        Rc = constrain_residual(residual_fn(u, inputs), u, free, bc_values)
        dest = (inputs.get("__bt_dest__")
                if isinstance(inputs, dict) else None)
        mat = template.matrix(jac_blocks_fn(u, inputs), dest=dest)
        if jacobi_scale:
            smat, s = mat.jacobi_scaled()
        else:
            smat, s = mat, jnp.ones((mat.nb, mat.B), mat.D.dtype)
        fac = smat.factor(factor_store_dtype, spd)
        M = lambda b: mat.scale_vector(
            fac.solve(mat.scale_vector(b, s)), s)
        du = M(-Rc)
        if pcg_iters > 0:
            du = pcg_fixed(mat, None, -Rc, pcg_iters, x0=du, M=M)
        u = apply_bc(u + du, free, bc_values)
        carry = (mat.D, mat.L, mat.U, smat.D, smat.L, smat.U,
                 fac.Sinv, fac.C, s)
        return u, (u, inputs, carry)

    def bwd(res, ubar):
        from ..ops.block_tridiag import (
            BlockThomasFactor, BlockTridiagonalMatrix, pcg_fixed)

        u, inputs, carry = res
        if carry is None:
            dest = (inputs.get("__bt_dest__")
                    if isinstance(inputs, dict) else None)
            mat = template.matrix(jac_blocks_fn(u, inputs), dest=dest)
            M_t, _ = _precond(mat, transpose=True)
        else:
            D, L, U, D2, L2, U2, Sinv, C, s = carry
            mat = BlockTridiagonalMatrix(D, L, U, template.perm_full,
                                         template.n)
            smat = BlockTridiagonalMatrix(D2, L2, U2, template.perm_full,
                                          template.n)
            # symmetric operator (and symmetric scaling): the forward
            # factorization IS the transpose factorization
            fac = BlockThomasFactor(smat, Sinv, C)
            M_t = lambda b: mat.scale_vector(
                fac.solve(mat.scale_vector(b, s)), s)
        psi = M_t(ubar)
        if pcg_iters > 0:
            psi = pcg_fixed(mat, None, ubar, pcg_iters, x0=psi,
                            transpose=True, M=M_t)
        psi = jnp.where(free, psi, 0.0)
        _, vjp_p = jax.vjp(lambda p: residual_fn(u, p), inputs)
        (pbar,) = vjp_p(-psi)
        return pbar, jnp.zeros_like(u)

    solve.defvjp(fwd, bwd)
    return solve
