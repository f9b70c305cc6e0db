"""Block-tridiagonal operator + block-Thomas direct solver (the
scalable MUMPS replacement, SURVEY.md N5)."""

import numpy as np
import pytest
import jax.numpy as jnp

from femo_tpu.fea import (
    FunctionSpace, Function, FormDef, dx, grad, dot, inner, sym, tr,
    Identity, assemble_matrix, create_unit_square_mesh, DirichletBC,
    bc_arrays,
)
from femo_tpu.ops.block_tridiag import (
    BlockTridiagonalMatrix, BlockTridiagFactorization,
)


@pytest.fixture(scope="module")
def poisson_system():
    mesh = create_unit_square_mesh(16)
    V = FunctionSpace(mesh, ("CG", 1))
    u = Function(V, "u")
    form = FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)) + w.u * w.v)],
                   coeffs=[u], test=V)
    A = assemble_matrix(form, "u")
    bc = DirichletBC(V, 0.0, where=lambda x: np.isclose(x[0], 0))
    free, _ = bc_arrays([bc], V.n_dofs)
    return A, free, V


def test_matvec_matches(poisson_system):
    A, free, V = poisson_system
    bt = BlockTridiagonalMatrix.from_element_matrix(A)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=V.n_dofs))
    np.testing.assert_allclose(
        np.asarray(bt.matvec(x)), np.asarray(A.matvec(x)), atol=1e-11)


def test_block_thomas_solve(poisson_system):
    A, free, V = poisson_system
    fac = BlockTridiagFactorization(A, free)
    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.normal(size=V.n_dofs))
    x = fac.solve(b)
    # residual of the constrained system
    xf = jnp.where(free, x, 0.0)
    r = jnp.where(free, A.matvec(xf), x) - b
    assert float(jnp.linalg.norm(r)) < 1e-9 * float(jnp.linalg.norm(b))


def test_block_thomas_transpose_solve(poisson_system):
    A, free, V = poisson_system
    fac = BlockTridiagFactorization(A, free)
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.normal(size=V.n_dofs))
    x = fac.solve_t(b)
    xf = jnp.where(free, x, 0.0)
    r = jnp.where(free, A.rmatvec(xf), x) - b
    assert float(jnp.linalg.norm(r)) < 1e-9 * float(jnp.linalg.norm(b))


def test_vector_field_elasticity_solve():
    """Nonsymmetric-ish blocked dofs (vector space) round trip."""
    mesh = create_unit_square_mesh(10)
    V = FunctionSpace(mesh, ("CG", 1), ncomp=2)
    u = Function(V, "u")

    def elast(w, g):
        eu, ev = sym(grad(w.u)), sym(grad(w.v))
        return inner(2 * eu + 0.5 * tr(eu) * Identity(2), ev) \
            + dot(w.u, w.v)

    A = assemble_matrix(
        FormDef([dx(elast)], coeffs=[u], test=V), "u")
    bc = DirichletBC(V, 0.0, where=lambda x: np.isclose(x[1], 0))
    free, _ = bc_arrays([bc], V.n_dofs)
    fac = BlockTridiagFactorization(A, free)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.normal(size=V.n_dofs))
    x = fac.solve(b)
    xf = jnp.where(free, x, 0.0)
    r = jnp.where(free, A.matvec(xf), x) - b
    assert float(jnp.linalg.norm(r)) < 1e-9 * float(jnp.linalg.norm(b))


def test_linear_solver_block_thomas_and_pcg(poisson_system):
    """LinearSolver dispatch: 'block_thomas' direct and 'cg_bt'
    (block-Thomas-preconditioned CG) both solve the constrained system."""
    from femo_tpu.solvers.linear import LinearSolver

    A, free, V = poisson_system
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.normal(size=V.n_dofs))
    for method in ("block_thomas", "cg_bt"):
        fac = LinearSolver(method=method, rtol=1e-10).factor(A, free)
        x = fac.solve(b)
        xf = jnp.where(free, x, 0.0)
        r = jnp.where(free, A.matvec(xf), x) - b
        rel = float(jnp.linalg.norm(r) / jnp.linalg.norm(b))
        assert rel < 1e-8, (method, rel)
        xt = fac.solve_t(b)
        xtf = jnp.where(free, xt, 0.0)
        rt = jnp.where(free, A.rmatvec(xtf), xt) - b
        assert float(jnp.linalg.norm(rt) / jnp.linalg.norm(b)) < 1e-8


def test_template_analyze_factorize_split(poisson_system):
    """Symbolic-once / numeric-refill template matches direct construction
    and is jittable end to end."""
    import jax

    from femo_tpu.ops.block_tridiag import BlockTridiagTemplate

    A, free, V = poisson_system
    tpl = BlockTridiagTemplate(A, free=free)
    blocks = [(b.A, b.rows, b.cols) for b in A.blocks]

    @jax.jit
    def solve(blocks, b):
        fac = tpl.factor(blocks)
        return fac.solve(b)

    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.normal(size=V.n_dofs))
    x = solve(blocks, b)
    xf = jnp.where(free, x, 0.0)
    r = jnp.where(free, A.matvec(xf), x) - b
    assert float(jnp.linalg.norm(r)) < 1e-9 * float(jnp.linalg.norm(b))
    # refill with scaled values solves the scaled system
    blocks2 = [(2.0 * b_.A, b_.rows, b_.cols) for b_ in A.blocks]
    x2 = solve(blocks2, b)
    np.testing.assert_allclose(np.asarray(x2[np.asarray(free)]),
                               np.asarray(x[np.asarray(free)]) / 2.0,
                               atol=1e-10)


def test_chebyshev_preconditioner(poisson_system):
    """Chebyshev polynomial preconditioning cuts CG outer iterations
    (SURVEY.md hard-part #1 family: Chebyshev/Jacobi smoothers)."""
    from femo_tpu.solvers.krylov import cg
    from femo_tpu.solvers.linear import LinearSolver, constrained_matvec

    A, free, V = poisson_system
    rng = np.random.default_rng(6)
    b = jnp.asarray(rng.normal(size=V.n_dofs))
    mv = constrained_matvec(A.matvec, free)
    base = cg(mv, b, rtol=1e-8)
    fac = LinearSolver(method="cg", pc="chebyshev:8",
                       rtol=1e-8).factor(A, free)
    x = fac.solve(b)
    r = b - mv(x)
    assert float(jnp.linalg.norm(r)) < 1e-6 * float(jnp.linalg.norm(b))
    assert int(fac.last_result.iters) < int(base.iters) / 3



def test_cyclic_reduction_matches_thomas_and_dense():
    """Block cyclic reduction (factor_cr): the batched log2(nb)-level
    elimination must reproduce block Thomas / dense LU to machine
    precision, including transpose solves, across odd / non-power-of-two
    block counts."""
    from femo_tpu.fea import create_rectangle_mesh

    for ny, expect_nb_odd in ((100, None), (230, None), (320, None)):
        mesh = create_rectangle_mesh(6, ny, 0, 0, 1.0, 30.0,
                                     cell_type="triangle")
        V = FunctionSpace(mesh, ("CG", 1))
        u = Function(V, "u")
        A = assemble_matrix(
            FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v))
                        + w.u * w.v)], coeffs=[u], test=V), "u")
        bt = BlockTridiagonalMatrix.from_element_matrix(A)
        rng = np.random.default_rng(ny)
        b = jnp.asarray(rng.standard_normal(V.n_dofs))
        x_th = np.asarray(bt.factor().solve(b))
        x_cr = np.asarray(bt.factor_cr().solve(b))
        np.testing.assert_allclose(x_cr, x_th, rtol=1e-11, atol=1e-13)
        xt_th = np.asarray(bt.factor_t().solve(b))
        xt_cr = np.asarray(bt.factor_t_cr().solve(b))
        np.testing.assert_allclose(xt_cr, xt_th, rtol=1e-11, atol=1e-13)


def test_bt_jit_cr_gradient_parity():
    """implicit_solve_bt_jit(factor_method='cr') matches the Thomas path:
    value and IFT gradient to f64 roundoff on a nonlinear solve."""
    import jax
    from femo_tpu.config import config
    from femo_tpu.fea import (FunctionSpace as FS, Function as Fn, FormDef,
                              dx, grad, dot, create_unit_square_mesh)
    from femo_tpu.fea.assemble import compile_form
    from femo_tpu.fea.bc import DirichletBC, bc_arrays
    from femo_tpu.graph.implicit import implicit_solve_bt_jit
    from femo_tpu.ops.block_tridiag import BlockTridiagTemplate

    mesh = create_unit_square_mesh(14)
    V = FS(mesh, ("CG", 1))
    W = FS(mesh, ("DG", 0))
    u, f = Fn(V, "u"), Fn(W, "f")
    res = FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v))
                      + w.u**3 * w.v - w.f * w.v)],
                  coeffs=[u, f], test=V)
    cf = compile_form(res)
    free, bv = bc_arrays(
        [DirichletBC(V, 0.0, where=lambda x: np.isclose(x[0], 0))],
        V.n_dofs)

    def blocks(uarr, p):
        raw = cf.matrix({"u": uarr, "f": p["f"]}, "u")
        return [(b.A, b.rows, b.cols) for b in raw.blocks]

    f0 = jnp.full(W.n_dofs, 8.0, config.jdtype)
    tpl = BlockTridiagTemplate(
        cf.matrix({"u": u.array, "f": f.array}, "u"), free=np.asarray(free))

    def make(method):
        solve = implicit_solve_bt_jit(
            lambda uarr, p: cf.vector({"u": uarr, "f": p["f"]}),
            blocks, tpl, free, bv, newton_iters=6, load_steps=2,
            pcg_iters=4, factor_method=method)

        def obj(farr):
            x = solve({"f": farr}, jnp.zeros(V.n_dofs, config.jdtype))
            return jnp.sum(x**2)

        return jax.jit(jax.value_and_grad(obj))

    va, ga = make("thomas")(f0)
    vb, gb = make("cr")(f0)
    np.testing.assert_allclose(float(vb), float(va), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(ga), rtol=1e-9)


def test_bt_jit_refactor_every_matches():
    """Shamanskii factorization reuse (refactor_every=k): factoring only
    on every k-th Newton iteration and keeping the stale factor as the
    PCG preconditioner must converge to the SAME fixed point — the
    residual and polish always use the fresh operator — so value and IFT
    gradient match the every-iteration-factor path once Newton is
    converged.  This is the motor latency lever (the per-iteration factor
    scan is the dominant sequential depth at B=128)."""
    import jax
    from femo_tpu.config import config
    from femo_tpu.fea import (FunctionSpace as FS, Function as Fn, FormDef,
                              dx, grad, dot, create_unit_square_mesh)
    from femo_tpu.fea.assemble import compile_form
    from femo_tpu.fea.bc import DirichletBC, bc_arrays
    from femo_tpu.graph.implicit import implicit_solve_bt_jit
    from femo_tpu.ops.block_tridiag import BlockTridiagTemplate
    import pytest

    mesh = create_unit_square_mesh(14)
    V = FS(mesh, ("CG", 1))
    W = FS(mesh, ("DG", 0))
    u, f = Fn(V, "u"), Fn(W, "f")
    res = FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v))
                      + w.u**3 * w.v - w.f * w.v)],
                  coeffs=[u, f], test=V)
    cf = compile_form(res)
    free, bv = bc_arrays(
        [DirichletBC(V, 0.0, where=lambda x: np.isclose(x[0], 0))],
        V.n_dofs)

    def blocks(uarr, p):
        raw = cf.matrix({"u": uarr, "f": p["f"]}, "u")
        return [(b.A, b.rows, b.cols) for b in raw.blocks]

    f0 = jnp.full(W.n_dofs, 8.0, config.jdtype)
    tpl = BlockTridiagTemplate(
        cf.matrix({"u": u.array, "f": f.array}, "u"), free=np.asarray(free))

    def make(refactor_every):
        solve = implicit_solve_bt_jit(
            lambda uarr, p: cf.vector({"u": uarr, "f": p["f"]}),
            blocks, tpl, free, bv, newton_iters=6, load_steps=2,
            pcg_iters=4, refactor_every=refactor_every)

        def obj(farr):
            x = solve({"f": farr}, jnp.zeros(V.n_dofs, config.jdtype))
            return jnp.sum(x**2)

        return jax.jit(jax.value_and_grad(obj))

    va, ga = make(1)(f0)
    vb, gb = make(3)(f0)
    np.testing.assert_allclose(float(vb), float(va), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(ga), rtol=1e-8)

    # guard rails: reuse without a polish, or with CR, is rejected
    with pytest.raises(ValueError):
        implicit_solve_bt_jit(
            lambda uarr, p: cf.vector({"u": uarr, "f": p["f"]}),
            blocks, tpl, free, bv, pcg_iters=0, refactor_every=2)
    with pytest.raises(ValueError):
        implicit_solve_bt_jit(
            lambda uarr, p: cf.vector({"u": uarr, "f": p["f"]}),
            blocks, tpl, free, bv, pcg_iters=4, factor_method="cr",
            refactor_every=2)


def test_factor_spd_matches_thomas():
    """Cholesky-storage block Thomas (factor_spd): solves match the
    inverse-storage factor and dense LU to machine precision on an SPD
    system, including with f32 factor storage (mixed-precision envelope)."""
    from femo_tpu.fea import create_rectangle_mesh

    mesh = create_rectangle_mesh(6, 40, 0, 0, 1.0, 8.0,
                                 cell_type="triangle")
    V = FunctionSpace(mesh, ("CG", 1))
    u = Function(V, "u")
    A = assemble_matrix(
        FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)) + w.u * w.v)],
                coeffs=[u], test=V), "u")
    bt = BlockTridiagonalMatrix.from_element_matrix(A)
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.standard_normal(V.n_dofs))
    x_ref = np.asarray(bt.factor().solve(b))
    x_spd = np.asarray(bt.factor_spd().solve(b))
    np.testing.assert_allclose(x_spd, x_ref, rtol=1e-11, atol=1e-13)
    x_32 = np.asarray(bt.factor_spd(store_dtype="float32").solve(b))
    rel = np.linalg.norm(x_32 - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-4, rel


def test_factor_chunked_matches_factor():
    """factor_chunked (host-looped chunk programs) is bit-identical to the
    single-scan factor: same Schur recursion, same order — only the
    program boundaries differ.  Covers uneven chunk splits and the f32
    factor store."""
    from femo_tpu.fea import create_rectangle_mesh

    mesh = create_rectangle_mesh(6, 40, 0, 0, 1.0, 8.0,
                                 cell_type="triangle")
    V = FunctionSpace(mesh, ("CG", 1))
    u = Function(V, "u")
    A = assemble_matrix(
        FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)) + w.u * w.v)],
                coeffs=[u], test=V), "u")
    bt = BlockTridiagonalMatrix.from_element_matrix(A)
    assert bt.nb >= 3
    f_ref = bt.factor(spd=True)
    f_ch = bt.factor_chunked(spd=True, chunk=max(1, bt.nb // 3 + 1))
    np.testing.assert_array_equal(np.asarray(f_ch.Sinv),
                                  np.asarray(f_ref.Sinv))
    np.testing.assert_array_equal(np.asarray(f_ch.C), np.asarray(f_ref.C))
    f32_ref = bt.factor("float32", spd=True)
    f32_ch = bt.factor_chunked("float32", spd=True, chunk=2)
    np.testing.assert_array_equal(np.asarray(f32_ch.Sinv),
                                  np.asarray(f32_ref.Sinv))
    rng = np.random.default_rng(7)
    b = jnp.asarray(rng.standard_normal(V.n_dofs))
    np.testing.assert_array_equal(np.asarray(f_ch.solve(b)),
                                  np.asarray(f_ref.solve(b)))


def test_factor_chunked_reuses_compiled_programs():
    """Regression: the chunk program is a module-level cached jit — a
    second factor_chunked call with the same shapes must NOT re-trace
    (a per-call wrapper cost ~90 s of recompilation per factorization at
    the 107k-cell FSI anchor)."""
    import numpy as np
    import jax.numpy as jnp
    from femo_tpu.ops.block_tridiag import (
        BlockTridiagonalMatrix, _factor_chunk_program)

    nb, B = 7, 4
    rng = np.random.default_rng(3)
    D = np.tile(np.eye(B) * 5.0, (nb, 1, 1)) \
        + 0.1 * rng.standard_normal((nb, B, B))
    D = 0.5 * (D + np.swapaxes(D, 1, 2))
    L = 0.1 * rng.standard_normal((nb, B, B))
    L[0] = 0
    U = 0.1 * rng.standard_normal((nb, B, B))
    U[-1] = 0
    n = nb * B
    bt = BlockTridiagonalMatrix(jnp.asarray(D), jnp.asarray(L),
                                jnp.asarray(U), np.arange(n), n)
    bt.factor_chunked(spd=False, chunk=3)
    size_after_first = _factor_chunk_program._cache_size()
    assert size_after_first > 0
    bt.factor_chunked(spd=False, chunk=3)
    assert _factor_chunk_program._cache_size() == size_after_first


def test_factor_guard_rescues_singular_f32_block():
    """Per-block singularity rescue (guard=True): the f32 Schur recursion
    can hit a singular-to-f32 block (measured at the 107k-cell FSI anchor:
    one bad block out of 7246 NaN'd the whole factor).  The guard must
    (a) leave healthy factorizations bit-identical (untaken lax.cond
    branch), (b) produce an all-finite factor when a block IS singular,
    fixing ONLY that block via a local diagonal shift."""
    rng = np.random.default_rng(3)
    nb, B = 6, 4
    n = nb * B

    def make(Dbad):
        D = np.stack([np.eye(B) + 0.05 * rng.standard_normal((B, B))
                      for _ in range(nb)]).astype(np.float32)
        D = (D + np.swapaxes(D, 1, 2)) / 2 + 2 * np.eye(B, dtype=np.float32)
        L = (0.01 * rng.standard_normal((nb, B, B))).astype(np.float32)
        U = np.swapaxes(L, 1, 2).copy()
        if Dbad:
            # exactly singular diagonal block, decoupled from neighbours
            # so its Schur complement S_3 = D_3 is singular too
            v = np.ones((B, 1), np.float32)
            D[3] = (v @ v.T)
            L[3] = 0.0
            U[3] = 0.0
            L[4] = 0.0
            U[2] = 0.0
        return BlockTridiagonalMatrix(
            jnp.asarray(D), jnp.asarray(L), jnp.asarray(U),
            np.arange(n), n)

    # (a) healthy: guard is a no-op, bit-identical factor
    bt = make(Dbad=False)
    f0 = bt.factor(spd=False)
    f1 = bt.factor(spd=False, guard=True)
    np.testing.assert_array_equal(np.asarray(f0.Sinv), np.asarray(f1.Sinv))
    np.testing.assert_array_equal(np.asarray(f0.C), np.asarray(f1.C))

    # (b) singular block: unguarded factor is non-finite, guarded is
    # finite everywhere and untouched away from the bad block
    btb = make(Dbad=True)
    fu = btb.factor(spd=False)
    assert not np.all(np.isfinite(np.asarray(fu.Sinv)))
    fg = btb.factor(spd=False, guard=True)
    Sg = np.asarray(fg.Sinv)
    assert np.all(np.isfinite(Sg))
    assert np.all(np.isfinite(np.asarray(fg.C)))
    # blocks before the bad one identical to the unguarded recursion
    np.testing.assert_array_equal(Sg[:3], np.asarray(fu.Sinv)[:3])
    # chunked path takes the same guard
    fc = btb.factor_chunked(spd=False, chunk=2, guard=True)
    np.testing.assert_array_equal(np.asarray(fc.Sinv), Sg)


def test_factor_mixed_ns_matches_f64():
    """Mixed-precision block inverses (mixed_ns>0): f32 Cholesky-inverse
    seed + f64 Newton-Schulz refinements, Schur chain in f64 (f64 work
    as matmuls only).  The
    mixed factor must (a) match the exact-f64 factor's direct solve to
    near-f64 accuracy on ill-conditioned SPD blocks inside the f32-seed
    range, and (b) rescue a block whose f32 seed cannot converge
    (cond >> 1/eps_f32) via the residual-checked exact-f64 fallback."""
    rng = np.random.default_rng(7)
    nb, B = 8, 16
    n = nb * B

    def spd_block(cond):
        Q, _ = np.linalg.qr(rng.standard_normal((B, B)))
        vals = np.logspace(0, -np.log10(cond), B)
        return (Q * vals) @ Q.T

    def system(bad_block=None):
        D = np.stack([spd_block(1e4) for _ in range(nb)])
        if bad_block is not None:
            D[bad_block] = spd_block(1e10)
        L = 1e-3 * rng.standard_normal((nb, B, B))
        L[0] = 0.0
        U = np.swapaxes(L, 1, 2).copy()
        U = np.roll(U, -1, axis=0)
        U[-1] = 0.0
        return BlockTridiagonalMatrix(
            jnp.asarray(D, jnp.float64), jnp.asarray(L, jnp.float64),
            jnp.asarray(U, jnp.float64), np.arange(n), n)

    x_true = rng.standard_normal(n)

    # (a) all blocks inside the f32-seed range
    bt = system()
    b = bt.matvec(jnp.asarray(x_true))
    x64 = np.asarray(bt.factor(spd=True).solve(b))
    xm = np.asarray(bt.factor(spd=True, mixed_ns=3).solve(b))
    assert np.linalg.norm(xm - x_true) / np.linalg.norm(x_true) < 1e-8
    assert np.linalg.norm(xm - x64) / np.linalg.norm(x64) < 1e-8

    # chunked path: identical recursion
    xc = np.asarray(bt.factor_chunked(spd=True, chunk=3,
                                      mixed_ns=3).solve(b))
    np.testing.assert_allclose(xc, xm, rtol=0, atol=1e-12)

    # (b) one hopeless-for-f32 block -> fallback keeps the solve accurate
    btb = system(bad_block=4)
    bb = btb.matvec(jnp.asarray(x_true))
    xmb = np.asarray(btb.factor(spd=True, mixed_ns=2).solve(bb))
    x64b = np.asarray(btb.factor(spd=True).solve(bb))
    assert np.all(np.isfinite(xmb))
    assert (np.linalg.norm(xmb - x64b) / np.linalg.norm(x64b)) < 1e-6

    # (c) RAW-space blocks with huge diagonal dynamic range (~1e8, the
    # unequilibrated FEM regime: shell diag entries span bending vs
    # membrane scales): the per-block diagonal scaling inside
    # _inv_block_mixed must make the f32 seed usable WITHOUT any outer
    # operator equilibration — the production mixed path factors raw
    def raw_system():
        mag = 10.0 ** rng.uniform(-4, 4, size=(nb, B))  # diag range 1e8
        D = np.stack([spd_block(1e4) for _ in range(nb)])
        D = mag[:, :, None] * D * mag[:, None, :]
        L = 1e-3 * rng.standard_normal((nb, B, B))
        L = mag[:, :, None] * L * np.roll(mag, 1, axis=0)[:, None, :]
        L[0] = 0.0
        U = np.swapaxes(np.roll(L, -1, axis=0), 1, 2).copy()
        U[-1] = 0.0
        return BlockTridiagonalMatrix(
            jnp.asarray(D, jnp.float64), jnp.asarray(L, jnp.float64),
            jnp.asarray(U, jnp.float64), np.arange(n), n)

    btr = raw_system()
    br = btr.matvec(jnp.asarray(x_true))
    x64r = np.asarray(btr.factor(spd=True).solve(br))
    xmr = np.asarray(btr.factor(spd=True, mixed_ns=3,
                                mixed_tol=1e-7).solve(br))
    assert np.all(np.isfinite(xmr))
    assert (np.linalg.norm(xmr - x64r) / np.linalg.norm(x64r)) < 1e-8


def test_factor_cr_chunked_and_mixed_match_exact():
    """factor_cr_chunked (per-level donated programs — the anchor HBM
    fix: the fused whole-factor CR program compile-OOMs at nb=7246) must
    be bit-identical to factor_cr, and mixed-precision CR block inverses
    (f32 seed + f64 Newton-Schulz, batched per level) must match the
    exact-f64 CR solve to the NS-refinement floor."""
    from femo_tpu.fea import create_rectangle_mesh

    mesh = create_rectangle_mesh(6, 230, 0, 0, 1.0, 30.0,
                                 cell_type="triangle")
    V = FunctionSpace(mesh, ("CG", 1))
    u = Function(V, "u")
    A = assemble_matrix(
        FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v))
                    + w.u * w.v)], coeffs=[u], test=V), "u")
    bt = BlockTridiagonalMatrix.from_element_matrix(A)
    rng = np.random.default_rng(7)
    b = jnp.asarray(rng.standard_normal(V.n_dofs))

    x_ref = np.asarray(bt.factor_cr(spd=True).solve(b))
    # chunked = identical per-level algebra, just separate programs
    xc = np.asarray(bt.factor_cr_chunked(spd=True, tail=2).solve(b))
    np.testing.assert_allclose(xc, x_ref, rtol=0, atol=0)
    # mixed block inverses inside CR (plain + chunked + f32 level store)
    xm = np.asarray(bt.factor_cr(spd=True, mixed_ns=3).solve(b))
    assert np.linalg.norm(xm - x_ref) / np.linalg.norm(x_ref) < 1e-9
    # mixed chunked: same recursion, but the per-level programs fuse the
    # f32 seed + NS refinement differently than the eager trace — equal
    # to fp reassociation, not bitwise
    xmc = np.asarray(bt.factor_cr_chunked(spd=True, tail=2,
                                          mixed_ns=3).solve(b))
    assert np.linalg.norm(xmc - xm) / np.linalg.norm(xm) < 1e-12
    xs = np.asarray(bt.factor_cr_chunked(spd=True, tail=2, mixed_ns=3,
                                         store_dtype="float32").solve(b))
    assert np.linalg.norm(xs - x_ref) / np.linalg.norm(x_ref) < 1e-5


def test_pcg_tol_converges_to_tolerance():
    """pcg_tol (while_loop solve-to-tolerance, the reference's converged
    SNES/KSP semantics): the returned residual honors rtol, the answer
    matches the direct solve, and a LOW-PRECISION factor only changes
    the iteration count — never the converged answer (the admissibility
    property the coupled-FSI anchor needs)."""
    from femo_tpu.fea import create_rectangle_mesh
    from femo_tpu.ops.block_tridiag import pcg_tol

    mesh = create_rectangle_mesh(6, 100, 0, 0, 1.0, 30.0,
                                 cell_type="triangle")
    V = FunctionSpace(mesh, ("CG", 1))
    u = Function(V, "u")
    A = assemble_matrix(
        FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v))
                    + w.u * w.v)], coeffs=[u], test=V), "u")
    bt = BlockTridiagonalMatrix.from_element_matrix(A)
    rng = np.random.default_rng(3)
    x_true = rng.standard_normal(V.n_dofs)
    b = bt.matvec(jnp.asarray(x_true))

    fac64 = bt.factor(spd=True)
    x, k, rr = pcg_tol(bt, fac64, b, rtol=1e-12, maxiter=50)
    assert float(rr) <= 1e-12
    assert np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(
        x_true) < 1e-10

    # degraded preconditioner: more iterations, same converged answer
    fac32 = bt.factor(spd=True, store_dtype="float32")
    x2, k2, rr2 = pcg_tol(bt, fac32, b, rtol=1e-12, maxiter=200)
    assert float(rr2) <= 1e-12
    assert int(k2) >= int(k)
    assert np.linalg.norm(np.asarray(x2) - x_true) / np.linalg.norm(
        x_true) < 1e-10

    # maxiter cap is respected
    _, k3, rr3 = pcg_tol(bt, fac32, b, rtol=1e-14, maxiter=2)
    assert int(k3) == 2
def test_bt_jit_freeze_operator_matches_at_convergence():
    """Classical Shamanskii (freeze_operator=True): fill AND factor only
    on refactor iterations, the PCG polish runs against the FROZEN
    operator — a quasi-Newton iteration with the same fixed point (the
    residual is always fresh).  At enough iterations the state converges
    to the same root, so value and IFT gradient match the every-iteration
    path; intermediate-iterate paths differ, so parity is asserted at
    convergence only (the motor uses the fixed-count band argument).
    Skipping reuse-iteration fills is the latency lever where the
    Jacobian fill dominates a step."""
    import jax
    from femo_tpu.config import config
    from femo_tpu.fea import (FunctionSpace as FS, Function as Fn, FormDef,
                              dx, grad, dot, create_unit_square_mesh)
    from femo_tpu.fea.assemble import compile_form
    from femo_tpu.fea.bc import DirichletBC, bc_arrays
    from femo_tpu.graph.implicit import implicit_solve_bt_jit
    from femo_tpu.ops.block_tridiag import BlockTridiagTemplate
    import pytest

    mesh = create_unit_square_mesh(12)
    V = FS(mesh, ("CG", 1))
    W = FS(mesh, ("DG", 0))
    u, f = Fn(V, "u"), Fn(W, "f")
    res = FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v))
                      + w.u**3 * w.v - w.f * w.v)],
                  coeffs=[u, f], test=V)
    cf = compile_form(res)
    free, bv = bc_arrays(
        [DirichletBC(V, 0.0, where=lambda x: np.isclose(x[0], 0))],
        V.n_dofs)

    def blocks(uarr, p):
        raw = cf.matrix({"u": uarr, "f": p["f"]}, "u")
        return [(b.A, b.rows, b.cols) for b in raw.blocks]

    f0 = jnp.full(W.n_dofs, 8.0, config.jdtype)
    tpl = BlockTridiagTemplate(
        cf.matrix({"u": u.array, "f": f.array}, "u"), free=np.asarray(free))

    def make(**kw):
        solve = implicit_solve_bt_jit(
            lambda uarr, p: cf.vector({"u": uarr, "f": p["f"]}),
            blocks, tpl, free, bv, newton_iters=8, load_steps=2,
            pcg_iters=4, **kw)

        def obj(farr):
            x = solve({"f": farr}, jnp.zeros(V.n_dofs, config.jdtype))
            return jnp.sum(x**2)

        return jax.jit(jax.value_and_grad(obj))

    va, ga = make(refactor_every=1)(f0)
    vb, gb = make(refactor_every=4, freeze_operator=True)(f0)
    # frozen J contracts linearly, not quadratically: at 8 iterations the
    # state agrees to ~2e-8 rel (measured 1.8e-8) and keeps shrinking
    # with more iterations — same fixed point, slower approach
    np.testing.assert_allclose(float(vb), float(va), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(ga), rtol=1e-6)

    # guard rail: freezing with refactor_every=1 is a no-op request
    with pytest.raises(ValueError):
        implicit_solve_bt_jit(
            lambda uarr, p: cf.vector({"u": uarr, "f": p["f"]}),
            blocks, tpl, free, bv, pcg_iters=4, refactor_every=1,
            freeze_operator=True)
