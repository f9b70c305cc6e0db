"""Simulator: eager execution + total derivatives over a Model.

Parity with python_csdl_backend's Simulator (reference usage
run_poisson_opt.py:176-199: sim[name] get/set, sim.run(),
sim.compute_totals(), sim.check_totals()).  Total derivatives are plain
`jax.grad`/`jax.vjp` over the composed model — implicit solves contribute
their IFT custom_vjp rules.

Side-effect discipline: during `run()` state functions persist warm starts
and write recorders; under derivative tracing those side effects are
suppressed (pure mode) so no tracers leak.
"""

from __future__ import annotations

import contextlib

import numpy as np
import jax
import jax.numpy as jnp

from ..config import config
from .model import Model


class _PureMode:
    active = False


PURE_MODE = _PureMode()


@contextlib.contextmanager
def pure_mode():
    prev = PURE_MODE.active
    PURE_MODE.active = True
    try:
        yield
    finally:
        PURE_MODE.active = prev


class Simulator:
    """jit=True: totals/objective gradients are jitted end-to-end (requires
    every state op in jittable mode, e.g. FEA.solve_mode='jit_dense')."""

    def __init__(self, model: Model, analytics: bool = False,
                 jit: bool = False):
        self.model = model
        self.values: dict[str, jnp.ndarray] = dict(model.defaults)
        self.outputs: dict[str, jnp.ndarray] = {}
        self.analytics = analytics
        self.jit = jit
        self._jit_cache: dict = {}
        self._values_version = 0

    # -- value access (sim['f'] parity) -----------------------------------------
    def __getitem__(self, name):
        if name in self.outputs:
            return np.asarray(self.outputs[name])
        return np.asarray(self.values[name])

    def __setitem__(self, name, val):
        self.values[name] = jnp.asarray(val, config.jdtype)
        self._values_version += 1

    # -- execution -----------------------------------------------------------------
    def run(self):
        self.outputs = self.model.evaluate(self.values)
        if self.analytics:
            print(self._graph_summary())
        return self.outputs

    # -- graph introspection ---------------------------------------------------
    def _graph_summary(self) -> str:
        m = self.model
        lines = [f"model graph: {len(m.operations)} operations, "
                 f"{len(m.design_variables)} design variable(s), "
                 f"{len(m.constraints)} constraint(s), "
                 f"objective={m.objective['name'] if m.objective else None}"]
        for op in m.operations:
            outs = []
            for o in op.outputs:
                v = self.outputs.get(o)
                shp = tuple(np.shape(v)) if v is not None else "?"
                outs.append(f"{o}{shp}")
            lines.append(f"  {op.name}: ({', '.join(op.inputs)}) -> "
                         f"{', '.join(outs)}")
        return "\n".join(lines)

    def visualize_implementation(self, path: str | None = None) -> str:
        """Text rendering of the op DAG (reference
        sim.visualize_implementation N2-diagram toggle,
        run_poisson_opt.py:187-188; Simulator(analytics=True) prints the
        same summary after each run).  Returns the summary; optionally
        writes it to `path`."""
        if not self.outputs:
            self.run()
        s = self._graph_summary()
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        print(s)
        return s

    def _restricted_eval(self, wrt_names):
        """One JITTED evaluator reused across every FD perturbation.

        An eager model.evaluate per FD component re-traces the implicit
        solves' control-flow primitives each call (eager lax.scan/
        fori_loop bodies are re-traced per dispatch, so jax's in-memory
        executable cache never hits).  Beyond being 5-10x slower, with a
        persistent compilation cache enabled each re-dispatch became an
        XLA:CPU `deserialize_executable` — and XLA:CPU AOT reload is
        unreliable on mismatched-feature hosts (cpu_aot_loader warns of
        SIGILL-class failures; the round-4 suite segfault was the ~45th
        reload inside one check_totals).  Jitting once per (wrt set,
        values version) removes the re-dispatch entirely.  All state is
        passed as arguments (no large closed-over constants)."""
        def f(wrt_vals: dict, all_vals: dict):
            vals = dict(all_vals)
            vals.update(wrt_vals)
            with pure_mode():
                return self.model.evaluate(vals)

        key = ("_restricted_eval", tuple(sorted(wrt_names)),
               self._values_version)
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(f)
        jf = self._jit_cache[key]
        state = {"jit_ok": None}  # None = untried; models whose solves
        # use Python convergence checks (eager error-controlled Newton)
        # cannot trace — those fall back to the eager evaluator

        def call(wrt_vals: dict):
            if state["jit_ok"] is False:
                return f(wrt_vals, self.values)
            try:
                out = jf(wrt_vals, self.values)
                state["jit_ok"] = True
                return out
            except jax.errors.JAXTypeError:
                state["jit_ok"] = False
                return f(wrt_vals, self.values)

        return call

    def compute_totals(self, of, wrt):
        """d(of)/d(wrt) — scalar `of` via reverse mode.

        Returns dict {(of, wrt): array}.
        """
        of_list = [of] if isinstance(of, str) else list(of)
        wrt_list = [wrt] if isinstance(wrt, str) else list(wrt)
        f = self._restricted_eval(wrt_list)
        totals = {}
        for o in of_list:
            def scalar_out(wv, o=o):
                return jnp.sum(f(wv)[o])

            g = jax.grad(scalar_out)
            if self.jit:
                key = ("g", o, tuple(wrt_list), self._values_version)
                if key not in self._jit_cache:
                    self._jit_cache[key] = jax.jit(g)
                g = self._jit_cache[key]
            grads = g({w: self.values[w] for w in wrt_list})
            for w in wrt_list:
                totals[(o, w)] = grads[w]
        return totals

    def objective_gradient(self, of, wrt_list):
        """(value dict, grad dict) in one reverse pass."""
        f = self._restricted_eval(wrt_list)

        def scalar_out(wv):
            out = f(wv)
            return jnp.sum(out[of]), out

        vg = jax.value_and_grad(scalar_out, has_aux=True)
        if self.jit:
            key = ("vg", of, tuple(wrt_list), self._values_version)
            if key not in self._jit_cache:
                self._jit_cache.clear()
                self._jit_cache[key] = jax.jit(vg)
            vg = self._jit_cache[key]
        (val, out), grads = vg({w: self.values[w] for w in wrt_list})
        return val, grads, out

    def check_totals(self, of=None, wrt=None, step=1e-6, compact_print=True):
        """FD-vs-adjoint verification (reference sim.check_totals parity,
        used for gradient validation per SURVEY.md §4.3)."""
        of = of or self.model.objective["name"]
        wrt_list = ([wrt] if isinstance(wrt, str) else
                    wrt or list(self.model.design_variables.keys()))
        totals = self.compute_totals(of, wrt_list)
        report = {}
        f = self._restricted_eval(wrt_list)
        base_vals = {w: self.values[w] for w in wrt_list}
        base = float(jnp.sum(f(base_vals)[of]))
        for w in wrt_list:
            an = np.asarray(totals[(of, w)])
            fd = np.zeros_like(an)
            x0 = np.asarray(base_vals[w])
            for i in range(x0.size):
                xp = x0.copy()
                xp.flat[i] += step
                vals = dict(base_vals)
                vals[w] = jnp.asarray(xp)
                fd.flat[i] = (float(jnp.sum(f(vals)[of])) - base) / step
            denom = max(np.linalg.norm(an), 1e-300)
            rel = np.linalg.norm(an - fd) / denom
            report[(of, w)] = dict(analytic=an, fd=fd, rel_error=rel)
            if compact_print:
                print(f"check_totals d({of})/d({w}): rel FD error = {rel:.3e}")
        return report

    def dump_gradient_fields(self, of, wrt, space, path, step=1e-6):
        """Write analytic vs FD vs pointwise-error gradient FIELDS to XDMF
        for visual verification (reference parity:
        run_aeroelasticity_static_w_feedback.py:399-428 writes
        derivative_function / derivative_function_fd / derivative_error
        over the shell mesh).

        `wrt` must be a dof-vector design variable on `space` (one FD
        component per dof — same cost as check_totals).  Returns the
        check_totals report entry for (of, wrt).
        """
        from ..fea.space import Function
        from ..io.xdmf import XDMFWriter

        rep = self.check_totals(of, [wrt], step=step,
                                compact_print=False)[(of, wrt)]
        an, fd = rep["analytic"].ravel(), rep["fd"].ravel()
        if an.size != space.n_dofs:
            raise ValueError(
                f"gradient d({of})/d({wrt}) has {an.size} entries, but "
                f"space has {space.n_dofs} dofs — pass the design "
                f"variable's own FunctionSpace")
        with XDMFWriter(path, space.mesh) as w:
            for name, arr in ((f"d{of}_d{wrt}_analytic", an),
                              (f"d{of}_d{wrt}_fd", fd),
                              (f"d{of}_d{wrt}_error", an - fd)):
                w.write_function(Function(space, name, arr))
        return rep
