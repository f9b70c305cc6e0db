"""Build-time eager-compile budget regression tests.

Every eager device op in a builder compiles a tiny XLA program (the motor
build once ran 628 eager compiles at refine=4 before host-side pattern
prototypes cut it to ~2).  These tests pin the builder compile counts so a
stray `jnp.zeros` / device `.astype` / device slice in a build path fails
CI instead of silently costing build time on the device.

The only legitimate build-time compile is the cached lumped-mass assembly
program (fea/project.py lumped_mass), used by the FSI coupling maps.
"""

import logging
from contextlib import contextmanager

import jax
import pytest


class _CompileCounter(logging.Handler):
    def __init__(self):
        super().__init__()
        self.events = []

    def emit(self, rec):
        m = rec.getMessage()
        if m.startswith("Finished XLA compilation"):
            self.events.append(m.split(" of ")[1].split(" in ")[0])


@contextmanager
def count_compiles():
    h = _CompileCounter()
    loggers = [logging.getLogger(n) for n in
               ("jax._src.dispatch", "jax._src.interpreters.pxla")]
    prev_levels = [lg.level for lg in loggers]
    prev_flag = jax.config.jax_log_compiles
    jax.config.update("jax_log_compiles", True)
    for lg in loggers:
        lg.addHandler(h)
        lg.setLevel(logging.DEBUG)
    try:
        yield h
    finally:
        jax.config.update("jax_log_compiles", prev_flag)
        for lg, lv in zip(loggers, prev_levels):
            lg.removeHandler(h)
            lg.setLevel(lv)


def test_compile_counter_is_alive():
    """Canary: the counter keys on JAX's 'Finished XLA compilation' log
    line — if a JAX upgrade rewords it, every budget test below would
    pass vacuously.  Compiling a guaranteed-fresh program (unique shape,
    so neither the in-memory nor the persistent cache can swallow it)
    must be observed."""
    import secrets

    import jax.numpy as jnp

    n = 8 + secrets.randbelow(4096)
    with count_compiles() as h:
        jnp.ones((n,)).sum().block_until_ready()
    assert h.events, (
        "compile counter observed nothing for a fresh eager program — "
        "JAX changed its compile-log format; update _CompileCounter")


def test_motor_build_compile_budget():
    from femo_tpu.models.motor.model import build_motor_jit_step

    with count_compiles() as h:
        build_motor_jit_step(refine=0.5, em_load_steps=1,
                             mm_newton_iters=2, em_newton_iters=2,
                             design_space="edge_deltas")
    assert len(h.events) <= 1, (
        f"motor build ran {len(h.events)} eager compiles "
        f"(each compiles a device program): {h.events}")


def test_fsi_builders_compile_budget():
    from femo_tpu.models.fsi import (
        build_fsi_jit_step, build_wing_fsi, build_dynamic_fsi_jit_step)

    # budget = 1: the cached lumped-mass assembly program is the single
    # legitimate build-time compile (CLAUDE.md)
    with count_compiles() as h:
        build_fsi_jit_step(n_shell=(4, 6), n_vlm=(2, 4),
                           factor_store_dtype=None, pcg_iters=2,
                           gs_inner=4, relax=0.7)
    assert len(h.events) <= 1, f"fsi jit build: {h.events}"

    with count_compiles() as h:
        build_wing_fsi(n_shell=(4, 6), n_vlm=(2, 4))
    assert len(h.events) <= 1, f"wing fsi build: {h.events}"

    with count_compiles() as h:
        build_dynamic_fsi_jit_step(n_shell=(4, 6), n_vlm=(2, 4), dt=0.01)
    assert len(h.events) <= 1, f"dynamic fsi build: {h.events}"


def test_shell_build_compile_budget():
    from femo_tpu.models.shell import build_shell_jit_step

    with count_compiles() as h:
        build_shell_jit_step(n_shell=(4, 6))
    assert len(h.events) <= 1, f"shell build: {h.events}"
