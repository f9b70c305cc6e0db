"""Host-array helpers for builder code.

Build-time rule (CLAUDE.md): construct arrays in numpy on the host and
make ONE `jnp.asarray` transfer.  Any eager device op — `jnp.zeros`,
`jnp.full`, a device `.astype`, a strided slice — compiles a tiny XLA
program (the motor build once ran 628 of them before the host-side
pattern prototypes).  tests/test_build_compiles.py pins the per-builder
budgets.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def asdev(x, dtype=None):
    """Host-convert then transfer: `jnp.asarray(x, dtype)` with a dtype
    change compiles a convert program per shape; converting in numpy
    first makes the transfer compile-free."""
    return jnp.asarray(np.asarray(x, dtype))
