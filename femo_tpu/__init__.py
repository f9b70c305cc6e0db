"""femo_tpu — a differentiable finite-element framework in JAX for
PDE-constrained optimization, run on NVIDIA GPUs.

Capability-equivalent rebuild of RuruX/femo (FEniCSx/CSDL/PETSc based) as an
idiomatic JAX/XLA/Pallas stack: JAX-traced element kernels, segment-sum
assembly, device Krylov/Newton solvers, custom_vjp implicit-function-theorem
adjoints, and SPMD mesh partitioning over device meshes.
"""

from . import config as _config  # noqa: F401  (enables x64 on import)
from .config import config, set_precision

__version__ = "0.1.0"
