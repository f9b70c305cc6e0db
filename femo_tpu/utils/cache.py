"""Persistent XLA compilation cache for the GPU entry points.

Compiling a fused optimisation step is set-up time, and every process
pays it again unless the compiled executables are kept on disk.  The
reference stack has no such cost — FFCx kernels are compiled once to .so
and dlopened (SURVEY.md section 3) — so caching compiled executables
across processes is the parity move.

Where the cache lives:
  JAX_COMPILATION_CACHE_DIR set  -> JAX reads the variable itself; this
                                    module sets no other directory
  otherwise                      -> <checkout>/.jax_cache (git-ignored):
                                    a fixed path, since the path is part
                                    of what makes a later process hit

Off on the CPU: XLA:CPU's executable reload crashed the test suite after
thousands of in-process reloads (tests/conftest.py), so the CPU compiles
fresh.

Usage: call `enable_persistent_cache()` before the first jit compilation.
"""

import os

__all__ = ["cache_dir", "enable_persistent_cache"]

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir():
    """The directory the cache uses: JAX_COMPILATION_CACHE_DIR when set,
    else the fixed in-checkout path."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_persistent_cache(device=None):
    """Enable JAX's persistent compilation cache unless `device` (default:
    the first device) is a CPU.  Returns the cache directory, or None on
    the CPU."""
    import jax

    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return None
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
