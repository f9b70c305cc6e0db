from setuptools import setup, find_packages

setup(
    name="femo_tpu",
    version="0.1.0",
    description=(
        "Differentiable finite-element framework in JAX for "
        "PDE-constrained optimization (JAX/XLA/Pallas)"
    ),
    packages=find_packages(exclude=["tests", "examples"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
)
