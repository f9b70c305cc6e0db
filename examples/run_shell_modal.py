"""Shell modal analysis: natural frequencies + mode shapes of a clamped
plate wing (the run_pav_shell_modal.py workload, W6 modal variant,
/root/reference/examples/test_shell_m3l/run_pav_shell_modal.py).

Computes the first natural frequencies of the RM composite eigenproblem
K phi = omega^2 M phi twice — dense eigh (oracle) and the scalable
shift-invert Lanczos path on the block-Thomas factorization — and checks
the fundamental bending frequency against Euler-Bernoulli beam theory
f1 = (1.875^2 / 2 pi) sqrt(E I / (rho A L^4)).

PYTHONPATH=. JAX_PLATFORMS=cpu \
    python examples/run_shell_modal.py [--nx 4 --ny 16 --n-modes 6]
"""

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=4)
    ap.add_argument("--ny", type=int, default=16)
    ap.add_argument("--n-modes", type=int, default=6)
    ap.add_argument("--quad", action="store_true",
                    help="quad midsurface cells (PAV meshes are quad)")
    args = ap.parse_args()

    from femo_tpu.fea.bc import DirichletBC
    from femo_tpu.mesh.generators import create_rectangle_mesh
    from femo_tpu.mesh.mesh import Mesh
    from femo_tpu.models.shell import RMShellModel, shell_modal_analysis

    # cantilever plate wing: 4m span, 1m chord, aluminum-like, t=10mm
    L, b, t = 4.0, 1.0, 0.01
    E, nu, rho = 7e10, 0.3, 2700.0
    cell = "quad" if args.quad else "triangle"
    m2 = create_rectangle_mesh(args.nx, args.ny, 0, 0, b, L, cell_type=cell)
    coords3 = np.concatenate([m2.coords, np.zeros((m2.n_nodes, 1))], axis=1)
    mesh = Mesh(coords3, m2.cells, cell)
    shell = RMShellModel(mesh, E=E, nu=nu, rho=rho)
    shell.thickness.set(t)

    clamp = lambda x: np.isclose(x[1], 0.0)
    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]

    f_dense, _ = shell_modal_analysis(shell, bcs, n_modes=args.n_modes,
                                      method="dense")
    f_lcz, _ = shell_modal_analysis(shell, bcs, n_modes=args.n_modes,
                                    method="lanczos")

    # Euler-Bernoulli fundamental bending frequency of the equivalent beam
    I = b * t ** 3 / 12.0
    A = b * t
    f1_beam = (1.875104 ** 2 / (2 * np.pi)) * np.sqrt(
        E * I / (rho * A * L ** 4))

    print(f"mesh: {mesh.n_cells} {cell} cells, "
          f"{shell.Vu.n_dofs + shell.Vth.n_dofs} dofs")
    print(f"{'mode':>4} {'dense [Hz]':>12} {'lanczos [Hz]':>12}")
    for k in range(args.n_modes):
        print(f"{k + 1:>4} {f_dense[k]:>12.4f} {f_lcz[k]:>12.4f}")
    rel = abs(f_dense[0] - f1_beam) / f1_beam
    print(f"beam-theory f1 = {f1_beam:.4f} Hz  "
          f"(dense f1 rel err {rel:.2%}; converges with --ny, "
          f"0.08% at test_shell's resolution)")
    agree = np.max(np.abs(np.asarray(f_dense) - np.asarray(f_lcz))
                   / np.asarray(f_dense))
    print(f"dense vs lanczos max rel diff: {agree:.2e}")
    assert rel < 0.05 and agree < 1e-6


if __name__ == "__main__":
    main()
