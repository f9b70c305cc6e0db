"""SPMD mesh-partitioned assembly over a device mesh.

JAX replacement for MPI domain decomposition (SURVEY.md §2.4, N7):
the reference relies on dolfinx/PETSc rank-owned mesh partitions with
`ghostUpdate` scatters and `comm.allreduce`
(/root/reference/femo/fea/utils_dolfinx.py:167,200,236,271).  Here, *cells*
(and boundary facets) are sharded across devices via `shard_map`; dof vectors
stay replicated; each device segment-sums its local element contributions
into a full-length vector and a single `psum` over the mesh axis replaces
both the ghost scatter and the allreduce.  Krylov dot products then run on
replicated vectors — bitwise identical across devices — so no further
collectives are needed inside the solver.

This "cells sharded / dofs replicated" layout is the right first regime for
the workloads' scales (dof vectors are ~MBs while element work dominates);
a halo-exchange dof-sharded mode can be layered on the same Term-data
override mechanism later.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as DeviceMesh, PartitionSpec as P
from jax import shard_map

from ..config import config
from ..fea.assemble import CompiledForm, _Term


AXIS = "cells"


def device_mesh(n_devices: int | None = None) -> DeviceMesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return DeviceMesh(np.array(devs[:n]).reshape(n), (AXIS,))


def _pad_shard(arr: jnp.ndarray, n_ent: int, ndev: int):
    """Pad leading dim to a multiple of ndev by repeating entry 0 (valid
    geometry, masked to zero contribution)."""
    ne_pad = ((n_ent + ndev - 1) // ndev) * ndev
    if ne_pad == n_ent:
        return arr
    pad = jnp.broadcast_to(arr[0:1], (ne_pad - n_ent,) + arr.shape[1:])
    return jnp.concatenate([arr, pad], axis=0)


def _entity_order(term: _Term, ndev: int):
    """Spatially-coherent entity ordering via the native RCB partitioner
    (femo_tpu.native): each device's contiguous slice is a compact spatial
    block — the layout groundwork for halo-exchange dof sharding."""
    import numpy as np

    from .. import native

    cents = np.asarray(term.coords0).mean(axis=1)  # (ne, gdim)
    part = native.rcb_partition(cents, ndev)
    return np.argsort(part, kind="stable").astype(np.int32)


def _shard_term_data(term: _Term, ndev: int, order=None):
    """Build a padded+masked copy of a term's entity data, ready to be
    partitioned along the leading axis."""
    ne = term.n_ent
    ne_pad = ((ne + ndev - 1) // ndev) * ndev
    mask = jnp.concatenate(
        [jnp.ones(ne, config.jdtype), jnp.zeros(ne_pad - ne, config.jdtype)])
    d = SimpleNamespace(mask=mask)

    def prep(a):
        if order is not None:
            a = a[order]
        return _pad_shard(a, ne, ndev)

    for key in ("coords0", "h", "tag", "ctag0", "ctag1", "var0",
                "cent0", "coords1", "var1"):
        if hasattr(term, key):
            d.__dict__[key] = prep(getattr(term, key))
    d.gdofs0 = {k: prep(v) for k, v in term.gdofs0.items()}
    if hasattr(term, "gdofs1"):
        d.gdofs1 = {k: prep(v) for k, v in term.gdofs1.items()}
    return d


def _data_to_tree(d: SimpleNamespace):
    return dict(d.__dict__)


def _tree_to_data(t: dict):
    return SimpleNamespace(**t)


def sharded_vector_fn(cform: CompiledForm, mesh: DeviceMesh):
    """Residual assembly with entities sharded over the device mesh.

    Returns fn(values: dict[str, (n_dofs,)]) -> (n_dofs,), jittable and
    differentiable (shard_map supports jvp/vjp; the psum transposes to a
    broadcast automatically).
    """
    ndev = mesh.devices.size
    n = cform.form.test.n_dofs
    term_trees = [
        _data_to_tree(_shard_term_data(t, ndev, _entity_order(t, ndev)))
        for t in cform.terms]

    data_specs = [jax.tree.map(lambda _: P(AXIS), tree)
                  for tree in term_trees]

    def local_assemble(values, *trees):
        out = jnp.zeros(n, config.jdtype)
        for term, tree in zip(cform.terms, trees):
            d = _tree_to_data(tree)
            contrib, rows = term.residual_contrib(values, "__test__", d)
            out = out + jax.ops.segment_sum(contrib, rows, num_segments=n)
        return jax.lax.psum(out, AXIS)

    smapped = shard_map(
        local_assemble, mesh=mesh,
        in_specs=(P(),) + tuple(data_specs),
        out_specs=P(),
    )

    def fn(values: dict):
        vals = {k: values[k] for k in cform.all_names if k in values}
        return smapped(vals, *term_trees)

    return fn


def sharded_scalar_fn(cform: CompiledForm, mesh: DeviceMesh):
    """Functional assembly with entities sharded over the device mesh."""
    ndev = mesh.devices.size
    term_trees = [
        _data_to_tree(_shard_term_data(t, ndev, _entity_order(t, ndev)))
        for t in cform.terms]
    data_specs = [jax.tree.map(lambda _: P(AXIS), tree)
                  for tree in term_trees]

    def local_assemble(values, *trees):
        out = jnp.zeros((), config.jdtype)
        for term, tree in zip(cform.terms, trees):
            out = out + term.scalar(values, _tree_to_data(tree))
        return jax.lax.psum(out, AXIS)

    smapped = shard_map(
        local_assemble, mesh=mesh,
        in_specs=(P(),) + tuple(data_specs),
        out_specs=P(),
    )

    def fn(values: dict):
        vals = {k: values[k] for k in cform.all_names if k in values}
        return smapped(vals, *term_trees)

    return fn


def sharded_matrix_dense_fn(cform: CompiledForm, mesh: DeviceMesh, wrt: str):
    """Jacobian assembly with entities sharded over the device mesh,
    densified and psum-reduced to a replicated (n_rows, n_cols) matrix.

    The sharded counterpart of CompiledForm.matrix(...).to_dense(): each
    device scatters its local masked element blocks into a full dense
    matrix and one psum replaces the assembly ghost-scatter (reference MPI
    assembly, /root/reference/femo/fea/utils_dolfinx.py:195-202).  Feeds
    implicit_solve_dense_jit for a replicated on-device LU solve.
    """
    ndev = mesh.devices.size
    n_rows = cform.form.test.n_dofs
    n_cols = cform.form.coeffs[wrt].space.n_dofs
    term_trees = [
        _data_to_tree(_shard_term_data(t, ndev, _entity_order(t, ndev)))
        for t in cform.terms]
    data_specs = [jax.tree.map(lambda _: P(AXIS), tree)
                  for tree in term_trees]

    def local_assemble(values, *trees):
        M = jnp.zeros((n_rows, n_cols), config.jdtype)
        for term, tree in zip(cform.terms, trees):
            d = _tree_to_data(tree)
            A, rows, cols = term.matrix_blocks(values, "__test__", wrt, d)
            ne, nr, nc = A.shape
            ridx = jnp.broadcast_to(rows[:, :, None], (ne, nr, nc))
            cidx = jnp.broadcast_to(cols[:, None, :], (ne, nr, nc))
            M = M.at[ridx.reshape(-1), cidx.reshape(-1)].add(A.reshape(-1))
        return jax.lax.psum(M, AXIS)

    smapped = shard_map(
        local_assemble, mesh=mesh,
        in_specs=(P(),) + tuple(data_specs),
        out_specs=P(),
    )

    def fn(values: dict):
        vals = {k: values[k] for k in cform.all_names if k in values}
        return smapped(vals, *term_trees)

    return fn
