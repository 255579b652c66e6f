"""Spatial (pair-axis) parallelism for single large structures.

The reference scales only by replicating batches (data parallel,
`distribute_utils.py:84-159`); one huge MD cell cannot span GPUs. Here
a single structure's PAIR/TRIPLE arrays are sharded over the mesh while
positions/cell and every per-atom array stay replicated. Every per-atom
accumulation in the models is a `segment_sum` (or dense-layout matmul)
over the pair axis, so under `jit` XLA's SPMD partitioner computes
partial per-atom sums on each device and inserts the `psum`
automatically — the SAME energy function runs unchanged, and reverse-
mode forces/stress shard the scatter-adds the same way. Nonlinear
per-atom stages (EAM embedding F(rho), per-element MLPs) happen after
the psum, on replicated [n_vap] arrays, so physics is exact, not an
approximation.

This composes with data parallelism: a 2-D mesh ("data", "pairs")
shards batches on one axis and each structure's neighbor lists on the
other.
"""
from __future__ import annotations

from typing import Dict

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# feature keys whose LEADING axis is the pair / triple dimension.
# Dense-layout columns ("*_d") are per-ATOM [n_vap, nnl] arrays and
# stay replicated here — spatial sharding targets the flat segment
# layout.
_PAIR_PREFIXES = ("pair_", "trip_", "rij")


def is_pairwise_key(key: str) -> bool:
    return (any(key.startswith(p) for p in _PAIR_PREFIXES)
            and not key.endswith("_d"))


def pad_pair_axis(feats: Dict[str, np.ndarray], multiple: int
                  ) -> Dict[str, np.ndarray]:
    """Pad every pair/triple array's leading axis to a multiple of the
    mesh size (padding rows are masked: featurizer padding already
    points masked pairs at the VAP padding slot with mask 0, and
    np.zeros reproduces exactly that)."""
    out = dict(feats)
    for k, v in feats.items():
        if not is_pairwise_key(k) or np.ndim(v) == 0:
            continue
        n = v.shape[0]
        rem = (-n) % multiple
        if rem:
            pad = np.zeros((rem,) + v.shape[1:], dtype=np.asarray(v).dtype)
            out[k] = np.concatenate([np.asarray(v), pad], axis=0)
    return out


def shard_features_spatial(feats: Dict, mesh: Mesh,
                           axis_name: str = "pairs") -> Dict:
    """device_put features: pair/triple arrays sharded over the mesh
    axis, everything else (positions, cell, per-atom arrays, scalars)
    replicated."""
    n_dev = mesh.shape[axis_name]
    feats = pad_pair_axis(
        {k: np.asarray(jax.device_get(v)) if not isinstance(v, np.ndarray)
         else v for k, v in feats.items()}, n_dev)
    pair_sh = NamedSharding(mesh, P(axis_name))
    repl_sh = NamedSharding(mesh, P())

    def put(k, v):
        if is_pairwise_key(k) and np.ndim(v) > 0:
            return jax.device_put(v, pair_sh)
        return jax.device_put(v, repl_sh)

    return {k: put(k, v) for k, v in feats.items()}


def make_spatial_efs_fn(energy_fn, mesh: Mesh,
                        axis_name: str = "pairs"):
    """jit an EFS function whose pair work is sharded over the mesh.

    Returns fn(params, sharded_feats) -> {energy, forces, stress, ...};
    pass features through `shard_features_spatial` first. Output
    shardings are pinned replicated so results land on every device.
    """
    from ..nn.fields import make_efs_fn
    efs = make_efs_fn(energy_fn)
    repl = NamedSharding(mesh, P())
    return jax.jit(efs, out_shardings=repl)


def _pad_dense_columns(feats: Dict, multiple: int) -> Dict:
    """Pad the COLUMN (neighbor) axis of dense [n_vap, nnl, ...] arrays
    to a multiple of the mesh size. Padded columns reproduce the
    featurizer's padding exactly (index 0, mask 0), so physics is
    untouched. Transpose tables encode FLAT indices `row * width +
    col`, so when the source width changes they are remapped to the
    new stride (corrupt silently otherwise)."""
    out = dict(feats)
    widths = {}
    for k, v in feats.items():
        if not (k.startswith(("pair_", "trip_")) and k.endswith("_d")):
            continue
        v = np.asarray(v)
        if v.ndim < 2:
            continue
        rem = (-v.shape[1]) % multiple
        if rem:
            width = [(0, 0), (0, rem)] + [(0, 0)] * (v.ndim - 2)
            out[k] = np.pad(v, width)
        widths[k] = (v.shape[1], v.shape[1] + rem)
    for trans_key, src_key in (("pair_trans_d", "pair_j_d"),
                               ("trip_trans_j_d", "trip_j_d"),
                               ("trip_trans_k_d", "trip_j_d")):
        if trans_key not in out or src_key not in widths:
            continue
        old_w, new_w = widths[src_key]
        if old_w == new_w:
            continue
        t = np.asarray(out[trans_key])
        out[trans_key] = ((t // old_w) * new_w + t % old_w).astype(
            t.dtype)
    return out


def shard_features_spatial_dense(feats: Dict, mesh: Mesh,
                                 axis_name: str = "pairs") -> Dict:
    """Spatial sharding for the DENSE layout (the scatter-free fast
    paths): the [n_vap, nnl] neighbor-column axis is partitioned over
    the mesh — each device owns a slice of every atom's neighbors —
    while positions / cell / per-atom arrays replicate. Row reductions
    (rho sums, forces, virial) become per-device partials + an XLA
    `psum`; per-atom adjoint gathers (g_rho[jd]) read the
    replicated [n_vap] arrays locally. The column widths are
    power-of-two buckets, so any mesh size divides after padding."""
    n_dev = mesh.shape[axis_name]
    feats = _pad_dense_columns(
        {k: np.asarray(jax.device_get(v)) if not isinstance(v, np.ndarray)
         else v for k, v in feats.items()}, n_dev)
    col_sh = NamedSharding(mesh, P(None, axis_name))
    repl_sh = NamedSharding(mesh, P())

    def put(k, v):
        if (k.startswith(("pair_", "trip_")) and k.endswith("_d")
                and np.ndim(v) >= 2):
            return jax.device_put(v, col_sh)
        return jax.device_put(v, repl_sh)

    return {k: put(k, v) for k, v in feats.items()}


def make_spatial_fast_efs_fn(model, mesh: Mesh):
    """Spatially sharded SCATTER-FREE analytic EFS for EAM-family
    models: `nn/eam/fast_efs.make_fast_efs_fn` jitted over a mesh with
    dense-column sharded features (`shard_features_spatial_dense`).
    Physics is exact across chips — XLA inserts the psum of the
    column-partial accumulators."""
    from ..nn.eam.fast_efs import make_fast_efs_fn
    repl = NamedSharding(mesh, P())
    return jax.jit(make_fast_efs_fn(model), out_shardings=repl)
