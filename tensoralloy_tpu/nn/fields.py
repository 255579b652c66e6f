"""Derived physical properties by automatic differentiation.

Reference math (`tensoralloy/nn/basic.py:276-421`):
  forces  F = -dE/dR
  virial  W = (dE/dR)^T R + (dE/dh)^T h        (h = cell rows)
  stress  sigma = W / V (eV/A^3), Voigt order [xx, yy, zz, yz, xz, xy]
  total pressure P = -tr(sigma)/3 in GPa
  hessian H = d2E/dR2

In JAX these are one `jax.grad` (or `jax.hessian`) of the pure energy
function — no graph re-traversal machinery needed.
"""
from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp

# eV/A^3 -> GPa
EV_ANGSTROM3_TO_GPA = 160.21766208
# The virial contracts over every atom (or pair) with absolute
# positions of O(cell size); at float32 matmul defaults a GPU rounds
# the operands to TF32 (10-bit mantissa), which breaks the tensor's
# symmetry (by 1.2e-3 GPa for a 131k-atom GRAP cell on an H100). These
# products are tiny next to the model, so they always run exactly.
HIGHEST = jax.lax.Precision.HIGHEST
GPa = 1.0 / EV_ANGSTROM3_TO_GPA  # 1 GPa in eV/A^3


def full_to_voigt(s: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([s[..., 0, 0], s[..., 1, 1], s[..., 2, 2],
                      0.5 * (s[..., 1, 2] + s[..., 2, 1]),
                      0.5 * (s[..., 0, 2] + s[..., 2, 0]),
                      0.5 * (s[..., 0, 1] + s[..., 1, 0])], axis=-1)


def make_efs_fn(energy_fn: Callable,
                extras_fn: Callable = None) -> Callable:
    """energy_fn(params, features) -> scalar.

    Returns fn(params, features) -> dict with energy, forces
    [n_vap, 3], virial/stress [3,3], stress_voigt [6], total_pressure
    (GPa); `extras_fn(params, features) -> dict` outputs (e.g. atomic
    energies, finite-T heads) are merged in so everything compiles into
    ONE executable (critical over slow host<->device links).
    """

    def efs(params, features) -> Dict[str, jnp.ndarray]:
        pos = features["positions"]
        cell = features["cell"]

        def e_of(p, h):
            f = dict(features)
            f["positions"] = p
            f["cell"] = h
            return energy_fn(params, f)

        energy, (gpos, gcell) = jax.value_and_grad(
            e_of, argnums=(0, 1))(pos, cell)
        forces = -gpos
        virial = (jnp.dot(gpos.T, pos, precision=HIGHEST) +
                  jnp.dot(gcell.T, cell, precision=HIGHEST))
        volume = jnp.maximum(jnp.abs(jnp.linalg.det(cell)), 1e-12)
        stress = virial / volume
        voigt = full_to_voigt(stress)
        pressure = -jnp.trace(stress) / 3.0 * EV_ANGSTROM3_TO_GPA
        out = {"energy": energy, "forces": forces, "virial": virial,
               "stress": stress, "stress_voigt": voigt,
               "total_pressure": pressure}
        if extras_fn is not None:
            out.update(extras_fn(params, features))
        return out

    return efs


def make_hessian_fn(energy_fn: Callable) -> Callable:
    """-> fn(params, features) -> [n_vap, 3, n_vap, 3] Hessian."""

    def hess(params, features):
        pos = features["positions"]

        def e_of(p):
            f = dict(features)
            f["positions"] = p
            return energy_fn(params, f)

        return jax.hessian(e_of)(pos)

    return hess


def make_rij_efs_fn(energy_fn: Callable) -> Callable:
    """rij-fed evaluation (reference `use_computed_dists=False`,
    `universal.py:265-276`): the caller supplies displacement vectors
    ("rij" [nij, 3], plus "trip_rij"/"trip_rik" for angular models)
    and the energy is differentiated w.r.t. THEM — positions and cell
    stay out of the graph. This is the contract an external MD engine
    (LAMMPS pair style) needs: per-pair force partials it can
    accumulate itself.

    Returns fn(params, features) -> dict with
      energy        scalar
      pair_forces   dE/drij [nij, 3]  (engine-side accumulation)
      forces        [n_vap, 3] reconstructed: F_i = sum_{i center} g
                    - sum_{i neighbor} g  (for verification)
      virial/stress from W = sum_p g_p (x) rij_p.

    Only the flat pair layout (descriptor backend 'segment') carries
    explicit rij arrays; dense backends compute distances from
    their own columns.
    """

    def efs(params, features) -> Dict[str, jnp.ndarray]:
        keys = [k for k in ("rij", "trip_rij", "trip_rik")
                if k in features]
        vecs = tuple(features[k] for k in keys)

        def e_of(*vs):
            f = dict(features)
            f.update(zip(keys, vs))
            return energy_fn(params, f)

        energy, grads = jax.value_and_grad(
            e_of, argnums=tuple(range(len(keys))))(*vecs)
        grads = dict(zip(keys, grads))
        n_vap = features["positions"].shape[0]
        seg = lambda v, i: jax.ops.segment_sum(v, features[i],
                                               num_segments=n_vap)
        g = grads["rij"]
        forces = seg(g, "pair_i") - seg(g, "pair_j")
        virial = jnp.dot(g.T, features["rij"], precision=HIGHEST)
        out = {"energy": energy, "pair_forces": g}
        for gk, (src, dst) in (("trip_rij", ("trip_i", "trip_j")),
                               ("trip_rik", ("trip_i", "trip_k"))):
            if gk in grads:
                gt = grads[gk]
                forces = forces + seg(gt, src) - seg(gt, dst)
                virial = virial + jnp.dot(gt.T, features[gk],
                                          precision=HIGHEST)
                out[f"{gk}_forces"] = gt
        volume = jnp.abs(jnp.linalg.det(features["cell"]))
        stress = virial / jnp.maximum(volume, 1e-12)
        out.update({"forces": forces, "virial": virial,
                    "stress": stress,
                    "stress_voigt": full_to_voigt(stress)})
        return out

    return efs
