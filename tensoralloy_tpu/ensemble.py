"""Deep-ensemble inference and uncertainty-driven sampling.

The reference's data pipeline (`tensordb`) samples AIMD frames by
fixed schedules; the modern loop ranks candidates by MODEL DISAGREEMENT
instead. This module provides the device-side primitive: K independently
trained parameter sets evaluated in ONE device program via `jax.vmap`
over a stacked parameter pytree — the featurization, neighbor lists,
and XLA executable are shared, so ensemble inference costs roughly one
model's bandwidth plus K small MLP heads instead of K full pipelines.

`EnsembleCalculator` returns the ensemble mean for every property of
`TensorAlloyCalculator` plus uncertainty channels (`energy_std`,
`forces_std`, per-atom force disagreement); `select_by_uncertainty`
is the active-learning selection step used with `tensordb` samplers.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .atoms import Structure
from .calculator import TensorAlloyCalculator

__all__ = ["stack_params", "EnsembleCalculator", "select_by_uncertainty"]


def stack_params(params_list: Sequence[dict]):
    """[K] pytrees with identical structure -> one pytree whose leaves
    carry a leading ensemble axis."""
    if len(params_list) < 2:
        raise ValueError("an ensemble needs at least 2 parameter sets")
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
        *params_list)


class EnsembleCalculator(TensorAlloyCalculator):
    """Mean + disagreement over K parameter sets of ONE architecture.

    Construct from a list of saved-model paths (architectures must
    match; parameters differ by training seed/replica) or from a model
    plus an explicit parameter list. All `TensorAlloyCalculator`
    getters return the ensemble MEAN; `get_energy_std`,
    `get_forces_std`, `get_max_force_std` expose the disagreement.
    """

    def __init__(self, model_or_paths, params_list: Sequence[dict] = None,
                 n_shards: int = 1, **kwargs):
        if isinstance(model_or_paths, (list, tuple)):
            from .io.model import load_model
            models, plist = [], []
            for p in model_or_paths:
                m, params, _ = load_model(p)
                models.append(m)
                plist.append(params)
            a0 = models[0].featurizer.as_dict()
            for m in models[1:]:
                if m.featurizer.as_dict() != a0:
                    raise ValueError(
                        "ensemble members disagree on the featurizer "
                        "(elements/cutoffs) — they are not one "
                        "architecture")
            model, params_list = models[0], plist
        else:
            model = model_or_paths
            if params_list is None:
                raise ValueError("pass params_list with a model object")
        super().__init__(model, stack_params(params_list), **kwargs)
        self.n_members = len(params_list)
        if n_shards > 1:
            # shard the MEMBER axis over a 1-D device mesh: committee
            # members are embarrassingly parallel (no cross-member
            # coupling until the host-side mean/std), so a
            # NamedSharding on every stacked-parameter leaf is the
            # whole implementation — XLA replicates the shared
            # features and partitions the vmapped K-axis
            if self.n_members % n_shards:
                raise ValueError(
                    f"{self.n_members} members not divisible by "
                    f"n_shards={n_shards}")
            if n_shards > len(jax.devices()):
                raise ValueError(
                    f"n_shards={n_shards} > available devices")
            from jax.sharding import (Mesh, NamedSharding,
                                      PartitionSpec)
            mesh = Mesh(np.array(jax.devices()[:n_shards]),
                        ("member",))
            sharding = NamedSharding(mesh, PartitionSpec("member"))
            self.params = jax.device_put(self.params, sharding)

    @staticmethod
    def _jit_efs(fn):
        return jax.jit(jax.vmap(fn, in_axes=(0, None)))

    def _assemble(self, out, vap) -> Dict[str, np.ndarray]:
        forces_k = np.asarray(out["forces"])          # [K, n_vap, 3]
        energy_k = np.asarray(out["energy"])          # [K]
        if "energy_U" in out:
            energy_k = np.asarray(out["energy_U"])
        stress_k = np.asarray(out["stress_voigt"])
        results = {
            "energy": float(energy_k.mean()),
            "free_energy": float(np.asarray(out["energy"]).mean()),
            "forces": vap.reverse_map(forces_k.mean(axis=0)),
            "stress": stress_k.mean(axis=0),
            "pressure": float(np.asarray(out["total_pressure"]).mean()),
            "energy_std": float(energy_k.std(axis=0)),
            # per-atom std of the force VECTOR (norm over xyz of the
            # component-wise std): the usual query-by-committee score
            "forces_std": np.linalg.norm(
                vap.reverse_map(forces_k.std(axis=0)), axis=1),
            "stress_std": stress_k.std(axis=0),
        }
        if "atomic_energies" in out:
            results["atomic_energies"] = vap.reverse_map(
                np.asarray(out["atomic_energies"]).mean(axis=0))
        if "energy_U" in out:
            results["eentropy"] = float(
                np.asarray(out["eentropy"]).mean())
            results["free_energy"] = float(
                np.asarray(out["free_energy_F"]).mean())
        return results

    # ------------------------------------------------------------------
    def get_energy_std(self, structure: Structure = None) -> float:
        return self._maybe_calculate(structure)["energy_std"]

    def get_forces_std(self, structure: Structure = None) -> np.ndarray:
        """[n_atoms] committee disagreement per atom (eV/A)."""
        return self._maybe_calculate(structure)["forces_std"]

    def get_max_force_std(self, structure: Structure = None) -> float:
        return float(self._maybe_calculate(structure)["forces_std"].max())

    def get_hessian(self, structure, phonopy_format: bool = False):
        raise NotImplementedError(
            "ensemble Hessians are not reduced — evaluate a member "
            "with TensorAlloyCalculator on one parameter set")


def select_by_uncertainty(calc: EnsembleCalculator,
                          structures: List[Structure],
                          n_select: int = 0,
                          threshold: float = 0.0) -> List[int]:
    """Active-learning selection: rank `structures` by the committee's
    max per-atom force disagreement, descending. Returns the indices of
    the top `n_select` (all, if 0) whose score exceeds `threshold` —
    feed the chosen frames to a `tensordb` recompute calculator.
    """
    scores = [calc.get_max_force_std(s) for s in structures]
    order = sorted(range(len(structures)), key=lambda i: -scores[i])
    picked = [i for i in order if scores[i] >= threshold]
    return picked[:n_select] if n_select else picked
