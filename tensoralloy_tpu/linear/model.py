"""Linear moment-tensor potentials (reference `tensoralloy/linear/`:
`LinearTensorMD` + the Cython kernels in `ops.pyx`).

Redesign: the model is linear in its coefficients,
E = sum_e [ sum_{i in e} G_i . c_e + N_e b_e ], with G the GRAP
moment-tensor invariants. The reference's hand-written Cython force
kernels (`kernel_F1/kernel_F2`, `sum_forces`) are replaced by exact
`jax.jacrev` of the per-element feature sums w.r.t. positions/strain —
the same design-matrix rows, produced by autodiff and jit-compiled.

A fitted model is exported as a zero-hidden-layer `AtomicNN`, so the
whole calculator / saved-model / CLI stack applies unchanged.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..atoms import Structure
from ..nn.grap import GenericRadialAtomicPotential
from ..nn.atomic import AtomicNN
from ..transform.featurizer import Featurizer

# named radial-filter presets (reference `linear/preset.py`)
PRESETS: Dict[str, dict] = {
    "pexp16": {"algorithm": "pexp",
               "parameters": {
                   "rl": [1.0, 1.2, 1.4, 1.6, 1.8, 2.0, 2.2, 2.4, 2.6,
                          2.8, 3.0, 3.2, 3.4, 3.6, 3.8, 4.0],
                   "pl": [5.0, 4.75, 4.5, 4.25, 4.0, 3.75, 3.5, 3.25,
                          3.0, 2.75, 2.5, 2.25, 2.0, 1.75, 1.5, 1.25]}},
    "pexp8": {"algorithm": "pexp",
              "parameters": {
                  "rl": [1.0, 1.4, 1.8, 2.2, 2.6, 3.0, 3.4, 3.8],
                  "pl": [4.0, 3.5, 3.0, 2.75, 2.5, 2.25, 2.0, 1.5]}},
    "sf4": {"algorithm": "sf",
            "parameters": {"eta": [0.5, 1.0, 4.0, 20.0],
                           "omega": [0.0, 0.0, 0.0, 0.0]}},
}


class LinearTensorMD:
    """Least-squares-fitted linear moment-tensor potential."""

    def __init__(self, elements: Sequence[str], rcut: float = 6.0,
                 preset: str = "pexp8", max_moment: int = 3,
                 symmetric: bool = False):
        self.elements = sorted(elements)
        self.rcut = float(rcut)
        self.preset = preset
        if "@" in preset:  # reference-named bank, e.g. 'pexp@medium'
            from .preset import get_filter_preset
            cfg = dict(get_filter_preset(preset))
        else:
            cfg = dict(PRESETS[preset], param_space_method="pair")
        self.featurizer = Featurizer(self.elements, rcut=rcut)
        self.descriptor = GenericRadialAtomicPotential(
            self.elements, algorithm=cfg["algorithm"],
            parameters=cfg["parameters"],
            param_space_method=cfg["param_space_method"],
            moment_tensors=list(range(max_moment + 1)),
            symmetric=symmetric)
        self.max_moment = max_moment
        self.n_features = self.descriptor.feature_dim(
            self.featurizer.n_radial_slots, 0, False)
        # per element: n_features coefficients + 1 bias
        self.n_coef = len(self.elements) * (self.n_features + 1)
        self.coef_: Optional[np.ndarray] = None
        self._jit_cache: Dict[tuple, tuple] = {}

    # ------------------------------------------------------------------
    def _feature_sums_fn(self, max_occurs: Counter):
        """S(positions, cell, feats) -> [n_coef] per-element feature
        sums (+ atom counts for the bias columns)."""
        model = AtomicNN(self.featurizer, max_occurs, self.descriptor,
                         hidden_sizes=[], minmax_scale=False)

        def sums(feats):
            g = model.descriptors(feats)          # [n_vap, D]
            masks = feats["atom_masks"]
            cols = []
            for e in self.elements:
                lo, cnt = model.layout[e]
                if cnt:
                    ge = jax.lax.dynamic_slice_in_dim(g, lo, cnt, 0)
                    me = jax.lax.dynamic_slice_in_dim(masks, lo, cnt, 0)
                    cols.append(jnp.sum(ge * me[:, None], axis=0))
                    cols.append(jnp.sum(me)[None])
                else:
                    cols.append(jnp.zeros((self.n_features,), g.dtype))
                    cols.append(jnp.zeros((1,), g.dtype))
            return jnp.concatenate(cols)

        return sums, model

    def _get_jitted(self, max_occurs: Counter):
        key = tuple(sorted(max_occurs.items()))
        hit = self._jit_cache.get(key)
        if hit is None:
            sums, model = self._feature_sums_fn(Counter(dict(key)))

            def energy_row(feats):
                return sums(feats)

            def force_rows(feats):
                def s_of_pos(p):
                    return sums(dict(feats, positions=p))
                jac = jax.jacrev(s_of_pos)(feats["positions"])
                # [n_coef, n_vap, 3] -> forces row block is -dS/dR
                return -jac

            def virial_rows(feats):
                pos0, cell0 = feats["positions"], feats["cell"]

                def s_of_eps(eps6):
                    e = jnp.asarray(
                        [[eps6[0], eps6[5] / 2, eps6[4] / 2],
                         [eps6[5] / 2, eps6[1], eps6[3] / 2],
                         [eps6[4] / 2, eps6[3] / 2, eps6[2]]])
                    m = jnp.eye(3, dtype=pos0.dtype) + e
                    return sums(dict(feats, positions=pos0 @ m.T,
                                     cell=cell0 @ m.T))
                return jax.jacrev(s_of_eps)(
                    jnp.zeros((6,), pos0.dtype))   # [n_coef, 6]

            hit = (jax.jit(energy_row), jax.jit(force_rows),
                   jax.jit(virial_rows), model)
            self._jit_cache[key] = hit
        return hit

    # ------------------------------------------------------------------
    def design_rows(self, structure: Structure,
                    with_forces: bool = True, with_virial: bool = False
                    ) -> Dict[str, np.ndarray]:
        """Design-matrix rows and labels for one structure."""
        occurs = Counter(structure.symbols)
        e_fn, f_fn, v_fn, model = self._get_jitted(occurs)
        fz = self.featurizer
        vap = fz.make_vap(structure, occurs)
        feats = {k: jnp.asarray(v)
                 for k, v in fz.featurize(structure, vap).items()}
        out = {"energy_row": np.asarray(e_fn(feats)),
               "energy": structure.energy}
        if with_forces and structure.forces is not None:
            jac = np.asarray(f_fn(feats))          # [n_coef, n_vap, 3]
            local = jac[:, vap.local_to_vap, :]    # [n_coef, N, 3]
            out["force_rows"] = local.reshape(self.n_coef, -1).T
            out["forces"] = structure.forces.reshape(-1)
        if with_virial and structure.stress is not None:
            vir = np.asarray(v_fn(feats)).T        # [6, n_coef]
            out["virial_rows"] = vir / structure.volume
            out["stress"] = np.asarray(structure.stress)
        return out

    # ------------------------------------------------------------------
    def fit(self, structures: Sequence[Structure],
            energy_weight: float = 1.0, forces_weight: float = 1.0,
            stress_weight: float = 0.0, per_atom_energy: bool = True,
            method: str = "ridge", alpha: float = 1e-8) -> dict:
        rows, targets, weights = [], [], []
        for s in structures:
            d = self.design_rows(
                s, with_forces=forces_weight > 0,
                with_virial=stress_weight > 0)
            scale = 1.0 / len(s) if per_atom_energy else 1.0
            if d["energy"] is not None:
                rows.append(d["energy_row"] * scale)
                targets.append(d["energy"] * scale)
                weights.append(energy_weight)
            if forces_weight > 0 and "force_rows" in d:
                rows.extend(d["force_rows"])
                targets.extend(d["forces"])
                weights.extend([forces_weight] * len(d["forces"]))
            if stress_weight > 0 and "virial_rows" in d:
                rows.extend(d["virial_rows"])
                targets.extend(d["stress"])
                weights.extend([stress_weight] * 6)
        a = np.asarray(rows)
        b = np.asarray(targets)
        w = np.sqrt(np.asarray(weights))
        aw = a * w[:, None]
        bw = b * w
        if method == "lstsq":
            coef = np.linalg.lstsq(aw, bw, rcond=None)[0]
        elif method == "ridge":
            ata = aw.T @ aw + alpha * np.eye(self.n_coef)
            coef = np.linalg.solve(ata, aw.T @ bw)
        elif method == "elasticnet":
            from sklearn.linear_model import ElasticNet
            reg = ElasticNet(alpha=alpha, fit_intercept=False,
                             max_iter=50000)
            reg.fit(aw, bw)
            coef = reg.coef_
        else:
            raise ValueError(method)
        self.coef_ = coef
        resid = a @ coef - b
        return {"rmse": float(np.sqrt(np.mean(resid ** 2))),
                "n_rows": len(b), "n_coef": self.n_coef}

    # ------------------------------------------------------------------
    def to_atomic_nn(self, max_occurs: Counter
                     ) -> Tuple[AtomicNN, dict]:
        """Express the fitted linear model as a 0-hidden-layer AtomicNN
        (weights = coefficients, bias = per-element constant), so the
        standard calculator / export stack applies."""
        if self.coef_ is None:
            raise RuntimeError("fit() first")
        model = AtomicNN(self.featurizer, max_occurs, self.descriptor,
                         hidden_sizes=[], minmax_scale=False)
        params = model.init_params(jax.random.PRNGKey(0))
        per = self.n_features + 1
        for idx, e in enumerate(self.elements):
            block = self.coef_[idx * per:(idx + 1) * per]
            params[e]["mlp"]["layers"][0]["w"] = \
                jnp.asarray(block[:-1][:, None])
            params[e]["mlp"]["layers"][0]["b"] = \
                jnp.asarray(block[-1:])
        return model, params

    def predict(self, structure: Structure) -> Dict[str, np.ndarray]:
        calc = TensorMDPythonCalculator(self)
        return calc.calculate(structure)

    def export(self, path: str):
        """Save in the standard saved-model format (the .npz saved
        model is this framework's deployable artifact; see
        `export_tensormd` for the external-engine blob)."""
        from ..io.model import save_model
        occurs = Counter({e: 1 for e in self.elements})
        model, params = self.to_atomic_nn(occurs)
        save_model(path, model, params,
                   extra_metadata={"linear_tensor_md": True,
                                   "preset": self.preset})

    def export_tensormd(self, path: str, precision: int = 64):
        """Export the fitted model for the external TensorMD engine
        (LAMMPS `pair_style tensoralloy/native`) using the reference's
        npz key contract (`linear/model.py:666-707`): rmax/nelt/masses/
        numbers + descriptor::rl/pl + per-element weights_i_0 (the
        n_features coefficients) and biases_i_0 (the static energy).
        Only pexp banks are representable (descriptor::type 0)."""
        if self.coef_ is None:
            raise RuntimeError("fit() first")
        if self.descriptor.algorithm != "pexp":
            raise ValueError(
                "TensorMD engine export supports pexp filter banks only")
        dtype = np.float64 if precision == 64 else np.float32
        from ..elements import atomic_masses, atomic_numbers
        params = self.descriptor.parameters
        chars = [ord(ch) for elt in self.elements for ch in elt]
        data = {
            "rmax": dtype(self.rcut),
            "nelt": np.int32(len(self.elements)),
            "masses": np.array(
                [atomic_masses[atomic_numbers[e]] for e in self.elements],
                dtype=dtype),
            "numbers": np.array(chars, dtype=np.int32),
            "tdnp": np.int32(0),
            "precision": precision,
            "use_fnn": np.int32(0),
            "descriptor::rl": np.array(params["rl"], dtype=dtype),
            "descriptor::pl": np.array(params["pl"], dtype=dtype),
            "descriptor::type": np.int32(0),
            "nlayers": np.int32(0),
            "max_moment": np.int32(self.max_moment),
            "actfn": np.int32(0),
            "fctype": np.int32(0),
            "layer_sizes": np.array([0], dtype=np.int32),
            "use_resnet_dt": np.int32(0),
            "apply_output_bias": np.int32(1),
        }
        per = self.n_features + 1
        for i, _ in enumerate(self.elements):
            block = self.coef_[i * per:(i + 1) * per]
            data[f"weights_{i}_0"] = np.asarray(block[:-1], dtype=dtype)
            data[f"biases_{i}_0"] = np.asarray(block[-1:], dtype=dtype)
        np.savez(path, **data)
        return data


class TensorMDPythonCalculator:
    """Calculator over a fitted `LinearTensorMD` (reference
    `linear/model.py:710-874`)."""

    def __init__(self, model: LinearTensorMD):
        self.linear = model
        self._calc = None

    def calculate(self, structure: Structure) -> Dict[str, np.ndarray]:
        from ..calculator import TensorAlloyCalculator
        if self._calc is None:
            occurs = Counter({e: 1 for e in self.linear.elements})
            nn, params = self.linear.to_atomic_nn(occurs)
            self._calc = TensorAlloyCalculator(nn, params)
        return self._calc.calculate(structure)

    def get_potential_energy(self, structure: Structure) -> float:
        return self.calculate(structure)["energy"]

    def get_forces(self, structure: Structure) -> np.ndarray:
        return self.calculate(structure)["forces"]

    def get_stress(self, structure: Structure) -> np.ndarray:
        return self.calculate(structure)["stress"]
