"""Behler-Parrinello symmetry-function descriptors on flat pair/triple
arrays (reference math: `tensoralloy/nn/atomic/sf.py:79-215`).

G2 (radial), for center i, k-body slot s (neighbor element class), and
parameter tau = (eta, omega):

    G2[i, s, tau] = sum_{j in s} exp(-eta (r_ij - omega)^2 / rc^2) fc(r_ij)

G4 (angular), slot s = unordered neighbor-element pair, tau = (beta,
gamma, zeta):

    G4[i, s, tau] = sum_{j<k in s} 2^(1-zeta) (1 + gamma cos t_ijk)^zeta
                    exp(-beta (r_ij^2 + r_ik^2 + r_jk^2)/rc^2)
                    fc(r_ij) fc(r_ik) fc(r_jk)

Instead of the reference's dense `[terms, atoms, nnl]` scatter layout,
each pair/triple contributes one `segment_sum` row keyed by
``atom_row * n_slots + slot`` — a single XLA scatter-add per descriptor.
Parameter-grid ordering matches the reference's sklearn `ParameterGrid`
(sorted keys, last key fastest) so feature columns line up.
"""
from __future__ import annotations

from itertools import product
import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cutoffs import apply_cutoff
from ..ops.pairs import pair_distances, triple_distances


class SymmetryFunction:
    """Config + pure compute for SF descriptors."""

    name = "SF"

    def __init__(self, elements, eta=(0.05, 4.0, 20.0, 80.0), omega=(0.0,),
                 beta=(0.005,), gamma=(1.0, -1.0), zeta=(1.0, 4.0),
                 cutoff_function: str = "cosine",
                 backend: str = "segment"):
        if backend not in ("segment", "dense"):
            raise ValueError(f"unknown descriptor backend {backend!r} "
                             "(choose 'segment' or 'dense')")
        self.backend = backend
        self.elements = sorted(elements)
        self.eta = np.asarray(eta, dtype=np.float64)
        self.omega = np.asarray(omega, dtype=np.float64)
        self.beta = np.asarray(beta, dtype=np.float64)
        self.gamma = np.asarray(gamma, dtype=np.float64)
        self.zeta = np.asarray(zeta, dtype=np.float64)
        self.cutoff_function = cutoff_function
        # sklearn ParameterGrid order: sorted keys, product with last
        # key fastest -> (eta slow, omega fast) / (beta, gamma, zeta).
        self.radial_grid = np.array(
            list(product(self.eta, self.omega)))       # [T2, 2]
        self.angular_grid = np.array(
            list(product(self.beta, self.gamma, self.zeta)))  # [T4, 3]

    @property
    def n_radial_params(self) -> int:
        return len(self.radial_grid)

    @property
    def n_angular_params(self) -> int:
        return len(self.angular_grid)

    def feature_dim(self, n_radial_slots: int, n_angular_slots: int,
                    angular: bool) -> int:
        dim = n_radial_slots * self.n_radial_params
        if angular:
            dim += n_angular_slots * self.n_angular_params
        return dim

    # working-set estimates for the trainer's chunked min/max sweep
    def sweep_bytes_per_pair(self, n_slots: int, itemsize: int = 4) -> int:
        return itemsize * 2 * self.n_radial_params * (n_slots + 1)

    def sweep_bytes_per_triple(self, n_slots: int,
                               itemsize: int = 4) -> int:
        return itemsize * 2 * self.n_angular_params * (n_slots + 1)

    # ------------------------------------------------------------------
    def radial(self, features, rcut: float, n_slots: int) -> jnp.ndarray:
        """-> [n_vap, n_slots * n_radial_params]."""
        n_vap = features["positions"].shape[0]
        dtype = features["positions"].dtype
        eta = jnp.asarray(self.radial_grid[:, 0], dtype)
        omega = jnp.asarray(self.radial_grid[:, 1], dtype)
        if self.backend == "dense":
            from ..ops.dense import (dense_pair_geometry,
                                     slot_onehot_dense, contract_slots)
            rij, _, islotf, mask = dense_pair_geometry(features)
            fc = apply_cutoff(self.cutoff_function, rij, rcut) * mask
            z = jnp.square(rij[..., None] - omega) / (rcut * rcut)
            v = jnp.exp(-eta * z) * fc[..., None]           # [A, N, T2]
            sel = slot_onehot_dense(islotf, mask, n_slots)
            g = contract_slots(sel, v)              # [A, S, T2] matmul
            # rij.shape[0] (not n_vap): row-chunked evaluation passes
            # a block of rows with full positions for the gathers
            return g.reshape(rij.shape[0],
                             n_slots * self.n_radial_params)
        _, rij = pair_distances(features)
        mask = features["pair_mask"]
        fc = apply_cutoff(self.cutoff_function, rij, rcut) * mask
        z = jnp.square(rij[:, None] - omega[None, :]) / (rcut * rcut)
        v = jnp.exp(-eta[None, :] * z) * fc[:, None]        # [nij, T2]
        seg = features["pair_i"] * n_slots + features["pair_islot"]
        g = jax.ops.segment_sum(v, seg, num_segments=n_vap * n_slots)
        return g.reshape(n_vap, n_slots * self.n_radial_params)

    def angular_values(self, rij, rik, rjk, mask, acut: float
                       ) -> jnp.ndarray:
        """Per-triple G4 values [..., T4] (any leading shape; shared by
        every backend)."""
        dtype = rij.dtype
        rij2, rik2, rjk2 = rij * rij, rik * rik, rjk * rjk
        z = (rij2 + rik2 + rjk2) / (acut * acut)
        cos_theta = (rij2 + rik2 - rjk2) / (2.0 * rij * rik)
        fc = (apply_cutoff(self.cutoff_function, rij, acut) *
              apply_cutoff(self.cutoff_function, rik, acut) *
              apply_cutoff(self.cutoff_function, rjk, acut) * mask)
        beta = jnp.asarray(self.angular_grid[:, 0], dtype)
        gamma = jnp.asarray(self.angular_grid[:, 1], dtype)
        zeta = jnp.asarray(self.angular_grid[:, 2], dtype)
        base = 1.0 + gamma * cos_theta[..., None]
        # base can dip slightly below 0 from fp error at theta ~ pi
        base = jnp.maximum(base, 0.0)
        outer = 2.0 ** (1.0 - zeta)
        return (outer * base ** zeta *
                jnp.exp(-beta * z[..., None]) * fc[..., None])

    def angular(self, features, acut: float, n_slots: int) -> jnp.ndarray:
        """-> [n_vap, n_slots * n_angular_params]."""
        n_vap = features["positions"].shape[0]
        if self.backend == "dense":
            from ..ops.dense import (dense_triple_geometry,
                                     slot_onehot_dense, contract_slots)
            rij, rik, rjk, aslotf, mask = dense_triple_geometry(features)
            v = self.angular_values(rij, rik, rjk, mask, acut)
            sel = slot_onehot_dense(aslotf, mask, n_slots)
            g = contract_slots(sel, v)
            return g.reshape(rij.shape[0],
                             n_slots * self.n_angular_params)
        rij, rik, rjk = triple_distances(features)
        mask = features["trip_mask"]
        v = self.angular_values(rij, rik, rjk, mask, acut)  # [nijk, T4]
        seg = features["trip_i"] * n_slots + features["trip_aslot"]
        g = jax.ops.segment_sum(v, seg, num_segments=n_vap * n_slots)
        return g.reshape(n_vap, n_slots * self.n_angular_params)

    # ------------------------------------------------------------------
    def init_params(self, key) -> dict:
        return {}

    def compute(self, features, rcut: float, acut: float,
                n_radial_slots: int, n_angular_slots: int,
                angular: bool, params=None,
                vap_element_idx=None) -> jnp.ndarray:
        g = self.radial(features, rcut, n_radial_slots)
        if angular:
            g4 = self.angular(features, acut, n_angular_slots)
            g = jnp.concatenate([g, g4], axis=1)
        return g

    def as_dict(self) -> dict:
        return {"class": "SymmetryFunction", "elements": self.elements,
                "eta": self.eta.tolist(), "omega": self.omega.tolist(),
                "beta": self.beta.tolist(), "gamma": self.gamma.tolist(),
                "zeta": self.zeta.tolist(),
                "cutoff_function": self.cutoff_function,
                "backend": self.backend}
