"""GRAP — Generic Radial Atomic Potential descriptors
(reference `tensoralloy/nn/atomic/grap.py`).

Radial filter bank H x moment-tensor basis M -> rotation-invariant
per-atom features:

    P[i, s, k, d] = sum_{j in s} H_k(r_ij) fc(r_ij) M_d(r̂_ij)
    S = P^2;  Q[i, s, k, m] = sum_d S[i, s, k, d] T[d, m]
    G = [sign(P_0) sqrt(Q_0 + eps), Q_1, ..., Q_mm]

with T the multiplicity tensor over the compressed monomial basis
(moments <= 3: unique components x counts, optional traceless
"symmetric" correction; moments 4-5: full outer-product basis).

In the flat-pair layout the whole descriptor is one elementwise filter
bank + one `segment_sum` of the H (x) M outer product; the 'dense'
backend turns the sum into a per-atom contraction that XLA fuses with
the filter bank.

Radial algorithms: 'sf' (eta, omega), 'density' (A, beta, re), 'morse'
(D, gamma, r0), 'pexp' (rl, pl), or 'nn' (learned filter MLP, shared
across elements, input optionally scaled by the center element's
covalent radius).
"""
from __future__ import annotations

from itertools import product as iter_product
from typing import List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..elements import atomic_numbers, covalent_radii
from ..ops.cutoffs import apply_cutoff
from ..ops.generic import density_exp, morse, power_exp
from ..ops.pairs import pair_vectors, safe_norm
from .layers import apply_dense_stack, init_dense_stack

_ALGO_KEYS = {
    "sf": ["eta", "omega"],
    "density": ["A", "beta", "re"],
    "morse": ["D", "gamma", "r0"],
    "pexp": ["pl", "rl"],
}


def _param_grid(algorithm: str, parameters: dict, method: str) -> np.ndarray:
    """[K, n_keys] parameter table; 'cross' = product over sorted keys
    (sklearn ParameterGrid order), 'pair' = aligned lists."""
    keys = sorted(_ALGO_KEYS[algorithm])
    cols = [np.atleast_1d(np.asarray(parameters[k], np.float64))
            for k in keys]
    if method == "cross":
        rows = np.array(list(iter_product(*cols)))
    else:
        n = {len(c) for c in cols}
        if len(n) > 1:
            raise ValueError("pair param space needs equal-length lists")
        rows = np.stack(cols, axis=1)
    return rows, keys


# ----------------------------------------------------------------------
# Compressed monomial bases and multiplicity tensors
# ----------------------------------------------------------------------

_AB = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
_AB_MULT = [1, 2, 2, 1, 2, 1]
_ABC = [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 1), (0, 1, 2),
        (0, 2, 2), (1, 1, 1), (1, 1, 2), (1, 2, 2), (2, 2, 2)]
_ABC_MULT = [1, 3, 3, 3, 6, 3, 1, 3, 3, 1]

_FULL_DIMS = {0: 1, 1: 4, 2: 13, 3: 40, 4: 121, 5: 364}
_COMPRESSED_DIMS = {0: 1, 1: 4, 2: 10, 3: 20}


def moment_monomials(max_moment: int):
    """Unique (sorted) monomial index tuples per degree 0..max_moment:
    [(), (0,), (1,), (2,), (0,0), (0,1), ...] — C(m+2,2) per degree m
    (56 total at moment 5 vs 364 in the full outer-product basis)."""
    from itertools import combinations_with_replacement
    cols = [()]
    for m in range(1, max_moment + 1):
        cols += [tuple(c)
                 for c in combinations_with_replacement(range(3), m)]
    return cols


def multiplicity_tensor(max_moment: int, symmetric: bool = False
                        ) -> np.ndarray:
    """T[d, m] over the compressed unique-monomial basis (reference
    `grap.py:470-495`): each squared monomial sum enters its moment's
    rotational invariant with its multinomial multiplicity
    m!/(cx! cy! cz!) — identical invariants to the full 3^m
    outer-product contraction at a fraction of the compute/memory.
    The symmetric (trace-removal) corrections exist for moments 2-3
    only, as in the reference."""
    from math import factorial
    cols = moment_monomials(max_moment)
    t = np.zeros((len(cols), max_moment + 1))
    for d, mono in enumerate(cols):
        m = len(mono)
        mult = factorial(m)
        for ax in range(3):
            mult //= factorial(mono.count(ax))
        t[d, m] = float(mult)
    if symmetric:
        if max_moment >= 2:
            t[0, 2] = -1.0 / 3.0
        if max_moment >= 3:
            t[1:4, 3] = -3.0 / 5.0
    return t


def full_multiplicity_tensor(max_moment: int) -> np.ndarray:
    """Indicator T over the full outer-product basis
    (reference `grap.py:576-594`)."""
    dims = [1, 4, 13, 40, 121, 364]
    d = dims[max_moment]
    t = np.zeros((d, max_moment + 1))
    bounds = [0, 1, 4, 13, 40, 121, 364]
    for m in range(max_moment + 1):
        t[bounds[m]:bounds[m + 1], m] = 1.0
    return t


def moment_basis_c(comps, max_moment: int) -> jnp.ndarray:
    """M [..., D] from unit-vector COMPONENT arrays (ux, uy, uz):
    unique monomials (compressed basis for every moment; pairs with
    `multiplicity_tensor`).  At moment 5 this is 56 columns instead of
    the 364-column full outer-product basis — same invariants, ~6.5x
    less einsum/memory traffic in the dense path.  Components-in keeps
    every operand 2-D (no [*, 3]-minor arrays; see `ops/dense.py`)."""
    ux = comps[0]
    ones = jnp.ones(ux.shape, ux.dtype)
    cols = [ones]
    if max_moment >= 1:
        cols += [comps[0], comps[1], comps[2]]                  # x y z
    # degree-m columns from sorted degree-(m-1) tuples x one more
    # component >= the tuple's last — cache products by tuple
    prods = {(a,): comps[a] for a in range(3)}
    for mono in moment_monomials(max_moment):
        if len(mono) < 2:
            continue
        prods[mono] = prods[mono[:-1]] * comps[mono[-1]]
        cols.append(prods[mono])
    return jnp.stack(cols, axis=-1)


def moment_basis(unit: jnp.ndarray, max_moment: int) -> jnp.ndarray:
    """M [nij, D] from a stacked [nij, 3] unit array (segment/flat
    layout, where pair vectors are already [nij, 3] floats)."""
    return moment_basis_c(
        (unit[:, 0], unit[:, 1], unit[:, 2]), max_moment)


def moment_basis_c_t(comps, max_moment: int) -> jnp.ndarray:
    """moment_basis_c with the monomial axis on AXIS 1: [A, D, N] from
    (ux, uy, uz) [A, N] components — the lane axis stays NNL, so the
    D-column basis sublane-pads (<=1.2x) instead of lane-padding
    (up to 6.4x at D=20)."""
    ux = comps[0]
    cols = [jnp.ones_like(ux)]
    if max_moment >= 1:
        cols += [comps[0], comps[1], comps[2]]
    prods = {(a,): comps[a] for a in range(3)}
    for mono in moment_monomials(max_moment):
        if len(mono) < 2:
            continue
        prods[mono] = prods[mono[:-1]] * comps[mono[-1]]
        cols.append(prods[mono])
    return jnp.stack(cols, axis=1)


# Orientation of the dense descriptor contraction:
#   'lane-k' — einsum('ajx,ajd->axd'): filters K and monomials D are
#              the minor axes (the default).
#   'lane-n' — einsum('akn,adn->akd'): the neighbor axis NNL is the
#              minor axis; grid algorithms only ('nn' filter MLPs need
#              the [*, K] matmul layout). Values identical (pinned) in
#              exact float32; the contraction over NNL is
#              matmul-shaped, so at default matmul precision a GPU may
#              run it in TF32 — a flip for serving must pin the einsum
#              at highest precision. Never measured on a GPU; the
#              switch goes or stays on a measurement.
DENSE_ORIENTATION = "lane-k"


# ----------------------------------------------------------------------
class GenericRadialAtomicPotential:
    """Config + pure compute for GRAP descriptors."""

    name = "GRAP"

    def __init__(self, elements: List[str], algorithm: str = "sf",
                 parameters: Optional[dict] = None,
                 param_space_method: str = "pair",
                 moment_tensors: Union[int, List[int]] = 0,
                 cutoff_function: str = "cosine",
                 symmetric: bool = False,
                 legacy_mode: bool = False,
                 backend: str = "segment"):
        if backend not in ("segment", "dense"):
            raise ValueError(f"unknown descriptor backend {backend!r} "
                             "(choose 'segment' or 'dense')")
        if backend != "segment" and legacy_mode:
            raise ValueError("legacy GRAP supports only backend='segment'")
        self.backend = backend
        self.elements = sorted(elements)
        self.algorithm = algorithm
        self.parameters = parameters or {}
        self.param_space_method = param_space_method
        if isinstance(moment_tensors, int):
            moment_tensors = [moment_tensors]
        self.moment_tensors = sorted(set(moment_tensors))
        self.max_moment = max(self.moment_tensors)
        self.cutoff_function = cutoff_function
        self.symmetric = symmetric
        self.legacy_mode = legacy_mode

        if algorithm == "nn":
            if legacy_mode:
                raise ValueError("NN filters require non-legacy GRAP")
            p = self.parameters
            self.nn_hidden = list(p.get("hidden_sizes", [32, 32, 32]))
            self.nn_activation = p.get("activation", "softplus")
            self.nn_filters = int(p.get("num_filters", 16))
            self.nn_resnet_dt = bool(p.get("use_resnet_dt", True))
            self.h_modifier = int(p.get("h_abck_modifier", 0))
            self.n_filters = self.nn_filters
            self._grid = None
        else:
            self._grid, self._grid_keys = _param_grid(
                algorithm, self.parameters, param_space_method)
            self.n_filters = len(self._grid)

    # ------------------------------------------------------------------
    def sweep_bytes_per_pair(self, n_slots: int, itemsize: int = 4) -> int:
        """Per-pair working bytes of one descriptor evaluation: the
        moment basis [pairs, D], the slot-expanded filters
        [pairs, S*K], and a 2x allowance for XLA temporaries.  Used to
        chunk the training-set min/max sweep."""
        d = multiplicity_tensor(self.max_moment, self.symmetric).shape[0]
        k = self.n_filters
        return itemsize * 2 * (d + k * (n_slots + 1))

    def feature_dim(self, n_radial_slots: int, n_angular_slots: int,
                    angular: bool) -> int:
        if self.legacy_mode:
            return n_radial_slots * self.n_filters * len(self.moment_tensors)
        return n_radial_slots * self.n_filters * (self.max_moment + 1)

    def init_params(self, key) -> dict:
        if self.algorithm != "nn":
            return {}
        return {"filters": init_dense_stack(
            key, 1, self.nn_hidden, out_dim=self.nn_filters,
            output_bias=False, resnet_dt=self.nn_resnet_dt)}

    # ------------------------------------------------------------------
    def _filter_values(self, rij: jnp.ndarray, rcut: float,
                       params: Optional[dict],
                       rcov_per_pair: Optional[jnp.ndarray]) -> jnp.ndarray:
        """H [nij, K] before cutoff."""
        if self.algorithm == "nn":
            x = rij
            if self.h_modifier == 1:
                x = rij / rcov_per_pair
            elif self.h_modifier == 2:
                x = jnp.exp(-rij / rcov_per_pair)
            return apply_dense_stack(params["filters"], x[:, None],
                                     self.nn_activation)
        g = self._grid
        dtype = rij.dtype
        cols = {k: jnp.asarray(g[:, i], dtype)
                for i, k in enumerate(self._grid_keys)}
        r = rij[:, None]
        if self.algorithm == "sf":
            return jnp.exp(-cols["eta"] * jnp.square(r - cols["omega"]) /
                           (rcut * rcut))
        if self.algorithm == "density":
            return density_exp(r, cols["A"], cols["beta"], cols["re"])
        if self.algorithm == "morse":
            return morse(r, cols["D"], cols["gamma"], cols["r0"])
        if self.algorithm == "pexp":
            return power_exp(r, cols["rl"], cols["pl"])
        raise ValueError(self.algorithm)

    # ------------------------------------------------------------------
    def invariants_from_p(self, p: jnp.ndarray, n_vap: int,
                          n_slots: int) -> jnp.ndarray:
        """Shared tail: P [n_vap*n_slots, K, D] -> G (all backends)."""
        s = jnp.square(p)
        t = jnp.asarray(multiplicity_tensor(self.max_moment, self.symmetric),
                        p.dtype)
        q = s @ t                                      # [nseg, K, mm+1]
        eps = 1e-16
        g0 = jnp.sign(p[..., 0]) * jnp.sqrt(q[..., 0] + eps)
        g = jnp.concatenate([g0[..., None], q[..., 1:]], axis=-1)
        if self.moment_tensors != list(range(self.max_moment + 1)):
            # honor gaps in the requested list (e.g. [0, 2]) exactly
            # like legacy mode — emit only the requested moments
            g = g[..., jnp.asarray(self.moment_tensors)]
        return g.reshape(n_vap, n_slots * self.n_filters *
                         len(self.moment_tensors))

    def compute(self, features, rcut: float, acut: float,
                n_radial_slots: int, n_angular_slots: int, angular: bool,
                params: Optional[dict] = None,
                vap_element_idx: Optional[np.ndarray] = None) -> jnp.ndarray:
        if self.backend == "dense":
            return self._compute_dense(features, rcut, n_radial_slots,
                                       params, vap_element_idx)

        vec = pair_vectors(features)
        mask = features["pair_mask"]
        rij = safe_norm(vec)
        rij = jnp.where(mask > 0, rij, 1.0)
        unit = vec / rij[:, None]
        fc = apply_cutoff(self.cutoff_function, rij, rcut) * mask

        rcov_pp = None
        if self.algorithm == "nn" and self.h_modifier != 0:
            rcov_vap = jnp.asarray(
                covalent_radii[[atomic_numbers[self.elements[i]]
                                for i in np.asarray(vap_element_idx)]],
                rij.dtype)
            rcov_pp = rcov_vap[features["pair_i"]]

        h = self._filter_values(rij, rcut, params, rcov_pp) * fc[:, None]

        n_vap = features["positions"].shape[0]
        seg = features["pair_i"] * n_radial_slots + features["pair_islot"]
        nseg = n_vap * n_radial_slots

        if self.legacy_mode:
            return self._legacy(h, unit, seg, nseg, n_vap, n_radial_slots)

        m = moment_basis(unit, self.max_moment)        # [nij, D]
        hm = h[:, :, None] * m[:, None, :]             # [nij, K, D]
        p = jax.ops.segment_sum(hm, seg, num_segments=nseg)
        return self.invariants_from_p(p, n_vap, n_radial_slots)

    def _filter_values_t(self, rij: jnp.ndarray, rcut: float
                         ) -> jnp.ndarray:
        """H as K stacked [A, N] maps -> [A, K, N] (lane axis = NNL):
        no [.., K]-minor array ever exists, so nothing lane-pads
        K -> 128. Grid algorithms only (the 'nn' filter MLP needs the
        [*, K] matmul layout)."""
        g = self._grid
        cols = {k: np.asarray(g[:, i], np.float64)
                for i, k in enumerate(self._grid_keys)}

        def one(k):
            if self.algorithm == "sf":
                return jnp.exp(-float(cols["eta"][k]) *
                               jnp.square(rij - float(cols["omega"][k]))
                               / (rcut * rcut))
            if self.algorithm == "density":
                return density_exp(rij, float(cols["A"][k]),
                                   float(cols["beta"][k]),
                                   float(cols["re"][k]))
            if self.algorithm == "morse":
                return morse(rij, float(cols["D"][k]),
                             float(cols["gamma"][k]),
                             float(cols["r0"][k]))
            if self.algorithm == "pexp":
                return power_exp(rij, float(cols["rl"][k]),
                                 float(cols["pl"][k]))
            raise ValueError(self.algorithm)

        return jnp.stack([one(k) for k in range(self.n_filters)], axis=1)

    def _compute_dense_t(self, features, rcut: float, n_slots: int
                         ) -> jnp.ndarray:
        """[A, C, N]-oriented dense path (DENSE_ORIENTATION='lane-n'):
        every per-pair operand carries NNL on the minor axis instead
        of the K=16 / D<=56 filter and monomial axes. Values identical
        to `_compute_dense` (pinned by test_backends)."""
        from ..ops.dense import dense_pair_geometry
        rij, unit, islotf, mask = dense_pair_geometry(features)
        a, n = rij.shape
        fc = apply_cutoff(self.cutoff_function, rij, rcut) * mask
        h = self._filter_values_t(rij, rcut) * fc[:, None, :]  # [A,K,N]
        m = moment_basis_c_t(unit, self.max_moment)            # [A,D,N]
        k = self.n_filters
        if n_slots > 1:
            # masked one-hot slot selection, per-slot [A, N] maps
            # (slot_onehot_dense semantics without the [.., S]-minor
            # array)
            sel = [(islotf == s).astype(h.dtype) * mask
                   for s in range(n_slots)]
            hs = jnp.concatenate([h * s_[:, None, :] for s_ in sel],
                                 axis=1)                       # [A,S*K,N]
        else:
            hs = h
        p = jnp.einsum("akn,adn->akd", hs, m,
                       preferred_element_type=m.dtype)
        p = p.reshape(a * n_slots, k, m.shape[1])
        return self.invariants_from_p(p, a, n_slots)

    def _compute_dense(self, features, rcut: float, n_slots: int,
                       params=None, vap_element_idx=None) -> jnp.ndarray:
        """Dense per-atom layout: the (pairs x filters x monomials)
        reduction becomes ONE batched matmul over the neighbor axis —
        gathers only, no scatter, no [nij, K, D] intermediate in
        device memory."""
        from ..ops.dense import dense_pair_geometry, slot_onehot_dense
        if DENSE_ORIENTATION == "lane-n" and self.algorithm != "nn":
            return self._compute_dense_t(features, rcut, n_slots)
        rij, unit, islotf, mask = dense_pair_geometry(features)
        a, n = rij.shape
        fc = apply_cutoff(self.cutoff_function, rij, rcut) * mask

        rcov_pp = None
        if self.algorithm == "nn" and self.h_modifier != 0:
            rcov_vap = jnp.asarray(
                covalent_radii[[atomic_numbers[self.elements[i]]
                                for i in np.asarray(vap_element_idx)]],
                rij.dtype)
            rcov_pp = rcov_vap[:, None] * jnp.ones_like(rij)

        flat = lambda x: x.reshape((a * n,) + x.shape[2:])
        h = self._filter_values(
            flat(rij), rcut, params,
            flat(rcov_pp) if rcov_pp is not None else None)
        h = h.reshape(a, n, -1) * fc[..., None]        # [A, N, K]
        # unit is a (ux, uy, uz) component tuple [A, N] — the monomial
        # basis is built per component so no [*, 3] operand exists
        m = moment_basis_c(unit, self.max_moment)      # [A, N, D]
        k = self.n_filters
        sel = slot_onehot_dense(islotf, mask, n_slots)  # [A, N, S]
        hs = (sel[..., None] * h[..., None, :]).reshape(a, n, n_slots * k)
        p = jnp.einsum("ajx,ajd->axd", hs, m,
                       preferred_element_type=m.dtype)
        p = p.reshape(a * n_slots, k, m.shape[-1])
        return self.invariants_from_p(p, a, n_slots)

    def _legacy(self, h, unit, seg, nseg, n_vap, n_slots) -> jnp.ndarray:
        """Legacy per-kbody-term scalar contractions
        (reference `grap.py:384-468`): per tau and moment,
        0: sum, 1: sum_a (sum_j h u_a)^2, 2: sum_ab (sum_j h u_a u_b)^2
        over all 9 ordered (a, b)."""
        outs = []
        for moment in self.moment_tensors:
            if moment == 0:
                g = jax.ops.segment_sum(h, seg, num_segments=nseg)
            elif moment == 1:
                hm = h[:, :, None] * unit[:, None, :]
                p = jax.ops.segment_sum(hm, seg, num_segments=nseg)
                g = jnp.sum(jnp.square(p), axis=-1)
            elif moment == 2:
                ab = unit[:, :, None] * unit[:, None, :]   # [nij, 3, 3]
                hm = h[:, :, None] * ab.reshape(-1, 9)[:, None, :]
                p = jax.ops.segment_sum(hm, seg, num_segments=nseg)
                g = jnp.sum(jnp.square(p), axis=-1)
            else:
                raise ValueError("legacy GRAP supports moments 0-2")
            outs.append(g)
        g = jnp.stack(outs, axis=-1)   # [nseg, K, n_moments]
        return g.reshape(n_vap, n_slots * self.n_filters *
                         len(self.moment_tensors))

    # ------------------------------------------------------------------
    def as_dict(self) -> dict:
        return {"class": "GenericRadialAtomicPotential",
                "elements": self.elements,
                "algorithm": self.algorithm,
                "parameters": self.parameters,
                "param_space_method": self.param_space_method,
                "moment_tensors": self.moment_tensors,
                "cutoff_function": self.cutoff_function,
                "symmetric": self.symmetric,
                "legacy_mode": self.legacy_mode,
                "backend": self.backend}

    @classmethod
    def from_dict(cls, d: dict) -> "GenericRadialAtomicPotential":
        return cls(elements=d["elements"], algorithm=d["algorithm"],
                   parameters=d.get("parameters"),
                   param_space_method=d.get("param_space_method", "pair"),
                   moment_tensors=d.get("moment_tensors", 0),
                   cutoff_function=d.get("cutoff_function", "cosine"),
                   symmetric=d.get("symmetric", False),
                   legacy_mode=d.get("legacy_mode", False),
                   backend=d.get("backend", "segment"))
