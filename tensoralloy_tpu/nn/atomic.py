"""Per-atom descriptor NN potential (the reference's `AtomicNN`,
`tensoralloy/nn/atomic/atomic.py`).

Architecture: descriptors g_i -> optional min-max scaling -> per-element
MLP -> atomic energy; total energy is the masked sum. The VAP layout
makes each element's atoms a *static* row slice, so "per-element MLP"
compiles to one dense matmul chain per element — no gather,
no dynamic partition (contrast `nn/partition.py:18-139` in the
reference).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..transform.featurizer import Featurizer
from ..utils import Defaults
from .layers import (apply_dense_stack, init_dense_stack, l2_of_stack,
                     freeze_output_bias, minmax_normalize_apply,
                     minmax_normalize_init)


class AtomicNN:
    """Config object; all compute methods are pure functions of params."""

    def __init__(self,
                 featurizer: Featurizer,
                 max_occurs: Counter,
                 descriptor,
                 hidden_sizes: Union[Sequence[int], Dict[str, Sequence[int]],
                                     None] = None,
                 activation: str = Defaults.activation,
                 use_resnet_dt: bool = True,
                 minmax_scale: bool = True,
                 atomic_static_energy: Optional[Dict[str, float]] = None,
                 fixed_static_energy: bool = False,
                 kernel_initializer: str = "he_normal"):
        self.featurizer = featurizer
        self.max_occurs = Counter(max_occurs)
        self.descriptor = descriptor
        self.elements: List[str] = featurizer.elements
        if hidden_sizes is None:
            hidden_sizes = Defaults.hidden_sizes
        if not isinstance(hidden_sizes, dict):
            hidden_sizes = {e: list(hidden_sizes) for e in self.elements}
        self.hidden_sizes = hidden_sizes
        self.activation = activation
        self.use_resnet_dt = use_resnet_dt
        self.minmax_scale = minmax_scale
        self.atomic_static_energy = dict(atomic_static_energy or {})
        self.fixed_static_energy = fixed_static_energy
        self.kernel_initializer = kernel_initializer

        # static VAP row layout
        offset = 1
        self.layout: Dict[str, tuple] = {}
        for e in self.elements:
            cnt = int(self.max_occurs.get(e, 0))
            self.layout[e] = (offset, cnt)
            offset += cnt
        self.n_atoms_vap = offset

        self.feature_dim = descriptor.feature_dim(
            featurizer.n_radial_slots, featurizer.n_angular_slots,
            featurizer.angular)

        # static: element index of every VAP row (X row -> 0, masked)
        vei = np.zeros(self.n_atoms_vap, dtype=np.int32)
        for e in self.elements:
            lo, cnt = self.layout[e]
            vei[lo:lo + cnt] = self.elements.index(e)
        self.vap_element_idx = vei

    # ------------------------------------------------------------------
    def clone_for(self, max_occurs: Counter) -> "AtomicNN":
        """Same weights/hyperparams, different VAP row layout.

        Params are layout-independent (per-element MLPs), so inference
        on an arbitrary stoichiometry re-lays-out the model and reuses
        the trained params unchanged."""
        return type(self)(self.featurizer, max_occurs, self.descriptor,
                          hidden_sizes=self.hidden_sizes,
                          activation=self.activation,
                          use_resnet_dt=self.use_resnet_dt,
                          minmax_scale=self.minmax_scale,
                          atomic_static_energy=self.atomic_static_energy,
                          fixed_static_energy=self.fixed_static_energy,
                          kernel_initializer=self.kernel_initializer)

    def init_params(self, key) -> dict:
        params = {}
        key, sub = jax.random.split(key)
        dparams = self.descriptor.init_params(sub)
        if dparams:
            params["descriptor"] = dparams
        for e in self.elements:
            key, sub = jax.random.split(key)
            bias0 = float(self.atomic_static_energy.get(e, 0.0))
            p = {"mlp": init_dense_stack(
                sub, self.feature_dim, self.hidden_sizes[e], out_dim=1,
                output_bias=True, output_bias_mean=bias0,
                resnet_dt=self.use_resnet_dt,
                kernel_init=self.kernel_initializer)}
            if self.minmax_scale:
                p["norm"] = minmax_normalize_init(
                    self.feature_dim, p["mlp"]["layers"][0]["w"].dtype)
            params[e] = p
        return params

    # ------------------------------------------------------------------
    def descriptors(self, features, params: dict = None) -> jnp.ndarray:
        f = self.featurizer
        return self.descriptor.compute(
            features, f.rcut, f.acut, f.n_radial_slots, f.n_angular_slots,
            f.angular, params=(params or {}).get("descriptor"),
            vap_element_idx=self.vap_element_idx)

    def atomic_energies(self, params: dict, features) -> jnp.ndarray:
        """-> [n_vap] atomic energies (zero at padding rows)."""
        g = self.descriptors(features, params)
        out = jnp.zeros((self.n_atoms_vap,), g.dtype)
        for e in self.elements:
            lo, cnt = self.layout[e]
            if cnt == 0:
                continue
            x = jax.lax.dynamic_slice_in_dim(g, lo, cnt, axis=0)
            if self.minmax_scale:
                x = minmax_normalize_apply(params[e]["norm"], x)
            mlp = params[e]["mlp"]
            if self.fixed_static_energy:
                mlp = freeze_output_bias(mlp)
            y = apply_dense_stack(mlp, x, self.activation)[:, 0]
            out = jax.lax.dynamic_update_slice_in_dim(out, y, lo, axis=0)
        return out * features["atom_masks"]

    def energy(self, params: dict, features) -> jnp.ndarray:
        """Total potential energy (scalar)."""
        return jnp.sum(self.atomic_energies(params, features))

    # -- atom-chunked evaluation (large-cell single-chip inference) ----
    def _chunk_blocks(self, features, atom_chunk: int):
        """Shared guards + dense per-atom row blocking for the chunked
        evaluators: returns `(base, blocks, chunk, d_keys)` where
        `blocks` stacks every row-indexed array into
        `[n_blocks, chunk, ...]` (zero-padded final block) plus the
        per-row positions/masks/element-index companions."""
        if getattr(self.descriptor, "algorithm", None) == "nn":
            raise NotImplementedError(
                "chunked evaluation with learned ('nn') GRAP filters "
                "is not supported — the rcov channel indexes the full "
                "VAP layout")
        if getattr(self.descriptor, "backend", "segment") == "segment":
            raise ValueError(
                "energy_chunked requires a dense-layout descriptor "
                "backend ('dense'); the flat segment "
                "layout cannot be row-chunked")
        d_keys = [k for k in features if k.endswith("_d")]
        if "pair_j_d" not in features:
            raise KeyError("energy_chunked needs the dense layout "
                           "('pair_j_d' ...)")
        a_tot = features["pair_j_d"].shape[0]
        chunk = int(min(atom_chunk, a_tot))
        n_blocks = -(-a_tot // chunk)
        pad = n_blocks * chunk - a_tot
        base = {k: v for k, v in features.items() if k not in d_keys}

        def blocked(v):
            if pad:
                width = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
                v = jnp.pad(v, width)
            return v.reshape((n_blocks, chunk) + v.shape[1:])

        blocks = {k: blocked(features[k]) for k in d_keys}
        blocks["positions_rows"] = blocked(features["positions"])
        blocks["atom_masks_rows"] = blocked(features["atom_masks"])
        eidx = jnp.asarray(self.vap_element_idx, jnp.int32)
        blocks["eidx_rows"] = blocked(eidx)
        return base, blocks, chunk, d_keys

    def energy_chunked(self, params: dict, features,
                       atom_chunk: int = 4096) -> jnp.ndarray:
        """Total energy with the dense per-atom layout processed in
        rematerialized `lax.scan` row blocks: descriptors + per-element
        MLPs for `atom_chunk` atoms at a time, `jax.checkpoint` per
        block, so the force/stress backward holds one block instead of
        the full [A, N, D] descriptor intermediates.  Equal to `energy`
        up to float summation order; requires the dense featurizer
        layout.  (The 128k-atom regime: reference `cpc_speed.py:36-74`
        ran its NN model at this size on an 11 GB GPU.)"""
        base, blocks, chunk, d_keys = self._chunk_blocks(
            features, atom_chunk)

        @jax.checkpoint
        def body(carry, blk):
            f = dict(base)
            f.update({k: blk[k] for k in d_keys})
            f["positions_rows"] = blk["positions_rows"]
            g = self.descriptors(f, params)          # [chunk, D]
            y_rows = jnp.zeros((chunk,), g.dtype)
            for t, e in enumerate(self.elements):
                if self.max_occurs.get(e, 0) == 0:
                    continue
                x = g
                if self.minmax_scale:
                    x = minmax_normalize_apply(params[e]["norm"], x)
                mlp = params[e]["mlp"]
                if self.fixed_static_energy:
                    mlp = freeze_output_bias(mlp)
                y = apply_dense_stack(mlp, x, self.activation)[:, 0]
                y_rows = jnp.where(blk["eidx_rows"] == t, y, y_rows)
            e_blk = jnp.sum(y_rows * blk["atom_masks_rows"])
            return carry + e_blk, None

        total, _ = jax.lax.scan(body, jnp.zeros((), dtype=jnp.asarray(
            features["positions"]).dtype), blocks)
        return total

    def make_chunked_energy_fn(self, atom_chunk: int = 4096):
        return lambda p, f: self.energy_chunked(p, f, atom_chunk)

    # `variational_energy` is what forces/stress differentiate; for the
    # plain AtomicNN it IS the energy (reference `basic.py:190-202`).
    variational_energy = energy

    def l2_loss(self, params: dict) -> jnp.ndarray:
        total = sum(l2_of_stack(params[e]["mlp"])
                    for e in self.elements)
        # trainable descriptor stacks (GRAP algorithm='nn' filters)
        # are part of the model and must be regularized too
        for stack in (params.get("descriptor") or {}).values():
            if isinstance(stack, dict) and "layers" in stack:
                total = total + l2_of_stack(stack)
        return total

    # ------------------------------------------------------------------
    def norm_sweep_bytes_per_structure(self, feats) -> int:
        """Working-set estimate (bytes) for ONE structure inside the
        vmapped descriptor compute — used by the trainer to chunk the
        whole-set min/max sweep so it cannot OOM at large padding."""
        if "pair_j_d" in feats:
            sh = feats["pair_j_d"].shape
            pairs = int(sh[-2]) * int(sh[-1])
        elif "pair_i" in feats:
            pairs = int(feats["pair_i"].shape[-1])
        else:
            return 0
        per_pair = getattr(self.descriptor, "sweep_bytes_per_pair", None)
        total = (pairs * per_pair(self.featurizer.n_radial_slots)
                 if per_pair is not None else pairs * 512)
        if "trip_j_d" in feats:
            sh = feats["trip_j_d"].shape
            triples = int(sh[-2]) * int(sh[-1])
            per_trip = getattr(self.descriptor, "sweep_bytes_per_triple",
                               None)
            total += (triples * per_trip(self.featurizer.n_angular_slots)
                      if per_trip is not None else triples * 256)
        return total

    def update_norm_stats(self, params: dict, features_batch) -> dict:
        """Running min/max of descriptors over a batch (host-called;
        reference keeps xlo/xhi as running non-trainable variables)."""
        g = jax.vmap(lambda f: self.descriptors(f, params))(
            features_batch)  # [B, n_vap, D]
        masks = features_batch["atom_masks"]
        params = jax.tree_util.tree_map(lambda x: x, params)  # shallow copy
        for e in self.elements:
            lo, cnt = self.layout[e]
            if cnt == 0 or not self.minmax_scale:
                continue
            ge = g[:, lo:lo + cnt].reshape(-1, g.shape[-1])
            me = masks[:, lo:lo + cnt].reshape(-1) > 0
            big = jnp.where(me[:, None], ge, -jnp.inf).max(0)
            small = jnp.where(me[:, None], ge, jnp.inf).min(0)
            norm = params[e]["norm"]
            params[e] = dict(params[e])
            params[e]["norm"] = {
                "xlo": jnp.minimum(norm["xlo"], small),
                "xhi": jnp.maximum(norm["xhi"], big)}
        return params

    def as_dict(self) -> dict:
        return {"class": "AtomicNN",
                "featurizer": self.featurizer.as_dict(),
                "max_occurs": dict(self.max_occurs),
                "descriptor": self.descriptor.as_dict(),
                "hidden_sizes": self.hidden_sizes,
                "activation": self.activation,
                "use_resnet_dt": self.use_resnet_dt,
                "minmax_scale": self.minmax_scale,
                "atomic_static_energy": self.atomic_static_energy,
                "fixed_static_energy": self.fixed_static_energy}
