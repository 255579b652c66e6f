"""Featurization: structures -> fixed-shape device arrays.

This is the re-design of the reference's transformer layer
(`tensoralloy/transformer/universal.py`). The reference scatters pair
data into a dense ``[4, n_terms, n_atoms_vap, nnl_max, 1]`` g-tensor;
here we keep **flat padded pair/triple index arrays** and let the model
do `segment_sum` reductions on device — less padding waste, XLA-friendly
scatter-adds, and autodiff-transparent.

Host side produces only *indices and shifts* (int32 / small floats);
interatomic distances are always recomputed on device from positions so
forces/stress flow through `jax.grad` (same trade the reference makes
for training, `universal.py:1086-1112`).

Shape contract (`Features` dict):
  positions   [n_vap, 3]        VAP layout, row 0 = virtual atom
  cell        [3, 3]
  atom_masks  [n_vap]           1.0 for real atoms
  n_atoms     []                number of real atoms (int32)
  etemperature []               electron temperature (eV), optional
  pair_i / pair_j       [nij]   int32 VAP rows (0 for padding)
  pair_shift  [nij, 3]          integer cell shifts (float dtype)
  pair_islot  [nij]   int32     radial slot within center element's terms
  pair_term   [nij]   int32     global radial k-body term id
  pair_mask   [nij]             1.0 for real pairs
  (angular only)
  trip_i / trip_j / trip_k  [nijk] int32 VAP rows
  trip_shift_j / trip_shift_k [nijk, 3]
  trip_aslot  [nijk]  int32     angular slot within center element's terms
  trip_mask   [nijk]
"""
from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ..atoms import Structure
from ..neighbor import neighbor_list, find_neighbor_size_of_atoms, NeighborSize
from ..utils import get_kbody_terms
from ..vap import VirtualAtomMap

Features = Dict[str, np.ndarray]


class Featurizer:
    """Stateless structure->arrays transformer (UniversalTransformer role).

    Parameters
    ----------
    elements : supported chemical symbols (defines term tables & layout).
    rcut : radial cutoff (Angstrom).
    acut : angular cutoff; defaults to ``rcut`` when ``angular``.
    angular : build 3-body triples.
    symmetric : merge jk/kj angular classes (reference default True).
    """

    def __init__(self, elements: List[str], rcut: float,
                 acut: Optional[float] = None, angular: bool = False,
                 symmetric: bool = True, periodic: bool = True):
        all_terms, terms_per_elem, elements = get_kbody_terms(
            elements, angular=angular, symmetric=symmetric)
        self.elements = elements
        self.n_elements = len(elements)
        self.rcut = float(rcut)
        self.acut = float(acut if acut else rcut) if angular else 0.0
        self.angular = bool(angular)
        self.symmetric = bool(symmetric)
        self.periodic = bool(periodic)
        self.all_kbody_terms = all_terms
        self.kbody_terms_for_element = terms_per_elem

        n = self.n_elements
        self.n_radial_slots = n
        self.n_angular_slots = (n * (n + 1) // 2) if symmetric else n * n

        # (center_idx, neighbor_idx) -> slot within center's radial terms
        # and -> global term id.
        self._rslot = np.zeros((n, n), dtype=np.int32)
        self._rterm = np.zeros((n, n), dtype=np.int32)
        for ci, ce in enumerate(elements):
            for ni, ne in enumerate(elements):
                term = ce + ne
                self._rslot[ci, ni] = terms_per_elem[ce].index(term)
                self._rterm[ci, ni] = all_terms.index(term)
        if angular:
            self._aslot = np.zeros((n, n, n), dtype=np.int32)
            self._aterm = np.zeros((n, n, n), dtype=np.int32)
            for ci, ce in enumerate(elements):
                for ji, je in enumerate(elements):
                    for ki, ke in enumerate(elements):
                        if symmetric:
                            suffix = "".join(sorted([je, ke]))
                        else:
                            suffix = je + ke
                        term = ce + suffix
                        # slot among angular terms only
                        slot = terms_per_elem[ce].index(term) - n
                        self._aslot[ci, ji, ki] = slot
                        self._aterm[ci, ji, ki] = all_terms.index(term)

    # ------------------------------------------------------------------
    @property
    def max_cutoff(self) -> float:
        return max(self.rcut, self.acut)

    def radial_term_name(self, term_id: int) -> str:
        return self.all_kbody_terms[term_id]

    def element_index(self, symbol: str) -> int:
        return self.elements.index(symbol)

    def vap_element_indices(self, vap: VirtualAtomMap) -> np.ndarray:
        """[n_vap] element index of every VAP row (0 for the X row; row 0
        is always masked out by atom_masks downstream)."""
        out = np.zeros(vap.n_atoms_vap, dtype=np.int32)
        for e in vap.elements:
            lo = vap.element_offsets[e]
            out[lo:lo + vap.max_occurs[e]] = self.element_index(e)
        return out

    # ------------------------------------------------------------------
    def neighbor_size(self, structure: Structure) -> NeighborSize:
        return find_neighbor_size_of_atoms(
            structure, self.rcut, angular=self.angular,
            acut=self.acut if self.angular else None)

    def make_vap(self, structure: Structure,
                 max_occurs: Optional[Counter] = None) -> VirtualAtomMap:
        if max_occurs is None:
            max_occurs = Counter(structure.symbols)
        return VirtualAtomMap(max_occurs, structure.symbols)

    # ------------------------------------------------------------------
    def featurize(self, structure: Structure,
                  vap: Optional[VirtualAtomMap] = None,
                  nij_max: Optional[int] = None,
                  nijk_max: Optional[int] = None,
                  dtype=np.float64,
                  pair_bucket=None, trip_bucket=None,
                  nnl_max: Optional[int] = None,
                  ntl_max: Optional[int] = None,
                  layout: str = "both",
                  nnl_bucket=None, ntl_bucket=None,
                  transpose: bool = False,
                  ttrans_max: Optional[int] = None) -> Features:
        """Build the fixed-shape feature arrays for one structure.

        `pair_bucket`/`trip_bucket` round the exact pair/triple counts
        up (e.g. to powers of two) when no explicit max is given —
        single neighbor-list pass, bounded recompilation.

        `nnl_max`/`ntl_max` fix the widths of the dense per-atom
        neighbor/triple layouts used by the 'dense'
        descriptor backends; default = this structure's own maxima.
        `ttrans_max` likewise fixes the width of the triple TRANSPOSE
        tables (`transpose=True`, angular models) so featurized
        structures batch-stack — pass `NeighborSize.ttrans` over the
        dataset (the pair transpose table needs no extra bound:
        in-degree == out-degree on full directed lists, so `nnl_max`
        covers it).

        `layout` selects which layouts to emit: 'both' (default),
        'segment' (flat pair/triple index arrays only), or 'dense'
        (per-atom columns only) — training at SNAP-scale padding
        should emit only the layout its backend consumes, halving
        feature memory / cache / device-resident HBM."""
        if layout not in ("both", "segment", "dense"):
            raise ValueError(f"unknown layout {layout!r}")
        structure = structure.ensure_cell()
        if vap is None:
            vap = self.make_vap(structure)
        ilist, jlist, shift, dists, _ = neighbor_list(
            structure, self.max_cutoff)
        if self.angular and self.acut > self.rcut:
            all_pairs = (ilist, jlist, shift, dists)
            within_r = dists < self.rcut
            ilist, jlist, shift, dists = (ilist[within_r], jlist[within_r],
                                          shift[within_r], dists[within_r])
        else:
            all_pairs = None
        nij = len(ilist)
        if nij_max is None:
            nij_max = pair_bucket(nij) if pair_bucket else nij

        # vectorized symbol -> element-index map
        lut = np.full(128, -1, dtype=np.int32)
        from ..elements import atomic_numbers
        for idx, e in enumerate(self.elements):
            lut[atomic_numbers[e]] = idx
        elem_idx_local = lut[structure.numbers]
        if elem_idx_local.min(initial=0) < 0:
            bad = sorted(set(np.asarray(structure.symbols)[
                elem_idx_local < 0].tolist()))
            raise ValueError(f"unsupported element(s): {bad}")

        feats: Features = {}
        pos_vap = vap.map_positions(structure.positions).astype(dtype)
        feats["positions"] = pos_vap
        feats["cell"] = structure.cell.astype(dtype)
        feats["atom_masks"] = vap.atom_masks.astype(dtype)
        feats["n_atoms"] = np.int32(len(structure))
        feats["etemperature"] = np.asarray(
            structure.info.get("etemperature", 0.0), dtype=dtype)

        pad = nij_max - nij
        if pad < 0:
            raise ValueError(f"nij={nij} exceeds nij_max={nij_max}")
        ci = elem_idx_local[ilist]
        cj = elem_idx_local[jlist]
        if layout in ("both", "segment"):
            feats["pair_i"] = _pad(vap.local_to_vap[ilist], nij_max, 0)
            feats["pair_j"] = _pad(vap.local_to_vap[jlist], nij_max, 0)
            feats["pair_shift"] = np.concatenate(
                [shift, np.zeros((pad, 3))], axis=0).astype(dtype)
            feats["pair_islot"] = _pad(self._rslot[ci, cj], nij_max, 0)
            feats["pair_term"] = _pad(self._rterm[ci, cj], nij_max, 0)
            feats["pair_mask"] = np.concatenate(
                [np.ones(nij), np.zeros(pad)]).astype(dtype)

        if layout in ("both", "dense"):
            # Dense per-atom layout, built on the HOST so the device
            # sees gathers only. Row = VAP index of the center, column
            # = neighbor counter.
            cols, nnl = _columns_of(ilist, len(structure))
            if nnl_max is not None:
                if nnl > nnl_max:
                    raise ValueError(
                        f"nnl={nnl} exceeds nnl_max={nnl_max}")
                nnl = int(nnl_max)
            elif nnl_bucket is not None or pair_bucket is not None:
                # bounded recompiles (MD); nnl is a per-atom WIDTH
                # (typically 30-100), so callers should pass a
                # smaller-minimum nnl_bucket rather than reuse the
                # flat-nij bucket
                nnl = int((nnl_bucket or pair_bucket)(nnl))
            nnl = max(nnl, 1)
            n_vap = vap.n_atoms_vap
            rows = vap.local_to_vap[ilist]
            from ..ops.dense import encode_simg_np, SIMG_ZERO
            pjd = np.zeros((n_vap, nnl), np.int32)
            # periodic images packed into ONE int32 per slot (every
            # dense feature stays 2-D — see ops/dense.py); padding
            # slots carry the zero-image code so decoded garbage stays
            # small
            psd = np.full((n_vap, nnl), SIMG_ZERO, np.int32)
            pmd = np.zeros((n_vap, nnl), dtype)
            pisd = np.zeros((n_vap, nnl), dtype)
            pjd[rows, cols] = vap.local_to_vap[jlist]
            psd[rows, cols] = encode_simg_np(shift)
            pmd[rows, cols] = 1.0
            pisd[rows, cols] = self._rslot[ci, cj]
            feats["pair_j_d"] = pjd
            feats["pair_simg_d"] = psd
            feats["pair_mask_d"] = pmd
            feats["pair_islot_d"] = pisd
            # Transpose table (opt-in: per-structure widths are not
            # batch-stackable, so training caches skip them): for each
            # atom a, the FLAT slot indices (into [n_vap * nnl]) of
            # every pair whose NEIGHBOR is a. Full directed lists make
            # in-degree == out-degree, so the same nnl width always
            # fits. `ops/dense.transpose_reduce` turns the force
            # backward's scatter-add into a gather + row reduction.
            if not transpose:
                tcols = None
            else:
                tcols, _ = _columns_of(jlist, len(structure))
            if tcols is not None:
                ptd = np.zeros((n_vap, nnl), np.int32)
                ptm = np.zeros((n_vap, nnl), dtype)
                jrows = vap.local_to_vap[jlist]
                ptd[jrows, tcols] = rows * nnl + cols
                ptm[jrows, tcols] = 1.0
                feats["pair_trans_d"] = ptd
                feats["pair_trans_mask_d"] = ptm

        if self.angular:
            a_i, a_j, a_s, a_d = all_pairs if all_pairs is not None else (
                ilist, jlist, shift, dists)
            self._build_triples(feats, structure, vap, a_i, a_j, a_s,
                                a_d, elem_idx_local, nijk_max, dtype,
                                trip_bucket, ntl_max, layout,
                                ntl_bucket, transpose, ttrans_max)
        return feats

    def _build_triples(self, feats, structure, vap, ilist, jlist, shift,
                       dists, elem_idx_local, nijk_max, dtype,
                       trip_bucket=None, ntl_max=None, layout="both",
                       ntl_bucket=None, transpose=False,
                       ttrans_max=None):
        within = dists < self.acut
        ii, jj, ss = ilist[within], jlist[within], shift[within]
        # group pairs by center atom; emit j<k combinations
        order = np.argsort(ii, kind="stable")
        ii, jj, ss = ii[order], jj[order], ss[order]

        pq = None
        if not os.environ.get("TENSORALLOY_NO_NATIVE"):
            from ..native import native_triple_list
            pq = native_triple_list(ii, len(structure))
        if pq is not None:
            p, q = pq
            t_i = ii[p].astype(np.int64)
            t_j, t_k = jj[p], jj[q]
            t_sj, t_sk = ss[p], ss[q]
        else:
            counts = np.bincount(ii, minlength=len(structure))
            offsets = np.concatenate([[0], np.cumsum(counts)])
            t_i, t_j, t_k, t_sj, t_sk = [], [], [], [], []
            for a in range(len(structure)):
                lo, hi = offsets[a], offsets[a + 1]
                m = hi - lo
                if m < 2:
                    continue
                p, q = np.triu_indices(m, k=1)
                t_i.append(np.full(len(p), a, dtype=np.int64))
                t_j.append(jj[lo + p])
                t_k.append(jj[lo + q])
                t_sj.append(ss[lo + p])
                t_sk.append(ss[lo + q])
            if t_i:
                t_i = np.concatenate(t_i)
                t_j = np.concatenate(t_j)
                t_k = np.concatenate(t_k)
                t_sj = np.concatenate(t_sj)
                t_sk = np.concatenate(t_sk)
            else:
                t_i = np.zeros(0, np.int64)
                t_j = np.zeros(0, np.int64)
                t_k = np.zeros(0, np.int64)
                t_sj = np.zeros((0, 3))
                t_sk = np.zeros((0, 3))
        nijk = len(t_i)
        if nijk_max is None:
            nijk_max = trip_bucket(nijk) if trip_bucket else nijk
        pad = nijk_max - nijk
        if pad < 0:
            raise ValueError(f"nijk={nijk} exceeds nijk_max={nijk_max}")
        ci = elem_idx_local[t_i]
        cj = elem_idx_local[t_j]
        ck = elem_idx_local[t_k]
        if layout in ("both", "segment"):
            feats["trip_i"] = _pad(vap.local_to_vap[t_i], nijk_max, 0)
            feats["trip_j"] = _pad(vap.local_to_vap[t_j], nijk_max, 0)
            feats["trip_k"] = _pad(vap.local_to_vap[t_k], nijk_max, 0)
            feats["trip_shift_j"] = np.concatenate(
                [t_sj, np.zeros((pad, 3))], axis=0).astype(dtype)
            feats["trip_shift_k"] = np.concatenate(
                [t_sk, np.zeros((pad, 3))], axis=0).astype(dtype)
            feats["trip_aslot"] = _pad(self._aslot[ci, cj, ck],
                                       nijk_max, 0)
            feats["trip_mask"] = np.concatenate(
                [np.ones(nijk), np.zeros(pad)]).astype(dtype)
        if layout == "segment":
            return
        tcols, ntl = _columns_of(np.asarray(t_i, dtype=np.int64),
                                 len(structure))
        if ntl_max is not None:
            if ntl > ntl_max:
                raise ValueError(f"ntl={ntl} exceeds ntl_max={ntl_max}")
            ntl = int(ntl_max)
        elif ntl_bucket is not None or trip_bucket is not None:
            ntl = int((ntl_bucket or trip_bucket)(ntl))
        ntl = max(ntl, 1)
        n_vap = vap.n_atoms_vap
        rows = vap.local_to_vap[t_i]
        from ..ops.dense import encode_simg_np, SIMG_ZERO
        tjd = np.zeros((n_vap, ntl), np.int32)
        tkd = np.zeros((n_vap, ntl), np.int32)
        tsjd = np.full((n_vap, ntl), SIMG_ZERO, np.int32)
        tskd = np.full((n_vap, ntl), SIMG_ZERO, np.int32)
        tmd = np.zeros((n_vap, ntl), dtype)
        tasd = np.zeros((n_vap, ntl), dtype)
        tjd[rows, tcols] = vap.local_to_vap[t_j]
        tkd[rows, tcols] = vap.local_to_vap[t_k]
        tsjd[rows, tcols] = encode_simg_np(t_sj)
        tskd[rows, tcols] = encode_simg_np(t_sk)
        tmd[rows, tcols] = 1.0
        tasd[rows, tcols] = self._aslot[ci, cj, ck]
        feats["trip_j_d"] = tjd
        feats["trip_k_d"] = tkd
        feats["trip_simg_j_d"] = tsjd
        feats["trip_simg_k_d"] = tskd
        feats["trip_mask_d"] = tmd
        feats["trip_aslot_d"] = tasd
        # triple transpose tables (force assembly without scatter):
        # for each atom a, the flat slot indices of every triple where
        # a is the j (resp. k) neighbor — widths have their own maxima
        # (an atom appears as a side of up to ~2x its own triple count)
        if not transpose:
            return
        flat = (rows * ntl + tcols).astype(np.int64)
        for side, t_side in (("j", t_j), ("k", t_k)):
            scols, sw = _columns_of(np.asarray(t_side, np.int64),
                                    len(structure))
            sw = max(int(sw), 1)
            if ttrans_max is not None:
                if sw > ttrans_max:
                    raise ValueError(
                        f"triple {side}-side in-degree {sw} exceeds "
                        f"ttrans_max={ttrans_max}")
                sw = max(int(ttrans_max), 1)
            elif ntl_bucket is not None or trip_bucket is not None:
                sw = int((ntl_bucket or trip_bucket)(sw))
            std = np.zeros((n_vap, sw), np.int32)
            stm = np.zeros((n_vap, sw), dtype)
            srows = vap.local_to_vap[np.asarray(t_side, np.int64)]
            std[srows, scols] = flat
            stm[srows, scols] = 1.0
            feats[f"trip_trans_{side}_d"] = std
            feats[f"trip_trans_{side}_mask_d"] = stm

    # ------------------------------------------------------------------
    def as_dict(self) -> dict:
        return {"class": "Featurizer", "elements": self.elements,
                "rcut": self.rcut, "acut": self.acut,
                "angular": self.angular, "symmetric": self.symmetric,
                "periodic": self.periodic}

    def to_json(self) -> str:
        return json.dumps(self.as_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "Featurizer":
        d = dict(d)
        d.pop("class", None)
        return cls(elements=d["elements"], rcut=d["rcut"],
                   acut=d.get("acut") or None, angular=d.get("angular", False),
                   symmetric=d.get("symmetric", True),
                   periodic=d.get("periodic", True))


def _columns_of(centers: np.ndarray, n_atoms: int):
    """Per-entry column index within its center's dense row.

    -> (cols [len(centers)] int64, width = max entries of any center).
    """
    centers = np.asarray(centers, dtype=np.int64)
    if len(centers) == 0:
        return np.zeros(0, np.int64), 0
    counts = np.bincount(centers, minlength=n_atoms)
    order = np.argsort(centers, kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)])[:-1]
    cols = np.zeros(len(centers), dtype=np.int64)
    cols[order] = np.arange(len(centers)) - start[centers[order]]
    return cols, int(counts.max())


def _pad(arr: np.ndarray, size: int, fill) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.int32)
    out = np.full(size, fill, dtype=np.int32)
    out[:len(arr)] = arr
    return out


def batch_features(feature_list: List[Features]) -> Features:
    """Stack per-structure feature dicts along a leading batch axis."""
    keys = feature_list[0].keys()
    return {k: np.stack([f[k] for f in feature_list], axis=0) for k in keys}
