"""On-device periodic neighbor list: cell binning + static stencil.

The host featurizer (`transform/featurizer.py`) builds index arrays with
numpy/C++ — fine for training (featurize once, cache), but for MD and
large-cell inference the host becomes the bottleneck. This module
moves the neighbor list itself onto the device so the full pipeline — binning, pair
enumeration, descriptors, energy, forces — is one jitted program with
no host round trip.

The reference has no analogue (its `tensoralloy/neighbor.py` wraps
ASE's C neighbor list on the host and feeds a feed_dict per structure);
this is a capability beyond it.

Algorithm (all static shapes, XLA-friendly):
  1. fractional coords; wrap along periodic axes (wrap offsets are
     folded back into the emitted shifts so RAW positions stay exact:
     ``R_j + S @ cell - R_i``, matching `neighbor.py`'s contract);
  2. bin atoms into a ``g0 x g1 x g2`` grid (cell width >= cutoff, or
     a deeper stencil when the box is thinner than the cutoff), sort
     atom ids by cell id (one `argsort`), per-cell offsets via
     `searchsorted`;
  3. for each of the ``prod(2*s+1)`` stencil offsets (static Python
     loop) gather up to ``cell_cap`` candidates per atom — gathers
     only, no scatters;
  4. compact the ``n_stencil * cell_cap`` candidate columns down to the
     ``nnl_cap`` dense width with ONE row-wise `lax.sort` (valid
     entries keep their column order, so output is deterministic);
  5. emit the exact `Featurizer.featurize` feature contract (dense
     and/or segment layout, optional dense triples) in VAP row order.

Capacity discipline: `nnl_cap` / `cell_cap` / `ntl_cap` are compile
-time constants; `build` additionally returns a diagnostics dict with
the *needed* sizes so callers can detect overflow on the host (under
jit nothing can raise) and re-instantiate with bigger caps.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..atoms import Structure
from ..vap import VirtualAtomMap

__all__ = ["DeviceNeighborList"]


def _cell_heights(cell: np.ndarray) -> np.ndarray:
    vol = abs(np.linalg.det(cell))
    cross = np.cross(cell[[1, 2, 0]], cell[[2, 0, 1]])
    areas = np.linalg.norm(cross, axis=1)
    return vol / np.maximum(areas, 1e-300)


def _round_up(n: int, mult: int = 8) -> int:
    return max(mult, ((int(n) + mult - 1) // mult) * mult)


class DeviceNeighborList:
    """Jittable neighbor-list builder for a fixed (cell, stoichiometry).

    Parameters
    ----------
    featurizer : the model's `Featurizer` (defines elements, cutoffs,
        slot/term tables and whether triples are needed).
    vap : the `VirtualAtomMap` of the structures to be evaluated (the
        model's row layout; `model.clone_for(...)` must use the same).
    structure : a representative `Structure` — supplies cell, pbc,
        symbols, and the initial positions used to auto-size the caps.
    cutoff : pair cutoff (default `featurizer.max_cutoff`); pass
        ``rcut + skin`` for skinned MD lists (all model families mask
        ``r >= rcut`` on device, so the skin is energy-invariant).
    nnl_cap / cell_cap / ntl_cap : static capacities (auto-sized from
        `structure` with `margin` when omitted).
    layout : 'dense', 'segment', or 'both' (default: what the model
        family consumes — pass explicitly when known).
    angular : emit dense triples (default `featurizer.angular`).
    """

    def __init__(self, featurizer, vap: VirtualAtomMap,
                 structure: Structure, *, cutoff: Optional[float] = None,
                 nnl_cap: Optional[int] = None,
                 cell_cap: Optional[int] = None,
                 ntl_cap: Optional[int] = None,
                 layout: str = "dense", angular: Optional[bool] = None,
                 margin: float = 1.3, census: str = "exact"):
        if layout not in ("dense", "segment", "both"):
            raise ValueError(f"unknown layout {layout!r}")
        self.fz = featurizer
        self.vap = vap
        self.layout = layout
        self.cutoff = float(cutoff if cutoff else featurizer.max_cutoff)
        self.angular = bool(featurizer.angular if angular is None
                            else angular)
        structure = structure.ensure_cell()
        self._template = structure.copy()
        cell = np.asarray(structure.cell, dtype=np.float64)
        self.cell0 = cell
        self.pbc = np.asarray(structure.pbc, dtype=bool).copy()
        n = len(structure)
        self.n = n

        heights = _cell_heights(cell)
        if not np.all(heights > 0):
            raise ValueError("singular cell after ensure_cell()")
        # grid: cell width = height/g >= cutoff where possible; a box
        # thinner than the cutoff gets g=1 and a deeper stencil.
        g = np.maximum(np.floor(heights / self.cutoff).astype(int), 1)
        widths = heights / g
        s = np.maximum(np.ceil(self.cutoff / widths - 1e-9).astype(int), 1)
        # non-periodic axes never need image layers beyond the box
        s = np.where(self.pbc, s, 1)
        self.grid = tuple(int(x) for x in g)
        self.stencil_extent = tuple(int(x) for x in s)
        offs = np.stack(np.meshgrid(
            *[np.arange(-s[d], s[d] + 1) for d in range(3)],
            indexing="ij"), axis=-1).reshape(-1, 3).astype(np.int32)
        self.offsets = offs                       # [nsten, 3]
        self.n_stencil = len(offs)

        # element / slot tables (static)
        lut = np.full(128, -1, dtype=np.int32)
        from ..elements import atomic_numbers
        for idx, e in enumerate(featurizer.elements):
            lut[atomic_numbers[e]] = idx
        elem_idx = lut[structure.numbers]
        if elem_idx.min(initial=0) < 0:
            raise ValueError("structure has elements outside the model")
        self.elem_idx_local = elem_idx.astype(np.int32)
        self.local_to_vap = vap.local_to_vap.astype(np.int32)
        v2l = vap.vap_to_local.astype(np.int32)
        self.row_is_real = (v2l >= 0)
        self.vap_to_local = np.where(self.row_is_real, v2l, 0).astype(
            np.int32)
        self.n_vap = vap.n_atoms_vap

        # auto-size capacities from the representative structure.
        # census="exact" runs the host neighbor list once — right for
        # trajectory builders that amortize it over many frames.
        # census="density" sizes nnl from the uniform-density cutoff
        # sphere instead (numpy binning only, no host NL): the O(N)
        # host cost that dominates ONE-SHOT large cells disappears,
        # and an underestimate self-heals through the grow() loop the
        # same way any capacity overflow does. Angular models keep the
        # exact census (triple counts are too sensitive to estimate).
        if census not in ("exact", "density"):
            raise ValueError(f"unknown census mode {census!r}")
        if cell_cap is None or nnl_cap is None or (
                self.angular and ntl_cap is None):
            if census == "density" and not self.angular and n:
                occ, nnl_need, ntl_need = self._density_census(
                    structure.positions)
            else:
                occ, nnl_need, ntl_need = self._host_census(
                    structure.positions)
            if cell_cap is None:
                cell_cap = _round_up(int(np.ceil(occ * margin)))
            if nnl_cap is None:
                nnl_cap = _round_up(int(np.ceil(nnl_need * margin)))
            if self.angular and ntl_cap is None:
                ntl_cap = _round_up(int(np.ceil(ntl_need * margin)))
        self.cell_cap = int(cell_cap)
        self.nnl_cap = int(nnl_cap)
        self.ntl_cap = int(ntl_cap) if self.angular else 0
        if self.angular:
            p, q = np.triu_indices(self.nnl_cap, k=1)
            self._tri_p = p.astype(np.int32)
            self._tri_q = q.astype(np.int32)

        self._build_jit = jax.jit(self._build)

    # ------------------------------------------------------------------
    def _density_census(self, positions) -> Tuple[int, int, int]:
        """Capacity estimate without a host neighbor list: exact cell
        occupancy from numpy binning (microseconds) + neighbors/atom
        from the LOCAL density of the fullest bin — the cutoff-sphere
        count at that density bounds the worst atom for any roughly
        uniform system; pathological clustering self-heals via grow().
        """
        cell, g = self.cell0, np.asarray(self.grid)
        frac = positions @ np.linalg.inv(cell)
        wrap = np.where(self.pbc, np.floor(frac), 0.0)
        fw = frac - wrap
        c = np.clip((fw * g).astype(int), 0, g - 1)
        cid = (c[:, 0] * g[1] + c[:, 1]) * g[2] + c[:, 2]
        occ = int(np.bincount(cid, minlength=g.prod()).max())
        vol = float(abs(np.linalg.det(cell)))
        bin_vol = vol / float(g.prod())
        local_density = occ / bin_vol
        sphere = 4.0 / 3.0 * np.pi * self.cutoff ** 3
        nnl = int(np.ceil(sphere * local_density))
        return occ, max(nnl, 1), 0

    def _host_census(self, positions) -> Tuple[int, int, int]:
        """numpy mirror of the binning: exact (max cell occupancy,
        max neighbors/atom, max triples/atom) for the given positions."""
        cell, g = self.cell0, np.asarray(self.grid)
        frac = positions @ np.linalg.inv(cell)
        wrap = np.where(self.pbc, np.floor(frac), 0.0)
        fw = frac - wrap
        c = np.clip((fw * g).astype(int), 0, g - 1)
        cid = (c[:, 0] * g[1] + c[:, 1]) * g[2] + c[:, 2]
        occ = int(np.bincount(cid, minlength=g.prod()).max()) if self.n \
            else 0
        from ..neighbor import neighbor_list
        s = Structure(np.full(self.n, 1), positions - wrap @ cell,
                      cell, self.pbc)
        ii, _, _, dd, _ = neighbor_list(s, self.cutoff)
        cnt = np.bincount(ii, minlength=self.n) if len(ii) else \
            np.zeros(self.n, int)
        nnl = int(cnt.max()) if self.n else 0
        ntl = 0
        if self.angular:
            ca = np.bincount(ii[dd < self.fz.acut], minlength=self.n) \
                if len(ii) else np.zeros(self.n, int)
            ntl = int((ca * (ca - 1) // 2).max()) if self.n else 0
        return occ, nnl, ntl

    # ------------------------------------------------------------------
    def build(self, positions_vap, cell=None, etemperature=0.0
              ) -> Tuple[Dict[str, jnp.ndarray], Dict[str, jnp.ndarray]]:
        """positions_vap [n_vap, 3] (RAW, VAP layout) -> (features, diag).

        diag carries ``nnl_needed`` / ``cell_needed`` (and
        ``ntl_needed``): compare against the caps on the host; any
        excess means pairs were DROPPED and the caller must rebuild
        with larger caps (`.grow(diag)`).
        """
        cell = self.cell0 if cell is None else cell
        return self._build_jit(jnp.asarray(positions_vap),
                               jnp.asarray(cell, dtype=positions_vap.dtype),
                               jnp.asarray(etemperature,
                                           dtype=positions_vap.dtype))

    def check(self, diag) -> None:
        """Host-side overflow assertion for a `build` diagnostics dict."""
        nnl = int(diag["nnl_needed"])
        occ = int(diag["cell_needed"])
        if occ > self.cell_cap or nnl > self.nnl_cap:
            raise RuntimeError(
                f"device neighbor list overflow: needed cell occupancy "
                f"{occ} (cap {self.cell_cap}), nnl {nnl} (cap "
                f"{self.nnl_cap}) — rebuild with grow()")
        if self.angular and int(diag["ntl_needed"]) > self.ntl_cap:
            raise RuntimeError(
                f"device neighbor list overflow: needed ntl "
                f"{int(diag['ntl_needed'])} (cap {self.ntl_cap})")
        from ..ops.dense import SIMG_OFF
        if int(diag.get("simg_overflow", 0)) > 0:
            raise RuntimeError(
                f"shift-image overflow: {int(diag['simg_overflow'])} "
                f"pair components exceeded +-{SIMG_OFF} cells — "
                f"positions have drifted too far from the home cell "
                f"for the packed image code (the host featurizer "
                f"raises on the same condition); wrap coordinates or "
                f"rebuild from wrapped positions")

    def stencil_reach(self, cell) -> np.ndarray:
        """Physical distance the static stencil covers per axis for a
        DIFFERENT cell than the one this builder was sized for: the
        grid is fixed in FRACTIONAL space, so when a barostat shrinks
        the cell the bins shrink with it and the stencil may no longer
        span the cutoff. [3] in A — compare against `self.cutoff`."""
        heights = _cell_heights(np.asarray(cell, dtype=np.float64))
        return (np.asarray(self.stencil_extent, float) * heights /
                np.asarray(self.grid, float))

    def covers(self, cell, cutoff: Optional[float] = None) -> bool:
        """True when the stencil still spans `cutoff` (default: this
        builder's skinned cutoff) for the given cell; False means the
        caller must rebuild the binning before the next build."""
        want = self.cutoff if cutoff is None else float(cutoff)
        pbc_axes = self.pbc
        reach = self.stencil_reach(cell)
        return bool(np.all(reach[pbc_axes] >= want - 1e-9))

    def rebuilt_for(self, structure: Structure) -> "DeviceNeighborList":
        """New builder re-gridded for `structure`'s current cell (same
        cutoff/layout; caps re-auto-sized from its positions)."""
        return DeviceNeighborList(
            self.fz, self.vap, structure, cutoff=self.cutoff,
            layout=self.layout, angular=self.angular)

    def grow(self, diag, margin: float = 1.3) -> "DeviceNeighborList":
        """New builder with caps covering `diag` (keeps grid/layout).

        A truncated build UNDER-reports the needed widths (it only saw
        `cell_cap` candidates per stencil cell), so one grow() is not
        guaranteed to suffice — callers re-check and grow again until
        `check` passes (the MD driver does this automatically)."""
        def up(needed, cur):
            return max(_round_up(int(np.ceil(int(needed) * margin))),
                       _round_up(cur + 1))
        return DeviceNeighborList(
            self.fz, self.vap, self._template,
            cutoff=self.cutoff, layout=self.layout, angular=self.angular,
            nnl_cap=up(diag["nnl_needed"], self.nnl_cap),
            cell_cap=up(diag["cell_needed"], self.cell_cap),
            ntl_cap=up(diag.get("ntl_needed", 0), self.ntl_cap)
            if self.angular else None)

    # ------------------------------------------------------------------
    def _build(self, positions_vap, cell, etemperature):
        fdt = positions_vap.dtype
        n, K, NNL = self.n, self.cell_cap, self.nnl_cap
        g = jnp.asarray(self.grid, dtype=jnp.int32)
        gnp = np.asarray(self.grid)
        ncells = int(gnp.prod())
        pbc = jnp.asarray(self.pbc)
        l2v = jnp.asarray(self.local_to_vap)
        pos = positions_vap[l2v]                      # [n, 3] local order

        inv = jnp.linalg.inv(cell)
        frac = pos @ inv
        wrap = jnp.where(pbc[None, :], jnp.floor(frac), 0.0)
        wrap = jax.lax.stop_gradient(wrap)
        posw = pos - wrap @ cell                      # wrapped, home cell
        fw = jax.lax.stop_gradient(frac - wrap)
        c = jnp.clip((fw * g).astype(jnp.int32), 0, g - 1)   # [n, 3]
        cid = (c[:, 0] * self.grid[1] + c[:, 1]) * self.grid[2] + c[:, 2]

        perm = jnp.argsort(cid)                       # stable
        sorted_ids = cid[perm]
        starts = jnp.searchsorted(sorted_ids,
                                  jnp.arange(ncells + 1,
                                             dtype=sorted_ids.dtype))
        counts = jnp.diff(starts)                     # [ncells]

        slot = jnp.arange(K, dtype=jnp.int32)
        rc2 = jnp.asarray(self.cutoff * self.cutoff, dtype=fdt)
        # per-component position columns: ALL stencil geometry below
        # is structure-of-arrays [n, K] math (no [*, 3] gathers)
        pw = tuple(posw[:, a] for a in range(3))
        j_blocks, valid_blocks = [], []
        for o in self.offsets:                        # static loop
            nc = c + jnp.asarray(o, dtype=jnp.int32)  # [n, 3]
            quot = jnp.floor_divide(nc, g)
            rem = nc - quot * g
            # non-periodic axes: no wraparound — out-of-range cells are
            # simply invalid
            in_range = jnp.where(pbc[None, :], True,
                                 (nc >= 0) & (nc < g)).all(axis=1)
            s_sten = jnp.where(pbc[None, :], quot, 0)  # [n, 3] images
            ncid = ((rem[:, 0] * self.grid[1] + rem[:, 1]) *
                    self.grid[2] + rem[:, 2])
            base = starts[ncid]                        # [n]
            idx = base[:, None] + slot[None, :]        # [n, K]
            have = slot[None, :] < counts[ncid][:, None]
            j = perm[jnp.clip(idx, 0, max(n - 1, 0))]  # [n, K]
            sf = s_sten.astype(fdt)
            d2 = jnp.zeros(j.shape, fdt)
            for a in range(3):
                sc_a = (sf[:, 0] * cell[0, a] + sf[:, 1] * cell[1, a]
                        + sf[:, 2] * cell[2, a])       # [n]
                v_a = pw[a][j] + sc_a[:, None] - pw[a][:, None]
                d2 = d2 + v_a * v_a
            valid = (have & in_range[:, None] & (d2 < rc2) &
                     (d2 > 1e-20))
            j_blocks.append(j)
            valid_blocks.append(valid)
        j_all = jnp.concatenate(j_blocks, axis=1)       # [n, C]
        valid_all = jnp.concatenate(valid_blocks, axis=1)
        C = j_all.shape[1]

        row_need = jnp.sum(valid_all, axis=1).max() if n else \
            jnp.int32(0)
        diag = {"nnl_needed": row_need.astype(jnp.int32),
                "cell_needed": counts.max().astype(jnp.int32)}

        # compaction: valid entries keep column order, invalid sink.
        # The key IS the source column, so a SINGLE-operand sort
        # suffices — j is recovered by a gather afterwards (half the
        # sort traffic of the previous variadic (key, j) sort).
        # TA_NL_COMPACTION=topk switches to lax.top_k (partial
        # selection of the NNL smallest keys instead of a full
        # C-wide sort) — identical results; A/B with
        # bench_inference --device-nl.
        col = jnp.arange(C, dtype=jnp.int32)[None, :]
        key = jnp.broadcast_to(jnp.where(valid_all, col, C), (n, C))
        if os.environ.get("TA_NL_COMPACTION") == "topk":
            negv, _ = jax.lax.top_k(-key, NNL)
            key_o = -negv                               # ascending keys
        else:
            key_o = jax.lax.sort(key, dimension=1)[:, :NNL]
        m_o = key_o < C                                 # bool mask
        j_o = jnp.take_along_axis(
            j_all, jnp.clip(key_o, 0, C - 1).astype(jnp.int32), axis=1)
        blk = jnp.clip(key_o // K, 0, self.n_stencil - 1)
        o_tab = jnp.asarray(self.offsets)               # [nsten, 3]
        # fold wraps back so RAW positions satisfy R_j + S@cell - R_i.
        # Components stay [n, NNL] int32 and pack into ONE code per
        # slot (ops/dense.SIMG_*) — no [*, 3] gather or emission.
        from ..ops.dense import SIMG_BASE, SIMG_OFF, SIMG_ZERO
        wrap_i = wrap.astype(jnp.int32)                 # whole floats
        simg_o = jnp.zeros(j_o.shape, jnp.int32)
        mult = (1, SIMG_BASE, SIMG_BASE * SIMG_BASE)
        # range guard: s_a is unbounded when MD drifts raw coordinates
        # many cells from home (wrap_i - wrap_j grows without limit);
        # the host featurizer's encode_simg_np raises on |s| > SIMG_OFF
        # but a silent device-side wraparound would corrupt all three
        # decoded components. Count overflows into diag (check() fails
        # loudly) and clamp so even an unchecked build cannot poison
        # slots beyond the offending pair.
        simg_over = jnp.zeros((), jnp.int32)
        for a in range(3):
            s_a = jnp.where(
                pbc[a],
                jnp.floor_divide(c[:, a][:, None] + o_tab[:, a][blk],
                                 g[a]), 0)              # [n, NNL]
            s_a = s_a + wrap_i[:, a][:, None] - wrap_i[:, a][j_o]
            simg_over = simg_over + jnp.sum(
                (jnp.abs(s_a) > SIMG_OFF) & m_o).astype(jnp.int32)
            s_a = jnp.clip(s_a, -SIMG_OFF, SIMG_OFF)
            simg_o = simg_o + mult[a] * (jnp.where(m_o, s_a, 0)
                                         + SIMG_OFF)
        diag["simg_overflow"] = simg_over
        j_o = jnp.where(m_o, j_o, 0)

        elem = jnp.asarray(self.elem_idx_local)
        ci = elem[:, None]
        cj = elem[j_o]
        rslot = jnp.asarray(self.fz._rslot)
        rterm = jnp.asarray(self.fz._rterm)
        islot_o = jnp.where(m_o, rslot[ci, cj], 0)
        term_o = jnp.where(m_o, rterm[ci, cj], 0)
        jv_o = jnp.where(m_o, l2v[j_o], 0)              # VAP index of j

        # ---- VAP row layout -----------------------------------------
        v2l = jnp.asarray(self.vap_to_local)
        rmask = jnp.asarray(self.row_is_real)

        def to_vap(x, fill=0):
            shape = (self.n_vap,) + x.shape[1:]
            out = x[v2l]
            m = rmask.reshape((-1,) + (1,) * (x.ndim - 1))
            return jnp.where(m, out, jnp.asarray(fill, x.dtype)
                             ) if n else jnp.full(shape, fill, x.dtype)

        mask_f = m_o.astype(fdt)
        feats: Dict[str, jnp.ndarray] = {
            "positions": positions_vap,
            "cell": cell,
            "atom_masks": jnp.asarray(self.vap.atom_masks.astype(
                np.float64)).astype(fdt),
            "n_atoms": jnp.int32(n),
            "etemperature": etemperature,
        }
        pjd = to_vap(jv_o)
        psd = to_vap(simg_o, fill=SIMG_ZERO)
        pmd = to_vap(mask_f)
        pisd = to_vap(islot_o.astype(fdt))
        if self.layout in ("dense", "both"):
            feats["pair_j_d"] = pjd
            feats["pair_simg_d"] = psd
            feats["pair_mask_d"] = pmd
            feats["pair_islot_d"] = pisd
        if self.layout in ("segment", "both"):
            A = self.n_vap
            rows = jnp.broadcast_to(
                jnp.arange(A, dtype=jnp.int32)[:, None], (A, NNL))
            mflat = pmd.reshape(-1)
            feats["pair_i"] = jnp.where(mflat > 0, rows.reshape(-1), 0)
            feats["pair_j"] = jnp.where(mflat > 0, pjd.reshape(-1), 0)
            # the flat autodiff layout keeps its [nij, 3] float contract
            from ..ops.dense import decode_simg
            feats["pair_shift"] = jnp.stack(
                decode_simg(psd.reshape(-1), fdt), axis=-1)
            feats["pair_islot"] = jnp.where(
                mflat > 0, to_vap(islot_o).reshape(-1), 0)
            feats["pair_term"] = jnp.where(
                mflat > 0, to_vap(term_o).reshape(-1), 0)
            feats["pair_mask"] = mflat

        if self.angular:
            self._triples(feats, diag, posw, cell, j_o, m_o, simg_o,
                          wrap, elem, to_vap, fdt)
        return feats, diag

    # ------------------------------------------------------------------
    def _triples(self, feats, diag, posw, cell, j_o, m_o, simg_o, wrap,
                 elem, to_vap, fdt):
        """Dense j<k triples from the compacted pair rows (acut mask).

        `simg_o` carries the RAW-frame periodic images PACKED as one
        int32 per slot (ops/dense.SIMG_*) — all geometry below is
        per-component [n, NNL] math, never a [*, 3] gather/temp."""
        from ..ops.dense import decode_simg, SIMG_ZERO
        n, NNL, NTL = self.n, self.nnl_cap, self.ntl_cap
        # distances of the compacted pairs (wrapped frame: the wrap
        # folds cancel between center and neighbor)
        sx, sy, sz = decode_simg(simg_o, fdt)
        sw = [s - wrap[:, a][:, None] + wrap[:, a][j_o]   # stencil img
              for a, s in enumerate((sx, sy, sz))]
        d2 = jnp.zeros(j_o.shape, fdt)
        for a in range(3):
            sv_a = (sw[0] * cell[0, a] + sw[1] * cell[1, a]
                    + sw[2] * cell[2, a])
            v_a = posw[:, a][j_o] + sv_a - posw[:, a][:, None]
            d2 = d2 + v_a * v_a
        ac2 = jnp.asarray(self.fz.acut * self.fz.acut, dtype=fdt)
        amask = m_o & (d2 < ac2)                         # [n, NNL]

        p, q = jnp.asarray(self._tri_p), jnp.asarray(self._tri_q)
        T2 = p.shape[0]
        tmask_all = amask[:, p] & amask[:, q]            # [n, T2]
        diag["ntl_needed"] = jnp.sum(tmask_all, axis=1).max().astype(
            jnp.int32) if n else jnp.int32(0)

        col = jnp.arange(T2, dtype=jnp.int32)[None, :]
        key = jnp.where(tmask_all, col, T2)
        key_s = jax.lax.sort(jnp.broadcast_to(key, (n, T2)),
                             dimension=1)[:, :NTL]
        tm = key_s < T2
        pq = jnp.clip(key_s, 0, T2 - 1)
        pp, qq = p[pq], q[pq]                            # [n, NTL]
        gat = jnp.take_along_axis
        tj = gat(j_o, pp, axis=1)
        tk = gat(j_o, qq, axis=1)
        tsj = gat(simg_o, pp, axis=1)          # packed codes, [n, NTL]
        tsk = gat(simg_o, qq, axis=1)
        aslot = jnp.asarray(self.fz._aslot)
        ci = jnp.broadcast_to(elem[:, None], tj.shape)
        tslot = aslot[ci, elem[tj], elem[tk]]
        l2v = jnp.asarray(self.local_to_vap)
        z = lambda x: jnp.where(tm, x, 0)
        tmf = tm.astype(fdt)
        tjd = to_vap(z(l2v[tj]))
        tkd = to_vap(z(l2v[tk]))
        tsjd = to_vap(jnp.where(tm, tsj, SIMG_ZERO), fill=SIMG_ZERO)
        tskd = to_vap(jnp.where(tm, tsk, SIMG_ZERO), fill=SIMG_ZERO)
        tmd = to_vap(tmf)
        tad = to_vap(z(tslot))
        if self.layout in ("dense", "both"):
            feats["trip_j_d"] = tjd
            feats["trip_k_d"] = tkd
            feats["trip_simg_j_d"] = tsjd
            feats["trip_simg_k_d"] = tskd
            feats["trip_mask_d"] = tmd
            feats["trip_aslot_d"] = tad.astype(fdt)
        if self.layout in ("segment", "both"):
            A = self.n_vap
            rows = jnp.broadcast_to(
                jnp.arange(A, dtype=jnp.int32)[:, None], (A, NTL))
            mflat = tmd.reshape(-1)
            w = lambda x: jnp.where(mflat > 0, x.reshape(-1), 0)
            feats["trip_i"] = w(rows)
            feats["trip_j"] = w(tjd)
            feats["trip_k"] = w(tkd)
            # the flat autodiff layout keeps its [ntl, 3] float contract
            feats["trip_shift_j"] = jnp.stack(
                decode_simg(tsjd.reshape(-1), fdt), axis=-1)
            feats["trip_shift_k"] = jnp.stack(
                decode_simg(tskd.reshape(-1), fdt), axis=-1)
            feats["trip_aslot"] = w(tad)
            feats["trip_mask"] = mflat
