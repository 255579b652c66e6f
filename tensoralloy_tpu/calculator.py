"""Inference calculator over a saved model (reference
`tensoralloy/calculator.py`: `TensorAlloyCalculator`, an ASE calculator
over a frozen graph).

ASE is not a dependency here, but the interface mirrors ASE's
`Calculator` (get_potential_energy / get_forces / get_stress /
get_hessian / ...) over our `Structure`; if ASE is installed an adapter
(`as_ase_calculator`) wraps it for drop-in MD use.

Design for accelerator inference: per-formula VAP cache, and the padded pair
count is *bucketed* to powers-of-two so XLA compiles one executable per
bucket instead of one per structure — this plus on-device distance
computation removes the reference's dominant featurize/feed-dict
bottleneck (SURVEY §6: 26.6 s neighbor + 70.6 s feed for 128k atoms).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .atoms import Structure
from .nn.fields import make_efs_fn, make_hessian_fn
from .vap import VirtualAtomMap


def model_feature_layout(model, fast: bool = False) -> str:
    """Which feature layout a model consumes: 'segment' for EAM-family
    models and segment-backend descriptors, 'dense' for dense
    descriptor backends. `fast=True` selects the dense layout for
    EAM-family models too — the scatter-free analytic EFS
    (`nn/eam/fast_efs.py`) reads it."""
    if fast and is_eam_family(model):
        return "dense"
    descriptor = getattr(model, "descriptor", None)
    backend = getattr(descriptor, "backend", "segment")
    return "segment" if backend == "segment" else "dense"


def is_eam_family(model) -> bool:
    """True only for CONCRETE EamNN models whose variational energy is
    the plain EAM energy — the analytic fast path reimplements exactly
    that math. Wrappers that delegate attributes (e.g. the
    thermodynamic-integration `LambdaMix`, which mixes in Einstein
    springs) expose the same `tag` via __getattr__ but change the
    energy, so a duck-typed check would silently compute the WRONG
    physics (caught by test_ti)."""
    from .nn.eam.models import EamNN
    if not isinstance(model, EamNN):
        return False
    ve = getattr(type(model), "variational_energy", None)
    return ve is EamNN.variational_energy


def _bucket(n: int, minimum: int = 256) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


class TensorAlloyCalculator:
    """Evaluate energy/forces/stress/Hessian of arbitrary structures."""

    implemented_properties = ("energy", "free_energy", "forces", "stress",
                              "pressure", "hessian", "atomic_energies")

    def __init__(self, model_or_path, params: Optional[dict] = None,
                 chunked: "bool | str" = "auto", chunk_size: int = 0,
                 chunk_auto_pairs: int = 3_000_000,
                 device_nl: "bool | str" = "auto",
                 device_nl_auto_atoms: int = 8192,
                 fast_efs: "bool | str" = "auto"):
        """`chunked`: large-cell evaluation via the rematerialized
        chunk scan (`EamNN.energy_chunked` pair blocks /
        `AtomicNN.energy_chunked` atom-row blocks) — "auto" switches
        when the padded pair count exceeds `chunk_auto_pairs` (a
        threshold sized for the flat-layout autodiff backward on a
        16 GB device; kept as is on larger ones), True forces it,
        False disables.  `chunk_size`: pairs (EAM family) or atom rows
        (descriptor NNs) per block, 0 = default.

        `device_nl=True`: build the neighbor list ON DEVICE
        (`transform/device_nl.py`) instead of host featurization —
        the right mode for trajectory/scan workloads where the same
        (cell, composition) repeats: the first call pays a host census
        to size the capacities, every later call is pure device (bin,
        compact, evaluate — no host work). Builders are cached per
        (cell, symbol-sequence); capacity overflows self-heal by
        growing and rebuilding.

        `device_nl="auto"` (the default): large SINGLE frames route
        through the device builder too — at `device_nl_auto_atoms`+
        atoms (default 8192) host featurization is the dominant cost
        of a one-shot evaluation, so the auto path sizes the
        builder with the O(1)-host density census
        (`DeviceNeighborList(census="density")`) and keeps every
        O(N·nnl) step on device. Angular models (dense triples) stay
        on host featurization under "auto" — their triple capacities
        need the exact census. Small frames keep the host path (no
        build compile for one cheap structure)."""
        # serving processes are usually one-shot: reuse compiled
        # executables across processes (see cache.py); no-op on CPU,
        # opt out with TENSORALLOY_NO_CACHE=1
        from .cache import enable_compilation_cache
        enable_compilation_cache()
        if isinstance(model_or_path, str):
            from .io.model import load_model
            self.model, self.params, self.config = load_model(model_or_path)
        else:
            self.model = model_or_path
            self.params = params
            self.config = {}
        self.chunked = chunked
        self.chunk_size = int(chunk_size)
        self.chunk_auto_pairs = int(chunk_auto_pairs)
        self.device_nl = ("auto" if device_nl == "auto"
                          else bool(device_nl))
        self.device_nl_auto_atoms = int(device_nl_auto_atoms)
        # Scatter-free analytic EFS for the EAM family
        # (`nn/eam/fast_efs.py`): gathers + dense row reductions only —
        # no scatter-adds in forward or backward, no O(npairs)
        # autodiff residuals, so large cells need no chunking either.
        # "auto" = on whenever the model supports it, EXCEPT when the
        # caller explicitly forced chunked=True (an explicit request
        # for the rematerialized autodiff path wins).
        if fast_efs == "auto":
            self.fast_efs = is_eam_family(self.model) and chunked is not True
        else:
            self.fast_efs = bool(fast_efs) and is_eam_family(self.model)
        self._nl_cache: Dict[tuple, object] = {}
        self.featurizer = self.model.featurizer
        # per-layout caches: the model's VAP row layout is static under
        # jit, so each (bucketed) stoichiometry gets its own re-laid-out
        # model clone + compiled executable
        self._variant_cache: Dict[tuple, tuple] = {}
        self._vap_cache: Dict[str, VirtualAtomMap] = {}
        self.results: Dict[str, np.ndarray] = {}
        self._last = None

    @property
    def elements(self):
        return self.featurizer.elements

    @staticmethod
    def _jit_efs(fn):
        """Hook: how (params, feats) property functions are compiled.
        `EnsembleCalculator` overrides this with a vmap over the
        stacked parameter axis."""
        return jax.jit(fn)

    # ------------------------------------------------------------------
    def _bucketed_occurs(self, structure: Structure) -> Counter:
        """Round per-element counts up to powers of two: bounds the
        number of distinct compiled layouts for MD/scan workloads."""
        unknown = set(structure.symbols) - set(self.elements)
        if unknown:
            raise ValueError(
                f"structure contains element(s) {sorted(unknown)} not "
                f"supported by this model (elements: {self.elements})")
        counts = Counter(structure.symbols)
        out = Counter()
        for e, c in counts.items():
            b = 1
            while b < c:
                b *= 2
            out[e] = b
        return out

    def _use_device_nl(self, structure: Structure) -> bool:
        """Resolve the device_nl mode against this structure."""
        if self.device_nl == "auto":
            if len(structure) < self.device_nl_auto_atoms:
                return False
            # dense-triple capacities need the exact (host-NL) census,
            # which costs what the auto path exists to avoid
            if getattr(self.featurizer, "angular", False):
                return False
            return True
        return bool(self.device_nl)

    def _get_variant(self, structure: Structure, use_device: bool = False):
        """(model clone, jitted efs, jitted hessian) for this layout."""
        occurs = self._bucketed_occurs(structure)
        key = (tuple(sorted(occurs.items())), bool(use_device))
        hit = self._variant_cache.get(key)
        if hit is None:
            model = self.model.clone_for(Counter(dict(key[0])))

            # forces/stress/Hessian differentiate the variational energy
            # (free energy for finite-temperature models); atomic
            # energies and finite-T heads ride in the SAME executable so
            # inference is exactly one device call.
            def extras(params, feats, model=model):
                out = {"atomic_energies":
                       model.atomic_energies(params, feats)}
                if hasattr(model, "energy_ops"):
                    ops = model.energy_ops(params, feats)
                    out["energy_U"] = ops["energy"]
                    out["eentropy"] = ops["eentropy"]
                    out["free_energy_F"] = ops["free_energy"]
                return out

            if self.fast_efs:
                from .nn.eam.fast_efs import make_fast_efs_fn
                # analytic E+F+stress (atomic energies included) — no
                # autodiff residuals, so no chunked variant is needed
                efs = self._jit_efs(make_fast_efs_fn(model))
            elif (model_feature_layout(model) == "dense"
                    and not use_device):
                # dense descriptor models: differentiate w.r.t. the
                # pair/triple VECTORS and assemble forces through the
                # featurizer's transpose tables instead of the
                # scatter-add that the autodiff-vs-positions path's
                # gather-VJP lowers to
                from .ops.dense import make_dense_efs_fn
                efs = self._jit_efs(make_dense_efs_fn(
                    model.variational_energy, extras))
            else:
                efs = self._jit_efs(make_efs_fn(model.variational_energy,
                                                extras))
            hess = self._jit_efs(make_hessian_fn(model.variational_energy))
            efs_chunked = None
            layout = model_feature_layout(model, fast=self.fast_efs)
            desc = getattr(model, "descriptor", None)
            if self.fast_efs:
                can_chunk = False
            elif desc is None:  # EAM family: flat pair-block chunks
                can_chunk = hasattr(model, "make_chunked_energy_fn")
            else:               # descriptor NNs: dense row blocks only
                can_chunk = (layout == "dense" and
                             getattr(desc, "algorithm", None) != "nn")
            if self.chunked and can_chunk:   # "auto" or True
                chunk = self.chunk_size or (1 << 20 if layout ==
                                            "segment" else 4096)
                e_fn = model.make_chunked_energy_fn(chunk)
                # finite-T heads ride along (one extra scan; the
                # full atomic-energy vector is monolithic-only)
                extras_c = None
                if hasattr(model, "heads_chunked"):
                    def extras_c(params, feats, model=model,
                                 chunk=chunk):
                        ops = model.heads_chunked(params, feats, chunk)
                        return {"energy_U": ops["energy"],
                                "eentropy": ops["eentropy"],
                                "free_energy_F": ops["free_energy"]}
                efs_chunked = self._jit_efs(make_efs_fn(e_fn, extras_c))
            hit = (model, efs, hess, efs_chunked)
            self._variant_cache[key] = hit
        return hit

    @staticmethod
    def _padded_pairs(feats) -> int:
        if "pair_j_d" in feats:
            a, n = feats["pair_j_d"].shape
            t = (feats["trip_j_d"].shape[0] * feats["trip_j_d"].shape[1]
                 if "trip_j_d" in feats else 0)
            return a * n + t
        if "pair_i" in feats:
            t = feats["trip_i"].shape[0] if "trip_i" in feats else 0
            return int(feats["pair_i"].shape[0]) + t
        return 0

    def _get_vap(self, structure: Structure) -> VirtualAtomMap:
        # keyed by the exact symbol sequence: the local->VAP index map
        # depends on atom order, not just the reduced formula
        key = tuple(structure.symbols)
        vap = self._vap_cache.get(key)
        if vap is None:
            vap = VirtualAtomMap(self._bucketed_occurs(structure),
                                 structure.symbols)
            self._vap_cache[key] = vap
        return vap

    def _features(self, structure: Structure, vap: VirtualAtomMap,
                  layout: Optional[str] = None):
        fz = self.featurizer
        feats = fz.featurize(structure, vap,
                             pair_bucket=lambda n: _bucket(max(n, 1)),
                             trip_bucket=lambda n: _bucket(max(n, 1)),
                             # per-atom neighbor/triple WIDTHS are far
                             # smaller than flat counts: a 256-minimum
                             # bucket would pad every dense row 2-8x
                             nnl_bucket=lambda n: _bucket(max(n, 1),
                                                          minimum=32),
                             ntl_bucket=lambda n: _bucket(max(n, 1),
                                                          minimum=64),
                             dtype=np.float64 if jax.config.jax_enable_x64
                             else np.float32,
                             layout=layout or model_feature_layout(
                                 self.model, fast=self.fast_efs),
                             # transpose tables feed the scatter-free
                             # force assembly of dense descriptor EFS
                             transpose=(layout is None
                                        and not self.fast_efs
                                        and model_feature_layout(
                                            self.model) == "dense"))
        return {k: jnp.asarray(v) for k, v in feats.items()}

    def _features_device(self, structure: Structure,
                         vap: VirtualAtomMap):
        """On-device neighbor list path (`device_nl=True`): cached
        builder per (symbols, pbc) — the cell is a TRACED argument of
        the jitted build, so one builder serves every cell its stencil
        still covers (variable-cell workloads: relax_cell scans,
        strained sweeps, NPT frames reuse one executable instead of
        recompiling per cell byte-pattern); overflow self-heals."""
        from .transform.device_nl import DeviceNeighborList
        key = (tuple(structure.symbols),
               np.asarray(structure.pbc).tobytes())
        b = self._nl_cache.get(key)
        if b is None or not b.covers(structure.cell):
            b = DeviceNeighborList(
                self.featurizer, vap, structure,
                layout=model_feature_layout(self.model,
                                            fast=self.fast_efs),
                # one-shot auto routing must not pay a host neighbor
                # list just to size capacities; explicit device_nl=True
                # (trajectory mode) keeps the exact census it amortizes
                census=("density" if self.device_nl == "auto"
                        else "exact"))
            self._nl_cache[key] = b
        dtype = (np.float64 if jax.config.jax_enable_x64
                 else np.float32)
        pos = jnp.asarray(vap.map_positions(
            structure.positions).astype(dtype))
        cell = jnp.asarray(np.asarray(structure.cell).astype(dtype))
        etemp = float(structure.info.get("etemperature", 0.0) or 0.0)
        for _ in range(8):
            feats, diag = b.build(pos, cell=cell, etemperature=etemp)
            diag = jax.device_get(diag)
            try:
                b.check(diag)
                return feats
            except RuntimeError:
                b = b.grow(diag)
                self._nl_cache[key] = b
        b.check(diag)
        return feats

    # ------------------------------------------------------------------
    def calculate(self, structure: Structure) -> Dict[str, np.ndarray]:
        vap = self._get_vap(structure)
        use_device = self._use_device_nl(structure)
        model, efs, _, efs_chunked = self._get_variant(structure,
                                                       use_device)
        feats = (self._features_device(structure, vap) if use_device
                 else self._features(structure, vap))
        # chunk_auto_pairs is calibrated for the FLAT-segment autodiff
        # backward; the dense row layout holds ~8x less per padded
        # pair, so the threshold scales and large dense frames (the
        # 131k-atom GRAP cell) stay monolithic
        auto_pairs = self.chunk_auto_pairs * (
            8 if "pair_j_d" in feats else 1)
        use_chunked = efs_chunked is not None and (
            self.chunked is True or
            self._padded_pairs(feats) > auto_pairs)
        out = jax.device_get((efs_chunked if use_chunked else efs)(
            self.params, feats))
        self.results = self._assemble(out, vap)
        self._last = self._fingerprint(structure)
        return self.results

    def _assemble(self, out, vap) -> Dict[str, np.ndarray]:
        results = {
            "energy": float(out["energy"]),
            "free_energy": float(out["energy"]),
            "forces": vap.reverse_map(out["forces"]),
            "stress": np.asarray(out["stress_voigt"]),
            "pressure": float(out["total_pressure"]),
        }
        if "atomic_energies" in out:    # monolithic path only
            results["atomic_energies"] = vap.reverse_map(
                out["atomic_energies"])
        if "energy_U" in out:        # finite-temperature heads
            results["energy"] = float(out["energy_U"])
            results["eentropy"] = float(out["eentropy"])
            results["free_energy"] = float(out["free_energy_F"])
        return results

    @staticmethod
    def _fingerprint(structure: Structure):
        """Cheap content fingerprint: identity caching returns stale
        results when the same Structure instance is mutated in place
        (e.g. by an MD/relaxation driver) between calls."""
        etemp = structure.info.get("etemperature", 0.0)
        return (structure.numbers.tobytes(),
                structure.positions.tobytes(),
                structure.cell.tobytes(),
                structure.pbc.tobytes(), float(etemp or 0.0))

    def _maybe_calculate(self, structure: Optional[Structure]):
        if structure is not None:
            fp = self._fingerprint(structure)
            if fp != self._last:
                self.calculate(structure)
        if not self.results:
            raise RuntimeError(
                "no structure has been calculated yet — pass a "
                "Structure to the getter or call calculate() first")
        return self.results

    # ------------------------------------------------------------------
    def get_potential_energy(self, structure: Optional[Structure] = None
                             ) -> float:
        return self._maybe_calculate(structure)["energy"]

    def get_forces(self, structure: Optional[Structure] = None
                   ) -> np.ndarray:
        return self._maybe_calculate(structure)["forces"]

    def get_stress(self, structure: Optional[Structure] = None
                   ) -> np.ndarray:
        return self._maybe_calculate(structure)["stress"]

    def get_total_pressure(self, structure: Optional[Structure] = None
                           ) -> float:
        return self._maybe_calculate(structure)["pressure"]

    def get_atomic_energies(self, structure: Optional[Structure] = None
                            ) -> np.ndarray:
        results = self._maybe_calculate(structure)
        if "atomic_energies" not in results:
            raise ValueError(
                "per-atom energies are not computed on the chunked "
                "large-cell path; construct the calculator with "
                "chunked=False (needs the monolithic working set)")
        return results["atomic_energies"]

    def get_electron_entropy(self, structure: Optional[Structure] = None
                             ) -> float:
        results = self._maybe_calculate(structure)
        if "eentropy" not in results:
            raise ValueError(
                "this model has no electron-entropy head (finite-"
                "temperature pair styles td/* provide one)")
        return results["eentropy"]

    def get_free_energy(self, structure: Optional[Structure] = None
                        ) -> float:
        return self._maybe_calculate(structure)["free_energy"]

    def get_hessian(self, structure: Structure,
                    phonopy_format: bool = False) -> np.ndarray:
        vap = self._get_vap(structure)
        _, _, hess, _ = self._get_variant(structure)
        # the Hessian differentiates the autodiff energy, which reads
        # the layout the MODEL consumes (segment for EAM) even when the
        # fast dense-layout EFS serves first derivatives
        feats = self._features(structure, vap,
                               layout=model_feature_layout(self.model))
        h = np.asarray(hess(self.params, feats))
        return vap.reverse_map_hessian(h, phonopy_format=phonopy_format)

    # ------------------------------------------------------------------
    def as_ase_calculator(self):
        """Optional adapter when ASE is importable."""
        from ase.calculators.calculator import Calculator, all_changes

        outer = self

        class _Adapter(Calculator):
            implemented_properties = ["energy", "free_energy", "forces",
                                      "stress"]

            def calculate(self, atoms=None, properties=("energy",),
                          system_changes=all_changes):
                super().calculate(atoms, properties, system_changes)
                s = Structure(atoms.numbers, atoms.positions,
                              np.asarray(atoms.cell), atoms.pbc)
                res = outer.calculate(s)
                self.results = dict(res)

        return _Adapter()

