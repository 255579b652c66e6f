"""Device-resident molecular dynamics.

The reference delegates MD to LAMMPS/ASE through its exporters; here
the trained potential IS a jittable function, so the whole integrator
runs on the accelerator: velocity-Verlet steps inside one `jax.lax.scan`
(forces re-derived by `jax.grad` each step), with the host only
rebuilding the neighbor list between chunks. No per-step host-device
round trips.

Units: positions A, velocities A/fs, masses amu, energies eV,
time fs. eV/A / amu = 9.64853e-3 A/fs^2.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .atoms import Structure
from .nn.fields import HIGHEST

# (eV/A) / amu in A/fs^2
FORCE_TO_ACC = 9.648533290731905e-3
# Boltzmann constant in eV/K
KB = 8.617330337217213e-05
# eV/A^3 -> GPa
EV_A3_TO_GPA = 160.21766208


def maxwell_boltzmann_velocities(masses: np.ndarray, temperature: float,
                                 seed: int = 0) -> np.ndarray:
    """[N, 3] velocities (A/fs) at `temperature` K, COM removed."""
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(KB * temperature / masses * FORCE_TO_ACC)
    v = rng.normal(size=(len(masses), 3)) * sigma[:, None]
    v -= np.average(v, axis=0, weights=masses)
    return v


class VelocityVerlet:
    """NVE dynamics for one structure with a fixed stoichiometry.

    The pair list is built with a `skin` margin and reused for
    `chunk_size` jitted steps; call `run(n_steps)` and it handles the
    rebuild cadence. Choose `chunk_size * timestep * v_max < skin / 2`.
    """

    def __init__(self, model, params, structure: Structure,
                 timestep: float = 1.0, skin: float = 1.0,
                 chunk_size: int = 20,
                 temperature: Optional[float] = None, seed: int = 0,
                 target_temperature: Optional[float] = None,
                 friction: Optional[float] = None,
                 device_nl: bool = False,
                 target_pressure: Optional[float] = None,
                 pressure_tau: float = 1000.0,
                 compressibility: float = 5e-3,
                 record_heat_flux: bool = False,
                 record_stress: bool = False,
                 fast_efs: "bool | str" = "auto",
                 anisotropic: bool = False):
        """`temperature` seeds Maxwell-Boltzmann initial velocities
        (NVE). Setting BOTH `target_temperature` (K) and `friction`
        (1/fs) switches the integrator to the BAOAB Langevin
        splitting (Leimkuhler & Matthews 2013) — NVT sampling with
        the same one-force-evaluation-per-step cost, noise generated
        on device inside the scan.

        `device_nl=True` moves the between-chunk neighbor-list rebuild
        onto the device too (`transform/device_nl.py`): each jitted
        chunk re-bins atoms, rebuilds the skinned pair list, and
        integrates `chunk_size` steps — positions/velocities never
        leave the device, the host only checks the overflow
        diagnostics (two scalars per chunk).

        `record_heat_flux=True` evaluates the exact many-body heat
        flux (`analysis.heatflux`) at every chunk end INSIDE the
        jitted kernel — with `device_nl` a Green-Kubo production run
        never featurizes on the host at all. One extra backward pass
        per chunk, not per step.

        `record_stress=True` records the FULL instantaneous stress
        tensor (potential virial + kinetic part, eV/A^3) at every
        chunk end inside the jitted kernel — feeds the Green-Kubo
        shear viscosity (`analysis.heatflux.green_kubo_viscosity`).

        `target_pressure` (GPa) switches on the isotropic Berendsen
        barostat (NPT when combined with the Langevin thermostat):
        each step scales positions and cell by
        ``mu = (1 - dt/pressure_tau * compressibility * (P0 - P))^(1/3)``
        with the instantaneous ``P`` = virial + kinetic pressure.
        The stress comes from the SAME backward pass as the forces
        (value_and_grad over positions and cell), so an NPT step costs
        essentially an NVE step. `pressure_tau` in fs;
        `compressibility` in 1/GPa (default ~metals, 1/B with
        B ~ 200 GPa)."""
        self.base_model = model
        self.params = params
        self.structure = structure.copy()
        self.timestep = float(timestep)
        self.skin = float(skin)
        self.chunk_size = int(chunk_size)
        self.target_temperature = target_temperature
        self.friction = friction
        if (target_temperature is None) != (friction is None):
            raise ValueError("Langevin NVT needs both "
                             "target_temperature and friction")
        self.target_pressure = target_pressure
        self.pressure_tau = float(pressure_tau)
        self.compressibility = float(compressibility)
        # anisotropic=True upgrades the Berendsen barostat to the full
        # symmetric pressure TENSOR: each cell axis (and shear) relaxes
        # its own stress component toward the isotropic target — the
        # right tool for non-cubic cells (grain boundaries, interfaces,
        # strained slabs) where the scalar barostat cannot remove a
        # deviatoric stress.
        self.anisotropic = bool(anisotropic)
        if anisotropic and target_pressure is None:
            raise ValueError("anisotropic=True needs target_pressure")
        if target_pressure is not None and not structure.pbc.all():
            raise ValueError("the barostat needs a fully periodic cell")
        self._key = jax.random.PRNGKey(seed + 7919)

        self.model = model.clone_for(Counter(structure.symbols))
        self.record_heat_flux = bool(record_heat_flux)
        self.record_stress = bool(record_stress)
        # Scatter-free analytic EFS for EAM-family models
        # (`nn/eam/fast_efs.py`): the per-step force evaluation becomes
        # gathers + dense row reductions instead of autodiff whose
        # gather-VJPs lower to scatter-adds — and the exact
        # many-body heat flux has the same analytic form
        # (make_fast_heat_flux_fn), so Green-Kubo production is
        # scatter-free too. Descriptor models keep the autodiff path
        # (their flux needs the segment layout's owner-anchored rij).
        from .calculator import is_eam_family
        if fast_efs == "auto":
            self._use_fast_efs = is_eam_family(self.model)
        else:
            self._use_fast_efs = bool(fast_efs) and \
                is_eam_family(self.model)
        self._flux_fn = None
        if self.record_heat_flux:
            if self._use_fast_efs:
                from .nn.eam.fast_efs import make_fast_heat_flux_fn
                self._flux_fn = make_fast_heat_flux_fn(self.model)
            else:
                from .analysis.heatflux import make_heat_flux_fn
                # raises for dense-backend descriptors up front
                self._flux_fn = make_heat_flux_fn(self.model)
        self.fz = model.featurizer
        self.vap = self.fz.make_vap(structure,
                                    Counter(structure.symbols))
        masses_local = structure.masses
        self.masses_vap = np.zeros(self.model.n_atoms_vap)
        self.masses_vap[self.vap.local_to_vap] = masses_local
        self.masses_vap[0] = 1.0     # virtual atom: inert unit mass

        velocities = (maxwell_boltzmann_velocities(
            masses_local, temperature, seed)
            if temperature else np.zeros((len(structure), 3)))
        self.velocities_vap = np.zeros((self.model.n_atoms_vap, 3))
        self.velocities_vap[self.vap.local_to_vap] = velocities

        self._scan = None
        self._nij_cached = -1
        self._nl = None
        if device_nl:
            from .calculator import model_feature_layout
            from .transform.device_nl import DeviceNeighborList
            self._nl = DeviceNeighborList(
                self.fz, self.vap, structure,
                cutoff=self.fz.max_cutoff + self.skin,
                layout=model_feature_layout(self.model,
                                            fast=self._use_fast_efs))

    # ------------------------------------------------------------------
    def _build_features(self, positions_local: np.ndarray) -> Dict:
        from .calculator import model_feature_layout
        s = self.structure.copy()
        s.positions = positions_local
        pad = lambda n: max(256, 1 << int(np.ceil(np.log2(max(n, 1)))))
        wpad = lambda n: max(32, 1 << int(np.ceil(np.log2(max(n, 1)))))
        feats = self.fz.featurize(
            s, self.vap, pair_bucket=pad, trip_bucket=pad,
            nnl_bucket=wpad, ntl_bucket=wpad,
            dtype=np.float64 if jax.config.jax_enable_x64
            else np.float32,
            layout=model_feature_layout(self.model,
                                        fast=self._use_fast_efs))
        return feats

    def _integrator(self):
        """Shared per-step physics for the host- and device-NL chunk
        kernels: returns (forces_of, step, finish) closures. The carry
        is (pos, vel, acc, p_pot, cell, key, feats); `cell` is dynamic
        only under the barostat (NPT), otherwise it passes through."""
        model, dt = self.model, self.timestep
        masses = jnp.asarray(self.masses_vap)[:, None]
        mask = jnp.asarray(self.vap.atom_masks)[:, None]
        langevin = self.friction is not None
        npt = self.target_pressure is not None
        aniso = self.anisotropic
        if langevin:
            c1 = float(np.exp(-self.friction * dt))
            c2 = float(np.sqrt(1.0 - c1 * c1))
            # thermal velocity scale per atom (A/fs)
            sigma_v = jnp.sqrt(KB * self.target_temperature / masses *
                               FORCE_TO_ACC) * mask

        fast_fn = None
        if self._use_fast_efs:
            from .nn.eam.fast_efs import make_fast_efs_fn
            fast_fn = make_fast_efs_fn(model)

        def pot_pressure(virial, cell):
            """Potential pressure: tensor -virial/V (GPa) under the
            anisotropic barostat, its trace/3 otherwise."""
            vol = jnp.maximum(jnp.abs(jnp.linalg.det(cell)), 1e-12)
            if aniso:
                return -virial / vol * EV_A3_TO_GPA
            return -jnp.trace(virial) / vol / 3.0 * EV_A3_TO_GPA

        def forces_of(feats, pos, cell):
            """-> (forces, potential pressure GPa — a [3,3] tensor
            under the anisotropic barostat). Under NPT the pressure
            rides the SAME backward (grad over pos + cell); the fast
            path reads both from one analytic pass."""
            if fast_fn is not None:
                out = fast_fn(self.params,
                              dict(feats, positions=pos, cell=cell))
                if not npt:
                    return out["forces"] * mask, jnp.zeros((), pos.dtype)
                return out["forces"] * mask, pot_pressure(out["virial"],
                                                          cell)

            def e_of(p, h):
                return model.variational_energy(
                    self.params, dict(feats, positions=p, cell=h))
            if not npt:
                g = jax.grad(e_of)(pos, cell)
                return -g * mask, jnp.zeros((), pos.dtype)
            gpos, gcell = jax.grad(e_of, argnums=(0, 1))(pos, cell)
            virial = (jnp.dot(gpos.T, pos, precision=HIGHEST) +
                      jnp.dot(gcell.T, cell, precision=HIGHEST))
            return -gpos * mask, pot_pressure(virial, cell)

        def kinetic(vel):
            return 0.5 * jnp.sum(masses * jnp.square(vel) * mask) / \
                FORCE_TO_ACC

        def barostat(pos, vel, cell, p_pot):
            vol = jnp.maximum(jnp.abs(jnp.linalg.det(cell)), 1e-12)
            if aniso:
                # full-tensor Berendsen: mu = I - dt beta/(3 tau)
                # (P0 I - P_inst), P_inst = P_pot + m v (x) v / V
                # (symmetric -> no cell rotation); per-component clip
                # mirrors the scalar 1% safety bound
                mvv = jnp.dot((vel * masses * mask).T, vel,
                              precision=HIGHEST) / FORCE_TO_ACC
                p_inst = p_pot + mvv / vol * EV_A3_TO_GPA
                eye = jnp.eye(3, dtype=pos.dtype)
                delta = -dt / (3.0 * self.pressure_tau) * \
                    self.compressibility * \
                    (self.target_pressure * eye - p_inst)
                mu = eye + jnp.clip(delta, -0.01, 0.01)
                return pos @ mu.T, cell @ mu.T
            p_kin = (2.0 / 3.0) * kinetic(vel) / vol * EV_A3_TO_GPA
            p_inst = p_pot + p_kin
            mu = (1.0 - dt / self.pressure_tau * self.compressibility *
                  (self.target_pressure - p_inst)) ** (1.0 / 3.0)
            mu = jnp.clip(mu, 0.99, 1.01)
            return pos * mu, cell * mu

        def step(carry, _):
            # carry the end-of-step acceleration: every integrator needs
            # ONE new force evaluation per step, not two
            pos, vel, acc, p_pot, cell, key, feats = carry
            if langevin:
                # BAOAB: B(half kick) A(half drift) O(OU noise)
                #        A(half drift) B(half kick)
                vel = vel + 0.5 * dt * acc
                pos = pos + 0.5 * dt * vel
                key, sub = jax.random.split(key)
                xi = jax.random.normal(sub, vel.shape, vel.dtype)
                vel = c1 * vel + c2 * sigma_v * xi
                pos = pos + 0.5 * dt * vel
                forces, p_pot = forces_of(feats, pos, cell)
                acc_new = forces / masses * FORCE_TO_ACC
                vel = vel + 0.5 * dt * acc_new
            else:
                vel_half = vel + 0.5 * dt * acc
                pos = pos + dt * vel_half
                forces, p_pot = forces_of(feats, pos, cell)
                acc_new = forces / masses * FORCE_TO_ACC
                vel = vel_half + 0.5 * dt * acc_new
            if npt:
                pos, cell = barostat(pos, vel, cell, p_pot)
            return (pos, vel, acc_new, p_pot, cell, key, feats), None

        def finish(pos, vel, cell, p_pot, feats):
            """Chunk-end observables: (potential, kinetic, P_inst, J).

            When `record_heat_flux` is on, the exact many-body heat
            flux rides the chunk-end evaluation (one extra backward,
            amortized over `chunk_size` steps)."""
            if fast_fn is not None:
                out = fast_fn(self.params,
                              dict(feats, positions=pos, cell=cell))
                energy = out["energy"]
            else:
                out = None
                energy = model.variational_energy(
                    self.params, dict(feats, positions=pos, cell=cell))
            ke = kinetic(vel)
            vol = jnp.maximum(jnp.abs(jnp.linalg.det(cell)), 1e-12)
            p_scalar = jnp.trace(p_pot) / 3.0 if aniso else p_pot
            p_inst = p_scalar + (2.0 / 3.0) * ke / vol * EV_A3_TO_GPA
            if self._flux_fn is not None:
                j = self._flux_fn(
                    self.params, dict(feats, positions=pos, cell=cell),
                    vel, masses[:, 0])["J"]
            else:
                j = jnp.zeros(3, pos.dtype)
            if self.record_stress:
                if out is not None:
                    virial = out["virial"]
                else:
                    def e_of(p, h):
                        return model.variational_energy(
                            self.params, dict(feats, positions=p, cell=h))
                    gpos, gcell = jax.grad(e_of, argnums=(0, 1))(pos, cell)
                    virial = (jnp.dot(gpos.T, pos, precision=HIGHEST) +
                              jnp.dot(gcell.T, cell, precision=HIGHEST))
                mv = vel * masses * mask
                sigma = (virial - jnp.dot(mv.T, vel, precision=HIGHEST)
                         / FORCE_TO_ACC) / vol
            else:
                sigma = jnp.zeros((3, 3), pos.dtype)
            return energy, ke, p_inst, j, sigma

        return forces_of, step, finish

    def _make_scan(self):
        forces_of, step, finish = self._integrator()

        def chunk(pos, vel, cell, key, feats, n):
            forces0, p0 = forces_of(feats, pos, cell)
            acc0 = forces0 / jnp.asarray(self.masses_vap)[:, None] * \
                FORCE_TO_ACC
            (pos, vel, _, p_pot, cell, key, _), _ = jax.lax.scan(
                step, (pos, vel, acc0, p0, cell, key, feats), None,
                length=n)
            energy, ke, p_inst, j, sig = finish(pos, vel, cell,
                                                 p_pot, feats)
            return pos, vel, cell, key, energy, ke, p_inst, j, sig

        return jax.jit(chunk, static_argnames="n")

    def _make_scan_device(self):
        """Chunk kernel with the neighbor rebuild INSIDE the jit: bin,
        compact, integrate `n` steps — one device call per chunk."""
        builder = self._nl
        forces_of, step, finish = self._integrator()
        etemp0 = float(self.structure.info.get("etemperature", 0.0) or 0.0)

        def chunk(pos, vel, cell, key, n):
            feats, diag = builder._build(
                pos, cell, jnp.asarray(etemp0, pos.dtype))
            forces0, p0 = forces_of(feats, pos, cell)
            acc0 = forces0 / jnp.asarray(self.masses_vap)[:, None] * \
                FORCE_TO_ACC
            (pos, vel, _, p_pot, cell, key, _), _ = jax.lax.scan(
                step, (pos, vel, acc0, p0, cell, key, feats), None,
                length=n)
            energy, ke, p_inst, j, sig = finish(pos, vel, cell,
                                                 p_pot, feats)
            return (pos, vel, cell, key, energy, ke, p_inst, j, sig,
                    diag)

        return jax.jit(chunk, static_argnames="n")

    def _record(self, history, pe, ke, p_inst, cell,
                pos=None, vel=None, jflux=None, sigma=None):
        ndof = 3 * len(self.structure)
        if "heat_flux" in history:
            history["heat_flux"].append(np.asarray(jflux).copy())
        if "stress_tensor" in history:
            history["stress_tensor"].append(np.asarray(sigma).copy())
        history["potential"].append(float(pe))
        history["kinetic"].append(float(ke))
        history["total"].append(float(pe) + float(ke))
        history["temperature"].append(2.0 * float(ke) / (ndof * KB))
        if self.target_pressure is not None:
            history["pressure"].append(float(p_inst))
            history["volume"].append(
                float(abs(np.linalg.det(np.asarray(cell)))))
        if "positions" in history:
            # local order, UNWRAPPED (the integrator never wraps) —
            # directly usable by analysis.trajectory MSD/diffusion
            history["positions"].append(
                np.asarray(pos)[self.vap.local_to_vap].copy())
            history["velocities"].append(
                np.asarray(vel)[self.vap.local_to_vap].copy())
            history["cells"].append(np.asarray(cell).copy())

    def _history(self, record_trajectory=False):
        h = {"potential": [], "kinetic": [], "total": [],
             "temperature": []}
        if self.target_pressure is not None:
            h["pressure"], h["volume"] = [], []
        if record_trajectory:
            h["positions"], h["velocities"], h["cells"] = [], [], []
        if self.record_heat_flux:
            h["heat_flux"] = []
        if self.record_stress:
            h["stress_tensor"] = []
        return h

    def _run_device(self, n_steps: int, record_trajectory=False):
        dtype = (np.float64 if jax.config.jax_enable_x64
                 else np.float32)
        pos = jnp.asarray(self.vap.map_positions(
            self.structure.positions).astype(dtype))
        vel = jnp.asarray(self.velocities_vap.astype(dtype))
        cell = jnp.asarray(self.structure.cell.astype(dtype))
        if self._scan is None:
            self._scan = self._make_scan_device()
        history = self._history(record_trajectory)
        remaining = n_steps
        while remaining > 0:
            n = min(self.chunk_size, remaining)
            out = self._scan(pos, vel, cell, self._key, n)
            diag = jax.device_get(out[9])
            try:
                self._nl.check(diag)
            except RuntimeError:
                # capacity overflow: the chunk used a truncated pair
                # list — grow the builder and REDO it from the carried
                # pre-chunk state (pos/vel were not reassigned yet)
                self._nl = self._nl.grow(diag)
                self._scan = self._make_scan_device()
                continue
            (pos, vel, cell, self._key, pe, ke, p_inst, jflux,
             sig, _) = out
            self._record(history, pe, ke, p_inst, cell, pos, vel,
                         jflux, sig)
            remaining -= n
            if self.target_pressure is not None:
                # the grid is static in FRACTIONAL space: a barostat
                # shrink narrows the bins until the stencil no longer
                # spans the skinned cutoff. The skin absorbs in-chunk
                # drift; re-grid for the next chunk once the margin is
                # consumed. Reach below the BARE cutoff means the last
                # chunk may have run on a truncated list — refuse.
                cell_h = np.asarray(cell)
                if not self._nl.covers(cell_h, self.fz.max_cutoff):
                    raise RuntimeError(
                        "barostat shrank the cell past the neighbor "
                        "stencil within one chunk; use a smaller "
                        "chunk_size or a larger skin")
                if not self._nl.covers(cell_h):
                    tmpl = self.structure.copy()
                    tmpl.positions = np.asarray(pos)[
                        self.vap.local_to_vap]
                    tmpl.cell = cell_h
                    self._nl = self._nl.rebuilt_for(tmpl)
                    self._scan = self._make_scan_device()
        self.structure.positions = np.asarray(pos)[self.vap.local_to_vap]
        self.structure.cell = np.asarray(cell)
        self.velocities_vap = np.asarray(vel)
        return history

    # ------------------------------------------------------------------
    def run(self, n_steps: int, record_trajectory: bool = False):
        """Integrate `n_steps`; returns a dict with the per-chunk
        thermo history (potential, kinetic, total, temperature; plus
        pressure/volume under NPT). `record_trajectory=True` also
        stores per-chunk UNWRAPPED positions, velocities, and cells —
        the exact inputs `analysis.trajectory` (RDF/MSD/VACF/D)
        expects."""
        if self._nl is not None:
            return self._run_device(n_steps, record_trajectory)
        pos_local = self.structure.positions.copy()
        vel = jnp.asarray(self.velocities_vap)
        history = self._history(record_trajectory)
        remaining = n_steps
        while remaining > 0:
            n = min(self.chunk_size, remaining)
            # rebuild the (skinned) neighbor list on the host (at the
            # CURRENT cell — the barostat may have rescaled it)
            old_rcut = self.fz.rcut
            feats_np = None
            try:
                self.fz.rcut += self.skin
                feats_np = self._build_features(pos_local)
            finally:
                self.fz.rcut = old_rcut
            feats = {k: jnp.asarray(v) for k, v in feats_np.items()}
            # one scan closure for the run; jit re-specializes per
            # feature shape signature (dense layouts have no pair_i)
            if self._scan is None:
                self._scan = self._make_scan()
            dtype = np.asarray(feats["positions"]).dtype
            pos_vap = jnp.asarray(self.vap.map_positions(
                pos_local).astype(dtype))
            feats["positions"] = pos_vap
            cell = jnp.asarray(self.structure.cell.astype(dtype))
            (pos_vap, vel, cell, self._key, pe, ke, p_inst,
             jflux, sig) = self._scan(
                pos_vap, vel, cell, self._key, feats, n)
            pos_local = np.asarray(pos_vap)[self.vap.local_to_vap]
            self.structure.cell = np.asarray(cell)
            self._record(history, pe, ke, p_inst, cell, pos_vap, vel,
                         jflux, sig)
            remaining -= n
        self.structure.positions = pos_local
        self.velocities_vap = np.asarray(vel)
        return history


    # ------------------------------------------------------------------
    def zero_com_velocity(self) -> None:
        """Remove the center-of-mass drift (mass-weighted). A Langevin
        thermostat random-walks the total momentum; call this before
        an NVE production run whose observables are drift-sensitive
        (heat flux, MSD)."""
        m = self.masses_vap[:, None] * self.vap.atom_masks[:, None]
        v_com = (m * self.velocities_vap).sum(0) / m.sum()
        self.velocities_vap = (self.velocities_vap - v_com[None]) \
            * self.vap.atom_masks[:, None]

    # ------------------------------------------------------------------
    def save_state(self, path: str) -> None:
        """Checkpoint the integrator state (positions, velocities,
        cell, thermostat RNG key) to one npz — `load_state` resumes a
        production run BIT-EXACTLY as long as the chunk boundaries
        line up (run(10)+run(10) == run(20) for chunk_size dividing
        both)."""
        np.savez(path,
                 positions=self.structure.positions,
                 cell=self.structure.cell,
                 velocities_vap=self.velocities_vap,
                 key=np.asarray(self._key))

    def load_state(self, path: str) -> None:
        """Restore a `save_state` checkpoint (same structure/model)."""
        d = np.load(path)
        if d["velocities_vap"].shape != self.velocities_vap.shape:
            raise ValueError(
                "state file does not match this system: velocities "
                f"{d['velocities_vap'].shape} vs "
                f"{self.velocities_vap.shape}")
        self.structure.positions = d["positions"].copy()
        self.structure.cell = d["cell"].copy()
        self.velocities_vap = d["velocities_vap"].copy()
        self._key = jnp.asarray(d["key"])
        # A device neighbor list keeps its grid sized for the
        # construction-time cell; a checkpoint written at a different
        # cell (e.g. an NPT run resumed as NVE) would otherwise run on
        # a stencil that no longer spans the cutoff — mirror the
        # barostat re-grid path here.
        if self._nl is not None and not self._nl.covers(
                self.structure.cell):
            self._nl = self._nl.rebuilt_for(self.structure.copy())
            self._scan = None

    @property
    def temperature(self) -> float:
        """Instantaneous temperature (K)."""
        masses = self.masses_vap[:, None]
        mask = self.vap.atom_masks[:, None]
        ke = 0.5 * np.sum(masses * self.velocities_vap ** 2 * mask) / \
            FORCE_TO_ACC
        ndof = 3 * len(self.structure)
        return 2.0 * ke / (ndof * KB)
