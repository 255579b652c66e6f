"""Green-Kubo thermal conductivity from an exact autodiff heat flux.

The reference framework has no thermal-transport capability at all (it
delegates MD to LAMMPS through its exporters, and LAMMPS' own
`compute heat/flux` is WRONG for many-body potentials unless the
centroid form is used).  Here the potential is a pure JAX function of
the pair displacement vectors, so the EXACT many-body heat flux is one
`jax.value_and_grad` against them — the same rij-fed contract as
`nn.fields.make_rij_efs_fn` (reference `use_computed_dists=False`,
`transformer/universal.py:265-276`).

Math.  Every site energy in this framework is a function of the
displacement vectors anchored at its owner atom: E_i({d_q : o(q)=i})
with d_q = r_{n(q)} - r_{o(q)} (radial pairs `pair_i -> pair_j`,
angular triples `trip_i -> trip_j/trip_k`; see `ops/pairs.py`).  With
g_q = dE_total/d(d_q) = dE_{o(q)}/d(d_q) (owner-only dependence), the
microscopic energy current J = d/dt sum_i r_i (E_i + K_i) reduces to
the manifestly translation- and gauge-invariant operator

    J = sum_i (E_i + K_i) v_i  -  sum_q d_q (g_q . v_{n(q)})

(the absolute-position terms cancel between the potential piece and
the kinetic piece dK_i/dt = F_i . v_i).  This is the Hardy/Fan form
[Fan et al., PRB 92, 094301 (2015), Eq. 24] generalised to any owner-
anchored many-body decomposition — EAM/ADP, symmetry functions, GRAP
moment tensors alike.  Uniform velocities give the enthalpy-transport
identity J = (E + K) v - W^T v with W the potential virial.

Green-Kubo:  kappa = 1 / (V kB T^2) * int_0^inf <J(0) . J(t)>/3 dt,
with the HCACF averaged over all time origins.

Units follow `dynamics.py`: eV, A, fs, amu -> J in eV*A/fs, kappa
converted to W/(m K).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..dynamics import FORCE_TO_ACC, KB
from ..ops.pairs import pair_vectors

__all__ = ["make_heat_flux_fn", "make_atomic_virial_fn",
           "trajectory_heat_flux", "green_kubo",
           "green_kubo_viscosity"]

# 1 eV/(A fs K) in W/(m K): eV->J, A->m, fs->s
EV_A_FS_TO_W_MK = 1.602176634e-19 / (1e-10 * 1e-15)


def _trip_vectors(features):
    """Owner-anchored triple displacement vectors (d_ij, d_ik)."""
    pos, cell = features["positions"], features["cell"]
    ri = pos[features["trip_i"]]
    dij = (pos[features["trip_j"]] + features["trip_shift_j"] @ cell
           - ri)
    dik = (pos[features["trip_k"]] + features["trip_shift_k"] @ cell
           - ri)
    return dij, dik



def _site_energy_fn(model):
    """Per-atom site energies CONSISTENT with the forces: finite-T
    models differentiate the free energy F = U - T S (reference
    `basic.py:190-202` variational_energy), so the transported site
    energy on the ionic surface is F_i, not U_i."""
    if hasattr(model, "_atomic_heads"):
        return lambda params, feats: \
            model._atomic_heads(params, feats)["free_energy"]
    return model.atomic_energies


def make_heat_flux_fn(model) -> Callable:
    """-> fn(params, features, velocities, masses) -> dict.

    `features`: one structure's segment-layout features (the flat pair
    arrays; the owner-anchored rij-fed energy contract only exists
    there).  `velocities` [n_vap, 3] A/fs and `masses` [n_vap] amu in
    VAP order (virtual row 0 arbitrary — it is masked out).

    Returns {"J", "J_convective", "J_virial" [3] eV*A/fs,
    "energy" scalar, "atomic_energies" [n_vap]}.
    """
    backend = getattr(getattr(model, "descriptor", None), "backend",
                      "segment")
    if backend != "segment":
        raise ValueError(
            "heat flux needs the flat segment descriptor backend "
            f"(owner-anchored rij-fed gradients); got {backend!r}")

    site_energies = _site_energy_fn(model)

    def flux(params, features, velocities, masses
             ) -> Dict[str, jnp.ndarray]:
        feats = dict(features)
        keys = ["rij"]
        vecs = [pair_vectors(features)]
        if "trip_i" in features:
            dij, dik = _trip_vectors(features)
            keys += ["trip_rij", "trip_rik"]
            vecs += [dij, dik]

        def e_of(*vs):
            f = dict(feats)
            f.update(zip(keys, vs))
            ae = site_energies(params, f)
            return jnp.sum(ae), ae

        (energy, ae), grads = jax.value_and_grad(
            e_of, argnums=tuple(range(len(keys))),
            has_aux=True)(*vecs)
        grads = dict(zip(keys, grads))
        vecs = dict(zip(keys, vecs))

        amask = features["atom_masks"]
        kin = 0.5 * masses * jnp.sum(jnp.square(velocities), axis=-1) \
            / FORCE_TO_ACC
        conv = jnp.sum(((ae + kin * amask))[:, None] * velocities,
                       axis=0)

        def virial_term(vec_key, neighbor_key):
            g = grads[vec_key]
            vn = velocities[features[neighbor_key]]
            return -jnp.sum(vecs[vec_key]
                            * jnp.sum(g * vn, axis=-1, keepdims=True),
                            axis=0)

        jv = virial_term("rij", "pair_j")
        if "trip_rij" in grads:
            jv = jv + virial_term("trip_rij", "trip_j")
            jv = jv + virial_term("trip_rik", "trip_k")

        return {"J": conv + jv, "J_convective": conv, "J_virial": jv,
                "energy": energy, "atomic_energies": ae}

    return flux


def make_atomic_virial_fn(model) -> Callable:
    """-> fn(params, features) -> {"atomic_virials" [n_vap, 3, 3],
    "virial" [3, 3], "atomic_energies", "energy"}.

    Per-atom virials by the same owner-anchored pair/triple gradients
    as the heat flux: W_i = sum_{q: o(q)=i} g_q (x) d_q, which sums
    EXACTLY to the total potential virial (g.T @ d in
    `nn.fields.make_rij_efs_fn`). The per-atom decomposition is the
    standard atomistic local-stress diagnostic (grain boundaries,
    defect cores, surface stress); the reference has no analog.
    """
    backend = getattr(getattr(model, "descriptor", None), "backend",
                      "segment")
    if backend != "segment":
        raise ValueError(
            "atomic virials need the flat segment descriptor backend "
            f"(owner-anchored rij-fed gradients); got {backend!r}")

    site_energies = _site_energy_fn(model)

    def virials(params, features) -> Dict[str, jnp.ndarray]:
        feats = dict(features)
        keys = ["rij"]
        vecs = [pair_vectors(features)]
        if "trip_i" in features:
            dij, dik = _trip_vectors(features)
            keys += ["trip_rij", "trip_rik"]
            vecs += [dij, dik]

        def e_of(*vs):
            f = dict(feats)
            f.update(zip(keys, vs))
            ae = site_energies(params, f)
            return jnp.sum(ae), ae

        (energy, ae), grads = jax.value_and_grad(
            e_of, argnums=tuple(range(len(keys))),
            has_aux=True)(*vecs)
        grads = dict(zip(keys, grads))
        vecs = dict(zip(keys, vecs))
        n_vap = features["positions"].shape[0]

        def seg_outer(vec_key, owner_key):
            outer = grads[vec_key][:, :, None] \
                * vecs[vec_key][:, None, :]
            return jax.ops.segment_sum(outer, features[owner_key],
                                       num_segments=n_vap)

        w = seg_outer("rij", "pair_i")
        if "trip_rij" in grads:
            w = w + seg_outer("trip_rij", "trip_i")
            w = w + seg_outer("trip_rik", "trip_i")
        return {"atomic_virials": w, "virial": jnp.sum(w, axis=0),
                "atomic_energies": ae, "energy": energy}

    return virials


def trajectory_heat_flux(model, params, structure, positions, velocities,
                         cells=None, featurizer=None) -> np.ndarray:
    """J(t) [n_frames, 3] (eV*A/fs) for a recorded MD trajectory.

    `positions`/`velocities` [n_frames, N, 3] in LOCAL atom order (as
    recorded by `dynamics.VelocityVerlet.run(record_trajectory=True)`);
    `cells` [n_frames, 3, 3] or None for the fixed structure cell.
    Each frame is featurized on the host (exact neighbor list) and the
    flux is one jitted device call; frames share the compiled program
    via capacity-padded shapes.
    """
    from ..atoms import Structure
    from ..calculator import is_eam_family

    fz = featurizer or model.featurizer
    vap = fz.make_vap(structure, model.max_occurs)
    fast = is_eam_family(model)
    if fast:
        # EAM family: the analytic scatter-free flux on the dense
        # layout (`nn/eam/fast_efs.make_fast_heat_flux_fn`)
        from ..nn.eam.fast_efs import make_fast_heat_flux_fn
        flux = jax.jit(make_fast_heat_flux_fn(model))
    else:
        flux = jax.jit(make_heat_flux_fn(model))
    masses = jnp.asarray(vap.map_array(structure.masses))

    n_frames = len(positions)
    # One host pre-scan sizes the padded pair/triple capacity over the
    # WHOLE trajectory before the first device compile: a melting or
    # expanding trajectory previously grew the capacity mid-run and
    # re-entered XLA compilation for every growth step.  The host
    # arrays are already in memory, so the extra
    # neighbor-count pass is cheap by comparison.
    frames = []
    nij_max = nijk_max = nnl_max = 0
    for t in range(n_frames):
        s = Structure(structure.numbers, np.asarray(positions[t]),
                      structure.cell if cells is None
                      else np.asarray(cells[t]), structure.pbc)
        frames.append(s)
        ns = fz.neighbor_size(s)
        nij_max = max(nij_max, ns.nij)
        nijk_max = max(nijk_max, ns.nijk)
        nnl_max = max(nnl_max, ns.nnl_tot)
    out = np.zeros((n_frames, 3))
    for t, s in enumerate(frames):
        if fast:
            feats = fz.featurize(s, vap, layout="dense",
                                 nnl_max=max(nnl_max, 1))
        else:
            feats = fz.featurize(s, vap, layout="segment",
                                 nij_max=nij_max,
                                 nijk_max=nijk_max or None)
        v_vap = vap.map_array(np.asarray(velocities[t]))
        res = flux(params, {k: jnp.asarray(v) for k, v in feats.items()},
                   jnp.asarray(v_vap), masses)
        out[t] = np.asarray(res["J"])
    return out


# 1 eV*fs/A^3 in Pa*s
EV_FS_A3_TO_PA_S = 1.602176634e-19 / 1e-30 * 1e-15


def gk_plateau(acf: np.ndarray, running: np.ndarray
               ) -> Dict[str, float]:
    """Plateau estimate of a running Green-Kubo integral.

    The long-lag tail of a finite trajectory carries no signal — once
    the ACF has decayed, each added lag only random-walks the running
    integral (a 600 ps chip seed went NEGATIVE at max lag), so 'mean
    of the last half of lags' is biased by exactly the lags with the
    least information.  Standard practice instead: find t0 = the
    first lag where the ACF has decayed (first nonpositive value or
    <1% of ACF[0], whichever comes first) and average the running
    integral over the window [t0, 5*t0] — after decay, before the
    noise accumulates.

    Returns {"value", "stderr" (over the window, ddof=1), "lag_lo",
    "lag_hi" (indices)}.
    """
    acf = np.asarray(acf, np.float64)
    running = np.asarray(running, np.float64)
    a0 = abs(float(acf[0])) + 1e-300
    decayed = np.where((acf <= 0.0) | (np.abs(acf) < 0.01 * a0))[0]
    t0 = int(decayed[0]) if len(decayed) else max(len(running) // 4, 1)
    t0 = max(t0, 1)
    hi = int(min(len(running), max(5 * t0, t0 + 4)))
    win = running[t0:hi]
    se = float(win.std(ddof=1) / np.sqrt(len(win))) if len(win) > 1 \
        else 0.0
    return {"value": float(win.mean()), "stderr": se,
            "lag_lo": t0, "lag_hi": hi}


def green_kubo_viscosity(stress: np.ndarray, dt: float, volume: float,
                         temperature: float,
                         max_lag: Optional[int] = None
                         ) -> Dict[str, np.ndarray]:
    """Green-Kubo shear viscosity from an instantaneous-stress series:
    eta = V / (kB T) * int <sigma_ab(0) sigma_ab(t)> dt, ACF averaged
    over the three off-diagonal components and all time origins.

    `stress` [n_frames, 3, 3] in eV/A^3 (FULL microscopic stress incl.
    the kinetic part, e.g. `dynamics.VelocityVerlet(record_stress=
    True)`), `dt` fs between frames, `volume` A^3, `temperature` K.

    Returns {"lags" fs, "sacf" (eV/A^3)^2, "eta_running" Pa*s,
    "eta" float}.
    """
    s = np.asarray(stress, dtype=np.float64)
    comps = np.stack([s[:, 0, 1], s[:, 0, 2], s[:, 1, 2]], axis=1)
    comps = comps - comps.mean(axis=0, keepdims=True)
    n = len(comps)
    if max_lag is None:
        max_lag = n // 2
    max_lag = int(min(max_lag, n - 1))
    acf = np.empty(max_lag + 1)
    for lag in range(max_lag + 1):
        acf[lag] = np.mean(comps[:n - lag] * comps[lag:])
    lags = np.arange(max_lag + 1) * dt
    integ = np.concatenate(
        [[0.0], np.cumsum(0.5 * (acf[1:] + acf[:-1]) * dt)])
    pref = EV_FS_A3_TO_PA_S * volume / (KB * temperature)
    eta_running = pref * integ
    pl = gk_plateau(acf, eta_running)
    return {"lags": lags, "sacf": acf, "eta_running": eta_running,
            "eta": float(eta_running[-1]),
            "eta_plateau": pl["value"], "eta_plateau_se": pl["stderr"],
            "plateau_window": (pl["lag_lo"], pl["lag_hi"])}


def green_kubo(J: np.ndarray, dt: float, volume: float,
               temperature: float, max_lag: Optional[int] = None
               ) -> Dict[str, np.ndarray]:
    """Green-Kubo running thermal conductivity from a heat-flux series.

    J [n_frames, 3] in eV*A/fs (total flux, NOT per volume), `dt` fs
    between frames, `volume` A^3, `temperature` K.

    Returns {"lags" fs, "hcacf" (eV*A/fs)^2 (component-averaged,
    all-origin), "kappa_running" W/(m K) — trapezoidal running
    integral, "kappa" its final value}.
    """
    J = np.asarray(J, dtype=np.float64)
    # remove <J>: a residual center-of-mass drift (e.g. the random
    # momentum a Langevin equilibration leaves behind) rides the
    # convective term as a CONSTANT enthalpy flux, whose ACF offset
    # integrates to a spurious linear kappa(t)
    J = J - J.mean(axis=0, keepdims=True)
    n = len(J)
    if max_lag is None:
        max_lag = n // 2
    max_lag = int(min(max_lag, n - 1))
    acf = np.empty(max_lag + 1)
    for lag in range(max_lag + 1):
        prods = np.sum(J[:n - lag] * J[lag:], axis=1)
        acf[lag] = prods.mean() / 3.0
    lags = np.arange(max_lag + 1) * dt
    # trapezoidal cumulative integral of the HCACF
    integ = np.concatenate(
        [[0.0], np.cumsum(0.5 * (acf[1:] + acf[:-1]) * dt)])
    pref = EV_A_FS_TO_W_MK / (volume * KB * temperature ** 2)
    kappa_running = pref * integ
    pl = gk_plateau(acf, kappa_running)
    return {"lags": lags, "hcacf": acf,
            "kappa_running": kappa_running,
            "kappa": float(kappa_running[-1]),
            "kappa_plateau": pl["value"],
            "kappa_plateau_se": pl["stderr"],
            "plateau_window": (pl["lag_lo"], pl["lag_hi"])}
