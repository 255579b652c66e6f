"""Exact many-body heat flux + Green-Kubo machinery.

Oracles:
1. Uniform-velocity enthalpy identity: for v_i = v, the operator must
   give J = (E + KE) v - W^T v with W the potential virial from the
   standard EFS pass — pins the virial term against an independently
   computed quantity.
2. Finite-difference energy-current oracle on a vacuum cluster: with
   positions following r(t) = r + v t, dE_i/dt = (d/dt) E_i(r + v t)
   is computable by central differences of the per-atom energies, and
   the gauge-fixed current J = sum_i e_i v_i + sum_i r_i (dE_i/dt +
   F_i . v_i) must equal the operator exactly (it was derived from it
   by algebra with no approximation).  This verifies the owner-anchored
   attribution, every sign, and the kinetic piece at once.
3. Green-Kubo estimator pinned on a constant flux (hand-computed
   prefactor) and an exactly-known cosine HCACF.
"""
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensoralloy_tpu.atoms import Structure
from tensoralloy_tpu.transform import Featurizer
from tensoralloy_tpu.nn.eam import EamAlloyNN
from tensoralloy_tpu.nn.sf import SymmetryFunction
from tensoralloy_tpu.nn.atomic import AtomicNN
from tensoralloy_tpu.nn.fields import make_efs_fn
from tensoralloy_tpu.analysis.heatflux import (
    make_heat_flux_fn, trajectory_heat_flux, green_kubo,
    EV_A_FS_TO_W_MK)
from tensoralloy_tpu.dynamics import FORCE_TO_ACC, KB


def _fcc_ni(n_cell=2, a0=3.52, rattle=0.06, seed=0):
    rng = np.random.RandomState(seed)
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                     [0, 0.5, 0.5]])
    frac = np.concatenate([base + [i, j, k]
                           for i in range(n_cell)
                           for j in range(n_cell)
                           for k in range(n_cell)])
    pos = frac * a0 + rng.normal(scale=rattle, size=(len(frac), 3))
    return Structure.from_symbols(["Ni"] * len(frac), pos,
                                  np.eye(3) * a0 * n_cell,
                                  pbc=[True] * 3)


def _cluster_ni(n=10, seed=3):
    """Vacuum-cell cluster (gauge-fixed absolute positions)."""
    rng = np.random.RandomState(seed)
    pos = []
    while len(pos) < n:
        cand = rng.uniform(0, 6.5, size=3)
        if all(np.linalg.norm(cand - p) > 2.1 for p in pos):
            pos.append(cand)
    s = Structure.from_symbols(["Ni"] * n, np.array(pos) + 8.0,
                               np.eye(3) * 24.0, pbc=[False] * 3)
    return s


def _models(structure, angular=False, rcut=4.5):
    out = []
    n = len(structure)
    fz = Featurizer(["Ni"], rcut=rcut)
    eam = EamAlloyNN(fz, Counter({"Ni": n}), custom_potentials="zjw04")
    out.append((eam, eam.init_params(jax.random.PRNGKey(0)), fz))
    if angular:
        fza = Featurizer(["Ni"], rcut=rcut, angular=True)
        sf = SymmetryFunction(["Ni"])
        m = AtomicNN(fza, Counter({"Ni": n}), sf, hidden_sizes=[8],
                     minmax_scale=False)
        out.append((m, m.init_params(jax.random.PRNGKey(1)), fza))
    return out


def _feats(fz, s, vap):
    return {k: jnp.asarray(v)
            for k, v in fz.featurize(s, vap, layout="segment").items()}


def test_uniform_velocity_enthalpy_identity():
    """v_i = v for all i  =>  J = (E + KE) v - W^T v."""
    s = _fcc_ni()
    for model, params, fz in _models(s, angular=True):
        vap = fz.make_vap(s, model.max_occurs)
        feats = _feats(fz, s, vap)
        masses = jnp.asarray(vap.map_array(s.masses))
        v = np.array([0.013, -0.007, 0.019])
        vel = jnp.asarray(vap.map_array(np.tile(v, (len(s), 1))))

        res = jax.jit(make_heat_flux_fn(model))(params, feats, vel,
                                                masses)
        efs = jax.jit(make_efs_fn(model.energy))(params, feats)
        ke = float(0.5 * np.sum(np.asarray(masses)
                                * np.sum(np.asarray(vel) ** 2, -1))
                   / FORCE_TO_ACC)
        expect = ((float(efs["energy"]) + ke) * v
                  - np.asarray(efs["virial"]).T @ v)
        np.testing.assert_allclose(np.asarray(res["J"]), expect,
                                   rtol=1e-9, atol=1e-11)


def test_heat_flux_fd_energy_current_oracle():
    """Cluster: operator == gauge-fixed sum_i [e_i v_i + r_i de_i/dt]."""
    s = _cluster_ni()
    rng = np.random.RandomState(7)
    vel_local = rng.normal(scale=0.02, size=(len(s), 3))
    for model, params, fz in _models(s, angular=True):
        vap = fz.make_vap(s, model.max_occurs)
        feats = _feats(fz, s, vap)
        masses_local = s.masses
        masses = jnp.asarray(vap.map_array(masses_local))
        vel = jnp.asarray(vap.map_array(vel_local))

        res = jax.jit(make_heat_flux_fn(model))(params, feats, vel,
                                                masses)

        # central FD of per-atom site energies along r(t) = r + v t
        eps = 1e-5
        ae = {}
        for sgn in (+1, -1):
            s2 = Structure(s.numbers,
                           s.positions + sgn * eps * vel_local,
                           s.cell, s.pbc)
            f2 = _feats(fz, s2, vap)
            ae[sgn] = np.asarray(model.atomic_energies(params, f2))
        de_dt = vap.reverse_map((ae[+1] - ae[-1]) / (2 * eps))

        efs = jax.jit(make_efs_fn(model.energy))(params, feats)
        forces = vap.reverse_map(np.asarray(efs["forces"]))
        e_at = vap.reverse_map(
            np.asarray(model.atomic_energies(params, feats)))
        ke_at = 0.5 * masses_local * np.sum(vel_local ** 2, -1) \
            / FORCE_TO_ACC
        dke_dt = np.sum(forces * vel_local, -1)

        j_ref = (np.sum((e_at + ke_at)[:, None] * vel_local, 0)
                 + np.sum(s.positions * (de_dt + dke_dt)[:, None], 0))
        np.testing.assert_allclose(np.asarray(res["J"]), j_ref,
                                   rtol=2e-5, atol=2e-7)


def test_heat_flux_requires_segment_backend():
    s = _fcc_ni()
    fz = Featurizer(["Ni"], rcut=4.5)
    sf = SymmetryFunction(["Ni"], backend="dense")
    m = AtomicNN(fz, Counter({"Ni": len(s)}), sf, hidden_sizes=[8],
                 minmax_scale=False)
    with pytest.raises(ValueError, match="segment"):
        make_heat_flux_fn(m)


def test_green_kubo_prefactor_alternating_flux():
    """Zero-mean alternating J (+A, -A, ...): HCACF(L) = (-1)^L A^2/3
    exactly (all origins), and the first trapezoid segment pins the
    V-kB-T^2 prefactor: kappa_running[1] = pref * 0 ... use the lag-0
    half-cell: integral over [0, dt] of the linear interpolation
    (A^2/3 -> -A^2/3) is 0, so pin the prefactor through a one-sided
    rectified series instead: |J| pattern with known mean."""
    A = 0.3
    n = 400
    J = np.zeros((n, 3))
    J[:, 0] = A * (-1.0) ** np.arange(n)
    dt, vol, temp = 2.0, 1000.0, 300.0
    gk = green_kubo(J, dt=dt, volume=vol, temperature=temp,
                    max_lag=40)
    expect = (A ** 2 / 3.0) * (-1.0) ** np.arange(41)
    np.testing.assert_allclose(gk["hcacf"], expect, rtol=1e-10)
    # alternating series: every trapezoid pair cancels
    np.testing.assert_allclose(gk["kappa_running"][2::2], 0.0,
                               atol=1e-10)
    # prefactor: exponential-free pin via a two-point ACF integral
    pref = EV_A_FS_TO_W_MK / (vol * KB * temp ** 2)
    # kappa_running[1] = pref * dt * (acf0 + acf1)/2 = 0 here; use a
    # cosine with the analytic integral instead for the scale
    w = 0.05
    t_ax = np.arange(4000) * 1.0
    Jc = np.zeros((len(t_ax), 3))
    Jc[:, 0] = np.cos(w * t_ax)
    gkc = green_kubo(Jc, dt=1.0, volume=vol, temperature=temp,
                     max_lag=100)
    expect_k = pref * np.sin(w * gkc["lags"][-1]) / (2 * 3 * w)
    assert gkc["kappa"] == pytest.approx(expect_k, rel=0.02)


def test_green_kubo_cosine_acf():
    """J_x(t) = cos(w t) sampled densely: the all-origin HCACF at lag L
    is cos(w L) * mean_t[cos^2] ~ cos(w L)/2, and the running integral
    approaches sin(w t)/(2 w) * pref."""
    w = 0.05
    t = np.arange(4000) * 1.0
    J = np.zeros((len(t), 3))
    J[:, 0] = np.cos(w * t)
    gk = green_kubo(J, dt=1.0, volume=500.0, temperature=400.0,
                    max_lag=200)
    # finite-window origin averaging leaves an O(1/(w n)) remainder
    expect = 0.5 * np.cos(w * gk["lags"]) / 3.0
    np.testing.assert_allclose(gk["hcacf"], expect, atol=1e-3)


def test_gk_plateau_ignores_noisy_tail():
    """gk_plateau: an exponentially-decaying ACF whose running
    integral then random-walks must report the converged value (with
    a finite stderr), where the max-lag value is corrupted.  Window:
    [first decay below 1% of ACF[0], 5x that lag]."""
    from tensoralloy_tpu.analysis.heatflux import gk_plateau
    rng = np.random.RandomState(3)
    tau, dt, n = 20.0, 1.0, 2000
    lags = np.arange(n) * dt
    acf = np.exp(-lags / tau)
    integ = np.concatenate(
        [[0.0], np.cumsum(0.5 * (acf[1:] + acf[:-1]) * dt)])
    # corrupt the tail: after the ACF has died, add a random walk that
    # drags the running integral far from the converged tau
    walk = np.cumsum(rng.randn(n) * 0.3)
    walk[:300] = 0.0
    running = integ + walk
    pl = gk_plateau(acf, running)
    # analytic integral = tau (to ~dt/2 trapezoid error)
    assert pl["value"] == pytest.approx(tau, rel=0.05)
    assert pl["stderr"] >= 0.0
    # the decay window starts where exp(-t/tau) < 0.01 -> ~4.6 tau
    assert 80 <= pl["lag_lo"] <= 120
    assert abs(running[-1] - tau) > 5 * abs(pl["value"] - tau) + 1.0
    # green_kubo surfaces the same fields
    J = np.zeros((400, 3))
    J[:, 0] = np.exp(-np.arange(400) / 10.0) * np.cos(
        0.7 * np.arange(400))
    gk = green_kubo(J, dt=1.0, volume=500.0, temperature=300.0,
                    max_lag=150)
    lo, hi = gk["plateau_window"]
    assert 0 < lo < hi <= 151
    assert np.isfinite(gk["kappa_plateau"])
    assert np.isfinite(gk["kappa_plateau_se"])


def test_trajectory_heat_flux_compiles_once(monkeypatch):
    """The capacity pre-scan must hold the whole trajectory to ONE
    compiled executable even when the pair count varies frame-to-frame
    (an expanding cell previously re-entered XLA compilation on every
    new running max)."""
    import tensoralloy_tpu.analysis.heatflux as hf
    import tensoralloy_tpu.nn.eam.fast_efs as ff

    s = _fcc_ni(rattle=0.0)
    model, params, fz = _models(s)[0]
    traces = []

    def counted(orig):
        def make(model_):
            f = orig(model_)

            def wrapper(*a, **k):
                traces.append(1)   # jit runs the python fn once/trace
                return f(*a, **k)
            return wrapper
        return make

    # EAM routes through the fast analytic flux; patch both builders
    # so the pin holds whichever path the model family selects
    monkeypatch.setattr(hf, "make_heat_flux_fn",
                        counted(hf.make_heat_flux_fn))
    monkeypatch.setattr(ff, "make_fast_heat_flux_fn",
                        counted(ff.make_fast_heat_flux_fn))
    rng = np.random.RandomState(4)
    n_frames = 5
    # expanding cells: the neighbor count SHRINKS then grows depending
    # on frame order; either direction must not retrace
    scales = np.array([1.0, 1.06, 0.97, 1.12, 1.0])
    pos = np.stack([s.positions * c for c in scales])
    pos += rng.normal(scale=0.01, size=pos.shape)
    cells = np.stack([s.cell * c for c in scales])
    vel = rng.normal(scale=0.01, size=pos.shape)
    J = hf.trajectory_heat_flux(model, params, s, pos, vel, cells=cells)
    assert J.shape == (n_frames, 3)
    assert np.all(np.isfinite(J))
    assert len(traces) == 1, f"{len(traces)} compiles for one trajectory"


def test_trajectory_heat_flux_runs():
    """End-to-end: short NVE trajectory -> J(t) -> finite kappa; the
    first frame's flux matches a direct make_heat_flux_fn call."""
    from tensoralloy_tpu.dynamics import VelocityVerlet
    s = _fcc_ni(rattle=0.0)
    model, params, fz = _models(s)[0]
    md = VelocityVerlet(model, params, s, timestep=2.0,
                        temperature=400.0, seed=2, chunk_size=5)
    hist = md.run(10, record_trajectory=True)
    pos = np.asarray(hist["positions"])
    vel = np.asarray(hist["velocities"])
    J = trajectory_heat_flux(model, params, s, pos, vel)
    assert J.shape == (len(pos), 3)
    assert np.all(np.isfinite(J))

    vap = fz.make_vap(s, model.max_occurs)
    s0 = Structure(s.numbers, pos[0], s.cell, s.pbc)
    feats = _feats(fz, s0, vap)
    res = jax.jit(make_heat_flux_fn(model))(
        params, feats, jnp.asarray(vap.map_array(vel[0])),
        jnp.asarray(vap.map_array(s.masses)))
    np.testing.assert_allclose(J[0], np.asarray(res["J"]),
                               rtol=1e-6, atol=1e-9)

    gk = green_kubo(J, dt=2.0, volume=s.volume, temperature=400.0)
    assert np.isfinite(gk["kappa"])


def test_segmented_production_snaps_to_sample_cadence():
    """Segment lengths snap DOWN to a multiple of --sample: run()
    records one frame per MD chunk (chunk_size == sample), so a
    ragged segment boundary would inject an off-cadence frame into
    the fixed-dt ACF series. Only the FINAL segment may be ragged."""
    import argparse
    from tensoralloy_tpu.cli.entry import _segmented_production

    calls = []

    class FakeMD:
        def run(self, n):
            calls.append(n)
            frames = (n + 2) // 3
            return {"heat_flux": [0.0] * frames,
                    "temperature": [300.0] * frames}

    args = argparse.Namespace(steps=100, flush_every=10, sample=3)
    for _series, _temps, done in _segmented_production(
            FakeMD(), args, "heat_flux"):
        pass
    assert done == 100
    # flush 10 snaps to 9 (multiple of sample 3): 11 x 9 + final 1
    assert calls[:-1] == [9] * 11 and calls[-1] == 1
    assert all(c % 3 == 0 for c in calls[:-1])


def test_cli_compute_kappa(tmp_path):
    """`compute kappa` end-to-end on a tiny zjw04 Ni cell: NVT equil,
    NVE production, heat flux, HCACF CSV with finite kappa."""
    import subprocess
    import sys
    from tensoralloy_tpu.io.model import save_model

    fz = Featurizer(["Ni"], rcut=6.0)
    model = EamAlloyNN(fz, Counter({"Ni": 4}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    mpath = tmp_path / "ni.npz"
    save_model(str(mpath), model, jax.device_get(params))
    out_csv = tmp_path / "kappa.csv"
    out = subprocess.run(
        [sys.executable, "-m", "tensoralloy_tpu.cli", "compute",
         "kappa", str(mpath), "Ni", "--supercell", "2", "2", "2",
         "--temp", "300", "--equil-steps", "20", "--steps", "60",
         "--sample", "5", "--timestep", "2.0", "--flush-every", "30",
         "-o", str(out_csv)],
        capture_output=True, text=True, check=True)
    assert "kappa(max lag)" in out.stdout
    kappa = float(out.stdout.split("kappa(max lag) = ")[1].split()[0])
    assert np.isfinite(kappa)
    # the mid-production flush ran (preemption-safety contract: at
    # 30/60 steps a valid shorter-window CSV was already on disk) ...
    assert "flushed partial GK at 30/60 steps" in out.stdout
    rows = open(out_csv).readlines()
    # ... and the FINAL write replaced it without the PARTIAL marker
    assert rows[0].startswith("lag_fs,")
    assert len(rows) >= 5


def test_atomic_virials_sum_to_total():
    """Per-atom virials (owner-anchored g (x) d) sum exactly to the
    position/cell-gradient virial of the standard EFS pass; in the
    perfect crystal every atom carries W/N."""
    from tensoralloy_tpu.analysis.heatflux import make_atomic_virial_fn
    s = _fcc_ni()
    for model, params, fz in _models(s, angular=True):
        vap = fz.make_vap(s, model.max_occurs)
        feats = _feats(fz, s, vap)
        out = jax.jit(make_atomic_virial_fn(model))(params, feats)
        efs = jax.jit(make_efs_fn(model.energy))(params, feats)
        np.testing.assert_allclose(np.asarray(out["virial"]),
                                   np.asarray(efs["virial"]),
                                   rtol=1e-8, atol=1e-9)
        w = vap.reverse_map(np.asarray(out["atomic_virials"]))
        np.testing.assert_allclose(
            w.sum(0), np.asarray(efs["virial"]), rtol=1e-8, atol=1e-9)

    # perfect (unrattled) crystal: identical per-atom virials
    s0 = _fcc_ni(rattle=0.0)
    model, params, fz = _models(s0)[0]
    vap = fz.make_vap(s0, model.max_occurs)
    feats = _feats(fz, s0, vap)
    out = jax.jit(make_atomic_virial_fn(model))(params, feats)
    w = vap.reverse_map(np.asarray(out["atomic_virials"]))
    # identical up to fp64 summation-order noise (~4e-15 measured)
    np.testing.assert_allclose(
        w, np.broadcast_to(w[0], w.shape), atol=1e-13)


def test_md_onscan_heat_flux_matches_host_path():
    """record_heat_flux=True: the chunk-end J computed INSIDE the
    jitted MD kernel (on skinned features) equals the host-path
    recomputation on exact-rcut features — the on-device r<rcut mask
    zeroes every skin pair's gradient."""
    from tensoralloy_tpu.dynamics import VelocityVerlet
    s = _fcc_ni(rattle=0.0)
    model, params, fz = _models(s)[0]
    md = VelocityVerlet(model, params, s, timestep=2.0, chunk_size=5,
                        temperature=350.0, seed=4,
                        record_heat_flux=True)
    hist = md.run(15, record_trajectory=True)
    assert len(hist["heat_flux"]) == 3
    J_scan = np.stack(hist["heat_flux"])
    J_host = trajectory_heat_flux(
        md.model, params, md.structure,
        np.stack(hist["positions"]), np.stack(hist["velocities"]),
        cells=np.stack(hist["cells"]))
    np.testing.assert_allclose(J_scan, J_host, rtol=1e-8, atol=1e-10)
    assert np.any(np.abs(J_scan) > 0)


def test_md_onscan_heat_flux_device_nl():
    """The on-scan flux composes with the fully on-device neighbor
    list: J from a device-NL run matches the host-NL run frame by
    frame (same trajectory by determinism of NVE)."""
    from tensoralloy_tpu.dynamics import VelocityVerlet
    s = _fcc_ni(rattle=0.0)
    model, params, fz = _models(s)[0]
    runs = {}
    for dev in (False, True):
        md = VelocityVerlet(model, params, s, timestep=2.0,
                            chunk_size=5, temperature=350.0, seed=4,
                            device_nl=dev, record_heat_flux=True)
        runs[dev] = np.stack(md.run(15)["heat_flux"])
    np.testing.assert_allclose(runs[True], runs[False],
                               rtol=1e-7, atol=1e-9)


def test_record_stress_identity():
    """Chunk-end stress recorded inside the kernel == potential stress
    from the standard EFS pass + the kinetic term computed from the
    recorded velocities."""
    from tensoralloy_tpu.dynamics import VelocityVerlet
    s = _fcc_ni(rattle=0.0)
    model, params, fz = _models(s)[0]
    md = VelocityVerlet(model, params, s, timestep=2.0, chunk_size=5,
                        temperature=350.0, seed=4, record_stress=True)
    hist = md.run(10, record_trajectory=True)
    assert len(hist["stress_tensor"]) == 2
    vap = fz.make_vap(s, model.max_occurs)
    for frame in range(2):
        s_t = Structure(s.numbers, hist["positions"][frame],
                        hist["cells"][frame], s.pbc)
        feats = _feats(fz, s_t, vap)
        efs = jax.jit(make_efs_fn(model.energy))(params, feats)
        v = hist["velocities"][frame]
        mv = v * s.masses[:, None]
        sig_kin = -(mv.T @ v) / FORCE_TO_ACC / s_t.volume
        expect = np.asarray(efs["stress"]) + sig_kin
        np.testing.assert_allclose(hist["stress_tensor"][frame],
                                   expect, rtol=1e-7, atol=1e-12)


def test_record_stress_ideal_gas_limit():
    """Non-interacting atoms (far beyond rcut): the recorded stress is
    purely kinetic, trace = -2 KE / V (i.e. P = +2KE/3V)."""
    from tensoralloy_tpu.dynamics import VelocityVerlet
    pos = np.array([[5.0, 5.0, 5.0], [25.0, 25.0, 25.0]])
    s = Structure.from_symbols(["Ni"] * 2, pos, np.eye(3) * 40.0,
                               pbc=[True] * 3)
    model, params, fz = _models(s)[0]
    md = VelocityVerlet(model, params, s, timestep=1.0, chunk_size=2,
                        temperature=500.0, seed=1, record_stress=True)
    hist = md.run(2, record_trajectory=True)
    sig = hist["stress_tensor"][0]
    v = hist["velocities"][0]
    ke = 0.5 * np.sum(s.masses[:, None] * v ** 2) / FORCE_TO_ACC
    assert np.trace(sig) == pytest.approx(-2 * ke / s.volume,
                                          rel=1e-8)


def test_green_kubo_viscosity_prefactor():
    """sigma_xy(t) = A cos(w t): sacf -> A^2 cos(w L)/6 (component
    average over 3 off-diagonals) and the running integral carries the
    hand-computed V/(kB T) prefactor."""
    from tensoralloy_tpu.analysis.heatflux import (
        green_kubo_viscosity, EV_FS_A3_TO_PA_S)
    w, A = 0.04, 2e-3
    t = np.arange(6000) * 1.0
    sig = np.zeros((len(t), 3, 3))
    sig[:, 0, 1] = A * np.cos(w * t)
    gk = green_kubo_viscosity(sig, dt=1.0, volume=2000.0,
                              temperature=500.0, max_lag=300)
    expect = A ** 2 * np.cos(w * gk["lags"]) / 2.0 / 3.0
    np.testing.assert_allclose(gk["sacf"], expect,
                               atol=3e-3 * A ** 2)
    pref = EV_FS_A3_TO_PA_S * 2000.0 / (KB * 500.0)
    # analytic integral of the cosine ACF
    expect_eta = pref * A ** 2 * np.sin(w * gk["lags"][-1]) / (2 * 3 * w)
    assert gk["eta"] == pytest.approx(expect_eta, rel=0.02)
    assert np.isfinite(gk["eta_running"]).all()


def test_cli_compute_visc(tmp_path):
    """`compute visc` end-to-end: tiny hot run, finite eta, CSV."""
    import subprocess
    import sys
    from tensoralloy_tpu.io.model import save_model

    fz = Featurizer(["Ni"], rcut=6.0)
    model = EamAlloyNN(fz, Counter({"Ni": 4}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    mpath = tmp_path / "ni.npz"
    save_model(str(mpath), model, jax.device_get(params))
    out_csv = tmp_path / "visc.csv"
    out = subprocess.run(
        [sys.executable, "-m", "tensoralloy_tpu.cli", "compute",
         "visc", str(mpath), "Ni", "--supercell", "2", "2", "2",
         "--temp", "800", "--equil-steps", "20", "--steps", "60",
         "--sample", "5", "--timestep", "2.0", "--nvt-production",
         "-o", str(out_csv)],
        capture_output=True, text=True, check=True)
    assert "eta(max lag)" in out.stdout
    eta = float(out.stdout.split("eta(max lag) = ")[1].split()[0])
    assert np.isfinite(eta)
    rows = open(out_csv).readlines()
    assert rows[0].startswith("lag_fs,")


def test_heat_flux_finite_temperature_model():
    """Finite-T models transport per-atom FREE energies (consistent
    with forces = -dF/dR): the uniform-velocity identity must hold
    against the variational-energy EFS pass."""
    from tensoralloy_tpu.nn.finite_temperature import (
        TemperatureDependentAtomicNN)
    from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential

    s = _fcc_ni()
    s.info["etemperature"] = 0.35
    fz = Featurizer(["Ni"], rcut=4.5)
    grap = GenericRadialAtomicPotential(
        ["Ni"], algorithm="pexp",
        parameters={"rl": [1.0, 2.5], "pl": [3.0, 2.0]},
        moment_tensors=[0, 1])
    m = TemperatureDependentAtomicNN(fz, Counter({"Ni": len(s)}),
                                     grap, hidden_sizes=[8],
                                     minmax_scale=False)
    params = m.init_params(jax.random.PRNGKey(2))
    vap = fz.make_vap(s, m.max_occurs)
    feats = _feats(fz, s, vap)
    masses = jnp.asarray(vap.map_array(s.masses))
    v = np.array([0.011, 0.004, -0.017])
    vel = jnp.asarray(vap.map_array(np.tile(v, (len(s), 1))))

    res = jax.jit(make_heat_flux_fn(m))(params, feats, vel, masses)
    efs = jax.jit(make_efs_fn(m.variational_energy))(params, feats)
    ke = float(0.5 * np.sum(np.asarray(masses)
                            * np.sum(np.asarray(vel) ** 2, -1))
               / FORCE_TO_ACC)
    f_total = float(jnp.sum(
        m._atomic_heads(params, feats)["free_energy"]))
    expect = (f_total + ke) * v - np.asarray(efs["virial"]).T @ v
    np.testing.assert_allclose(np.asarray(res["J"]), expect,
                               rtol=1e-9, atol=1e-12)
    # and the convective term uses F, not U
    assert abs(float(res["energy"]) - f_total) < 1e-10


def test_cli_compute_kappa_multiseed(tmp_path):
    """--seeds 2: replica-averaged CSV with mean +/- std columns."""
    import subprocess
    import sys
    from tensoralloy_tpu.io.model import save_model

    fz = Featurizer(["Ni"], rcut=6.0)
    model = EamAlloyNN(fz, Counter({"Ni": 4}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    mpath = tmp_path / "ni.npz"
    save_model(str(mpath), model, jax.device_get(params))
    out_csv = tmp_path / "kappa.csv"
    out = subprocess.run(
        [sys.executable, "-m", "tensoralloy_tpu.cli", "compute",
         "kappa", str(mpath), "Ni", "--supercell", "2", "2", "2",
         "--temp", "300", "--equil-steps", "10", "--steps", "40",
         "--sample", "5", "--seeds", "2", "-o", str(out_csv)],
        capture_output=True, text=True, check=True)
    assert "kappa over 2 replicas:" in out.stdout
    assert "+/-" in out.stdout
    rows = open(out_csv).readlines()
    assert rows[0].strip() == "lag_fs,kappa_mean_W_mK,kappa_std_W_mK"
    assert (tmp_path / "kappa.csv.s0").exists()
    assert (tmp_path / "kappa.csv.s1").exists()


def test_green_kubo_drift_insensitive():
    """A constant flux offset (COM drift's enthalpy transport) must
    not poison kappa: mean subtraction makes the constant component
    integrate to ~0 while a genuine fluctuation spectrum survives."""
    rng = np.random.RandomState(1)
    noise = rng.normal(size=(4000, 3))
    J0 = noise + np.array([50.0, -30.0, 10.0])[None]
    gk_drift = green_kubo(J0, dt=1.0, volume=1000.0,
                          temperature=300.0, max_lag=200)
    gk_clean = green_kubo(noise, dt=1.0, volume=1000.0,
                          temperature=300.0, max_lag=200)
    np.testing.assert_allclose(gk_drift["hcacf"], gk_clean["hcacf"],
                               rtol=1e-10, atol=1e-10)


def test_md_zero_com_velocity():
    """NVT equilibration leaves a nonzero COM momentum (Langevin
    random-walks it); zero_com_velocity removes it exactly."""
    from tensoralloy_tpu.dynamics import VelocityVerlet
    s = _fcc_ni(rattle=0.0)
    model, params, fz = _models(s)[0]
    md = VelocityVerlet(model, params, s, timestep=2.0, chunk_size=10,
                        temperature=300.0, seed=5,
                        target_temperature=300.0, friction=0.1)
    md.run(50)
    m = md.masses_vap[:, None] * md.vap.atom_masks[:, None]
    p_before = np.abs((m * md.velocities_vap).sum(0)).max()
    assert p_before > 1e-6                      # drift exists
    md.zero_com_velocity()
    p_after = np.abs((m * md.velocities_vap).sum(0)).max()
    assert p_after < 1e-12
