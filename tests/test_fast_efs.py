"""Scatter-free analytic EAM EFS (`nn/eam/fast_efs.py`) parity vs the
autodiff path (`nn/fields.make_efs_fn`) — same features, f64, 1e-10.

The fast path replaces the scatter-adds of the autodiff path (forward
segment_sum + gather-VJP) with gathers and row reductions; its math is
a hand-derived accumulator-adjoint force formula that must match the
autodiff result EXACTLY (no approximation anywhere), including ADP's
vector moments, per-term grouping, multi-element bucketed padding and
non-orthogonal cells.
"""
from collections import Counter

import jax
import numpy as np
import pytest

from tensoralloy_tpu.atoms import Structure
from tensoralloy_tpu.transform import Featurizer
from tensoralloy_tpu.nn.eam.models import EamAlloyNN, EamFsNN, AdpNN
from tensoralloy_tpu.nn.eam.fast_efs import make_fast_efs_fn
from tensoralloy_tpu.nn.fields import make_efs_fn


def _structure(seed=0, n=24, skew=True):
    rng = np.random.RandomState(seed)
    cell = np.eye(3) * 9.0
    if skew:
        cell[1, 0] = 1.2
        cell[2, 1] = -0.8
    frac = rng.uniform(0, 1, (n, 3))
    syms = ["Ni"] * (n // 2) + ["Mo"] * (n - n // 2)
    return Structure.from_symbols(syms, frac @ cell, cell,
                                  pbc=[True] * 3)


def _compare(model, s, fz, rtol=1e-10, atol=1e-10):
    params = model.init_params(jax.random.PRNGKey(0))
    # bucketed VAP (padding rows) exercises the atom_masks handling
    occurs = Counter(s.symbols)
    for e in occurs:
        occurs[e] += 3
    model = model.clone_for(occurs)
    vap = fz.make_vap(s, model.max_occurs)
    feats = fz.featurize(s, vap, layout="both", dtype=np.float64)
    import jax.numpy as jnp
    feats = {k: jnp.asarray(v) for k, v in feats.items()}
    ref = jax.jit(make_efs_fn(model.energy))(params, feats)
    fast = jax.jit(make_fast_efs_fn(model))(params, feats)
    np.testing.assert_allclose(float(fast["energy"]),
                               float(ref["energy"]), rtol=rtol)
    np.testing.assert_allclose(np.asarray(fast["forces"]),
                               np.asarray(ref["forces"]),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(fast["virial"]),
                               np.asarray(ref["virial"]),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(fast["stress_voigt"]),
                               np.asarray(ref["stress_voigt"]),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        np.asarray(fast["atomic_energies"]),
        np.asarray(model.atomic_energies(params, feats)),
        rtol=rtol, atol=atol)
    return fast


def test_fast_efs_alloy_zjw04_single_element():
    rng = np.random.RandomState(1)
    a0 = 3.52
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(2)
                           for j in range(2) for k in range(2)]) / 2
    cell = np.eye(3) * 2 * a0
    pos = frac @ cell + rng.normal(0, 0.08, (32, 3))
    s = Structure.from_symbols(["Ni"] * 32, pos, cell, pbc=[True] * 3)
    fz = Featurizer(["Ni"], rcut=6.0)
    model = EamAlloyNN(fz, Counter(s.symbols), custom_potentials="zjw04")
    _compare(model, s, fz)


def test_fast_efs_alloy_binary_mlp():
    s = _structure(seed=2)
    fz = Featurizer(["Mo", "Ni"], rcut=4.5)
    model = EamAlloyNN(fz, Counter(s.symbols), hidden_sizes=[8, 8])
    _compare(model, s, fz)


def test_fast_efs_fs_binary():
    s = _structure(seed=3)
    fz = Featurizer(["Mo", "Ni"], rcut=4.5)
    model = EamFsNN(fz, Counter(s.symbols), hidden_sizes=[8])
    _compare(model, s, fz)


@pytest.mark.parametrize("per_term", [True, False])
def test_fast_efs_adp_binary(per_term):
    s = _structure(seed=4)
    fz = Featurizer(["Mo", "Ni"], rcut=4.5)
    model = AdpNN(fz, Counter(s.symbols), hidden_sizes=[8],
                  adp_per_term=per_term)
    _compare(model, s, fz)


@pytest.mark.parametrize("kind", ["alloy", "fs", "adp"])
def test_fast_heat_flux_matches_autodiff_operator(kind):
    """The analytic heat flux must equal the autodiff Hardy/Fan
    operator exactly: same owner-anchored g_q, same convective and
    virial parts — pinned per EAM flavor on random velocities."""
    import jax.numpy as jnp
    from tensoralloy_tpu.nn.eam.fast_efs import make_fast_heat_flux_fn
    from tensoralloy_tpu.analysis.heatflux import make_heat_flux_fn

    s = _structure(seed=6)
    fz = Featurizer(["Mo", "Ni"], rcut=4.5)
    cls = {"alloy": EamAlloyNN, "fs": EamFsNN, "adp": AdpNN}[kind]
    model = cls(fz, Counter(s.symbols), hidden_sizes=[8])
    params = model.init_params(jax.random.PRNGKey(0))
    vap = fz.make_vap(s, model.max_occurs)
    feats = fz.featurize(s, vap, layout="both", dtype=np.float64)
    feats = {k: jnp.asarray(v) for k, v in feats.items()}
    rng = np.random.RandomState(7)
    vel = jnp.asarray(vap.map_array(
        rng.normal(0, 0.01, (len(s), 3))))
    masses = jnp.asarray(vap.map_array(s.masses))
    ref = jax.jit(make_heat_flux_fn(model))(params, feats, vel, masses)
    fast = jax.jit(make_fast_heat_flux_fn(model))(params, feats, vel,
                                                  masses)
    for key in ("J", "J_convective", "J_virial"):
        np.testing.assert_allclose(np.asarray(fast[key]),
                                   np.asarray(ref[key]),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(fast["atomic_energies"]),
                               np.asarray(ref["atomic_energies"]),
                               rtol=1e-10, atol=1e-12)


def test_wrapper_models_never_take_the_fast_path():
    """A wrapper that delegates attributes (LambdaMix mixes Einstein
    springs into the energy) exposes the wrapped model's `tag` via
    __getattr__; classifying it as EAM-family would make MD integrate
    the WRONG Hamiltonian (regression: test_ti caught the fast path
    computing pure-EAM forces under lambda-mixing)."""
    from tensoralloy_tpu.calculator import is_eam_family
    from tensoralloy_tpu.analysis.ti import LambdaMix

    s = _structure(seed=8)
    fz = Featurizer(["Mo", "Ni"], rcut=4.5)
    model = EamAlloyNN(fz, Counter(s.symbols), hidden_sizes=[8])
    assert is_eam_family(model)
    n_vap = model.n_atoms_vap
    mixed = LambdaMix(model, 0.5, np.zeros((n_vap, 3)), 1.0,
                      np.ones(n_vap))
    assert mixed.tag == "alloy"          # delegation works...
    assert not is_eam_family(mixed)      # ...but no fast path


def test_fast_efs_translation_and_newton():
    """Physics invariants independent of the autodiff comparison:
    forces sum to zero, virial is symmetric for radial models."""
    s = _structure(seed=5, skew=False)
    fz = Featurizer(["Mo", "Ni"], rcut=4.5)
    model = EamAlloyNN(fz, Counter(s.symbols), hidden_sizes=[8])
    fast = _compare(model, s, fz)
    f = np.asarray(fast["forces"])
    np.testing.assert_allclose(f.sum(axis=0), 0.0, atol=1e-9)
    w = np.asarray(fast["virial"])
    np.testing.assert_allclose(w, w.T, atol=1e-9)


def test_fast_efs_gather_layout_t_matches():
    """GATHER_LAYOUT='t' (the [A, C, N] gather that avoids the
    lane-padded [A, N, C] table) through the BINARY fast path — the
    4-column position+element table and the single-element gather_vec
    both ride the switch; values must match autodiff at f64 1e-10
    like the default layout."""
    import tensoralloy_tpu.ops.dense as od
    s = _structure(seed=5)
    fz = Featurizer(["Mo", "Ni"], rcut=4.5)
    model = EamAlloyNN(fz, Counter(s.symbols), hidden_sizes=[8, 8])
    old = od.GATHER_LAYOUT
    od.GATHER_LAYOUT = "t"
    try:
        _compare(model, s, fz)
    finally:
        od.GATHER_LAYOUT = old
