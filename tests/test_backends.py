"""Descriptor backend equivalence: segment (flat + segment_sum) vs
dense (per-atom matmul layout) — values AND gradients (forces/stress
through both layouts)."""
import copy
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensoralloy_tpu.atoms import Structure
from tensoralloy_tpu.transform import Featurizer
from tensoralloy_tpu.nn.sf import SymmetryFunction
from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu.nn.atomic import AtomicNN
from tensoralloy_tpu.nn.fields import make_efs_fn


def _structure(seed=0, n=24):
    rng = np.random.RandomState(seed)
    symbols = ["Ni"] * (n // 2) + ["Mo"] * (n - n // 2)
    a = 7.0
    pos = rng.uniform(0, a, (n, 3))
    return Structure.from_symbols(symbols, pos, np.eye(3) * a,
                                  pbc=[True] * 3)


def _feats(angular=False, seed=0):
    s = _structure(seed)
    fz = Featurizer(["Mo", "Ni"], rcut=4.5, angular=angular)
    vap = fz.make_vap(s)
    return s, fz, {k: jnp.asarray(v) for k, v in
                   fz.featurize(s, vap).items()}


def _tol():
    return dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend", ["dense"])
def test_g2_backends_match(backend):
    s, fz, feats = _feats(angular=False)
    ref = SymmetryFunction(fz.elements)
    alt = SymmetryFunction(fz.elements, backend=backend)
    g_ref = np.asarray(ref.radial(feats, fz.rcut, fz.n_radial_slots))
    g_alt = np.asarray(alt.radial(feats, fz.rcut, fz.n_radial_slots))
    np.testing.assert_allclose(g_alt, g_ref, **_tol())


@pytest.mark.parametrize("backend", ["dense"])
def test_g4_backends_match(backend):
    s, fz, feats = _feats(angular=True)
    ref = SymmetryFunction(fz.elements)
    alt = SymmetryFunction(fz.elements, backend=backend)
    g_ref = np.asarray(ref.angular(feats, fz.acut, fz.n_angular_slots))
    g_alt = np.asarray(alt.angular(feats, fz.acut, fz.n_angular_slots))
    np.testing.assert_allclose(g_alt, g_ref, **_tol())


@pytest.mark.parametrize("backend", ["dense"])
@pytest.mark.parametrize("algorithm,moments", [
    ("pexp", [0, 1, 2, 3]),
    ("pexp", [0, 1, 2, 3, 4, 5]),   # full-basis regime (kernel uses
    ("pexp", [0, 2, 5]),            # compressed multiplicities) + gaps
    ("sf", [0, 1, 2, 3]),
    ("morse", [0, 1, 2, 3]),
    ("density", [0, 1, 2, 3]),
])
def test_grap_backends_match(backend, algorithm, moments):
    s, fz, feats = _feats(angular=False)
    params = {
        "pexp": {"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]},
        "sf": {"eta": [0.5, 2.0, 8.0], "omega": [0.0, 0.0, 0.0]},
        "morse": {"D": [1.0, 1.0], "gamma": [0.5, 1.0], "r0": [2.0, 2.5]},
        "density": {"A": [1.0, 1.0], "beta": [2.0, 4.0], "re": [3.0, 3.0]},
    }[algorithm]
    kw = dict(algorithm=algorithm, parameters=params,
              moment_tensors=moments)
    ref = GenericRadialAtomicPotential(fz.elements, **kw)
    alt = GenericRadialAtomicPotential(fz.elements, **kw, backend=backend)
    args = (feats, fz.rcut, fz.acut, fz.n_radial_slots,
            fz.n_angular_slots, False)
    g_ref = np.asarray(ref.compute(*args))
    g_alt = np.asarray(alt.compute(*args))
    np.testing.assert_allclose(g_alt, g_ref, **_tol())


@pytest.mark.parametrize("backend", ["dense"])
def test_forces_and_stress_through_backends(backend):
    """The full EFS pipeline (jax.grad of energy wrt positions + cell)
    must agree across backends."""
    s = _structure(3)
    fz = Featurizer(["Mo", "Ni"], rcut=4.5, angular=True)
    vap0 = fz.make_vap(s)
    feats = {k: jnp.asarray(v) for k, v in fz.featurize(s, vap0).items()}

    def efs_for(be):
        desc = SymmetryFunction(fz.elements, backend=be)
        model = AtomicNN(fz, Counter(s.symbols), desc,
                         hidden_sizes=[8], minmax_scale=False)
        params = model.init_params(jax.random.PRNGKey(0))
        out = make_efs_fn(model.energy)(params, feats)
        return {k: np.asarray(v) for k, v in out.items()
                if k in ("energy", "forces", "stress_voigt")}

    ref = efs_for("segment")
    alt = efs_for(backend)
    np.testing.assert_allclose(alt["energy"], ref["energy"], **_tol())
    np.testing.assert_allclose(alt["forces"], ref["forces"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(alt["stress_voigt"], ref["stress_voigt"],
                               rtol=2e-4, atol=2e-5)


def test_backend_survives_model_save_roundtrip(tmp_path):
    from tensoralloy_tpu.io.model import save_model, load_model
    s, fz, feats = _feats()
    desc = SymmetryFunction(fz.elements, backend="dense")
    model = AtomicNN(fz, Counter(s.symbols), desc, hidden_sizes=[8],
                     minmax_scale=False)
    params = model.init_params(jax.random.PRNGKey(0))
    path = str(tmp_path / "m.npz")
    save_model(path, model, params)
    model2, _, _ = load_model(path)
    assert model2.descriptor.backend == "dense"


@pytest.mark.parametrize("algorithm,moments", [
    ("pexp", [0, 1, 2, 3]),
    ("pexp", [0, 1, 2, 3, 4, 5]),
    ("sf", [0, 1, 2, 3]),
    ("morse", [0, 1, 2]),
    ("density", [0, 1, 2]),
])
def test_grap_dense_orientation_lane_n_matches(algorithm, moments):
    """DENSE_ORIENTATION='lane-n' (NNL on the lane axis, the layout
    that avoids the K/D minor-axis tile padding — PERF.md round-5)
    produces identical descriptors AND position gradients to the
    default 'lane-k' orientation, including the multi-slot (Mo+Ni)
    selection."""
    import tensoralloy_tpu.nn.grap as grap_mod
    s, fz, feats = _feats(angular=False)
    params = {
        "pexp": {"rl": [1.0, 2.0, 3.0], "pl": [4.0, 3.0, 2.0]},
        "sf": {"eta": [0.5, 2.0, 8.0], "omega": [0.0, 0.0, 0.0]},
        "morse": {"D": [1.0, 1.0], "gamma": [0.5, 1.0], "r0": [2.0, 2.5]},
        "density": {"A": [1.0, 1.0], "beta": [2.0, 4.0], "re": [3.0, 3.0]},
    }[algorithm]
    desc = GenericRadialAtomicPotential(
        fz.elements, algorithm=algorithm, parameters=params,
        moment_tensors=moments, backend="dense")
    args = (feats, fz.rcut, fz.acut, fz.n_radial_slots,
            fz.n_angular_slots, False)

    def grad_pos():
        def loss(pos):
            f = dict(feats)
            f["positions"] = pos
            return jnp.sum(jnp.square(desc.compute(*((f,) + args[1:]))))
        return jax.grad(loss)(feats["positions"])

    g_ref = np.asarray(desc.compute(*args))
    dg_ref = np.asarray(grad_pos())
    old = grap_mod.DENSE_ORIENTATION
    grap_mod.DENSE_ORIENTATION = "lane-n"
    try:
        g_t = np.asarray(desc.compute(*args))
        dg_t = np.asarray(grad_pos())
    finally:
        grap_mod.DENSE_ORIENTATION = old
    np.testing.assert_allclose(g_t, g_ref, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(dg_t, dg_ref, rtol=1e-8, atol=1e-10)


def test_gather_vec_layout_t_matches():
    """GATHER_LAYOUT='t' ([A, 3, N]-layout neighbor gather, no
    lane-padded [A, N, 3] intermediate) returns the same component
    tuple and gradients as the default row gather."""
    import tensoralloy_tpu.ops.dense as od
    s, fz, feats = _feats(angular=False)
    pos, jd = feats["positions"], feats["pair_j_d"]
    simg, cell = feats["pair_simg_d"], feats["cell"]

    def run():
        v = od.gather_vec(pos, jd, simg, cell)
        return [np.asarray(c) for c in v]

    def grad_run():
        def loss(p):
            v = od.gather_vec(p, jd, simg, cell)
            return sum(jnp.vdot(c, c) for c in v)
        return np.asarray(jax.grad(loss)(pos))

    ref, dref = run(), grad_run()
    old = od.GATHER_LAYOUT
    od.GATHER_LAYOUT = "t"
    try:
        got, dgot = run(), grad_run()
    finally:
        od.GATHER_LAYOUT = old
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(dgot, dref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("where", ["sf", "grap", "toml"])
def test_pallas_backend_is_rejected(where, tmp_path):
    """The fused-kernel backend is gone: every entry point that takes a
    descriptor backend names the valid choices."""
    if where == "sf":
        with pytest.raises(ValueError, match="'segment' or 'dense'"):
            SymmetryFunction(["Ni"], backend="pallas")
    elif where == "grap":
        with pytest.raises(ValueError, match="'segment' or 'dense'"):
            GenericRadialAtomicPotential(["Ni"], backend="pallas")
    else:
        from tensoralloy_tpu.io.input import InputReader
        path = tmp_path / "input.toml"
        path.write_text('[dataset]\nsqlite3 = "x.db"\nname = "x"\n'
                        '[nn.atomic.grap]\nbackend = "pallas"\n')
        with pytest.raises(ValueError, match="not a valid choice for "
                           "'nn.atomic.grap.backend'"):
            InputReader(str(path))
