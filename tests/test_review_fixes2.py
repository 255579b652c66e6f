"""Regression tests for the round-2 nn/ review findings."""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensoralloy_tpu.atoms import Structure
from tensoralloy_tpu.transform import Featurizer
from tensoralloy_tpu.nn.sf import SymmetryFunction
from tensoralloy_tpu.nn.atomic import AtomicNN
from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential
from tensoralloy_tpu.nn.eam.models import EamAlloyNN, EamFsNN


def _ni_cell(n=4):
    rng = np.random.RandomState(3)
    pos = rng.uniform(0.5, 4.5, size=(n, 3))
    return Structure.from_symbols(["Ni"] * n, pos, np.eye(3) * 5.5,
                                  pbc=[True] * 3)


def _feats(fz, model, s):
    vap = fz.make_vap(s, model.max_occurs)
    return {k: jnp.asarray(v) for k, v in fz.featurize(s, vap).items()}


def test_fixed_static_energy_freezes_output_bias():
    """fixed_atomic_static_energy must actually pin the static-energy
    bias: its gradient is zero, so the optimizer never moves it."""
    s = _ni_cell()
    fz = Featurizer(["Ni"], rcut=4.5)
    sf = SymmetryFunction(["Ni"])
    for fixed, expect_zero in ((True, True), (False, False)):
        model = AtomicNN(fz, Counter(s.symbols), sf, hidden_sizes=[8],
                         minmax_scale=False,
                         atomic_static_energy={"Ni": -4.0},
                         fixed_static_energy=fixed)
        params = model.init_params(jax.random.PRNGKey(0))
        feats = _feats(fz, model, s)
        g = jax.grad(lambda p: model.energy(p, feats))(params)
        bias_grad = float(jnp.abs(
            g["Ni"]["mlp"]["layers"][-1]["b"]).max())
        if expect_zero:
            assert bias_grad == 0.0
        else:
            assert bias_grad > 0.0


def test_rose_constraint_finite_for_unbound_prediction():
    """a = sqrt(-9 V0 B / E0) must stay finite when the model predicts
    E0 >= 0 (early training), instead of poisoning the loss with NaN."""
    import os
    from tensoralloy_tpu.nn import constraints as C
    crystals_dir = os.path.join(os.path.dirname(__file__), "..",
                                "tensoralloy_tpu", "data", "crystals")
    fz = Featurizer(["Ni"], rcut=6.0)
    sf = SymmetryFunction(["Ni"])
    # +5 eV/atom static bias -> guaranteed positive (unbound) E0
    model = AtomicNN(fz, Counter({"Ni": 1}), sf, hidden_sizes=[8],
                     minmax_scale=False,
                     atomic_static_energy={"Ni": 5.0})
    params = model.init_params(jax.random.PRNGKey(0))
    con = C.RoseConstraint(
        model, C.RoseConstraintOptions(crystals=["Ni"], weight=1.0,
                                       beta=[0.005]),
        base_dir=crystals_dir)
    loss, grads = jax.value_and_grad(
        lambda p: con.loss(p))(params)
    assert np.isfinite(float(loss))
    flat = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(x))) for x in flat)


def test_logcosh_weighted_forces_loss_scale():
    """Uniform sample weights must give the SAME logcosh forces loss
    as no weights (the weighted branch used to be 3x larger)."""
    from tensoralloy_tpu.nn.losses import forces_loss, LossOptions
    rng = np.random.RandomState(0)
    b, nvap = 4, 9
    labels = jnp.asarray(rng.normal(size=(b, nvap, 3)))
    preds = jnp.asarray(rng.normal(size=(b, nvap, 3)))
    masks = jnp.asarray(np.concatenate(
        [np.zeros((b, 1)), np.ones((b, nvap - 1))], axis=1))
    opts = LossOptions(method="logcosh")
    v0, _ = forces_loss(labels, preds, masks, opts)
    v1, _ = forces_loss(labels, preds, masks, opts,
                        sample_weight=jnp.ones(b))
    assert float(v1) == pytest.approx(float(v0), rel=1e-6)


def test_eam_fs_with_element_parameterized_rho():
    """eam/fs with zjw04 everywhere: the ordered-pair rho slot must
    resolve the NEIGHBOR element's density instead of crashing, and
    for a single element FS == alloy exactly."""
    s = _ni_cell()
    fz = Featurizer(["Ni"], rcut=6.0)
    fs = EamFsNN(fz, Counter(s.symbols), custom_potentials="zjw04")
    alloy = EamAlloyNN(fz, Counter(s.symbols),
                       custom_potentials="zjw04")
    p_fs = fs.init_params(jax.random.PRNGKey(0))
    p_al = alloy.init_params(jax.random.PRNGKey(0))
    feats = _feats(fz, fs, s)
    e_fs = float(fs.energy(p_fs, feats))
    e_al = float(alloy.energy(p_al, feats))
    assert np.isfinite(e_fs)
    assert e_fs == pytest.approx(e_al, abs=1e-8)


def test_eam_fs_generic_morse_trains_per_pair_rho():
    """Generic morse on eam/fs: pair sections seed nested phi/rho
    sub-dicts (phi 'A' would collide with density 'A' in Buckingham),
    and the energy evaluates finite with trainable per-pair rho."""
    s = _ni_cell()
    fz = Featurizer(["Ni"], rcut=4.5)
    fs = EamFsNN(fz, Counter(s.symbols), custom_potentials="morse")
    params = fs.init_params(jax.random.PRNGKey(0))
    sec = params["morse"]["NiNi"]
    assert set(sec) == {"phi", "rho"}
    feats = _feats(fz, fs, s)
    e = float(fs.energy(params, feats))
    assert np.isfinite(e)
    g = jax.grad(lambda p: fs.energy(p, feats))(params)
    assert float(jnp.abs(g["morse"]["NiNi"]["rho"]["A"])) > 0.0


@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_grap_moment_list_gaps_are_honored(backend):
    """moment_tensors=[0, 2] must emit exactly those two moment blocks
    (non-legacy mode used to silently compute 0..max)."""
    s = _ni_cell(6)
    fz = Featurizer(["Ni"], rcut=4.5)

    def build(moments):
        g = GenericRadialAtomicPotential(
            ["Ni"], algorithm="pexp",
            parameters={"rl": [1.5, 2.5], "pl": [4.0, 2.0]},
            moment_tensors=moments, backend=backend)
        m = AtomicNN(fz, Counter(s.symbols), g, hidden_sizes=[4],
                     minmax_scale=False)
        p = m.init_params(jax.random.PRNGKey(0))
        return m, p

    m_gap, p_gap = build([0, 2])
    m_full, p_full = build([0, 1, 2])
    feats = _feats(fz, m_gap, s)
    g_gap = np.asarray(m_gap.descriptors(feats, p_gap))
    g_full = np.asarray(m_full.descriptors(feats, p_full))
    k = 2  # filters
    n_slots = fz.n_radial_slots
    assert g_gap.shape[1] == n_slots * k * 2
    assert g_full.shape[1] == n_slots * k * 3
    sel = g_full.reshape(len(g_full), n_slots, k, 3)[..., [0, 2]]
    np.testing.assert_allclose(
        g_gap, sel.reshape(len(g_gap), -1), atol=1e-12)


def test_atomic_l2_includes_descriptor_filters():
    """L2 must cover the trainable GRAP NN-filter stack, not only the
    per-element head MLPs."""
    fz = Featurizer(["Ni"], rcut=4.5)
    g = GenericRadialAtomicPotential(["Ni"], algorithm="nn",
                                     moment_tensors=[0])
    model = AtomicNN(fz, Counter({"Ni": 4}), g, hidden_sizes=[4],
                     minmax_scale=False)
    params = model.init_params(jax.random.PRNGKey(0))
    full = float(model.l2_loss(params))
    heads_only = float(sum(
        jnp.sum(jnp.square(layer["w"]))
        for layer in params["Ni"]["mlp"]["layers"]))
    assert full > heads_only


def test_natural_exp_decay_matches_tf_semantics():
    """natural_exp_decay is lr*exp(-rate*t/steps); mapping it to plain
    exponential_decay with the same rate was ~47x too slow."""
    from tensoralloy_tpu.train.trainer import (OptParameters,
                                               make_lr_schedule)
    opt = OptParameters(learning_rate=0.01,
                        decay_function="natural_exp",
                        decay_rate=0.98, decay_steps=100)
    sched = make_lr_schedule(opt)
    assert float(sched(100)) == pytest.approx(0.01 * np.exp(-0.98),
                                              rel=1e-6)
    assert float(sched(0)) == pytest.approx(0.01, rel=1e-6)


def test_dataset_is_picklable_for_process_fanout(tmp_path):
    """build(serial=False) pickles the bound _featurize_one (and with
    it the Dataset incl. CoreDatabase); the live sqlite3.Connection
    used to make that impossible."""
    import pickle
    import shutil
    from tensoralloy_tpu.io.sqlite import connect
    from tensoralloy_tpu.train.dataset import Dataset
    shutil.copy("/root/reference/test_files/datasets/ethanol/ethanol.db",
                tmp_path / "ethanol.db")
    db = connect(str(tmp_path / "ethanol.db"))
    fz = Featurizer(db.elements, rcut=4.0)
    ds = Dataset(db, fz, name="eth", test_size=2,
                 cache_dir=str(tmp_path))
    worker = pickle.loads(pickle.dumps(ds._featurize_one))
    s = next(iter(db))
    feats, labels = worker(s)
    assert "positions" in feats and "energy" in labels


def test_restore_reset_global_step_restarts_lr_schedule(tmp_path):
    """reset_global_step=true must restart the LR schedule even when
    the optimizer moments are restored: the optax counts inside
    opt_state drive the schedule, not state['step']."""
    import optax
    from tensoralloy_tpu.nn import losses as L
    from tensoralloy_tpu.train.trainer import (Trainer, OptParameters,
                                               TrainParameters)
    fz = Featurizer(["Ni"], rcut=4.5)
    model = AtomicNN(fz, Counter({"Ni": 2}), SymmetryFunction(["Ni"]),
                     hidden_sizes=[4], minmax_scale=False)
    params = model.init_params(jax.random.PRNGKey(0))
    tr = Trainer(model, L.LossParameters(),
                 OptParameters(learning_rate=1e-3,
                               decay_function="exponential",
                               decay_rate=0.5, decay_steps=10),
                 TrainParameters(batch_size=2, train_steps=10),
                 minimize_properties=("energy",), n_devices=1)
    state = tr.init_state(params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    for _ in range(5):
        _, state["opt_state"] = tr.tx.update(
            zeros, state["opt_state"], state["params"])
    state["step"] = jnp.asarray(5, jnp.int32)
    path = str(tmp_path / "ck.npz")
    tr.save_checkpoint(path, jax.device_get(state))
    restored = tr.restore_state(path, params,
                                restore_optimizer_variables=True,
                                reset_global_step=True)
    counts = [np.asarray(x) for x in
              jax.tree_util.tree_leaves(restored["opt_state"])
              if np.asarray(x).dtype.kind in "iu"
              and np.asarray(x).ndim == 0]
    assert counts and all(int(c) == 0 for c in counts)
    # without the reset the counts survive
    kept = tr.restore_state(path, params,
                            restore_optimizer_variables=True,
                            reset_global_step=False)
    counts2 = [int(np.asarray(x)) for x in
               jax.tree_util.tree_leaves(kept["opt_state"])
               if np.asarray(x).dtype.kind in "iu"
               and np.asarray(x).ndim == 0]
    assert any(c == 5 for c in counts2)


def test_slab_with_zero_lattice_vector_keeps_inplane_periodicity():
    """A 2D slab (zero third lattice vector, pbc=[T,T,F]) must keep
    its in-plane periodic images; a periodic axis with a degenerate
    vector is a clear error."""
    from tensoralloy_tpu.neighbor import neighbor_list
    cell = np.array([[4.0, 0, 0], [0, 4.0, 0], [0, 0, 0.0]])
    pos = np.array([[0.5, 0.5, 0.0], [2.5, 2.5, 0.0]])
    slab = Structure.from_symbols(["Ni", "Ni"], pos, cell,
                                  pbc=[True, True, False])
    ii, jj, shift, d, _ = neighbor_list(slab, 4.5)
    # with images: each atom sees the other + its own periodic copies
    assert len(ii) > 2
    assert np.abs(shift[:, :2]).max() >= 1       # in-plane images used
    assert np.abs(shift[:, 2]).max() == 0        # none along z
    bad = Structure.from_symbols(["Ni"], [[0, 0, 0]], cell,
                                 pbc=[True, True, True])
    with pytest.raises(ValueError):
        neighbor_list(bad, 4.5)


def test_triple_bounds_use_angular_cutoff():
    """nijk/ntl padding must be counted within acut, not rcut — at the
    default rcut=6/acut=4 the old bound overshot ~(6/4)^6 ~ 11x."""
    from tensoralloy_tpu.neighbor import find_neighbor_size_of_atoms
    a0 = 3.52
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(2)
                           for j in range(2) for k in range(2)]) / 2
    s = Structure.from_symbols(["Ni"] * 32, frac @ (np.eye(3) * 2 * a0),
                               np.eye(3) * 2 * a0, pbc=[True] * 3)
    wide = find_neighbor_size_of_atoms(s, 6.0, angular=True)
    tight = find_neighbor_size_of_atoms(s, 6.0, angular=True, acut=4.0)
    assert tight.nij == wide.nij                 # pairs unchanged
    assert tight.nijk < wide.nijk / 4            # triples much tighter
    exact = find_neighbor_size_of_atoms(s, 4.0, angular=True)
    assert tight.nijk == exact.nijk
    # acut > rcut: pairs counted at rcut, triples at acut
    big = find_neighbor_size_of_atoms(s, 4.0, angular=True, acut=6.0)
    assert big.nij == exact.nij
    assert big.nijk == wide.nijk


def test_db_write_invalidates_cached_metadata(tmp_path):
    """Appending to a database must drop the cached max_occurs /
    neighbor bounds / static energies so consumers recompute."""
    from tensoralloy_tpu.io.sqlite import connect
    db = connect(str(tmp_path / "t.db"))
    s1 = _ni_cell(4)
    s1.info["energy"] = -17.0
    db.write(s1)
    assert db.max_occurs["Ni"] == 4
    _ = db.get_neighbor_sizes(4.5)
    s2 = Structure.from_symbols(["Ni"] * 6,
                                np.random.RandomState(0).uniform(
                                    0.5, 5.0, (6, 3)),
                                np.eye(3) * 6.0, pbc=[True] * 3)
    s2.info["energy"] = -25.0
    db.write(s2)
    assert db.max_occurs["Ni"] == 6              # recomputed, not stale
    assert "neighbors" not in db.metadata or \
        not db.metadata["neighbors"]


def test_calculator_accessor_errors():
    from tensoralloy_tpu.calculator import TensorAlloyCalculator
    fz = Featurizer(["Ni"], rcut=4.5)
    model = EamAlloyNN(fz, Counter({"Ni": 2}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    calc = TensorAlloyCalculator(model, params)
    with pytest.raises(RuntimeError, match="no structure"):
        calc.get_forces()
    s = _ni_cell(2)
    with pytest.raises(ValueError, match="electron-entropy"):
        calc.get_electron_entropy(s)


def test_get_motifs_runs():
    """Regression: the minimum-image consolidation left an undefined
    `cell` reference — every call raised NameError."""
    from tensoralloy_tpu.analysis.fingerprints import get_motifs
    s = _ni_cell(5)
    motifs = get_motifs(s, 3.0)
    assert len(motifs) == 5
    assert all(len(m) >= 1 for m in motifs)


def test_eos_sj_form():
    """'sj' is documented — it must fit (exact cubic in V^(-1/3))."""
    from tensoralloy_tpu.analysis.eos import (EquationOfState,
                                              birchmurnaghan)
    v = np.linspace(9.0, 13.0, 15)
    e = birchmurnaghan(v, -4.45, 1.1, 4.5, 10.9)
    eos = EquationOfState(v, e, eos="sj")
    v0, e0, b = eos.fit()
    assert v0 == pytest.approx(10.9, rel=0.01)
    assert e0 == pytest.approx(-4.45, abs=0.005)
    assert b == pytest.approx(1.1, rel=0.05)
    assert np.allclose(eos.evaluate(v), e, atol=5e-3)


def test_rhombohedral_metric_falls_back_to_triclinic():
    """fcc primitive cells (and any rhombohedral metric) have their
    3-fold axis along [111], not z — the reduced trigonal pattern
    would fit wrong constants, so detection must fall back."""
    from tensoralloy_tpu.analysis import elastic as EL
    a = 3.52
    cell = np.array([[0, .5, .5], [.5, 0, .5], [.5, .5, 0]]) * a
    s = Structure.from_symbols(["Ni"], [[0, 0, 0]], cell,
                               pbc=[True] * 3)
    assert EL.detect_lattice(s) == "triclinic"


def test_vasp_service_unit_none_before_job_ran(tmp_path):
    """A task with no OUTCAR/timing must yield None (the 'job never
    ran' gate) — a zero-hour unit made every unstarted task count as
    completed in the status scan."""
    from tensoralloy_tpu.tensordb.vaspkit import VaspJob
    job = VaspJob(tmp_path)
    assert job.get_vasp_job_service_unit() is None


def test_insert_interstitials_minimum_image(tmp_path):
    """Candidates near a cell face must clear the periodic images of
    atoms at the opposite face."""
    from tensoralloy_tpu.tensordb.microstructure import (
        insert_interstitials)
    from tensoralloy_tpu.atoms import minimum_image
    s = Structure.from_symbols(["Ni"], [[0.05, 0.05, 0.05]],
                               np.eye(3) * 4.0, pbc=[True] * 3)
    out = insert_interstitials(s, "He", count=3, min_distance=1.8,
                               seed=1, max_trials=5000)
    pos = out.positions
    for i in range(len(out)):
        for j in range(i + 1, len(out)):
            d = np.linalg.norm(minimum_image(pos[j] - pos[i],
                                             out.cell, out.pbc))
            assert d > 1.8 - 1e-9


def test_ensure_cell_preserves_slab_periodicity():
    """featurize() calls ensure_cell on volume~0 structures; a slab
    must keep its real in-plane lattice vectors and pbc (it used to be
    silently converted to an isolated cluster)."""
    cell = np.array([[4.0, 0, 0], [0, 4.0, 0], [0, 0, 0.0]])
    slab = Structure.from_symbols(
        ["Ni", "Ni"], [[0.5, 0.5, 0.0], [2.5, 2.5, 0.0]], cell,
        pbc=[True, True, False])
    out = slab.ensure_cell()
    np.testing.assert_allclose(out.cell[:2], cell[:2])
    assert list(out.pbc) == [True, True, False]
    assert abs(np.linalg.det(out.cell)) > 1.0
    # featurization end-to-end: in-plane periodic pairs must exist
    fz = Featurizer(["Ni"], rcut=4.5)
    feats = fz.featurize(slab)
    assert int(np.sum(feats["pair_mask"])) > 2
    with pytest.raises(ValueError):
        Structure.from_symbols(["Ni"], [[0, 0, 0]], cell,
                               pbc=[True] * 3).ensure_cell()


def test_neighbor_list_handles_unwrapped_positions():
    """Unwrapped (MD-trajectory) coordinates must give the same pair
    list as wrapped ones, with shifts adjusted so R_j + S@cell - R_i
    stays exact for the RAW positions."""
    from tensoralloy_tpu.neighbor import neighbor_list
    rng = np.random.RandomState(0)
    cell = np.eye(3) * 5.0
    pos = rng.uniform(0, 5.0, (6, 3))
    s_wrapped = Structure.from_symbols(["Ni"] * 6, pos, cell,
                                       pbc=[True] * 3)
    # push atoms several cells away (unwrapped trajectory frame)
    drift = rng.randint(-3, 4, (6, 3)).astype(float) @ cell
    s_raw = Structure.from_symbols(["Ni"] * 6, pos + drift, cell,
                                   pbc=[True] * 3)
    iw, jw, _, dw, _ = neighbor_list(s_wrapped, 4.0)
    ir, jr, sr, dr, vr = neighbor_list(s_raw, 4.0)
    assert len(ir) == len(iw)
    np.testing.assert_allclose(np.sort(dr), np.sort(dw), atol=1e-10)
    # the shift contract holds for the raw coordinates
    recon = s_raw.positions[jr] + sr @ cell - s_raw.positions[ir]
    np.testing.assert_allclose(np.linalg.norm(recon, axis=1), dr,
                               atol=1e-10)


def test_minimum_image_skewed_cell():
    """Fractional rounding alone is not minimal for skewed cells; the
    refined search must find the true shortest image."""
    from tensoralloy_tpu.atoms import minimum_image
    cell = np.array([[10.0, 0, 0], [5.0, 8.66, 0], [0, 0, 10.0]])
    d = 0.5 * cell[0] + 0.5 * cell[1]          # (7.5, 4.33, 0)
    m = minimum_image(d, cell)
    assert np.linalg.norm(m) == pytest.approx(5.0, abs=0.01)


def test_truncated_setfl_raises(tmp_path):
    from tensoralloy_tpu.io.lammps import read_eam_alloy_setfl
    p = tmp_path / "bad.eam.alloy"
    p.write_text("c1\nc2\nc3\n1 Ni\n5 0.1 5 0.1 5.0\n"
                 "28 58.69 3.52 fcc\n1.0 2.0 3.0\n")   # far too short
    with pytest.raises(ValueError, match="truncated"):
        read_eam_alloy_setfl(str(p))
