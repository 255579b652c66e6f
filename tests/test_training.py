"""Integration: db -> dataset -> train -> export -> calculator.

Mirrors the reference's `train/tests/test_training.py` wiring tests and
short-train smoke runs, on the bundled ethanol fixture database.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensoralloy_tpu.io.sqlite import connect
from tensoralloy_tpu.transform import Featurizer
from tensoralloy_tpu.nn.sf import SymmetryFunction
from tensoralloy_tpu.nn.atomic import AtomicNN
from tensoralloy_tpu.nn import losses as L
from tensoralloy_tpu.train.dataset import Dataset, batches
from tensoralloy_tpu.train.trainer import (Trainer, OptParameters,
                                           TrainParameters)

DB_SRC = "/root/reference/test_files/datasets/ethanol/ethanol.db"


@pytest.fixture(scope="module")
def ethanol_db(tmp_path_factory):
    path = tmp_path_factory.mktemp("db") / "ethanol.db"
    shutil.copy(DB_SRC, path)
    return connect(str(path))


def test_db_read(ethanol_db):
    db = ethanol_db
    assert len(db) == 10
    assert db.elements == ["C", "H", "O"]
    s = db.get(1)
    assert len(s) == 9
    assert s.energy is not None
    assert s.forces.shape == (9, 3)
    occurs = db.max_occurs
    assert occurs["C"] == 2 and occurs["H"] == 6 and occurs["O"] == 1


def test_db_static_energy(ethanol_db):
    # cached metadata (written by the reference) is honored as-is
    se = ethanol_db.get_atomic_static_energy()
    assert set(se) == {"C", "H", "O"}

    # recomputation from scratch must match an independent lstsq in
    # *prediction* space (composition matrix may be rank-deficient)
    md = ethanol_db.metadata
    md.pop("atomic_static_energy")
    ethanol_db.metadata = md
    se2 = ethanol_db.get_atomic_static_energy()
    rows, b = [], []
    for s in ethanol_db:
        c = s.count()
        rows.append([c.get(e, 0) for e in ["C", "H", "O"]])
        b.append(s.energy)
    a = np.asarray(rows, float)
    b = np.asarray(b)
    x = np.linalg.lstsq(a, b, rcond=None)[0]
    got = np.array([se2["C"], se2["H"], se2["O"]])
    np.testing.assert_allclose(a @ got, a @ x, rtol=1e-8)
    # restore the reference cache for downstream fixtures
    ethanol_db._update_metadata(atomic_static_energy=se)


def test_db_roundtrip(tmp_path, ethanol_db):
    out = connect(str(tmp_path / "copy.db"))
    s0 = ethanol_db.get(1)
    out.write(s0)
    back = out.get(1)
    np.testing.assert_allclose(back.positions, s0.positions)
    np.testing.assert_allclose(back.forces, s0.forces)
    assert back.energy == pytest.approx(s0.energy)
    np.testing.assert_array_equal(back.numbers, s0.numbers)


def test_dataset_build_and_batches(ethanol_db, tmp_path):
    fz = Featurizer(ethanol_db.elements, rcut=5.0)
    ds = Dataset(ethanol_db, fz, name="ethanol", test_size=2,
                 dtype=np.float64, cache_dir=str(tmp_path))
    feats, labels = ds.build()
    assert feats["positions"].shape == (10, ds.n_atoms_vap, 3)
    assert feats["pair_i"].shape == (10, ds.nij_max)
    tf_, tl_, ef_, el_ = ds.split(feats, labels)
    assert len(el_["energy"]) == 2 and len(tl_["energy"]) == 8
    bf, bl = next(batches(tf_, tl_, 4, seed=1, repeat=True))
    assert bf["pair_i"].shape == (4, ds.nij_max)
    # cache reload produces identical arrays
    feats2, labels2 = ds.build()
    np.testing.assert_array_equal(feats["pair_i"], feats2["pair_i"])


@pytest.fixture(scope="module")
def trained(ethanol_db, tmp_path_factory):
    fz = Featurizer(ethanol_db.elements, rcut=5.0)
    ds = Dataset(ethanol_db, fz, name="ethanol", test_size=2,
                 dtype=np.float64,
                 cache_dir=str(tmp_path_factory.mktemp("cache")))
    feats, labels = ds.build()
    tf_, tl_, ef_, el_ = ds.split(feats, labels)
    sf = SymmetryFunction(ethanol_db.elements)
    model = AtomicNN(fz, ds.max_occurs, sf, hidden_sizes=[16, 16],
                     atomic_static_energy=
                     ethanol_db.get_atomic_static_energy())
    trainer = Trainer(model, L.LossParameters(),
                      OptParameters(learning_rate=0.005),
                      TrainParameters(batch_size=4, train_steps=60,
                                      eval_steps=30, log_steps=1000),
                      minimize_properties=("energy", "forces"),
                      n_devices=1)
    out = trainer.fit(tf_, tl_, ef_, el_, verbose=False)
    return model, trainer, out, (tf_, tl_, ef_, el_)


def test_training_loss_decreases(trained):
    model, trainer, out, (tf_, tl_, ef_, el_) = trained
    state = out["state"]
    loss0, _ = trainer.total_loss(
        model.init_params(jax.random.PRNGKey(611)),
        {k: jnp.asarray(v[:4]) for k, v in tf_.items()},
        {k: jnp.asarray(v[:4]) for k, v in tl_.items()}, 0)
    loss1, _ = trainer.total_loss(
        jax.device_get(state["params"]),
        {k: jnp.asarray(v[:4]) for k, v in tf_.items()},
        {k: jnp.asarray(v[:4]) for k, v in tl_.items()}, 0)
    assert float(loss1) < float(loss0)
    assert int(state["step"]) == 60


def test_ema_differs_from_params(trained):
    _, _, out, _ = trained
    state = out["state"]
    p = jax.tree_util.tree_leaves(state["params"])[0]
    e = jax.tree_util.tree_leaves(state["ema_params"])[0]
    assert not np.allclose(np.asarray(p), np.asarray(e))


def test_precision_annealing_final_f32_steps(ethanol_db, tmp_path):
    """final_f32_steps switches the train step to exact-f32 matmuls for
    the tail of the run (one extra compile). On CPU the precision
    context is a numerical no-op, so an annealed run must reproduce a
    plain run bit-for-bit — pinning that the switch changes ONLY the
    lowering precision, never the math, the batch stream, or the step
    count. Covers both the device-resident and host-streamed paths."""
    fz = Featurizer(ethanol_db.elements, rcut=5.0)
    ds = Dataset(ethanol_db, fz, name="ethanol", test_size=2,
                 dtype=np.float64, cache_dir=str(tmp_path))
    feats, labels = ds.build()
    tf_, tl_, ef_, el_ = ds.split(feats, labels)
    sf = SymmetryFunction(ethanol_db.elements)

    def run(final_f32, device_dataset):
        model = AtomicNN(fz, ds.max_occurs, sf, hidden_sizes=[8, 8],
                         atomic_static_energy=
                         ethanol_db.get_atomic_static_energy())
        tr = Trainer(model, L.LossParameters(),
                     OptParameters(learning_rate=0.005),
                     TrainParameters(batch_size=4, train_steps=24,
                                     eval_steps=1000, log_steps=1000,
                                     scan_steps=4,
                                     device_dataset=device_dataset,
                                     final_f32_steps=final_f32),
                     minimize_properties=("energy", "forces"),
                     n_devices=1)
        out = tr.fit(tf_, tl_, ef_, el_, verbose=False)
        assert int(out["state"]["step"]) == 24
        # on CPU bit-equality alone can't tell whether the switch
        # FIRED (f32 == default numerics here) — pin that the f32
        # program was actually built iff annealing was requested
        attr = ("_train_step_ix_f32" if device_dataset
                else "_train_step_f32")
        assert (getattr(tr, attr, None) is not None) == bool(final_f32)
        return jax.device_get(out["state"]["params"])

    for device_dataset in (True, False):
        base = run(0, device_dataset)
        annealed = run(12, device_dataset)
        for a, b in zip(jax.tree_util.tree_leaves(base),
                        jax.tree_util.tree_leaves(annealed)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_eval_matmul_precision_validated_at_construction():
    """A typo'd precision string must fail at TrainParameters
    construction, not hours into a run when the first eval trace
    enters jax.default_matmul_precision."""
    with pytest.raises(ValueError, match="eval_matmul_precision"):
        TrainParameters(eval_matmul_precision="high32")


def test_eval_matmul_precision_is_deployment_grade(trained):
    """Training-time evals must lower at exact-f32 matmul precision by
    default: reduced-precision (bf16/TF32) matmuls co-adapt
    late-training weights to their own rounding, and a bf16-evaluated
    test MAE can read ~2x
    better than exact evaluation of the SAME params (measured:
    snap_ni_refsf 2.23 vs 4.08 meV/atom at ckpt-150000). Pins the
    default, the knob plumbing, and that a rebuilt eval step under an
    explicit precision produces identical metrics on CPU."""
    model, trainer, out, (tf_, tl_, ef_, el_) = trained
    assert trainer.train_parameters.eval_matmul_precision == "highest"
    ema = jax.device_get(out["state"]["ema_params"])
    ev_default = trainer.evaluate(ema, ef_, el_)
    # rebuild the eval step under the device-native precision; on CPU
    # both lower to the same f32 kernels, so metrics must agree — the
    # point is that the context plumbing traces and runs
    trainer.train_parameters.eval_matmul_precision = "default"
    trainer._eval_step = trainer._build_eval_step()
    ev_native = trainer.evaluate(ema, ef_, el_)
    trainer.train_parameters.eval_matmul_precision = "highest"
    trainer._eval_step = trainer._build_eval_step()
    for k in ("energy/mae/atom", "forces/mae"):
        assert abs(ev_default[k] - ev_native[k]) < 1e-10


def test_checkpoint_roundtrip(trained, tmp_path):
    model, trainer, out, _ = trained
    state = jax.device_get(out["state"])
    path = str(tmp_path / "ckpt.npz")
    trainer.save_checkpoint(path, state)
    params, ema, step = trainer.load_checkpoint(path, state["params"])
    assert step == 60
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(state["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_export_and_calculator(trained, tmp_path, ethanol_db):
    from tensoralloy_tpu.io.model import save_model, load_model
    from tensoralloy_tpu.calculator import TensorAlloyCalculator
    model, trainer, out, _ = trained
    params = jax.device_get(out["state"]["ema_params"])
    path = str(tmp_path / "model.npz")
    save_model(path, model, params)

    calc = TensorAlloyCalculator(path)
    s = ethanol_db.get(3)
    e = calc.get_potential_energy(s)
    f = calc.get_forces(s)
    assert np.isfinite(e)
    assert f.shape == (9, 3)
    # direct-model evaluation must agree with the reloaded model
    calc2 = TensorAlloyCalculator(model, params)
    assert calc2.get_potential_energy(s) == pytest.approx(e, abs=1e-8)
    # translation invariance
    s2 = s.copy()
    s2.positions = s2.positions + 0.37
    assert calc.get_potential_energy(s2) == pytest.approx(e, abs=1e-6)
    ae = calc.get_atomic_energies(s)
    assert ae.shape == (9,)
    assert np.sum(ae) == pytest.approx(e, abs=1e-8)


def test_data_parallel_matches_single_device(ethanol_db, tmp_path):
    """Same batch, 1-device vs 2-device mesh -> identical loss/grads."""
    fz = Featurizer(ethanol_db.elements, rcut=5.0)
    ds = Dataset(ethanol_db, fz, name="ethanol", test_size=2,
                 dtype=np.float64, cache_dir=str(tmp_path))
    feats, labels = ds.build()
    sf = SymmetryFunction(ethanol_db.elements)
    model = AtomicNN(fz, ds.max_occurs, sf, hidden_sizes=[8],
                     minmax_scale=False)
    params = model.init_params(jax.random.PRNGKey(0))
    losses = []
    from tensoralloy_tpu.parallel.mesh import shard_batch, replicate
    for ndev in (1, 2):
        trainer = Trainer(model, L.LossParameters(),
                          OptParameters(learning_rate=1e-3),
                          TrainParameters(batch_size=4, train_steps=1),
                          minimize_properties=("energy", "forces"),
                          n_devices=ndev)
        step_fn = trainer._build_train_step()
        state = replicate(trainer.init_state(params), trainer.mesh)
        bf = shard_batch({k: jnp.asarray(v[:4]) for k, v in feats.items()},
                         trainer.mesh)
        bl = shard_batch({k: jnp.asarray(v[:4]) for k, v in labels.items()},
                         trainer.mesh)
        _, metrics = step_fn(state, bf, bl)
        losses.append(float(metrics["loss/total"]))
    assert losses[0] == pytest.approx(losses[1], rel=1e-12)


def test_calculator_arbitrary_stoichiometry(trained, ethanol_db):
    """Inference must re-layout the model for structures whose
    stoichiometry differs from the training max_occurs (the calculator
    buckets per-element counts and clones the model layout)."""
    from tensoralloy_tpu.calculator import TensorAlloyCalculator
    from tensoralloy_tpu.atoms import Structure
    model, trainer, out, _ = trained
    params = jax.device_get(out["state"]["ema_params"])
    calc = TensorAlloyCalculator(model, params)

    s = ethanol_db.get(2)
    e0 = calc.get_potential_energy(s)

    # rigid rotation: energy invariant, forces co-rotate
    th = 0.7
    rot = np.array([[np.cos(th), -np.sin(th), 0],
                    [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    f0 = calc.get_forces(s)
    s2 = s.copy()
    s2.positions = s.positions @ rot.T
    assert calc.get_potential_energy(s2) == pytest.approx(e0, abs=1e-9)
    np.testing.assert_allclose(calc.get_forces(s2), f0 @ rot.T, atol=1e-9)

    # unknown element -> clear error
    with pytest.raises(ValueError, match="Fe"):
        calc.get_potential_energy(Structure.from_symbols(
            ["Fe", "H"], [[0, 0, 0], [1, 0, 0]], np.eye(3) * 10))

    # bigger molecule than any training structure
    rng = np.random.RandomState(0)
    big = Structure.from_symbols(
        ["C"] * 4 + ["H"] * 10 + ["O"] * 2,
        rng.uniform(0, 6, (16, 3)), np.eye(3) * 12)
    assert np.isfinite(calc.get_potential_energy(big))

    # two different atom orders of the same formula agree
    perm = np.array([3, 0, 5, 1, 8, 2, 7, 4, 6])
    s3 = Structure(s.numbers[perm], s.positions[perm], s.cell.copy(),
                   s.pbc.copy())
    assert calc.get_potential_energy(s3) == pytest.approx(e0, abs=1e-9)
    np.testing.assert_allclose(calc.get_forces(s3), f0[perm], atol=1e-9)


def test_warm_start_semantics(trained, tmp_path):
    """restore_state: raw vs EMA weights, optimizer restore, step
    reset (reference `[train.ckpt]` + WarmStartFromVariablesHook)."""
    model, trainer, out, _ = trained
    state = jax.device_get(out["state"])
    path = str(tmp_path / "ws.npz")
    trainer.save_checkpoint(path, state)
    template = state["params"]

    st1 = trainer.restore_state(path, template, use_ema_variables=False,
                                reset_global_step=False)
    np.testing.assert_array_equal(
        np.asarray(jax.tree_util.tree_leaves(st1["params"])[0]),
        np.asarray(jax.tree_util.tree_leaves(state["params"])[0]))
    assert int(st1["step"]) == 60

    st2 = trainer.restore_state(path, template, use_ema_variables=True,
                                reset_global_step=True)
    np.testing.assert_array_equal(
        np.asarray(jax.tree_util.tree_leaves(st2["params"])[0]),
        np.asarray(jax.tree_util.tree_leaves(state["ema_params"])[0]))
    assert int(st2["step"]) == 0
    # optimizer moments restored
    l1 = jax.tree_util.tree_leaves(state["opt_state"])
    l2 = jax.tree_util.tree_leaves(st1["opt_state"])
    found_nonzero = False
    for a, b in zip(l1, l2):
        if np.asarray(a).size and np.asarray(a).dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))
            if np.any(np.asarray(a) != 0):
                found_nonzero = True
    assert found_nonzero

    # train_steps is an ABSOLUTE global-step horizon (reference
    # Estimator `max_steps`): a state restored at the horizon is a
    # no-op; raising the horizon continues from the restored step
    out2 = trainer.fit(*_[:2], verbose=False, initial_state=st1)
    assert int(out2["state"]["step"]) == 60
    trainer.train_parameters.train_steps = 90
    out3 = trainer.fit(*_[:2], verbose=False, initial_state=st1)
    assert int(out3["state"]["step"]) == 90
    trainer.train_parameters.train_steps = 60


def test_scan_steps_equivalent(ethanol_db, tmp_path):
    """scan_steps=K (fused lax.scan updates) produces the same params
    as K individual dispatched steps over the same batch sequence."""
    from tensoralloy_tpu.nn.sf import SymmetryFunction as SF
    fz = Featurizer(ethanol_db.elements, rcut=5.0)
    ds = Dataset(ethanol_db, fz, name="ethanol", test_size=2,
                 dtype=np.float64, cache_dir=str(tmp_path))
    feats, labels = ds.build()
    tf_, tl_, _, _ = ds.split(feats, labels)
    model = AtomicNN(fz, ds.max_occurs, SF(ethanol_db.elements),
                     hidden_sizes=[8], minmax_scale=False)
    params0 = jax.device_get(
        model.init_params(jax.random.PRNGKey(7)))
    results = []
    for scan_steps in (1, 4):
        trainer = Trainer(
            model, L.LossParameters(),
            OptParameters(learning_rate=1e-3),
            TrainParameters(batch_size=4, train_steps=8, eval_steps=100,
                            log_steps=1000, seed=123,
                            scan_steps=scan_steps),
            minimize_properties=("energy", "forces"), n_devices=1)
        out = trainer.fit(tf_, tl_, params=params0, verbose=False)
        assert int(out["state"]["step"]) == 8
        results.append(jax.device_get(out["state"]["params"]))
    for a, b in zip(jax.tree_util.tree_leaves(results[0]),
                    jax.tree_util.tree_leaves(results[1])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-12)


def test_microbatch_grad_accumulation_equivalent(ethanol_db, tmp_path):
    """train.microbatch_size=M (gradient accumulation inside the
    compiled step) produces the same params as the monolithic batch
    when the loss is linear in the batch mean (logcosh here: rmse is a
    sqrt OF the batch mean, so its accumulated objective is the mean
    of per-chunk RMSEs — the standard accumulation convention, see
    TrainParameters.microbatch_size). Also fuses with scan_steps (the
    accumulation scan nests inside the K-step scan)."""
    from tensoralloy_tpu.nn.sf import SymmetryFunction as SF
    fz = Featurizer(ethanol_db.elements, rcut=5.0)
    ds = Dataset(ethanol_db, fz, name="ethanol", test_size=2,
                 dtype=np.float64, cache_dir=str(tmp_path))
    feats, labels = ds.build()
    tf_, tl_, _, _ = ds.split(feats, labels)
    model = AtomicNN(fz, ds.max_occurs, SF(ethanol_db.elements),
                     hidden_sizes=[8], minmax_scale=False)
    params0 = jax.device_get(
        model.init_params(jax.random.PRNGKey(7)))
    lp = L.LossParameters(
        energy=L.LossOptions(method="logcosh"),
        forces=L.LossOptions(method="logcosh"))
    results = []
    for mb in (0, 2):
        trainer = Trainer(
            model, lp,
            OptParameters(learning_rate=1e-3),
            TrainParameters(batch_size=4, train_steps=8, eval_steps=100,
                            log_steps=1000, seed=123, scan_steps=2,
                            microbatch_size=mb),
            minimize_properties=("energy", "forces"), n_devices=1)
        out = trainer.fit(tf_, tl_, params=params0, verbose=False)
        assert int(out["state"]["step"]) == 8
        results.append(jax.device_get(out["state"]["params"]))
    for a, b in zip(jax.tree_util.tree_leaves(results[0]),
                    jax.tree_util.tree_leaves(results[1])):
        # equality up to summation reassociation: the accumulated
        # chunk-mean differs from the monolithic batch mean in add
        # order, and XLA's fusion choices (which shift with global
        # compile state set by earlier tests) move the noise floor —
        # observed 1.9e-9 abs in full-suite order vs <1e-12 standalone
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-8, rtol=1e-7)
    # non-divisor microbatch fails at construction, not trace time
    with pytest.raises(ValueError, match="microbatch_size"):
        TrainParameters(batch_size=4, microbatch_size=3)


def test_spatial_pair_sharding_matches_single_device():
    """Spatial parallelism (parallel/spatial.py): one structure's pair
    arrays sharded over a 4-device mesh gives the same energy, forces
    and stress as a single device — XLA partitions the segment-sums
    and all-reduces the per-atom accumulators, so the nonlinear
    embedding runs on exact densities."""
    from collections import Counter
    from tensoralloy_tpu.atoms import Structure
    from tensoralloy_tpu.nn.eam import EamAlloyNN
    from tensoralloy_tpu.nn.fields import make_efs_fn
    from tensoralloy_tpu.parallel.mesh import make_mesh
    from tensoralloy_tpu.parallel.spatial import (
        is_pairwise_key, make_spatial_efs_fn, shard_features_spatial)

    rng = np.random.RandomState(7)
    a0, n_cell = 3.52, 2
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(n_cell)
                           for j in range(n_cell) for k in range(n_cell)])
    s = Structure.from_symbols(
        ["Ni"] * len(frac),
        frac * a0 + rng.normal(scale=0.08, size=(len(frac), 3)),
        np.eye(3) * a0 * n_cell, pbc=[True] * 3)
    fz = Featurizer(["Ni"], rcut=5.0)
    model = EamAlloyNN(fz, Counter({"Ni": len(s)}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    feats_np = fz.featurize(s, fz.make_vap(s, model.max_occurs))
    ref = jax.jit(make_efs_fn(model.energy))(
        params, {k: jnp.asarray(v) for k, v in feats_np.items()})

    mesh = make_mesh(4, axis_name="pairs")
    sharded = shard_features_spatial(feats_np, mesh)
    # pair arrays padded to a multiple of the mesh and actually sharded
    assert sharded["pair_i"].shape[0] % 4 == 0
    assert not is_pairwise_key("positions")
    assert not is_pairwise_key("pair_j_d")   # dense cols stay replicated
    out = make_spatial_efs_fn(model.energy, mesh)(params, sharded)
    assert float(out["energy"]) == pytest.approx(float(ref["energy"]),
                                                 abs=1e-8)
    np.testing.assert_allclose(np.asarray(out["forces"]),
                               np.asarray(ref["forces"]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out["stress_voigt"]),
                               np.asarray(ref["stress_voigt"]),
                               atol=1e-8)


def test_spatial_dense_fast_efs_matches_single_device():
    """Spatial sharding of the scatter-free fast EAM path: the dense
    [n_vap, nnl] neighbor-COLUMN axis partitions over a 4-device mesh
    (each device owns a slice of every atom's neighbors; XLA psums the
    row-partial accumulators) and must reproduce the single-device
    fast EFS exactly."""
    from collections import Counter
    from tensoralloy_tpu.atoms import Structure
    from tensoralloy_tpu.nn.eam import EamAlloyNN
    from tensoralloy_tpu.nn.eam.fast_efs import make_fast_efs_fn
    from tensoralloy_tpu.parallel.mesh import make_mesh
    from tensoralloy_tpu.parallel.spatial import (
        make_spatial_fast_efs_fn, shard_features_spatial_dense)

    rng = np.random.RandomState(9)
    a0, n_cell = 3.52, 2
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(n_cell)
                           for j in range(n_cell) for k in range(n_cell)])
    s = Structure.from_symbols(
        ["Ni"] * len(frac),
        frac * a0 + rng.normal(scale=0.08, size=(len(frac), 3)),
        np.eye(3) * a0 * n_cell, pbc=[True] * 3)
    fz = Featurizer(["Ni"], rcut=5.0)
    model = EamAlloyNN(fz, Counter({"Ni": len(s)}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    feats_np = fz.featurize(s, fz.make_vap(s, model.max_occurs),
                            layout="dense")
    ref = jax.jit(make_fast_efs_fn(model))(
        params, {k: jnp.asarray(v) for k, v in feats_np.items()})

    mesh = make_mesh(4, axis_name="pairs")
    sharded = shard_features_spatial_dense(feats_np, mesh)
    assert sharded["pair_j_d"].shape[1] % 4 == 0
    assert len(sharded["pair_j_d"].sharding.device_set) == 4
    out = make_spatial_fast_efs_fn(model, mesh)(params, sharded)
    assert float(out["energy"]) == pytest.approx(float(ref["energy"]),
                                                 abs=1e-8)
    np.testing.assert_allclose(np.asarray(out["forces"]),
                               np.asarray(ref["forces"]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out["stress_voigt"]),
                               np.asarray(ref["stress_voigt"]),
                               atol=1e-8)


def test_fit_eval_callback_and_best_checkpoint(trained, tmp_path):
    """fit(eval_callback=...) fires once per eval with the history row;
    wired to BestCheckpointHook it materializes ckpt-best.npz."""
    from tensoralloy_tpu.train import hooks as H
    model, trainer, out, (tf_, tl_, ef_, el_) = trained
    d = str(tmp_path / "best")
    hook = H.BestCheckpointHook(trainer, d, metric="energy/mae/atom")
    calls = []

    def cb(step, state, ev):
        calls.append((step, dict(ev)))
        hook.after_eval(step, state, ev)

    res = trainer.fit(tf_, tl_, ef_, el_, verbose=False, eval_callback=cb)
    # one callback per eval boundary, same rows as history
    assert [s for s, _ in calls] == [h["step"] for h in res["history"]]
    assert os.path.exists(os.path.join(d, "ckpt-best.npz"))
    rec = json.load(open(os.path.join(d, "best.json")))
    best_hist = min(res["history"], key=lambda h: h["energy/mae/atom"])
    assert rec["step"] == best_hist["step"]
    assert rec["value"] == pytest.approx(best_hist["energy/mae/atom"])
