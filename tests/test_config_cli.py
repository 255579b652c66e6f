"""Config system, TrainingManager wiring, CLI subcommands, analysis."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tensoralloy_tpu.io.input import InputReader
from tensoralloy_tpu.train.manager import PairStyle, TrainingManager


def test_input_reader_defaults(tmp_path):
    toml = tmp_path / "in.toml"
    toml.write_text("""
pair_style = "atomic/sf"
[dataset]
sqlite3 = "data.db"
name = "test"
""")
    r = InputReader(str(toml))
    assert r["precision"] == "medium"
    assert r["rcut"] == 6.0
    assert r["nn.loss.energy.weight"] == 1.0
    assert r["opt.method"] == "adam"
    # relative path resolved against the toml's directory
    assert r["dataset.sqlite3"] == str(tmp_path / "data.db")
    assert "nn.loss.energy.method" in r
    assert r.get("nope.nope", 42) == 42


def test_input_reader_validation(tmp_path):
    toml = tmp_path / "bad.toml"
    toml.write_text("""
pair_style = "bogus/style"
[dataset]
sqlite3 = "d.db"
name = "x"
""")
    with pytest.raises(ValueError, match="pair_style"):
        InputReader(str(toml))
    toml2 = tmp_path / "required.toml"
    toml2.write_text('pair_style = "atomic/sf"\n')
    with pytest.raises(ValueError, match="dataset"):
        InputReader(str(toml2))


def test_pair_style_parse():
    ps = PairStyle.parse("eam/alloy")
    assert ps.category == "eam" and ps.model == "alloy"
    ps = PairStyle.parse("atomic/sf/angular")
    assert ps.angular and ps.model == "sf"
    ps = PairStyle.parse("td/grap")
    assert ps.finite_temperature and ps.model == "grap"
    assert not PairStyle.parse("atomic/grap").angular


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    shutil.copy("/root/reference/test_files/datasets/ethanol/ethanol.db",
                d / "ethanol.db")
    return d


def test_training_manager_wiring_atomic(workdir):
    toml = workdir / "atomic.toml"
    toml.write_text("""
precision = "high"
pair_style = "atomic/grap"
rcut = 5.0
[dataset]
sqlite3 = "ethanol.db"
name = "ethanol"
test_size = 2
tfrecords_dir = "."
[nn]
minimize = ['energy', 'forces']
[nn.atomic.grap]
algorithm = 'pexp'
moment_tensors = [0, 1, 2]
[nn.atomic.grap.pexp]
rl = [1.0, 2.0]
pl = [2.0, 2.0]
[train]
model_dir = "m_atomic"
train_steps = 4
batch_size = 4
eval_steps = 4
""")
    mgr = TrainingManager(str(toml))
    from tensoralloy_tpu.nn.atomic import AtomicNN
    from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential
    assert isinstance(mgr.model, AtomicNN)
    assert isinstance(mgr.model.descriptor, GenericRadialAtomicPotential)
    assert mgr.model.descriptor.n_filters == 2
    assert mgr.featurizer.rcut == 5.0
    assert mgr.trainer.train_parameters.train_steps == 4
    out = mgr.train_and_evaluate(verbose=False)
    assert os.path.exists(os.path.join(mgr.model_dir, "checkpoint.npz"))
    path = mgr.export()
    assert os.path.exists(path)


def test_training_manager_wiring_eam(workdir, tmp_path):
    from tensoralloy_tpu.io.sqlite import read_file
    db = read_file("/root/reference/test_files/datasets/Ni/Ni.extxyz",
                   db_path=str(tmp_path / "Ni.db"))
    toml = tmp_path / "eam.toml"
    toml.write_text("""
precision = "high"
pair_style = "eam/alloy"
rcut = 6.0
[dataset]
sqlite3 = "Ni.db"
name = "ni"
test_size = 1
tfrecords_dir = "."
[nn.eam.rho]
Ni = "zjw04"
[nn.eam.embed]
Ni = "zjw04"
[nn.eam.phi]
NiNi = "zjw04"
[train]
model_dir = "m_eam"
train_steps = 2
batch_size = 2
eval_steps = 2
""")
    mgr = TrainingManager(str(toml))
    from tensoralloy_tpu.nn.eam import EamAlloyNN
    assert isinstance(mgr.model, EamAlloyNN)
    assert mgr.model.potentials["Ni"]["rho"] == "zjw04"
    assert mgr.model.potentials["NiNi"]["phi"] == "zjw04"


def test_eos_fit_roundtrip():
    from tensoralloy_tpu.analysis.eos import (EquationOfState,
                                              birchmurnaghan)
    v = np.linspace(9.0, 13.0, 15)
    e = birchmurnaghan(v, -4.5, 1.1, 4.2, 10.9)
    eos = EquationOfState(v, e, eos="birchmurnaghan")
    v0, e0, b = eos.fit()
    assert v0 == pytest.approx(10.9, abs=1e-6)
    assert e0 == pytest.approx(-4.5, abs=1e-8)
    assert b == pytest.approx(1.1, abs=1e-6)
    # rose form also fits its own data
    from tensoralloy_tpu.analysis.eos import rose
    e2 = rose(v, -4.5, 1.1, 0.005, 10.9)
    eos2 = EquationOfState(v, e2, eos="rose")
    v0, e0, b = eos2.fit()
    assert v0 == pytest.approx(10.9, abs=1e-4)


def test_cif_reader():
    from tensoralloy_tpu.io.cif import read_cif
    s = read_cif("/root/reference/test_files/crystals/Ni.cif")
    assert s.symbols == ["Ni"]
    assert s.volume == pytest.approx(10.904, abs=1e-2)
    # 60-degree rhombohedral primitive fcc cell
    a = np.linalg.norm(s.cell[0])
    assert a == pytest.approx(2.48902, abs=1e-5)


def test_elastic_cubic_zjw04():
    """Elastic constants of conventional fcc Ni with zjw04 must show
    cubic symmetry and be in the physical ballpark."""
    from collections import Counter
    import jax
    from tensoralloy_tpu.atoms import Structure
    from tensoralloy_tpu.transform import Featurizer
    from tensoralloy_tpu.nn.eam import EamAlloyNN
    from tensoralloy_tpu.calculator import TensorAlloyCalculator
    from tensoralloy_tpu.analysis.elastic import (compute_elastic_tensor,
                                                  cubic_constants)
    a0 = 3.52
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                     [0, 0.5, 0.5]]) * a0
    s = Structure.from_symbols(["Ni"] * 4, base, np.eye(3) * a0,
                               pbc=[True] * 3)
    fz = Featurizer(["Ni"], rcut=6.0)
    model = EamAlloyNN(fz, Counter({"Ni": 4}), custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    calc = TensorAlloyCalculator(model, params)
    c = compute_elastic_tensor(calc, s)
    cc = cubic_constants(c)
    # cubic symmetry within numerical tolerance
    assert abs(c[0, 0] - c[1, 1]) < 2.0
    assert abs(c[3, 3] - c[4, 4]) < 2.0
    assert abs(c[0, 3]) < 2.0
    # zjw04 Ni: c11 ~ 247, c12 ~ 148, c44 ~ 125 GPa at its own a0;
    # at a0 = 3.52 values shift but stay in the 100-400 GPa range
    assert 100 < cc["c11"] < 450
    assert 50 < cc["c12"] < 300
    assert 30 < cc["c44"] < 250


def test_cli_build_and_print(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "tensoralloy_tpu.cli", "build",
         "/root/reference/test_files/datasets/Ni/Ni.extxyz",
         "--output", str(tmp_path / "ni.db")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "2 structures" in out.stdout

    hist = tmp_path / "history.json"
    hist.write_text(json.dumps([{"step": 1, "energy/mae": 0.5},
                                {"step": 2, "energy/mae": 0.25}]))
    out = subprocess.run(
        [sys.executable, "-m", "tensoralloy_tpu.cli", "print", str(hist),
         "--output", str(tmp_path / "s.csv")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = (tmp_path / "s.csv").read_text().splitlines()
    assert lines[0] == "step,energy/mae"
    assert len(lines) == 3


def test_cli_print_reference_tf_logfile(tmp_path):
    """`print` parses the reference TF logfile format (reference
    `cli/entry.py:24-131` contract: pid lines reset the experiment,
    Elastic keys shortened + rounded to 0.1)."""
    import subprocess
    out = tmp_path / "summary.csv"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "tensoralloy_tpu.cli", "print",
         "/root/reference/test_files/logfile", "--output", str(out)],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    rows = [ln.split(",") for ln in out.read_text().splitlines()]
    head = rows[0]
    assert "global_step" in head and "Al/fcc/C11" in head
    assert "Al/fcc/kbar" in head          # Constraints key munged
    data = dict(zip(head, rows[1]))
    assert data["global_step"] == "500"
    assert data["Al/fcc/C11"] == "109.6"  # rounded to 0.1 GPa
    assert float(data["loss"]) == 8.926156
    assert len(rows) == 3                 # header + 2 evaluations


def test_vasp2lammps_roundtrip(tmp_path):
    """`vasp2lammps` (reference tools/vasp2lammps): POSCAR -> LAMMPS
    data file; read_poscar round-trips write_poscar (Cartesian) and
    handles Direct coordinates."""
    import subprocess
    from tensoralloy_tpu.tensordb.sampler import (make_phase_structure,
                                                  write_poscar)
    from tensoralloy_tpu.io.vasp import read_poscar
    s = make_phase_structure("Cu", "fcc", 3.6).repeat((2, 1, 1))
    poscar = tmp_path / "POSCAR"
    write_poscar(poscar, s)
    back = read_poscar(str(poscar))
    assert back.symbols == s.symbols
    np.testing.assert_allclose(back.cell, s.cell, atol=1e-10)
    np.testing.assert_allclose(back.positions, s.positions, atol=1e-9)
    # Direct-coordinate form
    frac = s.positions @ np.linalg.inv(s.cell)
    lines = [f"direct test", "1.0"]
    lines += ["  " + " ".join(f"{x:.12f}" for x in row)
              for row in s.cell]
    lines += ["Cu", str(len(s)), "Direct"]
    lines += ["  " + " ".join(f"{x:.12f}" for x in row) for row in frac]
    (tmp_path / "POSCAR2").write_text("\n".join(lines) + "\n")
    back2 = read_poscar(str(tmp_path / "POSCAR2"))
    np.testing.assert_allclose(back2.positions, s.positions, atol=1e-8)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "tensoralloy_tpu.cli", "vasp2lammps",
         str(poscar), "-o", str(tmp_path / "data.lammps")],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    data = (tmp_path / "data.lammps").read_text()
    assert "8 atoms" in data and "1 atom types" in data


def test_cli_evaluate_per_group(tmp_path, monkeypatch):
    """`evaluate` verb: deployment-grade per-source-group MAEs of a run
    dir through the real CLI dispatch — group tags from `source`, both
    splits + overall rows, JSON written, newest-ckpt selection
    (promotion of artifacts/evaluate_groups.py into the package)."""
    from tensoralloy_tpu.atoms import Structure
    from tensoralloy_tpu.io.sqlite import CoreDatabase

    rng = np.random.RandomState(3)
    db = CoreDatabase(str(tmp_path / "g.db"))
    for i in range(8):
        cell = np.eye(3) * 7.5
        pos = rng.uniform(0, 1, (6, 3)) @ cell
        s = Structure.from_symbols(["Ni"] * 6, pos, cell, pbc=[True] * 3)
        s.info["energy"] = float(rng.normal(-30.0, 0.5))
        s.info["forces"] = rng.normal(0, 0.3, (6, 3))
        s.info["source"] = f"Ni.{'Bulk' if i % 2 else 'Shear'}.{i}"
        db.write(s)

    monkeypatch.chdir(tmp_path)
    (tmp_path / "input.toml").write_text("""
precision = "medium"
pair_style = "atomic/sf"
rcut = 4.5
seed = 5
[dataset]
sqlite3 = "g.db"
name = "g"
test_size = 2
tfrecords_dir = "."
[nn]
minimize = ['energy', 'forces']
[train]
model_dir = "model"
train_steps = 4
eval_steps = 2
batch_size = 2
""")
    mgr = TrainingManager("input.toml")
    mgr.train_and_evaluate(verbose=False)

    from tensoralloy_tpu.cli.entry import main as cli_main
    assert cli_main(["evaluate", str(tmp_path)]) == 0
    out = json.loads((tmp_path / "group_maes.json").read_text())
    # newest checkpoint picked
    assert out["step"] == 4 and "ckpt-4" in out["checkpoint"]
    for split, n_rows in (("test", 2), ("train", 6)):
        rows = out["splits"][split]
        assert rows["overall"]["n"] == n_rows
        # both groups present across the union of splits
        assert set(rows) <= {"Ni.Bulk", "Ni.Shear", "overall"}
        group_n = sum(r["n"] for t, r in rows.items() if t != "overall")
        assert group_n == n_rows
        for r in rows.values():
            assert np.isfinite(r["energy_meV_per_atom"])
            assert np.isfinite(r["force_eV_A"])
    # --overall-only skips the breakdown
    from tensoralloy_tpu.train.evaluation import evaluate_run
    lean = evaluate_run(str(tmp_path), per_group=False, output=None,
                        verbose=False)
    assert set(lean["splits"]["test"]) == {"overall"}
