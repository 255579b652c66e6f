"""`chip_smoke.py`, `bench.py` and `__graft_entry__` off the card.

The phase functions of `chip_smoke.py` take a device and sizes; here
they run on the CPU device at small sizes (device and reference are the
same CPU, so every parity check must hold). The scripts themselves must
refuse to run without a GPU, and print no result.
"""
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tensoralloy_tpu.precision import precision_scope  # noqa: E402


def _cpu():
    return jax.devices("cpu")[0]


def _script(args, cwd=REPO, pythonpath=True):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    if not pythonpath:
        env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


def test_chip_smoke_without_gpu_exits_nonzero():
    r = _script([os.path.join(REPO, "chip_smoke.py")])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _script(["chip_smoke.py"], cwd=str(tmp_path), pythonpath=False)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_without_gpu_exits_nonzero():
    r = _script([os.path.join(REPO, "bench.py")])
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs a GPU" in r.stderr


@pytest.mark.parametrize("multi", [False, True])
def test_multi_flag_selects_phases(monkeypatch, multi, capsys):
    """--multi runs the four-device phase and nothing else; the default
    runs phases 0-4 and not the four-device one. The last line is the
    result object with the device count JAX reports."""
    called = []
    devs = jax.devices()
    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda platform, count: called.append(
                            ("device", count)) or devs)
    for name in ("reference", "serve", "md"):
        monkeypatch.setattr(chip_smoke, f"phase_{name}",
                            lambda *a, _n=name, **k: called.append(_n))
    monkeypatch.setattr(chip_smoke, "phase_train",
                        lambda *a, **k: called.append("train")
                        or {"model": "m.npz"})
    monkeypatch.setattr(chip_smoke, "phase_multi",
                        lambda d, *a, **k: called.append(("multi", len(d))))
    assert chip_smoke.main(["--multi"] if multi else []) == 0
    if multi:
        assert called == [("device", 4), ("multi", 4)]
    else:
        assert called == [("device", 1), "reference", "train", "serve",
                          "md"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith('{"ok": true, "device": {"platform": "cpu"')


def test_phase_device_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.phase_device("gpu")


def test_phase_reference_on_cpu():
    out = chip_smoke.phase_reference(_cpu(), _cpu(), n_axis=3)
    assert abs(out["ecoh_ev"] - chip_smoke.ECOH_NI) < chip_smoke.ECOH_TOL


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    with precision_scope("high"):     # the TOML sets "medium"
        return chip_smoke.phase_train(
            _cpu(), _cpu(), str(tmp_path_factory.mktemp("train")),
            n_structures=8, n_axis=2, batch_size=4, steps=24,
            hidden=(16, 16), n_timed=2)


def test_phase_train_on_cpu(trained):
    assert trained["loss_last"] < trained["loss_first"]
    assert trained["grad_rel_err"] == 0.0     # same device both sides
    assert os.path.exists(trained["model"])
    assert trained["descriptor_fwd_ms"] > 0


def test_phase_serve_on_cpu(trained):
    out = chip_smoke.phase_serve(_cpu(), _cpu(), trained["model"],
                                 n_big=4, n_parity=2)
    for name in ("eam", "grap"):
        assert out[f"{name}_parity"]["energy_rel"] == 0.0
        assert out[f"{name}_oneshot_warm_s"] > 0


def test_phase_md_on_cpu():
    out = chip_smoke.phase_md(_cpu(), _cpu(), n_axis=3, n_chunks=3,
                              chunk=8)
    assert out["drift_ev_per_atom"] < chip_smoke.DRIFT_TOL
    assert out["md_steps_per_s"] > 0


def test_phase_multi_on_four_virtual_devices(tmp_path):
    devs = jax.devices()[:4]
    assert len(devs) == 4
    out = chip_smoke.phase_multi(devs, str(tmp_path), batch_per_device=1,
                                 n_axis=2, n_big=4, hidden=(8,))
    assert out["dp_loss_rel"] < chip_smoke.E_REL_TOL
    assert out["spatial"]["energy_rel"] < chip_smoke.E_REL_TOL


def test_dryrun_multichip_uses_the_devices_it_has(monkeypatch):
    """No re-exec and no platform switch: the dryrun runs in this
    process on the (virtual CPU) devices JAX already has."""
    import __graft_entry__ as g
    real_run = subprocess.run

    def no_python(cmd, *a, **k):
        # the native neighbor library may be compiled on first use;
        # a second Python interpreter may not be started
        assert sys.executable not in list(cmd), \
            "dryrun_multichip re-launched Python"
        return real_run(cmd, *a, **k)
    monkeypatch.setattr(subprocess, "run", no_python)
    g.dryrun_multichip(4)


def test_dryrun_multichip_needs_enough_devices():
    import __graft_entry__ as g
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        g.dryrun_multichip(64)


@pytest.mark.gpu
def test_chip_smoke_on_gpu(tmp_path):
    """The whole one-card path; skips without a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("no GPU: chip_smoke.py runs this path on the card")
    assert chip_smoke.main(["--workdir", str(tmp_path)]) == 0


def test_nl_regrow_check_on_cpu():
    """The serve phase's self-healing check, on a device-NL calculator
    small enough for the CPU."""
    from tensoralloy_tpu.calculator import TensorAlloyCalculator
    s = chip_smoke.fcc_ni(4, rattle=0.05, seed=3)
    model, params = chip_smoke.zjw04_ni(len(s))
    calc = TensorAlloyCalculator(model, params, device_nl=True)
    chip_smoke._check_nl_regrow("eam", calc, s)
