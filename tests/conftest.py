"""Test configuration: run JAX on CPU with 8 virtual devices and f64.

Physics parity tests follow the reference's precision discipline
(fp64, `tensoralloy/precision.py`); multi-device sharding tests use the
virtual CPU mesh.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
# keep the repo importable for subprocess `python -m tensoralloy_tpu.cli`
os.environ["PYTHONPATH"] = os.pathsep.join(
    [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    + [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))])
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tensoralloy_tpu import set_precision  # noqa: E402

set_precision("high")

REFERENCE_DIR = "/root/reference/test_files"


@pytest.fixture(scope="session")
def test_files():
    return REFERENCE_DIR


@pytest.fixture(scope="session")
def ni_structures():
    from tensoralloy_tpu.io.extxyz import read_extxyz
    return read_extxyz(f"{REFERENCE_DIR}/datasets/Ni/Ni.extxyz")


@pytest.fixture(scope="session")
def snap_ni():
    from tensoralloy_tpu.io.extxyz import read_extxyz
    return read_extxyz(f"{REFERENCE_DIR}/snap_Ni_id11.extxyz")[0]


@pytest.fixture()
def pd3o2():
    """The reference's canonical permutation fixture
    (`tensoralloy/test_utils.py:44-66` uses Pd3O2 vs Pd2O2Pd)."""
    from tensoralloy_tpu.atoms import Structure
    rng = np.random.RandomState(611)
    positions = rng.uniform(1.0, 4.0, size=(5, 3))
    cell = np.eye(3) * 8.0
    a = Structure.from_symbols(
        ["Pd", "Pd", "Pd", "O", "O"], positions, cell,
        pbc=[True, True, True])
    perm = [0, 3, 4, 1, 2]   # Pd O O Pd Pd
    b = Structure.from_symbols(
        [a.symbols[i] for i in perm], positions[perm], cell,
        pbc=[True, True, True])
    return a, b, perm
