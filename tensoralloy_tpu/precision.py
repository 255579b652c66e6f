"""Global float-precision policy (reference `tensoralloy/precision.py`).

Two named precisions:
  * ``high``   -> float64 (requires ``jax_enable_x64``; CPU parity/physics)
  * ``medium`` -> float32 (the accelerator compute path)

``medium`` is the production setting. On a GPU its float32 matmuls run
as TF32 (10-bit mantissa) unless ``jax.default_matmul_precision`` or a
``precision`` argument says otherwise: the model's own matmuls keep that
default, while the virial contractions over all atoms always run exact
(``nn.fields.HIGHEST``), and evaluation steps default to 'highest'
(``TrainParameters.eval_matmul_precision``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class FloatPolicy:
    name: str
    dtype: jnp.dtype
    eps: float

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)


_POLICIES = {
    "high": FloatPolicy("high", jnp.float64, 1e-14),
    "medium": FloatPolicy("medium", jnp.float32, 1e-8),
}

_current = _POLICIES["medium"]


def set_precision(name: str = "medium") -> FloatPolicy:
    """Set the global float policy. 'high' enables x64 in jax."""
    global _current
    if name not in _POLICIES:
        raise ValueError(f"precision must be one of {list(_POLICIES)}")
    if name == "high":
        jax.config.update("jax_enable_x64", True)
    _current = _POLICIES[name]
    return _current


def get_float_policy() -> FloatPolicy:
    return _current


def get_float_dtype():
    return _current.dtype


def get_float_eps() -> float:
    return _current.eps


@contextlib.contextmanager
def precision_scope(name: str):
    global _current
    prev = _current
    set_precision(name)
    try:
        yield _current
    finally:
        _current = prev
