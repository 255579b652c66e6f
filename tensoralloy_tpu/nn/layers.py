"""Dense-stack building block (the reference's `convolution1x1`,
`tensoralloy/nn/convolutional.py:154-300`, re-expressed functionally).

A "1x1 convolution over atoms" is just a dense layer applied to the
feature axis — a plain [atoms, features] @ [features, out] matmul, so
no conv machinery is needed.

Params are plain pytrees: {"layers": [{"w": ..., "b": ...}, ...]}.
Supports the reference's resnet-dt residual (when consecutive widths
match, x_{l+1} = f(W x + b) * dt + x_l with trainable dt) and a fixed or
trainable output bias used for per-element static energies.
"""
from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..precision import get_float_dtype


def softplus(x):
    return jax.nn.softplus(x)


def squareplus(x, b: float = 4.0):
    """x/2 + sqrt(x^2 + b)/2 (reference `nn/utils.py:39-74`)."""
    return 0.5 * (x + jnp.sqrt(jnp.square(x) + b))


ACTIVATIONS = {
    "softplus": softplus,
    "squareplus": squareplus,
    "tanh": jnp.tanh,
    "relu": jax.nn.relu,
    "leaky_relu": jax.nn.leaky_relu,
    "elu": jax.nn.elu,
    "gelu": jax.nn.gelu,
    "sigmoid": jax.nn.sigmoid,
    "softsign": jax.nn.soft_sign,
}


def get_activation(name: str):
    return ACTIVATIONS[name]


# ----------------------------------------------------------------------
# Kernel initializer registry (reference `nn/init_ops.py:20-130`).
# Variance-scaling *normal* variants draw from a TRUNCATED normal at
# +-2 sigma with the TF VarianceScaling std correction, *uniform*
# variants from U(-limit, limit) with limit = sqrt(3 * scale / fan).
_TRUNC_STD_CORRECTION = 0.8796256610342398  # std of N(0,1)|[-2,2]

KERNEL_INITIALIZERS = (
    "he_normal", "he_uniform", "lecun_normal", "lecun_uniform",
    "glorot_normal", "glorot_uniform", "xavier_normal",
    "xavier_uniform", "truncated_normal", "random_normal",
    "random_uniform", "zeros", "constant")


def sample_kernel(key, name: str, fan_in: int, fan_out: int, dtype,
                  value: float = 0.0, stddev: float = 0.05,
                  limit: float = 0.05):
    """Draw a [fan_in, fan_out] kernel from the named initializer."""
    name = (name or "he_normal").lower()
    shape = (fan_in, fan_out)
    scaled = {"he_normal": 2.0 / fan_in, "he_uniform": 2.0 / fan_in,
              "lecun_normal": 1.0 / fan_in,
              "lecun_uniform": 1.0 / fan_in,
              "glorot_normal": 2.0 / (fan_in + fan_out),
              "glorot_uniform": 2.0 / (fan_in + fan_out),
              "xavier_normal": 2.0 / (fan_in + fan_out),
              "xavier_uniform": 2.0 / (fan_in + fan_out)}
    if name in scaled:
        if name.endswith("_uniform"):
            lim = np.sqrt(3.0 * scaled[name])
            w = jax.random.uniform(key, shape, minval=-lim, maxval=lim)
        else:
            std = np.sqrt(scaled[name]) / _TRUNC_STD_CORRECTION
            w = jax.random.truncated_normal(key, -2.0, 2.0, shape) * std
    elif name == "truncated_normal":
        w = jax.random.truncated_normal(key, -2.0, 2.0, shape) * \
            (stddev / _TRUNC_STD_CORRECTION)
    elif name == "random_normal":
        w = jax.random.normal(key, shape) * stddev
    elif name == "random_uniform":
        w = jax.random.uniform(key, shape, minval=-limit, maxval=limit)
    elif name == "zeros":
        w = jnp.zeros(shape)
    elif name == "constant":
        w = jnp.full(shape, value)
    else:
        raise ValueError(f"unknown kernel initializer {name!r} "
                         f"(allowed: {KERNEL_INITIALIZERS})")
    return w.astype(dtype)


def init_dense_stack(key, in_dim: int, hidden_sizes: Sequence[int],
                     out_dim: int = 1,
                     output_bias: bool = True,
                     output_bias_mean: float = 0.0,
                     resnet_dt: bool = False,
                     kernel_init: str = "he_normal",
                     dtype=None) -> dict:
    """Initialize an MLP param pytree: hidden layers + linear output."""
    dtype = dtype or get_float_dtype()
    sizes = [in_dim] + list(hidden_sizes) + [out_dim]
    layers = []
    for li in range(len(sizes) - 1):
        key, sub = jax.random.split(key)
        fan_in, fan_out = sizes[li], sizes[li + 1]
        layer = {"w": sample_kernel(sub, kernel_init, fan_in, fan_out,
                                    dtype)}
        is_output = li == len(sizes) - 2
        if not is_output:
            layer["b"] = jnp.zeros((fan_out,), dtype)
            if resnet_dt and fan_in == fan_out:
                layer["dt"] = jnp.full((fan_out,), 0.1, dtype)
        elif output_bias:
            layer["b"] = jnp.full((fan_out,), output_bias_mean, dtype)
        layers.append(layer)
    return {"layers": layers}


def apply_dense_stack(params: dict, x: jnp.ndarray,
                      activation: str = "softplus") -> jnp.ndarray:
    """Apply the MLP along the last axis of ``x``."""
    act = get_activation(activation)
    layers: List[dict] = params["layers"]
    for li, layer in enumerate(layers):
        h = x @ layer["w"]
        if "b" in layer:
            h = h + layer["b"]
        if li < len(layers) - 1:
            h = act(h)
            if "dt" in layer:
                h = h * layer["dt"] + x
        x = h
    return x


def l2_of_stack(params: dict) -> jnp.ndarray:
    """Sum of squared kernel weights (for L2 regularization)."""
    return sum(jnp.sum(jnp.square(layer["w"])) for layer in params["layers"])


def minmax_normalize_init(feature_dim: int, dtype=None) -> dict:
    """Running min-max input scaling state (reference
    `nn/atomic/atomic.py:157-195` keeps xlo/xhi as non-trainable vars)."""
    dtype = dtype or get_float_dtype()
    return {"xlo": jnp.zeros((feature_dim,), dtype),
            "xhi": jnp.ones((feature_dim,), dtype)}


def minmax_normalize_apply(state: dict, x: jnp.ndarray) -> jnp.ndarray:
    """Scale by the (non-trainable) running min/max stats."""
    state = jax.lax.stop_gradient(state)
    span = jnp.maximum(state["xhi"] - state["xlo"], 1e-12)
    return (x - state["xlo"]) / span


def freeze_output_bias(stack: dict) -> dict:
    """Stop-gradient the LAST layer's bias of a dense stack — used by
    `fixed_atomic_static_energy` so the per-element static-energy bias
    stays pinned at its database value during training."""
    layers = list(stack["layers"])
    last = dict(layers[-1])
    if "b" in last:
        last["b"] = jax.lax.stop_gradient(last["b"])
    layers[-1] = last
    return {**stack, "layers": layers}
