"""Training orchestration: optax optimizer, EMA, jitted data-parallel
train/eval steps, checkpointing.

Replaces the reference's Estimator machinery
(`tensoralloy/train/training.py`, `nn/opt.py`, `nn/hooks.py`) with a
functional JAX loop: one jitted `train_step` (grads -> optax update ->
EMA), one jitted `eval_step` (MAE/MSE metrics with EMA params), flat
npz checkpoints with keep-N rotation, and a 1-D device mesh for data
parallelism.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..nn import losses as loss_ops
from ..nn.fields import make_efs_fn
from ..parallel.mesh import make_mesh, shard_batch, replicate
from .dataset import batches


@dataclasses.dataclass
class OptParameters:
    """Reference `[opt]` section (`nn/dataclasses.py`, `nn/utils.py`)."""
    method: str = "adam"
    learning_rate: float = 0.01
    decay_function: Optional[str] = None     # exponential | inverse_time | cosine
    decay_rate: float = 0.95
    decay_steps: int = 1000
    staircase: bool = False
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    rho: float = 0.95                         # adadelta
    momentum: float = 0.9                     # rmsprop / sgd
    use_nesterov: bool = True                 # sgd
    clip_norm: float = 0.0


@dataclasses.dataclass
class TrainParameters:
    batch_size: int = 32
    train_steps: int = 10000
    eval_steps: int = 1000
    summary_steps: int = 100
    log_steps: int = 100
    max_checkpoints_to_keep: int = 5
    ema_decay: float = 0.999
    seed: int = 611
    model_dir: str = "train"
    # >1: fuse this many optimizer steps into one lax.scan device
    # program per dispatch (amortizes host dispatch; metrics are
    # reported from the last step of each fused block)
    scan_steps: int = 1
    # keep the WHOLE training set device-resident and gather batches on
    # device by index (single upload instead of a host->device
    # transfer per step).
    # Used when the mesh is a single device; multi-device data-parallel
    # runs shard per-step batches instead.
    device_dataset: bool = True
    # Upper bound (GiB) on the padded feature+label arrays eligible for
    # the device-resident path; larger datasets automatically fall back
    # to host streaming instead of running out of device memory at
    # upload time. The value was sized for a 16 GB device and is kept
    # on an 80 GB one.
    device_dataset_max_gb: float = 6.0
    # Matmul precision for the EVAL step only. Under the 'medium'
    # policy float32 matmuls on a GPU default to TF32 (10-bit
    # mantissa): on an H100 the GRAP train step's loss moves by ~6e-4
    # relative and its gradient by ~4e-2 of its largest entry against
    # exact float32 (chip_smoke.py). Late in training (once the LR
    # decays below the rounding noise) the optimizer co-adapts the
    # weights to such numerics, so a reduced-precision test MAE can
    # read better than exact-f32 evaluation of the SAME parameters
    # (a bf16-trained model read 2.23 vs 4.08 meV/atom, snap_ni_refsf).
    # 'highest' makes training-time evals report deployment-grade
    # (f32) numbers for a negligible cost at eval cadence; set
    # 'default' to reproduce the device's native inference numerics.
    eval_matmul_precision: str = "highest"
    # Precision annealing: run the LAST N optimizer steps with
    # exact-f32 matmuls (one extra compile at the switch). Trains at
    # full TF32 speed, then re-adapts the co-adapted weights to
    # deployment numerics in place — the built-in form of the
    # snap_ni_refsf_readapt experiment. 0 = off. The switch happens at
    # the first fused scan block whose start step crosses
    # train_steps - N.
    final_f32_steps: int = 0
    # How the training/eval step assembles forces and stress from the
    # energy (the reference always autodiffs, `nn/basic.py:276-421`):
    #   'autodiff' — jax.grad w.r.t. positions. The VJP of every
    #       positions[pair_j_d] gather lowers to a scatter-add.
    #   'dense'    — differentiate w.r.t. the dense pair/triple
    #       VECTORS and assemble forces through the featurizer's
    #       host-built transpose tables (gather + row reduction, no
    #       scatter anywhere; `ops/dense.make_dense_efs_fn`). Requires
    #       a dense descriptor backend AND features built with
    #       transpose=True (`Dataset(..., transpose=True)`).
    #   'auto'     — 'dense' whenever both requirements hold,
    #       'autodiff' otherwise. Values agree to f64 1e-10 (pinned);
    #       existing runs are unaffected because datasets do not emit
    #       transpose tables unless asked.
    force_assembly: str = "auto"
    # Gradient accumulation: split each optimizer batch into
    # batch_size/microbatch_size chunks inside the compiled step
    # (lax.scan), averaging the per-chunk gradients before ONE
    # optimizer update. 0 = off (monolithic batch). It keeps the
    # compiled shapes at the chunk size whatever the optimizer batch:
    # for memory, or where a large monolithic batch compiles to a
    # slower program per structure. Not measured on a GPU yet.
    # Semantics: gradients are the MEAN over chunks of per-chunk
    # batch gradients — identical to the monolithic batch whenever the
    # loss is linear in the batch mean (logcosh/mse-type, uniform
    # structure sizes, no sample weights; pinned to 1e-12 in
    # test_training.py). With rmse-type losses (sqrt OF a batch mean)
    # the objective becomes the mean of per-chunk RMSEs, and with
    # sample weights / unequal structure sizes the normalization is
    # per-chunk — both the standard gradient-accumulation convention
    # (each chunk contributes equally, as in per-shard DDP-style
    # accumulation). Requires batch_size % microbatch_size == 0.
    microbatch_size: int = 0

    def __post_init__(self):
        # Fail at construction, not hours later when the first eval
        # trace enters jax.default_matmul_precision.
        valid = {"default", "high", "highest", "bfloat16",
                 "bfloat16_3x", "tensorfloat32", "float32"}
        if (self.eval_matmul_precision or "default") not in valid:
            raise ValueError(
                f"eval_matmul_precision={self.eval_matmul_precision!r}"
                f" is not one of {sorted(valid)}")
        mb = int(self.microbatch_size or 0)
        if mb < 0 or (mb and self.batch_size % mb != 0):
            raise ValueError(
                f"microbatch_size={self.microbatch_size} must be 0 or a "
                f"positive divisor of batch_size={self.batch_size}")
        if self.force_assembly not in ("auto", "autodiff", "dense"):
            raise ValueError(
                f"force_assembly={self.force_assembly!r} is not one of "
                "['auto', 'autodiff', 'dense']")


def _norm_sweep_chunk(model, feats, budget_bytes: int = 2 * 1024 ** 3,
                      cap: int = 512) -> int:
    """Chunk size for the whole-set min/max descriptor sweep.

    The vmapped descriptor compute materializes working arrays far
    larger than the raw padded features (the GRAP moment basis alone is
    [pairs, 364] floats at moment 5), so a fixed 512-structure chunk
    OOMs a 16 GiB chip at binary-alloy padding.  Models may expose
    ``norm_sweep_bytes_per_structure(feats)`` for a working-set
    estimate; otherwise a conservative per-pair default is used.
    """
    per = 0
    est = getattr(model, "norm_sweep_bytes_per_structure", None)
    if est is not None:
        per = int(est(feats))
    if per <= 0:
        per = 64 * sum(int(np.asarray(v[0:1]).nbytes)
                       for v in feats.values())
    return max(1, min(cap, int(budget_bytes // max(per, 1))))


def make_lr_schedule(opt: OptParameters):
    lr = opt.learning_rate
    if opt.decay_function in (None, "", "none", False):
        return optax.constant_schedule(lr)
    if opt.decay_function == "exponential":
        return optax.exponential_decay(
            lr, opt.decay_steps, opt.decay_rate, staircase=opt.staircase)
    if opt.decay_function == "natural_exp":
        # reference tf natural_exp_decay: lr * exp(-rate * t / steps)
        # == exponential decay with per-period factor exp(-rate)
        return optax.exponential_decay(
            lr, opt.decay_steps, float(np.exp(-opt.decay_rate)),
            staircase=opt.staircase)
    if opt.decay_function == "inverse_time":
        return lambda step: lr / (1.0 + opt.decay_rate *
                                  jnp.asarray(step, jnp.float32) /
                                  opt.decay_steps)
    if opt.decay_function == "cosine":
        return optax.cosine_decay_schedule(lr, opt.decay_steps)
    raise ValueError(f"unknown decay_function {opt.decay_function}")


def _reset_opt_counts(tree):
    """Zero every `count` field inside an optax state pytree (optax
    states are NamedTuples; the schedule/bias-correction counters are
    integer leaves named 'count')."""
    if hasattr(tree, "_fields"):
        vals = {f: _reset_opt_counts(getattr(tree, f))
                for f in tree._fields}
        if "count" in tree._fields:
            vals["count"] = jnp.zeros_like(getattr(tree, "count"))
        return type(tree)(**vals)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reset_opt_counts(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _reset_opt_counts(v) for k, v in tree.items()}
    return tree


def make_optimizer(opt: OptParameters) -> optax.GradientTransformation:
    sched = make_lr_schedule(opt)
    method = opt.method.lower()
    if method == "adam":
        tx = optax.adam(sched, b1=opt.beta1, b2=opt.beta2)
    elif method == "adamw":
        tx = optax.adamw(sched, b1=opt.beta1, b2=opt.beta2,
                         weight_decay=opt.weight_decay or 1e-4)
    elif method == "nadam":
        tx = optax.nadam(sched, b1=opt.beta1, b2=opt.beta2)
    elif method == "adadelta":
        tx = optax.adadelta(sched, rho=opt.rho)
    elif method == "rmsprop":
        tx = optax.rmsprop(sched, momentum=opt.momentum)
    elif method in ("sgd", "nesterov"):
        tx = optax.sgd(sched, momentum=opt.momentum,
                       nesterov=(True if method == "nesterov"
                                 else opt.use_nesterov))
    else:
        raise ValueError(f"unknown optimizer {opt.method}")
    if opt.clip_norm and opt.clip_norm > 0:
        tx = optax.chain(optax.clip_by_global_norm(opt.clip_norm), tx)
    return tx


# ----------------------------------------------------------------------
class Trainer:
    """Train a potential model on a featurized dataset."""

    def __init__(self, model, loss_parameters: loss_ops.LossParameters,
                 opt_parameters: OptParameters,
                 train_parameters: TrainParameters,
                 minimize_properties=("energy", "forces", "stress"),
                 n_devices: Optional[int] = None,
                 constraints: Optional[list] = None):
        self.model = model
        self.loss_parameters = loss_parameters
        self.opt_parameters = opt_parameters
        self.train_parameters = train_parameters
        self.minimize = tuple(minimize_properties)
        self.constraints = list(constraints or [])
        self.tx = make_optimizer(opt_parameters)
        self.mesh = make_mesh(n_devices)
        self.efs = make_efs_fn(model.variational_energy)
        # Scatter-free alternative (only meaningful when the energy
        # actually consumes the dense layout — a 'segment'-backend
        # energy never reads the pair vectors this path differentiates,
        # so offering it there would silently produce zero forces).
        backend = getattr(getattr(model, "descriptor", None),
                          "backend", "segment")
        if backend != "segment":
            from ..ops.dense import make_dense_efs_fn
            self._dense_efs = make_dense_efs_fn(model.variational_energy)
        else:
            self._dense_efs = None
        self._train_step = None
        self._train_step_ix = None
        self._eval_step = None

    # ------------------------------------------------------------------
    def _select_efs(self, feats):
        """Resolve TrainParameters.force_assembly against this batch.

        Key presence is static under jit, so the choice is made once
        per trace; 'dense' additionally needs the triple transpose
        tables whenever the features carry dense triples (angular
        models) — `make_dense_efs_fn` re-checks and raises otherwise.
        """
        mode = self.train_parameters.force_assembly
        if mode == "autodiff":
            return self.efs
        have = ("pair_trans_d" in feats and
                ("trip_j_d" not in feats or "trip_trans_j_d" in feats))
        if mode == "dense":
            if self._dense_efs is None:
                raise ValueError(
                    "force_assembly='dense' needs a dense "
                    "descriptor backend (this model's energy reads the "
                    "flat segment layout)")
            if not have:
                raise KeyError(
                    "force_assembly='dense' needs transpose tables — "
                    "build the Dataset/featurize with transpose=True")
            return self._dense_efs
        return self._dense_efs if (self._dense_efs is not None and have) \
            else self.efs

    def batched_predictions(self, params, feats) -> Dict[str, jnp.ndarray]:
        efs = self._select_efs(feats)
        out = jax.vmap(lambda f: efs(params, f))(feats)
        if hasattr(self.model, "energy_ops"):
            # finite-temperature models: forces/stress derive from the
            # free energy, but the energy/eentropy/free_energy heads are
            # separate predictions (XLA CSE dedups the shared trunk)
            ops = jax.vmap(lambda f: self.model.energy_ops(params, f))(
                feats)
            out.update(ops)
        return out

    def total_loss(self, params, feats, labels, step
                   ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
        lp = self.loss_parameters
        preds = self.batched_predictions(params, feats)
        n_atoms = labels["n_atoms"]
        atom_masks = feats["atom_masks"]
        max_steps = self.train_parameters.train_steps
        w_struct = labels.get("weights")  # [B, 3] energy/forces/stress

        if "forces" in self.minimize and lp.adaptive_sample_weight.enabled:
            asw = loss_ops.adaptive_sample_weight(
                labels["forces"], atom_masks, n_atoms,
                lp.adaptive_sample_weight)
            normalized = lp.adaptive_sample_weight.normalized
        else:
            asw, normalized = None, False

        def weights_for(i, base):
            """Combine adaptive and per-structure label weights."""
            w = base
            if w_struct is not None:
                col = w_struct[:, i]
                w = col if w is None else w * col
            return w

        out: Dict[str, jnp.ndarray] = {}
        metrics: Dict[str, jnp.ndarray] = {}

        w_e = weights_for(0, asw)
        loss_e, mae_e = loss_ops.scalar_property_loss(
            labels["energy"], preds["energy"], lp.energy, n_atoms=n_atoms,
            sample_weight=w_e, normalized=normalized or w_e is not None)
        out["energy"] = loss_e * loss_ops.resolve_weight(
            lp.energy.weight, step, max_steps,
            lp.energy.logscaled_dynamic_weight)
        metrics["energy/mae"] = mae_e
        metrics["energy/mae/atom"] = jnp.mean(
            jnp.abs(labels["energy"] - preds["energy"]) / n_atoms)

        if "forces" in self.minimize:
            w_f = weights_for(1, asw)
            loss_f, mae_f = loss_ops.forces_loss(
                labels["forces"], preds["forces"], atom_masks, lp.forces,
                sample_weight=w_f, normalized=True)
            out["forces"] = loss_f * loss_ops.resolve_weight(
                lp.forces.weight, step, max_steps,
                lp.forces.logscaled_dynamic_weight)
            metrics["forces/mae"] = mae_f

        if "stress" in self.minimize:
            w_s = weights_for(2, asw)
            has = labels.get("has_stress")
            lbl = labels["stress"]
            prd = preds["stress_voigt"]
            if has is not None:
                w_s = has if w_s is None else w_s * has
            loss_s, mae_s = loss_ops.stress_loss(
                lbl, prd, lp.stress, sample_weight=w_s,
                normalized=w_s is not None)
            out["stress"] = loss_s * loss_ops.resolve_weight(
                lp.stress.weight, step, max_steps,
                lp.stress.logscaled_dynamic_weight)
            metrics["stress/mae"] = mae_s

        if "total_pressure" in self.minimize:
            # label derived from the Voigt stress (eV/A^3): the
            # reference encodes total_pressure = -mean(virial[:3])/GPa
            # (`transformer/base.py:425-436`, loss `losses.py:459-504`)
            from ..nn.fields import EV_ANGSTROM3_TO_GPA
            lbl_p = labels.get("total_pressure")
            if lbl_p is None:
                lbl_p = -jnp.mean(labels["stress"][:, :3], axis=1) \
                    * EV_ANGSTROM3_TO_GPA
            has = labels.get("has_stress")
            w_p = weights_for(2, None)
            if has is not None:
                w_p = has if w_p is None else w_p * has
            loss_p, mae_p = loss_ops.scalar_property_loss(
                lbl_p, preds["total_pressure"], lp.total_pressure,
                sample_weight=w_p, normalized=w_p is not None)
            out["total_pressure"] = loss_p * loss_ops.resolve_weight(
                lp.total_pressure.weight, step, max_steps,
                lp.total_pressure.logscaled_dynamic_weight)
            metrics["total_pressure/mae"] = mae_p

        for prop, opts in (("eentropy", lp.eentropy),
                           ("free_energy", lp.free_energy)):
            if prop in self.minimize and prop in preds:
                loss_p, mae_p = loss_ops.scalar_property_loss(
                    labels[prop], preds[prop], opts, n_atoms=n_atoms)
                out[prop] = loss_p * loss_ops.resolve_weight(
                    opts.weight, step, max_steps,
                    opts.logscaled_dynamic_weight)
                metrics[f"{prop}/mae"] = mae_p

        if lp.l2.weight > 0:
            l2 = self.model.l2_loss(params)
            w = lp.l2.weight
            if lp.l2.decayed:
                w = w * lp.l2.decay_rate ** (
                    jnp.asarray(step, jnp.float32) / lp.l2.decay_steps)
            out["l2"] = l2 * w

        for constraint in self.constraints:
            out[constraint.name] = constraint.loss(params)

        total = sum(out.values())
        metrics.update({f"loss/{k}": v for k, v in out.items()})
        metrics["loss/total"] = total
        return total, metrics

    # ------------------------------------------------------------------
    def init_state(self, params) -> dict:
        # Fresh buffers for both params and ema: the train step donates
        # its input state, so aliasing the caller's arrays (or each
        # other) would invalidate them on the first step.
        copy = lambda t: jax.tree_util.tree_map(
            lambda x: jnp.array(x, copy=True), t)
        params = copy(params)
        ema = copy(params)
        return {"params": params,
                "opt_state": self.tx.init(params),
                "ema_params": ema,
                "step": jnp.zeros((), jnp.int32)}

    def _make_raw_train_step(self):
        """Unjitted single optimizer step (shared by every fused
        variant)."""
        decay = self.train_parameters.ema_decay
        mb = int(getattr(self.train_parameters, "microbatch_size", 0)
                 or 0)
        bs = int(self.train_parameters.batch_size)

        def loss_and_grads(params, feats, labels, step):
            if not (0 < mb < bs):
                return jax.value_and_grad(
                    self.total_loss, has_aux=True)(
                        params, feats, labels, step)
            # gradient accumulation: scan over [bs/mb, mb, ...] chunks
            # so the position-backward compiles at the small-batch
            # shapes where XLA keeps the row-gather tables materialized
            # (see TrainParameters.microbatch_size)
            n_chunks = bs // mb
            split = lambda t: jax.tree_util.tree_map(
                lambda x: x.reshape((n_chunks, mb) + x.shape[1:]), t)
            fs, ls = split(feats), split(labels)
            first = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
            rest = lambda t: jax.tree_util.tree_map(lambda x: x[1:], t)
            (_, m0), g0 = jax.value_and_grad(
                self.total_loss, has_aux=True)(
                    params, first(fs), first(ls), step)

            def body(carry, chunk):
                g_acc, m_acc = carry
                bf, bl = chunk
                (_, m), g = jax.value_and_grad(
                    self.total_loss, has_aux=True)(params, bf, bl, step)
                add = lambda a, b: jax.tree_util.tree_map(jnp.add, a, b)
                return (add(g_acc, g), add(m_acc, m)), None

            (g, m), _ = jax.lax.scan(body, (g0, m0), (rest(fs), rest(ls)))
            scale = 1.0 / n_chunks
            mean = lambda t: jax.tree_util.tree_map(
                lambda x: x * scale, t)
            metrics = mean(m)
            return (metrics["loss/total"], metrics), mean(g)

        def train_step(state, feats, labels):
            step = state["step"]
            (loss, metrics), grads = loss_and_grads(
                state["params"], feats, labels, step)
            updates, opt_state = self.tx.update(
                grads, state["opt_state"], state["params"])
            params = optax.apply_updates(state["params"], updates)
            # ramped decay min(d, (1+t)/(10+t)) — the tf.train.EMA
            # `num_updates` schedule the reference relies on; a fixed
            # 0.999 leaves ~d^t weight on the random init at short
            # horizons, wrecking EMA-based eval/export
            t = step.astype(jnp.float32)
            d_t = jnp.minimum(decay, (1.0 + t) / (10.0 + t))
            ema = jax.tree_util.tree_map(
                lambda e, p: d_t * e + (1.0 - d_t) * p,
                state["ema_params"], params)
            new_state = {"params": params, "opt_state": opt_state,
                         "ema_params": ema, "step": step + 1}
            return new_state, metrics

        return train_step

    @staticmethod
    def _at_precision(fn, matmul_precision):
        """Wrap fn so it TRACES under the given matmul precision (the
        context applies at lowering time, so the whole fused program
        compiles at that precision)."""
        if not matmul_precision:
            return fn

        def wrapped(*args):
            with jax.default_matmul_precision(matmul_precision):
                return fn(*args)
        return wrapped

    def _build_train_step(self, matmul_precision: str = None):
        train_step = self._make_raw_train_step()
        # Inputs arrive pre-sharded (batch over the data axis, state
        # replicated); jit honors argument shardings and XLA inserts the
        # gradient all-reduce.
        scan_steps = self.train_parameters.scan_steps
        if scan_steps and scan_steps > 1:
            def fused(state, feats_stacked, labels_stacked):
                def body(st, batch):
                    bf, bl = batch
                    return train_step(st, bf, bl)
                state2, metrics_seq = jax.lax.scan(
                    body, state, (feats_stacked, labels_stacked))
                metrics = jax.tree_util.tree_map(lambda x: x[-1],
                                                 metrics_seq)
                return state2, metrics
            return jax.jit(self._at_precision(fused, matmul_precision),
                           donate_argnums=(0,))
        return jax.jit(self._at_precision(train_step, matmul_precision),
                       donate_argnums=(0,))

    def _build_train_step_indexed(self, matmul_precision: str = None):
        """Fused K-step program gathering batches ON DEVICE from the
        resident dataset: (state, all_feats, all_labels, idx [K, B])."""
        base = self._make_raw_train_step()

        def fused(state, all_feats, all_labels, idx):
            def body(st, sel):
                bf = jax.tree_util.tree_map(lambda a: a[sel], all_feats)
                bl = jax.tree_util.tree_map(lambda a: a[sel], all_labels)
                return base(st, bf, bl)
            state2, metrics_seq = jax.lax.scan(body, state, idx)
            metrics = jax.tree_util.tree_map(lambda x: x[-1], metrics_seq)
            return state2, metrics

        return jax.jit(self._at_precision(fused, matmul_precision),
                       donate_argnums=(0,))

    def _build_eval_step(self):
        prec = getattr(self.train_parameters,
                       "eval_matmul_precision", "highest") or "default"

        def eval_step(params, feats, labels):
            # the context applies at trace time, so the whole eval body
            # (forward + autodiff forces/stress) lowers at this
            # precision regardless of the global policy
            with jax.default_matmul_precision(prec):
                return _eval_body(params, feats, labels)

        def _eval_body(params, feats, labels):
            preds = self.batched_predictions(params, feats)
            n_atoms = labels["n_atoms"]
            mask = feats["atom_masks"][:, 1:]
            diff_f = (labels["forces"][:, 1:] - preds["forces"][:, 1:]) \
                * mask[..., None]
            n_f = jnp.maximum(jnp.sum(mask) * 3.0, 1.0)
            de = labels["energy"] - preds["energy"]
            ds = labels["stress"] - preds["stress_voigt"]
            s_norm = jnp.linalg.norm(labels["stress"], axis=1)
            bsz = jnp.asarray(labels["energy"].shape[0], jnp.float32)
            n_sl = jnp.maximum(jnp.sum(s_norm > 1e-8), 1)
            out = {
                "energy/mae": jnp.mean(jnp.abs(de)),
                "energy/mse": jnp.mean(jnp.square(de)),
                "energy/mae/atom": jnp.mean(jnp.abs(de) / n_atoms),
                "energy/mse/atom": jnp.mean(jnp.square(de / n_atoms)),
                "forces/mae": jnp.sum(jnp.abs(diff_f)) / n_f,
                "forces/mse": jnp.sum(jnp.square(diff_f)) / n_f,
                "stress/mae": jnp.mean(jnp.abs(ds)),
                "stress/mse": jnp.mean(jnp.square(ds)),
                # relative stress RMSE (reference `basic.py:829-918`),
                # only over structures that actually carry stress labels
                "stress/rel_rmse": jnp.sum(
                    jnp.where(s_norm > 1e-8,
                              jnp.linalg.norm(ds, axis=1) /
                              jnp.maximum(s_norm, 1e-8), 0.0)) / n_sl,
            }
            # denominator basis per metric, so evaluate() can combine
            # per-batch means exactly (force metrics are per real
            # force ENTRY — weighting them by structure count skews
            # the MAE toward small structures when sizes vary)
            wts = {k: (n_f if k.startswith("forces/") else
                       n_sl.astype(jnp.float32)
                       if k == "stress/rel_rmse" else bsz)
                   for k in out}
            if hasattr(self.model, "energy_ops"):
                dS = labels.get("eentropy")
                if dS is not None and "eentropy" in preds:
                    out["eentropy/mae"] = jnp.mean(
                        jnp.abs(dS - preds["eentropy"]))
                    wts["eentropy/mae"] = bsz
                dF = labels.get("free_energy")
                if dF is not None and "free_energy" in preds:
                    out["free_energy/mae/atom"] = jnp.mean(
                        jnp.abs(dF - preds["free_energy"]) / n_atoms)
                    wts["free_energy/mae/atom"] = bsz
            return out, wts
        return jax.jit(eval_step)

    # ------------------------------------------------------------------
    def fit(self, train_feats, train_labels, test_feats=None,
            test_labels=None, params=None, verbose: bool = True,
            callback: Optional[Callable] = None,
            initial_state: Optional[dict] = None,
            eval_callback: Optional[Callable] = None) -> dict:
        tp = self.train_parameters
        if params is None and initial_state is None:
            # (skipped on resume: initial_state already carries params,
            # and the full-dataset norm sweep would be thrown away)
            params = self.model.init_params(
                jax.random.PRNGKey(tp.seed))
            if getattr(self.model, "minmax_scale", False):
                # running min/max over the WHOLE training set (chunked;
                # reference keeps xlo/xhi as running variables — a
                # file-order prefix biases heterogeneous databases)
                n_all = len(train_labels["energy"])
                chunk = _norm_sweep_chunk(self.model, train_feats)
                print(f"minmax sweep: {n_all} structures in chunks of "
                      f"{chunk}", flush=True)
                for lo in range(0, n_all, chunk):
                    sample = {k: jnp.asarray(v[lo:lo + chunk])
                              for k, v in train_feats.items()}
                    params = self.model.update_norm_stats(params, sample)
                print("minmax sweep done", flush=True)

        bs = tp.batch_size
        if self._train_step is None:
            self._train_step = self._build_train_step()
            self._eval_step = self._build_eval_step()

        start = 0
        if initial_state is not None:
            # exact resume: continue the step counter and fast-forward
            # the (seeded) batch stream so the data order matches an
            # uninterrupted run
            start = min(int(jax.device_get(initial_state["step"])),
                        tp.train_steps)
        state = replicate(initial_state or self.init_state(params),
                          self.mesh)
        n_train = len(train_labels["energy"])
        k = max(int(tp.scan_steps or 1), 1)
        # Device-resident fast path (single-device mesh): upload the
        # whole training set ONCE, stream only [k, bs] index arrays,
        # gather batches on device inside the fused scan. Order is
        # identical to the host path (shared batch_index_stream).
        use_dev = bool(tp.device_dataset) and self.mesh.size == 1
        if use_dev:
            dev_bytes = sum(np.asarray(v).nbytes
                            for d in (train_feats, train_labels)
                            for v in d.values())
            cap = float(tp.device_dataset_max_gb) * 1024 ** 3
            if dev_bytes > cap:
                print(f"device_dataset: padded set is "
                      f"{dev_bytes / 1024**3:.2f} GiB > "
                      f"{tp.device_dataset_max_gb:g} GiB cap "
                      f"(train.device_dataset_max_gb) — streaming batches "
                      f"from host instead")
                use_dev = False
        if use_dev:
            from .dataset import batch_index_stream
            dev_feats = {key: jnp.asarray(v)
                         for key, v in train_feats.items()}
            dev_labels = {key: jnp.asarray(v)
                          for key, v in train_labels.items()}
            idx_it = batch_index_stream(n_train, bs, seed=tp.seed,
                                        repeat=True, skip=start)
            if self._train_step_ix is None:
                self._train_step_ix = self._build_train_step_indexed()
            step_ix = self._train_step_ix
        else:
            it = batches(train_feats, train_labels, bs, seed=tp.seed,
                         repeat=True, skip=start)
        history = []
        t0 = time.time()
        examples = 0
        # precision annealing: past this step the train step runs with
        # exact-f32 matmuls (lazy second compile) so the deployed
        # weights are adapted to deployment numerics, not TF32
        f32_after = (tp.train_steps - int(
            getattr(tp, "final_f32_steps", 0) or 0))
        annealing = f32_after < tp.train_steps
        for step in range(start, tp.train_steps, k):
            n_fused = min(k, tp.train_steps - step)
            if annealing and step >= f32_after:
                attr = ("_train_step_ix_f32" if use_dev
                        else "_train_step_f32")
                if getattr(self, attr, None) is None:
                    if verbose:
                        print(f"precision annealing at step {step}: "
                              "switching matmuls to f32", flush=True)
                    build = (self._build_train_step_indexed if use_dev
                             else self._build_train_step)
                    setattr(self, attr, build("highest"))
                if use_dev:
                    step_ix = getattr(self, attr)
                    step_fn = self._train_step
                else:
                    step_fn = getattr(self, attr)
            else:
                step_fn = self._train_step
            # stack exactly n_fused batches: a final short block must
            # not overshoot train_steps (the fused program
            # re-specializes once for the tail shape)
            if use_dev:
                idx = jnp.asarray(np.stack(
                    [next(idx_it) for _ in range(n_fused)]
                ).astype(np.int32))
                state, metrics = step_ix(state, dev_feats, dev_labels,
                                         idx)
            elif k > 1:
                group = [next(it) for _ in range(n_fused)]
                from jax.sharding import NamedSharding, PartitionSpec
                sh = NamedSharding(self.mesh, PartitionSpec(None, "data"))
                put = lambda v: jax.device_put(v, sh)
                bf = {key: put(np.stack([g[0][key] for g in group]))
                      for key in group[0][0]}
                bl = {key: put(np.stack([g[1][key] for g in group]))
                      for key in group[0][1]}
                state, metrics = step_fn(state, bf, bl)
            else:
                bf, bl = next(it)
                bf = shard_batch(bf, self.mesh)
                bl = shard_batch(bl, self.mesh)
                state, metrics = step_fn(state, bf, bl)
            examples += bs * n_fused
            step_now = step + n_fused - 1
            if verbose and (step_now + 1) % tp.log_steps < n_fused:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                print(f"step {step + 1}: loss={m['loss/total']:.6f} "
                      f"e_mae/atom={m['energy/mae/atom']:.6f} "
                      f"f_mae={m.get('forces/mae', 0.0):.6f} "
                      f"({examples / dt:.1f} structures/s)")
            if callback is not None:
                callback(step_now, state, metrics)
            if test_feats is not None and len(test_labels["energy"]) and \
                    (step_now + 1) % tp.eval_steps < n_fused:
                ev = self.evaluate(state["ema_params"], test_feats,
                                   test_labels)
                history.append({"step": step_now + 1, **ev})
                if eval_callback is not None:
                    eval_callback(step_now + 1, state, ev)
                if verbose:
                    print(f"  eval@{step + 1}: " +
                          " ".join(f"{k}={v:.6f}" for k, v in ev.items()))
        self.state = state
        return {"state": state, "history": history,
                "throughput": examples / (time.time() - t0)}

    def evaluate(self, params, feats, labels, batch_size: int = 0) -> dict:
        n = len(labels["energy"])
        if n == 0:
            return {}
        if self._eval_step is None:     # standalone use (no fit() yet)
            self._eval_step = self._build_eval_step()
        bs = batch_size or min(n, self.train_parameters.batch_size)
        sums, wsums = {}, {}
        for lo in range(0, n, bs):
            sel = slice(lo, min(lo + bs, n))
            bf = {k: jnp.asarray(v[sel]) for k, v in feats.items()}
            bl = {k: jnp.asarray(v[sel]) for k, v in labels.items()}
            out, wts = self._eval_step(params, bf, bl)
            for k, v in out.items():
                # combine per-batch means weighted by each metric's
                # own denominator (structures for energy, real force
                # entries for forces, labeled rows for rel stress) so
                # the result equals the dataset-level metric exactly
                w = float(wts[k])
                sums[k] = sums.get(k, 0.0) + float(v) * w
                wsums[k] = wsums.get(k, 0.0) + w
        return {k: sums[k] / max(wsums[k], 1e-12) for k in sums}

    # ------------------------------------------------------------------
    @staticmethod
    def _flatten_tree(prefix, tree, out):
        for kp, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = prefix + "/" + "/".join(
                str(getattr(p, "key", getattr(p, "idx", p)))
                for p in kp)
            out[key] = np.asarray(leaf)

    @staticmethod
    def _unflatten_tree(prefix, template, flat):
        def visit(kp, leaf):
            key = prefix + "/" + "/".join(
                str(getattr(p, "key", getattr(p, "idx", p)))
                for p in kp)
            return jnp.asarray(flat[key])
        return jax.tree_util.tree_map_with_path(visit, template)

    def save_checkpoint(self, path: str, state: dict, extra: dict = None):
        """Flat-npz checkpoint: params, EMA params, optimizer state,
        global step (reference: Estimator ckpt + EMA shadow vars)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = {}
        self._flatten_tree("params", state["params"], flat)
        self._flatten_tree("ema", state["ema_params"], flat)
        if "opt_state" in state:
            self._flatten_tree("opt", state["opt_state"], flat)
        flat["step"] = np.asarray(state["step"])
        np.savez(path, **flat)
        if extra:
            with open(path + ".json", "w") as fh:
                json.dump(extra, fh)

    def load_checkpoint(self, path: str, params_template: dict
                        ) -> Tuple[dict, dict, int]:
        """-> (params, ema_params, step)."""
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return (self._unflatten_tree("params", params_template, flat),
                self._unflatten_tree("ema", params_template, flat),
                int(flat["step"]))

    def restore_state(self, path: str, params_template: dict,
                      use_ema_variables: bool = False,
                      restore_optimizer_variables: bool = True,
                      reset_global_step: bool = False) -> dict:
        """Full warm-start semantics (reference `nn/hooks.py:29-106` +
        `[train.ckpt]`): pick raw-vs-EMA weights, optionally restore
        the optimizer state, optionally reset the global step."""
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        params = self._unflatten_tree(
            "ema" if use_ema_variables else "params",
            params_template, flat)
        state = self.init_state(params)
        state["ema_params"] = self._unflatten_tree(
            "ema", params_template, flat)
        if restore_optimizer_variables and any(
                k.startswith("opt/") for k in flat):
            try:
                state["opt_state"] = self._unflatten_tree(
                    "opt", state["opt_state"], flat)
            except KeyError:
                pass   # optimizer changed shape/method: keep fresh
        if not reset_global_step:
            state["step"] = jnp.asarray(int(flat["step"]), jnp.int32)
        elif restore_optimizer_variables:
            # the LR schedule is driven by the optax counts inside
            # opt_state, not by state['step'] — resetting the global
            # step must restart the schedule (reference semantics)
            # while keeping the restored moments
            state["opt_state"] = _reset_opt_counts(state["opt_state"])
        return state
