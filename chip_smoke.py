#!/usr/bin/env python3
"""Smoke test of the main path on one NVIDIA GPU: train -> export ->
serve -> MD, each phase checked against the same computation on the
host CPU in the same process.

    python chip_smoke.py            # one GPU: phases 0-4
    python chip_smoke.py --multi    # four GPUs: the multi-device paths

Phases (each is a function of a device and sizes, so the CPU tests call
them at small sizes):

0. device    -- JAX must see GPUs; prints the card's name and power
                limit, the JAX version, the compile-cache directory and
                whether the native host neighbor library loaded.
1. reference -- zjw04 EAM Ni cohesive energy at a0 = 3.52 A, and the
                analytic fast EFS against autodiff EFS at 4,000 atoms.
2. train     -- 64 rattled 108-atom fcc Ni cells labelled with zjw04
                through `TensorAlloyCalculator`, written as extxyz, then
                `cli build` and `cli run` on a GRAP pexp-16 / moments
                0-3 / [128, 128] model; loss must fall; one train step's
                loss and gradient against the CPU; step and descriptor
                times.
3. serve     -- the exported GRAP model and zjw04 EAM through
                `TensorAlloyCalculator`: one-shot E+F+S of the 131,072-
                atom cell (cold and warm), physics checks there, and
                E/F/S parity against the CPU at 4,000 atoms.
4. md        -- `VelocityVerlet(device_nl=True)`, 4,000-atom zjw04 Ni
                NVE at 600 K; first chunk against the CPU host-NL path;
                energy drift bound; steps per second.

`--multi` runs only the four-device paths (data-parallel train step,
pair-axis spatial fast EFS, replica-sharded NEB, member-sharded
ensemble), each against the single-device result of the same input.

Parity runs the device side under
`jax.default_matmul_precision("highest")` (float32 matmuls on the GPU
otherwise run as TF32); the distance of the default precision from
"highest" is printed separately. Any failed check exits non-zero. On
success the last line of standard output is one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances for float32 on two backends whose reductions sum in
# different orders (and, on the GPU, scatter-adds whose order changes
# from run to run):
E_REL_TOL = 1e-5      # energy, relative: ~100 eps32 of a sum over atoms
F_ABS_TOL = 1e-4      # forces, eV/A: per-atom sums of O(1) eV/A terms
S_ABS_TOL_GPA = 1e-3  # stress, GPa: virial sum / volume at 4k atoms
S_REL_TOL = 2e-4      # stress, relative to its largest entry: the virial
                      # is a sum over every pair slot (3.2e5 at 4k
                      # atoms); two summation orders differ by
                      # ~sqrt(N) eps32 = 7e-5, and this is 3 times that
G_REL_TOL = 1e-4      # parameter gradient, relative to its largest entry
MD_POS_TOL = 1e-3     # A after one 32-step chunk: rounding grows along
                      # the trajectory, positions are O(35 A)
ECOH_NI = -4.45       # published zjw04 Ni cohesive energy, eV/atom
ECOH_TOL = 1e-3
DRIFT_TOL = 1e-4      # eV/atom over the MD phase: 4,000-atom Ni at 1 fs
                      # stays within ~1e-5 in float32; wrong forces or
                      # a truncated neighbor list drift far above this
EPS32 = float(np.finfo(np.float32).eps)
GPA = 160.21766208    # eV/A^3 -> GPa

GRAP_PEXP = {"rl": [1.0, 1.2, 1.4, 1.6, 1.8, 2.0, 2.2, 2.4, 2.6, 2.8,
                    3.0, 3.2, 3.4, 3.6, 3.8, 4.0],
             "pl": [5.0, 4.75, 4.5, 4.25, 4.0, 3.75, 3.5, 3.25, 3.0,
                    2.75, 2.5, 2.25, 2.0, 1.75, 1.5, 1.25]}


class SmokeFailure(RuntimeError):
    """A check of the smoke test failed."""


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def report(name: str, value) -> None:
    print(f"  {name} = {value}", flush=True)


@contextlib.contextmanager
def on(device, precision=None):
    """Run JAX work on `device`, optionally at a matmul precision."""
    import jax
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax.default_device(device))
        if precision:
            stack.enter_context(jax.default_matmul_precision(precision))
        yield


def timed(fn):
    """-> (result, seconds) of fn(); fn must end in a host transfer or
    `block_until_ready`."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def fcc_ni(n_axis: int, a0: float = 3.52, rattle: float = 0.0,
           seed: int = 0):
    from tensoralloy_tpu.atoms import Structure
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(n_axis)
                           for j in range(n_axis) for k in range(n_axis)])
    pos = frac * a0
    if rattle:
        pos = pos + np.random.RandomState(seed).normal(
            scale=rattle, size=pos.shape)
    return Structure.from_symbols(["Ni"] * len(frac), pos,
                                  np.eye(3) * a0 * n_axis, pbc=[True] * 3)


def zjw04_ni(n_atoms: int, rcut: float = 6.0):
    import jax
    from tensoralloy_tpu.nn.eam import EamAlloyNN
    from tensoralloy_tpu.transform import Featurizer
    model = EamAlloyNN(Featurizer(["Ni"], rcut=rcut),
                       Counter({"Ni": n_atoms}), custom_potentials="zjw04")
    return model, model.init_params(jax.random.PRNGKey(0))


def efs_errors(a: dict, b: dict) -> dict:
    """Energy (relative), force (eV/A) and stress (GPa) distances."""
    return {
        "energy_rel": abs(a["energy"] - b["energy"]) /
        max(abs(b["energy"]), 1e-12),
        "forces_abs": float(np.max(np.abs(np.asarray(a["forces"]) -
                                          np.asarray(b["forces"])))),
        "stress_gpa": float(np.max(np.abs(np.asarray(a["stress"]) -
                                          np.asarray(b["stress"])))) * GPA,
    }


def check_efs(label: str, got: dict, ref: dict,
              noise: dict | None = None) -> dict:
    """E/F/S parity. Stress may also differ by S_REL_TOL of its largest
    entry. Each tolerance is at least ten times `noise`, the change the
    reference itself shows when every float32 position moves by about
    one ulp: with positions of O(cell size), rij = r_j - r_i loses
    those bits on any backend."""
    err = efs_errors(got, ref)
    noise = noise or {"energy_rel": 0.0, "forces_abs": 0.0,
                      "stress_gpa": 0.0}
    s_max = GPA * float(np.max(np.abs(np.asarray(ref["stress"]))))
    e_tol = max(E_REL_TOL, 10 * noise["energy_rel"])
    f_tol = max(F_ABS_TOL, 10 * noise["forces_abs"])
    s_tol = max(S_ABS_TOL_GPA, S_REL_TOL * s_max,
                10 * noise["stress_gpa"])
    check(err["energy_rel"] < e_tol,
          f"{label} energy rel err {err['energy_rel']:.3e} < {e_tol:.3e}")
    check(err["forces_abs"] < f_tol,
          f"{label} forces abs err {err['forces_abs']:.3e} eV/A "
          f"< {f_tol:.3e}")
    check(err["stress_gpa"] < s_tol,
          f"{label} stress abs err {err['stress_gpa']:.3e} GPa "
          f"< {s_tol:.3e} (max |S| {s_max:.3g} GPa)")
    return err


def _host(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# ----------------------------------------------------------------------
def phase_device(platform: str = "gpu", count: int = 1):
    """Phase 0: the devices JAX sees, the card, the cache, the native
    host library. Raises SmokeFailure when JAX has no `platform`."""
    import jax
    from tensoralloy_tpu.cache import enable_compilation_cache
    from tensoralloy_tpu import native

    print("phase 0: device", flush=True)
    devices = jax.devices()
    if devices[0].platform != platform:
        raise SmokeFailure(
            f"JAX found no {platform.upper()}: default devices are "
            f"{[str(d) for d in devices]}")
    if len(devices) < count:
        raise SmokeFailure(f"need {count} {platform} devices, JAX has "
                           f"{len(devices)}")
    if platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        for line in smi.stdout.strip().splitlines():
            print(line.strip(), flush=True)
    enable_compilation_cache()
    report("jax", jax.__version__)
    report("devices", f"{len(devices)} x {devices[0].device_kind}")
    report("compile_cache_dir", jax.config.jax_compilation_cache_dir)
    report("native_neighbor_library",
           "loaded" if native.get_lib() is not None
           else "NOT loaded (numpy fallback on the host)")
    return devices


def phase_reference(dev, ref, n_axis: int = 10) -> dict:
    """Phase 1: zjw04 Ni E_coh, and fast EFS == autodiff EFS on `dev`."""
    import jax
    import jax.numpy as jnp
    from tensoralloy_tpu.calculator import TensorAlloyCalculator
    from tensoralloy_tpu.nn.eam.fast_efs import make_fast_efs_fn
    from tensoralloy_tpu.nn.fields import make_efs_fn

    print("phase 1: reference", flush=True)
    out = {}
    s0 = fcc_ni(3)
    model, params = zjw04_ni(len(s0))
    with on(dev, "highest"):
        e = TensorAlloyCalculator(model, params).get_potential_energy(s0)
    out["ecoh_ev"] = e / len(s0)
    check(abs(out["ecoh_ev"] - ECOH_NI) < ECOH_TOL,
          f"zjw04 Ni E_coh {out['ecoh_ev']:.6f} eV/atom == {ECOH_NI} "
          f"+- {ECOH_TOL}")

    s = fcc_ni(n_axis, rattle=0.05, seed=1)
    model, params = zjw04_ni(len(s))
    fz = model.featurizer
    vap = fz.make_vap(s)
    dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    dense = fz.featurize(s, vap, layout="dense", dtype=dtype)
    flat = fz.featurize(s, vap, dtype=dtype)
    with on(dev, "highest"):
        fast = jax.jit(make_fast_efs_fn(model))(
            params, {k: jnp.asarray(v) for k, v in dense.items()})
        auto = jax.jit(make_efs_fn(model.energy))(
            params, {k: jnp.asarray(v) for k, v in flat.items()})
    pick = lambda o: {"energy": float(o["energy"]),
                      "forces": np.asarray(o["forces"]),
                      "stress": np.asarray(o["stress_voigt"])}
    out["fast_vs_autodiff"] = check_efs(
        f"fast EFS vs autodiff EFS ({len(s)} atoms, {dev.platform})",
        pick(fast), pick(auto))
    return out


def make_training_set(dev, n_structures: int, n_axis: int, seed: int):
    """Rattled, strained fcc Ni cells labelled by zjw04 through the
    calculator on `dev`."""
    from tensoralloy_tpu.calculator import TensorAlloyCalculator
    rng = np.random.RandomState(seed)
    model, params = zjw04_ni(4 * n_axis ** 3)
    calc = TensorAlloyCalculator(model, params)
    out = []
    with on(dev, "highest"):
        for i in range(n_structures):
            s = fcc_ni(n_axis, a0=3.52 * rng.uniform(0.98, 1.02),
                       rattle=0.08, seed=seed * 100003 + i)
            res = calc.calculate(s)
            s.info["energy"] = float(res["energy"])
            s.info["forces"] = np.asarray(res["forces"])
            s.info["stress"] = np.asarray(res["stress"])
            out.append(s)
    return out


def _write_input(path, workdir, batch_size, steps, hidden, lr):
    rl = ", ".join(str(x) for x in GRAP_PEXP["rl"])
    pl = ", ".join(str(x) for x in GRAP_PEXP["pl"])
    with open(path, "w") as fh:
        fh.write(f"""\
precision = "medium"
pair_style = "atomic/grap"
rcut = 6.0
seed = 611

[dataset]
sqlite3 = "{workdir}/ni.db"
name = "ni_grap"
test_size = 0.2
tfrecords_dir = "{workdir}"

[nn]
minimize = ["energy", "forces", "stress"]
export = ["energy", "forces", "stress"]

[nn.loss.energy]
weight = 1.0
per_atom_loss = true

[nn.loss.forces]
weight = 1.0

[nn.loss.stress]
weight = 0.1

[nn.atomic]
minmax_scale = false
activation = "softplus"

[nn.atomic.layers]
Ni = {list(hidden)}

[nn.atomic.grap]
algorithm = "pexp"
moment_tensors = [0, 1, 2, 3]
backend = "dense"

[nn.atomic.grap.pexp]
rl = [{rl}]
pl = [{pl}]

[opt]
method = "adam"
learning_rate = {lr}
decay_function = false

[train]
batch_size = {batch_size}
train_steps = {steps}
eval_steps = {steps}
summary_steps = 1
log_steps = {steps}
scan_steps = 1
model_dir = "{workdir}/model"
""")


def phase_train(dev, ref, workdir: str, n_structures: int = 64,
                n_axis: int = 3, batch_size: int = 32, steps: int = 40,
                hidden=(128, 128), lr: float = 0.005, seed: int = 0,
                n_timed: int = 50) -> dict:
    """Phase 2: label, build, train and export through the CLI; check
    the loss falls; one train step's loss + gradient on `dev` vs `ref`;
    train-step and descriptor-forward times on `dev`."""
    import jax
    import jax.numpy as jnp
    from tensoralloy_tpu.cli.entry import main as cli
    from tensoralloy_tpu.io.extxyz import write_extxyz
    from tensoralloy_tpu.io.model import load_model
    from tensoralloy_tpu.train.manager import TrainingManager

    print("phase 2: train", flush=True)
    out = {}
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    structures = make_training_set(dev, n_structures, n_axis, seed)
    xyz = os.path.join(workdir, "ni.extxyz")
    write_extxyz(xyz, structures)
    toml = os.path.join(workdir, "input.toml")
    _write_input(toml, workdir, batch_size, steps, hidden, lr)
    with on(dev):
        check(cli(["build", xyz, "--output",
                   os.path.join(workdir, "ni.db")]) == 0, "cli build")
        (rc, t_run) = timed(lambda: cli(["run", toml, "--quiet"]))
    check(rc == 0, "cli run (train + export)")
    out["cli_run_s"] = t_run
    report("cli_run_wall_s", f"{t_run:.3f}")
    rows = [json.loads(ln) for ln in open(
        os.path.join(workdir, "model", "metrics.jsonl"))]
    losses = np.array([r["loss/total"] for r in rows])
    k = max(1, len(losses) // 4)    # batches differ: compare quarters
    out["loss_first"] = float(losses[:k].mean())
    out["loss_last"] = float(losses[-k:].mean())
    check(bool(np.all(np.isfinite(losses))),
          f"loss finite over {len(losses)} steps")
    check(out["loss_last"] < out["loss_first"],
          f"loss falls: mean of first {k} steps {out['loss_first']:.6g}"
          f" -> last {k} {out['loss_last']:.6g}")
    npz = os.path.join(workdir, "model", "ni_grap.npz")
    check(os.path.exists(npz), "exported model")
    out["model"] = npz

    # one train step: loss and parameter gradient, device vs host
    manager = TrainingManager(toml)
    trainer = manager.trainer
    feats, labels = manager.dataset.build()
    bf = {k: v[:batch_size] for k, v in feats.items()}
    bl = {k: v[:batch_size] for k, v in labels.items()}
    _, params, _ = load_model(npz)
    grad_fn = jax.jit(jax.value_and_grad(trainer.total_loss, has_aux=True))

    def loss_grad(device, precision):
        with on(device, precision):
            put = lambda t: jax.device_put(t, device)
            (loss, _), g = grad_fn(put(params), put(bf), put(bl),
                                   jnp.asarray(0))
            return float(loss), _host(g)

    l_dev, g_dev = loss_grad(dev, "highest")
    l_ref, g_ref = loss_grad(ref, None)
    l_tf, g_tf = loss_grad(dev, None)
    flat = lambda g: np.concatenate(
        [np.ravel(x) for x in jax.tree_util.tree_leaves(g)])
    gd, gr, gt = flat(g_dev), flat(g_ref), flat(g_tf)
    scale = max(float(np.max(np.abs(gr))), 1e-30)
    out["loss_rel_err"] = abs(l_dev - l_ref) / abs(l_ref)
    out["grad_rel_err"] = float(np.max(np.abs(gd - gr))) / scale
    check(out["loss_rel_err"] < E_REL_TOL,
          f"train-step loss rel err {out['loss_rel_err']:.3e} "
          f"< {E_REL_TOL}")
    check(out["grad_rel_err"] < G_REL_TOL,
          f"train-step gradient rel err {out['grad_rel_err']:.3e} "
          f"< {G_REL_TOL}")
    out["tf32_loss_rel"] = abs(l_tf - l_dev) / abs(l_dev)
    out["tf32_grad_rel"] = float(np.max(np.abs(gt - gd))) / scale
    report("default_precision_vs_highest_train",
           f"loss rel {out['tf32_loss_rel']:.3e}, gradient rel "
           f"{out['tf32_grad_rel']:.3e}")

    # step time at the production (default) precision
    with on(dev):
        step = trainer._build_train_step()
        state = trainer.init_state(jax.device_put(params, dev))
        bfd, bld = jax.device_put((bf, bl), dev)
        for _ in range(2):
            state, m = step(state, bfd, bld)
        jax.block_until_ready(m)

        def run_steps():
            nonlocal state
            for _ in range(n_timed):
                state, mm = step(state, bfd, bld)
            return jax.block_until_ready(mm)
        _, t = timed(run_steps)
        out["train_ms_per_step"] = t / n_timed * 1e3

        desc, fz = manager.model.descriptor, manager.featurizer
        args = (fz.rcut, fz.acut, fz.n_radial_slots, fz.n_angular_slots,
                fz.angular)
        fwd = jax.jit(jax.vmap(lambda f: desc.compute(f, *args)))
        dfeats = {k: v for k, v in bfd.items()}
        jax.block_until_ready(fwd(dfeats))
        _, t = timed(lambda: jax.block_until_ready(
            [fwd(dfeats) for _ in range(n_timed)]))
        out["descriptor_fwd_ms"] = t / n_timed * 1e3
    out["descriptor_share"] = (out["descriptor_fwd_ms"] /
                               out["train_ms_per_step"])
    report(f"train_ms_per_step_bs{batch_size}",
           f"{out['train_ms_per_step']:.4f}")
    report(f"descriptor_fwd_ms_bs{batch_size}",
           f"{out['descriptor_fwd_ms']:.4f}")
    report("descriptor_fwd_share_of_step", f"{out['descriptor_share']:.4f}")
    return out


def ulp_jitter(s, seed: int = 7):
    """`s` with every coordinate moved by up to one float32 ulp."""
    out = s.copy()
    rng = np.random.RandomState(seed)
    out.positions = s.positions * (1 + EPS32 * rng.uniform(
        -1, 1, s.positions.shape))
    return out


def _oneshot_checks(label, calc, s, perfect: bool, ecoh: bool):
    """E_coh, force-sum and stress-symmetry checks on one big frame."""
    res = calc.calculate(s)
    n = len(s)
    if ecoh:
        e = res["energy"] / n
        check(abs(e - ECOH_NI) < ECOH_TOL,
              f"{label} perfect-fcc E = {e:.6f} eV/atom == {ECOH_NI}")
    if perfect:
        return res
    f = np.asarray(res["forces"], dtype=np.float64)
    fsum = float(np.max(np.abs(f.sum(axis=0))))
    ftot = float(np.abs(f).sum())
    check(fsum < 1e-5 * ftot + 1e-6,
          f"{label} |sum F| {fsum:.3e} eV/A < 1e-5 x sum|F| "
          f"({1e-5 * ftot:.3e})")
    # the full stress tensor, from the variant the calculator serves
    vap = calc._get_vap(s)
    use_dev = calc._use_device_nl(s)
    _, efs, _, _ = calc._get_variant(s, use_dev)
    feats = (calc._features_device(s, vap) if use_dev
             else calc._features(s, vap))
    sig = np.asarray(efs(calc.params, feats)["stress"], np.float64)
    asym = float(np.max(np.abs(sig - sig.T))) * GPA
    r = np.linalg.norm(s.positions, axis=1)
    bound = 64 * EPS32 * float(np.sum(np.linalg.norm(f, axis=1) * r)) / \
        s.volume * GPA
    check(asym < bound,
          f"{label} stress asymmetry {asym:.3e} GPa < {bound:.3e} "
          f"(64 eps32 sum|F||r|/V)")
    return res


def _check_nl_regrow(label, calc, s):
    """The device-NL capacity self-healing of the calculator: seed its
    builder cache with half the neighbor capacity it chose, and the
    next call must grow it and give the same E+F+S."""
    from tensoralloy_tpu.transform.device_nl import DeviceNeighborList
    key = (tuple(s.symbols), np.asarray(s.pbc).tobytes())
    want = calc.calculate(s)
    good = calc._nl_cache[key]
    small = DeviceNeighborList(
        calc.featurizer, calc._get_vap(s), s, layout=good.layout,
        nnl_cap=max(good.nnl_cap // 2, 1), cell_cap=good.cell_cap)
    calc._nl_cache[key] = small
    got = calc.calculate(s)
    grown = calc._nl_cache[key]
    report(f"{label}_device_nl_caps",
           f"density census nnl {good.nnl_cap} / cell {good.cell_cap}; "
           f"halved nnl {small.nnl_cap} regrew to {grown.nnl_cap}")
    check(grown.nnl_cap > small.nnl_cap,
          f"{label} device NL regrew from an undersized capacity")
    err = efs_errors(got, want)
    check(err["energy_rel"] < E_REL_TOL and err["forces_abs"] < F_ABS_TOL,
          f"{label} E+F after regrow match: E rel {err['energy_rel']:.3e},"
          f" F {err['forces_abs']:.3e} eV/A")


def phase_serve(dev, ref, grap_npz: str, n_big: int = 32,
                n_parity: int = 10) -> dict:
    """Phase 3: one-shot E+F+S of the 4*n_big^3-atom cell for the zjw04
    EAM and the trained GRAP model (cold, warm, physics checks), and
    E/F/S parity vs `ref` at 4*n_parity^3 atoms."""
    import jax
    from tensoralloy_tpu.calculator import TensorAlloyCalculator
    from tensoralloy_tpu.io.model import load_model

    print("phase 3: serve", flush=True)
    out = {}
    big = fcc_ni(n_big)
    big_r = fcc_ni(n_big, rattle=0.05, seed=3)
    small = fcc_ni(n_parity, rattle=0.05, seed=4)
    eam, eam_p = zjw04_ni(len(big))
    grap, grap_p, _ = load_model(grap_npz)
    for name, model, params in (("eam", eam, eam_p),
                                ("grap", grap, grap_p)):
        label = f"{name} {len(big)} atoms"
        with on(dev):
            calc = TensorAlloyCalculator(model, params)
            _, t_cold = timed(lambda: calc.calculate(big))
            _, t_warm = timed(lambda: calc.calculate(big))
            out[f"{name}_oneshot_cold_s"] = t_cold
            out[f"{name}_oneshot_warm_s"] = t_warm
            report(f"{name}_oneshot_{len(big)}_cold_s", f"{t_cold:.4f}")
            report(f"{name}_oneshot_{len(big)}_warm_s", f"{t_warm:.4f}")
            _oneshot_checks(label, calc, big, perfect=True,
                            ecoh=name == "eam")
            res_tf = _oneshot_checks(label + " rattled", calc, big_r,
                                     perfect=False, ecoh=False)
            if name == "eam" and calc._use_device_nl(big_r):
                _check_nl_regrow(label, calc, big_r)
            res_tf32_small = calc.calculate(small)
        with on(dev, "highest"):
            calc_hi = TensorAlloyCalculator(model, params)
            res_hi = calc_hi.calculate(big_r)
            got = calc_hi.calculate(small)
        err = efs_errors(res_tf, res_hi)
        out[f"{name}_tf32_big"] = err
        report(f"default_precision_vs_highest_{name}_{len(big)}",
               f"E rel {err['energy_rel']:.3e}, F {err['forces_abs']:.3e}"
               f" eV/A, S {err['stress_gpa']:.3e} GPa")
        with on(ref):
            calc_ref = TensorAlloyCalculator(
                model, jax.device_put(params, ref))
            want = calc_ref.calculate(small)
            noise = efs_errors(calc_ref.calculate(ulp_jitter(small)), want)
        report(f"{name}_{len(small)}_{ref.platform}_one_ulp_position_noise",
               f"E rel {noise['energy_rel']:.3e}, F "
               f"{noise['forces_abs']:.3e} eV/A, S "
               f"{noise['stress_gpa']:.3e} GPa")
        out[f"{name}_parity"] = check_efs(
            f"{name} {len(small)} atoms {dev.platform} vs {ref.platform}",
            got, want, noise)
        err = efs_errors(res_tf32_small, got)
        out[f"{name}_tf32_small"] = err
        report(f"default_precision_vs_highest_{name}_{len(small)}",
               f"E rel {err['energy_rel']:.3e}, F {err['forces_abs']:.3e}"
               f" eV/A, S {err['stress_gpa']:.3e} GPa")
    return out


def phase_md(dev, ref, n_axis: int = 10, n_chunks: int = 10,
             chunk: int = 32, temperature: float = 600.0) -> dict:
    """Phase 4: device-NL NVE MD on `dev`; first chunk vs the host-NL
    path on `ref`; energy drift; steps per second."""
    import jax
    from tensoralloy_tpu.dynamics import VelocityVerlet

    print("phase 4: md", flush=True)
    out = {}
    s = fcc_ni(n_axis)
    model, params = zjw04_ni(len(s))
    kw = dict(timestep=1.0, skin=1.0, chunk_size=chunk,
              temperature=temperature, seed=0)
    with on(dev, "highest"):
        md_dev = VelocityVerlet(model, params, s, device_nl=True, **kw)
        h_dev = md_dev.run(chunk)
    with on(ref):
        md_ref = VelocityVerlet(model, jax.device_put(params, ref), s,
                                **kw)
        h_ref = md_ref.run(chunk)
    dpos = float(np.max(np.abs(md_dev.structure.positions -
                               md_ref.structure.positions)))
    de = abs(h_dev["total"][-1] - h_ref["total"][-1]) / \
        abs(h_ref["total"][-1])
    out["first_chunk_pos_err"], out["first_chunk_energy_rel"] = dpos, de
    check(dpos < MD_POS_TOL,
          f"first chunk positions, device NL ({dev.platform}) vs host NL "
          f"({ref.platform}): {dpos:.3e} A < {MD_POS_TOL}")
    check(de < E_REL_TOL, f"first chunk total energy rel err {de:.3e} "
          f"< {E_REL_TOL}")

    with on(dev):
        md = VelocityVerlet(model, params, s, device_nl=True, **kw)
        _, t_first = timed(lambda: md.run(chunk))
        h, t = timed(lambda: md.run(chunk * (n_chunks - 1)))
    out["first_chunk_s"] = t_first
    out["md_steps_per_s"] = chunk * (n_chunks - 1) / t
    out["md_atom_steps_per_s"] = out["md_steps_per_s"] * len(s)
    total = np.asarray(h["total"])
    drift = float(np.max(np.abs(total - total[0]))) / len(s)
    out["drift_ev_per_atom"] = drift
    report(f"md_{len(s)}_atoms_first_chunk_s", f"{t_first:.4f}")
    report(f"md_{len(s)}_atoms_steps_per_s", f"{out['md_steps_per_s']:.3f}")
    report("md_temperature_end_K", f"{h['temperature'][-1]:.2f}")
    check(np.all(np.isfinite(total)), "MD energies finite")
    check(drift < DRIFT_TOL, f"NVE energy drift {drift:.3e} eV/atom "
          f"< {DRIFT_TOL} over {n_chunks - 1} chunks")
    return out


# ----------------------------------------------------------------------
def _grap_model(fz, n_atoms, hidden):
    from tensoralloy_tpu.nn.atomic import AtomicNN
    from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential
    desc = GenericRadialAtomicPotential(
        ["Ni"], algorithm="pexp", parameters=GRAP_PEXP,
        moment_tensors=[0, 1, 2, 3], backend="dense")
    return AtomicNN(fz, Counter({"Ni": n_atoms}), desc,
                    hidden_sizes=list(hidden), minmax_scale=False)


def phase_multi(devices, workdir: str, batch_per_device: int = 32,
                n_axis: int = 3, n_big: int = 32, hidden=(128, 128),
                seed: int = 0) -> dict:
    """Four-device paths, each against one device of the same input:
    data-parallel train step, spatial fast EFS, NEB, ensemble."""
    import jax
    import jax.numpy as jnp
    from tensoralloy_tpu.atoms import Structure
    from tensoralloy_tpu.ensemble import EnsembleCalculator
    from tensoralloy_tpu.io.extxyz import write_extxyz
    from tensoralloy_tpu.io.sqlite import read_file
    from tensoralloy_tpu.neb import NEB
    from tensoralloy_tpu.nn import losses as L
    from tensoralloy_tpu.nn.eam.fast_efs import make_fast_efs_fn
    from tensoralloy_tpu.parallel.mesh import (make_mesh, replicate,
                                               shard_batch)
    from tensoralloy_tpu.parallel.spatial import (
        make_spatial_fast_efs_fn, shard_features_spatial_dense)
    from tensoralloy_tpu.train.dataset import Dataset
    from tensoralloy_tpu.train.trainer import (OptParameters, Trainer,
                                               TrainParameters)
    from tensoralloy_tpu.transform import Featurizer
    from tensoralloy_tpu.transform.device_nl import DeviceNeighborList

    n = len(devices)
    print(f"phase multi: {n} devices", flush=True)
    dev0 = devices[0]
    out = {}
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    with jax.default_matmul_precision("highest"):
        # 1. data-parallel train step. SGD makes the update linear in
        # the gradient, so the updates compare entry by entry.
        bs = batch_per_device * n
        xyz = os.path.join(workdir, "dp.extxyz")
        write_extxyz(xyz, make_training_set(dev0, bs, n_axis, seed))
        db = read_file(xyz, db_path=os.path.join(workdir, "dp.db"))
        fz = Featurizer(["Ni"], rcut=6.0)
        dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
        bf, bl = Dataset(db, fz, name="dp", test_size=0, dtype=dtype,
                         cache_dir=workdir, layout="dense").build()
        model = _grap_model(fz, 4 * n_axis ** 3, hidden)
        params = model.init_params(jax.random.PRNGKey(seed))
        res = {}
        for k in (1, n):
            tr = Trainer(model, L.LossParameters(),
                         OptParameters(method="sgd", learning_rate=1e-3),
                         TrainParameters(batch_size=bs, train_steps=1),
                         minimize_properties=("energy", "forces",
                                              "stress"),
                         n_devices=k)
            state = replicate(tr.init_state(params), tr.mesh)
            st, m = tr._build_train_step()(
                state, shard_batch(bf, tr.mesh), shard_batch(bl, tr.mesh))
            res[k] = (float(m["loss/total"]), _host(st["params"]))
        flat = lambda t: np.concatenate(
            [np.ravel(x) for x in jax.tree_util.tree_leaves(t)])
        p0 = flat(_host(params))
        d1, dn = flat(res[1][1]) - p0, flat(res[n][1]) - p0
        out["dp_loss_rel"] = abs(res[n][0] - res[1][0]) / abs(res[1][0])
        out["dp_update_rel"] = float(np.max(np.abs(dn - d1))) / \
            max(float(np.max(np.abs(d1))), 1e-30)
        check(out["dp_loss_rel"] < E_REL_TOL,
              f"dp train step bs {bs} on {n} vs 1 device: loss rel err "
              f"{out['dp_loss_rel']:.3e} < {E_REL_TOL}")
        check(out["dp_update_rel"] < G_REL_TOL,
              f"dp train step parameter update rel err "
              f"{out['dp_update_rel']:.3e} < {G_REL_TOL}")

        # 2. pair-axis spatial fast EFS of the big EAM cell
        s = fcc_ni(n_big, rattle=0.05, seed=5)
        eam, eam_p = zjw04_ni(len(s))
        vap = eam.featurizer.make_vap(s)
        with on(dev0):
            b = DeviceNeighborList(eam.featurizer, vap, s, layout="dense",
                                   census="density")
            feats, diag = b.build(jnp.asarray(
                vap.map_positions(s.positions).astype(dtype)))
            b.check(jax.device_get(diag))
            one = _host(jax.jit(make_fast_efs_fn(eam))(eam_p, feats))
        mesh = make_mesh(n, axis_name="pairs")
        sp = shard_features_spatial_dense(feats, mesh)
        many = _host(make_spatial_fast_efs_fn(eam, mesh)(eam_p, sp))
        pick = lambda o: {"energy": float(o["energy"]),
                          "forces": o["forces"],
                          "stress": o["stress_voigt"]}
        out["spatial"] = check_efs(
            f"spatial fast EFS {len(s)} atoms on {n} vs 1 device",
            pick(many), pick(one))

        # 3. NEB: a vacancy hop in a 3x3x3 cell, replica axis sharded
        bulk = fcc_ni(3)
        pos = bulk.positions[1:]
        d = pos - bulk.positions[0]
        frac = d @ np.linalg.inv(bulk.cell)
        d = (frac - np.round(frac)) @ bulk.cell
        hop = int(np.argmin(np.linalg.norm(d, axis=1)))
        pos_f = pos.copy()
        pos_f[hop] = pos[hop] - d[hop]
        syms = ["Ni"] * len(pos)
        s_i = Structure.from_symbols(syms, pos, bulk.cell, pbc=[True] * 3)
        s_f = Structure.from_symbols(syms, pos_f, bulk.cell,
                                     pbc=[True] * 3)
        eam_n, eam_np = zjw04_ni(len(syms))
        energies = {}
        for k in (1, n):
            with on(dev0):
                neb = NEB(eam_n, eam_np, s_i, s_f, n_images=2 * n,
                          chunk_size=5, n_shards=k)
                neb.run(fmax=1e-9, max_steps=10)
            energies[k] = np.asarray(neb.energies)
            if k > 1:
                check(len(neb.last_sharding.device_set) == n,
                      f"NEB replica axis on {n} devices")
        out["neb_energy_abs"] = float(np.max(np.abs(energies[n] -
                                                    energies[1])))
        tol = E_REL_TOL * float(np.max(np.abs(energies[1])))
        check(out["neb_energy_abs"] < tol,
              f"NEB band energies on {n} vs 1 device: "
              f"{out['neb_energy_abs']:.3e} eV < {tol:.3e}")

        # 4. ensemble: n GRAP members, member axis sharded
        s = fcc_ni(n_axis, rattle=0.08, seed=6)
        grap = _grap_model(fz, len(s), hidden)
        plist = [grap.init_params(jax.random.PRNGKey(100 + k))
                 for k in range(n)]
        ens = {}
        for k in (1, n):
            with on(dev0):
                calc = EnsembleCalculator(grap, plist, n_shards=k)
                r = calc.calculate(s)
            ens[k] = r
            if k > 1:
                leaf = jax.tree_util.tree_leaves(calc.params)[0]
                check(len(leaf.sharding.device_set) == n,
                      f"ensemble members on {n} devices")
        out["ensemble"] = check_efs(
            f"ensemble of {n} on {n} vs 1 device", ens[n], ens[1])
        out["ensemble_std_abs"] = abs(ens[n]["energy_std"] -
                                      ens[1]["energy_std"])
        tol = E_REL_TOL * abs(ens[1]["energy"])
        check(out["ensemble_std_abs"] < tol,
              f"ensemble energy std on {n} vs 1 device: "
              f"{out['ensemble_std_abs']:.3e} eV < {tol:.3e}")
    return out


# ----------------------------------------------------------------------
class CompileClock:
    """Sums JAX's backend-compile durations and persistent-cache hits."""

    def __init__(self):
        import jax.monitoring as mon
        self.seconds, self.hits = 0.0, 0

        def on_duration(event, secs, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.seconds += secs

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.hits += 1

        mon.register_event_duration_secs_listener(on_duration)
        mon.register_event_listener(on_event)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device paths on 4 GPUs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(REPO, ".chip_smoke"),
                    help="scratch directory for the train phase")
    args = ap.parse_args(argv)

    import jax
    clock = CompileClock()
    t0 = time.perf_counter()
    try:
        devices = phase_device("gpu", 4 if args.multi else 1)
        cpu = jax.devices("cpu")[0]
        if args.multi:
            phase_multi(devices[:4], args.workdir, seed=args.seed)
        else:
            dev = devices[0]
            phase_reference(dev, cpu)
            train = phase_train(dev, cpu, args.workdir, seed=args.seed)
            phase_serve(dev, cpu, train["model"])
            phase_md(dev, cpu)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    report("compile_s", f"{clock.seconds:.3f}")
    report("persistent_cache_hits", clock.hits)
    report("wall_s", f"{time.perf_counter() - t0:.3f}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
