"""Headline benchmark on one GPU.

Two workloads, both through the PRODUCTION `Trainer._build_train_step`
(scan-fused full optimizer steps — no hand-copied training code):

1. QM7-scale: AtomicNN + radial+angular symmetry functions, bs=50 —
   directly comparable to the reference's 2,328 structures/s on a GTX
   1080Ti (`doc/papers/nn/figures/qm7/qm7.speed.csv:5`, BASELINE.md).
2. SNAP-scale: 108-atom Ni cells at rc=6.0 (the BASELINE.md padding
   regime), flagship GRAP pexp-16 moment-0..3 model, dense descriptor
   backend.

Timing method: each measurement ends in a host fetch of the final
loss and uses the MARGINAL cost between a K-step-fused and a
2-step-fused program, so the fixed per-dispatch cost cancels.

MFU evidence: achieved FLOP/s = marginal HLO cost-analysis flops /
marginal time; the device peak is MEASURED in-process with a 4096^3
float32 matmul anchor.

Needs a GPU: without one, or when any stage fails, it exits non-zero.
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_STRUCTURES_PER_S = 2328.0  # QM7 angular SF bs=50, GTX 1080Ti

RECORD = {
    "metric": "qm7_train_throughput_angular_sf_bs50",
    "value": None,
    "unit": "structures/s",
    "vs_baseline": None,
    "extras": {},
}


def make_synthetic_qm7(n_structures: int, seed: int = 611):
    """QM7-like CHNO molecules (up to 16 atoms) with random labels."""
    from tensoralloy_tpu.atoms import Structure
    rng = np.random.RandomState(seed)
    structures = []
    for _ in range(n_structures):
        n_c = rng.randint(2, 6)
        n_h = rng.randint(4, 9)
        n_o = rng.randint(0, 3)
        symbols = ["C"] * n_c + ["H"] * n_h + ["O"] * n_o
        n = len(symbols)
        pos = rng.uniform(0, max(4.0, n ** (1 / 3) * 2.2), size=(n, 3))
        s = Structure.from_symbols(symbols, pos, cell=None)
        s = s.ensure_cell(6.0)
        s.info["energy"] = float(rng.normal(-100.0, 1.0))
        s.info["forces"] = rng.normal(0, 1, size=(n, 3))
        structures.append(s)
    return structures


def make_snap_ni(n_structures: int, seed: int = 0):
    """108-atom rattled fcc Ni cells (SNAP-scale padding at rc=6.0)."""
    from tensoralloy_tpu.atoms import Structure
    rng = np.random.RandomState(seed)
    a0 = 3.52
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(3)
                           for j in range(3) for k in range(3)])
    out = []
    for _ in range(n_structures):
        pos = frac * a0 + rng.normal(scale=0.08, size=(len(frac), 3))
        s = Structure.from_symbols(["Ni"] * len(frac), pos,
                                   np.eye(3) * 3 * a0, pbc=[True] * 3)
        s.info["energy"] = float(rng.normal(-480.0, 1.0))
        s.info["forces"] = rng.normal(0, 1, size=(len(frac), 3))
        out.append(s)
    return out


def featurize_all(structures, fz, max_occurs, transpose=False):
    from tensoralloy_tpu.transform.featurizer import batch_features
    sizes = [fz.neighbor_size(s) for s in structures]
    nij_max = max(x.nij for x in sizes)
    nijk_max = max(x.nijk for x in sizes)
    nnl_max = max(x.nnl_tot for x in sizes)
    ntl_max = max(x.ntl for x in sizes)
    ttrans_max = max(x.ttrans for x in sizes)
    feats_list, labels_list = [], []
    for s in structures:
        vap = fz.make_vap(s, max_occurs)
        f = fz.featurize(s, vap, nij_max=nij_max,
                         nijk_max=nijk_max or None,
                         nnl_max=nnl_max or None, ntl_max=ntl_max or None,
                         dtype=np.float32, transpose=transpose,
                         ttrans_max=(ttrans_max or None)
                         if transpose else None)
        feats_list.append(f)
        labels_list.append({
            "energy": np.float32(s.info["energy"]),
            "n_atoms": np.float32(len(s)),
            "forces": vap.map_forces(s.info["forces"]).astype(np.float32),
            "stress": np.zeros(6, np.float32),
            "has_stress": np.float32(0.0),
            "weights": np.ones(3, np.float32),
        })
    return batch_features(feats_list), batch_features(labels_list)


def _hlo_flops(compiled) -> float:
    try:
        an = compiled.cost_analysis()
        if isinstance(an, (list, tuple)):
            an = an[0]
        return float(an.get("flops", 0.0))
    except Exception:
        return 0.0


def _hlo_bytes(compiled) -> float:
    try:
        an = compiled.cost_analysis()
        if isinstance(an, (list, tuple)):
            an = an[0]
        return float(an.get("bytes accessed", 0.0))
    except Exception:
        return 0.0


def measure_peak_bandwidth():
    """Anchor: big elementwise copy-add, marginal per-iteration GB/s."""
    import jax
    import jax.numpy as jnp
    x = jnp.ones((64, 1024, 1024), jnp.float32)   # 256 MB

    def mk(n):
        def f(x):
            def body(c, _):
                return c + 1.0, None
            c, _ = jax.lax.scan(body, x, None, length=n)
            return c[0, 0, 0]
        return jax.jit(f)

    g1, g9 = mk(1), mk(9)
    float(g1(x)), float(g9(x))
    def best(g):
        b = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            float(g(x))
            b = min(b, time.perf_counter() - t0)
        return b
    per = (best(g9) - best(g1)) / 8
    return 2 * x.nbytes / per / 1e9   # read + write


def measure_train(model, feats, labels, batch_size, k_hi=18,
                  minimize=("energy", "forces"),
                  force_assembly="autodiff", microbatch=0):
    """-> (per_step_seconds, achieved_flops_per_s) via marginal fused
    programs (k_hi-step vs 2-step; fixed dispatch cost cancels)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from tensoralloy_tpu.nn import losses as L
    from tensoralloy_tpu.train.trainer import (Trainer, OptParameters,
                                               TrainParameters)
    from tensoralloy_tpu.parallel.mesh import replicate

    n = len(labels["energy"])
    rng = np.random.RandomState(0)

    def stacked(k):
        sel = rng.randint(0, n, size=(k, batch_size))
        bf = {key: jnp.asarray(v[sel]) for key, v in feats.items()}
        bl = {key: jnp.asarray(v[sel]) for key, v in labels.items()}
        return bf, bl

    results = {}
    flops = {}
    nbytes = {}
    for k in (2, k_hi):
        trainer = Trainer(
            model, L.LossParameters(), OptParameters(learning_rate=1e-3),
            TrainParameters(batch_size=batch_size, train_steps=10000,
                            scan_steps=k, force_assembly=force_assembly,
                            microbatch_size=microbatch),
            minimize_properties=minimize, n_devices=1)
        params = model.init_params(jax.random.PRNGKey(0))
        state = replicate(trainer.init_state(params), trainer.mesh)
        step = trainer._build_train_step()
        bf, bl = stacked(k)
        # "inputs actually read" lower bound: the autodiff program
        # never touches the transpose tables (featurized with
        # transpose=True only so the denseefs rows can share the same
        # arrays), so counting them would inflate the stream rate
        read_keys = [key for key in bf
                     if force_assembly != "autodiff" or "_trans" not in key]
        batch_bytes = (sum(np.asarray(bf[key]).nbytes
                           for key in read_keys) +
                       sum(np.asarray(v).nbytes
                           for v in bl.values())) / k
        state, m = step(state, bf, bl)
        float(m["loss/total"])              # compile + force completion
        best = 1e9
        for _ in range(5):
            t0 = time.perf_counter()
            state, m = step(state, bf, bl)
            float(m["loss/total"])          # host fetch = real barrier
            best = min(best, time.perf_counter() - t0)
        results[k] = best
        compiled = step.lower(state, bf, bl).compile()
        flops[k] = _hlo_flops(compiled)
        nbytes[k] = _hlo_bytes(compiled)
    per_step = max((results[k_hi] - results[2]) / (k_hi - 2), 1e-9)
    # XLA cost_analysis counts a lax.scan body ONCE (trip count is not
    # folded in), so the k-fused program's flops ARE the per-step flops
    return (per_step, flops[k_hi] / per_step, nbytes[k_hi] / per_step,
            batch_bytes / per_step)


def measure_md(n_axis=10):
    """Device-resident NVE MD throughput (zjw04 EAM Ni, 4*n_axis^3
    atoms): marginal seconds/step via 64-vs-32-step fused chunks with a
    forced host fetch. Returns (natoms, md_steps_per_s,
    atom_steps_per_s)."""
    from collections import Counter
    import jax
    from tensoralloy_tpu.atoms import Structure
    from tensoralloy_tpu.transform import Featurizer
    from tensoralloy_tpu.nn.eam import EamAlloyNN
    from tensoralloy_tpu.dynamics import VelocityVerlet

    a0 = 3.52
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(n_axis)
                           for j in range(n_axis) for k in range(n_axis)])
    s = Structure.from_symbols(["Ni"] * len(frac), frac * a0,
                               np.eye(3) * a0 * n_axis, pbc=[True] * 3)
    fz = Featurizer(["Ni"], rcut=6.0)
    model = EamAlloyNN(fz, Counter({"Ni": len(s)}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    md = VelocityVerlet(model, params, s, timestep=1.0, skin=1.0,
                        chunk_size=32, temperature=600.0)
    # one host featurization (skinned), then time the jitted chunk
    old = fz.rcut
    try:
        fz.rcut += md.skin
        feats_np = md._build_features(s.positions)
    finally:
        fz.rcut = old
    import jax.numpy as jnp
    feats = {k: jnp.asarray(v) for k, v in feats_np.items()}
    dtype = np.asarray(feats["positions"]).dtype
    pos = jnp.asarray(md.vap.map_positions(s.positions).astype(dtype))
    feats["positions"] = pos
    vel = jnp.asarray(md.velocities_vap.astype(dtype))
    cell = jnp.asarray(np.asarray(s.cell).astype(dtype))
    scan = md._make_scan()

    def run(n):
        out = scan(pos, vel, cell, md._key, feats, n)
        return float(out[4])   # energy: forced host fetch

    run(64), run(32)       # compile both
    def best(n):
        b = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            run(n)
            b = min(b, time.perf_counter() - t0)
        return b
    per_step = max((best(64) - best(32)) / 32, 1e-9)
    return len(s), 1.0 / per_step, len(s) / per_step


def _fcc_ni(n_axis):
    from tensoralloy_tpu.atoms import Structure
    a0 = 3.52
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(n_axis)
                           for j in range(n_axis) for k in range(n_axis)])
    return Structure.from_symbols(["Ni"] * len(frac), frac * a0,
                                  np.eye(3) * a0 * n_axis, pbc=[True] * 3)


def measure_md_device_nl(n_axis=10):
    """Fully on-device MD: the neighbor rebuild runs INSIDE the jitted
    chunk (`transform/device_nl.py`), so this number includes
    re-neighboring every 32 steps — unlike `measure_md`, which times
    the integration scan only and leaves the (much slower) host
    rebuild out. Returns (natoms, md_steps_per_s, atom_steps_per_s)."""
    from collections import Counter
    import jax
    import jax.numpy as jnp
    from tensoralloy_tpu.transform import Featurizer
    from tensoralloy_tpu.nn.eam import EamAlloyNN
    from tensoralloy_tpu.dynamics import VelocityVerlet

    s = _fcc_ni(n_axis)
    fz = Featurizer(["Ni"], rcut=6.0)
    model = EamAlloyNN(fz, Counter({"Ni": len(s)}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    md = VelocityVerlet(model, params, s, timestep=1.0, skin=1.0,
                        chunk_size=32, temperature=600.0,
                        device_nl=True)
    dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    pos = jnp.asarray(md.vap.map_positions(s.positions).astype(dtype))
    vel = jnp.asarray(md.velocities_vap.astype(dtype))
    cell = jnp.asarray(np.asarray(s.cell).astype(dtype))
    scan = md._make_scan_device()

    def run(n):
        out = scan(pos, vel, cell, md._key, n)
        return float(out[4])   # energy: forced host fetch

    run(64), run(32)       # compile both
    per_step = max((_best_of(lambda: run(64)) -
                    _best_of(lambda: run(32))) / 32, 1e-9)
    return len(s), 1.0 / per_step, len(s) / per_step


def measure_device_nl_build(n_axis=16):
    """Neighbor-list construction alone, device vs host, same system
    (4*n_axis^3 fcc Ni atoms, rc 6.0): the device build replaces the
    dominant host cost of large-cell inference. Returns
    (natoms, device_build_ms, host_featurize_ms)."""
    import jax
    import jax.numpy as jnp
    from tensoralloy_tpu.transform import Featurizer
    from tensoralloy_tpu.transform.device_nl import DeviceNeighborList

    s = _fcc_ni(n_axis)
    fz = Featurizer(["Ni"], rcut=6.0)
    vap = fz.make_vap(s)
    t0 = time.perf_counter()
    feats_host = fz.featurize(s, vap, layout="dense")
    host_ms = (time.perf_counter() - t0) * 1e3
    b = DeviceNeighborList(fz, vap, s, layout="dense")
    pos = jnp.asarray(vap.map_positions(s.positions))

    def run():
        feats, diag = b.build(pos)
        jax.block_until_ready(feats["pair_j_d"])

    run()                   # compile
    dev_ms = _best_of(run) * 1e3
    del feats_host
    return len(s), dev_ms, host_ms


def _best_of(fn, reps=3):
    b = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        b = min(b, time.perf_counter() - t0)
    return b


def measure_descriptor(desc, fz, feats, batch_size, k_lo=2, k_hi=12):
    """Marginal device time of the batched descriptor FORWARD alone
    (the hot kernel BASELINE.json targets), plus its compulsory HBM
    traffic (inputs actually read + outputs written — the post-fusion
    LOWER bound on bytes; cost_analysis gives the pre-fusion upper).

    Returns (seconds_per_batch, compulsory_bytes_per_batch)."""
    import jax
    import jax.numpy as jnp

    n = len(feats["n_atoms"])
    sel = np.random.RandomState(0).randint(0, n, size=batch_size)
    batch = {k: jnp.asarray(v[sel]) for k, v in feats.items()}
    args = (fz.rcut, fz.acut, fz.n_radial_slots, fz.n_angular_slots,
            fz.angular)

    def make(k):
        def f(d):
            def body(c, _):
                d2 = dict(d)
                d2["positions"] = d["positions"] + c * 1e-12
                g = jax.vmap(lambda f1: desc.compute(f1, *args))(d2)
                return c + 1e-30 * jnp.sum(g), None
            c, _ = jax.lax.scan(body, jnp.zeros(()), None, length=k)
            return c
        return jax.jit(f)

    g_lo, g_hi = make(k_lo), make(k_hi)
    float(g_lo(batch)), float(g_hi(batch))
    t = (_best_of(lambda: float(g_hi(batch))) -
         _best_of(lambda: float(g_lo(batch)))) / (k_hi - k_lo)
    g_out = jax.vmap(lambda f1: desc.compute(f1, *args))(batch)
    pair_keys = [k for k in batch if k.endswith("_d") or
                 k in ("positions", "cell")]
    in_bytes = sum(np.asarray(batch[k]).nbytes for k in pair_keys)
    out_bytes = np.asarray(g_out).nbytes
    return max(t, 1e-9), float(in_bytes + out_bytes)


def measure_descriptor_matrix(fz, feats, batch_size=32):
    """SNAP-padding dense GRAP descriptor forward ms for the flagship
    at moments 0-3 and the accuracy config 0-5, with its compulsory
    traffic rate."""
    from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential

    pexp = {"rl": [1.0, 1.2, 1.4, 1.6, 1.8, 2.0, 2.2, 2.4, 2.6,
                   2.8, 3.0, 3.2, 3.4, 3.6, 3.8, 4.0],
            "pl": [5.0, 4.75, 4.5, 4.25, 4.0, 3.75, 3.5, 3.25,
                   3.0, 2.75, 2.5, 2.25, 2.0, 1.75, 1.5, 1.25]}
    out = {}
    for moments in ([0, 1, 2, 3], [0, 1, 2, 3, 4, 5]):
        desc = GenericRadialAtomicPotential(
            ["Ni"], algorithm="pexp", parameters=pexp,
            moment_tensors=moments, backend="dense")
        key = f"m0-{max(moments)}_dense"
        t, comp_bytes = measure_descriptor(desc, fz, feats, batch_size)
        out[key + "_desc_ms"] = round(t * 1e3, 3)
        out[key + "_compulsory_gbps"] = round(comp_bytes / t / 1e9, 1)
    return out


def measure_bs_scaling(fz, feats, labels, model_fn,
                       sizes=(32, 128, 512)):
    """structures/s vs batch size for the full SNAP train step — where
    does one device saturate? (bs=32 of 108-atom cells is small)."""
    out = {}
    for bs in sizes:
        step, fps, _, _ = measure_train(model_fn(), feats, labels,
                                        batch_size=bs, k_hi=6)
        out[f"bs{bs}_structs_per_s"] = round(bs / step, 1)
        out[f"bs{bs}_achieved_tflops"] = round(fps / 1e12, 3)
    # gradient accumulation (train.microbatch_size): the same optimizer
    # batch scanned through the compiled step in small-batch chunks
    for bs, mb in ((128, 32), (512, 32), (512, 128)):
        step, fps, _, _ = measure_train(model_fn(), feats, labels,
                                        batch_size=bs, k_hi=6,
                                        microbatch=mb)
        out[f"bs{bs}_mb{mb}_structs_per_s"] = round(bs / step, 1)
        out[f"bs{bs}_mb{mb}_achieved_tflops"] = round(fps / 1e12, 3)
    # scatter-free force assembly (force_assembly='dense'): the same
    # train step with the gather-VJP scatter-add replaced by transpose-
    # table gathers
    for bs in sizes:
        step, fps, _, _ = measure_train(model_fn(), feats, labels,
                                        batch_size=bs, k_hi=6,
                                        force_assembly="dense")
        out[f"bs{bs}_structs_per_s_denseefs"] = round(bs / step, 1)
        out[f"bs{bs}_achieved_tflops_denseefs"] = round(fps / 1e12, 3)
    return out


def measure_fast_efs(n_axis=24):
    """Large-cell E+F+stress through the scatter-free analytic EAM
    path (`nn/eam/fast_efs.py`) — marginal device seconds per full
    evaluation at 4*n_axis^3 atoms."""
    import jax
    import jax.numpy as jnp
    from collections import Counter
    from tensoralloy_tpu.transform import Featurizer
    from tensoralloy_tpu.nn.eam import EamAlloyNN
    from tensoralloy_tpu.nn.eam.fast_efs import make_fast_efs_fn

    s = _fcc_ni(n_axis)
    fz = Featurizer(["Ni"], rcut=6.0)
    model = EamAlloyNN(fz, Counter({"Ni": len(s)}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    vap = fz.make_vap(s)
    feats = fz.featurize(
        s, vap, layout="dense", dtype=np.float32,
        nnl_bucket=lambda m: max(32, 1 << (m - 1).bit_length()))
    dfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    efs = make_fast_efs_fn(model)

    def mk(k):
        def f(p, d):
            def body(carry, _):
                d2 = dict(d)
                d2["positions"] = d["positions"] + carry * 1e-12
                o = efs(p, d2)
                return (o["energy"] + 1e-30 * jnp.sum(o["forces"]) +
                        1e-30 * jnp.sum(o["stress"])), None
            acc, _ = jax.lax.scan(body, jnp.zeros(()), None, length=k)
            return acc
        return jax.jit(f)

    g1, g5 = mk(1), mk(5)
    float(g1(params, dfeats)), float(g5(params, dfeats))
    t = (_best_of(lambda: float(g5(params, dfeats))) -
         _best_of(lambda: float(g1(params, dfeats)))) / 4
    return len(s), max(t, 1e-9)


def measure_peak_tflops():
    """Anchor: 4096^3 matmul chain, marginal per-iteration time."""
    import jax
    import jax.numpy as jnp
    x = jax.random.normal(jax.random.PRNGKey(0), (4096, 4096), jnp.float32)

    def mk(n):
        def f(x):
            def body(c, _):
                return jnp.tanh(c @ x), None
            c, _ = jax.lax.scan(body, x, None, length=n)
            return c[0, 0]
        return jax.jit(f)

    g1, g9 = mk(1), mk(9)
    float(g1(x)), float(g9(x))
    def best(g):
        b = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            float(g(x))
            b = min(b, time.perf_counter() - t0)
        return b
    per = (best(g9) - best(g1)) / 8
    return 2 * 4096 ** 3 / per / 1e12


def run_bench():
    """Run every stage, filling RECORD; any failure propagates."""
    from collections import Counter
    import jax
    from tensoralloy_tpu.transform import Featurizer
    from tensoralloy_tpu.nn.sf import SymmetryFunction
    from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential
    from tensoralloy_tpu.nn.atomic import AtomicNN

    ex = RECORD["extras"]
    dev = jax.devices()[0]
    ex["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                    "count": len(jax.devices())}
    ex["timing"] = ("marginal K-vs-2 fused scan, host fetch of the "
                    "final loss; full optimizer step incl adam+EMA")

    # ---- QM7-scale headline (reference-comparable task) ----
    structures = make_synthetic_qm7(120)
    max_occurs = Counter()
    for s in structures:
        for e, c in s.count().items():
            max_occurs[e] = max(max_occurs[e], c)
    fz = Featurizer(sorted(max_occurs), rcut=6.5, angular=True)
    feats, labels = featurize_all(structures, fz, max_occurs,
                                  transpose=True)
    sf = SymmetryFunction(sorted(max_occurs), backend="dense")
    model = AtomicNN(fz, max_occurs, sf, hidden_sizes=[64, 32],
                     minmax_scale=False)
    qm7_step, qm7_fps, _, _ = measure_train(model, feats, labels,
                                            batch_size=50, k_hi=66)
    qm7_throughput = 50.0 / qm7_step
    RECORD["value"] = round(qm7_throughput, 1)
    RECORD["vs_baseline"] = round(
        qm7_throughput / BASELINE_STRUCTURES_PER_S, 3)
    ex["qm7_achieved_tflops"] = round(qm7_fps / 1e12, 2)
    qd_step, qd_fps, _, _ = measure_train(
        model, feats, labels, batch_size=50, k_hi=66,
        force_assembly="dense")
    ex["qm7_structs_per_s_denseefs"] = round(50.0 / qd_step, 1)
    ex["qm7_achieved_tflops_denseefs"] = round(qd_fps / 1e12, 2)

    # ---- SNAP-scale flagship (BASELINE.md padding regime) ----
    snap = make_snap_ni(32)
    mo = Counter({"Ni": 108})
    fzs = Featurizer(["Ni"], rcut=6.0)
    sfeats, slabels = featurize_all(snap, fzs, mo, transpose=True)

    def snap_model():
        g = GenericRadialAtomicPotential(
            ["Ni"], algorithm="pexp",
            parameters={"rl": [1.0, 1.2, 1.4, 1.6, 1.8, 2.0, 2.2, 2.4,
                               2.6, 2.8, 3.0, 3.2, 3.4, 3.6, 3.8, 4.0],
                        "pl": [5.0, 4.75, 4.5, 4.25, 4.0, 3.75, 3.5,
                               3.25, 3.0, 2.75, 2.5, 2.25, 2.0, 1.75,
                               1.5, 1.25]},
            moment_tensors=[0, 1, 2, 3], backend="dense")
        return AtomicNN(fzs, mo, g, hidden_sizes=[128, 128],
                        minmax_scale=False)

    snap_step, snap_fps, snap_bps, snap_stream = measure_train(
        snap_model(), sfeats, slabels, batch_size=32, k_hi=10)
    snap_throughput = 32.0 / snap_step
    ex["snap_grap_train_structs_per_s"] = round(snap_throughput, 1)
    ex["snap_grap_train_ms_per_step_bs32"] = round(snap_step * 1e3, 3)
    ex["snap_grap_achieved_tflops"] = round(snap_fps / 1e12, 2)

    peak = measure_peak_tflops()
    peak_bw = measure_peak_bandwidth()
    ex["measured_peak_tflops_matmul_anchor"] = round(peak, 1)
    ex["snap_mfu_vs_measured_peak"] = round(
        snap_fps / 1e12 / max(peak, 1e-9), 4)
    # this op class is bandwidth-bound (tiny matmuls, big gathers):
    # the roofline axis that binds is device-memory bytes. HLO 'bytes
    # accessed' counts each op's logical traffic BEFORE fusion, so it
    # is an UPPER bound — a ratio > 1 vs the copy anchor means XLA
    # fused away materializations, not a violation. The batch-stream
    # rate is the matching LOWER bound (inputs actually read).
    ex["snap_grap_hlo_gbps_prefusion_upper"] = round(snap_bps / 1e9, 1)
    ex["snap_grap_batch_stream_gbps_lower"] = round(snap_stream / 1e9, 1)
    ex["measured_peak_gbps_copy_anchor"] = round(peak_bw, 1)
    ex["snap_hlo_bytes_vs_peak"] = round(
        snap_bps / max(peak_bw * 1e9, 1e-9), 4)

    md_atoms, md_sps, md_aps = measure_md(10)
    ex["md_nve_eam_atoms"] = md_atoms
    ex["md_nve_eam_steps_per_s"] = round(md_sps, 1)
    ex["md_nve_eam_atom_steps_per_s"] = round(md_aps, 0)
    # fully on-device MD: neighbor rebuild INSIDE the jitted chunk
    # (every 32 steps) — end to end, no host work
    _, mdn_sps, mdn_aps = measure_md_device_nl(10)
    ex["md_device_nl_steps_per_s"] = round(mdn_sps, 1)
    ex["md_device_nl_atom_steps_per_s"] = round(mdn_aps, 0)
    nl_atoms, nl_dev_ms, nl_host_ms = measure_device_nl_build(16)
    ex["device_nl_atoms"] = nl_atoms
    ex["device_nl_build_ms"] = round(nl_dev_ms, 2)
    ex["host_featurize_ms_same_system"] = round(nl_host_ms, 1)

    # large-cell scatter-free EFS (the analytic EAM path)
    natoms, t_fast = measure_fast_efs(24)
    ex["fast_efs_atoms"] = natoms
    ex["fast_efs_device_s"] = round(t_fast, 4)

    ex["descriptor_matrix"] = measure_descriptor_matrix(fzs, sfeats,
                                                        batch_size=32)
    ex["bs_scaling"] = measure_bs_scaling(fzs, sfeats, slabels,
                                          snap_model)


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform} "
              f"devices {jax.devices()}", file=sys.stderr)
        return 1
    run_bench()
    print(json.dumps(RECORD), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
