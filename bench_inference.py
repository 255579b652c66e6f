"""Large-cell inference benchmark (EAM/zjw04 energy+forces+stress).

Reference baseline (BASELINE.md): 128,000-atom MoNi prediction took
~71.6 s end-to-end on the reference workstation (26.6 s neighbor list
+ 70.6 s feed-dict in Python + ~1.0 s GPU graph). Here featurization is
a native C++ cell list (or fully on-device) and the whole property
computation is ONE jitted executable.

The script reports both force paths — the scatter-free analytic EFS
(`nn/eam/fast_efs.py`: gathers + dense row reductions with
hand-derived forces) and autodiff — plus a stage breakdown (device-NL
build alone vs build+EFS) to bracket where the time goes.

Prints one JSON line per size. Not the driver headline (see bench.py);
run manually:
    python bench_inference.py [n_axis] [pair_chunk] [--device-nl]
                              [--no-fast] [--autodiff]

Every timed region ends in a host fetch and uses marginal K-vs-1
fused scans, so the fixed per-dispatch cost cancels. Host-side
featurization times vary with the host's load more than device
times do.
"""
import json
import sys
import time

import numpy as np


def _marginal(run_k, lo=1, hi=5, reps=3):
    """Marginal per-iteration seconds between a hi- and lo-fused
    program, host-fetch forced by run_k itself."""
    g_lo, g_hi = run_k(lo), run_k(hi)
    g_lo(), g_hi()                       # compile both
    def best(g):
        b = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            g()
            b = min(b, time.perf_counter() - t0)
        return b
    return max((best(g_hi) - best(g_lo)) / (hi - lo), 1e-9)


def _main_device_nl(s, fz, vap, model, params, efs_raw, fast_fn,
                    pair_chunk):
    """Steady-state trajectory regime: neighbor list built ON DEVICE —
    each frame is ONE device call from raw positions to E+F+S. Stage
    breakdown: (a) NL build alone, (b) build + fast EFS, (c) build +
    autodiff EFS (round-3 path)."""
    import jax
    import jax.numpy as jnp
    from tensoralloy_tpu.transform.device_nl import DeviceNeighborList
    from tensoralloy_tpu.calculator import model_feature_layout

    t0 = time.perf_counter()
    builder = DeviceNeighborList(
        fz, vap, s, layout="dense" if fast_fn is not None else "segment")
    t_census = time.perf_counter() - t0
    pos0 = jnp.asarray(vap.map_positions(s.positions).astype(np.float32))
    cell = jnp.asarray(builder.cell0, pos0.dtype)

    def make_run(consume):
        """consume(feats, diag) -> scalar; returns k -> timed callable."""
        def run_k(k):
            def f(p, pos):
                def body(carry, _):
                    feats, diag = builder._build(
                        pos + carry * 1e-12, cell,
                        jnp.zeros((), pos.dtype))
                    return consume(p, feats, diag, pos.dtype), None
                acc, _ = jax.lax.scan(body, jnp.zeros((), pos.dtype),
                                      None, length=k)
                return acc
            g = jax.jit(f)
            return lambda: float(g(params, pos0))
        return run_k

    def eat_build(p, feats, diag, dt):
        # touch every feature array so the build cannot be DCE'd
        acc = diag["nnl_needed"].astype(dt)
        for v in feats.values():
            acc = acc + 1e-30 * jnp.sum(v.astype(dt) if v.dtype != dt
                                        else v)
        return acc

    def eat_efs(efs):
        def f(p, feats, diag, dt):
            o = efs(p, feats)
            return (o["energy"] + 1e-30 * jnp.sum(o["forces"]) +
                    1e-30 * jnp.sum(o["stress"]) +
                    1e-30 * diag["nnl_needed"].astype(dt))
        return f

    import jax.numpy as jnp  # noqa: F811 (used in closures above)
    t_build = _marginal(make_run(eat_build))
    out = {"metric": f"efs_device_nl_{len(s)}_atoms",
           "unit": "s/frame (positions -> E+F+stress, one device call)",
           "census_s_one_time": round(t_census, 3),
           "nl_build_only_s": round(t_build, 4),
           "nnl_cap": builder.nnl_cap}
    if fast_fn is not None:
        t_fast = _marginal(make_run(eat_efs(fast_fn)))
        out["value"] = round(t_fast, 4)
        out["efs_fast_minus_build_s"] = round(t_fast - t_build, 4)
    else:
        t_auto = _marginal(make_run(eat_efs(efs_raw)))
        out["value"] = round(t_auto, 4)
        out["efs_autodiff_minus_build_s"] = round(t_auto - t_build, 4)
        out["pair_chunk"] = pair_chunk
    # overflow sanity once (outside the timed loop)
    feats, diag = builder.build(pos0)
    builder.check(jax.device_get(diag))
    baseline_total = 71.6 * len(s) / 128000.0
    out["vs_baseline"] = round(baseline_total / max(out["value"], 1e-9), 2)
    print(json.dumps(out))


def _grap_main(n: int):
    """Descriptor-NN family at large cells (the reference's own speed
    benchmark family, `cpc_speed.py:36-74`: AtomicNN/GRAP on a 1080Ti
    executed its 128k-atom graph in ~1.0 s): E+F+S through the
    transpose-assembled dense EFS (`ops/dense.make_dense_efs_fn`) vs
    the positions-autodiff path."""
    import jax
    import jax.numpy as jnp
    from collections import Counter
    from tensoralloy_tpu.atoms import Structure
    from tensoralloy_tpu.transform import Featurizer
    from tensoralloy_tpu.nn.atomic import AtomicNN
    from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential
    from tensoralloy_tpu.nn.fields import make_efs_fn
    from tensoralloy_tpu.ops.dense import make_dense_efs_fn

    a0 = 3.52
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                     [0, 0.5, 0.5]])
    rng = np.random.RandomState(0)
    frac = np.concatenate([base + [i, j, k] for i in range(n)
                           for j in range(n) for k in range(n)])
    pos = frac * a0 + rng.normal(0, 0.05, (len(frac), 3))
    s = Structure.from_symbols(["Ni"] * len(frac), pos,
                               np.eye(3) * a0 * n, pbc=[True] * 3)
    fz = Featurizer(["Ni"], rcut=6.0)
    grap = GenericRadialAtomicPotential(
        ["Ni"], algorithm="pexp",
        parameters={"rl": [1.0, 1.2, 1.4, 1.6, 1.8, 2.0, 2.2, 2.4, 2.6,
                           2.8, 3.0, 3.2, 3.4, 3.6, 3.8, 4.0],
                    "pl": [5.0, 4.75, 4.5, 4.25, 4.0, 3.75, 3.5, 3.25,
                           3.0, 2.75, 2.5, 2.25, 2.0, 1.75, 1.5, 1.25]},
        moment_tensors=[0, 1, 2, 3], backend="dense")
    model = AtomicNN(fz, Counter({"Ni": len(s)}), grap,
                     hidden_sizes=[128, 128], minmax_scale=False)
    params = model.init_params(jax.random.PRNGKey(0))

    t0 = time.perf_counter()
    vap = fz.make_vap(s)
    feats = fz.featurize(s, vap,
                         nnl_bucket=lambda m: max(
                             32, 1 << (m - 1).bit_length()),
                         dtype=np.float32, layout="dense",
                         transpose=True)
    t_feat = time.perf_counter() - t0
    dfeats = {k: jax.device_put(jnp.asarray(v)) for k, v in feats.items()}
    jax.block_until_ready(list(dfeats.values()))

    def timed(efs):
        def run_k(k):
            def f(p, d):
                def body(carry, _):
                    d2 = dict(d)
                    d2["positions"] = d["positions"] + carry * 1e-12
                    o = efs(p, d2)
                    acc = (o["energy"] +
                           1e-30 * jnp.sum(o["forces"]) +
                           1e-30 * jnp.sum(o["stress"]))
                    return acc, None
                acc, _ = jax.lax.scan(body, jnp.zeros(()), None, length=k)
                return acc
            g = jax.jit(f)
            return lambda: float(g(params, dfeats))
        return _marginal(run_k, lo=1, hi=5)

    t_new = timed(make_dense_efs_fn(model.variational_energy))
    out = {"metric": f"grap_efs_inference_{len(s)}_atoms",
           "unit": "s device (E+F+stress, dense GRAP pexp-16 m0-3)",
           "featurize_s": round(t_feat, 3),
           "device_exec_transpose_s": round(t_new, 4),
           "value": round(t_new, 4),
           # reference graph time scaled from its 128k measurement
           "vs_baseline_graph": round(
               1.0 * len(s) / 128000.0 / max(t_new, 1e-9), 2)}
    try:
        t_auto = timed(make_efs_fn(model.variational_energy))
        out["device_exec_autodiff_s"] = round(t_auto, 4)
    except Exception as e:       # monolithic backward can OOM at 131k
        out["device_exec_autodiff_s"] = -1.0
        out["autodiff_error"] = repr(e)[:120]
    print(json.dumps(out))


def main(n: int = 20, pair_chunk: int = 0, device_nl: bool = False,
         fast: bool = True, also_autodiff: bool = False):
    import jax
    import jax.numpy as jnp
    from collections import Counter
    from tensoralloy_tpu.atoms import Structure
    from tensoralloy_tpu.transform import Featurizer
    from tensoralloy_tpu.nn.eam import EamAlloyNN
    from tensoralloy_tpu.nn.eam.fast_efs import make_fast_efs_fn
    from tensoralloy_tpu.nn.fields import make_efs_fn

    a0 = 3.52
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                     [0, 0.5, 0.5]])
    rng = np.random.RandomState(0)
    frac = np.concatenate([base + [i, j, k] for i in range(n)
                           for j in range(n) for k in range(n)])
    pos = frac * a0 + rng.normal(0, 0.05, (len(frac), 3))
    s = Structure.from_symbols(["Ni"] * len(frac), pos,
                               np.eye(3) * a0 * n, pbc=[True] * 3)
    fz = Featurizer(["Ni"], rcut=6.0)
    model = EamAlloyNN(fz, Counter({"Ni": len(s)}),
                       custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))

    if pair_chunk == 0 and len(s) > 60000:
        # monolithic autodiff backward exceeds single-chip HBM above
        # ~60k atoms: remat pair-chunks (fast path needs neither)
        pair_chunk = 1 << 21
    energy_fn = (model.make_chunked_energy_fn(pair_chunk)
                 if pair_chunk else model.variational_energy)
    efs_raw = make_efs_fn(energy_fn)
    fast_fn = make_fast_efs_fn(model) if fast else None
    if device_nl:
        return _main_device_nl(s, fz, fz.make_vap(s), model, params,
                               efs_raw, fast_fn, pair_chunk)

    t0 = time.perf_counter()
    vap = fz.make_vap(s)
    feats = fz.featurize(s, vap,
                         pair_bucket=lambda m: 1 << (m - 1).bit_length(),
                         nnl_bucket=lambda m: max(
                             32, 1 << (m - 1).bit_length()),
                         dtype=np.float32,
                         layout="dense" if fast and not also_autodiff
                         else "both")
    t_feat = time.perf_counter() - t0

    t0 = time.perf_counter()
    dfeats = {k: jax.device_put(jnp.asarray(v)) for k, v in feats.items()}
    jax.block_until_ready(list(dfeats.values()))
    t_h2d = time.perf_counter() - t0

    def timed(efs):
        def run_k(k):
            def f(p, d):
                def body(carry, _):
                    d2 = dict(d)
                    # thread the carry into the inputs so XLA cannot
                    # hoist the loop-invariant evaluation out; the carry
                    # must touch EVERY output or the force/stress part
                    # is dead-code-eliminated
                    d2["positions"] = d["positions"] + carry * 1e-12
                    o = efs(p, d2)
                    acc = (o["energy"] +
                           1e-30 * jnp.sum(o["forces"]) +
                           1e-30 * jnp.sum(o["stress"]))
                    return acc, None
                acc, _ = jax.lax.scan(body, jnp.zeros(()), None, length=k)
                return acc
            g = jax.jit(f)
            return lambda: float(g(params, dfeats))
        return _marginal(run_k, lo=1, hi=9)

    out = {"metric": f"efs_inference_{len(s)}_atoms",
           "unit": "s (featurize+transfer+device)",
           "featurize_s": round(t_feat, 3),
           "h2d_s": round(t_h2d, 3)}
    if fast:
        t_exec = timed(fast_fn)
        out["device_exec_fast_s"] = round(t_exec, 4)
    if also_autodiff or not fast:
        t_auto = timed(efs_raw)
        out["device_exec_autodiff_s"] = round(t_auto, 4)
        out["pair_chunk"] = pair_chunk
        if not fast:
            t_exec = t_auto
    total = t_feat + t_h2d + t_exec
    baseline_total = 71.6 * len(s) / 128000.0
    out["value"] = round(total, 3)
    out["vs_baseline"] = round(baseline_total / total, 2)
    print(json.dumps(out))


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if "--grap" in sys.argv:
        _grap_main(int(args[0]) if args else 20)
    else:
        main(int(args[0]) if args else 20,
             int(args[1]) if len(args) > 1 else 0,
             device_nl="--device-nl" in sys.argv,
             fast="--no-fast" not in sys.argv,
             also_autodiff="--autodiff" in sys.argv)
