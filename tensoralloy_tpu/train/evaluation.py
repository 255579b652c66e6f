"""Deployment-grade (exact-f32) evaluation of a finished run dir.

The reference reports one overall MAE per property per model
(`tensoralloy/train/training.py` eval loop; its paper tables are
overall numbers only, `doc/papers/nn/manuscript.tex:1234-1247`).
Round 4 hardened two lessons into the framework that this module
institutionalizes as a first-class verb:

1. **Training-time evals at reduced matmul precision are not accuracy
   numbers.** Under bf16 (or TF32) matmuls, late-training weights
   co-adapt to device rounding and forward noise pessimizes small
   channels, so
   quoted MAEs must come from a fresh evaluation whose programs lower
   at exact precision. `Trainer.evaluate` already does this
   (`TrainParameters.eval_matmul_precision` defaults to 'highest'),
   so every number here is deployment-grade on any backend.
2. **Overall MAEs hide where the error lives.** The SNAP-style dbs
   tag frames with a `source` like "Mo.Elastic.12"; grouping the
   split by that prefix separates capacity problems (bad on train
   too) from generalization problems (bad only on test) — the
   diagnosis layer every round-4 ablation ran on.

The split is rebuilt through `Dataset.split_indices` — THE split
contract — so rows can never be mis-tagged by a drifted permutation.
"""
import contextlib
import re
import glob
import json
import os
from typing import Optional

import numpy as np

from ..nn.fields import EV_ANGSTROM3_TO_GPA as GPA


@contextlib.contextmanager
def _chdir(path: str):
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def _group_of(source: str) -> str:
    """'Mo.Elastic.12' -> 'Mo.Elastic' (strip the frame counter)."""
    return ".".join(str(source).split(".")[:-1]) or str(source)


def evaluate_run(workdir: str = ".", ckpt: Optional[str] = None,
                 per_group: bool = True, use_ema: bool = True,
                 output: Optional[str] = "group_maes.json",
                 verbose: bool = True) -> dict:
    """Evaluate a run dir (containing input.toml + model/) per group.

    Returns {"step", "checkpoint", "splits": {split: {tag: {n,
    energy_meV_per_atom, force_eV_A, stress_GPa}}}} for both splits,
    with an "overall" row per split; writes it to `output` (relative
    to workdir) unless None. `ckpt` picks a specific checkpoint file
    (relative to the CALLER's cwd); default = the newest `ckpt-*.npz`
    in the run's model_dir.

    Run this under a CPU backend (the deployment-grade numbers are
    exact-f32 either way, but per-group evaluation compiles one eval
    program per distinct group size, which is cheap on CPU).
    """
    if ckpt is not None:
        ckpt = os.path.abspath(ckpt)
    with _chdir(workdir):
        import jax
        from .manager import TrainingManager

        mgr = TrainingManager("input.toml")
        ds = mgr.dataset
        feats, labels = ds.build()
        tf_, tl_, ef_, el_ = ds.split(feats, labels)

        # group tag of every db row, in the same id order list(db) uses
        groups = np.asarray([_group_of(s.info.get("source", "ungrouped"))
                             for s in ds.db])
        # guard on TOTAL rows: a db changed after the cache was built
        # yields a different permutation entirely, and with an integer
        # test_size the test-row COUNT would still match — compare the
        # full lengths so mis-tagging cannot pass silently
        if len(groups) != len(labels["energy"]):
            raise RuntimeError(
                f"split mismatch: db has {len(groups)} rows but the "
                f"feature cache has {len(labels['energy'])} — the db "
                "changed after the cache was built (rebuild with "
                "force=True)")
        train_idx, test_idx = ds.split_indices(len(groups))
        tags = {"test": groups[test_idx], "train": groups[train_idx]}

        if ckpt is None:
            # newest NUMBERED checkpoint; ckpt-best.npz (the eval-best
            # model kept by BestCheckpointHook) is selected explicitly
            # via --ckpt, never implicitly
            cands = sorted(
                (p for p in glob.glob(
                    os.path.join(mgr.model_dir, "ckpt-*.npz"))
                 if re.search(r"ckpt-(\d+)\.npz$", p)),
                key=lambda p: int(p.split("-")[-1].split(".")[0]))
            if not cands:
                raise FileNotFoundError(
                    f"no ckpt-*.npz under {mgr.model_dir!r}")
            ckpt = cands[-1]
        ckpt = os.path.abspath(ckpt)
        tmpl = mgr.model.init_params(jax.random.PRNGKey(0))
        params, ema, step = mgr.trainer.load_checkpoint(ckpt, tmpl)
        eval_params = ema if use_ema else params
        if verbose:
            print(f"checkpoint step {step}: {ckpt}")

        out = {"step": int(step), "checkpoint": ckpt, "splits": {}}
        for split, (sf_all, sl_all) in (("test", (ef_, el_)),
                                        ("train", (tf_, tl_))):
            t = tags[split]
            row_tags = (sorted(set(t)) if per_group else []) + ["overall"]
            rows = {}
            for tag in row_tags:
                sel = (np.arange(len(t)) if tag == "overall"
                       else np.nonzero(t == tag)[0])
                sf = {k: v[sel] for k, v in sf_all.items()}
                sl = {k: v[sel] for k, v in sl_all.items()}
                ev = mgr.trainer.evaluate(eval_params, sf, sl)
                # None (json null), not NaN: bare NaN tokens make the
                # output unreadable by strict JSON parsers
                s_mae = ev.get("stress/mae")
                rows[tag] = {
                    "n": int(len(sel)),
                    "energy_meV_per_atom":
                        1000 * float(ev["energy/mae/atom"]),
                    "force_eV_A": float(ev["forces/mae"]),
                    "stress_GPa":
                        GPA * float(s_mae) if s_mae is not None else None,
                }
            out["splits"][split] = rows
            if verbose:
                print(f"-- {split} --")
                for tag, r in rows.items():
                    s = ("     — " if r["stress_GPa"] is None
                         else f"{r['stress_GPa']:6.3f}")
                    print(f"  {tag:18s} n={r['n']:3d} "
                          f"E {r['energy_meV_per_atom']:7.2f} meV/atom  "
                          f"F {r['force_eV_A']:6.3f} eV/A  "
                          f"S {s} GPa")
        if output:
            with open(output, "w") as f:
                json.dump(out, f, indent=1)
        return out
