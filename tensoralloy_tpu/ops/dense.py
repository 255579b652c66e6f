"""Dense per-atom neighbor layout: gathers in, matmuls out, NO scatters.

The flat pair path reduces with scatter-adds (`segment_sum`, scatter
densification). The featurizer instead builds the dense `[n_vap, nnl]`
layout on the HOST (`pair_j_d`/`pair_shift_d`/`pair_mask_d`/
`pair_islot_d`, triples likewise); on device the forward pass is
gathers (`positions[pair_j_d]`) + elementwise filters + a batched
matmul over the neighbor axis:

    G[a, s, t] = sum_j sel[a, j, s] v[a, j, t]  =  sel_d^T @ v_d

The only scatter left in the whole pipeline is the force backward
(gather transpose, [A, N, 3] -> [A, 3] — tiny). Replaces the
reference's scatter-into-dense-g-tensor (`universal.py:583-620`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .pairs import safe_norm

# Periodic-image triples are PACKED into one int32 per pair slot
# (`pair_simg_d`): one [A, N] int32 keeps every dense feature 2-D, so
# padding/sharding/batching machinery needs no [*, 3] special cases
# and nothing on device ever gathers a [*, 3] shift array.
SIMG_BASE = 31
SIMG_OFF = 15          # components must lie in [-15, 15]
SIMG_ZERO = SIMG_OFF * (1 + SIMG_BASE + SIMG_BASE * SIMG_BASE)


def encode_simg_np(shift) -> np.ndarray:
    """numpy [*, 3] integer image counts -> packed int32 [*]."""
    s = np.asarray(np.rint(shift), np.int64)
    if s.size and (np.abs(s) > SIMG_OFF).any():
        raise ValueError(
            f"periodic image count exceeds +-{SIMG_OFF}: "
            f"{np.abs(s).max()} (cell too small for this cutoff)")
    return ((s[..., 0] + SIMG_OFF)
            + SIMG_BASE * (s[..., 1] + SIMG_OFF)
            + SIMG_BASE * SIMG_BASE * (s[..., 2] + SIMG_OFF)
            ).astype(np.int32)


def decode_simg(simg, dtype):
    """packed int32 [*] -> (sx, sy, sz) float [*] components."""
    sx = simg % SIMG_BASE - SIMG_OFF
    rest = simg // SIMG_BASE
    sy = rest % SIMG_BASE - SIMG_OFF
    sz = rest // SIMG_BASE - SIMG_OFF
    return (sx.astype(dtype), sy.astype(dtype), sz.astype(dtype))


def shift_dot_cell(simg, cell, dtype):
    """packed images -> cartesian offset components (sv_x, sv_y, sv_z):
    sv = s @ cell done per component so no [*, 3] array exists."""
    sx, sy, sz = decode_simg(simg, dtype)
    return tuple(sx * cell[0, a] + sy * cell[1, a] + sz * cell[2, a]
                 for a in range(3))


def gather_vec(pos, jd, simg, cell, centers=None):
    """Per-pair vectors r_j + S @ cell - r_i as THREE [A, N] component
    arrays — the structure-of-arrays form every dense consumer uses.
    `centers` (row-chunked evaluation) defaults to `pos`.

    The neighbor positions are fetched with ONE row gather `pos[jd]`
    and sliced into components afterwards, rather than one gather per
    component (`pos[:, a][jd]`)."""
    c = pos if centers is None else centers
    dtype = pos.dtype
    sv = shift_dot_cell(simg, cell, dtype)
    if GATHER_LAYOUT == "t":
        return tuple(
            v + sv[a] - c[:, a][:, None]
            for a, v in enumerate(_row_gather_t(pos, jd)))
    g = pos[jd]                                    # [A, N, 3] row gather
    return tuple(g[..., a] + sv[a] - c[:, a][:, None]
                 for a in range(3))


# Layout of the neighbor-position row gather inside `gather_vec`:
#   'row' — `pos[jd]` -> [A, N, 3] (the default).
#   't'   — explicit `lax.gather` with offset_dims=(1,) -> [A, 3, N]:
#           the neighbor axis is minor.
# Both return the same (vx, vy, vz) component tuple (parity pinned in
# test_backends.py); never measured on a GPU, the switch goes or stays
# on a measurement.
GATHER_LAYOUT = "row"


def _row_gather_t(pos, jd):
    """out[i, c, k] = pos[jd[i, k], c] as three [A, N] slices of an
    [A, 3, N]-layout gather (no lane-padded [A, N, 3] intermediate)."""
    from jax import lax
    dn = lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,),
        start_index_map=(0,))
    g = lax.gather(pos, jd[..., None], dn,
                   slice_sizes=(1, pos.shape[1]))
    return tuple(g[:, a, :] for a in range(pos.shape[1]))


def convert_legacy_shifts(feats: dict) -> dict:
    """HOST-side upgrade of a pre-simg feature dict / npz cache: float
    [A, N, 3] shift arrays -> packed int32 [A, N] (`*_simg_*`).
    No-op when the packed keys already exist."""
    for old, new in (("pair_shift_d", "pair_simg_d"),
                     ("trip_shift_j_d", "trip_simg_j_d"),
                     ("trip_shift_k_d", "trip_simg_k_d")):
        if old in feats and new not in feats:
            feats[new] = encode_simg_np(np.asarray(feats.pop(old)))
    return feats


def dense_pair_geometry(features):
    """-> (rij_d [A, N], (ux, uy, uz) [A, N] each, islotf_d, mask_d).

    Padding entries (mask 0) carry FINITE garbage geometry (they alias
    the virtual-atom row): every consumer must multiply by the mask (or
    a mask-carrying selector) before reducing, which also zeroes their
    gradients.
    """
    if "pair_j_d" not in features:
        raise KeyError(
            "features lack the dense pair layout ('pair_j_d' ...) — "
            "re-featurize with this version to use the dense "
            "descriptor backends")
    pos = features["positions"]
    cell = features["cell"]
    mask = features["pair_mask_d"]
    if "pair_vec_d" in features:
        # vector-fed evaluation (`make_dense_efs_fn`): the caller
        # differentiates the energy w.r.t. THESE component arrays and
        # assembles forces with the transpose table — positions stay
        # out of the graph, so the backward has no gather-VJP scatter
        vec = features["pair_vec_d"]          # (vx, vy, vz) tuple
    else:
        # row-chunked evaluation (AtomicNN.energy_chunked) passes the
        # block's center rows separately; gathers use full positions
        vec = gather_vec(pos, features["pair_j_d"],
                         features["pair_simg_d"], cell,
                         features.get("positions_rows"))
    rij = safe_norm_components(vec)
    rij = jnp.where(mask > 0, rij, 1.0)
    unit = tuple(v / rij for v in vec)
    return rij, unit, features["pair_islot_d"], mask


def safe_norm_components(vec, eps: float = 1e-14):
    """sqrt(vx^2 + vy^2 + vz^2 + eps) — identical numerics to
    `ops.pairs.safe_norm` on a stacked [..., 3] array."""
    return jnp.sqrt(vec[0] * vec[0] + vec[1] * vec[1]
                    + vec[2] * vec[2] + eps)


def dense_triple_geometry(features):
    """-> (rij_d, rik_d, rjk_d [A, Nt], aslotf_d, mask_d)."""
    if "trip_j_d" not in features:
        raise KeyError(
            "features lack the dense triple layout ('trip_j_d' ...) — "
            "re-featurize with this version to use the dense "
            "descriptor backends")
    pos = features["positions"]
    cell = features["cell"]
    mask = features["trip_mask_d"]

    def distv(v):
        return jnp.where(mask > 0, safe_norm_components(v), 1.0)

    if "trip_vec_j_d" in features:      # vector-fed (make_dense_efs_fn)
        vj = features["trip_vec_j_d"]
        vk = features["trip_vec_k_d"]
        return (distv(vj), distv(vk),
                distv(tuple(k - j for j, k in zip(vj, vk))),
                features["trip_aslot_d"], mask)
    centers = features.get("positions_rows")
    vj = gather_vec(pos, features["trip_j_d"], features["trip_simg_j_d"],
                    cell, centers)
    vk = gather_vec(pos, features["trip_k_d"], features["trip_simg_k_d"],
                    cell, centers)
    return (distv(vj), distv(vk),
            distv(tuple(k - j for j, k in zip(vj, vk))),
            features["trip_aslot_d"], mask)


def slot_onehot_dense(slotf: jnp.ndarray, mask: jnp.ndarray,
                      n_slots: int) -> jnp.ndarray:
    """[A, N, S] masked one-hot of the (float-carried) slot index."""
    eye = jnp.arange(n_slots, dtype=slotf.dtype)
    return (slotf[..., None] == eye) * mask[..., None]


def contract_slots(sel_d: jnp.ndarray, v_d: jnp.ndarray) -> jnp.ndarray:
    """G[a, s, t] = sum_j sel_d[a, j, s] v_d[a, j, t] (batched matmul)."""
    return jnp.einsum("ajs,ajt->ast", sel_d, v_d,
                      preferred_element_type=v_d.dtype)


def transpose_reduce(g, trans_idx: jnp.ndarray,
                     trans_mask: jnp.ndarray):
    """scatter-add(g by index table) expressed as a GATHER + row
    reduction via the host-built transpose table: out[a] =
    sum_c g.flat[trans_idx[a, c]] * trans_mask[a, c]. Exact — the
    table enumerates every slot whose index equals a (full directed
    lists guarantee the occurrence count of a as a neighbor equals a's
    own neighbor count, so the table is never wider than the source).
    `g` is a component tuple of [A, N] arrays; the components are
    stacked into one [A*N, 3] table fetched by a single ROW gather."""
    tab = jnp.stack([gc.reshape(-1) for gc in g], axis=-1)  # [A*N, 3]
    gt = tab[trans_idx]                                     # [A, C, 3]
    return tuple(jnp.sum(gt[..., c] * trans_mask, axis=1)
                 for c in range(len(g)))


def make_dense_efs_fn(energy_fn, extras_fn=None):
    """Scatter-free E+F+stress for DENSE-layout descriptor models
    (`make_rij_efs_fn`'s contract, generalized to the dense layout).

    The autodiff EFS (`make_efs_fn`) differentiates w.r.t. positions,
    so the VJP of `positions[pair_j_d]` lowers to a scatter-add. Here
    the energy is differentiated w.r.t. the pair (and
    triple) VECTORS instead; forces are then assembled exactly:

        dE/dpos_k = sum_{slots of row k} (-g)            (center side)
                  + sum_{slots pointing AT k} g          (neighbor side)

    with the neighbor side read through the featurizer's transpose
    table (`pair_trans_d`) — a gather + row reduction. The virial is
    sum g (x) v per slot, identical to gpos.T @ pos + gcell.T @ cell
    for minimum-image energies. Needs features from a featurizer that
    emits the transpose tables (host path; the device-NL builder does
    not yet)."""
    from ..nn.fields import full_to_voigt, EV_ANGSTROM3_TO_GPA, HIGHEST

    def efs(params, features):
        pos = features["positions"]
        cell = features["cell"]
        pv = gather_vec(pos, features["pair_j_d"],
                        features["pair_simg_d"], cell)
        angular = "trip_j_d" in features
        if angular and "trip_trans_j_d" not in features:
            # positions are NOT differentiated here — without the
            # triple transpose tables the 3-body force contributions
            # would be silently dropped
            raise KeyError(
                "features carry dense triples but no trip_trans "
                "tables — re-featurize with transpose=True")
        if "pair_trans_d" not in features:
            raise KeyError(
                "make_dense_efs_fn needs the featurizer's transpose "
                "tables — re-featurize with transpose=True")
        vecs = [pv]
        keys = ["pair_vec_d"]
        if angular:
            tvj = gather_vec(pos, features["trip_j_d"],
                             features["trip_simg_j_d"], cell)
            tvk = gather_vec(pos, features["trip_k_d"],
                             features["trip_simg_k_d"], cell)
            vecs += [tvj, tvk]
            keys += ["trip_vec_j_d", "trip_vec_k_d"]

        def e_of(*vs):
            f = dict(features)
            f.update(zip(keys, vs))
            return energy_fn(params, f)

        # each vec is a (vx, vy, vz) component tuple — jax
        # differentiates the pytree, so every gradient stays [A, N]
        energy, grads = jax.value_and_grad(
            e_of, argnums=tuple(range(len(keys))))(*vecs)

        def assemble(g, tidx, tmask):
            # center side is a row reduction, neighbor side reads the
            # transpose table (gather — no scatter anywhere)
            rev = transpose_reduce(g, tidx, tmask)
            return tuple(jnp.sum(gc, axis=1) - rc
                         for gc, rc in zip(g, rev))

        def outer_virial(g, vv):
            return jnp.stack(
                [jnp.stack([jnp.vdot(g[a], vv[b], precision=HIGHEST)
                            for b in range(3)])
                 for a in range(3)])

        g = grads[0]
        fc = assemble(g, features["pair_trans_d"],
                      features["pair_trans_mask_d"])
        virial = outer_virial(g, pv)
        if angular:
            for gi, vv, side in ((grads[1], tvj, "j"),
                                 (grads[2], tvk, "k")):
                fi = assemble(gi, features[f"trip_trans_{side}_d"],
                              features[f"trip_trans_{side}_mask_d"])
                fc = tuple(a + b for a, b in zip(fc, fi))
                virial = virial + outer_virial(gi, vv)
        forces = jnp.stack(fc, axis=-1)
        volume = jnp.maximum(jnp.abs(jnp.linalg.det(cell)), 1e-12)
        stress = virial / volume
        out = {"energy": energy, "forces": forces, "virial": virial,
               "stress": stress, "stress_voigt": full_to_voigt(stress),
               "total_pressure": -jnp.trace(stress) / 3.0
               * EV_ANGSTROM3_TO_GPA}
        if extras_fn is not None:
            out.update(extras_fn(params, features))
        return out

    return efs
