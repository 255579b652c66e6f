"""Scatter-free analytic E+F+stress for the EAM family (fast path).

Why this exists: the autodiff EFS (`nn/fields.make_efs_fn`) over the
flat pair layout is correct everywhere but lowers to scatter-adds
twice — the forward `segment_sum` over pairs and the VJP of the
per-pair position gathers — and it keeps O(npairs) autodiff
residuals.  The EAM family needs no autodiff at all: every model in
the family is

    E = sum_i F_i(A_i),   A_i = sum_{j in row i} a(v_ij; e_i, e_j)

with per-atom accumulators A (rho; and mu/lambda for ADP) and an
elementwise finalize F.  Forces then have a closed form that reads
only *row-local* data plus gathers of per-atom adjoints:

    dE/dpos_k = sum_{j in row k} [ ct_{jk}(-v_kj) - ct_{kj}(v_kj) ]

where ct_{ij} = (d a_{ij} / d v_ij)^T g_i is the per-pair cotangent
through the CENTER's accumulators and g_i = dE/dA_i is the per-atom
adjoint (elementwise autodiff of the finalize — no pair arrays
involved).  The reversed cotangent ct_{jk} is re-evaluated on row k
from the same geometry (full directed neighbor lists contain both
(k,j) and (j,k); same r, swapped element roles, gathered g_j) — this
replaces the transpose scatter with a second elementwise pass.

The virial needs no reversal: each directed pair's ct (x) v lands in
its own row, so W = sum_rows sum_cols ct_self (x) v, matching
`make_efs_fn`'s gpos.T @ pos + gcell.T @ cell identity exactly.

Everything is gathers, dense row reductions, and elementwise math on
the HOST-BUILT (or device-NL) dense layout [n_vap, nnl] — zero
scatters in forward OR backward, because there is no backward.

Parity: bit-level-close (f64 1e-10) to the autodiff path for
alloy/fs/adp, empirical and MLP functions, multi-element bucketed VAP
padding, non-orthogonal cells — `tests/test_fast_efs.py`.

Reference context: the reference's analogous hot path is its
TF graph of `basic.py:276-421` (autodiff).
"""
from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import full_to_voigt, EV_ANGSTROM3_TO_GPA
from ...ops.dense import gather_vec, safe_norm_components


def _val_and_deriv(f: Callable, r: jnp.ndarray):
    """(f(r), f'(r)) for an elementwise scalar function via one VJP —
    exact for both empirical forms and pointwise MLPs, and free of
    pair-indexed scatters (an MLP's VJP is just transposed matmuls)."""
    val, pullback = jax.vjp(f, r)
    return val, pullback(jnp.ones_like(val))[0]


def _make_pass(model) -> Callable:
    """Core analytic pass: (params, features) -> dict with
    atomic_energies, forces, virial, and the OWNER-anchored per-slot
    cotangents ct_self = dE/d v_kj through row k's accumulators
    (exactly the g_q of `analysis/heatflux.py`'s operator), plus v —
    shared by the EFS and heat-flux builders."""
    rcut = model.featurizer.rcut
    elements = model.elements
    is_adp = model.tag == "adp"
    is_fs = model.tag == "fs"

    def run(params, features) -> Dict[str, jnp.ndarray]:
        pos = features["positions"]            # [n_vap, 3]
        cell = features["cell"]
        jd = features["pair_j_d"]              # [n_vap, nnl] int32
        mask = features["pair_mask_d"]         # [n_vap, nnl]
        am = features["atom_masks"]            # [n_vap]
        n_vap = pos.shape[0]

        # per-pair vectors as a (vx, vy, vz) COMPONENT tuple of
        # [n_vap, nnl] arrays: the elementwise math is structure-of-
        # arrays, but the position FETCH is one row gather, so every
        # per-pair lookup below rides a [n_vap, C] row-gather table.
        elem_np = np.asarray(model.vap_element_idx)
        n_el = len(elements)
        dtype = pos.dtype
        if n_el == 1:
            v = gather_vec(pos, jd, features["pair_simg_d"], cell)
            ej_eq = lambda b: np.bool_(b == 0)
            ut = None
        else:
            # the neighbor-element lookup rides the SAME row gather as
            # the positions (column 3 of the table)
            from ...ops import dense as _od
            sv = _od.shift_dot_cell(features["pair_simg_d"], cell,
                                    dtype)
            ptab = jnp.concatenate(
                [pos, jnp.asarray(elem_np, dtype)[:, None]], axis=1)
            if _od.GATHER_LAYOUT == "t":
                cols = _od._row_gather_t(ptab, jd)   # 4x [n_vap, nnl]
                v = tuple(cols[a] + sv[a] - pos[:, a][:, None]
                          for a in range(3))
                ejf = cols[3]
            else:
                g = ptab[jd]                   # [n_vap, nnl, 4]
                v = tuple(g[..., a] + sv[a] - pos[:, a][:, None]
                          for a in range(3))
                ejf = g[..., 3]
            ej_eq = lambda b: ejf == np.asarray(b, dtype)
            # k-body term of each pair, assembled ELEMENTWISE from a
            # per-atom row (no [n_el, n_el]-operand per-pair gather)
            trow = jnp.asarray(model._uterm_table)[
                jnp.asarray(elem_np)]          # [n_vap, n_el]
            ut = jnp.zeros(jd.shape, jnp.int32)
            for b in range(n_el):
                ut = jnp.where(ej_eq(b), trow[:, b][:, None], ut)
        r = safe_norm_components(v)            # [n_vap, nnl]
        r = jnp.where(mask > 0, r, 1.0)
        mask = mask * (r < rcut).astype(mask.dtype)
        u = tuple(vc / r for vc in v)

        ei = jnp.asarray(elem_np)[:, None]     # [n_vap, 1] broadcasts
        ut_eq = ((lambda t: np.bool_(
            int(model._uterm_table[0, 0]) == t)) if ut is None
            else (lambda t: ut == t))

        # ---- per-pair function values + radial derivatives ----------
        # rho: 'self' = a_{kj} (center k), 'rev' = a_{jk} (center j).
        rho_p = jnp.zeros_like(r)
        drho_self = jnp.zeros_like(r)
        drho_rev = jnp.zeros_like(r)
        if is_fs:
            for a_i, a in enumerate(elements):
                for b_i, b in enumerate(elements):
                    if model.max_occurs.get(a, 0) == 0 or \
                            model.max_occurs.get(b, 0) == 0:
                        continue
                    val, der = _val_and_deriv(
                        model._fn(params, a + b, "rho", "rho"), r)
                    sel_s = (ei == a_i) & ej_eq(b_i)
                    sel_r = ej_eq(a_i) & (ei == b_i)
                    rho_p = rho_p + jnp.where(sel_s, val, 0.0)
                    drho_self = drho_self + jnp.where(sel_s, der, 0.0)
                    drho_rev = drho_rev + jnp.where(sel_r, der, 0.0)
        else:
            for e_i, e in enumerate(elements):
                if model.max_occurs.get(e, 0) == 0:
                    continue
                val, der = _val_and_deriv(
                    model._fn(params, e, "rho", "rho"), r)
                # alloy: rho depends on the NEIGHBOR element only
                rho_p = rho_p + jnp.where(ej_eq(e_i), val, 0.0)
                drho_self = drho_self + jnp.where(ej_eq(e_i), der, 0.0)
                drho_rev = drho_rev + jnp.where(ei == e_i, der, 0.0)

        phi_p = jnp.zeros_like(r)
        dphi = jnp.zeros_like(r)
        for t, term in enumerate(model.unique_kbody_terms):
            if not model._term_possible(term):
                continue
            val, der = _val_and_deriv(
                model._fn(params, term, "phi", "phi"), r)
            sel = ut_eq(t)
            phi_p = phi_p + jnp.where(sel, val, 0.0)
            dphi = dphi + jnp.where(sel, der, 0.0)

        # ---- accumulators (dense row reductions, no scatter) --------
        rho_i = jnp.sum(rho_p * mask, axis=1)
        phi_i = 0.5 * jnp.sum(phi_p * mask, axis=1)

        # per-atom embed + adjoint dE/drho (elementwise autodiff)
        embed_i, emb_pullback = jax.vjp(
            lambda rho: model._embed_energy(params, rho), rho_i)
        g_rho = emb_pullback(am)[0]

        atomic_e = (embed_i + phi_i) * am
        # per-atom adjoints fetched through ONE row gather (1D-operand
        # per-pair gathers serialize; probe_fast_efs — stage 'forces'
        # was 0.43 s of the old 1.0 s pass)
        gt = jnp.stack([g_rho, am], axis=-1)[jd]   # [n_vap, nnl, 2]
        g_rho_j = gt[..., 0]
        am_j = gt[..., 1]

        # ---- radial force/virial coefficients ------------------------
        w_self = g_rho[:, None] * drho_self + 0.5 * am[:, None] * dphi
        w_rev = g_rho_j * drho_rev + 0.5 * am_j * dphi
        w_self = w_self * mask
        w_rev = w_rev * mask
        # forces[k] = sum_row (w_self + w_rev) u ; ct_self = w_self u
        # (per component: forces_c [n_vap], ct_self [n_vap, nnl] x 3)
        w_tot = w_self + w_rev
        forces_c = [jnp.sum(w_tot * uc, axis=1) for uc in u]
        ct_self = [w_self * uc for uc in u]

        if is_adp:
            ut_arr = (jnp.zeros(jd.shape, jnp.int32) if ut is None
                      else ut)
            adp_e, ct_a_self, ct_a_rev = _adp_terms(
                model, params, features, v, r, u, mask, ut_arr, am, jd,
                n_vap)
            atomic_e = atomic_e + adp_e * am
            forces_c = [fc + jnp.sum(cs - cr, axis=1)
                        for fc, cs, cr in zip(forces_c, ct_a_self,
                                              ct_a_rev)]
            ct_self = [c + cs for c, cs in zip(ct_self, ct_a_self)]

        # virial[a, b] = sum ct_self[a] v[b]
        virial = jnp.stack(
            [jnp.stack([jnp.vdot(ct_self[a], v[b]) for b in range(3)])
             for a in range(3)])
        forces = jnp.stack(forces_c, axis=-1)  # [n_vap, 3] — tiny
        energy = jnp.sum(atomic_e)
        volume = jnp.maximum(jnp.abs(jnp.linalg.det(cell)), 1e-12)
        stress = virial / volume
        return {"energy": energy, "atomic_energies": atomic_e,
                "forces": forces, "virial": virial, "stress": stress,
                "ct_self": tuple(ct_self), "v": v}

    return run


def make_fast_efs_fn(model, extras_fn: Callable = None) -> Callable:
    """fn(params, features) -> same dict contract as `make_efs_fn`
    (energy, forces, virial, stress, stress_voigt, total_pressure)
    plus 'atomic_energies', computed WITHOUT autodiff over pair arrays.

    Requires the dense layout ('pair_j_d' / 'pair_simg_d' /
    'pair_mask_d'); raises KeyError otherwise.
    """
    core = _make_pass(model)

    def efs(params, features) -> Dict[str, jnp.ndarray]:
        o = core(params, features)
        stress = o["stress"]
        out = {"energy": o["energy"],
               "atomic_energies": o["atomic_energies"],
               "forces": o["forces"], "virial": o["virial"],
               "stress": stress,
               "stress_voigt": full_to_voigt(stress),
               "total_pressure": -jnp.trace(stress) / 3.0
               * EV_ANGSTROM3_TO_GPA}
        if extras_fn is not None:
            out.update(extras_fn(params, features))
        return out

    return efs


def make_fast_heat_flux_fn(model) -> Callable:
    """Analytic (scatter-free) many-body heat flux on the dense layout
    — the SAME operator as `analysis/heatflux.make_heat_flux_fn`
    (J = sum_i (E_i + K_i) v_i - sum_q d_q (g_q . v_n(q)), Hardy/Fan
    form with owner-anchored attribution), with g_q = ct_self computed
    analytically instead of by autodiff: EAM-family Green-Kubo
    production never touches an XLA scatter.

    fn(params, features, velocities [n_vap, 3], masses [n_vap]) ->
    {"J", "J_convective", "J_virial", "energy", "atomic_energies"}.
    """
    from ...dynamics import FORCE_TO_ACC
    core = _make_pass(model)

    def flux(params, features, velocities, masses):
        o = core(params, features)
        ae = o["atomic_energies"]
        am = features["atom_masks"]
        kin = 0.5 * masses * jnp.sum(jnp.square(velocities), axis=-1) \
            / FORCE_TO_ACC
        conv = jnp.sum((ae + kin * am)[:, None] * velocities, axis=0)
        # neighbor velocities through ONE row gather, sliced into
        # components (per-component 1D-operand gathers serialize when
        # fused — probe_fast_efs3); ct.vel contracted first, then
        # dotted with v
        jd = features["pair_j_d"]
        vg = velocities[jd]                       # [n_vap, nnl, 3]
        ct_dot_vel = sum(ct * vg[..., a]
                         for a, ct in enumerate(o["ct_self"]))
        jv = -jnp.stack([jnp.vdot(o["v"][b], ct_dot_vel)
                         for b in range(3)])
        return {"J": conv + jv, "J_convective": conv, "J_virial": jv,
                "energy": o["energy"], "atomic_energies": ae}

    return flux


def _adp_terms(model, params, features, v, r, u, mask, ut, am, jd,
               n_vap):
    """ADP dipole/quadrupole energy + analytic forces/virial.

    a_mu = u_t(r) v  (per k-body term t),  a_lam = w_t(r) v (x) v.
    Cotangents through the center's moments (m = g_mu, L = g_lam):
      ct_mu(m)  = u'(r) (m . v) u + u_t(r) m
      ct_lam(L) = w'(r) (L : vv) u + 2 w_t(r) L v
    Reversed-pair cotangents evaluate at v_jk = -v with gathered
    adjoints: the mu form is EVEN under the flip (both sign changes
    cancel), the lam form is ODD — signs below carry a parity test
    against the autodiff path (`test_fast_efs.py`).

    `v`/`u` arrive as component tuples; ADP's moment algebra is
    genuinely tensorial, so they are stacked to [*, 3] HERE (ADP
    production cells are small — the (8, 128) padding tax on these
    elementwise temps is tolerable, unlike on the main pass's
    gathers); the returned cotangents are component tuples again."""
    n_ut = len(model.unique_kbody_terms)
    per_term = model.adp_per_term
    v = jnp.stack(v, axis=-1)              # [n_vap, nnl, 3]
    u = jnp.stack(u, axis=-1)

    u_p = jnp.zeros_like(r)
    du_p = jnp.zeros_like(r)
    w_p = jnp.zeros_like(r)
    dw_p = jnp.zeros_like(r)
    for t, term in enumerate(model.unique_kbody_terms):
        if not model._term_possible(term):
            continue
        sel = ut == t
        val, der = _val_and_deriv(
            model._fn(params, term, "dipole", "dipole"), r)
        u_p = u_p + jnp.where(sel, val, 0.0)
        du_p = du_p + jnp.where(sel, der, 0.0)
        val, der = _val_and_deriv(
            model._fn(params, term, "quadrupole", "quadrupole"), r)
        w_p = w_p + jnp.where(sel, val, 0.0)
        dw_p = dw_p + jnp.where(sel, der, 0.0)
    u_p = u_p * mask
    w_p = w_p * mask

    # moments per (atom, term) — [n_vap, n_ut, 3] / [n_vap, n_ut, 3, 3]
    # (per_term=False folds the term axis to 1)
    n_groups = n_ut if per_term else 1
    tsel = (jax.nn.one_hot(ut, n_ut, dtype=r.dtype) if per_term
            else jnp.ones(r.shape + (1,), r.dtype))   # [n_vap,nnl,G]
    mu = jnp.einsum("knt,kn,kna->kta", tsel, u_p, v)
    dd = v[..., :, None] * v[..., None, :]            # [n_vap,nnl,3,3]
    lam = jnp.einsum("knt,kn,knab->ktab", tsel, w_p, dd)

    def quad_energy(mu_, lam_):
        e_mu = 0.5 * jnp.sum(jnp.square(mu_), axis=-1)
        e_lam = 0.5 * jnp.sum(jnp.square(lam_), axis=(-1, -2))
        nu = jnp.trace(lam_, axis1=-2, axis2=-1)
        return jnp.sum(e_mu + e_lam - jnp.square(nu) / 6.0, axis=-1)

    adp_e, pullback = jax.vjp(quad_energy, mu, lam)
    g_mu, g_lam = pullback(am)                        # per-atom adjoints

    # adjoints at the center and at the neighbor, selected per pair's
    # k-body term by the same one-hot contraction (gathers + einsum —
    # no take_along_axis shape traps, fuses into the pair loop)
    m_self = jnp.einsum("knt,kta->kna", tsel, g_mu)
    L_self = jnp.einsum("knt,ktab->knab", tsel, g_lam)
    m_rev = jnp.einsum("knt,knta->kna", tsel, g_mu[jd])
    L_rev = jnp.einsum("knt,kntab->knab", tsel, g_lam[jd])

    def ct_mu(m):
        return (du_p * jnp.sum(m * v, axis=-1))[..., None] * u \
            + u_p[..., None] * m

    def ct_lam(L):
        lvv = jnp.einsum("knab,kna,knb->kn", L, v, v)
        return (dw_p * lvv)[..., None] * u \
            + 2.0 * w_p[..., None] * jnp.einsum("knab,knb->kna", L, v)

    ct_self = (ct_mu(m_self) + ct_lam(L_self)) * mask[..., None]
    # reversed pair: mu form even under v -> -v, lam form odd.
    # ct_rev is the cotangent of pair (j,k) w.r.t. v_jk mapped through
    # dv_jk/dpos_k = +1, already expressed in row-k geometry; the
    # caller assembles forces[k] = sum_row (ct_self - ct_rev).
    ct_rev = (ct_mu(m_rev) - ct_lam(L_rev)) * mask[..., None]
    return (adp_e,
            tuple(ct_self[..., a] for a in range(3)),
            tuple(ct_rev[..., a] for a in range(3)))
