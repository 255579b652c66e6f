"""Device-resident nudged elastic band (NEB).

The reference delegates NEB to a replica-enabled LAMMPS build through
deck generation (`/root/reference/tensoralloy/analysis/lammps/calcs.py`);
here the trained potential is a jittable function, so the whole band
relaxes ON the device: every replica's energy/forces come from ONE
`jax.vmap`-batched evaluation (replicas are just a leading batch
axis), and the FIRE damped-dynamics optimizer runs inside
`jax.lax.scan` with the host only rebuilding the (skinned) neighbor
lists between chunks.

Implements the improved tangent estimate and the climbing-image method
(Henkelman & Jonsson, J. Chem. Phys. 113, 9901/9978 (2000)).

Units follow the rest of the package: A, eV, eV/A.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .atoms import Structure, minimum_image


def interpolate_band(initial: Structure, final: Structure,
                     n_images: int) -> np.ndarray:
    """[M, N, 3] linear path (minimum-image) incl. both endpoints."""
    if list(initial.symbols) != list(final.symbols):
        raise ValueError("initial/final stoichiometry-order mismatch")
    d = minimum_image(final.positions - initial.positions, initial.cell)
    s = np.linspace(0.0, 1.0, n_images)[:, None, None]
    return initial.positions[None] + s * d[None]


class NEB:
    """Nudged-elastic-band barrier search with a trained model.

    Parameters
    ----------
    model, params : any model exposing ``variational_energy`` (AtomicNN,
        EAM family, finite-T) and its parameter pytree.
    initial, final : endpoint `Structure`s (same cell, same symbol
        order; pre-relax them first).
    n_images : total replicas including the two fixed endpoints.
    k : spring constant (eV/A^2) between adjacent replicas.
    climb : turn the highest interior replica into a climbing image
        (no spring; tangential true force inverted) so it converges
        onto the saddle point.
    n_shards : shard the replica axis over the first `n_shards`
        devices of a 1-D `jax.sharding.Mesh` (the reference's analog
        is LAMMPS `-partition Mx1` replica parallelism over MPI;
        here the band arrays carry a `NamedSharding` and XLA's SPMD
        partitioner inserts the collective-permutes the tangent /
        spring terms and the band-wide FIRE reductions need — same
        math, zero re-implementation). `n_images` must be divisible
        by `n_shards`.
    """

    def __init__(self, model, params, initial: Structure,
                 final: Structure, n_images: int = 9, k: float = 5.0,
                 climb: bool = True, skin: float = 0.5,
                 chunk_size: int = 25, n_shards: int = 1):
        if n_images < 3:
            raise ValueError("need at least 3 images")
        if n_shards > 1:
            if n_images % n_shards:
                raise ValueError(
                    f"n_images={n_images} not divisible by "
                    f"n_shards={n_shards}")
            if n_shards > len(jax.devices()):
                raise ValueError(
                    f"n_shards={n_shards} > {len(jax.devices())} "
                    "available devices")
            from jax.sharding import Mesh
            self.mesh = Mesh(
                np.array(jax.devices()[:n_shards]), ("rep",))
        else:
            self.mesh = None
        self.params = params
        self.k = float(k)
        self.climb = bool(climb)
        self.skin = float(skin)
        self.chunk_size = int(chunk_size)
        self.cell = initial.cell.copy()
        self.template = initial.copy()

        self.model = model.clone_for(Counter(initial.symbols))
        # EAM-family bands evaluate through the scatter-free analytic
        # EFS (`nn/eam/fast_efs.py`) — same exact physics, no autodiff
        # over pair arrays (matters for large-cell barriers).
        from .calculator import is_eam_family
        self._use_fast_efs = is_eam_family(self.model)
        self.fz = model.featurizer
        self.vap = self.fz.make_vap(initial, Counter(initial.symbols))

        # [M, N, 3] local-order path
        self.positions = interpolate_band(initial, final, n_images)
        self.n_images = n_images
        self._scan = None
        self._shapes_key = None
        self._fire_state = None
        self.energies: Optional[np.ndarray] = None
        self.last_sharding = None

    # ------------------------------------------------------------------
    def _featurize_band(self):
        """Stack per-image features along a leading replica axis."""
        from .calculator import model_feature_layout
        layout = model_feature_layout(self.model,
                                      fast=self._use_fast_efs)
        dtype = (np.float64 if jax.config.jax_enable_x64
                 else np.float32)
        pad = lambda n: max(64, 1 << int(np.ceil(np.log2(max(n, 1)))))
        wpad = lambda n: max(32, 1 << int(np.ceil(np.log2(max(n, 1)))))
        old_rcut = self.fz.rcut
        per_image = []
        try:
            self.fz.rcut = old_rcut + self.skin
            for m in range(self.n_images):
                s = self.template.copy()
                s.positions = self.positions[m]
                per_image.append(self.fz.featurize(
                    s, self.vap, pair_bucket=pad, trip_bucket=pad,
                    nnl_bucket=wpad, ntl_bucket=wpad,
                    dtype=dtype, layout=layout))
            keys = per_image[0].keys()
            shapes = {k: tuple(np.maximum.reduce(
                [np.asarray(f[k]).shape for f in per_image]))
                for k in keys if np.asarray(per_image[0][k]).ndim}
            if any(np.asarray(f[k]).shape != shapes[k]
                   for f in per_image for k in shapes):
                # rare: replicas fell in different buckets — refeaturize
                # against the band-wide maxima so the stack is regular
                maxima = {}
                if "pair_mask" in shapes:
                    maxima["nij_max"] = shapes["pair_mask"][0]
                if "trip_mask" in shapes:
                    maxima["nijk_max"] = shapes["trip_mask"][0]
                if "pair_mask_d" in shapes:
                    maxima["nnl_max"] = shapes["pair_mask_d"][1]
                if "trip_mask_d" in shapes:
                    maxima["ntl_max"] = shapes["trip_mask_d"][1]
                per_image = []
                for m in range(self.n_images):
                    s = self.template.copy()
                    s.positions = self.positions[m]
                    per_image.append(self.fz.featurize(
                        s, self.vap, dtype=dtype, layout=layout,
                        **maxima))
        finally:
            self.fz.rcut = old_rcut
        return {k: jnp.asarray(np.stack([np.asarray(f[k])
                                         for f in per_image]))
                for k in per_image[0].keys()}

    # ------------------------------------------------------------------
    def _make_scan(self):
        model, params, kspr = self.model, self.params, self.k
        climb = self.climb
        M = self.n_images
        cell = jnp.asarray(self.cell)
        inv_cell = jnp.asarray(np.linalg.inv(self.cell))
        # move only real atoms of interior replicas
        move = np.ones((M, 1, 1))
        move[0] = move[-1] = 0.0
        move = jnp.asarray(move)

        if self._use_fast_efs:
            from .nn.eam.fast_efs import make_fast_efs_fn
            fast_fn = make_fast_efs_fn(model)

            def energy_forces(feats, pos):
                def one(f, p):
                    o = fast_fn(params, dict(f, positions=p))
                    return o["energy"], o["forces"]
                e, fr = jax.vmap(one)(feats, pos)
                mask = feats["atom_masks"][..., None]
                return e, fr * mask
        else:
            def energy_forces(feats, pos):
                def one(f, p):
                    e = model.variational_energy(params,
                                                 dict(f, positions=p))
                    return e
                e, g = jax.vmap(jax.value_and_grad(one, argnums=1))(
                    feats, pos)
                mask = feats["atom_masks"][..., None]
                return e, -g * mask

        def mic(d):
            frac = d @ inv_cell
            return (frac - jnp.round(frac)) @ cell

        def band_force(feats, pos):
            """NEB effective force on every replica ([M,nvap,3])."""
            e, f = energy_forces(feats, pos)
            mask = feats["atom_masks"][..., None]
            # displacements to the next/previous replica (real atoms)
            d_next = mic(pos[1:] - pos[:-1]) * mask[:-1]    # [M-1]
            dot = lambda a, b: jnp.sum(a * b, axis=(-2, -1))
            norm = lambda a: jnp.sqrt(dot(a, a) + 1e-32)

            # improved tangent (Henkelman-Jonsson): per interior image
            e_prev, e_mid, e_next = e[:-2], e[1:-1], e[2:]
            t_plus = d_next[1:]                              # [M-2]
            t_minus = d_next[:-1]
            de_next = e_next - e_mid
            de_prev = e_mid - e_prev
            up = (e_next > e_mid) & (e_mid > e_prev)
            down = (e_next < e_mid) & (e_mid < e_prev)
            dmax = jnp.maximum(jnp.abs(de_next), jnp.abs(de_prev))
            dmin = jnp.minimum(jnp.abs(de_next), jnp.abs(de_prev))
            w_hi = jnp.where(e_next > e_prev, dmax, dmin)[:, None, None]
            w_lo = jnp.where(e_next > e_prev, dmin, dmax)[:, None, None]
            tau = jnp.where(up[:, None, None], t_plus,
                            jnp.where(down[:, None, None], t_minus,
                                      t_plus * w_hi + t_minus * w_lo))
            tau = tau / norm(tau)[:, None, None]

            f_mid = f[1:-1]
            f_par = dot(f_mid, tau)[:, None, None] * tau
            f_spring = (kspr * (norm(t_plus) -
                                norm(t_minus))[:, None, None] * tau)
            f_neb = f_mid - f_par + f_spring
            if climb:
                i_max = jnp.argmax(e_mid)
                one_hot = (jnp.arange(M - 2) == i_max)[:, None, None]
                f_climb = f_mid - 2.0 * f_par
                f_neb = jnp.where(one_hot, f_climb, f_neb)
            full = jnp.zeros_like(pos).at[1:-1].set(f_neb)
            return e, full * move * mask

        # FIRE (Bitzek et al., PRL 97, 170201) on the whole band
        f_inc, f_dec, alpha0, f_alpha = 1.1, 0.5, 0.1, 0.99
        n_min, dt_max, maxstep = 5, 0.25, 0.2

        def fire_step(carry, _):
            pos, vel, dt, alpha, n_up, feats = carry
            e, force = band_force(feats, pos)
            p = jnp.sum(force * vel)
            fn = jnp.sqrt(jnp.sum(force * force) + 1e-32)
            vn = jnp.sqrt(jnp.sum(vel * vel) + 1e-32)
            vel = jnp.where(p > 0,
                            (1 - alpha) * vel + alpha * vn * force / fn,
                            jnp.zeros_like(vel))
            grow = (p > 0) & (n_up >= n_min)
            dt = jnp.where(grow, jnp.minimum(dt * f_inc, dt_max),
                           jnp.where(p > 0, dt, dt * f_dec))
            alpha = jnp.where(grow, alpha * f_alpha,
                              jnp.where(p > 0, alpha, alpha0))
            n_up = jnp.where(p > 0, n_up + 1, 0)
            vel = vel + dt * force
            dr = dt * vel
            steplen = jnp.sqrt(jnp.sum(dr * dr, axis=-1,
                                       keepdims=True) + 1e-32)
            dr = dr * jnp.minimum(1.0, maxstep / steplen)
            return (pos + dr, vel, dt, alpha, n_up, feats), None

        def chunk(pos, vel, dt, alpha, n_up, feats, n):
            (pos, vel, dt, alpha, n_up, _), _ = jax.lax.scan(
                fire_step, (pos, vel, dt, alpha, n_up, feats), None,
                length=n)
            e, force = band_force(feats, pos)
            fmax = jnp.sqrt(
                jnp.max(jnp.sum(force * force, axis=-1)))
            return pos, vel, dt, alpha, n_up, e, fmax

        return jax.jit(chunk, static_argnames="n")

    # ------------------------------------------------------------------
    def _eval_chunk(self, vel, dt, alpha, n_up, n):
        """Featurize the CURRENT band, run `n` FIRE steps, return the
        end-of-chunk state. n=0 is a pure (fresh-list) band evaluation."""
        l2v = self.vap.local_to_vap
        feats = self._featurize_band()
        key = tuple((k,) + tuple(np.asarray(v).shape)
                    for k, v in sorted(feats.items()))
        if self._scan is None or key != self._shapes_key:
            self._scan = self._make_scan()
            self._shapes_key = key
        pos_vap = np.zeros(
            (self.n_images, self.model.n_atoms_vap, 3),
            dtype=np.asarray(feats["positions"]).dtype)
        pos_vap[:, l2v] = self.positions
        pos_in = jnp.asarray(pos_vap)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(self.mesh, P("rep"))
            feats = {k: jax.device_put(v, rep)
                     if np.asarray(v).ndim else v
                     for k, v in feats.items()}
            pos_in = jax.device_put(pos_in, rep)
            vel = jax.device_put(vel, rep)
        pos_j, vel, dt, alpha, n_up, e, f = self._scan(
            pos_in, vel, dt, alpha, n_up, feats, n)
        if self.mesh is not None and n > 0:
            # surface the sharding for tests/diagnostics
            self.last_sharding = pos_j.sharding
        self.positions = np.asarray(pos_j)[:, l2v]
        return vel, dt, alpha, n_up, np.asarray(e), float(f)

    def run(self, fmax: float = 0.05, max_steps: int = 1000) -> dict:
        """Relax the band; returns energies, barrier and convergence.

        The neighbor list is rebuilt between chunks; because replicas
        can drift within a chunk while the list is frozen, convergence
        is only declared after a re-evaluation on FRESH features (an
        n=0 chunk), and the reported energies always come from a fresh
        list."""
        vel = jnp.zeros((self.n_images, self.model.n_atoms_vap, 3))
        dt, alpha, n_up = jnp.asarray(0.1), jnp.asarray(0.1), \
            jnp.asarray(0)
        steps_done, converged = 0, False
        while steps_done < max_steps and not converged:
            n = min(self.chunk_size, max_steps - steps_done)
            vel, dt, alpha, n_up, energies, cur_fmax = \
                self._eval_chunk(vel, dt, alpha, n_up, n)
            steps_done += n
            if cur_fmax < fmax:
                # chunk-end forces used the chunk-start neighbor list;
                # confirm against a freshly built one before accepting
                _, _, _, _, energies, cur_fmax = self._eval_chunk(
                    vel, dt, alpha, n_up, 0)
                converged = cur_fmax < fmax
        if not converged:
            # honest final report: fresh-list energies and fmax
            _, _, _, _, energies, cur_fmax = self._eval_chunk(
                vel, dt, alpha, n_up, 0)
        self.energies = energies
        i_top = 1 + int(np.argmax(energies[1:-1]))
        return {
            "energies": energies,
            "barrier": float(energies[i_top] - energies[0]),
            "reverse_barrier": float(energies[i_top] - energies[-1]),
            "delta_e": float(energies[-1] - energies[0]),
            "fmax": cur_fmax,
            "converged": bool(converged),
            "n_steps": steps_done,
            "saddle_index": i_top,
        }

    def saddle_structure(self) -> Structure:
        """The highest-energy replica as a Structure."""
        if self.energies is None:
            raise RuntimeError("run() first")
        i = 1 + int(np.argmax(self.energies[1:-1]))
        s = self.template.copy()
        s.positions = self.positions[i]
        return s
