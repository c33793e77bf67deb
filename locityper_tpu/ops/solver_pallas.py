"""Read-assignment annealer as one Pallas kernel for the GPU (Triton route).

The XLA chain (ops/solver._chain) makes one move per while-loop step, so
every step is at least one kernel launch with very little work in it.
Here one program runs TB chains, one chain per thread, for all of the
steps:

- each chain's state sits in device memory in chain-major rows: the
  assignment [C, R], the window depths [C, W], and the weight·lnBayes
  value at each window's current depth [C, W];
- a move reads and writes only the entries it touches, with indexed loads
  and stores, so it costs O(1) whatever the read and window counts;
- candidate feeds are [C, K, R] in valid-first permuted slot order, and
  the weight·lnBayes table is [C, W·D_TAB];
- random numbers come from a counter-based hash of (seed, chain, step,
  draw), so interpret mode on the CPU runs the same dynamics as the card.

Semantics follow ops/solver._chain: a random other valid candidate of a
random non-trivial read, Metropolis acceptance under linear cooling for
`anneal_steps`, then accept-improving polish.  `plato` adds the
reference's plateau freeze (stoch.rs:196-240).  The final likelihood is
recomputed from the end state.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .solver import (NEG, SolverConfig, _compact_valid, _gather_candidates,
                     _read_windows, _window_tables)

M16 = 0xFFFF
#: Chains per program (one per thread of a single warp).
CHAINS_PER_PROGRAM = 32
#: Steps between checks of the plateau exit.
PLATO_CHECK = 128


def _mix32(x):
    """lowbias32 integer hash (uint32 -> uint32)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def random_bits(seed, chain, step, draw: int):
    """Counter-based random bits for (seed, chain, step, draw); all
    arguments uint32 (draw a small static int)."""
    x = _mix32(step * np.uint32(4) + np.uint32(draw) + seed)
    return _mix32(x ^ (chain * np.uint32(0x9E3779B9)))


def uniform01(bits):
    """Uniform float32 in [0, 1) from the top 24 random bits."""
    return (bits >> np.uint32(8)).astype(jnp.int32).astype(jnp.float32) \
        * np.float32(1.0 / (1 << 24))


def randint(bits, bound):
    """Uniform int32 in [0, bound) (bound > 0)."""
    return jnp.minimum(
        (uniform01(bits) * bound.astype(jnp.float32)).astype(jnp.int32),
        bound - 1)


def _kernel(seed_ref, temp_ref, probs_ref, winpk_ref, vcount_ref, nt_ref,
            ntc_ref, wtab_ref, _assgn_in, _depth_in, _cache_in,
            assgn_ref, depth_ref, cache_ref,
            *, TB: int, n_steps: int, anneal_steps: int, dc: float,
            ac: float, D_TAB: int, plato: int, ln_init_prob: float):
    """State refs are aliased to their inputs and hold the initial state.
    plato > 0: a chain freezes after `plato` consecutive non-accepted
    (anneal) or non-improving (polish) moves, and the program exits once
    all its chains are frozen; differences within 1e-6·max|Δ| count as
    float noise (stoch.rs:27-29, scaled for float32)."""
    c = pl.program_id(0) * TB + jnp.arange(TB, dtype=jnp.int32)
    cu = c.astype(jnp.uint32)
    seed = seed_ref[0].astype(jnp.uint32)
    ntc = ntc_ref[c]
    start_temp = temp_ref[c]
    if plato:
        min_diff = jnp.maximum(
            start_temp * np.float32(-ln_init_prob * 1e-6), np.float32(1e-10))
    else:
        min_diff = jnp.zeros_like(start_temp)

    def step(s, stale):
        su = s.astype(jnp.uint32)
        r = nt_ref[c, randint(random_bits(seed, cu, su, 0), ntc)]
        cur = assgn_ref[c, r]
        vc = vcount_ref[c, r]
        i = 1 + randint(random_bits(seed, cu, su, 1), jnp.maximum(vc - 1, 1))
        new = jnp.where(i <= cur, i - 1, i)
        p_cur = probs_ref[c, cur, r]
        p_new = probs_ref[c, new, r]
        wp_cur = winpk_ref[c, cur, r]
        wp_new = winpk_ref[c, new, r]
        w1 = wp_cur & M16
        w2 = (wp_cur >> 16) & M16
        w3 = wp_new & M16
        w4 = (wp_new >> 16) & M16

        # Net depth change per distinct window, carried by its first
        # occurrence (assgn.rs:259-284).
        e21 = w2 == w1
        c1 = jnp.where(e21, -2, -1)
        c2 = jnp.where(e21, 0, -1)
        e31, e32 = w3 == w1, w3 == w2
        c3 = jnp.where(e31 | e32, 0, 1)
        c1 = c1 + e31.astype(jnp.int32)
        c2 = c2 + (~e31 & e32).astype(jnp.int32)
        e41, e42, e43 = w4 == w1, w4 == w2, w4 == w3
        c4 = jnp.where(e41 | e42 | e43, 0, 1)
        c1 = c1 + e41.astype(jnp.int32)
        c2 = c2 + (~e41 & e42).astype(jnp.int32)
        c3 = c3 + (~e41 & ~e42 & e43).astype(jnp.int32)

        moves = []
        d_depth = jnp.zeros((TB,), jnp.float32)
        for w, cw in ((w1, c1), (w2, c2), (w3, c3), (w4, c4)):
            d0 = depth_ref[c, w]
            d1 = jnp.clip(d0 + cw, 0, D_TAB - 1)
            new_v = wtab_ref[c, w * D_TAB + d1]
            d_depth = d_depth + jnp.where(cw == 0, 0.0,
                                          new_v - cache_ref[c, w])
            moves.append((w, cw, d0 + cw, new_v))
        delta = ac * (p_new - p_cur) + dc * d_depth

        s_rem = jnp.maximum(anneal_steps - s, 0).astype(jnp.float32)
        temp = start_temp * (s_rem / max(anneal_steps, 1))
        u = uniform01(random_bits(seed, cu, su, 2))
        diffm = delta - min_diff
        metro = (temp > 0) & (u <= jnp.exp(diffm / jnp.maximum(temp, 1e-30)))
        if plato:
            in_anneal = s < anneal_steps
            accept = ((in_anneal & ((diffm >= 0) | metro))
                      | (~in_anneal & (delta > min_diff))) & (stale < plato)
            stale = jnp.where(accept, 0, stale + 1)
        else:
            accept = (delta >= 0) | metro
        for w, cw, d_new, new_v in moves:
            upd = accept & (cw != 0)
            plgpu.store(depth_ref.at[c, w], d_new, mask=upd)
            plgpu.store(cache_ref.at[c, w], new_v, mask=upd)
        plgpu.store(assgn_ref.at[c, r], new, mask=accept)
        return stale

    stale0 = jnp.zeros((TB,), jnp.int32)
    if plato:
        def cond(carry):
            s, stale = carry
            return (s < n_steps) & (jnp.min(stale) < plato)

        def body(carry):
            s, stale = carry
            stale = jax.lax.fori_loop(
                s, jnp.minimum(s + PLATO_CHECK, n_steps), step, stale)
            return s + PLATO_CHECK, stale

        jax.lax.while_loop(cond, body, (jnp.int32(0), stale0))
    else:
        jax.lax.fori_loop(0, n_steps, step, stale0)


def _prepare_chains(key, genotypes, attempts, hap_prob, hap_mid,
                    unmapped_prob, pack_nwin, pack_regstart, pack_len, gc_at,
                    weight_at, bayes, cfg: SolverConfig, max_windows: int,
                    random_init: bool, k_eff: int | None = None,
                    init_assgn=None):
    """Chain-major kernel inputs (XLA, once per stage call).  The candidate
    gather and valid-first permutation depend only on the genotype and are
    computed once, then repeated across attempts; the tweaked window
    tables and the initial state are per attempt."""
    D_TAB = cfg.d_tab

    def per_gt(gt):
        probs, mids, slots, valid = _gather_candidates(
            hap_prob, hap_mid, unmapped_prob, gt, cfg.prob_diff)
        vorder, vcount = _compact_valid(valid)
        probs_p = jnp.take_along_axis(probs, vorder, axis=1)
        mids_p = jnp.take_along_axis(mids, vorder[..., None], axis=1)
        slots_p = jnp.take_along_axis(slots, vorder, axis=1)
        if k_eff is not None and k_eff < probs_p.shape[-1]:
            # Every valid candidate sits below the host-computed cap
            # (solve.py _candidate_k_cap): the dropped tail is padding.
            probs_p = probs_p[:, :k_eff]
            mids_p = mids_p[:, :k_eff]
            slots_p = slots_p[:, :k_eff]
        nontrivial = vcount > 1
        ntc = jnp.maximum(jnp.sum(nontrivial), 1).astype(jnp.int32)
        nt_ixs = jnp.argsort(~nontrivial, stable=True).astype(jnp.int32)
        vp = jnp.where(probs_p > NEG / 2, probs_p, jnp.nan)
        spread = jnp.nanmax(vp, 1) - jnp.nanmin(vp, 1)
        max_abs = jnp.nan_to_num(jnp.nanmax(spread), nan=1.0) \
            * cfg.aln_contrib + 10.0
        start_temp = jnp.maximum(-max_abs / jnp.log(cfg.init_prob), 1e-5)
        return probs_p, mids_p, slots_p, vcount, nt_ixs, ntc, start_temp

    G = genotypes.shape[0]
    probs_g, mids_g, slots_g, vcount_g, nt_g, ntc_g, temp_g = jax.vmap(
        per_gt)(genotypes)

    rep = lambda x: jnp.repeat(x, attempts, axis=0)  # noqa: E731
    keys_flat = jax.random.split(key, G * attempts)

    def per_attempt(k, gt, probs_p, mids, slots, vcount, init_row=None):
        kw, kr = jax.random.split(k)
        win_gc, win_weight = _window_tables(
            kw, gt, pack_nwin, pack_regstart, pack_len, gc_at, weight_at,
            cfg.window_size, cfg.tweak, max_windows)
        wins = _read_windows(kr, gt, mids, slots, pack_nwin, pack_regstart,
                             cfg.window_size, cfg.tweak, max_windows)
        winpk = wins[..., 0] | (wins[..., 1] << 16)              # [R, K]
        wtab = win_weight[:, None] * bayes[win_gc, :D_TAB]       # [W, D]
        if init_row is not None:
            # Warm start (e.g. the previous stage's best assignment in
            # the same permuted slot space), clipped to the valid set.
            assgn0 = jnp.clip(init_row.astype(jnp.int32), 0,
                              jnp.maximum(vcount - 1, 0))
        elif random_init:
            u = jax.random.uniform(jax.random.fold_in(kw, 7),
                                   (vcount.shape[0],))
            assgn0 = jnp.minimum((u * vcount).astype(jnp.int32),
                                 jnp.maximum(vcount - 1, 0))
        else:
            assgn0 = jnp.argmax(probs_p, axis=1).astype(jnp.int32)
        wp0 = jnp.take_along_axis(winpk, assgn0[:, None], axis=1)[:, 0]
        W = wtab.shape[0]
        depth0 = (jnp.zeros(W, jnp.int32).at[wp0 & M16].add(1)
                  .at[(wp0 >> 16) & M16].add(1))
        cache0 = jnp.take_along_axis(
            wtab, jnp.clip(depth0, 0, D_TAB - 1)[:, None], axis=1)[:, 0]
        return winpk.T, wtab.reshape(-1), assgn0, depth0, cache0

    args = [keys_flat, rep(genotypes), rep(probs_g), rep(mids_g),
            rep(slots_g), rep(vcount_g)]
    if init_assgn is not None:
        args.append(init_assgn.reshape(G * attempts, -1))
    winpk, wtab, assgn0, depth0, cache0 = jax.vmap(per_attempt)(*args)
    probs = jnp.transpose(rep(probs_g), (0, 2, 1))               # [C, K, R]
    return (probs, winpk, rep(vcount_g), rep(nt_g), rep(ntc_g), wtab,
            rep(temp_g), assgn0, depth0, cache0)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_attempts", "max_windows", "random_init",
                     "n_steps", "k_eff", "plato", "interpret"))
def solve_genotypes_pallas(key, genotypes, hap_prob, hap_mid, unmapped_prob,
                           pack_nwin, pack_regstart, pack_len, gc_at,
                           weight_at, bayes, cfg: SolverConfig,
                           n_attempts: int, max_windows: int,
                           n_steps: int | None = None,
                           random_init: bool = True,
                           k_eff: int | None = None, plato: int = 0,
                           init_assgn=None, interpret: bool = False):
    """Kernel counterpart of ops.solver.solve_genotypes.
    Returns (liks [G, A], assignments [G, A, R] in the valid-first PERMUTED
    slot space of _prepare_chains; use liks for ranking).

    init_assgn: optional [G, A, R] warm-start assignments in that same
    permuted slot space (the permutation is deterministic per genotype,
    so a previous stage's output rows feed in directly)."""
    TB = CHAINS_PER_PROGRAM
    G = genotypes.shape[0]
    C = G * n_attempts
    pad = (-C) % TB
    if n_steps is None:
        n_steps = cfg.anneal_steps + cfg.polish_steps

    kp, kk = jax.random.split(key)
    feeds = _prepare_chains(
        kp, genotypes, n_attempts, hap_prob, hap_mid, unmapped_prob,
        pack_nwin, pack_regstart, pack_len, gc_at, weight_at, bayes, cfg,
        max_windows, random_init, k_eff=k_eff, init_assgn=init_assgn)
    if pad:
        # Padding chains repeat the last chain; their results are dropped.
        feeds = [jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)])
                 for x in feeds]
    (probs, winpk, vcount, nt_ixs, ntc, wtab, start_temp, assgn0, depth0,
     cache0) = feeds
    seed = jax.random.randint(kk, (1,), 0, 2**31 - 1, dtype=jnp.int32)

    kernel = functools.partial(
        _kernel, TB=TB, n_steps=n_steps, anneal_steps=cfg.anneal_steps,
        dc=float(cfg.depth_contrib), ac=float(cfg.aln_contrib),
        D_TAB=cfg.d_tab, plato=(plato if 0 < plato < n_steps else 0),
        ln_init_prob=float(np.log(cfg.init_prob)))
    assgn, _depth, cache = pl.pallas_call(
        kernel,
        grid=((C + pad) // TB,),
        out_shape=[jax.ShapeDtypeStruct(assgn0.shape, jnp.int32),
                   jax.ShapeDtypeStruct(depth0.shape, jnp.int32),
                   jax.ShapeDtypeStruct(cache0.shape, jnp.float32)],
        input_output_aliases={8: 0, 9: 1, 10: 2},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=TB // 32,
                                             num_stages=1),
        interpret=interpret,
        name="anneal_chains",
    )(seed, start_temp.astype(jnp.float32), probs, winpk, vcount, nt_ixs,
      ntc, wtab, assgn0, depth0, cache0.astype(jnp.float32))
    aln = jnp.sum(jnp.take_along_axis(probs, assgn[:, None, :], axis=1)[:, 0],
                  axis=-1)
    lik = cfg.depth_contrib * jnp.sum(cache, axis=-1) + cfg.aln_contrib * aln
    R = assgn.shape[1]
    return (lik[:C].reshape(G, n_attempts),
            assgn[:C].reshape(G, n_attempts, R))
