"""Massively parallel read-assignment solver (device kernel).

This replaces the reference's thread-pool of sequential stochastic solvers
(solvers/stoch.rs, solvers/solve.rs:969-1127) with a single jitted program
that runs (genotype × attempt) simulated-annealing chains in parallel via
nested vmap — the data-parallel counterpart of SURVEY.md §3.5's "thousands of
independent chains, each doing ~120k sequential moves".

Model recap (model/assgn.rs):
  total = depth_contrib · Σ_w weight[w]·lnBayes(depth[w])
        + aln_contrib   · Σ_r ln_prob[r, assignment[r]]
A move changes one read's location: Δ touches ≤4 windows (assgn.rs:259-284)
and one alignment probability.  Annealing: `anneal_steps` cooling steps with
temperature start_temp·s/steps (start_temp from an initial 0.5 acceptance
probability, stoch.rs:195-226), then greedy polish steps (accept improving).

Genotype assembly is pure gathers (extend_read_gt_alns, windows.rs:762-797):
candidates of the two haplotypes + the unmapped state, thresholded at
best − prob_diff.  Read→window mapping and per-attempt window tweaks
(assgn.rs:127-151) are index arithmetic into per-haplotype characteristic
arrays (model/windows.py).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e30
UNMAPPED_WINDOW = 0
BOUNDARY_WINDOW = 1
REG_WINDOW_SHIFT = 2
DEPTH_CAP = 256
MIN_WINDOW_WEIGHT = 1e-7   # distr_cache.rs:84-92


@dataclass(frozen=True)
class SolverConfig:
    anneal_steps: int = 20000
    polish_steps: int = 10000
    init_prob: float = 0.5
    depth_contrib: float = 1.85
    aln_contrib: float = 0.15
    prob_diff: float = 4.605
    tweak: int = 50
    window_size: int = 100
    greedy_start_best: bool = True     # polish-only chains start from best
    # Batched-move solver (ops/solver_batched.py): cooling super-steps and
    # per-step acceptance thinning.
    anneal_steps_b: int = 500
    move_thin: float = 0.3
    # Annealer kernel depth-table height (ops/solver_pallas.py).  Depths
    # above this clamp to the last row; the XLA engine uses DEPTH_CAP=256.
    d_tab: int = 64
    # Reference-greedy mode (stoch.rs:36-145): when greedy_sample > 0 the
    # XLA chain samples that many non-trivial reads per iteration, applies
    # the single best improving reassignment, and stops after plato_size
    # iterations without improvement (instead of the fixed-length
    # accept-improving polish walk).
    greedy_sample: int = 0
    plato_size: int = 100


def _gather_candidates(hap_prob, hap_mid, unmapped_prob, gt, prob_diff):
    """Candidates of genotype gt = (h_0..h_{P-1}): [R, K = P·Kh + 1] arrays
    (P = ploidy = gt.shape[0], a static shape under jit/vmap).  Last slot is
    the all-unmapped state (windows.rs:762-797; the reference supports
    arbitrary ploidy, genotype.rs:1077-1108).

    unmapped_prob: [R], or [H, R] per-haplotype rows (multi-locus panel
    solving shares the read axis across loci; each locus's haplotype rows
    carry its own unmapped penalties — solvers/solve.py:solve_panel)."""
    P = gt.shape[0]
    ps = [hap_prob[gt[s]] for s in range(P)]       # each [R, Kh]
    ms = [hap_mid[gt[s]] for s in range(P)]        # each [R, Kh, 2]
    if unmapped_prob.ndim == 2:
        unmapped_prob = unmapped_prob[gt[0]]
    R = ps[0].shape[0]
    probs = jnp.concatenate(ps + [unmapped_prob[:, None]], axis=1)
    mids = jnp.concatenate(ms + [jnp.full((R, 1, 2), -1, ms[0].dtype)],
                           axis=1)
    slots = jnp.concatenate(
        [jnp.full_like(p, s, jnp.int32) for s, p in enumerate(ps)]
        + [jnp.full((R, 1), 0, jnp.int32)], axis=1)
    # Threshold: max(unmapped, best per hap) - prob_diff.
    best = unmapped_prob
    for p in ps:
        best = jnp.maximum(best, jnp.max(p, 1))
    thresh = best - prob_diff
    valid = probs >= thresh[:, None]
    # The unmapped candidate stays valid as a fallback if nothing else is.
    probs = jnp.where(valid, probs, NEG)
    return probs, mids, slots, valid


def _compact_valid(valid):
    """Per read: indices of valid candidates moved to the front + count."""
    K = valid.shape[-1]
    order = jnp.argsort(~valid, axis=-1, stable=True)     # valid first
    count = jnp.sum(valid, axis=-1)
    return order.astype(jnp.int32), count.astype(jnp.int32)


def _window_tables(key, gt, pack_nwin, pack_regstart, pack_len, gc_at, weight_at,
                   wsize, tweak, max_windows):
    """Per-attempt tweaked window characteristics.

    Returns (win_gc [W], win_weight [W]) with W = 2 + P·max_windows
    (P = ploidy); slots 0/1 (unmapped/boundary) have weight 0 (trivial).
    Window i of hap copy s has a random start shift in
    [-min(tweak,start), +min(tweak, len-end)] (windows.rs:478-486)."""
    P = gt.shape[0]
    W = 2 + P * max_windows
    win_gc = jnp.zeros(W, jnp.int32)
    win_weight = jnp.zeros(W, jnp.float32)
    offs = jnp.array([2 + s * max_windows for s in range(P)])
    for s in range(P):
        h = gt[s]
        n = pack_nwin[h]
        starts = pack_regstart[h] + wsize * jnp.arange(max_windows)
        ends = starts + wsize
        left = jnp.minimum(tweak, starts)
        right = jnp.minimum(tweak, jnp.maximum(pack_len[h] - ends, 0))
        u = jax.random.uniform(jax.random.fold_in(key, s), (max_windows,))
        shift = jnp.floor(u * (left + right + 1)).astype(jnp.int32) - left
        pos = jnp.clip(starts + shift, 0, pack_len[h] - 1)
        gc = gc_at[h, pos]
        wt = weight_at[h, pos]
        active = jnp.arange(max_windows) < n
        wt = jnp.where(active, wt, 0.0)
        wt = jnp.where(wt < MIN_WINDOW_WEIGHT, 0.0, wt)
        win_gc = jax.lax.dynamic_update_slice(win_gc, gc, (offs[s],))
        win_weight = jax.lax.dynamic_update_slice(win_weight, wt, (offs[s],))
    return win_gc, win_weight


def _read_windows(key, gt, mids, slots, pack_nwin, pack_regstart, wsize, tweak,
                  max_windows):
    """Maps candidate middles to window indices with per-candidate random
    tweaks (define_windows_random, windows.rs:123-136).  mids [R, K, 2]."""
    R, K, _ = mids.shape
    P = gt.shape[0]
    t = jax.random.randint(key, (R, K, 2), 0, 2 * tweak + 1)
    # Per-slot scalars selected by ploidy-unrolled masks instead of an
    # [R, K] hap gather (pack_nwin[gt[slots]]).
    n = jnp.zeros(mids.shape[:2], pack_nwin.dtype)
    reg = jnp.zeros(mids.shape[:2], pack_regstart.dtype)
    for s in range(P):
        sel = slots == s
        n = jnp.where(sel, pack_nwin[gt[s]], n)
        reg = jnp.where(sel, pack_regstart[gt[s]], reg)
    n = n[..., None]
    reg = reg[..., None]
    wshift = (REG_WINDOW_SHIFT + slots * max_windows)[..., None]
    m = mids + t
    w = (m - reg) // wsize
    inside = (m >= reg) & (w >= 0) & (w < n)
    win = jnp.where(inside, w + wshift, BOUNDARY_WINDOW)
    win = jnp.where(mids < 0, UNMAPPED_WINDOW, win)
    return win.astype(jnp.int32)                           # [R, K, 2]


def _depth_lik_terms(bayes, win_gc, win_weight, depth):
    d = jnp.minimum(depth, DEPTH_CAP - 1)
    return win_weight * bayes[win_gc, d]


def _ln_depth(bayes, win_gc, win_weight, w, d):
    """weight·lnBayes at window w and depth d (WindowDistr::ln_prob)."""
    d = jnp.clip(d, 0, DEPTH_CAP - 1)
    return win_weight[w] * bayes[win_gc[w], d]


def _depth_lik_diff(bayes, win_gc, win_weight, depth, w1, w2, w3, w4):
    """Exact 4-window depth delta with shared-window handling
    (assgn.rs:259-284): depth at w1,w2 −1, at w3,w4 +1."""
    c1 = jnp.int32(-1)
    e21 = w2 == w1
    c2 = jnp.where(e21, 0, -1)
    c1 = c1 + jnp.where(e21, -1, 0)
    e31, e32 = w3 == w1, w3 == w2
    c3 = jnp.where(e31 | e32, 0, 1)
    c1 = c1 + jnp.where(e31, 1, 0)
    c2 = c2 + jnp.where(~e31 & e32, 1, 0)
    e41, e42, e43 = w4 == w1, w4 == w2, w4 == w3
    c4 = jnp.where(e41 | e42 | e43, 0, 1)
    c1 = c1 + jnp.where(e41, 1, 0)
    c2 = c2 + jnp.where(~e41 & e42, 1, 0)
    c3 = c3 + jnp.where(~e41 & ~e42 & e43, 1, 0)

    def atomic(w, c):
        d0 = depth[w]
        return jnp.where(
            c == 0, 0.0,
            _ln_depth(bayes, win_gc, win_weight, w, d0 + c)
            - _ln_depth(bayes, win_gc, win_weight, w, d0))
    return atomic(w1, c1) + atomic(w2, c2) + atomic(w3, c3) + atomic(w4, c4)


def _chain(key, probs, wins, vorder, vcount, nt_ixs, nt_count, bayes, win_gc,
           win_weight, cfg: SolverConfig, random_init: bool):
    """One annealing chain.  probs [R, K]; wins [R, K, 2]."""
    R, K = probs.shape
    W = win_gc.shape[0]
    k_init, k_probe, k_steps = jax.random.split(key, 3)

    # Initial assignment: random valid candidate, or best (index 0 of vorder
    # is the argmax because probs of invalid slots are NEG).
    if random_init:
        u = jax.random.uniform(k_init, (R,))
        pick = jnp.floor(u * vcount).astype(jnp.int32)
        assgn = jnp.take_along_axis(vorder, pick[:, None], 1)[:, 0]  # [R]
    else:
        assgn = jnp.argmax(probs, axis=1).astype(jnp.int32)          # best start

    w_asg = jnp.take_along_axis(
        wins, assgn[:, None, None].repeat(2, 2), 1)[:, 0]           # [R, 2]
    depth = jnp.zeros(W, jnp.int32).at[w_asg.reshape(-1)].add(1)
    aln_lik = jnp.sum(jnp.take_along_axis(probs, assgn[:, None], 1))
    depth_lik = jnp.sum(_depth_lik_terms(bayes, win_gc, win_weight, depth))

    dc, ac = jnp.float32(cfg.depth_contrib), jnp.float32(cfg.aln_contrib)

    def propose(k, state):
        assgn, depth = state
        k1, k2 = jax.random.split(k)
        r = nt_ixs[jax.random.randint(k1, (), 0, jnp.maximum(nt_count, 1))]
        old_slot = assgn[r]
        n_valid = vcount[r]
        # Random other valid candidate (ReassignmentTarget::random).
        old_pos = jnp.argmax(vorder[r] == old_slot)
        i = jax.random.randint(k2, (), 1, jnp.maximum(n_valid, 2))
        new_pos = jnp.where(i <= old_pos, i - 1, i)
        new_slot = vorder[r, new_pos]
        w1, w2 = wins[r, old_slot, 0], wins[r, old_slot, 1]
        w3, w4 = wins[r, new_slot, 0], wins[r, new_slot, 1]
        d_aln = probs[r, new_slot] - probs[r, old_slot]
        d_depth = _depth_lik_diff(bayes, win_gc, win_weight, depth, w1, w2, w3, w4)
        delta = ac * d_aln + dc * d_depth
        return r, old_slot, new_slot, (w1, w2, w3, w4), d_aln, d_depth, delta

    def apply_move(state, liks, r, old_slot, new_slot, ws, d_aln, d_depth, accept):
        assgn, depth = state
        aln_lik, depth_lik = liks
        w1, w2, w3, w4 = ws
        assgn = assgn.at[r].set(jnp.where(accept, new_slot, old_slot))
        inc = jnp.where(accept, 1, 0)
        depth = depth.at[w1].add(-inc).at[w2].add(-inc).at[w3].add(inc).at[w4].add(inc)
        aln_lik = aln_lik + jnp.where(accept, d_aln, 0.0)
        depth_lik = depth_lik + jnp.where(accept, d_depth, 0.0)
        return (assgn, depth), (aln_lik, depth_lik)

    # Initial temperature: max |delta| over 100 random probes (stoch.rs:19-29).
    def probe_body(i, carry):
        mx, state = carry
        _, _, _, _, _, _, delta = propose(jax.random.fold_in(k_probe, i), state)
        return jnp.maximum(mx, jnp.abs(delta)), state
    max_abs, _ = jax.lax.fori_loop(0, 100, probe_body, (jnp.float32(0.0),
                                                        (assgn, depth)))
    start_temp = jnp.maximum(-max_abs / jnp.log(cfg.init_prob), 1e-5)
    temp_step = start_temp / max(cfg.anneal_steps, 1)

    n_total = cfg.anneal_steps + cfg.polish_steps

    def step(carry, s):
        state, liks = carry
        k = jax.random.fold_in(k_steps, s)
        r, old_slot, new_slot, ws, d_aln, d_depth, delta = propose(k, state)
        # Annealing temperature: counts down during anneal phase, 0 after.
        s_rem = jnp.maximum(cfg.anneal_steps - s, 0).astype(jnp.float32)
        temp = temp_step * s_rem
        u = jax.random.uniform(jax.random.fold_in(k, 1))
        metro = (temp > 0) & (u <= jnp.exp(delta / jnp.maximum(temp, 1e-30)))
        accept = (delta >= 0) | metro
        state, liks = apply_move(state, liks, r, old_slot, new_slot, ws,
                                 d_aln, d_depth, accept)
        return (state, liks), None

    (state, liks), _ = jax.lax.scan(step, ((assgn, depth), (aln_lik, depth_lik)),
                                    jnp.arange(n_total))
    assgn, depth = state
    # Recompute likelihood from scratch (assgn.rs:346-354) — removes f32
    # accumulation drift over the chain.
    w_fin = jnp.take_along_axis(wins, assgn[:, None, None].repeat(2, 2), 1)[:, 0]
    depth_fin = jnp.zeros(W, jnp.int32).at[w_fin.reshape(-1)].add(1)
    aln_fin = jnp.sum(jnp.take_along_axis(probs, assgn[:, None], 1))
    depth_fin_lik = jnp.sum(_depth_lik_terms(bayes, win_gc, win_weight, depth_fin))
    total = dc * depth_fin_lik + ac * aln_fin
    return total, assgn


def _greedy_chain(key, probs, wins, vorder, vcount, nt_ixs, nt_count, bayes,
                  win_gc, win_weight, cfg: SolverConfig, random_init: bool):
    """Reference Greedy solver (stoch.rs:36-145) as a device while-loop: per
    iteration sample `cfg.greedy_sample` non-trivial reads (with
    replacement — the reference samples without), take the single best
    improving reassignment over ALL candidates of the sampled reads, stop
    after `cfg.plato_size` non-improving iterations (max iter
    max(100k, 100*plato), min_diff = eps * max|random delta|)."""
    R, K = probs.shape
    W = win_gc.shape[0]
    S = cfg.greedy_sample
    k_init, k_probe, k_steps = jax.random.split(key, 3)

    if random_init:
        u = jax.random.uniform(k_init, (R,))
        pick = jnp.floor(u * vcount).astype(jnp.int32)
        assgn = jnp.take_along_axis(vorder, pick[:, None], 1)[:, 0]
    else:
        assgn = jnp.argmax(probs, axis=1).astype(jnp.int32)

    w_asg = jnp.take_along_axis(
        wins, assgn[:, None, None].repeat(2, 2), 1)[:, 0]
    depth = jnp.zeros(W, jnp.int32).at[w_asg.reshape(-1)].add(1)
    aln_lik = jnp.sum(jnp.take_along_axis(probs, assgn[:, None], 1))
    depth_lik = jnp.sum(_depth_lik_terms(bayes, win_gc, win_weight, depth))
    dc, ac = jnp.float32(cfg.depth_contrib), jnp.float32(cfg.aln_contrib)

    # min_diff from 100 random probes (stoch.rs:19-29; eps scaled for f32).
    def probe(i, carry):
        mx, state = carry
        assgn_, depth_ = state
        k1, k2 = jax.random.split(jax.random.fold_in(k_probe, i))
        r = nt_ixs[jax.random.randint(k1, (), 0, jnp.maximum(nt_count, 1))]
        old_slot = assgn_[r]
        n_valid = vcount[r]
        old_pos = jnp.argmax(vorder[r] == old_slot)
        i2 = jax.random.randint(k2, (), 1, jnp.maximum(n_valid, 2))
        new_slot = vorder[r, jnp.where(i2 <= old_pos, i2 - 1, i2)]
        d_aln = probs[r, new_slot] - probs[r, old_slot]
        d_dep = _depth_lik_diff(bayes, win_gc, win_weight, depth_,
                                wins[r, old_slot, 0], wins[r, old_slot, 1],
                                wins[r, new_slot, 0], wins[r, new_slot, 1])
        return jnp.maximum(mx, jnp.abs(ac * d_aln + dc * d_dep)), state
    max_abs, _ = jax.lax.fori_loop(0, 100, probe,
                                   (jnp.float32(0.0), (assgn, depth)))
    min_diff = jnp.maximum(1e-6 * max_abs, jnp.float32(1e-8))

    max_iter = max(100_000, cfg.plato_size * 100)
    diff4 = jax.vmap(jax.vmap(
        _depth_lik_diff,
        in_axes=(None, None, None, None, None, None, 0, 0)),
        in_axes=(None, None, None, None, 0, 0, 0, 0))

    def cond(carry):
        _state, _liks, plato, it = carry
        return (plato <= cfg.plato_size) & (it < max_iter)

    def body(carry):
        state, liks, plato, it = carry
        assgn_, depth_ = state
        k = jax.random.fold_in(k_steps, it)
        rs = nt_ixs[jax.random.randint(k, (S,), 0,
                                       jnp.maximum(nt_count, 1))]   # [S]
        old = assgn_[rs]                                            # [S]
        p_old = probs[rs, old]
        d_aln = probs[rs] - p_old[:, None]                          # [S, K]
        w1 = wins[rs, old, 0]
        w2 = wins[rs, old, 1]                                       # [S]
        w3 = wins[rs, :, 0]
        w4 = wins[rs, :, 1]                                         # [S, K]
        d_dep = diff4(bayes, win_gc, win_weight, depth_, w1, w2, w3, w4)
        delta = ac * d_aln + dc * d_dep                             # [S, K]
        flat = delta.reshape(-1)
        best = jnp.argmax(flat)
        best_v = flat[best]
        si, ki = best // K, best % K
        improved = best_v > min_diff
        r = rs[si]
        old_slot = old[si]
        new_slot = ki.astype(jnp.int32)
        state, liks = apply_move_greedy(
            state, liks, r, old_slot, new_slot,
            (w1[si], w2[si], wins[r, new_slot, 0], wins[r, new_slot, 1]),
            d_aln[si, ki], d_dep[si, ki], improved)
        plato = jnp.where(improved, 0, plato + 1)
        return state, liks, plato, it + 1

    def apply_move_greedy(state, liks, r, old_slot, new_slot, ws, d_aln,
                          d_depth, accept):
        assgn_, depth_ = state
        a_lik, d_lik = liks
        w1, w2, w3, w4 = ws
        assgn_ = assgn_.at[r].set(jnp.where(accept, new_slot, old_slot))
        inc = jnp.where(accept, 1, 0)
        depth_ = depth_.at[w1].add(-inc).at[w2].add(-inc)                        .at[w3].add(inc).at[w4].add(inc)
        return (assgn_, depth_), (a_lik + jnp.where(accept, d_aln, 0.0),
                                  d_lik + jnp.where(accept, d_depth, 0.0))

    state, liks, _plato, _it = jax.lax.while_loop(
        cond, body, ((assgn, depth), (aln_lik, depth_lik),
                     jnp.int32(0), jnp.int32(0)))
    assgn, depth = state
    w_fin = jnp.take_along_axis(wins, assgn[:, None, None].repeat(2, 2), 1)[:, 0]
    depth_fin = jnp.zeros(W, jnp.int32).at[w_fin.reshape(-1)].add(1)
    aln_fin = jnp.sum(jnp.take_along_axis(probs, assgn[:, None], 1))
    depth_fin_lik = jnp.sum(_depth_lik_terms(bayes, win_gc, win_weight,
                                             depth_fin))
    return dc * depth_fin_lik + ac * aln_fin, assgn


def _eval_genotype(key, gt, hap_prob, hap_mid, unmapped_prob, pack_nwin,
                   pack_regstart, pack_len, gc_at, weight_at, bayes,
                   cfg: SolverConfig, n_attempts: int, max_windows: int,
                   random_init: bool):
    probs, mids, slots, valid = _gather_candidates(
        hap_prob, hap_mid, unmapped_prob, gt, cfg.prob_diff)
    vorder, vcount = _compact_valid(valid)
    nontrivial = vcount > 1
    nt_count = jnp.sum(nontrivial)
    nt_ixs = jnp.argsort(~nontrivial, stable=True).astype(jnp.int32)

    def one_attempt(k):
        kw, kr, kc = jax.random.split(k, 3)
        win_gc, win_weight = _window_tables(
            kw, gt, pack_nwin, pack_regstart, pack_len, gc_at, weight_at,
            cfg.window_size, cfg.tweak, max_windows)
        wins = _read_windows(kr, gt, mids, slots, pack_nwin, pack_regstart,
                             cfg.window_size, cfg.tweak, max_windows)
        chain = _greedy_chain if cfg.greedy_sample > 0 else _chain
        return chain(kc, probs, wins, vorder, vcount, nt_ixs, nt_count,
                     bayes, win_gc, win_weight, cfg, random_init)

    keys = jax.random.split(key, n_attempts)
    liks, assgns = jax.vmap(one_attempt)(keys)
    return liks, assgns


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "n_attempts", "max_windows", "random_init"))
def solve_genotypes(key, genotypes, hap_prob, hap_mid, unmapped_prob,
                    pack_nwin, pack_regstart, pack_len, gc_at, weight_at,
                    bayes, cfg: SolverConfig, n_attempts: int,
                    max_windows: int, random_init: bool = True):
    """Evaluates a batch of genotypes.

    genotypes: [G, P] int32 haplotype ids (P = ploidy; the reference
    enumerates arbitrary ploidy, genotype.rs:1077-1108).
    Returns (liks [G, n_attempts] f32, assignments [G, n_attempts, R] int32).
    """
    keys = jax.random.split(key, genotypes.shape[0])
    return jax.vmap(
        lambda k, gt: _eval_genotype(
            k, gt, hap_prob, hap_mid, unmapped_prob, pack_nwin, pack_regstart,
            pack_len, gc_at, weight_at, bayes, cfg, n_attempts, max_windows,
            random_init)
    )(keys, genotypes)


def build_bayes_table(depth_distrs, alt_cn, mul_coef: float,
                      cap: int = DEPTH_CAP) -> np.ndarray:
    """[101, cap] f32: ln posterior P(CN=1 | depth) per GC bin
    (DistrCache, model/distr_cache.rs:58-93 + BayesCalc bayes.rs:26-36)."""
    ks = np.arange(cap)
    out = np.empty((len(depth_distrs), cap), np.float64)
    for gc, d in enumerate(depth_distrs):
        cn1 = d.mul(mul_coef)
        null = cn1.ln_pmf(ks)
        alts = np.stack([cn1.mul(cn).ln_pmf(ks) for cn in alt_cn])
        stack = np.concatenate([null[None], alts], 0)
        m = stack.max(0)
        out[gc] = null - (m + np.log(np.sum(np.exp(stack - m), 0)))
    return out.astype(np.float32)
