"""Banded maximum-likelihood read↔haplotype alignment on device.

This kernel replaces three external components of the reference
(SURVEY.md §2.2): the strobealign/minimap2 subprocess mappers
(command/genotype.rs:978-1074), the WFA2-lib C aligner (seq/wfa.rs), and the
alignment-transfer machinery (seq/transfer.rs, cigar.rs:944-1035) — by
densely aligning every recruited read against every candidate haplotype
window in one batched, static-shape program.

Model: the DP directly maximizes the *error-profile log-likelihood* of the
alignment — each op costs its background ln-probability (bg/err_prof.rs:212-221):
    =:ln p_match  X:ln p_mism  I:ln p_ins  D:ln p_del  S:ln p_clip
so the optimal score IS the alignment ln-prob used by the genotyping model
(model/locs.rs:299-305), and no separate CIGAR scoring pass is needed.
Gap model is linear (the multinomial error profile has no open/extend split).

Band parameterization: offset j ∈ [0, B) maps "read prefix i consumed" to
"haplotype-window prefix p = i + j consumed".  Moves:
    diag  (i-1, j)   + sub(r[i-1], h[i+j-1])
    ins   (i-1, j+1) + ins_score
    del   (i,   j-1) + del_score          (within-row max-plus prefix scan)
    clip-start: i·clip_score at any j     (soft-clip of the read head)
Row 0 is free (glocal start anywhere in the window).  Final score folds
max_i max_j S[i,j] + (len-i)·clip_score (soft-clip of the read tail).

Op counts (mismatch/ins/del/clip + start/end haplotype positions) ride along
as argmax payloads, giving edit distance and alignment intervals without
traceback (SURVEY.md §7).
"""
from __future__ import annotations

import functools
import logging
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e30


@dataclass(frozen=True)
class Scores:
    """Per-op ln-probabilities (see bg/err_prof.rs:88-110)."""
    match: float
    mismatch: float
    insertion: float
    deletion: float
    clip: float

    @classmethod
    def from_error_rates(cls, mism: float, ins: float, dele: float) -> "Scores":
        m = 1.0 - mism - ins - dele
        return cls(np.log(m), np.log(mism), np.log(ins), np.log(dele),
                   np.log(max(mism, ins)))

    def astuple(self):
        return (self.match, self.mismatch, self.insertion, self.deletion, self.clip)


def _del_scan(base, payload, del_score, band):
    """Within-row deletion propagation: out[j] = max_{j'<=j} base[j'] + (j-j')·del.

    Implemented as a max-plus prefix scan: adjusted[j] = base[j] - j·del is
    run through a cumulative argmax (associative_scan), payloads follow the
    winning origin; the deletion count increments by (j - j_origin).
    """
    j_idx = jnp.arange(band, dtype=jnp.float32)
    adjusted = base - j_idx * del_score

    def combine(a, b):
        sa, pa = a
        sb, pb = b
        take_b = sb >= sa
        s = jnp.where(take_b, sb, sa)
        p = jax.tree.map(lambda x, y: jnp.where(take_b, y, x), pa, pb)
        return s, p

    origin = dict(payload)
    origin["j_origin"] = jnp.arange(band, dtype=jnp.int32)
    run_s, run_p = jax.lax.associative_scan(combine, (adjusted, origin), axis=-1)
    out = run_s + j_idx * del_score
    # The ±j·del round-trip loses ~|j·del|·2^-24 per row in f32, which
    # accumulates across rows. When no deletion was taken (origin == j, the
    # common case) restore the exact base value.
    no_del = run_p["j_origin"] == jnp.arange(band, dtype=jnp.int32)
    out = jnp.where(no_del, base, out)
    n_del = run_p["n_del"] + (jnp.arange(band, dtype=jnp.int32) - run_p["j_origin"])
    new_payload = {k: v for k, v in run_p.items() if k not in ("j_origin", "n_del")}
    new_payload["n_del"] = n_del
    return out, new_payload


def _align_one(read, rlen, hap_win, scores, band):
    """Aligns one read against one haplotype window.

    read:    [L]  int8 codes (pad 4)
    rlen:    ()   int32
    hap_win: [L+band] int8 codes (pad 4 outside the haplotype)
    Returns dict of scalars: score, n_mism, n_ins, n_del, n_clip, start_p,
    end_p (window-relative), valid.
    """
    m_sc, x_sc, i_sc, d_sc, c_sc = scores
    L = read.shape[0]
    j_idx = jnp.arange(band, dtype=jnp.int32)

    zero_payload = dict(
        n_mism=jnp.zeros(band, jnp.int32),
        n_ins=jnp.zeros(band, jnp.int32),
        n_del=jnp.zeros(band, jnp.int32),
        n_clip=jnp.zeros(band, jnp.int32),
        start_p=j_idx,                      # row 0: alignment starts at p = j
    )
    row0 = jnp.zeros(band, jnp.float32)

    best0 = dict(score=jnp.float32(NEG), n_mism=jnp.int32(0), n_ins=jnp.int32(0),
                 n_del=jnp.int32(0), n_clip=jnp.int32(0),
                 start_p=jnp.int32(0), end_p=jnp.int32(0))

    def pick(cands):
        """Elementwise argmax over candidate (score, payload) tuples."""
        s, p = cands[0]
        for s2, p2 in cands[1:]:
            take = s2 > s
            p = jax.tree.map(lambda a, b: jnp.where(take, b, a), p, p2)
            s = jnp.where(take, s2, s)
        return s, p

    def row_step(carry, i):
        prev, prev_pay, best = carry
        # i = 1-based read row. Read char r[i-1]; diag consumes hap at p-1 = i+j-1.
        r_c = read[i - 1]
        h_c = jax.lax.dynamic_slice(hap_win, (i - 1,), (band,))      # h[i-1+j]
        h_valid = h_c < 4
        sub = jnp.where(r_c == h_c, m_sc, x_sc)
        sub = jnp.where(h_valid & (r_c < 4), sub, NEG)
        is_mism = (r_c != h_c)

        diag_s = prev + sub
        diag_p = dict(prev_pay)
        diag_p["n_mism"] = prev_pay["n_mism"] + is_mism.astype(jnp.int32)

        ins_s = jnp.concatenate([prev[1:], jnp.array([NEG], jnp.float32)]) + i_sc
        ins_p = jax.tree.map(lambda x: jnp.concatenate([x[1:], x[-1:]]), prev_pay)
        ins_p["n_ins"] = ins_p["n_ins"] + 1

        clip_s = jnp.full(band, jnp.float32(c_sc) * i.astype(jnp.float32))
        clip_p = dict(
            n_mism=jnp.zeros(band, jnp.int32), n_ins=jnp.zeros(band, jnp.int32),
            n_del=jnp.zeros(band, jnp.int32), n_clip=jnp.full(band, i, jnp.int32),
            start_p=i + j_idx,
        )

        base_s, base_p = pick([(diag_s, diag_p), (ins_s, ins_p), (clip_s, clip_p)])
        row_s, row_p = _del_scan(base_s, base_p, jnp.float32(d_sc), band)

        # Fold the best possible end at this row: remaining read is clipped.
        active = i <= rlen
        end_bonus = jnp.where(active, (rlen - i).astype(jnp.float32) * c_sc, NEG)
        cand = row_s + end_bonus
        jbest = jnp.argmax(cand)
        cand_best = dict(
            score=cand[jbest],
            n_mism=row_p["n_mism"][jbest], n_ins=row_p["n_ins"][jbest],
            n_del=row_p["n_del"][jbest],
            n_clip=row_p["n_clip"][jbest] + (rlen - i),
            start_p=row_p["start_p"][jbest], end_p=i + jbest,
        )
        take = cand_best["score"] > best["score"]
        best = jax.tree.map(lambda a, b: jnp.where(take, b, a), best, cand_best)
        row_s = jnp.where(active, row_s, NEG)
        return (row_s, row_p, best), None

    (_, _, best), _ = jax.lax.scan(row_step, (row0, zero_payload, best0),
                                   jnp.arange(1, L + 1))
    best["valid"] = best["score"] > NEG / 2
    return best


@functools.partial(jax.jit, static_argnames=("band",))
def align_batch(reads, rlens, hap_wins, score_vec, band: int = 48):
    """Batched banded alignment.

    reads:    [N, L]        int8
    rlens:    [N]           int32
    hap_wins: [N, L+band]   int8 (extracted on host at the candidate diagonal)
    score_vec: [5] f32      (match, mism, ins, del, clip) ln-probs
    Returns dict of [N] arrays.
    """
    scores = tuple(score_vec[i] for i in range(5))
    return jax.vmap(lambda r, n, h: _align_one(r, n, h, scores, band))(
        reads, rlens, hap_wins)


def align_batch_auto(reads, rlens, hap_wins, score_vec, band: int = 48):
    """Dispatch by ops/device.kernel_route: the Pallas kernel
    (ops/align_pallas.py) on the GPU, the XLA kernel on the CPU.  Reads of
    MAX_LEN bases or more exceed the kernel's 16-bit payload fields and
    take the XLA kernel on every route, with a warning."""
    from .align_pallas import MAX_LEN, align_batch_pallas
    from .device import kernel_route
    if kernel_route() == "gpu":
        if reads.shape[1] < MAX_LEN:
            return align_batch_pallas(reads, rlens, hap_wins, score_vec,
                                      band=band)
        logging.getLogger("locityper").warning(
            "reads of %d bp exceed the aligner kernel's limit of %d: "
            "aligning them with the XLA kernel", reads.shape[1], MAX_LEN)
    return align_batch(reads, rlens, hap_wins, score_vec, band=band)


#: Result-vector order of the packed [8, N] int32 kernel output
#: (score is bitcast f32; model/locs.py unpacks on host).
ALIGN_RESULT_KEYS = ("score", "start_p", "end_p", "n_mism", "n_ins",
                     "n_del", "n_clip", "valid")


@functools.partial(jax.jit, static_argnames=("L", "W", "band"))
def align_batch_packed(comb, score_vec, L: int, W: int, band: int = 48):
    """align_batch_auto on a combined 4-bit-packed upload, returning the
    packed [8, N] int32 result matrix (ALIGN_RESULT_KEYS order).

    comb: [N, L/8 + W/8 + 1] uint32 — read nibbles, window nibbles, then
    the read length (model/locs.py _pack_align_jobs_host).  One upload at
    about half the bytes of (reads, lens, wins)."""
    rw, ww = L // 8, W // 8
    shifts = jnp.arange(8, dtype=jnp.uint32) * 4

    def unpack(p):
        nib = (p[:, :, None] >> shifts) & jnp.uint32(0xF)
        return nib.reshape(p.shape[0], -1).astype(jnp.int8)

    reads = unpack(comb[:, :rw])
    wins = unpack(comb[:, rw:rw + ww])
    lens = comb[:, rw + ww].astype(jnp.int32)
    res = align_batch_auto(reads, lens, wins, score_vec, band=band)
    rows = []
    for k in ALIGN_RESULT_KEYS:
        v = res[k]
        if v.dtype == jnp.float32:
            v = jax.lax.bitcast_convert_type(v, jnp.int32)
        else:
            v = v.astype(jnp.int32)
        rows.append(v)
    return jnp.stack(rows)


# ---------------------------------------------------------------------------
# Host-side helpers: candidate windows and batched invocation.
# ---------------------------------------------------------------------------

def extract_windows(hap: np.ndarray, win_starts: np.ndarray, width: int) -> np.ndarray:
    """Gathers [len(win_starts), width] windows from a haplotype, padding
    out-of-range positions with code 4 (vectorized gather, no per-row
    Python)."""
    n = win_starts.size
    if n == 0:
        return np.full((0, width), 4, dtype=np.int8)
    idx = win_starts.astype(np.int64)[:, None] + np.arange(width)[None, :]
    # Clamp to a sentinel slot holding code 4 on both ends.
    np.clip(idx, -1, hap.size, out=idx)
    padded = np.full(hap.size + 2, 4, dtype=np.int8)
    padded[1:-1] = hap
    return padded[idx + 1]


def edit_and_matches(res: dict, rlens: np.ndarray):
    """Vector (edit, matches) per alignment, following err_prof.rs:71-80:
    matches = rlen - mism - ins - clip;  edit = mism + ins + clip + del."""
    n_mism = np.asarray(res["n_mism"])
    n_ins = np.asarray(res["n_ins"])
    n_del = np.asarray(res["n_del"])
    n_clip = np.asarray(res["n_clip"])
    matches = rlens - n_mism - n_ins - n_clip
    edit = n_mism + n_ins + n_clip + n_del
    return edit, matches
