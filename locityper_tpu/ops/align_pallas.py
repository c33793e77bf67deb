"""Banded ML aligner as one Pallas kernel for the GPU (Triton route).

Same contract as ops/align.align_batch: the same recurrence, scores and
payloads (parity in tests/test_align_pallas.py, run in interpret mode).
The XLA version is a `lax.scan` over read rows, which moves the whole
[N, band] score state and its payloads through device memory on every
row.  Here the row loop runs inside the kernel and the band state stays in
registers:

- one program aligns TB reads, one read per thread, and stops at the
  longest of its reads;
- the band is a Python-unrolled list of [TB] vectors, so the diagonal and
  insertion moves are renames.  Bands wider than MAX_REG_BAND stream
  through per-program row buffers in device memory (cached in L1/L2),
  an unrolled chunk of cells at a time;
- the deletion pass is an exact sequential max-plus scan over the band
  (ties go to the later origin, as in the reference's associative scan),
  so there is no cap on deletion runs;
- reads and windows arrive transposed ([L, B], [L+band, B]), so one row's
  characters for TB reads are one contiguous load.

Payloads are packed two to an int32 (pk1 = n_mism | n_ins << 16,
pk2 = n_del | n_clip << 16), which keeps the per-thread state at four
values per band cell; fields stay below 2^16, so reads must be shorter
than MAX_LEN.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG = -1e30
HI = 1 << 16       # plain ints: jnp constants would be captured as tracers
MASK16 = 0xFFFF
#: Longest read the packed 16-bit payload fields can count.
MAX_LEN = 1 << 16


def _cells(j0, prev, nb, ctx, scan, best):
    """Row i of the DP over consecutive band cells j0, j0+1, ...

    prev: (S, PK1, PK2, SP) lists of [TB] vectors, the previous row at
    those cells; nb: the same four values at the cell after the last (the
    insertion neighbour of the last cell); scan: the running deletion
    max-plus state (run, orig, pk1, pk2, sp) carried in from the cells
    before j0; best: (score, pk1, pk2, sp, ep) so far.  j0 is a Python int
    or a traced scalar.  Returns (new row lists, scan, best)."""
    (i, r_c, r_ok, clip_s, active, end_bonus, end_clip, sc, wins_ref,
     cols) = ctx
    m_sc, x_sc, i_sc, d_sc, _ = sc
    S, PK1, PK2, SP = prev
    run, orig, rp1, rp2, rsp = scan
    b_s, b_pk1, b_pk2, b_sp, b_ep = best
    new = ([], [], [], [])
    n = len(S)
    for t in range(n):
        j = j0 + t
        jf = j if isinstance(j, int) else j.astype(jnp.float32)
        # Diagonal, insertion and read-head clip; the first of equal
        # candidates wins (strict >), as in ops/align.pick.
        h = wins_ref[i - 1 + j, cols].astype(jnp.int32)
        sub = jnp.where(r_c == h, m_sc, x_sc)
        sub = jnp.where((h < 4) & r_ok, sub, NEG)
        s = S[t] + sub
        p1 = PK1[t] + (r_c != h).astype(jnp.int32)
        p2, sp = PK2[t], SP[t]
        ns, n1, n2, nsp = ((S[t + 1], PK1[t + 1], PK2[t + 1], SP[t + 1])
                           if t + 1 < n else nb)
        ins_s = ns + i_sc
        take = ins_s > s
        s = jnp.where(take, ins_s, s)
        p1 = jnp.where(take, n1 + HI, p1)
        p2 = jnp.where(take, n2, p2)
        sp = jnp.where(take, nsp, sp)
        take = clip_s > s
        s = jnp.where(take, clip_s, s)
        p1 = jnp.where(take, 0, p1)
        p2 = jnp.where(take, i * HI, p2)
        sp = jnp.where(take, i + j, sp)
        # Deletions: running max of base[j] - j*del, origin and payloads
        # following the winner (the later origin on ties).
        jd = jf * d_sc
        adj = s - jd
        take = adj >= run
        run = jnp.where(take, adj, run)
        orig = jnp.where(take, j, orig)
        rp1 = jnp.where(take, p1, rp1)
        rp2 = jnp.where(take, p2, rp2)
        rsp = jnp.where(take, sp, rsp)
        out = jnp.where(orig == j, s, run + jd)
        out_p2 = rp2 + (j - orig)
        # Best end at this row (rest of the read clipped): the first cell
        # of the row's maximum, if it beats the best so far.
        cand = out + end_bonus
        better = cand > b_s
        b_s = jnp.where(better, cand, b_s)
        b_pk1 = jnp.where(better, rp1, b_pk1)
        b_pk2 = jnp.where(better, out_p2 + end_clip, b_pk2)
        b_sp = jnp.where(better, rsp, b_sp)
        b_ep = jnp.where(better, i + j, b_ep)
        for lst, v in zip(new, (jnp.where(active, out, NEG), rp1, out_p2,
                                rsp)):
            lst.append(v)
    return (new, (run, orig, rp1, rp2, rsp),
            (b_s, b_pk1, b_pk2, b_sp, b_ep))


def _kernel(sc_ref, reads_ref, lens_ref, wins_ref,
            score_out, mism_out, ins_out, del_out, clip_out, sp_out, ep_out,
            *bufs, band: int, TB: int, chunk: int):
    """bufs: none when the band stays in registers (chunk == band), else
    four [band + 1, B] row buffers (score, pk1, pk2, start_p) that the
    band is streamed through `chunk` cells at a time; row `band` holds
    the out-of-band insertion neighbour."""
    cols = pl.ds(pl.program_id(0) * TB, TB)
    sc = tuple(sc_ref[k] for k in range(5))
    c_sc = sc[4]
    lens = lens_ref[cols]
    lens_f = lens.astype(jnp.float32)
    zi = jnp.zeros((TB,), jnp.int32)
    zf = jnp.zeros((TB,), jnp.float32)
    scan0 = (jnp.full((TB,), -jnp.inf, jnp.float32), zi, zi, zi, zi)
    best0 = (jnp.full((TB,), NEG, jnp.float32), zi, zi, zi, zi)

    def ctx_for(i):
        r_c = reads_ref[i - 1, cols].astype(jnp.int32)
        i_f = i.astype(jnp.float32)
        active = i <= lens
        return (i, r_c, r_c < 4, c_sc * i_f, active,
                jnp.where(active, (lens_f - i_f) * c_sc, NEG),
                (lens - i) * HI, sc, wins_ref, cols)

    # Rows past every read of this program change nothing: stop there.
    n_rows = jnp.max(lens)
    if chunk == band:
        def row(i, st):
            prev, best = st
            nb = (NEG, prev[1][-1], prev[2][-1], prev[3][-1])
            new, _, best = _cells(0, prev, nb, ctx_for(i), scan0, best)
            return new, best

        prev0 = ([zf] * band, [zi] * band, [zi] * band,
                 [zi + j for j in range(band)])     # row 0: start at p = j
        _, best = jax.lax.fori_loop(1, n_rows + 1, row, (prev0, best0))
    else:
        bufs_init = (zf, zi, zi, None)
        for j in range(band + 1):
            for buf, v in zip(bufs, bufs_init):
                buf[j, cols] = zi + j if v is None else v
        bufs[0][band, cols] = jnp.full((TB,), NEG, jnp.float32)

        def row(i, best):
            ctx = ctx_for(i)

            def block(c, carry):
                scan, best = carry
                j0 = c * chunk
                vals = [[buf[j0 + t, cols] for t in range(chunk + 1)]
                        for buf in bufs]
                prev = tuple(v[:chunk] for v in vals)
                nb = tuple(v[chunk] for v in vals)
                new, scan, best = _cells(j0, prev, nb, ctx, scan, best)
                for buf, lst in zip(bufs, new):
                    for t, v in enumerate(lst):
                        buf[j0 + t, cols] = v
                return scan, best

            _, best = jax.lax.fori_loop(0, band // chunk, block,
                                        (scan0, best))
            return best

        best = jax.lax.fori_loop(1, n_rows + 1, row, best0)
    b_s, b_pk1, b_pk2, b_sp, b_ep = best
    score_out[cols] = b_s
    mism_out[cols] = b_pk1 & MASK16
    ins_out[cols] = (b_pk1 >> 16) & MASK16
    del_out[cols] = b_pk2 & MASK16
    clip_out[cols] = (b_pk2 >> 16) & MASK16
    sp_out[cols] = b_sp
    ep_out[cols] = b_ep


#: Widest band held in registers; wider bands stream through row buffers
#: in chunks (a fully unrolled band of 160 cells takes minutes to compile
#: and spills anyway).
MAX_REG_BAND = 64


def chunk_for(band: int) -> int:
    """Band cells per unrolled block: the whole band up to MAX_REG_BAND,
    else the largest power of two up to 32 that divides it."""
    if band <= MAX_REG_BAND:
        return band
    return next(c for c in (32, 16, 8, 4, 2, 1) if band % c == 0)


def tile_for(band: int) -> tuple[int, int]:
    """(reads per program, warps): one read per thread.  Wide bands hold
    more state per thread, so they take one-warp programs (more programs
    in flight for the small batches long reads come in)."""
    return (64, 2) if band <= 64 else (32, 1)


@functools.partial(jax.jit, static_argnames=("band", "interpret"))
def align_batch_pallas(reads, rlens, hap_wins, score_vec, band: int = 48,
                       interpret: bool = False):
    """Drop-in replacement for ops.align.align_batch (same outputs).
    The batch is padded to a multiple of the program width."""
    B, L = reads.shape
    if L >= MAX_LEN:
        raise ValueError(f"read length {L} exceeds the kernel's 16-bit "
                         f"payload fields (< {MAX_LEN})")
    TB, num_warps = tile_for(band)
    chunk = chunk_for(band)
    pad = (-B) % TB
    Bp = B + pad
    r_t = jnp.pad(reads.astype(jnp.int8), ((0, pad), (0, 0)),
                  constant_values=4).T
    w_t = jnp.pad(hap_wins.astype(jnp.int8),
                  ((0, pad), (0, L + band - hap_wins.shape[1])),
                  constant_values=4).T
    lens = jnp.pad(rlens.astype(jnp.int32), (0, pad))
    kernel = functools.partial(_kernel, band=band, TB=TB, chunk=chunk)
    out_shape = ([jax.ShapeDtypeStruct((Bp,), jnp.float32)]
                 + [jax.ShapeDtypeStruct((Bp,), jnp.int32)] * 6)
    if chunk < band:
        out_shape += ([jax.ShapeDtypeStruct((band + 1, Bp), jnp.float32)]
                      + [jax.ShapeDtypeStruct((band + 1, Bp), jnp.int32)] * 3)
    res = pl.pallas_call(
        kernel,
        grid=(Bp // TB,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="banded_align",
    )(score_vec.astype(jnp.float32), r_t, lens, w_t)
    score, mism, ins, dele, clip, sp, ep = (x[:B] for x in res[:7])
    return dict(score=score, n_mism=mism, n_ins=ins, n_del=dele,
                n_clip=clip, start_p=sp, end_p=ep, valid=score > NEG / 2)
