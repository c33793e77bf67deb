"""Device recruitment kernel: batched minimizer matching.

The device twin of seq/recruit.py's host engine (behavioral spec:
reference seq/recruit.rs): dense [B, L] read batches → canonical k-mers →
32-bit murmur3 minimizers (first-argmin per window, deduped) → sorted-table
binary search → per-locus direction/rarity counters → short-read and pair
decision rules, bit-identical to the host path.

Index layout: instead of variable-length (locus, info) entry lists (a
scatter-heavy shape), each minimizer key stores three LOCUS BITMAPS
(fw-direction, bw-direction, rare) as uint32 words (32 loci per word).
Per-locus counters then reduce to bit-extractions + sums — pure VPU work
with no scatters and no per-entry loop (SURVEY.md §7 'device hash tables').

Decision rules are exact integer cross-multiplications of the rational
match-fraction threshold.
"""
from __future__ import annotations

import functools
import logging
from collections import namedtuple
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..seq.recruit import (DIR_BW, DIR_FW, RARE_BIT, RARE_WORTH,
                           TargetIndex)

UNDEF32 = jnp.uint32(0xFFFFFFFF)
# Hashes travel device-side in a SIGNED order-preserving view
# (h ^ 0x80000000 as int32), the order the sorted-key binary search uses.
SIGN_BIT = 0x80000000
BIG_S32 = np.int32(0x7FFFFFFF)          # UNDEF32 under the signed view

_Cfg = namedtuple("_Cfg", "n_loci n_groups k w frac_p frac_q lookup "
                          "shift_b shift_t")

#: Key-count threshold above which the displacement hash replaces the
#: sorted-table binary search: searchsorted grows with M while the
#: 2-gather hash lookup is flat.  Chosen on earlier hardware; not yet
#: measured on the GPU.
HASH_MIN_KEYS = 1 << 17
_HC1 = np.uint32(0x9E3779B1)      # bucket hash multiplier
_HC2 = np.uint32(0x85EBCA77)      # slot hash multiplier
_HC3 = np.uint32(0xC2B2AE3D)      # displacement-seed multiplier


def _build_disp_hash(keys: np.ndarray, packed: np.ndarray):
    """Hash-and-displace (Pagh) perfect-ish hashing, vectorized build:
    every key lands in a UNIQUE slot of a [T, W] table via
    slot = ((key ^ d*C3) * C2) >> shift_t with a per-bucket displacement
    d = d_tab[(key*C1) >> shift_b].  Device lookup is two dependent
    gathers and no sort.  Deterministic: buckets commit in rounds with
    lowest-bucket-id priority on slot contention.

    Returns (d_tab [Bk] uint32, shift_b, shift_t, table [T, W] uint32)
    where table[:, 0] is the key (UNDEF32 sentinel in empty slots —
    never a valid minimizer hash, seq/kmers semantics)."""
    M = keys.size
    T = 1 << max(int(np.ceil(np.log2(max(M, 2) * 2.0))), 4)
    Bk = 1 << max(int(np.ceil(np.log2(max(M, 2)))), 4)
    shift_b = 32 - int(np.log2(Bk))
    shift_t = 32 - int(np.log2(T))
    with np.errstate(over="ignore"):
        b = ((keys * _HC1) >> np.uint32(shift_b)).astype(np.int64)
        d_tab = np.zeros(Bk, np.uint32)
        taken = np.zeros(T, bool)
        slot_of = np.zeros(M, np.int64)
        unplaced = np.ones(M, bool)
        for _round in range(100_000):
            ki = np.nonzero(unplaced)[0]
            if ki.size == 0:
                break
            kb = b[ki]
            slots = (((keys[ki] ^ (d_tab[kb] * _HC3)) * _HC2)
                     >> np.uint32(shift_t)).astype(np.int64)
            # A key wins its slot iff the slot is free and it is the first
            # claimant in (slot, bucket-id) order; a bucket commits iff
            # ALL its keys win (within-bucket duplicates lose too).
            order = np.lexsort((kb, slots))
            ss = slots[order]
            win_sorted = np.ones(ss.size, bool)
            win_sorted[1:] = ss[1:] != ss[:-1]
            win_sorted &= ~taken[ss]
            win = np.empty(ss.size, bool)
            win[order] = win_sorted
            bucket_ok = np.ones(Bk, bool)
            np.logical_and.at(bucket_ok, kb, win)
            commit = bucket_ok[kb]
            ci = ki[commit]
            taken[slots[commit]] = True
            slot_of[ci] = slots[commit]
            unplaced[ci] = False
            failed = np.unique(kb[~commit])
            d_tab[failed] += np.uint32(1)
        else:
            raise RuntimeError("displacement hash build did not converge")
    table = np.zeros((T, packed.shape[1]), np.uint32)
    table[:, 0] = np.uint32(0xFFFFFFFF)
    table[slot_of] = packed
    return d_tab, shift_b, shift_t, table


@dataclass(frozen=True, eq=False)
class DeviceIndex:
    """TargetIndex as per-key locus bitmaps."""
    keys: np.ndarray          # [M] uint32 sorted
    fw_mask: np.ndarray       # [M, G] uint32 — direction includes forward
    bw_mask: np.ndarray       # [M, G] uint32 — direction includes backward
    rare_mask: np.ndarray     # [M, G] uint32
    n_loci: int
    n_groups: int
    k: int
    w: int
    frac_p: int               # match_frac = frac_p / frac_q
    frac_q: int

    @classmethod
    def from_index(cls, index: TargetIndex) -> "DeviceIndex":
        p = index.params
        frac = p.match_frac_rational
        M = index.keys.size
        G = max(-(-index.n_loci // 32), 1)
        fw = np.zeros((M, G), np.uint32)
        bw = np.zeros((M, G), np.uint32)
        rare = np.zeros((M, G), np.uint32)
        offs = index.offsets
        for m in range(M):
            for e in range(int(offs[m]), int(offs[m + 1])):
                l = int(index.entry_locus[e])
                info = int(index.entry_info[e])
                g, b = divmod(l, 32)
                bit = np.uint32(1 << b)
                if info & DIR_FW:
                    fw[m, g] |= bit
                if info & DIR_BW:
                    bw[m, g] |= bit
                if info & RARE_BIT:
                    rare[m, g] |= bit
        return cls(keys=index.keys.astype(np.uint32), fw_mask=fw, bw_mask=bw,
                   rare_mask=rare, n_loci=index.n_loci, n_groups=G,
                   k=p.minimizer_k, w=p.minimizer_w,
                   frac_p=frac.numerator, frac_q=frac.denominator)

    @property
    def packed(self) -> np.ndarray:
        """[M, 1+3G] uint32: key + fw/bw/rare bitmaps in ONE row — key
        verification and all three bitmaps cost a single row gather."""
        if not hasattr(self, "_packed"):
            object.__setattr__(self, "_packed", np.concatenate(
                [self.keys[:, None], self.fw_mask, self.bw_mask,
                 self.rare_mask], axis=1).astype(np.uint32))
        return self._packed

    @property
    def cfg(self) -> "_Cfg":
        return _Cfg(self.n_loci, self.n_groups, self.k, self.w,
                    self.frac_p, self.frac_q, *self._lookup_mode())

    def _lookup_mode(self):
        """(lookup, shift_b, shift_t): 'hash' above HASH_MIN_KEYS keys
        (flat 2-gather lookup), 'sorted' below.  A pathological
        key set whose displacement search does not converge falls back
        to sorted mode (warned once) instead of aborting the run."""
        if self.keys.size >= HASH_MIN_KEYS:
            h = self._hash_tables()                  # sizes fix the shifts
            if h is not None:
                return ("hash", h[1], h[2])
        return ("sorted", 0, 0)

    def _hash_tables(self):
        if not hasattr(self, "_hash"):
            try:
                h = _build_disp_hash(self.keys, self.packed)
            except RuntimeError as e:
                logging.getLogger("locityper").warning(
                    "%s for %d keys — using the sorted-lookup path",
                    e, self.keys.size)
                h = None
            object.__setattr__(self, "_hash", h)
        return self._hash

    def tables(self):
        """The two lookup tables the kernels take, as host numpy:
        sorted mode -> (keys_signed [M], packed [M, 1+3G]);
        hash mode -> (d_tab [Bk], hash table [T, 1+3G])."""
        if self.keys.size >= HASH_MIN_KEYS:
            h = self._hash_tables()
            if h is not None:
                d_tab, _sb, _st, table = h
                return d_tab, table
        return self.keys_signed, self.packed

    @property
    def keys_signed(self) -> np.ndarray:
        """Sorted keys in the signed order-preserving view (see SIGN_BIT)."""
        return (self.keys ^ np.uint32(SIGN_BIT)).astype(np.int32)

    def device_args(self):
        """Index tables resident on device (uploaded once, not with
        every batch)."""
        if not hasattr(self, "_dev_args"):
            object.__setattr__(self, "_dev_args", tuple(
                jax.device_put(a) for a in self.tables()))
        return self._dev_args


def _canonical_hashes(reads, k: int):
    """[B, P] uint32 minimizer-space hashes; UNDEF32 where invalid."""
    B, L = reads.shape
    P = L - k + 1
    codes = reads.astype(jnp.int32)
    valid = codes < 4
    c = jnp.where(valid, codes, 0).astype(jnp.uint32)
    fw = jnp.zeros((B, P), jnp.uint32)
    rv = jnp.zeros((B, P), jnp.uint32)
    ok = jnp.ones((B, P), bool)
    for j in range(k):
        cj = jax.lax.dynamic_slice_in_dim(c, j, P, axis=1)
        vj = jax.lax.dynamic_slice_in_dim(valid, j, P, axis=1)
        fw = fw | (cj << jnp.uint32(2 * (k - 1 - j)))
        rv = rv | ((jnp.uint32(3) - cj) << jnp.uint32(2 * j))
        ok = ok & vj
    is_fw = fw <= rv
    kmer = jnp.where(is_fw, fw, rv)
    x = ~kmer
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    h = jnp.where(ok, x, UNDEF32)
    return h, is_fw


def _minimizer_mask(h, w: int):
    """[B, P] bool: position is a window first-argmin with a defined hash.

    Scatter-free formulation: position p is
    selected by SOME window iff a' + b' >= w-1, where a' = number of
    consecutive left neighbours with strictly greater hash (ties break to
    the first index) and b' = consecutive right neighbours with
    greater-or-equal hash, both capped by the array edges and w-1.
    Bit-identical to the scatter/argmin formulation (test_recruit.py)."""
    B, P = h.shape
    if P - w + 1 <= 0:
        return jnp.zeros_like(h, bool)
    a = jnp.zeros((B, P), jnp.int32)
    b = jnp.zeros((B, P), jnp.int32)
    lmin = None
    rmin = None
    for i in range(1, w):
        sh_l = jnp.roll(h, i, axis=1).at[:, :i].set(UNDEF32)
        lmin = sh_l if lmin is None else jnp.minimum(lmin, sh_l)
        a = a + (lmin > h)
        sh_r = jnp.roll(h, -i, axis=1).at[:, P - i:].set(UNDEF32)
        rmin = sh_r if rmin is None else jnp.minimum(rmin, sh_r)
        b = b + (rmin >= h)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    a = jnp.minimum(a, pos)
    b = jnp.minimum(b, P - 1 - pos)
    return (a + b >= w - 1) & (h != UNDEF32)


def _hash_mask(reads, k: int, w: int):
    """(hs signed-view, is_fw, mask): one fused XLA elementwise chain."""
    h, is_fw = _canonical_hashes(reads, k)
    mask = _minimizer_mask(h, w)
    hs = (h ^ jnp.uint32(SIGN_BIT)).astype(jnp.int32)
    return hs, is_fw, mask


def _compact_width(P: int, w: int) -> int:
    """Minimizer slots kept per read: the expected count is 2P/(w+1) and
    this cap is >2.5x that, so by a Chernoff bound a read is truncated with
    probability < 1e-9 (and truncation only DROPS matches — strictly
    conservative for recruitment)."""
    return min(P, max(4 * (P // (w + 1)) + 16, 16))


def _compact_minimizers(h, is_fw, mask, S: int):
    """The first S minimizer positions of each read, in position order,
    packed to the front (stable sort on the mask): the index lookups and
    bitmap extraction then touch S columns instead of P."""
    order = jnp.argsort(~mask, axis=1, stable=True)[:, :S]
    return tuple(jnp.take_along_axis(x, order, axis=1)
                 for x in (h, is_fw, mask))


def _lookup_rows(cfg: _Cfg, h, mask, tbl_a, tbl_b):
    """(found [B, S] bool, rows [B, S, 1+3G] uint32): one packed index row
    per minimizer query — key verification and all three bitmaps ride ONE
    row gather.

    Two lookup modes (DeviceIndex.tables):
    - 'sorted': binary search over the signed-view sorted keys
      (method='sort': one global sort of queries+keys; chosen on earlier
      hardware, not yet measured on the GPU).
    - 'hash': displacement hash — two dependent gathers, no sort; flat in
      M, used above HASH_MIN_KEYS."""
    # h is the SIGNED order-preserving view (see SIGN_BIT); the packed /
    # hash tables store RAW uint32 keys — un-flip before comparing.
    h_u = jax.lax.bitcast_convert_type(h, jnp.uint32) ^ jnp.uint32(SIGN_BIT)
    if cfg.lookup == "hash":
        b = (h_u * _HC1) >> jnp.uint32(cfg.shift_b)
        d = tbl_a[b.reshape(-1)]
        slot = ((h_u.reshape(-1) ^ (d * _HC3)) * _HC2) \
            >> jnp.uint32(cfg.shift_t)
        rows = tbl_b[slot].reshape(h.shape + (tbl_b.shape[1],))
    else:
        M = tbl_a.shape[0]
        idx = jnp.searchsorted(tbl_a, h.reshape(-1), method="sort")
        idx = jnp.minimum(idx, M - 1)
        rows = tbl_b[idx].reshape(h.shape + (tbl_b.shape[1],))
    found = (rows[..., 0] == h_u) & mask
    return found, rows


def _mate_counters(reads, cfg: _Cfg, tbl_a, tbl_b):
    """Per-locus counters [B, n_loci, 4] = [bw_c, fw_c, bw_r, fw_r] and the
    minimizer totals [B] — via bitmap extraction, no scatters.

    (tbl_a, tbl_b) are DeviceIndex.tables() in the layout cfg.lookup
    names (see _lookup_rows)."""
    h, is_fw, mask = _hash_mask(reads, cfg.k, cfg.w)
    total = jnp.sum(mask, axis=1).astype(jnp.int32)
    h, is_fw, mask = _compact_minimizers(h, is_fw, mask,
                                         _compact_width(h.shape[1], cfg.w))

    G = cfg.n_groups
    found, tbl = _lookup_rows(cfg, h, mask, tbl_a, tbl_b)

    per_group = []
    for g in range(G):
        fmask = jnp.where(found, tbl[..., 1 + g], 0)      # [B, S] uint32
        bmask = jnp.where(found, tbl[..., 1 + G + g], 0)
        rmask = tbl[..., 1 + 2 * G + g]
        # Read-direction semantics (BaseMatchCount::inc): the "forward"
        # counter counts entries whose direction includes the read
        # minimizer's own direction; "backward" the opposite.
        m_fwdir = jnp.where(is_fw, fmask, bmask)          # hits fw counter
        m_bwdir = jnp.where(is_fw, bmask, fmask)          # hits bw counter
        n_here = min(32, cfg.n_loci - 32 * g)
        # Broadcast bit extraction over all loci of the group at once:
        # [B, P, n_here] hits, summed over positions in one fused reduce.
        bits = jnp.arange(n_here, dtype=jnp.uint32)
        rare_b = ((rmask[..., None] >> bits) & 1) != 0
        fw_hit = ((m_fwdir[..., None] >> bits) & 1) != 0
        bw_hit = ((m_bwdir[..., None] >> bits) & 1) != 0
        bw_c = jnp.sum(bw_hit & ~rare_b, axis=1)          # [B, n_here]
        fw_c = jnp.sum(fw_hit & ~rare_b, axis=1)
        bw_r = jnp.sum(bw_hit & rare_b, axis=1)
        fw_r = jnp.sum(fw_hit & rare_b, axis=1)
        per_group.append(jnp.stack([bw_c, fw_c, bw_r, fw_r], axis=-1))
    counts = jnp.concatenate(per_group, axis=1).astype(jnp.int32)
    return counts, total                                   # [B, n_loci, 4]


def _pack_decisions(dec):
    """[B, n_loci] bool -> [B, G] uint32 locus bitmaps: decisions travel
    D2H packed, 32 loci to a word."""
    B, n = dec.shape
    G = max(-(-n // 32), 1)
    pad = 32 * G - n
    if pad:
        dec = jnp.pad(dec, ((0, 0), (0, pad)))
    d = dec.reshape(B, G, 32).astype(jnp.uint32)
    bits = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(d << bits, axis=2, dtype=jnp.uint32)


def unpack_decisions(arr, n_loci: int) -> np.ndarray:
    """Host inverse of _pack_decisions; passes bool arrays through (the
    host twin and older checkpoints return unpacked decisions)."""
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        return arr
    bits = np.unpackbits(np.ascontiguousarray(arr).view(np.uint8), axis=1,
                         bitorder="little")
    return bits[:, :n_loci].view(np.bool_)


def _numer_denoms(counts, total):
    """fw/bw weighted numerators and denominators (recruit.rs:294-348)."""
    bw_c = counts[..., 0]
    fw_c = counts[..., 1]
    bw_r = counts[..., 2]
    fw_r = counts[..., 3]
    t = total[:, None]
    fw_n = RARE_WORTH * fw_r + fw_c
    bw_n = RARE_WORTH * bw_r + bw_c
    fw_d = RARE_WORTH * (t - fw_c) + fw_c
    bw_d = RARE_WORTH * (t - bw_c) + bw_c
    has_rare = (bw_r > 0) | (fw_r > 0)
    return fw_n, bw_n, fw_d, bw_d, has_rare


def _short_decide(cfg, reads, tbl_a, tbl_b):
    counts, total = _mate_counters(reads, cfg, tbl_a, tbl_b)
    fw_n, bw_n, fw_d, bw_d, has_rare = _numer_denoms(counts, total)
    use_fw = fw_n >= bw_n
    numer = jnp.where(use_fw, fw_n, bw_n)
    denom = jnp.maximum(jnp.where(use_fw, fw_d, bw_d), 1)
    passed = numer * cfg.frac_q >= cfg.frac_p * denom
    return _pack_decisions(has_rare & passed)


@functools.partial(jax.jit, static_argnames=("cfg",))
def recruit_short_batch(cfg, reads, tbl_a, tbl_b):
    """Packed [B, G] uint32 decisions for short single-end reads
    (unpack_decisions for the bool view)."""
    return _short_decide(cfg, reads, tbl_a, tbl_b)


@functools.partial(jax.jit, static_argnames=("cfg",))
def recruit_short_batch_packed(cfg, packed, tbl_a, tbl_b):
    """recruit_short_batch on a pack_reads_host-packed [B, L/8] uint32
    batch (half the upload bytes; bit-identical decisions)."""
    return _short_decide(cfg, _unpack_reads4(packed), tbl_a, tbl_b)


def pack_reads_host(*mats) -> np.ndarray:
    """Host-side 4-bit base packing for H2D: [B, L] int8 code matrices
    (codes 0-4, L a multiple of 8) -> ONE [sum(B), L/8] uint32 matrix,
    two bases per byte, little-endian nibbles.  Halves the upload bytes
    and collapses the per-batch device_put calls to one."""
    from .. import native
    if native.available():
        return native.pack_codes4(mats)       # ~8x the numpy pack speed
    both = np.concatenate(mats, axis=0) if len(mats) > 1 else mats[0]
    b = (both[:, 0::2] | (both[:, 1::2] << 4)).astype(np.uint8)
    return np.ascontiguousarray(b).view(np.uint32)


def _unpack_reads4(packed):
    """Device inverse of pack_reads_host: [N, L/8] uint32 -> [N, L] int8."""
    shifts = jnp.arange(8, dtype=jnp.uint32) * 4
    nib = (packed[:, :, None] >> shifts) & jnp.uint32(0xF)
    return nib.reshape(packed.shape[0], -1).astype(jnp.int8)


def _pairs_decide(cfg, both, B, tbl_a, tbl_b):
    """Decision body shared by the packed/unpacked pair entries:
    both = [2B, L] codes (mate-1 rows then mate-2 rows)."""
    c, t = _mate_counters(both, cfg, tbl_a, tbl_b)
    c1, c2 = c[:B], c[B:]
    t1, t2 = t[:B], t[B:]
    fw_n1, bw_n1, fw_d1, bw_d1, rare1 = _numer_denoms(c1, t1)
    fw_n2, bw_n2, fw_d2, bw_d2, rare2 = _numer_denoms(c2, t2)
    use_fw1 = fw_n1 + bw_n2 >= bw_n1 + fw_n2
    n1 = jnp.where(use_fw1, fw_n1, bw_n1)
    d1 = jnp.maximum(jnp.where(use_fw1, fw_d1, bw_d1), 1)
    n2 = jnp.where(use_fw1, bw_n2, fw_n2)
    d2 = jnp.maximum(jnp.where(use_fw1, bw_d2, fw_d2), 1)
    ok1 = n1 * cfg.frac_q >= cfg.frac_p * d1
    ok2 = n2 * cfg.frac_q >= cfg.frac_p * d2
    # Mate-1 must have at least one match at the locus (the reference never
    # inserts mate-2-only loci, recruit.rs:915-917).
    any1 = jnp.sum(c1, axis=-1) > 0
    return _pack_decisions((rare1 | rare2) & ok1 & ok2 & any1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def recruit_pairs_batch(cfg, reads1, reads2, tbl_a, tbl_b):
    """Packed [B, G] uint32 decisions for read pairs (strand-consistent
    joint orientation, both mates must pass; recruit.rs:885-932).  Both
    mates run as ONE [2B, L] counter pass (halves the fixed per-pass
    cost)."""
    both = jnp.concatenate([reads1, reads2], axis=0)
    return _pairs_decide(cfg, both, reads1.shape[0], tbl_a, tbl_b)


@functools.partial(jax.jit, static_argnames=("cfg",))
def recruit_pairs_batch_packed(cfg, packed, tbl_a, tbl_b):
    """recruit_pairs_batch on a pack_reads_host-packed [2B, L/8] uint32
    batch (both mates in one upload; bit-identical decisions)."""
    both = _unpack_reads4(packed)
    return _pairs_decide(cfg, both, packed.shape[0] // 2, tbl_a, tbl_b)


def _max_subarray(v):
    """Max subarray sum along axis 1 of v [B, S, L] via an associative scan
    (the data-parallel form of the reference's sequential Kadane loop,
    recruit.rs:940-964).  Segment state:
    (total, best_prefix, best_suffix, best)."""

    def combine(a, b):
        t1, p1, s1, b1 = a
        t2, p2, s2, b2 = b
        return (t1 + t2,
                jnp.maximum(p1, t1 + p2),
                jnp.maximum(s2, s1 + t2),
                jnp.maximum(jnp.maximum(b1, b2), s1 + p2))

    zero = jnp.zeros_like(v)
    init = (v, jnp.maximum(v, zero), jnp.maximum(v, zero),
            jnp.maximum(v, zero))
    total, pre, suf, best = jax.lax.associative_scan(combine, init, axis=1)
    return best[:, -1]


def _long_decide(cfg, reads, tbl_a, tbl_b, stretch_minims: int,
                 stretch_score: int):
    """[B, n_loci] decisions for long single-end reads
    (recruit.rs:966-997): rare-match fraction threshold + Kadane matching
    stretch, both evaluated for every locus at once on device.
    (tbl_a, tbl_b) are DeviceIndex.tables()."""
    h, is_fw, mask = _hash_mask(reads, cfg.k, cfg.w)
    total = jnp.sum(mask, axis=1).astype(jnp.int32)
    h, is_fw, mask = _compact_minimizers(h, is_fw, mask,
                                         _compact_width(h.shape[1], cfg.w))

    G = cfg.n_groups
    found, tbl = _lookup_rows(cfg, h, mask, tbl_a, tbl_b)

    # Counters (as _mate_counters) and per-position per-locus stretch values.
    SUB_P, SUB_B = 1, 3         # SUBSUM_PENALTY / SUBSUM_BONUS
    per_group_counts = []
    per_group_vfw = []
    per_group_vbw = []
    for g in range(cfg.n_groups):
        fmask = jnp.where(found, tbl[..., 1 + g], 0)
        bmask = jnp.where(found, tbl[..., 1 + G + g], 0)
        rmask = tbl[..., 1 + 2 * G + g]
        m_fwdir = jnp.where(is_fw, fmask, bmask)
        m_bwdir = jnp.where(is_fw, bmask, fmask)
        n_here = min(32, cfg.n_loci - 32 * g)
        bits = jnp.arange(n_here, dtype=jnp.uint32)
        rare_b = ((rmask[..., None] >> bits) & 1) != 0     # [B, S, n]
        fw_hit = ((m_fwdir[..., None] >> bits) & 1) != 0
        bw_hit = ((m_bwdir[..., None] >> bits) & 1) != 0
        bw_c = jnp.sum(bw_hit & ~rare_b, axis=1)
        fw_c = jnp.sum(fw_hit & ~rare_b, axis=1)
        bw_r = jnp.sum(bw_hit & rare_b, axis=1)
        fw_r = jnp.sum(fw_hit & rare_b, axis=1)
        per_group_counts.append(jnp.stack([bw_c, fw_c, bw_r, fw_r], axis=-1))
        # Stretch values: +SUB_P(+SUB_B if rare) on a direction hit, then
        # -SUB_P per minimizer step; padding rows contribute 0.
        x = (SUB_P + SUB_B * rare_b.astype(jnp.int32))
        step = mask[..., None].astype(jnp.int32) * SUB_P
        per_group_vfw.append(fw_hit.astype(jnp.int32) * x - step)
        per_group_vbw.append(bw_hit.astype(jnp.int32) * x - step)
    counts = jnp.concatenate(per_group_counts, axis=1).astype(jnp.int32)
    v_fw = jnp.concatenate(per_group_vfw, axis=2)
    v_bw = jnp.concatenate(per_group_vbw, axis=2)

    bw_c = counts[..., 0]
    fw_c = counts[..., 1]
    bw_r = counts[..., 2]
    fw_r = counts[..., 3]
    use_fw = fw_r >= bw_r
    numer = jnp.where(use_fw, fw_r, bw_r)
    denom = total[:, None] - jnp.where(use_fw, fw_c, bw_c)
    # threshold = max(1, ceil(min(stretch_minims, denom) * p/q)), exact
    # integer rational (mirrors RecruitParams.long_read_threshold).
    m = jnp.minimum(denom, stretch_minims)
    thresh = jnp.maximum(1, -((-m * cfg.frac_p) // cfg.frac_q))
    frac_ok = numer >= thresh

    best_fw = _max_subarray(v_fw)
    best_bw = _max_subarray(v_bw)
    stretch_ok = ((denom < stretch_minims) | (best_fw >= stretch_score)
                  | (best_bw >= stretch_score))
    return _pack_decisions(frac_ok & stretch_ok)


@functools.partial(jax.jit, static_argnames=("cfg", "stretch_minims",
                                             "stretch_score"))
def recruit_long_batch(cfg, reads, tbl_a, tbl_b, stretch_minims: int,
                       stretch_score: int):
    """Packed [B, G] uint32 decisions for long single-end reads
    (see _long_decide)."""
    return _long_decide(cfg, reads, tbl_a, tbl_b, stretch_minims,
                        stretch_score)


@functools.partial(jax.jit, static_argnames=("cfg", "stretch_minims",
                                             "stretch_score"))
def recruit_long_batch_packed(cfg, packed, tbl_a, tbl_b,
                              stretch_minims: int, stretch_score: int):
    """recruit_long_batch on a pack_reads_host-packed [B, L/8] uint32
    batch (half the upload bytes — long reads are the biggest uploads)."""
    return _long_decide(cfg, _unpack_reads4(packed), tbl_a, tbl_b,
                        stretch_minims, stretch_score)


def run_long_async(dev: DeviceIndex, reads: np.ndarray, stretch_minims: int,
                   stretch_score: int):
    """Dispatches and returns the device array (no host sync)."""
    if reads.shape[1] % 8 == 0:
        return recruit_long_batch_packed(
            dev.cfg, jax.device_put(pack_reads_host(reads)),
            *dev.device_args(), stretch_minims, stretch_score)
    return recruit_long_batch(dev.cfg, jax.device_put(reads),
                              *dev.device_args(), stretch_minims,
                              stretch_score)


def run_short_async(dev: DeviceIndex, reads: np.ndarray):
    if reads.shape[1] % 8 == 0:
        return recruit_short_batch_packed(
            dev.cfg, jax.device_put(pack_reads_host(reads)),
            *dev.device_args())
    return recruit_short_batch(dev.cfg, jax.device_put(reads),
                               *dev.device_args())


def run_pairs_async(dev: DeviceIndex, reads1: np.ndarray,
                    reads2: np.ndarray):
    return recruit_pairs_batch(dev.cfg, jax.device_put(reads1),
                               jax.device_put(reads2), *dev.device_args())


def run_pairs_async_packed(dev: DeviceIndex, reads1: np.ndarray,
                           reads2: np.ndarray):
    """run_pairs_async via the 4-bit packed single-upload path (half the
    H2D bytes, one device_put per batch; bit-identical decisions)."""
    packed = pack_reads_host(reads1, reads2)
    return recruit_pairs_batch_packed(dev.cfg, jax.device_put(packed),
                                      *dev.device_args())


def run_long(dev: DeviceIndex, reads: np.ndarray, stretch_minims: int,
             stretch_score: int):
    return unpack_decisions(run_long_async(dev, reads, stretch_minims,
                                           stretch_score), dev.n_loci)


def run_short(dev: DeviceIndex, reads: np.ndarray):
    return unpack_decisions(run_short_async(dev, reads), dev.n_loci)


def run_pairs(dev: DeviceIndex, reads1: np.ndarray, reads2: np.ndarray):
    return unpack_decisions(run_pairs_async(dev, reads1, reads2),
                            dev.n_loci)
