"""Canonical k-mers and minimizers, vectorized over whole sequences.

Behavioral counterpart of reference seq/kmers.rs, restructured from a rolling
scalar loop into dense numpy array ops (the device recruitment twin in
ops/recruit.py reuses the same hash):

* k-mers: 2-bit packed, canonical = min(forward, revcomp) (kmers.rs:163-202).
  K-mers containing invalid bases get UNDEF = 2^64-1 (kmers.rs:26-29).
* minimizer hash: the 64-bit "fasthash" mix over the canonical k-mer
  (kmers.rs:93-103): x = ~x; x ^= x>>23; x *= 0x2127599bf4325c37; x ^= x>>47.
* minimizers: position of the first-minimum hash in every window of `w`
  consecutive k-mers, deduplicated by position (kmers.rs:265-331).  Windows
  whose minimum is UNDEF (all k-mers invalid) yield nothing.  NOTE: the
  reference additionally delays window emission by w-1 after an all-invalid
  window (kmers.rs:321-324); we simply skip invalid windows — both sides of
  recruitment (index build and read scan) use this implementation, so the
  matching semantics are self-consistent.

Minimizer *values* are the hashes themselves, as in the reference
(kmers.rs:328 pushes `best_hash`).
"""
from __future__ import annotations

import numpy as np

from .dna import encode

UNDEF = np.uint64(0xFFFFFFFFFFFFFFFF)
_FASTHASH_MULT = np.uint64(0x2127599BF4325C37)


def fasthash64(x: np.ndarray) -> np.ndarray:
    """fasthash mix function on uint64 arrays (kmers.rs:93-103)."""
    x = (~x.astype(np.uint64))
    x ^= x >> np.uint64(23)
    with np.errstate(over="ignore"):
        x = x * _FASTHASH_MULT
    x ^= x >> np.uint64(47)
    return x


def _rolling_kmers_codes(codes: np.ndarray, k: int):
    """Returns (fw, rv, valid) uint64 arrays of length len(codes)-k+1.

    fw[i] packs codes[i:i+k] big-endian 2-bit; rv packs the reverse
    complement; valid[i] iff no invalid base inside.
    """
    n = codes.size
    m = n - k + 1
    if m <= 0:
        e = np.empty(0, dtype=np.uint64)
        return e, e.copy(), np.empty(0, dtype=bool)
    c = codes.astype(np.int64)
    valid_base = c < 4
    c4 = np.where(valid_base, c, 0).astype(np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(c4, k)            # [m, k]
    pw = (np.uint64(1) << (np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)))
    with np.errstate(over="ignore"):
        fw = win @ pw                                                 # uint64 dot
        rv = (np.uint64(3) - win)[:, ::-1] @ pw
    vwin = np.lib.stride_tricks.sliding_window_view(valid_base, k)
    valid = vwin.all(axis=1)
    return fw.astype(np.uint64), rv.astype(np.uint64), valid


def _canonical_kmers_numpy(codes: np.ndarray, k: int):
    """numpy fallback of canonical_kmers (kept for toolchain-less installs;
    the native kernel is ~100x faster on genome-length sequences)."""
    fw, rv, valid = _rolling_kmers_codes(codes, k)
    is_fw = fw <= rv
    kmer = np.where(is_fw, fw, rv)
    kmer = np.where(valid, kmer, UNDEF)
    return kmer, is_fw, valid


def canonical_kmers(seq, k: int):
    """Returns (kmers, forward, valid): canonical k-mers for every position.

    kmers[i] = min(fw, rv) of seq[i:i+k]; forward[i] = fw <= rv;
    invalid positions have kmer == UNDEF.  Dispatches to the native C++
    kernel when built (exact-parity contract, tests/test_native.py).
    """
    codes = seq if isinstance(seq, np.ndarray) else encode(seq)
    from .. import native
    if native.available() and codes.dtype == np.int8:
        return native.canonical_kmers(codes, k)
    return _canonical_kmers_numpy(codes, k)


def minimizer_hashes(seq, k: int):
    """Canonical-kmer hash per position; UNDEF for invalid positions."""
    kmer, is_fw, valid = canonical_kmers(seq, k)
    h = fasthash64(kmer)
    h = np.where(valid, h, UNDEF)
    return h, is_fw


def minimizers(seq, k: int, w: int):
    """Returns (positions, hashes, forward) of the sequence minimizers.

    positions are k-mer start positions; each window of `w` consecutive
    k-mers contributes its first-minimum hash; duplicates (same position
    selected by several windows) are removed (kmers.rs:265-331).
    """
    h, is_fw = minimizer_hashes(seq, k)
    m = h.size
    if m < w:
        # Too short to hold a full window: no minimizers (kmers.rs:289,314).
        e = np.empty(0, dtype=np.int64)
        return e, np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    windows = np.lib.stride_tricks.sliding_window_view(h, w)          # [m-w+1, w]
    arg = np.argmin(windows, axis=1)
    vals = windows[np.arange(windows.shape[0]), arg]
    pos = arg + np.arange(windows.shape[0])
    keep = vals != UNDEF
    pos, vals = pos[keep], vals[keep]
    if pos.size == 0:
        return pos.astype(np.int64), vals, np.empty(0, dtype=bool)
    first = np.ones(pos.size, dtype=bool)
    first[1:] = pos[1:] != pos[:-1]
    pos = pos[first].astype(np.int64)
    vals = vals[first]
    return pos, vals, is_fw[pos]


UNDEF32 = np.uint32(0xFFFFFFFF)
_MURMUR3_MULT = np.uint32(0x85EBCA6B)


def murmur3_mix32(x: np.ndarray) -> np.ndarray:
    """32-bit murmur3-style mix (kmers.rs:77-91).  Used for the recruitment
    minimizer space: with k ≤ 16 the canonical k-mer fits in 32 bits, which
    keeps the whole recruitment index in 32-bit words on device
    (SURVEY.md §7 'device hash tables')."""
    x = (~x.astype(np.uint32))
    x ^= x >> np.uint32(16)
    with np.errstate(over="ignore"):
        x = x * _MURMUR3_MULT
    x ^= x >> np.uint32(13)
    return x


def minimizers32(seq, k: int, w: int):
    """Like `minimizers` but in the 32-bit hash space (k ≤ 16).  Both the
    recruitment index build and the read scan use this function (host) or its
    device twin (ops/recruit.py), so matching is self-consistent.

    Dispatches to the native C++ kernel when built (exact-parity contract,
    tests/test_native.py)."""
    assert k <= 16
    codes = seq if isinstance(seq, np.ndarray) else encode(seq)
    from .. import native
    if native.available():
        return native.minimizers32(codes, k, w)
    fw, rv, valid = _rolling_kmers_codes(codes, k)
    is_fw = fw <= rv
    kmer = np.where(is_fw, fw, rv).astype(np.uint32)
    h = murmur3_mix32(kmer)
    h = np.where(valid, h, UNDEF32)
    m = h.size
    if m < w:
        e = np.empty(0, dtype=np.int64)
        return e, np.empty(0, dtype=np.uint32), np.empty(0, dtype=bool)
    windows = np.lib.stride_tricks.sliding_window_view(h, w)
    arg = np.argmin(windows, axis=1)
    vals = windows[np.arange(windows.shape[0]), arg]
    pos = arg + np.arange(windows.shape[0])
    keep = vals != UNDEF32
    pos, vals = pos[keep], vals[keep]
    if pos.size == 0:
        return pos.astype(np.int64), vals, np.empty(0, dtype=bool)
    first = np.ones(pos.size, dtype=bool)
    first[1:] = pos[1:] != pos[:-1]
    pos = pos[first].astype(np.int64)
    vals = vals[first]
    return pos, vals, is_fw[pos]


def sorted_minimizer_set(seq, k: int, w: int) -> np.ndarray:
    """Sorted unique minimizer hashes (for Jaccard divergence, div.rs:16-40)."""
    _, vals, _ = minimizers(seq, k, w)
    return np.unique(vals)


def jaccard_distance(set1: np.ndarray, set2: np.ndarray):
    """(non-shared count, Jaccard distance) between sorted unique minimizer
    sets (div.rs:16-40)."""
    overlap = np.intersect1d(set1, set2, assume_unique=True).size
    n1, n2 = set1.size, set2.size
    union = n1 + n2 - overlap
    unique = union - overlap
    return int(unique), (float(unique) / union if union else 0.0)


def noncanonical_kmers_u32(seq, k: int):
    """Forward-strand (non-canonical) k-mers as uint64 with validity mask —
    used by linguistic complexity (compl.rs)."""
    codes = seq if isinstance(seq, np.ndarray) else encode(seq)
    fw, _, valid = _rolling_kmers_codes(codes, k)
    return fw, valid
