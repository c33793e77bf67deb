"""Synthetic data generator: genomes, haplotype panels, reads.

The reference is validated against a downloadable dataset
(locityper.vercel.app); this sandbox has no egress, so correctness is
established on simulated loci where the true genotype is known — plus
unit-level oracles throughout tests/.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .seq import dna

BASES = np.arange(4, dtype=np.int8)


def random_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.int8)


def random_genome_gc(rng: np.random.Generator, length: int,
                     gc_low: float = 0.25, gc_high: float = 0.70,
                     block: int = 500) -> np.ndarray:
    """Random genome whose GC content oscillates between `gc_low` and
    `gc_high` over ~`block`-sized stretches — isochore-like structure, so
    fragment GC varies by position and GC-conditional depth bias
    (gc_bias_curve) produces real coverage waves for the 101-bin depth
    model to absorb (reference bg/depth.rs:42-91)."""
    phase = 2 * np.pi * np.arange(length) / (2.0 * block)
    gc = gc_low + (gc_high - gc_low) * 0.5 * (1 + np.sin(phase))
    is_gc = rng.random(length) < gc
    half = rng.integers(0, 2, size=length)
    # ACGT = 0123: GC bases are 1/2, AT bases are 0/3.
    return np.where(is_gc, 1 + half, 3 * half).astype(np.int8)


def mutate(rng: np.random.Generator, seq: np.ndarray, snp_rate: float = 0.01,
           indel_rate: float = 0.001, max_indel: int = 8) -> np.ndarray:
    """Derives a haplotype by applying random SNVs (density `snp_rate` per
    base) and short indels (density `indel_rate` per base)."""
    n = seq.size
    r = rng.random(n)
    # SNVs.
    snp = r < snp_rate
    out = np.where(snp, (seq + rng.integers(1, 4, n)) % 4, seq).astype(np.int8)
    # Indels: splice at event positions.
    pos = np.nonzero((r >= snp_rate) & (r < snp_rate + indel_rate))[0]
    if pos.size == 0:
        return out
    parts = []
    prev = 0
    for p in pos:
        length = int(rng.integers(1, max_indel + 1))
        if rng.random() < 0.5:   # deletion of `length` bases at p
            parts.append(out[prev:p])
            prev = min(p + length, n)
        else:                     # insertion of `length` random bases at p
            parts.append(out[prev:p])
            parts.append(rng.integers(0, 4, size=length, dtype=np.int8))
            prev = p
    parts.append(out[prev:])
    return np.concatenate(parts)


@dataclass
class SimLocus:
    """A simulated locus: haplotype panel + the true diploid genotype."""
    name: str
    haplotypes: list[np.ndarray]
    hap_names: list[str]
    true_genotype: tuple[int, int]


def simulate_locus(rng: np.random.Generator, name: str = "locus",
                   length: int = 4000, n_haps: int = 6,
                   divergence: float = 0.01,
                   base: np.ndarray | None = None) -> SimLocus:
    if base is None:
        base = random_genome(rng, length)
    haps = [base]
    for _ in range(n_haps - 1):
        haps.append(mutate(rng, base, snp_rate=divergence, indel_rate=divergence / 10))
    order = rng.permutation(n_haps)
    haps = [haps[i] for i in order]
    gt = tuple(sorted(rng.choice(n_haps, size=2, replace=True).tolist()))
    return SimLocus(name, haps, [f"{name}*{i:02d}" for i in range(n_haps)], gt)


def simulate_structured_locus(rng: np.random.Generator, name: str = "locus",
                              length: int = 4000, n_clades: int = 4,
                              haps_per_clade: int = 4,
                              clade_divergence: float = 0.02,
                              within_divergence: float = 0.002) -> SimLocus:
    """Haplotype panel with realistic structure:
    `n_clades` distant clades (founders at `clade_divergence` from a common
    ancestor), each holding `haps_per_clade` near-identical haplotypes at
    `within_divergence` from the clade founder.  Models HLA-style panels
    where hundreds of alleles cluster into a few allele groups and the
    caller must separate sub-percent-divergent siblings.

    The true genotype draws its two haplotypes from different clades when
    possible, so each true haplotype has same-clade near-twins competing
    with it — the hard case."""
    ancestor = random_genome(rng, length)
    haps, clade_of = [], []
    for c in range(n_clades):
        founder = mutate(rng, ancestor, snp_rate=clade_divergence,
                         indel_rate=clade_divergence / 10)
        for i in range(haps_per_clade):
            h = founder if i == 0 else mutate(
                rng, founder, snp_rate=within_divergence,
                indel_rate=within_divergence / 10)
            haps.append(h)
            clade_of.append(c)
    order = rng.permutation(len(haps))
    haps = [haps[i] for i in order]
    clade_of = [clade_of[i] for i in order]
    if n_clades >= 2:
        c1, c2 = rng.choice(n_clades, size=2, replace=False)
        i1 = int(rng.choice([i for i, c in enumerate(clade_of) if c == c1]))
        i2 = int(rng.choice([i for i, c in enumerate(clade_of) if c == c2]))
    else:
        i1, i2 = (int(x) for x in rng.choice(len(haps), size=2, replace=True))
    gt = tuple(sorted((i1, i2)))
    return SimLocus(name, haps,
                    [f"{name}*{i:03d}" for i in range(len(haps))], gt)


def make_paralog(rng: np.random.Generator, seq: np.ndarray,
                 identity: float = 0.97) -> np.ndarray:
    """A decoy paralog of `seq` at the given sequence identity — the
    CYP2D6/CYP2D7 stress (BASELINE config 3): placed elsewhere in the
    genome, it sheds reads that recruitment will pull in and that must not
    corrupt the call, while its k-mers raise off-target counts."""
    div = max(1.0 - identity, 0.0)
    return mutate(rng, seq, snp_rate=div * 0.9, indel_rate=div * 0.1)


@dataclass
class ErrorModel:
    mismatch: float = 0.002
    insertion: float = 0.0002
    deletion: float = 0.0002

    def apply(self, rng: np.random.Generator, seq: np.ndarray) -> np.ndarray:
        """Per-base event: deletion | insertion-before | mismatch | match —
        mutually exclusive, so realized edit rate = del+ins+mism exactly.
        (A round-5 fix: the old if-chain let every insertion ALSO mutate
        the following base, inflating long-read edit distance ~0.8% above
        what the error profile models and pushing reads past the
        BetaBinomial passable threshold — err_prof.rs:363-412.)"""
        out = []
        for c in seq:
            r = rng.random()
            if r < self.deletion:
                continue
            if r < self.deletion + self.insertion:
                out.append(int(rng.integers(0, 4)))
                out.append(int(c))
            elif r < self.deletion + self.insertion + self.mismatch:
                out.append(int((c + rng.integers(1, 4)) % 4))
            else:
                out.append(int(c))
        return np.array(out, dtype=np.int8)


@dataclass
class SimReads:
    reads1: list[np.ndarray]
    reads2: list[np.ndarray]          # empty list entries for single-end
    names: list[str]
    source_hap: list[int]             # which haplotype each pair came from
    source_pos: list[int]


def gc_bias_curve(strength: float = 0.8, center: float = 0.45) -> np.ndarray:
    """A [101] acceptance-probability curve over fragment GC%: depth peaks
    at `center` GC and falls off quadratically, dropping by `strength` at
    the 0/100% extremes — the shape the reference's 101-GC-bin depth model
    exists to absorb (bg/depth.rs:42-91)."""
    gc = np.arange(101) / 100.0
    curve = 1.0 - strength * np.minimum(
        ((gc - center) / max(center, 1.0 - center)) ** 2, 1.0)
    return np.clip(curve, 0.05, 1.0)


def simulate_paired_reads(rng: np.random.Generator, seqs: list[np.ndarray],
                          depth: float = 30.0, read_len: int = 150,
                          insert_mean: float = 400.0, insert_sd: float = 60.0,
                          errors: ErrorModel | None = None,
                          prefix: str = "rd",
                          gc_bias: np.ndarray | None = None) -> SimReads:
    """Simulates paired-end reads uniformly from `seqs` (e.g. the two true
    haplotypes) at the given per-haplotype depth.

    `gc_bias`: optional [101] per-GC%-bin acceptance probability
    (gc_bias_curve()).  Each drawn fragment is kept with probability
    gc_bias[round(100*GC)], so realized depth at fragment GC g is
    `depth * gc_bias[g]` — GC-conditional coverage like real libraries
    (PCR/optical bias), which the 101-bin depth model must absorb."""
    errors = errors or ErrorModel()
    reads1, reads2, names, src, pos = [], [], [], [], []
    counter = 0
    for hap_ix, seq in enumerate(seqs):
        is_gc = (seq == 1) | (seq == 2)   # ACGT = 0123: C/G bases
        n_pairs = int(depth * seq.size / (2 * read_len) + 0.5)
        for _ in range(n_pairs):
            insert = max(int(rng.normal(insert_mean, insert_sd)), read_len)
            insert = min(insert, seq.size)
            start = int(rng.integers(0, max(seq.size - insert, 0) + 1))
            if gc_bias is not None:
                gc_pct = int(round(100.0 * float(
                    is_gc[start:start + insert].mean())))
                if rng.random() >= gc_bias[gc_pct]:
                    continue
            frag = seq[start:start + insert]
            r1 = errors.apply(rng, frag[:read_len])
            r2 = errors.apply(rng, dna.revcomp(frag[-read_len:]))
            if rng.random() < 0.5:
                r1, r2 = r2, r1  # strand swap: mate1 may be on either strand
            reads1.append(r1)
            reads2.append(r2)
            names.append(f"{prefix}{counter:06d}")
            src.append(hap_ix)
            pos.append(start)
            counter += 1
    return SimReads(reads1, reads2, names, src, pos)


def simulate_single_reads(rng: np.random.Generator, seqs: list[np.ndarray],
                          depth: float = 30.0, read_len_mean: int = 10000,
                          read_len_sd: int = 3000,
                          errors: ErrorModel | None = None,
                          prefix: str = "lr") -> SimReads:
    """Long single-end reads (HiFi/ONT-like)."""
    errors = errors or ErrorModel(mismatch=0.01, insertion=0.005, deletion=0.005)
    reads, names, src, pos = [], [], [], []
    counter = 0
    for hap_ix, seq in enumerate(seqs):
        target_bases = depth * seq.size
        covered = 0
        while covered < target_bases:
            L = max(int(rng.normal(read_len_mean, read_len_sd)), 300)
            L = min(L, seq.size)
            start = int(rng.integers(0, seq.size - L + 1))
            frag = seq[start:start + L]
            if rng.random() < 0.5:
                frag = dna.revcomp(frag)
            reads.append(errors.apply(rng, frag))
            names.append(f"{prefix}{counter:06d}")
            src.append(hap_ix)
            pos.append(start)
            covered += L
            counter += 1
    return SimReads(reads, [], names, src, pos)


def apply_errors_bulk(rng: np.random.Generator, frags: np.ndarray,
                      errors: ErrorModel, out_len: int) -> np.ndarray:
    """ErrorModel.apply on every row of `frags` [n, F] at once, each output
    cut to `out_len` bases (rows that come out shorter are padded with
    code 4; make F a little longer than out_len).  Same per-base events:
    deletion | insertion-before | mismatch | match."""
    n, F = frags.shape
    ev = rng.random((n, F))
    dele = ev < errors.deletion
    ins = (~dele) & (ev < errors.deletion + errors.insertion)
    mism = (~dele & ~ins) & (
        ev < errors.deletion + errors.insertion + errors.mismatch)
    base = np.where(mism, (frags + rng.integers(1, 4, (n, F))) % 4, frags)
    width = np.where(dele, 0, np.where(ins, 2, 1))
    pos = np.cumsum(width, axis=1) - width
    out = np.full((n, 2 * F + 1), 4, np.int8)
    rows = np.broadcast_to(np.arange(n)[:, None], (n, F))
    ib = np.nonzero(ins)
    out[ib[0], pos[ib]] = rng.integers(0, 4, ib[0].size)
    kb = np.nonzero(~dele)
    out[rows[kb], pos[kb] + ins[kb]] = base[kb]
    return out[:, :out_len]


def simulate_paired_reads_bulk(rng: np.random.Generator, seq: np.ndarray,
                               depth: float = 30.0, read_len: int = 150,
                               insert_mean: float = 400.0,
                               insert_sd: float = 60.0,
                               errors: ErrorModel | None = None,
                               chunk: int = 100_000):
    """simulate_paired_reads for one long sequence, vectorized: yields
    (reads1 [n, read_len], reads2 [n, read_len]) int8 chunks of at most
    `chunk` pairs.  For the off-target bulk of a simulated WGS sample."""
    errors = errors or ErrorModel()
    L = read_len
    n_pairs = int(depth * seq.size / (2 * L) + 0.5)
    F = L + 16
    padded = np.concatenate([seq, np.full(F, 4, seq.dtype)])
    for st in range(0, n_pairs, chunk):
        n = min(chunk, n_pairs - st)
        insert = np.clip(np.rint(rng.normal(insert_mean, insert_sd, n)),
                         L, seq.size).astype(np.int64)
        start = (rng.random(n) * (seq.size - insert + 1)).astype(np.int64)
        off = np.arange(F)
        frag1 = padded[start[:, None] + off]
        # Mate 2: reverse complement of the fragment's last read_len
        # bases, extended past them for the error model's slack.
        end = start + insert
        idx2 = np.maximum(end[:, None] - 1 - off, 0)
        frag2 = np.where(padded[idx2] < 4, 3 - padded[idx2], 4)
        r1 = apply_errors_bulk(rng, frag1, errors, L)
        r2 = apply_errors_bulk(rng, frag2.astype(np.int8), errors, L)
        swap = rng.random(n) < 0.5
        r1[swap], r2[swap] = r2[swap], r1[swap].copy()
        yield r1, r2
