#!/usr/bin/env python
"""Phase-by-phase wall-time profile of the per-locus pipeline on simulated
data (host paths on CPU; device kernels via the XLA fallback).  Used to
attack the end-to-end throughput gap."""
import cProfile
import io
import pstats
import sys
import time

import numpy as np

import jax
jax.config.update("jax_platforms", "cpu")

from locityper_tpu import sim
from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
from locityper_tpu.model import Params
from locityper_tpu.model.locs import (HapMinimizerIndex, UniqueKmers,
                                      _align_candidates, build_all_alignments)
from locityper_tpu.pipeline import LocusData, estimate_bg_from_reads, genotype_locus
from locityper_tpu.seq.contigs import ContigSet
from locityper_tpu.seq.counts import GenomeKmerCounter, KmerCounts
from locityper_tpu.seq.recruit import RecruitParams, TargetIndex
from locityper_tpu.bg import Technology


def build_world(n_reads=8000, n_haps=8, length=6000, seed=0):
    rng = np.random.default_rng(seed)
    locus = sim.simulate_locus(rng, "L", length=length, n_haps=n_haps,
                               divergence=0.015)
    genome = np.concatenate([sim.random_genome(rng, 100_000),
                             locus.haplotypes[0],
                             sim.random_genome(rng, 100_000)])
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    from locityper_tpu.seq.counts import off_target_counts
    kc = off_target_counts(counter, list(locus.haplotypes),
                           locus.haplotypes[0])
    cset = ContigSet("L", locus.hap_names, list(locus.haplotypes))
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    depth = n_reads * 300 / (2 * sum(len(h) for h in true_haps) / 2)
    reads = sim.simulate_paired_reads(rng, true_haps, depth=depth, errors=err)
    pairs = list(zip(reads.reads1, reads.reads2))[:n_reads]
    names = reads.names[:n_reads]
    bg_reads = sim.simulate_paired_reads(rng, [genome[:50_000]], depth=25.0,
                                         errors=err, prefix="bg")
    bg = estimate_bg_from_reads(bg_reads.reads1, bg_reads.reads2,
                              genome[:50_000], counter,
                              Technology.ILLUMINA)
    return cset, kc, pairs, names, bg, counter


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 4000
    t0 = time.perf_counter()
    cset, kc, pairs, names, bg, counter = build_world(n_reads=n_reads)
    print(f"setup: {time.perf_counter()-t0:.1f}s  ({len(pairs)} pairs, "
          f"{len(cset.seqs)} haps)", flush=True)

    params = Params()
    params.band = 48
    params.set_tweak_size(bg.depth.window_size)
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(
        Technology.ILLUMINA))

    # Warm the align kernel (exclude compile from the profile).
    t0 = time.perf_counter()
    build_all_alignments(pairs[:64], names[:64], cset, kc, bg, edit_cache,
                         params)
    print(f"warmup(compile): {time.perf_counter()-t0:.1f}s", flush=True)

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    all_alns, stats = build_all_alignments(pairs, names, cset, kc, bg,
                                           edit_cache, params)
    pr.disable()
    dt = time.perf_counter() - t0
    print(f"build_all_alignments: {dt:.2f}s = {len(pairs)/dt:.0f} pairs/s  "
          f"({stats})", flush=True)
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(25)
    print(s.getvalue())


if __name__ == "__main__":
    main()
