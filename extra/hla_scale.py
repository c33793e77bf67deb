#!/usr/bin/env python
"""HLA-scale validation: loci with hundreds of haplotypes through the FULL
reference-default solver scheme, end to end.

Builds N loci whose panels mirror HLA structure (clusters of
near-identical alleles at 0.1-0.5% divergence inside a few distant allele
groups — sim.simulate_structured_locus), so at H=200 the stage-0 filter
sees G = 20,100 diploid genotypes, stage 1 greedy-polishes the 5000
survivors, and stage 2 runs the reference-default anneal (i=20, a=20,
20k+10k steps) — the workload of solve.rs:211-229 + genotype.rs:1077-1108.

Usage:
    python extra/hla_scale.py [--n-loci 5] [--n-haps 200] [--length 4000]
        [--depth 15] [--scheme default|light] [--seed 0] [--repeat 1]

Prints per-phase timings, peak RSS, tensor shapes, and exactness; exits
nonzero if any call misses the simulated truth.
"""
import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def build_panel(args):
    from locityper_tpu import sim
    from locityper_tpu.pipeline import LocusData
    from locityper_tpu.seq.contigs import ContigSet
    from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts

    rng = np.random.default_rng(args.seed)
    haps_per_clade = max(args.n_haps // args.n_clades, 1)
    loci = [sim.simulate_structured_locus(
                rng, f"HLA{i}", length=args.length, n_clades=args.n_clades,
                haps_per_clade=haps_per_clade,
                clade_divergence=0.02, within_divergence=args.within_div)
            for i in range(args.n_loci)]
    flanks = [sim.random_genome(rng, 20000) for _ in range(args.n_loci + 1)]
    genome = np.concatenate(
        [p for pair in zip(flanks, [l.haplotypes[0] for l in loci])
         for p in pair] + [flanks[-1]])
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    data = {}
    for locus in loci:
        kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
        data[locus.name] = LocusData(
            ContigSet(locus.name, locus.hap_names, locus.haplotypes), kc)

    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    reads1, reads2, names = [], [], []
    for locus in loci:
        r = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=args.depth, read_len=150, errors=err, prefix=locus.name)
        reads1 += list(r.reads1)
        reads2 += list(r.reads2)
        names += list(r.names)
    bgr = sim.simulate_paired_reads(rng, flanks, depth=args.depth,
                                    read_len=150, errors=err, prefix="bg")
    reads1 += list(bgr.reads1)
    reads2 += list(bgr.reads2)
    names += list(bgr.names)
    return loci, data, (names, reads1, reads2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-loci", type=int, default=5)
    ap.add_argument("--n-haps", type=int, default=200)
    ap.add_argument("--n-clades", type=int, default=10)
    ap.add_argument("--within-div", type=float, default=0.003)
    ap.add_argument("--length", type=int, default=4000)
    ap.add_argument("--depth", type=float, default=15.0)
    ap.add_argument("--scheme", default="default",
                    help="'default' (reference full scheme), 'light' "
                         "(bench r4 reduced), or ';'-joined stage specs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1,
                    help="extra warm timing passes after the compile pass")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (debug)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    from locityper_tpu.cli import _enable_compile_cache
    from locityper_tpu.utils.malloc import tune_host_allocator
    _enable_compile_cache()
    tune_host_allocator()

    import tempfile
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.commands.genotype import recruit_reads_fast
    from locityper_tpu.model import Params
    from locityper_tpu.model.locs import build_all_alignments_panel
    from locityper_tpu.pipeline import genotype_panel
    from locityper_tpu.seq.fastx import Read, write_fastq
    from locityper_tpu.seq.recruit import RecruitParams
    from locityper_tpu.solvers.solve import Scheme

    import bench

    t0 = time.perf_counter()
    loci, data, (names, reads1, reads2) = build_panel(args)
    G = args.n_haps * (args.n_haps + 1) // 2
    print(f"panel: {args.n_loci} loci x {args.n_haps} haps "
          f"({args.n_clades} clades, within-div {args.within_div}), "
          f"G={G} genotypes/locus, {len(names)} read pairs "
          f"[built in {time.perf_counter() - t0:.1f}s]", flush=True)

    tmpd = Path(tempfile.mkdtemp(prefix="hla_scale_"))
    fq1, fq2 = tmpd / "r1.fq", tmpd / "r2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for n, a, b in zip(names, reads1, reads2):
            write_fastq(f1, Read(n, a))
            write_fastq(f2, Read(n, b))

    bg = bench._make_bg(depth_per_hap=args.depth)
    tech = bg.seq_info.technology
    params = Params(unmapped_penalty=tech.default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    if params.band is None:
        params.band = 48
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
    rp = RecruitParams(match_frac=tech.default_match_frac(True))
    if args.scheme == "default":
        scheme = Scheme.default()
    elif args.scheme == "light":
        scheme = Scheme.parse(["greedy:i=5k,a=1",
                               "anneal:i=8,a=8,n=3000,p=2000"])
    else:
        scheme = Scheme.parse(args.scheme.split(";"))

    def one_pass(seed):
        t0 = time.perf_counter()
        rec, _ = recruit_reads_fast(data, str(fq1), str(fq2), rp, seed=seed)
        t1 = time.perf_counter()
        panel = [(rec[l.name][0], rec[l.name][1], data[l.name].contig_set,
                  data[l.name].kmer_counts) for l in loci]
        built = build_all_alignments_panel(panel, bg, edit_cache, params)
        t2 = time.perf_counter()
        entries = [dict(locus=data[l.name], read_pairs=rec[l.name][0],
                        names=rec[l.name][1], tag=l.name, prebuilt=built[i])
                   for i, l in enumerate(loci)]
        solved = genotype_panel(entries, bg, params=params, scheme=scheme,
                                seed=seed)
        t3 = time.perf_counter()
        calls = [tuple(sorted(res.genotypes[0])) for res, _ in solved]
        quals = [res.quality for res, _ in solved]
        # [H, R, kh] dense-tensor shape per locus (kh=10 model default).
        shapes = [(len(l.haplotypes), len(rec[l.name][0]), 10)
                  for l in loci]
        print(f"  pass seed={seed}: recruit={t1 - t0:.2f}s "
              f"align={t2 - t1:.2f}s solve={t3 - t2:.2f}s "
              f"total={t3 - t0:.2f}s", flush=True)
        return t3 - t0, calls, quals, shapes

    dt, calls, quals, shapes = one_pass(1)
    truth = [tuple(sorted(l.true_genotype)) for l in loci]
    n_exact = sum(c == t for c, t in zip(calls, truth))
    for i, (c, t, q) in enumerate(zip(calls, truth, quals)):
        status = "EXACT" if c == t else f"MISS truth={t}"
        print(f"  locus {loci[i].name}: call={c} qual={q:.1f} {status}")
    best = dt
    for r in range(args.repeat):
        best = min(best, one_pass(2 + r)[0])
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(f"[G,R,K] per locus: {shapes[0]} x {args.n_loci} loci; "
          f"peak RSS {rss_mb:.0f} MB")
    summary = dict(
        metric="hla_scale_e2e", n_loci=args.n_loci, n_haps=args.n_haps,
        genotypes_stage0=G, scheme=args.scheme,
        wall_s=round(best, 2), s_per_locus=round(best / args.n_loci, 2),
        pairs=len(names), pairs_per_sec=round(len(names) / best, 1),
        exact=f"{n_exact}/{args.n_loci}", peak_rss_mb=round(rss_mb))
    from locityper_tpu.ops.device import kernel_route
    summary["kernel_route"] = kernel_route()
    print(json.dumps(summary))
    return 0 if n_exact == args.n_loci else 1


if __name__ == "__main__":
    sys.exit(main())
