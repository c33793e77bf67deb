#!/usr/bin/env python
"""End-to-end benchmark: input reads genotyped per second on a simulated
multi-locus panel (recruit -> candidate align -> solve), on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "scheme", "extra"}.

It times the same code path the `genotype` command runs — streaming
recruitment over every input read, panel-batched device alignment
(model/locs.py:build_all_alignments_panel), dense tensor build, and the
multi-stage device solver — not an isolated kernel.  The
solver runs the REFERENCE-DEFAULT scheme (greedy:i=5k,a=1 +
anneal:i=20,a=20 with 20k anneal + 10k plateau steps —
solvers/solve.py:Scheme.default, reference solve.rs:211-229), i.e. the
same work the CLI does by default.  "extra" carries a long-read e2e
metric (BASELINE config 4) and the reduced scheme as a secondary line;
a failure of either fails the run.

Run `python bench.py --kernel` for the raw aligner-kernel metric (through
the same dispatch as the pipeline), `--light` for the reduced scheme
only, `--longread` for the long-read panel only.
"""
import json
import sys
import time

import numpy as np

DEFAULT_SCHEME_STR = "greedy:i=5k,a=1 + anneal:i=20,a=20 (reference default)"


def _make_bg(read_len=150.0, depth_per_hap=15.0, window=100):
    from locityper_tpu.bg import BgDistr, SequencingInfo, Technology
    from locityper_tpu.bg.depth import ReadDepth
    from locityper_tpu.bg.err_prof import ErrorProfile
    from locityper_tpu.bg.insertsz import InsertDistr
    from locityper_tpu.mathx.distr import NBinom

    err = ErrorProfile.estimate(997600, 2000, 200, 200,
                                [(0, 150, 100.0), (1, 150, 50.0)])
    ins = InsertDistr.from_nbinom(NBinom.estimate(400.0, 4000.0))
    hap_m = depth_per_hap * window / (2 * read_len) / 2.0
    depth = ReadDepth(2, window, 300,
                      [NBinom.estimate(hap_m, hap_m * 1.6)] * 101)
    return BgDistr(SequencingInfo(read_len, Technology.ILLUMINA), ins, err,
                   depth)


def bench_e2e(n_loci=4, n_haps=6, locus_len=4000, depth=15.0,
              scheme_kind="default"):
    import tempfile
    from pathlib import Path

    from locityper_tpu import sim
    from locityper_tpu.pipeline import LocusData, genotype_locus
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.commands.genotype import recruit_reads_fast
    from locityper_tpu.model import Params
    from locityper_tpu.model.locs import build_all_alignments_panel
    from locityper_tpu.seq.contigs import ContigSet
    from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
    from locityper_tpu.seq.recruit import RecruitParams
    from locityper_tpu.solvers.solve import Scheme

    rng = np.random.default_rng(0)
    loci = [sim.simulate_locus(rng, f"B{i}", length=locus_len, n_haps=n_haps,
                               divergence=0.015) for i in range(n_loci)]
    flanks = [sim.random_genome(rng, 20000) for _ in range(n_loci + 1)]
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
            depth=depth, read_len=150, errors=err, prefix=locus.name)
        reads1 += list(r.reads1)
        reads2 += list(r.reads2)
        names += list(r.names)
    # Background: ~10x the locus reads, drawn off-locus — recruitment
    # must scan every input read, like a real WGS sample.
    bgr = sim.simulate_paired_reads(rng, flanks * 10, depth=depth,
                                    read_len=150, errors=err, prefix="bg")
    reads1 += list(bgr.reads1)
    reads2 += list(bgr.reads2)
    names += list(bgr.names)
    total_pairs = len(reads1)
    # Write the sample as FASTQ so recruitment runs the production input
    # path (native C++ parser -> dense batches -> device kernel).
    from locityper_tpu.seq.fastx import Read, write_fastq
    tmpd = Path(tempfile.mkdtemp(prefix="bench_e2e_"))
    fq1, fq2 = tmpd / "r1.fq", tmpd / "r2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for n, a, b in zip(names, reads1, reads2):
            write_fastq(f1, Read(n, a))
            write_fastq(f2, Read(n, b))

    bg = _make_bg(depth_per_hap=depth)
    tech = bg.seq_info.technology
    params = Params(unmapped_penalty=tech.default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    if params.band is None:
        params.band = 48
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
    rp = RecruitParams(match_frac=tech.default_match_frac(True))
    if scheme_kind == "default":
        scheme, scheme_str = Scheme.default(), DEFAULT_SCHEME_STR
    else:
        scheme = Scheme.parse(["greedy:i=5k,a=1",
                               "anneal:i=8,a=8,n=3000,p=2000"])
        scheme_str = "greedy:i=5k,a=1 + anneal:i=8,a=8,n=3000,p=2000 (light)"

    from locityper_tpu.pipeline import genotype_panel

    def one_pass(seed):
        t0 = time.perf_counter()
        rec, _speed = recruit_reads_fast(data, str(fq1), str(fq2), rp,
                                         seed=seed)
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
        calls = [tuple(sorted(res.genotypes[0])) for res, _ in solved]
        t3 = time.perf_counter()
        print(f"phases: recruit={t1 - t0:.2f}s align={t2 - t1:.2f}s "
              f"solve={t3 - t2:.2f}s", file=sys.stderr)
        return t3 - t0, calls

    _dt, calls = one_pass(1)                 # warmup: compiles
    truth = [tuple(sorted(l.true_genotype)) for l in loci]
    acc = sum(c == t for c, t in zip(calls, truth))
    # Best of 3 warm passes.
    dt = min(one_pass(seed)[0] for seed in (2, 3, 4))
    reads_per_sec = total_pairs / dt
    print(f"panel={n_loci}x{n_haps}hap pairs={total_pairs} warm_wall={dt:.2f}s"
          f" s/locus={dt / n_loci:.2f} exact_calls={acc}/{n_loci}",
          file=sys.stderr)
    return {
        "metric": "e2e_reads_genotyped_per_sec_panel",
        "value": round(float(reads_per_sec), 1),
        "unit": "read pairs/s",
        "scheme": scheme_str,
        "exact": f"{acc}/{n_loci}",
    }


def bench_longread(n_loci=3, n_haps=4, locus_len=16384, depth=10.0):
    """Long-read (ONT-like) end-to-end panel: device Kadane recruitment
    over every input read (ops/recruit.py long path, recruit.rs:940-964),
    banded alignment, and the default solver scheme.  Metric: input bases
    genotyped per second (BASELINE config 4)."""
    from locityper_tpu import sim
    from locityper_tpu.bg import BgDistr, SequencingInfo, Technology
    from locityper_tpu.bg.depth import ReadDepth
    from locityper_tpu.bg.err_prof import ErrorProfile
    from locityper_tpu.bg.insertsz import InsertDistr
    from locityper_tpu.commands.genotype import recruit_reads
    from locityper_tpu.mathx.distr import NBinom
    from locityper_tpu.pipeline import LocusData, genotype_locus
    from locityper_tpu.seq.contigs import ContigSet
    from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
    from locityper_tpu.seq.recruit import RecruitParams
    from locityper_tpu.solvers.solve import Scheme

    rng = np.random.default_rng(7)
    loci = [sim.simulate_locus(rng, f"L{i}", length=locus_len, n_haps=n_haps,
                               divergence=0.01) for i in range(n_loci)]
    flanks = [sim.random_genome(rng, 30000) for _ in range(n_loci + 1)]
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

    err = sim.ErrorModel(mismatch=0.02, insertion=0.008, deletion=0.008)
    reads, names = [], []
    for locus in loci:
        r = sim.simulate_single_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=depth, read_len_mean=12000, read_len_sd=2000, errors=err,
            prefix=locus.name)
        reads += list(r.reads1)
        names += list(r.names)
    bgr = sim.simulate_single_reads(rng, flanks, depth=depth / 2,
                                    read_len_mean=12000, read_len_sd=2000,
                                    errors=err, prefix="bg")
    reads += list(bgr.reads1)
    names += list(bgr.names)
    total_bp = int(sum(r.size for r in reads))

    ep = ErrorProfile.estimate(950000, 20000, 8000, 8000,
                               [(420, 12000, 50.0), (470, 12000, 30.0)])
    window = 2000
    m = depth * window / 12000.0 / 2.0
    bg = BgDistr(SequencingInfo(12000.0, Technology.NANOPORE),
                 InsertDistr.undefined(), ep,
                 ReadDepth(2, window, max(window, 300),
                           [NBinom.estimate(m, m * 1.5)] * 101))
    rp = RecruitParams(
        match_frac=Technology.NANOPORE.default_match_frac(False),
        match_length=2000)
    scheme = Scheme.default()

    def one_pass(seed):
        t0 = time.perf_counter()
        rec, _ = recruit_reads(
            data, ((n, r, None) for n, r in zip(names, reads)), rp,
            seed=seed)
        t1 = time.perf_counter()
        calls = []
        for locus in loci:
            pairs, rnames = rec[locus.name]
            res, _ = genotype_locus(data[locus.name], pairs, rnames, bg,
                                    scheme=scheme, seed=seed)
            calls.append(tuple(sorted(res.genotypes[0])))
        t2 = time.perf_counter()
        print(f"longread phases: recruit={t1 - t0:.2f}s "
              f"align+solve={t2 - t1:.2f}s", file=sys.stderr)
        return t2 - t0, calls

    _, calls = one_pass(1)            # warmup: compiles
    truth = [tuple(sorted(l.true_genotype)) for l in loci]
    acc = sum(c == t for c, t in zip(calls, truth))
    dt = min(one_pass(seed)[0] for seed in (2, 3))
    bp_per_sec = total_bp / dt
    print(f"longread panel={n_loci}x{n_haps}hap reads={len(reads)} "
          f"bp={total_bp} warm_wall={dt:.2f}s exact={acc}/{n_loci}",
          file=sys.stderr)
    return {
        "metric": "longread_e2e_bp_per_sec",
        "value": round(float(bp_per_sec), 1),
        "unit": "input bp/s",
        "exact": f"{acc}/{n_loci}",
        "scheme": DEFAULT_SCHEME_STR,
    }


def bench_kernel():
    """Raw banded-ML-aligner throughput through ops/align.align_batch_auto
    (the kernel the pipeline's route selects)."""
    import jax
    import jax.numpy as jnp
    from locityper_tpu.ops import align as A
    from locityper_tpu import sim

    rng = np.random.default_rng(0)
    L, band, batch = 152, 48, 4096
    hap = sim.random_genome(rng, 200_000)
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    sc = A.Scores.from_error_rates(0.002, 0.0002, 0.0002)
    score_vec = np.array(sc.astuple(), np.float32)

    reads = np.full((batch, L), 4, np.int8)
    lens = np.zeros(batch, np.int32)
    wins = np.full((batch, L + band), 4, np.int8)
    for i in range(batch):
        start = int(rng.integers(0, hap.size - L - 1))
        r = err.apply(rng, hap[start:start + L])[:L]
        lens[i] = r.size
        reads[i, :r.size] = r
        wins[i] = A.extract_windows(hap, np.array([start - band // 2]),
                                    L + band)[0]
    inputs = (jax.device_put(reads), jax.device_put(lens),
              jax.device_put(wins))

    def run(r, l, w):
        return A.align_batch_auto(r, l, w, score_vec, band=band)

    N_CHAIN = 32

    @jax.jit
    def chained(reads, lens, wins):
        def body(i, acc):
            out = run(jnp.roll(reads, i, axis=0), jnp.roll(lens, i, axis=0),
                      jnp.roll(wins, i, axis=0))
            return acc + jnp.sum(out["score"])
        return jax.lax.fori_loop(0, N_CHAIN, body, jnp.float32(0.0))

    _ = float(np.asarray(chained(*inputs)))
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        _ = float(np.asarray(chained(*inputs)))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    rps = N_CHAIN * batch / best
    return {
        "metric": "reads_aligned_per_sec",
        "value": round(float(rps), 1),
        "unit": "reads/s",
    }


def main():
    from locityper_tpu.cli import _enable_compile_cache
    from locityper_tpu.utils.malloc import tune_host_allocator
    _enable_compile_cache()
    tune_host_allocator()
    if "--kernel" in sys.argv:
        print(json.dumps(bench_kernel()))
    elif "--light" in sys.argv:
        print(json.dumps(bench_e2e(scheme_kind="light")))
    elif "--longread" in sys.argv:
        print(json.dumps(bench_longread()))
    else:
        # Primary: reference-default solver scheme.
        res = bench_e2e(scheme_kind="default")
        lr = bench_longread()
        lt = bench_e2e(scheme_kind="light")
        res["extra"] = dict(
            longread_bp_per_sec=lr["value"], longread_exact=lr["exact"],
            light_scheme_pairs_per_sec=lt["value"],
            light_scheme_exact=lt["exact"])
        print(json.dumps(res))


if __name__ == "__main__":
    main()
