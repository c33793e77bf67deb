"""Multi-locus panel genotyping: several loci recruited and solved from one
read pool (the reference's primary production mode, genotype.rs:1278-1298)."""
import numpy as np
import pytest

from locityper_tpu import sim
from locityper_tpu.pipeline import LocusData, genotype_locus
from locityper_tpu.seq.contigs import ContigSet
from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
from locityper_tpu.seq.recruit import RecruitParams, TargetIndex, recruit_read_pair
from locityper_tpu.solvers.solve import Scheme

import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).parent))
from test_pipeline import make_bg  # noqa: E402


@pytest.fixture(scope="module")
def panel():
    rng = np.random.default_rng(55)
    n_loci = 3
    loci = [sim.simulate_locus(rng, f"G{i}", length=3000, n_haps=4,
                               divergence=0.015) for i in range(n_loci)]
    parts = [sim.random_genome(rng, 20000)]
    for locus in loci:
        parts.append(locus.haplotypes[0])
        parts.append(sim.random_genome(rng, 20000))
    genome = np.concatenate(parts)
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    data = []
    for locus in loci:
        kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
        data.append(LocusData(ContigSet(locus.name, locus.hap_names,
                                        locus.haplotypes), kc))
    # One read pool from all true genotypes.
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    all_r1, all_r2, all_names = [], [], []
    for locus in loci:
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=14.0, errors=err, prefix=locus.name)
        all_r1 += reads.reads1
        all_r2 += reads.reads2
        all_names += reads.names
    return rng, loci, data, (all_r1, all_r2, all_names)


def test_panel_recruitment_separates_loci(panel):
    rng, loci, data, (r1, r2, names) = panel
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    for d in data:
        idx.add_locus(d.contig_set, d.kmer_counts)
    idx.finalize()
    correct = cross = miss = 0
    for a, b, name in zip(r1[:300], r2[:300], names[:300]):
        src = int(name[1])      # "G{i}..."
        hits = recruit_read_pair(idx, a, b)
        if src in hits:
            correct += 1
            cross += len(hits) - 1
        else:
            miss += 1
    assert correct / 300 > 0.95
    assert cross / 300 < 0.05


def test_panel_genotyping(panel):
    rng, loci, data, (r1, r2, names) = panel
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    for d in data:
        idx.add_locus(d.contig_set, d.kmer_counts)
    idx.finalize()
    per_locus = {i: ([], []) for i in range(len(loci))}
    for a, b, name in zip(r1, r2, names):
        for locus_ix in recruit_read_pair(idx, a, b):
            per_locus[locus_ix][0].append((a, b))
            per_locus[locus_ix][1].append(name)
    bg = make_bg()
    scheme = Scheme.parse(["greedy:i=5k,a=1", "anneal:i=6,a=6,n=2000,p=1000"])
    for i, locus in enumerate(loci):
        pairs, nm = per_locus[i]
        result, _ = genotype_locus(data[i], pairs, nm, bg, scheme=scheme,
                                   seed=100 + i, tag=locus.name)
        called = tuple(sorted(int(x) for x in result.genotypes[0]))
        assert called == locus.true_genotype, (
            f"{locus.name}: called {called}, truth {locus.true_genotype}")


def test_panel_batched_equals_per_locus(panel):
    """Multi-locus batched alignment (build_all_alignments_panel) must be
    bit-identical to per-locus build_all_alignments — same jobs, same
    kernel, shared L bucket."""
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.model import Params
    from locityper_tpu.model.locs import (build_all_alignments,
                                          build_all_alignments_panel)

    rng, loci, data, (r1, r2, names) = panel
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    for d in data:
        idx.add_locus(d.contig_set, d.kmer_counts)
    idx.finalize()
    per_locus = {i: ([], []) for i in range(len(loci))}
    for a, b, name in zip(r1, r2, names):
        for locus_ix in recruit_read_pair(idx, a, b):
            per_locus[locus_ix][0].append((a, b))
            per_locus[locus_ix][1].append(name)
    bg = make_bg()
    tech = bg.seq_info.technology
    params = Params(unmapped_penalty=tech.default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    if params.band is None:
        params.band = 48
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))

    inputs = [(per_locus[i][0], per_locus[i][1], data[i].contig_set,
               data[i].kmer_counts) for i in range(len(loci))]
    batched = build_all_alignments_panel(inputs, bg, edit_cache, params)
    for i in range(len(loci)):
        single, s_stats = build_all_alignments(
            per_locus[i][0], per_locus[i][1], data[i].contig_set,
            data[i].kmer_counts, bg, edit_cache, params)
        b_alns, b_stats = batched[i]
        assert s_stats == b_stats
        t1, t2 = single.table, b_alns.table
        assert len(t1) == len(t2)
        for f in ("mate", "hap", "start", "end", "fwd", "prob", "edit",
                  "n_mism", "n_ins", "n_del", "n_clip", "ws"):
            np.testing.assert_array_equal(getattr(t1, f), getattr(t2, f),
                                          err_msg=f"locus {i} field {f}")
        np.testing.assert_array_equal(single.c_prob, b_alns.c_prob)
        np.testing.assert_array_equal(single.used_mask, b_alns.used_mask)


def test_panel_group_pipeline_invariant(panel):
    """The 3-stage locus-group pipeline (round 5: candidate voting of
    group i+1 on a worker thread behind group i's device dispatch) must
    be invariant to group_size — per-locus results never depend on the
    grouping."""
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.model import Params
    from locityper_tpu.model.locs import build_all_alignments_panel

    rng, loci, data, (r1, r2, names) = panel
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    for d in data:
        idx.add_locus(d.contig_set, d.kmer_counts)
    idx.finalize()
    per_locus = {i: ([], []) for i in range(len(loci))}
    for a, b, name in zip(r1, r2, names):
        for locus_ix in recruit_read_pair(idx, a, b):
            per_locus[locus_ix][0].append((a, b))
            per_locus[locus_ix][1].append(name)
    bg = make_bg()
    tech = bg.seq_info.technology
    params = Params(unmapped_penalty=tech.default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    if params.band is None:
        params.band = 48
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
    inputs = [(per_locus[i][0], per_locus[i][1], data[i].contig_set,
               data[i].kmer_counts) for i in range(len(loci))]
    a = build_all_alignments_panel(inputs, bg, edit_cache, params,
                                   group_size=1)
    b = build_all_alignments_panel(inputs, bg, edit_cache, params,
                                   group_size=100)
    for i in range(len(loci)):
        (aa, sa), (bb, sb) = a[i], b[i]
        assert sa == sb
        np.testing.assert_array_equal(aa.table.prob, bb.table.prob)
        np.testing.assert_array_equal(aa.table.hap, bb.table.hap)
        np.testing.assert_array_equal(aa.used_mask, bb.used_mask)


def test_solve_panel_matches_per_locus(panel):
    """Cross-locus batched solving (solve_panel) must call the same
    genotypes as per-locus genotype_locus, with near-equal likelihoods
    (different RNG substreams; same search budget)."""
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.model import Params
    from locityper_tpu.model.locs import build_all_alignments_panel
    from locityper_tpu.pipeline import genotype_panel

    rng, loci, data, (r1, r2, names) = panel
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    for d in data:
        idx.add_locus(d.contig_set, d.kmer_counts)
    idx.finalize()
    per_locus = {i: ([], []) for i in range(len(loci))}
    for a, b, name in zip(r1, r2, names):
        for locus_ix in recruit_read_pair(idx, a, b):
            per_locus[locus_ix][0].append((a, b))
            per_locus[locus_ix][1].append(name)
    bg = make_bg()
    tech = bg.seq_info.technology
    params = Params(unmapped_penalty=tech.default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    if params.band is None:
        params.band = 48
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
    inputs = [(per_locus[i][0], per_locus[i][1], data[i].contig_set,
               data[i].kmer_counts) for i in range(len(loci))]
    built = build_all_alignments_panel(inputs, bg, edit_cache, params)
    scheme = Scheme.parse(["anneal:i=6,a=6,n=2000,p=1000"])

    entries = [dict(locus=data[i], read_pairs=per_locus[i][0],
                    names=per_locus[i][1], tag=loci[i].name,
                    prebuilt=built[i]) for i in range(len(loci))]
    batched = genotype_panel(entries, bg, params=params, scheme=scheme,
                             seed=7)
    for i, locus in enumerate(loci):
        single, _ = genotype_locus(
            data[i], per_locus[i][0], per_locus[i][1], bg, params=params,
            scheme=scheme, seed=300 + i, tag=locus.name,
            prebuilt_alns=built[i])
        b_res, _ = batched[i]
        called_b = tuple(sorted(int(x) for x in b_res.genotypes[0]))
        called_s = tuple(sorted(int(x) for x in single.genotypes[0]))
        assert called_b == called_s == locus.true_genotype
        # Likelihood scales agree (same objective, different RNG streams;
        # each attempt re-randomizes window tweaks, so compare within the
        # attempt-to-attempt spread).
        pb, ps = b_res.predictions[0], single.predictions[0]
        spread = 4.0 * np.sqrt(pb.lik_var / pb.attempts
                               + ps.lik_var / ps.attempts) + 1.0
        assert pb.lik_mean == pytest.approx(ps.lik_mean, abs=spread)


def test_genotype_panel_out_sams_and_multistage(panel, tmp_path):
    """Panel path with SAM output and a two-stage scheme (stage-1 culling
    runs per locus inside solve_panel)."""
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.model import Params
    from locityper_tpu.model.locs import build_all_alignments_panel
    from locityper_tpu.pipeline import genotype_panel

    rng, loci, data, (r1, r2, names) = panel
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    for d in data:
        idx.add_locus(d.contig_set, d.kmer_counts)
    idx.finalize()
    per_locus = {i: ([], []) for i in range(len(loci))}
    for a, b, name in zip(r1, r2, names):
        for locus_ix in recruit_read_pair(idx, a, b):
            per_locus[locus_ix][0].append((a, b))
            per_locus[locus_ix][1].append(name)
    bg = make_bg()
    tech = bg.seq_info.technology
    params = Params(unmapped_penalty=tech.default_unmapped_penalty(),
                    out_sams=1, dont_skip=True)
    params.set_tweak_size(bg.depth.window_size)
    if params.band is None:
        params.band = 48
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
    inputs = [(per_locus[i][0], per_locus[i][1], data[i].contig_set,
               data[i].kmer_counts) for i in range(len(loci))]
    built = build_all_alignments_panel(inputs, bg, edit_cache, params)
    scheme = Scheme.parse(["greedy:i=5,a=1", "anneal:i=4,a=4,n=1500,p=800"])
    entries = [dict(locus=data[i], read_pairs=per_locus[i][0],
                    names=per_locus[i][1], tag=loci[i].name,
                    prebuilt=built[i],
                    sam_dir=tmp_path / f"sams{i}",
                    sol_path=tmp_path / f"sol{i}.csv")
               for i in range(len(loci))]
    solved = genotype_panel(entries, bg, params=params, scheme=scheme,
                            seed=11)
    for i, locus in enumerate(loci):
        res, _ = solved[i]
        called = tuple(sorted(int(x) for x in res.genotypes[0]))
        assert called == locus.true_genotype
        sam = tmp_path / f"sams{i}" / "00.sam.gz"
        assert sam.exists()
        import gzip
        lines = gzip.open(sam, "rt").read().splitlines()
        assert sum(1 for l in lines if not l.startswith("@")) > 50
        sol = open(tmp_path / f"sol{i}.csv").read().splitlines()
        assert sol[0] == "stage\tgenotype\tscore"
        assert {l.split("\t")[0] for l in sol[1:]} == {"1", "2"}


def test_solve_panel_mixed_window_sizes(panel):
    """Loci windowed at different sizes must flow through solve_panel via
    per-size bucketed programs (previously an assert
    that died into the per-locus fallback), matching per-locus solve_locus
    calls."""
    import jax
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.model import Params
    from locityper_tpu.model.assgn import LocusTensors
    from locityper_tpu.model.locs import build_all_alignments
    from locityper_tpu.model.windows import ContigInfoPack, build_contig_infos
    from locityper_tpu.seq.contigs import Genotype
    from locityper_tpu.solvers.solve import PanelItem, solve_locus, solve_panel

    rng, loci, data, (r1, r2, names) = panel
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    for d in data:
        idx.add_locus(d.contig_set, d.kmer_counts)
    idx.finalize()
    per_locus = {i: ([], []) for i in range(len(loci))}
    for a, b, name in zip(r1, r2, names):
        for locus_ix in recruit_read_pair(idx, a, b):
            per_locus[locus_ix][0].append((a, b))
            per_locus[locus_ix][1].append(name)
    bg = make_bg()
    tech = bg.seq_info.technology
    params = Params(unmapped_penalty=tech.default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    if params.band is None:
        params.band = 48
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
    scheme = Scheme.parse(["anneal:i=6,a=6,n=2000,p=1000"])

    wsizes = [bg.depth.window_size, 2 * bg.depth.window_size]
    items, singles = [], []
    for i in (0, 1):
        alns, _ = build_all_alignments(per_locus[i][0], per_locus[i][1],
                                       data[i].contig_set,
                                       data[i].kmer_counts, bg, edit_cache,
                                       params)
        infos = build_contig_infos(data[i].contig_set, data[i].kmer_counts,
                                   wsizes[i], max(wsizes[i], 300), params)
        pack = ContigInfoPack.pack(infos)
        assert pack.window_size == wsizes[i]
        tensors = LocusTensors.build(alns)
        gts = Genotype.generate_all(len(data[i].contig_set.seqs), 2)
        genotypes = np.array([g.ids for g in gts], np.int32)
        priors = np.zeros(len(gts))
        items.append(PanelItem(tensors=tensors, pack=pack,
                               genotypes=genotypes, priors=priors,
                               tag=loci[i].name))
        singles.append(solve_locus(tensors, pack, bg, genotypes, priors,
                                   params, scheme, jax.random.PRNGKey(40 + i),
                                   tag=loci[i].name))

    solved = solve_panel(items, bg, params, scheme, jax.random.PRNGKey(9))
    for i in (0, 1):
        called_b = tuple(sorted(int(x) for x in solved[i].genotypes[0]))
        called_s = tuple(sorted(int(x) for x in singles[i].genotypes[0]))
        assert called_b == called_s == loci[i].true_genotype
