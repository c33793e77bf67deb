"""Vectorized build_all_alignments must be bit-identical to the readable
per-read oracle (build_all_alignments_obj) — guards the
array-native rewrite of the post-alignment phase (locs.rs:736-1004)."""
import numpy as np
import pytest

from locityper_tpu import sim
from locityper_tpu.bg import BgDistr, SequencingInfo, Technology
from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
from locityper_tpu.model import Params
from locityper_tpu.model.assgn import LocusTensors
from locityper_tpu.model.locs import (build_all_alignments,
                                      build_all_alignments_obj)

from test_pipeline import make_bg, make_locus


def _world(seed=0, n_pairs=300, paired=True, n_haps=5, divergence=0.015):
    rng, locus, data = make_locus(seed=seed, n_haps=n_haps,
                                  divergence=divergence)
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    err = sim.ErrorModel(0.003, 0.0003, 0.0003)
    reads = sim.simulate_paired_reads(rng, true_haps, depth=12.0, errors=err)
    if paired:
        pairs = list(zip(reads.reads1, reads.reads2))[:n_pairs]
    else:
        pairs = [(r, None) for r in reads.reads1[:n_pairs]]
    names = reads.names[:n_pairs]
    bg = make_bg()
    if not paired:
        # Single-end insert distr.
        from locityper_tpu.bg.insertsz import InsertDistr
        bg = BgDistr(bg.seq_info, InsertDistr.undefined(), bg.err_prof,
                     bg.depth)
    params = Params()
    params.band = 48
    params.set_tweak_size(bg.depth.window_size)
    cache = EditDistCache(bg.err_prof, EditThresh.default_for(
        Technology.ILLUMINA))
    return data, pairs, names, bg, params, cache


def _assert_parity(data, pairs, names, bg, params, cache):
    vec, stats_v = build_all_alignments(pairs, names, data.contig_set,
                                        data.kmer_counts, bg, cache, params)
    reads_o, unused_o, stats_o = build_all_alignments_obj(
        pairs, names, data.contig_set, data.kmer_counts, bg, cache, params)
    assert stats_v == stats_o

    reads_v = vec.reads
    assert len(reads_v) == len(reads_o) == vec.n_used
    assert len(vec.unused_reads) == len(unused_o)
    for rv, ro in zip(reads_v + vec.unused_reads, reads_o + unused_o):
        assert rv.name == ro.name
        assert rv.read_ix == ro.read_ix
        assert rv.weight == pytest.approx(ro.weight, abs=0, rel=0)
        assert rv.unmapped_prob == pytest.approx(ro.unmapped_prob, abs=0,
                                                 rel=0)
        assert len(rv.cands) == len(ro.cands), rv.name
        for cv, co in zip(rv.cands, ro.cands):
            assert (cv.hap, cv.middle1, cv.middle2) == \
                (co.hap, co.middle1, co.middle2), rv.name
            assert cv.ln_prob == co.ln_prob, rv.name
            for av, ao in ((cv.aln1, co.aln1), (cv.aln2, co.aln2)):
                assert (av is None) == (ao is None)
                if av is not None:
                    assert (av.hap, av.start, av.end, av.fwd, av.edit,
                            av.ws) == (ao.hap, ao.start, ao.end, ao.fwd,
                                       ao.edit, ao.ws)
                    assert av.ln_prob == ao.ln_prob

    # Dense tensors: array scatter path vs per-read object oracle.
    t_vec = LocusTensors.build(vec)

    class _Obj:
        n_haps = vec.n_haps
        reads = reads_o
    t_obj = LocusTensors._build_from_objects(_Obj())
    np.testing.assert_array_equal(t_vec.hap_prob, t_obj.hap_prob)
    np.testing.assert_array_equal(t_vec.hap_mid, t_obj.hap_mid)
    np.testing.assert_array_equal(t_vec.unmapped_prob, t_obj.unmapped_prob)
    assert t_vec.n_reads == t_obj.n_reads

    # best_aln_matrix vectorized twin.
    if vec.n_used:
        ref = np.empty((vec.n_haps, vec.n_used))
        for r, ra in enumerate(reads_o):
            for h in range(vec.n_haps):
                ref[h, r] = ra.best_at_hap(h, ra.unmapped_prob)
        np.testing.assert_array_equal(vec.best_aln_matrix(), ref)
    return stats_v


class TestLocsParity:
    def test_paired(self):
        stats = _assert_parity(*_world(seed=0, n_pairs=300))
        assert stats["n_alns"] > 100

    def test_paired_high_divergence(self):
        _assert_parity(*_world(seed=3, n_pairs=200, divergence=0.05,
                               n_haps=6))

    def test_single_end(self):
        stats = _assert_parity(*_world(seed=1, n_pairs=200, paired=False))
        assert stats["n_alns"] > 50

    def test_empty(self):
        data, pairs, names, bg, params, cache = _world(seed=2, n_pairs=4)
        rng = np.random.default_rng(99)
        junk = [(sim.random_genome(rng, 150), sim.random_genome(rng, 150))
                for _ in range(4)]
        _assert_parity(data, junk, [f"j{i}" for i in range(4)], bg, params,
                       cache)


def test_low_complexity_relaxes_edit_threshold():
    """locs.rs:510-528: reads whose primary alignment sits in a
    low-complexity neighbourhood accept edits up to poor_compl_edit*len;
    with the relaxation disabled the same reads are poorly mapped."""
    import numpy as np

    from locityper_tpu import sim
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.model import Params
    from locityper_tpu.model.locs import build_all_alignments
    from locityper_tpu.seq.contigs import ContigSet
    from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
    from test_pipeline import make_bg

    rng = np.random.default_rng(0)
    # Haplotype with a long dinucleotide repeat in the middle: linguistic
    # complexity there is far below poor_compl=0.5.
    flank1 = sim.random_genome(rng, 1200)
    repeat = np.tile(np.array([0, 1], np.int8), 600)       # ACAC... x600
    flank2 = sim.random_genome(rng, 1200)
    hap = np.concatenate([flank1, repeat, flank2])
    cset = ContigSet("LC", ["h0"], [hap])
    counter = GenomeKmerCounter(25)
    counter.add_seq(np.concatenate([sim.random_genome(rng, 5000), hap]))
    counter.finalize()
    kc = off_target_counts(counter, [hap], hap)

    bg = make_bg()
    params = Params(
        unmapped_penalty=bg.seq_info.technology.default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    params.band = 48
    edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(
        bg.seq_info.technology))
    good, _passable = edit_cache.get(150)

    # Paired reads from the repeat with edit distance just above `good`.
    err = sim.ErrorModel(mismatch=(good + 3) / 150.0, insertion=0.0,
                         deletion=0.0)
    pairs, names = [], []
    for i in range(30):
        s = 1250 + int(rng.integers(0, 500))
        r1 = err.apply(rng, hap[s:s + 150])[:150]
        r2 = err.apply(rng, hap[s + 250:s + 400])[:150]
        pairs.append((r1, r2))
        names.append(f"p{i}")

    relaxed, st_rel = build_all_alignments(pairs, names, cset, kc, bg,
                                           edit_cache, params)
    params_off = Params(
        unmapped_penalty=bg.seq_info.technology.default_unmapped_penalty(),
        poor_compl=0.0)                        # relaxation can never fire
    params_off.set_tweak_size(bg.depth.window_size)
    params_off.band = 48
    strict, st_off = build_all_alignments(pairs, names, cset, kc, bg,
                                          edit_cache, params_off)
    assert st_rel["poorly_mapped"] < st_off["poorly_mapped"], (st_rel, st_off)
    assert relaxed.n_used > strict.n_used
