"""Region-weight-aware alignment probabilities.

Reference semantics: model/windows.rs:507-575 `weighted_aln_prob` — each
CIGAR op contributes weight(ref position)·ln p(op); the sum is renormalized
by sum_len/sum_weight so only RELATIVE weight differences within one
alignment matter.  Terminal soft clips are limited to the contig bounds
(aln.rs limited_clipping) and weighted at the alignment's end positions.
"""
import numpy as np
import pytest

from locityper_tpu import sim
from locityper_tpu.bg import BgDistr
from locityper_tpu.bg.err_prof import EditDistCache, EditThresh, ErrorProfile
from locityper_tpu.bg.insertsz import InsertDistr
from locityper_tpu.model import Params
from locityper_tpu.model.locs import build_all_alignments
from locityper_tpu.model.windows import ExplicitWeights
from locityper_tpu.seq.contigs import ContigSet
from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts

from test_pipeline import make_bg


def _prof():
    return ErrorProfile.estimate(997600, 2000, 200, 200,
                                 [(0, 150, 100.0), (1, 150, 50.0)])


class TestWeightedAlnLnProb:
    def test_hand_computed(self):
        """5= 2X 1I 3D 4= starting at ref 10, with weight 0.25 on [12, 20)
        and 1.0 elsewhere; every term written out by hand."""
        p = _prof()
        w = np.ones(40)
        w[12:20] = 0.25
        ops = np.array([0, 1, 2, 3, 0], np.int32)
        lens = np.array([5, 2, 1, 3, 4], np.int32)
        # ref walk: = at 10..15 (w 1,1,.25,.25,.25), X at 15..17 (.25,.25),
        # I at rpos 17 (len 1 -> 1*.25), D at 17..20 (.25,.25,.25),
        # = at 20..24 (1,1,1,1).
        prob = ((1 + 1 + .25 * 3) * p.ln_match + (.25 * 2) * p.ln_mismatch
                + .25 * p.ln_insertion + (.25 * 3) * p.ln_deletion
                + 4.0 * p.ln_match)
        sum_w = (1 + 1 + .25 * 3) + .25 * 2 + .25 + .25 * 3 + 4.0
        sum_len = 5 + 2 + 1 + 3 + 4
        expected = prob * sum_len / sum_w
        got, edit, read_len = p.weighted_aln_ln_prob(ops, lens, 10, 24, w, 40)
        assert got == pytest.approx(expected, rel=1e-12)
        assert edit == 2 + 1 + 3
        assert read_len == sum_len - 3

    def test_clipping_limited_to_contig_bounds(self):
        """10S 5= 10S at ref [3, 8) on a 10 bp contig: only 3 left-clip and
        2 right-clip bases are chargeable (limited_clipping semantics),
        weighted at the alignment's terminal ref positions."""
        p = _prof()
        w = np.ones(10)
        w[3] = 2.0      # left clip weighted at ref_start
        w[8] = 4.0      # right clip weighted at ref_end
        ops = np.array([4, 0, 4], np.int32)
        lens = np.array([10, 5, 10], np.int32)
        # match span [3, 8) includes ref 3 (w=2): Σw_match = 2+1+1+1+1 = 6.
        prob = 6.0 * p.ln_match + (3 * 2.0 + 2 * 4.0) * p.ln_clipping
        sum_w = 6.0 + 3 * 2.0 + 2 * 4.0
        sum_len = 5 + 3 + 2
        got, edit, read_len = p.weighted_aln_ln_prob(ops, lens, 3, 8, w, 10)
        assert got == pytest.approx(prob * sum_len / sum_w, rel=1e-12)
        assert edit == 0
        assert read_len == sum_len      # no deletions

    def test_uniform_weights_equal_unweighted(self):
        """All-ones weights must reproduce Σ count·ln p(op) exactly
        (windows.rs:571 normalization cancels)."""
        p = _prof()
        rng = np.random.default_rng(7)
        for _ in range(20):
            n = int(rng.integers(3, 9))
            ops = rng.choice([0, 1, 2, 3], size=n).astype(np.int32)
            ops[0] = 0                       # keep clips out of the middle
            lens = rng.integers(1, 20, size=n).astype(np.int32)
            span = int(lens[(ops == 0) | (ops == 1) | (ops == 3)].sum())
            start = int(rng.integers(0, 50))
            w = np.ones(start + span + 60)
            got, edit, _ = p.weighted_aln_ln_prob(
                ops, lens, start, start + span, w, start + span + 60)
            counts = [int(lens[ops == o].sum()) for o in range(5)]
            expected = p.ln_prob_counts(counts[0], counts[1], counts[2],
                                        counts[3], counts[4])
            assert got == pytest.approx(float(expected), rel=1e-12)
            assert edit == counts[1] + counts[2] + counts[3]

    def test_downweight_shrinks_mismatch_penalty(self):
        """Mismatches inside a near-zero-weight region barely lower the
        probability relative to an error-free alignment — the point of
        --reg-weights (windows.rs:566-571 renormalization keeps uniform
        regions unaffected; only straddlers change)."""
        p = _prof()
        L = 200
        clean = (np.array([0], np.int32), np.array([150], np.int32))
        dirty = (np.array([0, 1, 0], np.int32),
                 np.array([75, 5, 70], np.int32))
        uni = np.ones(L)
        down = np.ones(L)
        down[75:] = 0.01                     # mismatches all land in here
        gap_uni = (p.weighted_aln_ln_prob(*clean, 0, 150, uni, L)[0]
                   - p.weighted_aln_ln_prob(*dirty, 0, 150, uni, L)[0])
        gap_down = (p.weighted_aln_ln_prob(*clean, 0, 150, down, L)[0]
                    - p.weighted_aln_ln_prob(*dirty, 0, 150, down, L)[0])
        assert gap_uni > 0
        assert 0 < gap_down < 0.2 * gap_uni

    def test_fully_downweighted_alignment_unchanged(self):
        """An alignment entirely inside a uniformly down-weighted region is
        NOT penalized globally (the sum_len/sum_weight renormalization,
        windows.rs:566-571)."""
        p = _prof()
        ops = np.array([0, 1, 0], np.int32)
        lens = np.array([60, 3, 60], np.int32)
        uni = np.ones(300)
        low = np.full(300, 0.05)
        a = p.weighted_aln_ln_prob(ops, lens, 50, 173, uni, 300)[0]
        b = p.weighted_aln_ln_prob(ops, lens, 50, 173, low, 300)[0]
        assert a == pytest.approx(b, rel=1e-9)


class TestPipelineReweight:
    def _world(self):
        """Two haplotypes identical except for mismatches in [1500, 1600);
        paired reads drawn from hap A straddle that region."""
        rng = np.random.default_rng(11)
        hapA = sim.random_genome(rng, 3000)
        hapB = hapA.copy()
        pos = np.arange(1505, 1595, 12)
        hapB[pos] = (hapB[pos] + 1 + rng.integers(0, 3, pos.size)) % 4
        cset = ContigSet("W", ["hA", "hB"], [hapA, hapB])
        counter = GenomeKmerCounter(25)
        counter.add_seq(np.concatenate([sim.random_genome(rng, 8000), hapA]))
        counter.finalize()
        kc = off_target_counts(counter, [hapA, hapB], hapA)

        bg = make_bg()
        params = Params(unmapped_penalty=bg.seq_info.technology
                        .default_unmapped_penalty())
        params.set_tweak_size(bg.depth.window_size)
        params.band = 48
        cache = EditDistCache(bg.err_prof, EditThresh.default_for(
            bg.seq_info.technology))
        from locityper_tpu.seq import dna
        pairs, names = [], []
        for i in range(25):
            # mate1 [s, s+150) always straddles the down-weighted region's
            # left edge (1450) — a fully-inside alignment is renormalized
            # back to unweighted (windows.rs:566-571) and would not shrink.
            s = 1380 + int(rng.integers(0, 50))
            pairs.append((hapA[s:s + 150].copy(),
                          dna.revcomp(hapA[s + 300:s + 450])))
            names.append(f"r{i}")
        return cset, kc, bg, params, cache, pairs, names

    @staticmethod
    def _gap(alns):
        """Mean best-candidate prob difference hapA − hapB per read."""
        gaps = []
        for r in np.unique(alns.c_read):
            sel = alns.c_read == r
            pa = alns.c_prob[sel & (alns.c_hap == 0)]
            pb = alns.c_prob[sel & (alns.c_hap == 1)]
            if pa.size and pb.size:
                gaps.append(pa.max() - pb.max())
        assert gaps
        return float(np.mean(gaps))

    def test_downweight_region_shrinks_hap_gap(self):
        cset, kc, bg, params, cache, pairs, names = self._world()
        base, _ = build_all_alignments(pairs, names, cset, kc, bg, cache,
                                       params)
        ew = ExplicitWeights({"hA": [(1450, 1650, 0.01)],
                              "hB": [(1450, 1650, 0.01)]})
        down, _ = build_all_alignments(pairs, names, cset, kc, bg, cache,
                                       params, explicit_weights=ew)
        g0, g1 = self._gap(base), self._gap(down)
        assert g0 > 5.0                      # mismatches discriminate
        assert 0 <= g1 < 0.5 * g0            # down-weighting neutralizes

    def test_uniform_explicit_weights_keep_probs(self):
        """ExplicitWeights with no intervals (all 1.0) must reproduce the
        kernel's unweighted probabilities (up to f32 vs f64 accumulation)."""
        cset, kc, bg, params, cache, pairs, names = self._world()
        base, _ = build_all_alignments(pairs, names, cset, kc, bg, cache,
                                       params)
        uni, _ = build_all_alignments(pairs, names, cset, kc, bg, cache,
                                      params, explicit_weights=
                                      ExplicitWeights({}))
        np.testing.assert_array_equal(base.c_read, uni.c_read)
        np.testing.assert_array_equal(base.c_hap, uni.c_hap)
        np.testing.assert_allclose(base.c_prob, uni.c_prob, rtol=1e-4)
