"""Adversarial correctness oracles: the simulator's
hard cases — near-identical haplotype clusters, paralog decoys sharing
95-99% identical sequence (the CYP2D6/CYP2D7 stress, BASELINE config 3),
and GC-biased depth that makes the 101-GC-bin depth model load-bearing
(reference bg/depth.rs:42-91)."""
import numpy as np
import pytest

from locityper_tpu import sim
from locityper_tpu.bg import BgDistr, SequencingInfo, Technology
from locityper_tpu.bg.depth import ReadDepth
from locityper_tpu.bg.err_prof import ErrorProfile
from locityper_tpu.bg.insertsz import InsertDistr
from locityper_tpu.mathx.distr import NBinom
from locityper_tpu.pipeline import LocusData, genotype_locus
from locityper_tpu.seq.contigs import ContigSet
from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
from locityper_tpu.solvers.solve import Scheme

SCHEME = Scheme.parse(["greedy:i=5k,a=1", "anneal:i=8,a=8,n=3000,p=2000"])
ERR = sim.ErrorModel(0.002, 0.0002, 0.0002)


def make_bg(read_len=150.0, depth_per_hap=15.0, window=100,
            gc_curve=None):
    """Background distributions matching the simulator; with `gc_curve`
    (a [101] acceptance-probability array) the per-GC-bin depth means
    follow the curve, as preproc's estimator would fit from a biased
    library."""
    err = ErrorProfile.estimate(997600, 2000, 200, 200,
                                [(0, 150, 100.0), (1, 150, 50.0)])
    ins = InsertDistr.from_nbinom(NBinom.estimate(400.0, 4000.0))
    hap_m = depth_per_hap * window / (2 * read_len) / 2.0
    if gc_curve is None:
        distrs = [NBinom.estimate(hap_m, hap_m * 1.6)] * 101
    else:
        distrs = [NBinom.estimate(max(hap_m * c, 0.05),
                                  max(hap_m * c, 0.05) * 1.6)
                  for c in gc_curve]
    depth = ReadDepth(2, window, 300, distrs)
    return BgDistr(SequencingInfo(read_len, Technology.ILLUMINA), ins, err,
                   depth)


def locus_data(locus, genome_extra=()):
    """LocusData with off-target counts over a genome that embeds the
    reference haplotype plus any decoy sequences."""
    rng = np.random.default_rng(99)
    genome = np.concatenate(
        [sim.random_genome(rng, 30000), locus.haplotypes[0]]
        + [np.concatenate([sim.random_genome(rng, 10000), d])
           for d in genome_extra]
        + [sim.random_genome(rng, 30000)])
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
    return LocusData(ContigSet(locus.name, locus.hap_names,
                               locus.haplotypes), kc)


class TestNearIdenticalHaps:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_sub_half_percent_twins(self, seed):
        """Each true haplotype has same-clade siblings at 0.3% divergence
        (~15 diffs over 5 kb); the call must still be exact."""
        rng = np.random.default_rng(100 + seed)
        locus = sim.simulate_structured_locus(
            rng, "NI", length=5000, n_clades=3, haps_per_clade=3,
            clade_divergence=0.02, within_divergence=0.003)
        data = locus_data(locus)
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=18.0, errors=ERR)
        res, _ = genotype_locus(
            data, list(zip(reads.reads1, reads.reads2)), reads.names,
            make_bg(depth_per_hap=18.0), scheme=SCHEME, seed=seed)
        called = tuple(sorted(res.genotypes[0]))
        assert called == locus.true_genotype, (
            f"seed {seed}: called {called}, truth {locus.true_genotype}, "
            f"top5={[tuple(g) for g in res.genotypes[:5]]}")


class TestParalogDecoy:
    @pytest.mark.parametrize("seed,identity", [(0, 0.97), (1, 0.99)])
    def test_decoy_reads_do_not_corrupt_call(self, seed, identity):
        """A diploid paralog at 97-99% identity lives elsewhere in the
        genome and sheds reads that recruitment pulls in; off-target k-mer
        counts (which see the decoy) must down-weight the shared sequence
        so the call stays exact."""
        from locityper_tpu.commands.genotype import recruit_reads
        from locityper_tpu.seq.recruit import RecruitParams

        rng = np.random.default_rng(200 + seed)
        locus = sim.simulate_locus(rng, "PD", length=4000, n_haps=5,
                                   divergence=0.015)
        decoy = sim.make_paralog(rng, locus.haplotypes[0],
                                 identity=identity)
        data = locus_data(locus, genome_extra=[decoy])

        true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
        rd_true = sim.simulate_paired_reads(rng, true_haps, depth=16.0,
                                            errors=ERR, prefix="t")
        # The decoy is present in BOTH sample haplotypes (depth 2x16).
        rd_decoy = sim.simulate_paired_reads(rng, [decoy, decoy],
                                             depth=16.0, errors=ERR,
                                             prefix="d")
        rd_bg = sim.simulate_paired_reads(
            rng, [sim.random_genome(rng, 20000)], depth=16.0, errors=ERR,
            prefix="b")
        names = rd_true.names + rd_decoy.names + rd_bg.names
        all1 = rd_true.reads1 + rd_decoy.reads1 + rd_bg.reads1
        all2 = rd_true.reads2 + rd_decoy.reads2 + rd_bg.reads2
        order = np.random.default_rng(seed).permutation(len(names))

        rec, _ = recruit_reads(
            {"PD": data},
            ((names[i], all1[i], all2[i]) for i in order),
            RecruitParams(match_frac=0.6), batch=512, use_device=False)
        pairs, rnames = rec["PD"]
        # The decoy actually stresses recruitment: some decoy reads must
        # have been recruited for this test to mean anything.
        n_decoy = sum(n.startswith("d") for n in rnames)
        assert n_decoy > 0, "decoy shed no recruited reads; not a stress"

        res, _ = genotype_locus(data, pairs, rnames,
                                make_bg(depth_per_hap=16.0),
                                scheme=SCHEME, seed=seed)
        called = tuple(sorted(res.genotypes[0]))
        assert called == locus.true_genotype, (
            f"identity {identity}: called {called}, "
            f"truth {locus.true_genotype}, {n_decoy} decoy reads recruited")


class TestGCBiasedDepth:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_gc_wave_coverage(self, seed):
        """Isochore-structured locus + GC-dependent fragment acceptance:
        realized coverage varies ~5x along the locus.  With the matched
        per-GC-bin depth model the call must be exact."""
        rng = np.random.default_rng(300 + seed)
        base = sim.random_genome_gc(rng, 4500, gc_low=0.25, gc_high=0.70)
        locus = sim.simulate_locus(rng, "GC", n_haps=5, divergence=0.015,
                                   base=base)
        data = locus_data(locus)
        curve = sim.gc_bias_curve(strength=0.8, center=0.45)
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=26.0, errors=ERR, gc_bias=curve)
        assert len(reads.reads1) < 26.0 * 2 * 4500 / (2 * 150), \
            "bias rejected nothing; curve not load-bearing"
        res, _ = genotype_locus(
            data, list(zip(reads.reads1, reads.reads2)), reads.names,
            make_bg(depth_per_hap=26.0, gc_curve=curve),
            scheme=SCHEME, seed=seed)
        called = tuple(sorted(res.genotypes[0]))
        assert called == locus.true_genotype, (
            f"seed {seed}: called {called}, truth {locus.true_genotype}")
