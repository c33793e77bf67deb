"""Arbitrary-ploidy genotyping: the reference
enumerates genotypes for any ploidy (genotype.rs:1077-1108 via
ext/vec.rs:293-339).  The device tensors scale as K = P·Kh + 1 candidates
and W = 2 + P·max_windows windows."""
import numpy as np
import pytest

import jax

from locityper_tpu import sim
from locityper_tpu.model import Params
from locityper_tpu.ops.solver import SolverConfig, solve_genotypes
from locityper_tpu.pipeline import genotype_locus
from locityper_tpu.seq.contigs import Genotype
from locityper_tpu.solvers.ilp import (assemble_genotype_host,
                                       likelihood_of_assignment, solve_ilp)
from locityper_tpu.solvers.solve import Scheme

from test_ilp import small_problem
from test_pipeline import make_bg, make_locus


class TestEnumeration:
    def test_generate_all_p3(self):
        gts = Genotype.generate_all(4, 3)
        # C(4+3-1, 3) = 20 combinations with replacement, sorted ids.
        assert len(gts) == 20
        assert all(tuple(sorted(g.ids)) == tuple(g.ids) for g in gts)
        assert len({g.ids for g in gts}) == 20


class TestIlpP3:
    def test_objective_consistency_p3(self):
        tensors, pack, bayes, params = small_problem()
        gt = (0, 1, 2)
        assignment, lik = solve_ilp(gt, tensors, pack, bayes, params)
        probs, wins, valid, win_gc, win_weight = assemble_genotype_host(
            gt, tensors, pack, bayes, params.prob_diff)
        assert probs.shape[1] == 3 * tensors.kh + 1
        assert win_gc.size == 2 + 3 * pack.max_windows
        assert valid[np.arange(len(assignment)), assignment].all()
        recomputed = likelihood_of_assignment(
            assignment, probs, wins, win_gc, win_weight, bayes,
            params.depth_contrib, params.aln_contrib)
        assert lik == pytest.approx(recomputed, rel=1e-9)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_annealer_reaches_ilp_optimum_p3(self, seed):
        """The device annealer must reach the exact ILP optimum for a
        triploid genotype."""
        tensors, pack, bayes, params = small_problem(seed)
        gt = (0, 1, 2)
        _, ilp_lik = solve_ilp(gt, tensors, pack, bayes, params)
        # P=3 triples the move space per read; give the chains a larger
        # budget than the diploid oracle test.
        cfg = SolverConfig(anneal_steps=8000, polish_steps=8000,
                           depth_contrib=params.depth_contrib,
                           aln_contrib=params.aln_contrib,
                           prob_diff=params.prob_diff,
                           tweak=0, window_size=pack.window_size)
        liks, _ = solve_genotypes(
            jax.random.PRNGKey(seed), np.array([gt], np.int32),
            tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob,
            pack.n_windows, pack.reg_start, pack.contig_len, pack.gc_at,
            pack.weight_at, bayes, cfg, n_attempts=16,
            max_windows=pack.max_windows)
        best = float(np.max(np.asarray(liks)))
        assert best == pytest.approx(ilp_lik, abs=0.05), \
            f"anneal {best} vs ILP {ilp_lik}"
        assert best <= ilp_lik + 0.05

    def test_ilp_p1(self):
        """Haploid genotypes run natively as P=1 (no dummy haplotype)."""
        tensors, pack, bayes, params = small_problem(2)
        gt = (1,)
        assignment, lik = solve_ilp(gt, tensors, pack, bayes, params)
        probs, wins, valid, win_gc, win_weight = assemble_genotype_host(
            gt, tensors, pack, bayes, params.prob_diff)
        assert probs.shape[1] == tensors.kh + 1
        recomputed = likelihood_of_assignment(
            assignment, probs, wins, win_gc, win_weight, bayes,
            params.depth_contrib, params.aln_contrib)
        assert lik == pytest.approx(recomputed, rel=1e-9)


class TestTriploidRecovery:
    def test_recovers_true_triploid_genotype(self):
        """A simulated triploid locus (3 distinct haplotypes at equal depth)
        must be genotyped exactly at ploidy=3."""
        rng, locus, data = make_locus(seed=11, n_haps=5)
        bg = make_bg(depth_per_hap=15.0)
        truth = tuple(sorted(rng.choice(5, size=3, replace=False).tolist()))
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in truth], depth=15.0,
            errors=sim.ErrorModel(0.002, 0.0002, 0.0002))
        result, _ = genotype_locus(
            data, list(zip(reads.reads1, reads.reads2)), reads.names, bg,
            ploidy=3,
            scheme=Scheme.parse(["greedy:i=5k,a=1",
                                 "anneal:i=8,a=8,n=3000,p=2000"]),
            seed=11)
        called = tuple(sorted(result.genotypes[0]))
        assert called == truth, (
            f"called {called}, truth {truth}; "
            f"top5={[tuple(g) for g in result.genotypes[:5]]}")
        obj = result.to_json(locus.hap_names)
        assert obj["genotype"].count(",") == 2
