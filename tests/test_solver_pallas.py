"""Annealer kernel (ops/solver_pallas.py): engine equivalence, dynamics
and the in-kernel random numbers.

On the CPU the kernel runs in Pallas interpret mode.  Its random numbers
are a counter-based hash, so interpret mode runs the same dynamics as the
card: the ILP optimum and seed determinism are checked here too.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from locityper_tpu.model import Params
from locityper_tpu.model.assgn import LocusTensors
from locityper_tpu.model.windows import ContigInfoPack
from locityper_tpu.mathx.distr import NBinom
from locityper_tpu.ops import solver_pallas as SP
from locityper_tpu.ops.solver import (SolverConfig, build_bayes_table,
                                      solve_genotypes)
from locityper_tpu.ops.solver_pallas import solve_genotypes_pallas


def deep_problem(seed=0, n_reads=30, n_haps=3, kh=3):
    """Like test_ilp.small_problem but with every candidate middle inside
    ONE window, driving that window's depth to ~2·n_reads (=60) — above the
    old hard D_TAB=32 clamp, below the new default d_tab=64."""
    rng = np.random.default_rng(seed)
    hap_len = 1500
    hap_prob = rng.normal(-4.0, 2.0, (n_haps, n_reads, kh)).astype(np.float32)
    hap_prob[rng.random((n_haps, n_reads, kh)) < 0.2] = -1e30
    # All middles inside window 0 of each haplotype ([350, 450)).
    mid = rng.integers(360, 440, (n_haps, n_reads, kh, 2)).astype(np.int32)
    unm = np.full(n_reads, -30.0, np.float32)
    tensors = LocusTensors(hap_prob, mid, unm, n_haps, n_reads, kh)
    window = 100
    n_win = 8
    pack = ContigInfoPack(
        n_haps=n_haps, max_len=hap_len, max_windows=32,
        n_windows=np.full(n_haps, n_win, np.int32),
        reg_start=np.full(n_haps, (hap_len - n_win * window) // 2, np.int32),
        contig_len=np.full(n_haps, hap_len, np.int32),
        window_size=window,
        gc_at=rng.integers(35, 60, (n_haps, hap_len)).astype(np.int32),
        weight_at=rng.uniform(0.6, 1.0, (n_haps, hap_len)).astype(np.float32))
    bayes = build_bayes_table([NBinom(4.0, 0.45)] * 101, [0.3, 2.0, 3.0], 2.0)
    params = Params(tweak=0)
    return tensors, pack, bayes, params


def _args(tensors, pack, bayes):
    return (tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob,
            pack.n_windows, pack.reg_start, pack.contig_len, pack.gc_at,
            pack.weight_at, bayes)


def _run_pallas(key, gts, tensors, pack, bayes, cfg, **kw):
    return solve_genotypes_pallas(key, gts, *_args(tensors, pack, bayes),
                                  cfg, interpret=True, **kw)


def _cfg(params, pack, **kw):
    return SolverConfig(depth_contrib=params.depth_contrib,
                        aln_contrib=params.aln_contrib,
                        prob_diff=params.prob_diff, tweak=0,
                        window_size=pack.window_size, **kw)


class TestHighDepthEquivalence:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_pallas_matches_seq_at_depth_above_32(self, seed):
        """Deterministic path (0 steps, argmax init, tweak=0): the Pallas
        final likelihood must equal the XLA engine's at window depth ~60.
        Guards the d_tab parameterization (old kernel clamped at 32)."""
        tensors, pack, bayes, params = deep_problem(seed)
        gt = np.array([(0, 2)], np.int32)
        cfg = SolverConfig(anneal_steps=0, polish_steps=0,
                           depth_contrib=params.depth_contrib,
                           aln_contrib=params.aln_contrib,
                           prob_diff=params.prob_diff,
                           tweak=0, window_size=pack.window_size)
        want, _ = solve_genotypes(
            jax.random.PRNGKey(seed), gt, tensors.hap_prob, tensors.hap_mid,
            tensors.unmapped_prob, pack.n_windows, pack.reg_start,
            pack.contig_len, pack.gc_at, pack.weight_at, bayes, cfg,
            n_attempts=1, max_windows=pack.max_windows, random_init=False)
        got, _ = _run_pallas(jax.random.PRNGKey(seed), gt, tensors, pack,
                             bayes, cfg, n_attempts=1,
                             max_windows=pack.max_windows, n_steps=0,
                             random_init=False)
        want = float(np.asarray(want)[0, 0])
        got = float(np.asarray(got)[0, 0])
        assert got == pytest.approx(want, abs=1e-3), (got, want)

    def test_depth_exceeds_old_clamp(self):
        """Sanity: the constructed problem really puts depth > 32 in a
        window (otherwise the test above proves nothing)."""
        tensors, pack, bayes, params = deep_problem(0)
        # argmax-init assignment piles both mates of every read into
        # window 0 of each chosen haplotype: depth = 2 * n_reads = 60.
        assert 2 * tensors.n_reads > 32

    def test_d_tab_too_small_detected(self):
        """With d_tab=32 the same comparison must FAIL — proves the test
        has teeth (engines diverge exactly when depth saturates)."""
        tensors, pack, bayes, params = deep_problem(0)
        gt = np.array([(0, 2)], np.int32)
        cfg = SolverConfig(anneal_steps=0, polish_steps=0,
                           depth_contrib=params.depth_contrib,
                           aln_contrib=params.aln_contrib,
                           prob_diff=params.prob_diff,
                           tweak=0, window_size=pack.window_size, d_tab=32)
        want, _ = solve_genotypes(
            jax.random.PRNGKey(0), gt, tensors.hap_prob, tensors.hap_mid,
            tensors.unmapped_prob, pack.n_windows, pack.reg_start,
            pack.contig_len, pack.gc_at, pack.weight_at, bayes, cfg,
            n_attempts=1, max_windows=pack.max_windows, random_init=False)
        got, _ = _run_pallas(jax.random.PRNGKey(0), gt, tensors, pack,
                             bayes, cfg, n_attempts=1,
                             max_windows=pack.max_windows, n_steps=0,
                             random_init=False)
        assert abs(float(np.asarray(got)[0, 0])
                   - float(np.asarray(want)[0, 0])) > 1e-3


class TestPlateauExit:
    def test_plato_while_loop_plumbing(self):
        """plato > 0 switches the kernel to the reference's plateau
        semantics (stoch.rs:196-240) behind a while_loop.  From an argmax
        init, a polish-only walk accepts strictly improving moves only, so
        the likelihood cannot fall below the init state's, and the chain
        freezes (and the program exits) long before n_steps."""
        tensors, pack, bayes, params = deep_problem(0)
        gt = np.array([(0, 2)], np.int32)
        cfg = _cfg(params, pack, anneal_steps=0, polish_steps=0)
        base, _ = _run_pallas(jax.random.PRNGKey(0), gt, tensors, pack,
                              bayes, cfg, n_attempts=1,
                              max_windows=pack.max_windows, n_steps=0,
                              random_init=False)
        got, _ = _run_pallas(jax.random.PRNGKey(0), gt, tensors, pack,
                             bayes, cfg, n_attempts=1,
                             max_windows=pack.max_windows, n_steps=4000,
                             random_init=False, plato=25)
        base = float(np.asarray(base)[0, 0])
        got = float(np.asarray(got)[0, 0])
        assert np.isfinite(got) and got >= base - 1e-3

    def test_plato_disabled_when_too_large(self):
        """plato >= n_steps degrades to the fixed-step fori path."""
        tensors, pack, bayes, params = deep_problem(1)
        gt = np.array([(1, 2)], np.int32)
        cfg = SolverConfig(anneal_steps=0, polish_steps=0,
                           depth_contrib=params.depth_contrib,
                           aln_contrib=params.aln_contrib,
                           prob_diff=params.prob_diff,
                           tweak=0, window_size=pack.window_size)
        a, _ = _run_pallas(jax.random.PRNGKey(1), gt, tensors, pack,
                           bayes, cfg, n_attempts=1,
                           max_windows=pack.max_windows, n_steps=0,
                           random_init=False, plato=100)
        b, _ = _run_pallas(jax.random.PRNGKey(1), gt, tensors, pack,
                           bayes, cfg, n_attempts=1,
                           max_windows=pack.max_windows, n_steps=0,
                           random_init=False)
        assert float(np.asarray(a)[0, 0]) == float(np.asarray(b)[0, 0])


class TestSeededInit:
    def test_init_assgn_plumbing(self):
        """init_assgn (warm start, permuted slot space): seeding with the
        argmax rows must reproduce the random_init=False result exactly
        at 0 steps — same init state, same final likelihood."""
        tensors, pack, bayes, params = deep_problem(2)
        gt = np.array([(0, 1)], np.int32)
        cfg = SolverConfig(anneal_steps=0, polish_steps=0,
                           depth_contrib=params.depth_contrib,
                           aln_contrib=params.aln_contrib,
                           prob_diff=params.prob_diff,
                           tweak=0, window_size=pack.window_size)
        base, assgn = _run_pallas(jax.random.PRNGKey(2), gt, tensors, pack,
                                  bayes, cfg, n_attempts=2,
                                  max_windows=pack.max_windows, n_steps=0,
                                  random_init=False)
        seeded, _ = _run_pallas(jax.random.PRNGKey(99), gt, tensors, pack,
                                bayes, cfg, n_attempts=2,
                                max_windows=pack.max_windows, n_steps=0,
                                random_init=True,
                                init_assgn=np.asarray(assgn))
        np.testing.assert_allclose(np.asarray(seeded), np.asarray(base),
                                   rtol=0, atol=1e-4)

    def test_scheme_parse_init_prev(self):
        from locityper_tpu.solvers.solve import Scheme
        sch = Scheme.parse(["greedy:i=5k,a=1", "anneal:i=20,a=20,init=prev"])
        assert not sch.stages[0].seed_prev
        assert sch.stages[1].seed_prev
        assert not Scheme.default().stages[1].seed_prev


def test_stage_plato_mapping():
    """_stage_plato: anneal uses the polish budget; greedy converts
    reference iterations (of `sample` reads) to single-read steps."""
    from locityper_tpu.solvers.solve import Scheme, Stage, _stage_plato
    st = Scheme.default().stages
    assert _stage_plato(st[0]) == 100 * 10          # greedy
    assert _stage_plato(st[1]) == 10000             # anneal
    assert _stage_plato(Stage.parse("anneal:n=3000,p=2000")) == 2000


class TestDynamics:
    """Real annealing dynamics in interpret mode (ILP: tests/test_ilp.py)."""

    def test_reaches_ilp_optimum(self):
        from test_ilp import small_problem
        from locityper_tpu.solvers.ilp import solve_ilp
        tensors, pack, bayes, params = small_problem(0)
        gt = (0, 2)
        _, ilp_lik = solve_ilp(gt, tensors, pack, bayes, params)
        cfg = _cfg(params, pack, anneal_steps=4000, polish_steps=4000)
        liks, _ = _run_pallas(jax.random.PRNGKey(0),
                              np.array([gt], np.int32), tensors, pack,
                              bayes, cfg, n_attempts=8,
                              max_windows=pack.max_windows)
        best = float(np.max(np.asarray(liks)))
        assert best == pytest.approx(ilp_lik, abs=0.05)
        assert best <= ilp_lik + 0.05

    def test_seed_determinism(self):
        from test_ilp import small_problem
        tensors, pack, bayes, params = small_problem(1)
        gts = np.array([(0, 1), (0, 2)], np.int32)
        cfg = _cfg(params, pack, anneal_steps=1000, polish_steps=1000)
        kw = dict(n_attempts=4, max_windows=pack.max_windows)
        a, _ = _run_pallas(jax.random.PRNGKey(7), gts, tensors, pack, bayes,
                           cfg, **kw)
        b, _ = _run_pallas(jax.random.PRNGKey(7), gts, tensors, pack, bayes,
                           cfg, **kw)
        c, _ = _run_pallas(jax.random.PRNGKey(8), gts, tensors, pack, bayes,
                           cfg, **kw)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert not np.array_equal(np.asarray(a), np.asarray(c))

    def test_chain_padding_dropped(self):
        """Chains are padded to the program width (32): 3 genotypes x 3
        attempts = 9 chains come back as [3, 3], the same as the first
        rows of a wider call."""
        from test_ilp import small_problem
        tensors, pack, bayes, params = small_problem(2)
        gts = np.array([(0, 1), (0, 2), (1, 2)], np.int32)
        cfg = _cfg(params, pack, anneal_steps=0, polish_steps=0)
        liks, assgn = _run_pallas(jax.random.PRNGKey(3), gts, tensors, pack,
                                  bayes, cfg, n_attempts=3,
                                  max_windows=pack.max_windows,
                                  random_init=False)
        assert liks.shape == (3, 3)
        assert assgn.shape == (3, 3, tensors.hap_prob.shape[1])
        # Argmax init, 0 steps, no tweak: every attempt is the same state.
        np.testing.assert_allclose(np.asarray(liks),
                                   np.asarray(liks)[:, :1].repeat(3, 1),
                                   atol=1e-4)


class TestRandomBits:
    def _draws(self, n_chains=64, n_steps=512, draw=0):
        seed = jnp.uint32(12345)
        chain = jnp.arange(n_chains, dtype=jnp.uint32)[:, None]
        step = jnp.arange(n_steps, dtype=jnp.uint32)[None, :]
        return SP.random_bits(seed, chain, step, draw)

    def test_bounds(self):
        bits = self._draws()
        u = np.asarray(SP.uniform01(bits))
        assert u.min() >= 0.0 and u.max() < 1.0
        bound = jnp.full(bits.shape, 7, jnp.int32)
        k = np.asarray(SP.randint(bits, bound))
        assert k.min() == 0 and k.max() == 6

    def test_uniform(self):
        """Chi-square over 16 bins of 32768 draws, and the three draws of
        a step are not the same numbers."""
        u = np.asarray(SP.uniform01(self._draws())).ravel()
        counts = np.bincount((u * 16).astype(int), minlength=16)
        expected = u.size / 16
        chi2 = float(np.sum((counts - expected) ** 2 / expected))
        assert chi2 < 40.0, chi2          # 15 dof: p ~ 5e-4
        assert abs(float(u.mean()) - 0.5) < 0.01
        u1 = np.asarray(SP.uniform01(self._draws(draw=1))).ravel()
        assert abs(float(np.corrcoef(u, u1)[0, 1])) < 0.05


class TestKernelPlumbing:
    @pytest.mark.parametrize("plato", [0, 100])
    def test_lowers_for_cuda(self, plato):
        """The kernel lowers to Triton IR for a CUDA target, with and
        without the plateau exit loop."""
        from jax.export import DisabledSafetyCheck, export
        from test_ilp import small_problem
        tensors, pack, bayes, params = small_problem(0)
        cfg = _cfg(params, pack)
        f = jax.jit(lambda k, g, *a: solve_genotypes_pallas(
            k, g, *a, cfg, n_attempts=4, max_windows=pack.max_windows,
            plato=plato))
        exp = export(f, platforms=["cuda"], disabled_checks=[
            DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(
            jax.random.PRNGKey(0), np.array([(0, 1), (0, 2)], np.int32),
            *_args(tensors, pack, bayes))
        assert "anneal_chains" in exp.mlir_module()

    def test_auto_engine_follows_route(self, monkeypatch):
        from locityper_tpu.ops import device
        from locityper_tpu.solvers.solve import Stage, _resolve_engine
        monkeypatch.setattr(device, "kernel_route", lambda: "gpu")
        assert _resolve_engine(Stage(kind="anneal")) == "pallas"
        monkeypatch.setattr(device, "kernel_route", lambda: "xla")
        assert _resolve_engine(Stage(kind="anneal")) == "seq"
        assert _resolve_engine(Stage(kind="anneal",
                                     engine="batched")) == "batched"


@pytest.mark.gpu
def test_kernel_on_card():
    """Compiled for the card: the ILP optimum (run with
    LOCITYPER_TEST_GPU=1 on a GPU machine)."""
    from test_ilp import small_problem
    from locityper_tpu.solvers.ilp import solve_ilp
    tensors, pack, bayes, params = small_problem(0)
    _, ilp_lik = solve_ilp((0, 2), tensors, pack, bayes, params)
    cfg = _cfg(params, pack, anneal_steps=4000, polish_steps=4000)
    liks, _ = solve_genotypes_pallas(
        jax.random.PRNGKey(0), np.array([(0, 2)], np.int32),
        *_args(tensors, pack, bayes), cfg, n_attempts=8,
        max_windows=pack.max_windows)
    assert float(np.max(np.asarray(liks))) == pytest.approx(ilp_lik,
                                                             abs=0.05)
