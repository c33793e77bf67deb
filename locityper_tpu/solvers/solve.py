"""Multi-stage genotype solving and ranking.

Counterpart of reference solvers/solve.rs: a pre-filter on pure alignment
likelihood (:87-122), a pipeline of solver stages over shrinking genotype
sets (:150-251), genotype culling by one-sided Welch t-tests (:318-470), and
final ranking with pairwise probabilities, Phred quality and weighted
genotype distances (:472-767).

Work placement differs from the reference by design: each stage launches ONE
device program evaluating (genotypes × attempts) annealing chains in
parallel (ops/solver.py) instead of sharding genotypes over CPU threads.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import numpy as np

from .. import mathx
from ..model import Params
from ..model.assgn import LocusTensors
from ..model.windows import ContigInfoPack
from ..ops.solver import SolverConfig, build_bayes_table, solve_genotypes
from ..utils.logging import get_logger

logger = get_logger("solve")

_SIZE_SUFFIX = {"k": 1000, "m": 1000000}


def _parse_size(s: str) -> int:
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([kKmM]?)", s)
    if not m:
        raise ValueError(f"Cannot parse size {s!r}")
    v = float(m.group(1)) * _SIZE_SUFFIX.get(m.group(2).lower(), 1)
    return int(v)


@dataclass
class Stage:
    """One solver stage (solve.rs:138-203): SOLVER[:param=value,...].

    engine "auto" (default) resolves by ops/device.kernel_route: the
    Pallas annealer kernel (ops/solver_pallas.py) on the GPU, the XLA
    sequential chain on the CPU.  Explicit options: "pallas", "seq"
    (reference semantics), "batched" (synchronous batched moves).  All
    three reach the exact ILP optimum (tests/test_ilp.py,
    tests/test_solver_pallas.py).
    """
    kind: str                    # "greedy" | "anneal"
    in_size: int = 1000
    attempts: int = 20
    anneal_steps: int = 20000
    polish_steps: int = 10000
    engine: str = "auto"
    batched_steps: int = 1000
    batched_anneal: int = 500
    # Reference-greedy knobs (stoch.rs:36-145; the seq engine implements
    # them exactly, the pallas/batched engines run the polish-walk instead).
    sample: int = 10
    plato: int = 100
    # init=prev: seed every chain from the previous stage's best
    # assignment instead of random init (pallas engine; an optimization
    # beyond the reference — off by default).
    seed_prev: bool = False

    @classmethod
    def parse(cls, s: str) -> "Stage":
        name, _, rest = s.partition(":")
        name = name.strip().lower()
        if name in ("anneal", "simanneal", "annealing", "simannealing"):
            st = cls(kind="anneal")
        elif name == "greedy":
            st = cls(kind="greedy", anneal_steps=0, polish_steps=8000, attempts=1)
        else:
            raise ValueError(f"Unknown solver {name!r}")
        if rest:
            for kv in rest.split(","):
                k, _, v = kv.partition("=")
                k = k.strip()
                if k in ("i", "input", "in-size"):
                    st.in_size = _parse_size(v)
                elif k in ("a", "attempts"):
                    st.attempts = int(v)
                elif k in ("n", "steps"):
                    st.anneal_steps = _parse_size(v)
                elif k in ("p", "plato"):
                    st.polish_steps = _parse_size(v)
                    st.plato = _parse_size(v)
                elif k in ("s", "sample"):
                    st.sample = _parse_size(v)
                elif k in ("e", "engine"):
                    st.engine = v.strip()
                elif k == "init":
                    st.seed_prev = v.strip() in ("prev", "stage1", "1")
                elif k in ("b", "bsteps"):
                    st.batched_steps = _parse_size(v)
                else:
                    logger.warning("Unknown stage parameter %r", k)
        if st.kind == "greedy":
            st.batched_anneal = 0
            st.batched_steps = min(st.batched_steps, 400)
        return st


@dataclass
class Scheme:
    stages: list

    @classmethod
    def default(cls) -> "Scheme":
        """greedy:i=5k,a=1 → anneal:i=20,a=20 (solve.rs:211-229)."""
        return cls([Stage(kind="greedy", in_size=5000, attempts=1,
                          anneal_steps=0, polish_steps=8000,
                          batched_anneal=0, batched_steps=400),
                    Stage(kind="anneal", in_size=20, attempts=20)])

    @classmethod
    def parse(cls, specs: list[str]) -> "Scheme":
        if not specs:
            return cls.default()
        return cls([Stage.parse(s) for s in specs])


@dataclass
class Prediction:
    lik_mean: float
    lik_var: float
    attempts: int
    assignments: np.ndarray | None = None


def compare_two_likelihoods(p1: Prediction, p2: Prediction) -> float:
    """ln P(gt1 is better), max of simple normalization and t-test p-value
    (solve.rs:318-335)."""
    simple_norm = p1.lik_mean - mathx.ln_add(p1.lik_mean, p2.lik_mean)
    if (np.isfinite(p1.lik_var) and np.isfinite(p2.lik_var)
            and p1.lik_var > 0 and p2.lik_var > 0):
        if p1.attempts == p2.attempts:
            pval = mathx.unpaired_onesided_t_test(
                p1.lik_mean, p1.lik_var, p2.lik_mean, p2.lik_var,
                float(p1.attempts))
        else:
            pval = mathx.unpaired_onesided_t_test_diffsizes(
                p1.lik_mean, p1.lik_var, p2.lik_mean, p2.lik_var,
                float(p1.attempts), float(p2.attempts))
        return max(simple_norm, np.log(max(pval, 1e-300)))
    return simple_norm


def genotype_distance(gt1, gt2, dist_matrix: np.ndarray) -> float:
    """Min-permutation distance between genotypes (solve.rs:338-347)."""
    import itertools
    best = np.inf
    for perm in itertools.permutations(gt1):
        d = sum(0 if i == j else dist_matrix[i, j] for i, j in zip(perm, gt2))
        best = min(best, d)
    return float(best)


@dataclass
class Genotyping:
    """Final result (solve.rs:556-767)."""
    tag: str
    genotypes: list                 # [(h_0..h_{P-1})] best..worst
    ln_probs: np.ndarray
    predictions: list
    quality: float
    total_reads: int
    weighted_dist: float | None = None
    distances: list | None = None
    unexpl_reads: int | None = None
    warnings: list = field(default_factory=list)

    def to_json(self, hap_names: list[str]):
        def gt_name(gt):
            return ",".join(hap_names[h] for h in gt)
        obj = dict(total_reads=self.total_reads, quality=self.quality)
        if self.weighted_dist is not None:
            obj["weight_dist"] = self.weighted_dist
        if self.unexpl_reads is not None:
            obj["unexpl_reads"] = self.unexpl_reads
        if self.genotypes:
            obj["genotype"] = gt_name(self.genotypes[0])
            options = []
            for i, gt in enumerate(self.genotypes):
                pred = self.predictions[i]
                o = dict(genotype=gt_name(gt),
                         lik_mean=mathx.to_log10(pred.lik_mean).item(),
                         lik_sd=mathx.to_log10(pred.lik_var).item(),
                         prob=float(np.exp(self.ln_probs[i])),
                         log10_prob=mathx.to_log10(self.ln_probs[i]).item())
                if self.distances is not None:
                    o["dist_to_primary"] = self.distances[i]
                options.append(o)
            obj["options"] = options
        if self.warnings:
            obj["warnings"] = self.warnings
        return obj


def run_filter(genotypes: np.ndarray, priors: np.ndarray,
               best_aln_matrix: np.ndarray, filt_diff: float,
               out_size: int) -> np.ndarray:
    """Stage-0 filter on alignment likelihood alone (solve.rs:87-122):
    score(gt) = prior + Σ_r max_h∈gt best_aln[h, r].  genotypes [G, P]."""
    gt_best = best_aln_matrix[genotypes[:, 0]]                 # [G, R]
    for p in range(1, genotypes.shape[1]):
        gt_best = np.maximum(gt_best, best_aln_matrix[genotypes[:, p]])
    scores = priors + gt_best.sum(axis=1)
    return select_by_scores(scores, filt_diff, out_size)


def _resolve_engine(stage: Stage) -> str:
    """Stage engine with "auto" resolved by ops/device.kernel_route.  On
    the GPU, greedy stages run the kernel's polish walk rather than the
    reference greedy: chip_smoke.py checks that its stage-1 survivor set
    overlaps the greedy's as well as the greedy overlaps itself from seed
    to seed."""
    if stage.engine != "auto":
        return stage.engine
    from ..ops.device import kernel_route
    return "pallas" if kernel_route() == "gpu" else "seq"


def _stage_plato(stage: Stage) -> int:
    """Plateau budget (in kernel steps) for the annealer kernel's
    walk.  Anneal stages: the reference's plato_size equals the polish
    budget (stoch.rs:164-167, the `p=` parameter sets both here).  Greedy
    stages: the reference counts ITERATIONS of `sample` examined reads
    (stoch.rs:95-133), so its plateau of `plato` iterations corresponds to
    plato x sample single-read steps of the polish walk."""
    if stage.kind == "anneal":
        return int(stage.polish_steps)
    return int(stage.plato) * max(int(stage.sample), 1)


_PACK_CACHE = {}


def _pack_solver_out(liks, assgns):
    """[G, A, 1+R] int32 device buffer holding f32-bitcast likelihoods and
    assignments: one D2H instead of two."""
    import jax
    import jax.numpy as jnp

    fn = _PACK_CACHE.get("fn")
    if fn is None:
        @jax.jit
        def fn(liks_, assgns_):
            l32 = jax.lax.bitcast_convert_type(liks_.astype(jnp.float32),
                                               jnp.int32)
            return jnp.concatenate(
                [l32[..., None], assgns_.astype(jnp.int32)], axis=-1)
        _PACK_CACHE["fn"] = fn
    return fn(liks, assgns)


def select_by_scores(scores: np.ndarray, filt_diff: float,
                     out_size: int) -> np.ndarray:
    """Selection half of the stage-0 filter: keep genotypes within
    `filt_diff` of the best, at least `out_size` (solve.rs:87-122)."""
    ixs = np.argsort(-scores, kind="stable")
    n = ixs.size
    if out_size >= n:
        return ixs
    thresh = scores[ixs[0]] - filt_diff
    m = int(np.searchsorted(-scores[ixs], -thresh, side="right"))
    if m < out_size:
        thresh = scores[ixs[out_size - 1]]
        m = int(np.searchsorted(-scores[ixs], -thresh, side="right"))
    m = min(max(m, 1), n)
    logger.debug("    Filter: keep %d/%d genotypes (%.1f%%)", m, n, 100.0 * m / n)
    return ixs[:m]


def discard_improbable(ixs: np.ndarray, predictions: dict, genotypes,
                       prob_thresh: float, out_size: int) -> np.ndarray:
    """(solve.rs:415-470)."""
    n = ixs.size
    if out_size >= n:
        return ixs
    order = sorted(ixs.tolist(), key=lambda i: -predictions[i].lik_mean)
    best = predictions[order[0]]
    new_ixs = order[:out_size]
    if out_size <= 500:
        dropped = 0
        for ix in order[out_size:]:
            ln_pval = compare_two_likelihoods(predictions[ix], best)
            if ln_pval >= prob_thresh:
                new_ixs.append(ix)
            else:
                dropped += 1
                if dropped >= 5:
                    break
    logger.debug("    Keep %d/%d genotypes after culling", len(new_ixs), n)
    return np.array(new_ixs)


def produce_result(ixs, predictions: dict, genotypes, tag: str,
                   total_reads: int, params: Params) -> Genotyping:
    """(solve.rs:472-524)."""
    THRESH = np.log(1e-5)
    MAX_GENOTYPES = 50
    min_output = max(4, params.out_bams, params.out_sams)
    thresh_prob = min(THRESH, params.prob_thresh)
    order = sorted(ixs.tolist(), key=lambda i: -predictions[i].lik_mean)
    n = min(len(order), MAX_GENOTYPES)
    ln_probs = np.zeros(n)
    out_gts, preds = [], []
    i = 0
    while i < n:
        pred_i = predictions[order[i]]
        out_gts.append(tuple(genotypes[order[i]]))
        for j in range(i + 1, n):
            pred_j = predictions[order[j]]
            prob_j = compare_two_likelihoods(pred_j, pred_i)
            if i == 0 and j >= min_output and prob_j < thresh_prob:
                n = j
                break
            ln_probs[i] += np.log1p(-min(np.exp(prob_j), 1.0 - 1e-15))
            ln_probs[j] += prob_j
        preds.append(pred_i)
        i += 1
    ln_probs = ln_probs[:n]
    norm = mathx.ln_sum(ln_probs)
    ln_probs = ln_probs - norm
    quality = (min(mathx.phred_from_ln_prob(mathx.ln_sum(ln_probs[1:])), 1e9)
               if n > 1 else 0.0)
    return Genotyping(tag=tag, genotypes=out_gts, ln_probs=ln_probs,
                      predictions=preds, quality=float(quality),
                      total_reads=total_reads)


def _unpermute_assignments(assgns, gts, tensors, params):
    """assgns [Gc, A, R] in permuted slots -> original slots (the
    permutation is deterministic: valid-first stable order)."""
    out = np.empty_like(assgns)
    for gi, gt in enumerate(gts):
        ps = [tensors.hap_prob[int(h)] for h in gt]
        unm = (tensors.unmapped_prob if tensors.unmapped_prob.ndim == 1
               else tensors.unmapped_prob[int(gt[0])])
        probs = np.concatenate(ps + [unm[:, None]], 1)
        best = unm
        for p in ps:
            best = np.maximum(best, p.max(1))
        valid = probs >= (best - params.prob_diff)[:, None]
        vorder = np.argsort(~valid, axis=-1, kind="stable")
        R = probs.shape[0]
        for a in range(assgns.shape[1]):
            out[gi, a] = vorder[np.arange(R), assgns[gi, a]]
    return out


def _gt_chunks(total: int, cap: int, floor: int = 16) -> list:
    """Chunk plan [(start, take, padded_size)] for a genotype list: full
    cap-sized chunks, then a greedy DESCENDING-pow2 tail (min `floor`).
    Shapes stay pow2-bucketed (one compile each); the tail split stops a
    just-over-half tail from padding to the full cap."""
    out = []
    start = 0
    while start < total:
        rem = total - start
        size = max(min(1 << (rem.bit_length() - 1), cap), floor)
        take = min(size, rem)
        out.append((start, take, size))
        start += take
    return out


def _candidate_k_cap(tensors, ploidy: int) -> int | None:
    """Static cap on live candidate slots for the annealer kernel's
    valid-first-permuted feeds: every read has at most `max_v` non-NEG
    slots per haplotype (host count over tensors.hap_prob — an upper
    bound on _gather_candidates' post-prob_diff valid set), so after the
    valid-first permutation all live candidates sit below
    P*max_v + 1.  Slicing there shrinks the kernel's candidate feeds
    bit-identically (the random stream does not depend on K).
    Bucketed to {5, 9, 17} to bound compile shapes; None = no win."""
    from ..ops.solver import NEG
    k_full = ploidy * tensors.kh + 1
    if tensors.hap_prob.size == 0:
        return None
    max_v = int((np.asarray(tensors.hap_prob) > NEG / 2).sum(axis=2).max())
    k_eff = ploidy * max_v + 1
    for b in (5, 9, 17):
        if k_eff <= b < k_full:
            return b
    return None


def _device_solver_args(tensors, pack, bayes, mesh):
    """The 9 array operands every stage call passes to the solver, made
    device-resident ONCE instead of uploaded again with every chunked
    stage call.  Mesh runs keep numpy: arrays committed to one device
    conflict with shard_map placement."""
    import jax
    args = (tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob,
            pack.n_windows, pack.reg_start, pack.contig_len,
            pack.gc_at, pack.weight_at, bayes)
    if mesh is not None:
        return args
    return tuple(jax.device_put(a) for a in args)


def solve_locus(tensors: LocusTensors, pack: ContigInfoPack, bg_distr,
                genotypes: np.ndarray, priors: np.ndarray, params: Params,
                scheme: Scheme, key, tag: str = "locus",
                dist_matrix: np.ndarray | None = None,
                gt_batch: int | None = None, sol_writer=None,
                gt_names=None, mesh=None) -> Genotyping:
    """Full multi-stage solve of one locus on device.

    sol_writer: optional text stream receiving per-stage scores
    ("stage\\tgenotype\\tscore", counterpart of sol.csv.gz, solve.rs:918-919).
    mesh: optional jax.sharding.Mesh — the stage-0 filter runs read-sharded
    (psum across devices) and every solver stage runs genotype-sharded over the
    full mesh (the reference's solver worker pool, solve.rs:969-1127).
    """
    import jax

    def write_sol(stage_ix, ix, score):
        if sol_writer is not None:
            name = gt_names[ix] if gt_names else f"{genotypes[ix]}"
            sol_writer.write(f"{stage_ix}\t{name}\t{mathx.to_log10(score):.4f}\n")

    if gt_batch is None:
        gt_batch = _default_gt_batch()
    mul_coef = 2.0 if bg_distr.insert_distr.is_paired_end else 1.0
    bayes = build_bayes_table(bg_distr.depth.distributions, list(params.alt_cn),
                              mul_coef)
    dev_args = _device_solver_args(tensors, pack, bayes, mesh)
    # Stage-0 filter on pure alignment likelihood.
    n_real = tensors.n_reads
    best_aln = np.maximum(tensors.hap_prob[:, :n_real].max(axis=2),
                          tensors.unmapped_prob[None, :n_real])  # [H, R]
    if mesh is not None:
        from ..parallel.mesh import sharded_filter_scores
        pad_r = (-n_real) % mesh.shape["read"]
        ba = np.pad(best_aln, ((0, 0), (0, pad_r)))  # zeros shift all equally
        scores = np.asarray(sharded_filter_scores(
            mesh, ba, genotypes.astype(np.int32),
            priors.astype(np.float32)), np.float64)
        ixs = select_by_scores(scores, params.filt_diff,
                               scheme.stages[0].in_size)
    else:
        ixs = run_filter(genotypes, priors, best_aln, params.filt_diff,
                         scheme.stages[0].in_size)

    predictions: dict[int, Prediction] = {}
    seed_rows: dict = {}      # ix -> permuted best assignment (init=prev)
    n_stages = len(scheme.stages)
    for s_ix, stage in enumerate(scheme.stages):
        out_size = (scheme.stages[s_ix + 1].in_size
                    if s_ix + 1 < n_stages else None)
        if not (params.dont_skip or out_size is None or out_size < ixs.size):
            logger.info("    Skipping stage %d, not enough genotypes", s_ix + 1)
            continue
        t0 = time.monotonic()
        random_init = stage.kind == "anneal"
        engine = _resolve_engine(stage)
        cfg = SolverConfig(
            anneal_steps=stage.anneal_steps,
            polish_steps=stage.polish_steps,
            depth_contrib=params.depth_contrib,
            aln_contrib=params.aln_contrib,
            prob_diff=params.prob_diff,
            tweak=int(params.tweak or 0),
            window_size=pack.window_size,
            anneal_steps_b=stage.batched_anneal,
            greedy_sample=(stage.sample
                           if stage.kind == "greedy" and engine == "seq"
                           else 0),
            plato_size=stage.plato,
        )
        # init=prev seeding: the NEXT stage wants this stage's best
        # assignments (permuted slot space) as warm starts, so this
        # stage's packed output must cross D2H even if non-final.
        next_seed = (out_size is not None
                     and scheme.stages[s_ix + 1].seed_prev)
        if engine == "pallas":
            from ..ops.solver_pallas import solve_genotypes_pallas
            k_cap = _candidate_k_cap(tensors, int(genotypes.shape[-1]))
            plato_steps = _stage_plato(stage)

            def run_solver(key_, gts_, init_=None):
                return solve_genotypes_pallas(
                    key_, gts_, *dev_args, cfg,
                    n_attempts=stage.attempts, max_windows=pack.max_windows,
                    n_steps=cfg.anneal_steps + cfg.polish_steps,
                    random_init=random_init, k_eff=k_cap,
                    plato=plato_steps, init_assgn=init_)
        elif engine == "batched":
            from ..ops.solver_batched import solve_genotypes_batched

            def run_solver(key_, gts_, init_=None):
                return solve_genotypes_batched(
                    key_, gts_, *dev_args, cfg,
                    n_attempts=stage.attempts, max_windows=pack.max_windows,
                    n_steps=stage.batched_steps, random_init=random_init)
        else:
            def run_solver(key_, gts_, init_=None):
                return solve_genotypes(
                    key_, gts_, *dev_args, cfg,
                    n_attempts=stage.attempts, max_windows=pack.max_windows,
                    random_init=random_init)
        # Two-phase chunk pipeline with a pow2 tail split (see
        # _solve_panel_group): every chunk dispatches before the first
        # fetch, with an async D2H prefetch riding the kernel queue.
        floor = max(16, mesh.devices.size if mesh is not None else 16)
        pend = []
        for st, take, size in _gt_chunks(ixs.size, gt_batch, floor):
            chunk = ixs[st:st + take]
            gts = genotypes[chunk]
            if size - take:
                gts = np.concatenate(
                    [gts, np.repeat(gts[-1:], size - take, 0)])
            init_ = None
            if (stage.seed_prev and engine == "pallas" and mesh is None
                    and all(int(ix) in seed_rows for ix in chunk)):
                init_ = np.stack([seed_rows[int(ix)] for ix in chunk])
                if size - take:
                    init_ = np.concatenate(
                        [init_, np.repeat(init_[-1:], size - take, 0)])
                init_ = np.repeat(init_[:, None, :], stage.attempts, 1)
            stage_key = jax.random.fold_in(key, s_ix * 100003 + st)
            if mesh is not None:
                from ..parallel.mesh import sharded_stage_solver
                liks, assgns = sharded_stage_solver(mesh, run_solver,
                                                    stage_key, gts)
            else:
                liks, assgns = run_solver(stage_key, gts, init_)
            # Final stage: one packed D2H for both outputs.  Non-final
            # stages only rank by likelihood, so the [G, A, R]
            # assignments stay on device (at HLA scale R is thousands),
            # unless the next stage seeds from them.
            final_stage = out_size is None
            out_dev = (_pack_solver_out(liks, assgns)
                       if final_stage or next_seed else liks)
            if hasattr(out_dev, "copy_to_host_async"):
                out_dev.copy_to_host_async()
            pend.append((chunk, out_dev))
        seed_rows = {}
        for chunk, out_dev in pend:
            host = np.asarray(out_dev)
            if final_stage or next_seed:
                liks = host[..., 0].view(np.float32).astype(np.float64)
                assgns = host[..., 1:]
                if next_seed and engine == "pallas":
                    # Keep the best attempt's PERMUTED row per genotype
                    # for the next stage's warm start.
                    best_a = np.argmax(liks[:chunk.size], axis=1)
                    for gi, ix in enumerate(chunk.tolist()):
                        seed_rows[int(ix)] = assgns[gi, best_a[gi]]
                if final_stage and engine == "pallas":
                    # Pallas assignments live in the valid-first permuted
                    # slot space; map back to original candidate slots.
                    assgns = _unpermute_assignments(assgns,
                                                    genotypes[chunk],
                                                    tensors, params)
            else:
                liks = host.astype(np.float64)
            liks = liks[:chunk.size]
            for gi, (row, ix) in enumerate(zip(liks, chunk.tolist())):
                row = row + priors[ix]
                mean, var = mathx.mean_variance(row)
                predictions[ix] = Prediction(
                    mean, var, stage.attempts,
                    assignments=assgns[gi] if final_stage else None)
                write_sol(s_ix + 1, ix, mean)
        dt = time.monotonic() - t0
        logger.info("    Stage %d (%s): %d genotypes x %d attempts in %.2fs "
                    "(%.4f s/gt)", s_ix + 1, stage.kind, ixs.size,
                    stage.attempts, dt, dt / max(ixs.size, 1))
        if out_size is not None:
            ixs = discard_improbable(ixs, predictions, genotypes,
                                     params.prob_thresh, out_size)

    result = produce_result(ixs, predictions, genotypes, tag,
                            tensors.n_reads, params)
    if dist_matrix is not None:
        dists = [0.0 if i == 0 else
                 genotype_distance(result.genotypes[0], gt, dist_matrix)
                 for i, gt in enumerate(result.genotypes)]
        probs = np.exp(result.ln_probs)
        result.weighted_dist = float(np.sum(probs * np.array(dists))
                                     / max(np.sum(probs), 1e-300))
        result.distances = dists
    return result


# ---------------------------------------------------------------------------
# Multi-locus panel solving (solve across loci in one program)
# ---------------------------------------------------------------------------

@dataclass
class PanelItem:
    """One locus's solver inputs for `solve_panel`."""
    tensors: object                  # LocusTensors
    pack: object                     # ContigInfoPack
    genotypes: np.ndarray            # [G, P] local hap ids
    priors: np.ndarray               # [G]
    tag: str = "locus"
    dist_matrix: np.ndarray | None = None
    sol_writer: object = None
    gt_names: list | None = None


def _combine_panel(items):
    """Concatenates per-locus tensors along the haplotype axis with a SHARED
    read axis [R_max]: each locus's haplotype rows carry its own reads
    (rows beyond its read count stay NEG/-1/0 — trivial, contributing 0,
    exactly like LocusTensors.build's dummy reads).  unmapped_prob becomes
    [H_tot, R_max] per-haplotype rows.  Genotype hap ids shift by per-locus
    offsets.  Returns (tensors-like args dict, hap offsets)."""
    from ..model.assgn import LocusTensors
    from ..model.windows import ContigInfoPack
    from ..ops.solver import NEG

    R_max = max(it.tensors.hap_prob.shape[1] for it in items)
    kh = max(it.tensors.kh for it in items)
    H_tot = sum(it.tensors.n_haps for it in items)
    max_len = max(it.pack.max_len for it in items)
    max_windows = max(it.pack.max_windows for it in items)
    wsize = items[0].pack.window_size
    assert all(it.pack.window_size == wsize for it in items)

    hap_prob = np.full((H_tot, R_max, kh), NEG, np.float32)
    hap_mid = np.full((H_tot, R_max, kh, 2), -1, np.int32)
    unm = np.zeros((H_tot, R_max), np.float32)
    gc_at = np.zeros((H_tot, max_len), np.int32)
    weight_at = np.zeros((H_tot, max_len), np.float32)
    n_windows = np.zeros(H_tot, np.int32)
    reg_start = np.zeros(H_tot, np.int32)
    contig_len = np.zeros(H_tot, np.int32)
    offsets = []
    off = 0
    for it in items:
        t, p = it.tensors, it.pack
        H, R, K = t.hap_prob.shape
        hap_prob[off:off + H, :R, :K] = t.hap_prob
        hap_mid[off:off + H, :R, :K] = t.hap_mid
        unm[off:off + H, :R] = t.unmapped_prob[None, :]
        gc_at[off:off + H, :p.max_len] = p.gc_at
        weight_at[off:off + H, :p.max_len] = p.weight_at
        n_windows[off:off + H] = p.n_windows
        reg_start[off:off + H] = p.reg_start
        contig_len[off:off + H] = p.contig_len
        offsets.append(off)
        off += H
    tensors = LocusTensors(hap_prob, hap_mid, unm, H_tot, R_max, kh)
    pack = ContigInfoPack(
        n_haps=H_tot, max_len=max_len, max_windows=max_windows,
        n_windows=n_windows, reg_start=reg_start, contig_len=contig_len,
        window_size=wsize, gc_at=gc_at, weight_at=weight_at)
    return tensors, pack, offsets


def _default_gt_batch() -> int:
    """Genotype-chunk size per solver kernel call (overridable via
    LOCITYPER_GT_BATCH).  Chosen on earlier hardware; not yet measured
    on the GPU."""
    import os
    try:
        return int(os.environ.get("LOCITYPER_GT_BATCH", "512"))
    except ValueError:
        return 512


def solve_panel(items: list, bg_distr, params: Params, scheme: Scheme, key,
                gt_batch: int | None = None, mesh=None) -> list:
    """Multi-stage solve of SEVERAL loci in shared device programs: every
    stage runs the combined genotype list of all loci through one kernel
    call per chunk, amortizing the annealer's sequential-step latency
    across the panel (the annealer is bound by the latency of its
    sequential steps, not by the number of chains, at small per-locus
    genotype counts).  Per-locus semantics
    — stage-0 filter, stage skipping, culling, ranking — stay independent
    and match `solve_locus` (tests/test_panel.py).

    Loci whose contigs were windowed at different sizes (different read
    lengths at preproc time) cannot share one combined program — they are
    bucketed by window size and each bucket solved in its own combined
    program (single-bucket panels are unaffected).

    Returns list[Genotyping] in `items` order.
    """
    import jax

    if gt_batch is None:
        gt_batch = _default_gt_batch()
    sizes = [it.pack.window_size for it in items]
    if len(set(sizes)) > 1:
        logger.info("    Panel spans %d window sizes — solving one combined "
                    "program per size bucket", len(set(sizes)))
        results: list = [None] * len(items)
        for b_ix, ws in enumerate(sorted(set(sizes))):
            sub = [li for li, s in enumerate(sizes) if s == ws]
            sub_res = _solve_panel_group(
                [items[li] for li in sub], bg_distr, params, scheme,
                jax.random.fold_in(key, b_ix), gt_batch, mesh)
            for li, r in zip(sub, sub_res):
                results[li] = r
        return results
    return _solve_panel_group(items, bg_distr, params, scheme, key,
                              gt_batch, mesh)


def _solve_panel_group(items: list, bg_distr, params: Params, scheme: Scheme,
                       key, gt_batch: int | None = None, mesh=None) -> list:
    """One combined multi-stage program over loci sharing a window size
    (`solve_panel` body; see its docstring)."""
    import jax

    if gt_batch is None:
        gt_batch = _default_gt_batch()
    n_loci = len(items)
    t_c0 = time.monotonic()
    tensors, pack, offsets = _combine_panel(items)
    mul_coef = 2.0 if bg_distr.insert_distr.is_paired_end else 1.0
    bayes = build_bayes_table(bg_distr.depth.distributions,
                              list(params.alt_cn), mul_coef)
    dev_args = _device_solver_args(tensors, pack, bayes, mesh)
    logger.debug("    combine+upload: %.2fs (R=%d, W=%d)",
                 time.monotonic() - t_c0, tensors.n_reads,
                 pack.max_windows)

    def write_sol(it, stage_ix, ix, score):
        if it.sol_writer is not None:
            name = (it.gt_names[ix] if it.gt_names
                    else f"{it.genotypes[ix]}")
            it.sol_writer.write(
                f"{stage_ix}\t{name}\t{mathx.to_log10(score):.4f}\n")

    # Per-locus stage-0 filter (host; pure alignment likelihood).
    ixs_per: list[np.ndarray] = []
    for it in items:
        t = it.tensors
        n_real = t.n_reads
        best_aln = np.maximum(t.hap_prob[:, :n_real].max(axis=2),
                              t.unmapped_prob[None, :n_real])
        ixs_per.append(run_filter(it.genotypes, it.priors, best_aln,
                                  params.filt_diff,
                                  scheme.stages[0].in_size))

    preds_per: list[dict] = [{} for _ in items]
    seed_rows: dict = {}    # (locus, ix) -> permuted best row (init=prev)
    n_stages = len(scheme.stages)
    for s_ix, stage in enumerate(scheme.stages):
        out_size = (scheme.stages[s_ix + 1].in_size
                    if s_ix + 1 < n_stages else None)
        # Per-locus stage skipping (solve.rs: skip when not enough gts).
        active = [li for li in range(n_loci)
                  if params.dont_skip or out_size is None
                  or out_size < ixs_per[li].size]
        if not active:
            logger.info("    Skipping stage %d for all loci", s_ix + 1)
            continue
        t0 = time.monotonic()
        random_init = stage.kind == "anneal"
        engine = _resolve_engine(stage)
        cfg = SolverConfig(
            anneal_steps=stage.anneal_steps,
            polish_steps=stage.polish_steps,
            depth_contrib=params.depth_contrib,
            aln_contrib=params.aln_contrib,
            prob_diff=params.prob_diff,
            tweak=int(params.tweak or 0),
            window_size=pack.window_size,
            anneal_steps_b=stage.batched_anneal,
            greedy_sample=(stage.sample
                           if stage.kind == "greedy" and engine == "seq"
                           else 0),
            plato_size=stage.plato,
        )
        next_seed = (out_size is not None
                     and scheme.stages[s_ix + 1].seed_prev)
        if engine == "pallas":
            from ..ops.solver_pallas import solve_genotypes_pallas
            k_cap = _candidate_k_cap(
                tensors, int(items[0].genotypes.shape[-1]))
            plato_steps = _stage_plato(stage)

            def run_solver(key_, gts_, init_=None):
                return solve_genotypes_pallas(
                    key_, gts_, *dev_args, cfg,
                    n_attempts=stage.attempts, max_windows=pack.max_windows,
                    n_steps=cfg.anneal_steps + cfg.polish_steps,
                    random_init=random_init, k_eff=k_cap,
                    plato=plato_steps, init_assgn=init_)
        elif engine == "batched":
            from ..ops.solver_batched import solve_genotypes_batched

            def run_solver(key_, gts_, init_=None):
                return solve_genotypes_batched(
                    key_, gts_, *dev_args, cfg,
                    n_attempts=stage.attempts, max_windows=pack.max_windows,
                    n_steps=stage.batched_steps, random_init=random_init)
        else:
            def run_solver(key_, gts_, init_=None):
                return solve_genotypes(
                    key_, gts_, *dev_args, cfg,
                    n_attempts=stage.attempts, max_windows=pack.max_windows,
                    random_init=random_init)

        # Combined genotype list over the active loci.
        rows = []                # (locus, local gt ix)
        g_parts = []
        for li in active:
            gts_local = items[li].genotypes[ixs_per[li]]
            g_parts.append(gts_local.astype(np.int32) + offsets[li])
            rows.extend((li, int(ix)) for ix in ixs_per[li])
        all_gts = np.concatenate(g_parts)

        n_gts = 0
        t_disp = t_fetch = 0.0
        floor = max(16, mesh.devices.size if mesh is not None else 16)
        pend = []
        # Two-phase chunk pipeline: dispatch EVERY chunk (the device
        # queues them back to back) with an async D2H prefetch, then
        # process in order — no per-chunk blocking round trip, and the
        # pow2 tail split stops a 288-gt tail from padding to 512.
        for st, take, size in _gt_chunks(all_gts.shape[0], gt_batch, floor):
            chunk_rows = rows[st:st + take]
            gts = all_gts[st:st + take]
            if size - take:
                gts = np.concatenate(
                    [gts, np.repeat(gts[-1:], size - take, 0)])
            init_ = None
            if (stage.seed_prev and engine == "pallas" and mesh is None
                    and all(k in seed_rows for k in chunk_rows)):
                init_ = np.stack([seed_rows[k] for k in chunk_rows])
                if size - take:
                    init_ = np.concatenate(
                        [init_, np.repeat(init_[-1:], size - take, 0)])
                init_ = np.repeat(init_[:, None, :], stage.attempts, 1)
            stage_key = jax.random.fold_in(key, s_ix * 100003 + st)
            t_s0 = time.monotonic()
            if mesh is not None:
                from ..parallel.mesh import sharded_stage_solver
                liks, assgns = sharded_stage_solver(mesh, run_solver,
                                                    stage_key, gts)
            else:
                liks, assgns = run_solver(stage_key, gts, init_)
            # Assignments cross D2H only on the final stage (see
            # solve_locus; non-final stages rank by likelihood alone),
            # unless the next stage seeds from them (init=prev).
            final_stage = out_size is None
            out_dev = (_pack_solver_out(liks, assgns)
                       if final_stage or next_seed else liks)
            if hasattr(out_dev, "copy_to_host_async"):
                out_dev.copy_to_host_async()
            t_disp += time.monotonic() - t_s0
            pend.append((chunk_rows, gts, out_dev))
        seed_rows = {}
        for chunk_rows, gts, out_dev in pend:
            t_s1 = time.monotonic()
            host = np.asarray(out_dev)
            t_fetch += time.monotonic() - t_s1
            if final_stage or next_seed:
                liks = host[..., 0].view(np.float32).astype(np.float64)
                assgns = host[..., 1:]
                if next_seed and engine == "pallas":
                    best_a = np.argmax(liks[:len(chunk_rows)], axis=1)
                    for gi, k in enumerate(chunk_rows):
                        seed_rows[k] = assgns[gi, best_a[gi]]
                if final_stage and engine == "pallas":
                    assgns = _unpermute_assignments(
                        assgns, gts[:len(chunk_rows)], tensors, params)
            else:
                liks = host.astype(np.float64)
            for gi, (li, ix) in enumerate(chunk_rows):
                it = items[li]
                row = liks[gi] + it.priors[ix]
                mean, var = mathx.mean_variance(row)
                preds_per[li][ix] = Prediction(
                    mean, var, stage.attempts,
                    assignments=assgns[gi] if final_stage else None)
                write_sol(it, s_ix + 1, ix, mean)
            n_gts += len(chunk_rows)
        dt = time.monotonic() - t0
        logger.info("    Stage %d (%s): %d loci, %d genotypes x %d attempts "
                    "in %.2fs (%.4f s/gt)", s_ix + 1, stage.kind,
                    len(active), n_gts, stage.attempts, dt,
                    dt / max(n_gts, 1))
        logger.debug("      dispatch %.2fs, fetch %.2fs, host %.2fs",
                     t_disp, t_fetch, dt - t_disp - t_fetch)
        if out_size is not None:
            for li in active:
                ixs_per[li] = discard_improbable(
                    ixs_per[li], preds_per[li], items[li].genotypes,
                    params.prob_thresh, out_size)

    results = []
    for li, it in enumerate(items):
        result = produce_result(ixs_per[li], preds_per[li], it.genotypes,
                                it.tag, it.tensors.n_reads, params)
        if it.dist_matrix is not None and result.genotypes:
            dists = [0.0 if i == 0 else
                     genotype_distance(result.genotypes[0], gt,
                                       it.dist_matrix)
                     for i, gt in enumerate(result.genotypes)]
            probs = np.exp(result.ln_probs)
            result.weighted_dist = float(
                np.sum(probs * np.array(dists))
                / max(np.sum(probs), 1e-300))
            result.distances = dists
        results.append(result)
    return results
