#!/usr/bin/env python
"""Smoke run of locityper on an NVIDIA GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --devices 4    # four cards: the mesh phase only

Phases, in order, in this one process (never two JAX processes on a card):

1. device: a CUDA backend is required (no CPU fallback); prints the
   card's name and power limit, the device kind and the kernel route.
2. kernels: each hand-written kernel against its plain XLA reference at
   real widths (references under "highest" matmul precision), with the
   tolerance and its reason, and both times on one line; device
   recruitment against the host oracle.
3. shortread: a simulated WGS sample (one HLA-class locus of 200
   haplotypes, --loci ordinary 4 kb loci, off-target background, about
   1 M read pairs) through `add`, `preproc` and `genotype` with the
   reference-default scheme, cold and warm; every call must be exact.
4. longread: three 16 kb loci with ONT-like 12 kb reads through the CLI;
   every call must be exact.

--devices N instead genotypes the short-read panel over an N-card mesh and
on one card, and requires identical calls.

Any failure exits non-zero and prints no result line.  The last line of a
passing run is {"ok": true, "device": {...}}, after a "summary:" line
with every number as JSON.  Work files go to .smoke_work/ and are removed
at the end.
"""
from __future__ import annotations

import argparse
import gzip
import json
import logging
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SUMMARY = {}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def timed(fn, *args, reps: int = 3):
    """(result, best wall of `reps` warm calls); the first call compiles."""
    import jax
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


# ---------------------------------------------------------------------------
# 1. Device
# ---------------------------------------------------------------------------

def phase_device(n_devices: int):
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX backend is {backend!r}, not a GPU",
              file=sys.stderr)
        sys.exit(2)
    devices = jax.devices()
    if len(devices) < n_devices:
        print(f"chip_smoke: {n_devices} cards requested, "
              f"{len(devices)} visible", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from locityper_tpu.ops.device import ROUTE_ENV, kernel_route
    card = card_line()
    route = kernel_route()
    say(f"card: {card}")
    say(f"device_kind: {devices[0].device_kind} x {len(devices)}")
    say(f"kernel route: {route}")
    # The XLA route on a GPU only when asked for by name (comparisons).
    check(route == "gpu" or os.environ.get(ROUTE_ENV) == "xla",
          f"kernel route {route!r} on a GPU")
    SUMMARY.update(card=card, device_kind=devices[0].device_kind,
                   route=route)


# ---------------------------------------------------------------------------
# 2. Kernels
# ---------------------------------------------------------------------------

def _align_jobs(rng, n, L, band, errors, read_len=None, sd=0):
    """n reads (length read_len ± sd, padded to L) with their haplotype
    windows of L + band bases around the true start."""
    from locityper_tpu import sim
    from locityper_tpu.ops.align import extract_windows
    hap = sim.random_genome(rng, 2_000_000)
    read_len = read_len or L
    lens = np.clip(np.rint(rng.normal(read_len, sd, n)), 100,
                   L).astype(np.int32) if sd else np.full(n, L, np.int32)
    F = L + L // 8 + 16
    starts = rng.integers(band, hap.size - F - band, n)
    frags = hap[starts[:, None] + np.arange(F)]
    reads = sim.apply_errors_bulk(rng, frags, errors, L)
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    wins = np.stack([extract_windows(hap, np.array([s - band // 2]),
                                     L + band)[0] for s in starts])
    return reads, lens, wins


def _compare_align(tag, got, want, atol, why):
    d = float(np.max(np.abs(got["score"] - want["score"])))
    differ = np.zeros(got["score"].shape, bool)
    for k in ("n_mism", "n_ins", "n_del", "n_clip", "start_p", "end_p"):
        differ |= got[k] != want[k]
    share = float(np.mean(differ))
    say(f"  {tag}: max |score diff| {d:.3g} (tolerance {atol}: {why}); "
        f"payloads differ on {100 * share:.3f}% of jobs (limit 1%: "
        f"equal-score ties may take another path)")
    check(d <= atol, f"{tag}: score differs by {d}")
    check(share <= 0.01, f"{tag}: payloads differ on {share:.4f}")
    check(bool(np.all(got["valid"] == want["valid"])), f"{tag}: valid")


def kernels_aligner(rng):
    import jax
    from locityper_tpu import sim
    from locityper_tpu.ops import align as A
    from locityper_tpu.ops.align_pallas import align_batch_pallas
    sv = np.array(A.Scores.from_error_rates(0.002, 0.0002, 0.0002).astuple(),
                  np.float32)
    cases = [
        ("short 150 bp, band 48, B=32768", 32768, 152, 48,
         sim.ErrorModel(0.002, 0.0002, 0.0002), None, 0, 2e-3),
        ("ONT 12 kb +- 2 kb, band 160, B=256", 256, 18432, 160,
         sim.ErrorModel(0.02, 0.008, 0.008), 12000, 2000, 0.05),
    ]
    out = {}
    for tag, B, L, band, err, rl, sd, atol in cases:
        reads, lens, wins = _align_jobs(rng, B, L, band, err, rl, sd)
        args = [jax.device_put(x) for x in (reads, lens, wins, sv)]
        kern = jax.jit(lambda r, l, w, s, band=band: align_batch_pallas(
            r, l, w, s, band=band))
        ref = jax.jit(lambda r, l, w, s, band=band: A.align_batch(
            r, l, w, s, band=band))
        got, t_k = timed(kern, *args)
        with jax.default_matmul_precision("highest"):
            want, t_x = timed(ref, *args, reps=1)
        got = {k: np.asarray(v) for k, v in got.items()}
        want = {k: np.asarray(v) for k, v in want.items()}
        _compare_align(tag, got, want, atol,
                       "float32 sums over the read in another order; one "
                       "mismatch costs ~6 ln units")
        say(f"  aligner {tag}: kernel {t_k * 1e3:.3f} ms, XLA "
            f"{t_x * 1e3:.3f} ms ({B / t_k:.1f} vs {B / t_x:.1f} "
            f"alignments/s)")
        out[tag] = dict(kernel_s=t_k, xla_s=t_x)
    SUMMARY["aligner"] = out


def _solver_args(tensors, pack, bayes):
    return (tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob,
            pack.n_windows, pack.reg_start, pack.contig_len, pack.gc_at,
            pack.weight_at, bayes)


def _stage1_problem():
    """5050-genotype stage-1 problem: 100 haplotypes, reads from 7 and 23."""
    from locityper_tpu.mathx.distr import NBinom
    from locityper_tpu.model.assgn import LocusTensors
    from locityper_tpu.model.windows import ContigInfoPack
    from locityper_tpu.ops.solver import build_bayes_table
    rng = np.random.default_rng(3)
    n_haps, n_reads, kh = 100, 160, 4
    hap_prob = rng.normal(-12.0, 1.5, (n_haps, n_reads, kh)).astype(
        np.float32)
    src = np.where(rng.random(n_reads) < 0.5, 7, 23)
    for r in range(n_reads):
        hap_prob[src[r], r, 0] = rng.normal(-2.0, 0.3)
    hap_prob[rng.random((n_haps, n_reads, kh)) < 0.3] = -1e30
    mid = rng.integers(360, 1200, (n_haps, n_reads, kh, 2)).astype(np.int32)
    unm = np.full(n_reads, -25.0, np.float32)
    tensors = LocusTensors(hap_prob, mid, unm, n_haps, n_reads, kh)
    hap_len, window = 1600, 100
    pack = ContigInfoPack(
        n_haps=n_haps, max_len=hap_len, max_windows=16,
        n_windows=np.full(n_haps, 12, np.int32),
        reg_start=np.full(n_haps, 200, np.int32),
        contig_len=np.full(n_haps, hap_len, np.int32), window_size=window,
        gc_at=rng.integers(35, 60, (n_haps, hap_len)).astype(np.int32),
        weight_at=np.ones((n_haps, hap_len), np.float32))
    bayes = build_bayes_table([NBinom(4.0, 0.45)] * 101, [0.3, 2.0, 3.0],
                              2.0)
    gts = np.array([(a, b) for a in range(n_haps)
                    for b in range(a, n_haps)], np.int32)
    true_ix = int(np.nonzero((gts[:, 0] == 7) & (gts[:, 1] == 23))[0][0])
    return tensors, pack, bayes, gts, true_ix


def kernels_annealer():
    import jax
    sys.path.insert(0, str(ROOT / "tests"))
    from test_ilp import small_problem
    from test_solver_pallas import deep_problem

    from locityper_tpu import mathx
    from locityper_tpu.ops.solver import SolverConfig, solve_genotypes
    from locityper_tpu.ops.solver_pallas import solve_genotypes_pallas
    from locityper_tpu.solvers.ilp import solve_ilp
    from locityper_tpu.solvers.solve import (Prediction, discard_improbable,
                                             run_filter)

    def cfg_for(params, pack, **kw):
        return SolverConfig(depth_contrib=params.depth_contrib,
                            aln_contrib=params.aln_contrib,
                            prob_diff=params.prob_diff, tweak=0,
                            window_size=pack.window_size, **kw)

    # Deterministic path (0 steps, argmax init) at window depth above 32.
    for seed in (0, 1):
        tensors, pack, bayes, params = deep_problem(seed)
        args = _solver_args(tensors, pack, bayes)
        gt = np.array([(0, 2)], np.int32)
        cfg = cfg_for(params, pack, anneal_steps=0, polish_steps=0)
        with jax.default_matmul_precision("highest"):
            want, _ = solve_genotypes(jax.random.PRNGKey(seed), gt, *args,
                                      cfg, n_attempts=1,
                                      max_windows=pack.max_windows,
                                      random_init=False)
        got, _ = solve_genotypes_pallas(jax.random.PRNGKey(seed), gt, *args,
                                        cfg, n_attempts=1,
                                        max_windows=pack.max_windows,
                                        n_steps=0, random_init=False)
        d = abs(float(np.asarray(got)[0, 0]) - float(np.asarray(want)[0, 0]))
        say(f"  annealer = seq engine at 0 steps, depth > 32 (seed {seed}): "
            f"|diff| {d:.3g} (tolerance 1e-3: float32 sums in another "
            f"order)")
        check(d <= 1e-3, f"annealer vs seq at 0 steps: {d}")

    # Dynamics: the ILP optimum, and determinism for a seed.
    tensors, pack, bayes, params = small_problem(0)
    args = _solver_args(tensors, pack, bayes)
    _, ilp = solve_ilp((0, 2), tensors, pack, bayes, params)
    cfg = cfg_for(params, pack, anneal_steps=4000, polish_steps=4000)
    liks, _ = solve_genotypes_pallas(
        jax.random.PRNGKey(0), np.array([(0, 2)], np.int32), *args, cfg,
        n_attempts=8, max_windows=pack.max_windows)
    best = float(np.max(np.asarray(liks)))
    say(f"  annealer best of 8 chains {best:.4f} vs ILP optimum {ilp:.4f} "
        f"(tolerance 0.05: float32 likelihood sums)")
    check(abs(best - ilp) <= 0.05 and best <= ilp + 0.05,
          f"annealer {best} vs ILP {ilp}")
    gts = np.array([(0, 1), (0, 2)], np.int32)
    cfg = cfg_for(params, pack, anneal_steps=2000, polish_steps=2000)
    a, _ = solve_genotypes_pallas(jax.random.PRNGKey(7), gts, *args, cfg,
                                  n_attempts=4, max_windows=pack.max_windows)
    b, _ = solve_genotypes_pallas(jax.random.PRNGKey(7), gts, *args, cfg,
                                  n_attempts=4, max_windows=pack.max_windows)
    same = bool(np.array_equal(np.asarray(a), np.asarray(b)))
    say(f"  annealer deterministic for a seed: {same} (exact)")
    check(same, "annealer not deterministic")

    # Stage 1 at 5050 genotypes: the kernel's polish walk must keep a
    # survivor set as close to the reference greedy's as the greedy keeps
    # from seed to seed.
    tensors, pack, bayes, gts, true_ix = _stage1_problem()
    args = _solver_args(tensors, pack, bayes)
    priors = np.zeros(len(gts))
    best_aln = np.maximum(tensors.hap_prob.max(axis=2),
                          tensors.unmapped_prob[None, :])
    ixs = run_filter(gts, priors, best_aln, 50.0, 5000)
    window = pack.window_size
    cfg_g = SolverConfig(tweak=0, window_size=window, greedy_sample=10,
                         plato_size=100)
    cfg_p = SolverConfig(tweak=0, window_size=window, anneal_steps=0,
                         polish_steps=8000)

    def survivors(fn, cfg, seed=11, chunk=1024):
        key = jax.random.PRNGKey(seed)
        preds = {}
        for s in range(0, ixs.size, chunk):
            sub = ixs[s:s + chunk]
            liks, _ = fn(jax.random.fold_in(key, s), gts[sub], cfg)
            liks = np.asarray(liks, np.float64)
            for i, ix in enumerate(sub):
                m, v = mathx.mean_variance(liks[i])
                preds[int(ix)] = Prediction(m, v, liks.shape[1])
        return set(discard_improbable(ixs, preds, gts, 0.01, 20).tolist())

    def greedy(k, g, cfg):
        return solve_genotypes(k, g, *args, cfg, n_attempts=1,
                               max_windows=pack.max_windows,
                               random_init=False)

    def polish(k, g, cfg):
        return solve_genotypes_pallas(k, g, *args, cfg, n_attempts=1,
                                      max_windows=pack.max_windows,
                                      n_steps=cfg.polish_steps,
                                      random_init=False)

    s_g = survivors(greedy, cfg_g)
    s_p = survivors(polish, cfg_p)
    s_g2 = survivors(greedy, cfg_g, seed=12)
    base, cross = len(s_g & s_g2), len(s_g & s_p)
    say(f"  stage-1 survivors at 5050 genotypes: kernel walk vs greedy "
        f"{cross}/20, greedy vs greedy (other seed) {base}/20, truth kept: "
        f"{true_ix in s_p}")
    check(true_ix in s_g and true_ix in s_p, "true genotype lost")
    check(cross >= min(base, 19) - 1, f"survivor overlap {cross} < {base}")

    # Times at the two stage shapes of the reference-default scheme.
    out = {}
    key = jax.random.PRNGKey(5)
    stage2 = SolverConfig(tweak=0, window_size=window)
    shapes = [("stage 1: 5050 genotypes x 1, 8000 polish steps", gts,
               1, cfg_p, False),
              ("stage 2: 20 genotypes x 20, 20000+10000 steps", gts[ixs[:20]],
               20, stage2, True)]
    for tag, g, att, cfg, rinit in shapes:
        g = np.asarray(g)
        kern = jax.jit(lambda k, g_, att=att, cfg=cfg, rinit=rinit:
                       solve_genotypes_pallas(
                           k, g_, *args, cfg, n_attempts=att,
                           max_windows=pack.max_windows,
                           random_init=rinit)[0])
        ref = jax.jit(lambda k, g_, att=att, cfg=cfg, rinit=rinit:
                      solve_genotypes(k, g_, *args, cfg, n_attempts=att,
                                      max_windows=pack.max_windows,
                                      random_init=rinit)[0])
        _, t_k = timed(kern, key, g, reps=2)
        _, t_x = timed(ref, key, g, reps=1)
        say(f"  annealer {tag}: kernel {t_k:.4f} s, XLA seq {t_x:.4f} s")
        out[tag] = dict(kernel_s=t_k, xla_s=t_x)
    SUMMARY["annealer"] = out


def kernels_recruit(rng):
    """Device recruitment is bit-identical to the host oracle at B=32768
    pairs, and the time of the XLA front end and decision kernel."""
    import jax
    sys.path.insert(0, str(ROOT / "tests"))
    from test_recruit import build_world

    from locityper_tpu import sim
    from locityper_tpu.ops import recruit as R
    from locityper_tpu.seq.recruit import (RecruitParams, TargetIndex,
                                           recruit_read_pair)
    _, genome, locus, cset, kc, _ = build_world()
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    idx.add_locus(cset, kc)
    idx.finalize()
    dev = R.DeviceIndex.from_index(idx)
    B, L = 32768, 152
    loc = sim.simulate_paired_reads(
        rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=30)
    r1 = np.full((B, L), 4, np.int8)
    r2 = np.full((B, L), 4, np.int8)
    n_loc = min(len(loc.reads1), B // 4)
    for i in range(n_loc):
        r1[i, :loc.reads1[i].size] = loc.reads1[i][:L]
        r2[i, :loc.reads2[i].size] = loc.reads2[i][:L]
    bulk = np.concatenate([np.concatenate(x, 1) for x in
                           sim.simulate_paired_reads_bulk(
                               rng, genome, depth=200, chunk=B)])
    need = B - n_loc
    reps = -(-need // bulk.shape[0])
    bulk = np.concatenate([bulk] * reps)[:need]
    r1[n_loc:, :150] = bulk[:, :150]
    r2[n_loc:, :150] = bulk[:, 150:]
    got = R.run_pairs(dev, r1, r2)
    t0 = time.perf_counter()
    n_bad = 0
    for i in range(B):
        a = r1[i][r1[i] < 4]
        b = r2[i][r2[i] < 4]
        host = recruit_read_pair(idx, a, b)
        n_bad += sorted(np.nonzero(got[i])[0].tolist()) != host
    t_host = time.perf_counter() - t0
    n_hit = int(got.any(axis=1).sum())
    say(f"  recruitment: device vs host oracle on {B} pairs ({n_hit} "
        f"recruited): {n_bad} differ (exact; host oracle took "
        f"{t_host:.1f} s)")
    check(n_bad == 0, f"{n_bad} recruitment decisions differ")

    cfg = dev.cfg
    tables = dev.device_args()
    d1, d2 = jax.device_put(r1), jax.device_put(r2)
    both = jax.device_put(np.concatenate([r1, r2]))
    front = jax.jit(lambda x: R._hash_mask(x, cfg.k, cfg.w))
    _, t_front = timed(front, both)
    _, t_dec = timed(lambda a, b: R.recruit_pairs_batch(cfg, a, b, *tables),
                     d1, d2)
    say(f"  recruit front end (XLA, hash + minimizer mask) at B={B} pairs "
        f"L={L}: {t_front * 1e3:.3f} ms; whole decision kernel "
        f"{t_dec * 1e3:.3f} ms")
    SUMMARY["recruit"] = dict(front_s=t_front, decide_s=t_dec)


# ---------------------------------------------------------------------------
# 3-4. The CLI main path
# ---------------------------------------------------------------------------

ACGT = np.frombuffer(b"ACGTN", np.uint8)


def write_fastq_bulk(f, names_prefix: str, first: int, reads: np.ndarray):
    """Fixed-width FASTQ records for [n, L] int8 reads (all of length L)."""
    n, L = reads.shape
    name = np.array([f"@{names_prefix}{first + i:09d}\n".encode()
                     for i in range(n)])
    name = name.view(np.uint8).reshape(n, -1)
    seq = ACGT[reads]
    rec = np.concatenate([
        name, seq, np.full((n, 1), ord("\n"), np.uint8),
        np.frombuffer(b"+\n", np.uint8)[None].repeat(n, 0),
        np.full((n, L), ord("I"), np.uint8),
        np.full((n, 1), ord("\n"), np.uint8)], axis=1)
    f.write(rec.tobytes())


def _fastq_record(name: str, codes: np.ndarray) -> bytes:
    seq = ACGT[codes].tobytes()
    return b"@" + name.encode() + b"\n" + seq + b"\n+\n" \
        + b"I" * len(seq) + b"\n"


class WallCapture(logging.Handler):
    """Keeps the phase walls the genotype command logs."""

    def __init__(self):
        super().__init__()
        self.walls = None

    def emit(self, record):
        if hasattr(record, "walls"):
            self.walls = dict(record.walls)


def _calls(out: Path, truth: dict) -> tuple[int, list]:
    exact, misses = 0, []
    for name, want in truth.items():
        with gzip.open(out / "loci" / name / "res.json.gz", "rt") as f:
            res = json.load(f)
        got = tuple(sorted(res["genotype"].split(",")))
        if got == want:
            exact += 1
        else:
            misses.append((name, got, want))
    return exact, misses


def _genotype(cli, argv, cap) -> dict:
    cap.walls = None
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"genotype exited {rc}")
    check(cap.walls is not None, "genotype logged no phase walls")
    return dict(total=wall, **cap.walls)


def build_short_sample(work: Path, n_loci: int, seed: int,
                       n_pairs: int = 1_000_000, hla_haps: int = 200):
    """Reference, haplotype panels, BED and a paired FASTQ sample: one
    HLA-class locus (200 haplotypes in 10 clades, 0.3% within a clade),
    n_loci ordinary loci (4 kb, 6 haplotypes), 30x diploid depth, and an
    off-target background sized to about n_pairs read pairs in all."""
    from locityper_tpu import sim
    from locityper_tpu.seq import fastx
    rng = np.random.default_rng(seed)
    loci = [sim.simulate_structured_locus(
        rng, "HLA0", length=4000, n_clades=10,
        haps_per_clade=hla_haps // 10,
        clade_divergence=0.02, within_divergence=0.003)]
    loci += [sim.simulate_locus(rng, f"L{i:03d}", length=4000, n_haps=6,
                                divergence=0.015) for i in range(n_loci)]
    spacer = 10_000
    bg_len = max(int(n_pairs * 300 / 30), 1_000_000)
    parts, bed, pos = [], [], 0
    for lc in loci:
        sp = sim.random_genome(rng, spacer)
        parts += [sp, lc.haplotypes[0]]
        bed.append((pos + spacer, pos + spacer + lc.haplotypes[0].size,
                    lc.name))
        pos += spacer + lc.haplotypes[0].size
    background = sim.random_genome(rng, bg_len)
    bg_start = pos
    genome = np.concatenate(parts + [background])
    with open(work / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    (work / "loci.bed").write_text(
        "".join(f"chr1\t{s}\t{e}\t{n}\n" for s, e, n in bed))
    for lc in loci:
        with open(work / f"haps_{lc.name}.fa", "w") as f:
            for nm, sq in zip(lc.hap_names, lc.haplotypes):
                fastx.write_fasta(f, nm, sq)
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    n = 0
    with open(work / "r1.fq", "wb") as f1, open(work / "r2.fq", "wb") as f2:
        for lc in loci:
            r = sim.simulate_paired_reads(
                rng, [lc.haplotypes[i] for i in lc.true_genotype],
                depth=15.0, errors=err, prefix=f"{lc.name}_")
            for nm, a, b in zip(r.names, r.reads1, r.reads2):
                f1.write(_fastq_record(nm, a))
                f2.write(_fastq_record(nm, b))
                n += 1
        spacers = np.concatenate(parts[0::2])
        for seq in (spacers, background):
            for a, b in sim.simulate_paired_reads_bulk(rng, seq, depth=30.0,
                                                       errors=err):
                write_fastq_bulk(f1, "bg", n, a)
                write_fastq_bulk(f2, "bg", n, b)
                n += len(a)
    truth = {lc.name: tuple(sorted(lc.hap_names[i] for i in lc.true_genotype))
             for lc in loci}
    bg_region = f"chr1:{bg_start + 100_000}-{bg_start + 1_100_000}"
    return truth, n, bg_region


def _peak_bytes():
    import jax
    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.local_devices())


def phase_shortread(work: Path, n_loci: int, seed: int, n_pairs: int,
                    hla_haps: int = 200):
    from locityper_tpu import cli
    t0 = time.perf_counter()
    truth, total, bg_region = build_short_sample(work, n_loci, seed, n_pairs,
                                                 hla_haps)
    t_sim = time.perf_counter() - t0
    say(f"  simulated {len(truth)} loci (1 x {hla_haps} haplotypes, "
        f"{n_loci} x 6) "
        f"and {total} read pairs in {t_sim:.1f} s")
    t0 = time.perf_counter()
    check(cli.main(["add", "-d", str(work / "db"), "-r", str(work / "ref.fa"),
                    "-l", str(work / "loci.bed"),
                    "-s", str(work / "haps_{}.fa")]) == 0, "add failed")
    t_add = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(cli.main(["preproc", "-i", str(work / "r1.fq"),
                    str(work / "r2.fq"), "-r", str(work / "ref.fa"),
                    "-o", str(work / "sample"), "-b", bg_region,
                    "--max-reads", "20000"]) == 0, "preproc failed")
    t_pre = time.perf_counter() - t0
    say(f"  add {t_add:.1f} s, preproc {t_pre:.1f} s")
    cap = WallCapture()
    logging.getLogger("locityper").addHandler(cap)
    argv = ["genotype", "-i", str(work / "r1.fq"), str(work / "r2.fq"),
            "-d", str(work / "db"), "-p", str(work / "sample"),
            "-o", str(work / "out"), "--seed", str(seed)]
    res = {}
    for run in ("cold", "warm"):
        walls = _genotype(cli, argv + ["--rerun", "all"], cap)
        exact, misses = _calls(work / "out", truth)
        say(f"  genotype {run}: recruit {walls['recruit']:.2f} s, align "
            f"{walls['align']:.2f} s, solve {walls['solve']:.2f} s, total "
            f"{walls['total']:.2f} s; exact calls {exact}/{len(truth)}")
        for m in misses:
            say(f"    MISS {m[0]}: called {m[1]}, truth {m[2]}")
        check(not misses, f"{len(misses)} short-read calls not exact")
        res[run] = dict(walls=walls, exact=exact)
    peak = _peak_bytes()
    say(f"  peak device memory {peak / 2**30:.3f} GiB")
    res.update(n_loci=len(truth), pairs=total, peak_bytes=peak)
    SUMMARY["shortread"] = res


def build_long_sample(work: Path, seed: int, locus_len: int = 16384,
                      read_len: int = 12000):
    from locityper_tpu import sim
    from locityper_tpu.seq import fastx
    rng = np.random.default_rng(seed)
    loci = [sim.simulate_locus(rng, f"LR{i}", length=locus_len, n_haps=4,
                               divergence=0.01) for i in range(3)]
    flanks = [sim.random_genome(rng, 60_000) for _ in range(4)]
    parts, bed, pos = [], [], 0
    for i, lc in enumerate(loci):
        parts += [flanks[i], lc.haplotypes[0]]
        bed.append((pos + flanks[i].size,
                    pos + flanks[i].size + lc.haplotypes[0].size, lc.name))
        pos += flanks[i].size + lc.haplotypes[0].size
    parts.append(flanks[-1])
    with open(work / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", np.concatenate(parts))
    (work / "loci.bed").write_text(
        "".join(f"chr1\t{s}\t{e}\t{n}\n" for s, e, n in bed))
    for lc in loci:
        with open(work / f"haps_{lc.name}.fa", "w") as f:
            for nm, sq in zip(lc.hap_names, lc.haplotypes):
                fastx.write_fasta(f, nm, sq)
    err = sim.ErrorModel(mismatch=0.02, insertion=0.008, deletion=0.008)
    with open(work / "reads.fq", "w") as f:
        for lc in loci:
            r = sim.simulate_single_reads(
                rng, [lc.haplotypes[i] for i in lc.true_genotype], depth=10.0,
                read_len_mean=read_len, read_len_sd=read_len // 6,
                errors=err, prefix=f"{lc.name}_")
            for nm, rd in zip(r.names, r.reads1):
                fastx.write_fastq(f, fastx.Read(nm, rd))
        r = sim.simulate_single_reads(rng, flanks, depth=10.0,
                                      read_len_mean=read_len,
                                      read_len_sd=read_len // 6,
                                      errors=err, prefix="bg")
        for nm, rd in zip(r.names, r.reads1):
            fastx.write_fastq(f, fastx.Read(nm, rd))
    truth = {lc.name: tuple(sorted(lc.hap_names[i] for i in lc.true_genotype))
             for lc in loci}
    return truth, f"chr1:1000-{flanks[0].size - 1000}"


def phase_longread(work: Path, seed: int, **sample):
    from locityper_tpu import cli
    truth, bg_region = build_long_sample(work, seed, **sample)
    check(cli.main(["add", "-d", str(work / "db"), "-r", str(work / "ref.fa"),
                    "-l", str(work / "loci.bed"),
                    "-s", str(work / "haps_{}.fa")]) == 0, "add failed")
    check(cli.main(["preproc", "-i", str(work / "reads.fq"),
                    "-r", str(work / "ref.fa"), "-o", str(work / "sample"),
                    "--tech", "ont", "-b", bg_region]) == 0,
          "preproc failed")
    cap = WallCapture()
    logging.getLogger("locityper").addHandler(cap)
    argv = ["genotype", "-i", str(work / "reads.fq"), "-d", str(work / "db"),
            "-p", str(work / "sample"), "-o", str(work / "out"),
            "--seed", str(seed), "--rerun", "all"]
    res = {}
    for run in ("cold", "warm"):
        walls = _genotype(cli, argv, cap)
        exact, misses = _calls(work / "out", truth)
        say(f"  long-read genotype {run}: recruit {walls['recruit']:.2f} s, "
            f"align {walls['align']:.2f} s, solve {walls['solve']:.2f} s; "
            f"exact calls {exact}/{len(truth)}")
        for m in misses:
            say(f"    MISS {m[0]}: called {m[1]}, truth {m[2]}")
        check(not misses, f"{len(misses)} long-read calls not exact")
        res[run] = dict(walls=walls, exact=exact)
    SUMMARY["longread"] = res


# ---------------------------------------------------------------------------
# 5. Several cards
# ---------------------------------------------------------------------------

def phase_mesh(work: Path, n_devices: int, n_loci: int, seed: int,
               n_pairs: int):
    """The short-read panel over an n-card auto_mesh, then on one card
    (mesh=None); the calls must be identical."""
    from locityper_tpu import cli
    from locityper_tpu.parallel import mesh as M
    truth, total, bg_region = build_short_sample(work, n_loci, seed, n_pairs)
    check(cli.main(["add", "-d", str(work / "db"), "-r", str(work / "ref.fa"),
                    "-l", str(work / "loci.bed"),
                    "-s", str(work / "haps_{}.fa")]) == 0, "add failed")
    check(cli.main(["preproc", "-i", str(work / "r1.fq"),
                    str(work / "r2.fq"), "-r", str(work / "ref.fa"),
                    "-o", str(work / "sample"), "-b", bg_region,
                    "--max-reads", "20000"]) == 0, "preproc failed")
    mesh = M.auto_mesh()
    check(mesh is not None and mesh.devices.size == n_devices,
          f"auto_mesh gave {mesh}")
    say(f"  mesh {dict(mesh.shape)} over {n_devices} cards, {len(truth)} "
        f"loci, {total} read pairs")
    cap = WallCapture()
    logging.getLogger("locityper").addHandler(cap)
    calls = {}
    auto = M.auto_mesh
    for tag in ("mesh", "one card"):
        if tag == "one card":
            M.auto_mesh = lambda: None
        out = work / f"out_{tag.replace(' ', '_')}"
        argv = ["genotype", "-i", str(work / "r1.fq"), str(work / "r2.fq"),
                "-d", str(work / "db"), "-p", str(work / "sample"),
                "-o", str(out), "--seed", str(seed)]
        walls = _genotype(cli, argv, cap)
        exact, misses = _calls(out, truth)
        got = {}
        for name in truth:
            with gzip.open(out / "loci" / name / "res.json.gz", "rt") as f:
                got[name] = json.load(f)["genotype"]
        calls[tag] = got
        say(f"  {tag}: recruit {walls['recruit']:.2f} s, align "
            f"{walls['align']:.2f} s, solve {walls['solve']:.2f} s; exact "
            f"{exact}/{len(truth)}")
    M.auto_mesh = auto
    diff = [n for n in truth if calls["mesh"][n] != calls["one card"][n]]
    say(f"  {n_devices}-card calls identical to 1-card calls: {not diff}")
    check(not diff, f"mesh and one-card calls differ at {diff}")
    SUMMARY["mesh"] = dict(devices=n_devices, identical=not diff)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="cards to use; more than 1 runs the mesh phase only")
    ap.add_argument("--phase", action="append", default=None,
                    choices=("kernels", "shortread", "longread"),
                    help="run only these phases (after the device check)")
    ap.add_argument("--loci", type=int, default=30,
                    help="ordinary short-read loci beside the HLA-class one")
    ap.add_argument("--pairs", type=int, default=1_000_000,
                    help="read pairs of the short-read sample (about)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    phase_device(args.devices)
    logging.getLogger("locityper").setLevel(logging.INFO)
    work = ROOT / ".smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    t_start = time.perf_counter()
    try:
        if args.devices > 1:
            say(f"[mesh] {args.devices} cards")
            (work / "mesh").mkdir(parents=True)
            phase_mesh(work / "mesh", args.devices, args.loci, args.seed,
                       args.pairs)
        else:
            phases = args.phase or ["kernels", "shortread", "longread"]
            rng = np.random.default_rng(args.seed)
            if "kernels" in phases:
                say("[kernels]")
                kernels_aligner(rng)
                kernels_annealer()
                kernels_recruit(rng)
            if "shortread" in phases:
                say("[shortread]")
                (work / "short").mkdir(parents=True)
                phase_shortread(work / "short", args.loci, args.seed,
                                args.pairs)
            if "longread" in phases:
                say("[longread]")
                (work / "long").mkdir(parents=True)
                phase_longread(work / "long", args.seed)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    import jax
    dev = jax.devices()[0]
    SUMMARY["wall_s"] = time.perf_counter() - t_start
    say(f"summary: {json.dumps(SUMMARY)}")
    say(f"card: {SUMMARY['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": args.devices}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
