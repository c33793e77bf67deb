"""Chips-scaling curve on the virtual CPU mesh (1 -> 8 devices).

Times the three sharded production steps — pair recruitment
(sharded_recruit_pairs), alignment (build_all_alignments(mesh=...)) and
solving (solve_locus(mesh=...)) — at 1/2/4/8 virtual XLA CPU devices.
Wall-clock on CPU is only indicative (one physical socket is shared by
all virtual devices; true scaling needs real devices), but the
curve validates that the sharded paths partition work and that overheads
do not swamp the kernels.

Usage: python extra/scaling_cpu.py            # prints one line per n
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).parent.parent


def run_one(n: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, str(REPO))
    from locityper_tpu import sim
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.model import Params
    from locityper_tpu.model.locs import build_all_alignments
    from locityper_tpu.ops.recruit import DeviceIndex
    from locityper_tpu.parallel.mesh import make_mesh, sharded_recruit_pairs
    from locityper_tpu.pipeline import LocusData, genotype_locus
    from locityper_tpu.seq import dna
    from locityper_tpu.seq.contigs import ContigSet
    from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
    from locityper_tpu.seq.recruit import RecruitParams, TargetIndex
    from locityper_tpu.solvers.solve import Scheme

    sys.path.insert(0, str(REPO / "tests"))
    from test_pipeline import make_bg

    assert jax.device_count() == n, (jax.device_count(), n)
    mesh = make_mesh() if n > 1 else None
    rng = np.random.default_rng(0)

    # --- world
    locus = sim.simulate_locus(rng, length=4000, n_haps=6, divergence=0.02)
    counter = GenomeKmerCounter(25)
    counter.add_seq(np.concatenate([sim.random_genome(rng, 30000),
                                    locus.haplotypes[0]]))
    counter.finalize()
    kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
    cset = ContigSet(locus.name, locus.hap_names, locus.haplotypes)

    # --- recruit: 16k pairs x 192bp through the device kernel
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    idx.add_locus(cset, kc)
    idx.finalize()
    dev = DeviceIndex.from_index(idx)
    B, L = 16384, 192
    r1 = np.full((B, L), 4, np.int8)
    r2 = np.full((B, L), 4, np.int8)
    for i in range(B):
        s = int(rng.integers(0, 3800))
        r1[i, :150] = locus.haplotypes[i % 6][s:s + 150]
        r2[i, :150] = dna.revcomp(locus.haplotypes[0][s:s + 150])

    def recruit_once():
        if mesh is not None:
            from locityper_tpu.ops.recruit import unpack_decisions
            return unpack_decisions(np.asarray(sharded_recruit_pairs(
                mesh, dev.cfg, r1, r2, *dev.tables())), dev.n_loci)
        from locityper_tpu.ops.recruit import run_pairs
        return run_pairs(dev, r1, r2)

    recruit_once()                               # compile
    t_rec = min(_time(recruit_once) for _ in range(3))

    # --- align + solve through the production per-locus pipeline
    err = sim.ErrorModel(0.003, 0.0003, 0.0003)
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    reads = sim.simulate_paired_reads(rng, true_haps, depth=24.0, errors=err)
    pairs = list(zip(reads.reads1, reads.reads2))
    names = reads.names
    bg = make_bg()
    params = Params(unmapped_penalty=bg.seq_info.technology
                    .default_unmapped_penalty())
    params.set_tweak_size(bg.depth.window_size)
    params.band = 48
    cache = EditDistCache(bg.err_prof, EditThresh.default_for(
        bg.seq_info.technology))

    def align_once():
        return build_all_alignments(pairs, names, cset, kc, bg, cache,
                                    params, mesh=mesh)

    align_once()
    t_aln = min(_time(align_once) for _ in range(3))

    scheme = Scheme.parse(["anneal:i=8,a=8,n=3000,p=1500"])

    def solve_once():
        return genotype_locus(LocusData(cset, kc), pairs, names, bg,
                              params=params, scheme=scheme, seed=5,
                              mesh=mesh)

    result, _ = solve_once()
    t_e2e = min(_time(solve_once) for _ in range(2))
    called = tuple(sorted(int(x) for x in result.genotypes[0]))
    print(json.dumps(dict(n=n, recruit_s=round(t_rec, 3),
                          align_s=round(t_aln, 3), locus_s=round(t_e2e, 3),
                          pairs_per_s=int(B / t_rec),
                          exact=called == locus.true_genotype)))


def _time(fn):
    t0 = time.monotonic()
    fn()
    return time.monotonic() - t0


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        run_one(int(sys.argv[2]))
        return
    for n in (1, 2, 4, 8):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + f" --xla_force_host_platform_device_count={n}"
                            ).strip()
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        subprocess.run([sys.executable, __file__, "--one", str(n)], env=env,
                       check=True)


if __name__ == "__main__":
    main()
