"""100 kb locus + 20 kb ONT reads through the full pipeline on chip:
validates the row-streamed any-L aligner + device Kadane recruitment at
an order of magnitude beyond the 16-24 kb panels (round 5; reference
long-read path: recruit.rs:940-964, bg/mod.rs:245-288)."""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from locityper_tpu.cli import _enable_compile_cache  # noqa: E402
_enable_compile_cache()
from locityper_tpu import sim  # noqa: E402
from locityper_tpu.bg import BgDistr, SequencingInfo, Technology  # noqa: E402
from locityper_tpu.bg.depth import ReadDepth  # noqa: E402
from locityper_tpu.bg.err_prof import ErrorProfile  # noqa: E402
from locityper_tpu.bg.insertsz import InsertDistr  # noqa: E402
from locityper_tpu.commands.genotype import recruit_reads  # noqa: E402
from locityper_tpu.mathx.distr import NBinom  # noqa: E402
from locityper_tpu.pipeline import LocusData, genotype_locus  # noqa: E402
from locityper_tpu.seq.contigs import ContigSet  # noqa: E402
from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts  # noqa: E402
from locityper_tpu.seq.recruit import RecruitParams  # noqa: E402
from locityper_tpu.solvers.solve import Scheme  # noqa: E402

rng = np.random.default_rng(17)
locus = sim.simulate_locus(rng, "BIG", length=98304, n_haps=4,
                           divergence=0.01)
genome = np.concatenate([sim.random_genome(rng, 50000), locus.haplotypes[0],
                         sim.random_genome(rng, 50000)])
counter = GenomeKmerCounter(25)
counter.add_seq(genome)
counter.finalize()
kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
data = LocusData(ContigSet("BIG", locus.hap_names, locus.haplotypes), kc)

err = sim.ErrorModel(mismatch=0.02, insertion=0.008, deletion=0.008)
reads = sim.simulate_single_reads(
    rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=8.0,
    read_len_mean=20000, read_len_sd=5000, errors=err, prefix="big")
bgr = sim.simulate_single_reads(rng, [genome[:50000]], depth=4.0,
                                read_len_mean=20000, read_len_sd=5000,
                                errors=err, prefix="bg")
all_reads = list(reads.reads1) + list(bgr.reads1)
names = list(reads.names) + list(bgr.names)
total_bp = int(sum(r.size for r in all_reads))
print(f"{len(all_reads)} reads, {total_bp} bp, max "
      f"{max(r.size for r in all_reads)} bp", flush=True)

ep = ErrorProfile.estimate(950000, 20000, 8000, 8000,
                           [(700, 20000, 50.0), (780, 20000, 30.0)])
window = 2000
m = 8.0 * window / 20000.0 / 2.0
bg = BgDistr(SequencingInfo(20000.0, Technology.NANOPORE),
             InsertDistr.undefined(), ep,
             ReadDepth(2, window, max(window, 300),
                       [NBinom.estimate(m, m * 1.5)] * 101))
rp = RecruitParams(match_frac=Technology.NANOPORE.default_match_frac(False),
                   match_length=2000)

t0 = time.perf_counter()
rec, _ = recruit_reads({"BIG": data},
                       ((n, r, None) for n, r in zip(names, all_reads)),
                       rp, seed=2)
t1 = time.perf_counter()
pairs, rnames = rec["BIG"]
res, stats = genotype_locus(data, pairs, rnames, bg,
                            scheme=Scheme.default(), seed=2)
t2 = time.perf_counter()
called = tuple(sorted(int(x) for x in res.genotypes[0]))
print(f"recruited {len(pairs)} reads in {t1 - t0:.1f}s; "
      f"align+solve {t2 - t1:.1f}s", flush=True)
print(f"called {called} truth {locus.true_genotype} "
      f"quality {res.quality:.1f} "
      f"[{total_bp / (t2 - t0):.0f} input bp/s e2e]")
assert called == locus.true_genotype
print("100 kb STREAMING PIPELINE: exact genotype on device")
