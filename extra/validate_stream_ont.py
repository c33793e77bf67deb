import numpy as np, time
from locityper_tpu.cli import _enable_compile_cache
_enable_compile_cache()
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

rng = np.random.default_rng(11)
locus = sim.simulate_locus(rng, "ONTL", length=24000, n_haps=4, divergence=0.01)
genome = np.concatenate([sim.random_genome(rng, 30000), locus.haplotypes[0],
                         sim.random_genome(rng, 30000)])
counter = GenomeKmerCounter(25); counter.add_seq(genome); counter.finalize()
kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
data = LocusData(ContigSet("ONTL", locus.hap_names, locus.haplotypes), kc)
true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
reads = sim.simulate_single_reads(rng, true_haps, depth=8.0,
                                  read_len_mean=12000, read_len_sd=1500,
                                  errors=sim.ErrorModel(0.02, 0.008, 0.008))
print(f"{len(reads.reads1)} reads, mean len {np.mean([r.size for r in reads.reads1]):.0f}")
ep = ErrorProfile.estimate(950000, 20000, 8000, 8000,
                           [(420, 12000, 50.0), (470, 12000, 30.0)])
window = 2000
m = 8.0 * window / 12000.0 / 2.0
depth = ReadDepth(2, window, max(window, 300), [NBinom.estimate(m, m*1.5)]*101)
bg = BgDistr(SequencingInfo(12000.0, Technology.NANOPORE),
             InsertDistr.undefined(), ep, depth)
t0 = time.perf_counter()
result, stats = genotype_locus(
    data, [(r, None) for r in reads.reads1], reads.names, bg,
    scheme=Scheme.parse(["greedy:i=5k,a=1", "anneal:i=6,a=6,n=2000,p=1000"]),
    seed=4)
dt = time.perf_counter() - t0
called = tuple(sorted(int(x) for x in result.genotypes[0]))
print(f"called {called} truth {locus.true_genotype} in {dt:.0f}s "
      f"quality {result.quality:.1f}")
assert called == locus.true_genotype
print("ONT 12kb STREAMING PIPELINE: exact genotype on device")
