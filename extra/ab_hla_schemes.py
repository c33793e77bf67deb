"""Same-session interleaved A/B at HLA scale: reference-default solver
scheme vs a tuned scheme (stage-1 polish 8000->3000 steps, stage-2
seeded short anneal `init=prev`).  Reports per-scheme walls AND asserts
call equality — the evidence required to offer the tuned scheme as a
documented option.
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from locityper_tpu.cli import _enable_compile_cache  # noqa: E402
_enable_compile_cache()
from locityper_tpu.utils.malloc import tune_host_allocator  # noqa: E402
tune_host_allocator()

import tempfile  # noqa: E402

import bench  # noqa: E402
from extra.hla_scale import build_panel  # noqa: E402
from locityper_tpu.bg.err_prof import EditDistCache, EditThresh  # noqa: E402
from locityper_tpu.commands.genotype import recruit_reads_fast  # noqa: E402
from locityper_tpu.model import Params  # noqa: E402
from locityper_tpu.model.locs import build_all_alignments_panel  # noqa: E402
from locityper_tpu.pipeline import genotype_panel  # noqa: E402
from locityper_tpu.seq.fastx import Read, write_fastq  # noqa: E402
from locityper_tpu.seq.recruit import RecruitParams  # noqa: E402
from locityper_tpu.solvers.solve import Scheme  # noqa: E402


class Args:
    n_loci = 5
    n_haps = 200
    n_clades = 10
    within_div = 0.003
    length = 4000
    depth = 15.0
    seed = 0


loci, data, (names, reads1, reads2) = build_panel(Args)
tmpd = Path(tempfile.mkdtemp(prefix="ab_hla_"))
fq1, fq2 = tmpd / "r1.fq", tmpd / "r2.fq"
with open(fq1, "w") as f1, open(fq2, "w") as f2:
    for n, a, b in zip(names, reads1, reads2):
        write_fastq(f1, Read(n, a))
        write_fastq(f2, Read(n, b))

bg = bench._make_bg(depth_per_hap=Args.depth)
tech = bg.seq_info.technology
params = Params(unmapped_penalty=tech.default_unmapped_penalty())
params.set_tweak_size(bg.depth.window_size)
if params.band is None:
    params.band = 48
edit_cache = EditDistCache(bg.err_prof, EditThresh.default_for(tech))
rp = RecruitParams(match_frac=tech.default_match_frac(True))

SCHEMES = {
    "default": Scheme.default(),
    "tuned": Scheme.parse(["greedy:i=5k,a=1,p=3k",
                           "anneal:i=20,a=20,n=2k,p=10k,init=prev"]),
}
truth = [tuple(sorted(l.true_genotype)) for l in loci]


def one_pass(scheme, seed):
    t0 = time.perf_counter()
    rec, _ = recruit_reads_fast(data, str(fq1), str(fq2), rp, seed=seed)
    t1 = time.perf_counter()
    panel = [(rec[l.name][0], rec[l.name][1], data[l.name].contig_set,
              data[l.name].kmer_counts) for l in loci]
    built = build_all_alignments_panel(panel, bg, edit_cache, params)
    t2 = time.perf_counter()
    entries = [dict(locus=data[l.name], read_pairs=rec[l.name][0],
                    names=rec[l.name][1], tag=l.name, prebuilt=built[i])
               for i, l in enumerate(loci)]
    solved = genotype_panel(entries, bg, params=params, scheme=scheme,
                            seed=seed)
    t3 = time.perf_counter()
    calls = [tuple(sorted(res.genotypes[0])) for res, _ in solved]
    return dict(recruit=t1 - t0, align=t2 - t1, solve=t3 - t2,
                total=t3 - t0, calls=calls)


# Warmup/compile each scheme once.
for name, sch in SCHEMES.items():
    t0 = time.perf_counter()
    r = one_pass(sch, 1)
    print(f"compile {name}: {time.perf_counter() - t0:.1f}s "
          f"exact={sum(c == t for c, t in zip(r['calls'], truth))}/5",
          flush=True)

walls = {k: [] for k in SCHEMES}
calls_by = {}
for rnd in range(3):
    for name, sch in SCHEMES.items():
        r = one_pass(sch, 2)
        walls[name].append((r["recruit"], r["align"], r["solve"],
                            r["total"]))
        calls_by[name] = r["calls"]
        print(f"[{rnd}] {name}: recruit={r['recruit']:.2f} "
              f"align={r['align']:.2f} solve={r['solve']:.2f} "
              f"total={r['total']:.2f}", flush=True)

for name, ws in walls.items():
    med = np.median([w[3] for w in ws])
    print(f"{name}: median total {med:.2f}s "
          f"(solve {np.median([w[2] for w in ws]):.2f}s, "
          f"align {np.median([w[1] for w in ws]):.2f}s)", flush=True)
same = calls_by["default"] == calls_by["tuned"]
exact_d = sum(c == t for c, t in zip(calls_by["default"], truth))
exact_t = sum(c == t for c, t in zip(calls_by["tuned"], truth))
print(f"calls identical: {same}; exact default {exact_d}/5, "
      f"tuned {exact_t}/5")
