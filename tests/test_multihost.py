"""Two REAL `jax.distributed` processes genotype one panel into a shared
output directory (not a monkeypatched `process_count`).  Each process
initializes the distributed runtime on the CPU backend, takes its
round-robin share of the loci
(parallel/multihost.py), genotypes it through the full CLI, and the
outputs merge in one directory.  Counterpart capability: the reference
scales its solver pool to all cores of one node (solvers/solve.rs:969-1127);
this framework scales across hosts by locus sharding with no cross-host
collectives."""
import gzip
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from locityper_tpu import cli, sim
from locityper_tpu.seq import fastx
from locityper_tpu.utils.io import smart_create

N_LOCI = 4

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")   # workers run on the CPU
from locityper_tpu import cli
rc = cli.main(sys.argv[1:])
assert jax.process_count() == 2, jax.process_count()
sys.exit(rc)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(31)
    loci = [sim.simulate_locus(rng, f"G{i}", length=2500, n_haps=4,
                               divergence=0.02) for i in range(N_LOCI)]
    parts = [sim.random_genome(rng, 15000)]
    starts = []
    for locus in loci:
        starts.append(sum(p.size for p in parts))
        parts.append(locus.haplotypes[0])
        parts.append(sim.random_genome(rng, 15000))
    genome = np.concatenate(parts)
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    bed = "".join(f"chr1\t{s}\t{s + loci[i].haplotypes[0].size}\tG{i}\n"
                  for i, s in enumerate(starts))
    (root / "loci.bed").write_text(bed)
    for locus in loci:
        with open(root / f"haps_{locus.name}.fa", "w") as f:
            for name, seq in zip(locus.hap_names, locus.haplotypes):
                fastx.write_fasta(f, name, seq)
    assert cli.main(["add", "-d", str(root / "db"), "-r",
                     str(root / "ref.fa"), "-l", str(root / "loci.bed"),
                     "-s", str(root / "haps_{}.fa")]) == 0

    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    all1, all2, names = [], [], []
    for locus in loci:
        r = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=18.0, errors=err, prefix=locus.name)
        all1 += r.reads1
        all2 += r.reads2
        names += r.names
    # Background from the inter-locus flanks only — reads of the embedded
    # reference haplotypes would contaminate the per-locus truth.
    flanks = [p for p in parts if p.size == 15000]
    bgr = sim.simulate_paired_reads(rng, flanks, depth=8.0, errors=err,
                                    prefix="bg")
    all1 += bgr.reads1
    all2 += bgr.reads2
    names += bgr.names
    with smart_create(root / "r1.fq.gz") as f1, \
            smart_create(root / "r2.fq.gz") as f2:
        for nm, a, b in zip(names, all1, all2):
            fastx.write_fastq(f1, fastx.Read(nm, a))
            fastx.write_fastq(f2, fastx.Read(nm, b))
    assert cli.main(["preproc", "-i", str(root / "r1.fq.gz"),
                     str(root / "r2.fq.gz"), "-r", str(root / "ref.fa"),
                     "-o", str(root / "bg"), "-b",
                     f"chr1:1001-{genome.size - 1000}"]) == 0
    return root, loci


def test_two_process_distributed_genotype(world):
    root, loci = world
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = root / "out"
    worker = root / "worker.py"
    worker.write_text(_WORKER)
    args = [sys.executable, str(worker), "genotype",
            "-i", str(root / "r1.fq.gz"), str(root / "r2.fq.gz"),
            "-d", str(root / "db"), "-p", str(root / "bg"),
            "-o", str(out), "-S", "anneal:i=6,a=6,n=2500,p=1200",
            "--seed", "4"]
    import os
    procs = []
    for pid in range(2):
        env = dict(os.environ,
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   PYTHONPATH=str(Path(__file__).parent.parent)
                   + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.pop("XLA_FLAGS", None)      # one CPU device per process
        procs.append(subprocess.Popen(args, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=1200) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]

    # Each process took exactly half the loci (cost-weighted LPT over
    # near-equal costs balances 2/2), and the halves partition the panel:
    # every locus genotyped by exactly one process.
    shard_lines = ["Host 0/2 takes 2/4 loci", "Host 1/2 takes 2/4 loci"]
    logs = [se for _, se in outs]
    assert any(shard_lines[0] in l for l in logs)
    assert any(shard_lines[1] in l for l in logs)
    done = [{f"G{i}" for i in range(N_LOCI) if f"[G{i}] GT =" in se}
            for _, se in outs]
    assert len(done[0]) == len(done[1]) == 2, (done, logs[0][-2000:])
    assert done[0] | done[1] == {f"G{i}" for i in range(N_LOCI)}
    assert not done[0] & done[1]

    # The shared output directory holds every locus, all called correctly.
    for i, locus in enumerate(loci):
        res_path = out / "loci" / f"G{i}" / "res.json.gz"
        assert res_path.exists(), f"G{i} missing from merged output"
        res = json.load(gzip.open(res_path))
        called = sorted(res["genotype"].split(","))
        truth = sorted(locus.hap_names[j] for j in locus.true_genotype)
        assert called == truth, (i, called, truth)
