"""Streaming recruit-first preproc: depth must be
correct when the background region holds only a small fraction of the input
reads — round 1 read the first --max-reads reads of the file and
underestimated depth by orders of magnitude on WGS-scale input
(preproc.rs:659-714 recruit-first)."""
import json
import gzip
import numpy as np
import pytest

from locityper_tpu import cli, sim
from locityper_tpu.bg import BgDistr
from locityper_tpu.seq import fastx
from locityper_tpu.seq.fastx import Read
from locityper_tpu.utils import paths as P


@pytest.fixture(scope="module")
def wgs_world(tmp_path_factory):
    """A 400kb "genome" with a 60kb bg region in the middle; reads simulated
    from the WHOLE genome, so the bg region holds ~15% of them.  File order
    is genome order, so a head-truncated reader would see region reads only
    deep into the file."""
    root = tmp_path_factory.mktemp("wgs")
    rng = np.random.default_rng(11)
    genome = sim.random_genome(rng, 400_000)
    depth = 24.0
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    reads = sim.simulate_paired_reads(rng, [genome], depth=depth, errors=err)
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    # Sort reads by position (names encode nothing positional — simulate
    # file order = genome order by NOT shuffling; simulate_paired_reads
    # already emits roughly genome order).
    with open(root / "r1.fq", "w") as f1, open(root / "r2.fq", "w") as f2:
        for nm, s1, s2 in zip(reads.names, reads.reads1, reads.reads2):
            fastx.write_fastq(f1, Read(nm, s1))
            fastx.write_fastq(f2, Read(nm, s2))
    return root, genome, depth


def _run_preproc(root, out_name, extra):
    rc = cli.main(["preproc", "-i", str(root / "r1.fq"), str(root / "r2.fq"),
                   "-r", str(root / "ref.fa"), "-o", str(root / out_name),
                   "-b", "chr1:170000-230000"] + extra)
    assert rc == 0
    return BgDistr.load(P.bg_dir(root / out_name) / P.BG_DISTR)


def test_streaming_recruit_correct_depth(wgs_world):
    root, genome, depth = wgs_world
    bg = _run_preproc(root, "pre_stream", [])
    d = bg.depth.depth_distribution(41)
    # Haploid single-mate window depth ~ depth/2 * window/(2*read_len)...
    # compare through the model's own scale: estimated mean per window
    # (GC~41) times 2 (diploid) * 2 (mates) * read_len / window ~= depth.
    w = bg.depth.window_size
    est_total = d.mean() * 2 * 2 * 150.0 / w
    assert est_total == pytest.approx(depth, rel=0.25), \
        f"estimated {est_total:.1f}x vs simulated {depth}x"


def test_max_reads_subsampling_corrects_depth(wgs_world):
    root, genome, depth = wgs_world
    bg = _run_preproc(root, "pre_sub", ["--max-reads", "1500"])
    d = bg.depth.depth_distribution(41)
    w = bg.depth.window_size
    est_total = d.mean() * 2 * 2 * 150.0 / w
    # Subsampled 1500 of ~13k recruited pairs; the rate correction must
    # bring the depth back near truth.
    assert est_total == pytest.approx(depth, rel=0.35), \
        f"estimated {est_total:.1f}x vs simulated {depth}x"


def test_head_truncation_would_have_failed(wgs_world):
    """Sanity: the pre-round-2 behavior (first N reads only) fails on this
    input — of 1500 head reads only a small fraction fall in the region, so
    estimation either errors out or badly underestimates depth.  Guards
    that the fixture actually exercises the failure mode."""
    root, genome, depth = wgs_world
    rc = cli.main(["preproc", "-i", str(root / "r1.fq"), str(root / "r2.fq"),
                   "-r", str(root / "ref.fa"), "-o", str(root / "pre_skip"),
                   "-b", "chr1:170000-230000",
                   "--skip-recruitment", "--max-reads", "1500"])
    if rc != 0:
        return      # head reads don't even yield enough region pairs
    bg = BgDistr.load(P.bg_dir(root / "pre_skip") / P.BG_DISTR)
    d = bg.depth.depth_distribution(41)
    w = bg.depth.window_size
    est_total = d.mean() * 2 * 2 * 150.0 / w
    assert est_total < 0.5 * depth

def test_single_pass_io(wgs_world, monkeypatch, tmp_path):
    """Preproc must stream each input exactly once —
    total_reads is tallied during the recruitment stream (preproc.rs:979),
    never by a re-scan.  _count_input (the old full re-scan) must never
    run, and the stored totals must match the files exactly (proof the
    counting happened inside the single recruitment stream; the bounded
    head-probe sizing the batch width reads one 4 MB chunk, not a pass)."""
    from locityper_tpu.commands import preproc as pp

    root, genome, depth = wgs_world
    monkeypatch.setattr(
        pp, "_count_input",
        lambda *a: pytest.fail("preproc re-scanned the input"))
    out = tmp_path / "pre_once"
    rc = cli.main(["preproc", "-i", str(root / "r1.fq"), str(root / "r2.fq"),
                   "-r", str(root / "ref.fa"), "-o", str(out),
                   "-b", "chr1:170000-230000"])
    assert rc == 0

    bg = BgDistr.load(P.bg_dir(out) / P.BG_DISTR)
    with open(root / "r1.fq") as f:
        n_pairs = sum(1 for _ in f) // 4
    assert bg.seq_info.total_reads == n_pairs
    assert bg.seq_info.file_size == ((root / "r1.fq").stat().st_size
                                     + (root / "r2.fq").stat().st_size)
