"""CRAI indexed CRAM access (seq/crai.py): index build/load round-trip,
region fetch vs full scan, unplaced tail, and indexed fetch-region
recruitment from CRAM and from multiple indexed BAMs in the genotype CLI
(reference fastx.rs:586-887, genotype.rs:792-870)."""
import numpy as np
import pytest

from locityper_tpu.seq import bai, bam, crai
from locityper_tpu.seq.cram import (FLAG_PAIRED, FLAG_READ1, FLAG_READ2,
                                    FLAG_UNMAPPED, CramWriter,
                                    read_cram_records)


def _codes(rng, n):
    return rng.integers(0, 4, n).astype(np.int8)


@pytest.fixture
def sorted_cram(tmp_path):
    """Coordinate-sorted 2-contig reference-based CRAM with an unmapped
    tail, several containers (writer flushes every 4096 records)."""
    rng = np.random.default_rng(5)
    ref = {"c1": _codes(rng, 200_000), "c2": _codes(rng, 200_000)}
    path = tmp_path / "s.cram"
    recs = []
    for rid, cname in ((0, "c1"), (1, "c2")):
        poss = np.sort(rng.integers(0, 199_800, 5000))
        for i, p in enumerate(poss):
            recs.append((f"r{rid}_{i}", rid, int(p)))
    with CramWriter(path, ["c1", "c2"], [200_000, 200_000],
                    reference=ref) as w:
        for name, rid, p in recs:
            seq = ref["c1" if rid == 0 else "c2"][p:p + 100]
            w.write(name, 0, seq, ref_id=rid, pos=p)
        for i in range(15):
            w.write(f"un{i}", FLAG_UNMAPPED, _codes(rng, 100))
    return path, ref, recs


class TestCraiFetch:
    def test_build_load_roundtrip(self, sorted_cram):
        path, ref, _ = sorted_cram
        idx = crai.build_crai(path)
        assert (path.parent / "s.cram.crai").exists()
        idx2 = crai.CraiIndex.load(str(path) + ".crai")
        assert len(idx2.entries) == len(idx.entries) >= 3
        for a, b in zip(idx.entries, idx2.entries):
            assert (a.ref_id, a.start, a.span, a.c_offset) == \
                (b.ref_id, b.start, b.span, b.c_offset)

    def test_fetch_window(self, sorted_cram):
        path, ref, recs = sorted_cram
        idx = crai.build_crai(path)
        for rid, beg, end in ((0, 50_000, 60_000), (1, 0, 5_000),
                              (1, 150_000, 200_000)):
            want = sorted(n for n, r, p in recs
                          if r == rid and p < end and p + 100 > beg)
            got = sorted(r.name for r in
                         crai.fetch(path, idx, rid, beg, end, reference=ref))
            assert got == want

    def test_fetch_decodes_fewer_containers(self, sorted_cram):
        path, ref, recs = sorted_cram
        idx = crai.build_crai(path)
        offs = idx.container_offsets(0, 50_000, 60_000)
        all_offs = {e.c_offset for e in idx.entries}
        assert len(offs) < len(all_offs)

    def test_fetch_all_equals_stream(self, sorted_cram):
        path, ref, recs = sorted_cram
        idx = crai.build_crai(path)
        got = [r.name for r in crai.fetch(path, idx, 0, 0, 200_000,
                                          reference=ref)]
        want = [r.name for r in read_cram_records(path, reference=ref)
                if r.ref_id == 0 and r.pos >= 0]
        assert got == want

    def test_unplaced_tail(self, sorted_cram):
        path, ref, _ = sorted_cram
        idx = crai.build_crai(path)
        un = sorted(r.name for r in crai.fetch_unplaced(path, idx,
                                                        reference=ref))
        assert un == sorted(f"un{i}" for i in range(15))

    def test_fetched_seqs_decode_exactly(self, sorted_cram):
        path, ref, recs = sorted_cram
        idx = crai.build_crai(path)
        by_name = {n: (r, p) for n, r, p in recs}
        for rec in crai.fetch(path, idx, 0, 10_000, 12_000, reference=ref):
            rid, p = by_name[rec.name]
            np.testing.assert_array_equal(rec.seq, ref["c1"][p:p + 100])
            assert rec.pos == p and rec.end == p + 100


def _make_world(tmp_path, rng):
    from locityper_tpu import cli, sim
    from locityper_tpu.seq import fastx

    locus = sim.simulate_locus(rng, "L1", length=3000, n_haps=4,
                               divergence=0.02)
    left = sim.random_genome(rng, 50_000)
    right = sim.random_genome(rng, 50_000)
    genome = np.concatenate([left, locus.haplotypes[0], right])
    with open(tmp_path / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    (tmp_path / "loci.bed").write_text(
        f"chr1\t{left.size}\t{left.size + locus.haplotypes[0].size}\tL1\n")
    with open(tmp_path / "haps.fa", "w") as f:
        for name, seq in zip(locus.hap_names, locus.haplotypes):
            fastx.write_fasta(f, name, seq)
    assert cli.main(["add", "-d", str(tmp_path / "db"),
                     "-r", str(tmp_path / "ref.fa"),
                     "-l", str(tmp_path / "loci.bed"),
                     "-s", str(tmp_path / "haps.fa")]) == 0

    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    lr = sim.simulate_paired_reads(rng, true_haps, depth=14.0, read_len=150,
                                   errors=err)
    br = sim.simulate_paired_reads(rng, [left, left, right, right],
                                   depth=10.0, read_len=150, errors=err)
    entries = []
    for i, (c1, c2) in enumerate(zip(lr.reads1, lr.reads2)):
        pos = int(left.size + rng.integers(0, locus.haplotypes[0].size - 300))
        entries.append((pos, f"t{i}", c1, c2))
    for i, (c1, c2) in enumerate(zip(br.reads1, br.reads2)):
        pos = int(rng.integers(0, left.size - 400))
        entries.append((pos, f"g{i}", c1, c2))

    fq1, fq2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for pos, name, c1, c2 in entries:
            fastx.write_fastq(f1, fastx.Read(name, c1))
            fastx.write_fastq(f2, fastx.Read(name, c2))
    assert cli.main(["preproc", "-i", str(fq1), str(fq2),
                     "-r", str(tmp_path / "ref.fa"),
                     "-o", str(tmp_path / "bg"),
                     "-b", "chr1:1001-48000"]) == 0
    return locus, genome, entries


def _check_called(tmp_path, locus):
    import gzip
    import json

    res = json.load(gzip.open(tmp_path / "out" / "loci" / "L1"
                              / "res.json.gz"))
    called = sorted(res["genotype"].split(","))
    truth = sorted(locus.hap_names[i] for i in locus.true_genotype)
    assert called == truth


def test_genotype_cli_indexed_cram(tmp_path, caplog):
    """genotype from a coordinate-sorted CRAM + .crai takes the
    fetch-region path (no full scan) and calls the true genotype."""
    import logging

    from locityper_tpu import cli

    rng = np.random.default_rng(43)
    locus, genome, entries = _make_world(tmp_path, rng)

    flat = []
    for pos, name, c1, c2 in entries:
        flat.append((pos, name, FLAG_PAIRED | FLAG_READ1, c1))
        flat.append((pos + 150, name, FLAG_PAIRED | FLAG_READ2, c2))
    flat.sort(key=lambda t: t[0])
    cram_path = tmp_path / "sample.cram"
    ref_map = {"chr1": genome}
    with CramWriter(cram_path, ["chr1"], [genome.size],
                    reference=ref_map) as w:
        for pos, name, flag, c in flat:
            w.write(name, flag, c, ref_id=0, pos=pos)
    assert cli.main(["index", str(cram_path)]) == 0
    assert (tmp_path / "sample.cram.crai").exists()

    with caplog.at_level(logging.INFO, logger="locityper"):
        assert cli.main(["genotype", "-i", str(cram_path),
                         "-r", str(tmp_path / "ref.fa"),
                         "-d", str(tmp_path / "db"),
                         "-p", str(tmp_path / "bg"),
                         "-o", str(tmp_path / "out"),
                         "-S", "anneal:i=8,a=8,n=2000,p=1000"]) == 0
    assert any("Indexed input" in r.message for r in caplog.records), \
        "fetch-region path not taken"
    _check_called(tmp_path, locus)


def test_genotype_cli_two_indexed_bams(tmp_path, caplog):
    """genotype from TWO indexed BAMs (reads split between them) fetches
    regions from both files and calls the true genotype."""
    import logging

    from locityper_tpu import cli

    rng = np.random.default_rng(44)
    locus, genome, entries = _make_world(tmp_path, rng)

    halves = ([], [])
    for k, (pos, name, c1, c2) in enumerate(entries):
        halves[k % 2].append((pos, name, c1, c2))
    bam_paths = []
    for h, sub in enumerate(halves):
        flat = []
        for pos, name, c1, c2 in sub:
            flat.append((pos, name, bam.FLAG_PAIRED | bam.FLAG_MATE1, c1))
            flat.append((pos + 150, name, bam.FLAG_PAIRED | bam.FLAG_MATE2,
                         c2))
        flat.sort(key=lambda t: t[0])
        p = tmp_path / f"half{h}.bam"
        with bam.BamWriter(p, ["chr1"], [genome.size]) as w:
            for pos, name, flag, c in flat:
                w.write(name, flag, c, ref_id=0, pos=pos)
        bai.build_bai(p)
        bam_paths.append(p)

    with caplog.at_level(logging.INFO, logger="locityper"):
        assert cli.main(["genotype", "-i", str(bam_paths[0]),
                         str(bam_paths[1]),
                         "-d", str(tmp_path / "db"),
                         "-p", str(tmp_path / "bg"),
                         "-o", str(tmp_path / "out"),
                         "-S", "anneal:i=8,a=8,n=2000,p=1000"]) == 0
    assert any("Indexed input" in r.message and "2 file(s)" in r.message
               for r in caplog.records), "multi-file fetch path not taken"
    _check_called(tmp_path, locus)


def test_preproc_indexed_cram(tmp_path, caplog):
    """preproc on a sorted+indexed CRAM fetches the bg region instead of
    scanning the whole input (preproc.rs:1180-1202)."""
    import logging

    from locityper_tpu import cli, sim
    from locityper_tpu.seq import fastx

    rng = np.random.default_rng(8)
    genome = sim.random_genome(rng, 60_000)
    with open(tmp_path / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    r = sim.simulate_paired_reads(rng, [genome, genome], depth=10.0,
                                  read_len=150, errors=err)
    flat = []
    for i, (c1, c2) in enumerate(zip(r.reads1, r.reads2)):
        pos = int(rng.integers(0, genome.size - 500))
        flat.append((pos, f"p{i}", FLAG_PAIRED | FLAG_READ1, c1))
        flat.append((pos + 250, f"p{i}", FLAG_PAIRED | FLAG_READ2, c2))
    flat.sort(key=lambda t: t[0])
    cram_path = tmp_path / "s.cram"
    with CramWriter(cram_path, ["chr1"], [genome.size],
                    reference={"chr1": genome}) as w:
        for pos, name, flag, c in flat:
            w.write(name, flag, c, ref_id=0, pos=pos)
    crai.build_crai(cram_path)

    with caplog.at_level(logging.INFO, logger="locityper"):
        rc = cli.main(["preproc", "-i", str(cram_path),
                       "-r", str(tmp_path / "ref.fa"),
                       "-o", str(tmp_path / "bg"),
                       "-b", "chr1:5001-55000"])
    assert rc == 0
    assert any("Indexed input" in r.message for r in caplog.records)
