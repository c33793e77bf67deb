"""BAM IO: BGZF round-trip, record parsing, orientation restore, pair
matching, and the genotype CLI on BAM input (reference fastx.rs:586-887)."""
import numpy as np
import pytest

from locityper_tpu.seq import bam, dna, fastx


def _random_codes(rng, n):
    return rng.integers(0, 4, n).astype(np.int8)


def test_roundtrip_single(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "reads.bam"
    recs = [(f"r{i:04d}", _random_codes(rng, int(rng.integers(50, 200))))
            for i in range(500)]
    with bam.BamWriter(path, ["chr1"], [10000]) as w:
        for name, codes in recs:
            w.write(name, 0, codes,
                    qual=np.full(codes.size, 30, np.uint8))
    got = list(bam.read_bam(path))
    assert len(got) == 500
    for (name, codes), r in zip(recs, got):
        assert r.name == name
        assert np.array_equal(r.seq, codes)
        assert (r.qual == 30).all()


def test_reverse_flag_restores_orientation(tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / "rev.bam"
    codes = _random_codes(rng, 100)
    with bam.BamWriter(path, [], []) as w:
        # Stored reverse-complemented with FLAG_REVERSE (as an aligner
        # would); the reader must restore the sequencing orientation.
        w.write("fwd", 0, codes)
        w.write("rev", bam.FLAG_REVERSE, dna.revcomp(codes))
    got = {r.name: r.seq for r in bam.read_bam(path)}
    assert np.array_equal(got["fwd"], codes)
    assert np.array_equal(got["rev"], codes)


def test_secondary_supplementary_skipped(tmp_path):
    rng = np.random.default_rng(2)
    path = tmp_path / "sec.bam"
    with bam.BamWriter(path, [], []) as w:
        w.write("a", 0, _random_codes(rng, 60))
        w.write("a", bam.FLAG_SECONDARY, _random_codes(rng, 60))
        w.write("a", bam.FLAG_SUPPLEMENTARY, _random_codes(rng, 60))
        w.write("b", 0, _random_codes(rng, 60))
    assert [r.name for r in bam.read_bam(path)] == ["a", "b"]


def test_pair_matching(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "pairs.bam"
    pairs = {}
    with bam.BamWriter(path, [], []) as w:
        order = []
        for i in range(200):
            n = f"p{i:03d}"
            c1, c2 = _random_codes(rng, 100), _random_codes(rng, 100)
            pairs[n] = (c1, c2)
            order.append((n, 0, c1))
            order.append((n, 1, c2))
        # Shuffle record order: mates arrive far apart, like a sorted BAM.
        rng.shuffle(order)
        for n, mate, c in order:
            flag = bam.FLAG_PAIRED | (bam.FLAG_MATE1 if mate == 0
                                      else bam.FLAG_MATE2)
            w.write(n, flag, c)
    seen = 0
    for r1, r2 in bam.read_bam_pairs(path):
        c1, c2 = pairs[r1.name]
        assert np.array_equal(r1.seq, c1)
        assert np.array_equal(r2.seq, c2)
        seen += 1
    assert seen == 200
    assert bam.is_paired_bam(path)


def test_read_fastx_auto_dispatch(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "d.bam"
    with bam.BamWriter(path, [], []) as w:
        w.write("x", 0, _random_codes(rng, 80))
    got = list(fastx.read_fastx_auto(path))
    assert len(got) == 1 and got[0].name == "x"


def test_cram_truncated_rejected(tmp_path):
    p = tmp_path / "x.cram"
    p.write_bytes(b"CRAM")
    with pytest.raises(ValueError, match="CRAM"):
        list(bam.read_bam(p))


def test_bad_magic(tmp_path):
    import gzip
    p = tmp_path / "x.bam"
    with gzip.open(p, "wb") as f:
        f.write(b"NOTBAM")
    with pytest.raises(ValueError, match="magic"):
        list(bam.read_bam(p))


def test_genotype_cli_on_bam(tmp_path):
    """Full pipeline parity: FASTQ world converted to one paired BAM must
    produce the same genotype call."""
    from locityper_tpu import cli, sim
    from locityper_tpu.utils.io import smart_create

    rng = np.random.default_rng(77)
    locus = sim.simulate_locus(rng, "G1", length=3000, n_haps=4,
                               divergence=0.02)
    left = sim.random_genome(rng, 60_000)
    right = sim.random_genome(rng, 60_000)
    genome = np.concatenate([left, locus.haplotypes[0], right])
    root = tmp_path
    with open(root / "ref.fa", "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    (root / "loci.bed").write_text(
        f"chr1\t{left.size}\t{left.size + locus.haplotypes[0].size}\tG1\n")
    with open(root / "haps_G1.fa", "w") as f:
        for name, seq in zip(locus.hap_names, locus.haplotypes):
            fastx.write_fasta(f, name, seq)
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    lr = sim.simulate_paired_reads(rng, true_haps, depth=12.0, errors=err,
                                   prefix="loc")
    bgr = sim.simulate_paired_reads(rng, [genome], depth=4.0, errors=err,
                                    prefix="bg")
    all1 = lr.reads1 + bgr.reads1
    all2 = lr.reads2 + bgr.reads2
    names = lr.names + bgr.names
    bam_path = root / "sample.bam"
    with bam.BamWriter(bam_path, [], []) as w:
        for nm, c1, c2 in zip(names, all1, all2):
            w.write(nm, bam.FLAG_PAIRED | bam.FLAG_MATE1, c1)
            w.write(nm, bam.FLAG_PAIRED | bam.FLAG_MATE2, c2)

    assert cli.main(["add", "-d", str(root / "db"), "-r", str(root / "ref.fa"),
                     "-l", str(root / "loci.bed"),
                     "-s", str(root / "haps_{}.fa")]) == 0
    assert cli.main(["preproc", "-i", str(bam_path), "-r", str(root / "ref.fa"),
                     "-o", str(root / "sample"), "-b", "chr1:5000-115000",
                     "--max-reads", "6000"]) == 0
    assert cli.main(["genotype", "-i", str(bam_path), "-d", str(root / "db"),
                     "-p", str(root / "sample"), "-o", str(root / "out"),
                     "-S", "greedy:i=5k,a=1", "anneal:i=4,a=4,n=1000,p=500",
                     "--seed", "2"]) == 0
    import gzip as gz
    import json
    res = json.load(gz.open(root / "out" / "loci" / "G1" / "res.json.gz",
                            "rt"))
    called = tuple(sorted(res["genotype"].split(",")))
    truth = tuple(sorted(locus.hap_names[i] for i in locus.true_genotype))
    assert called == truth


def test_assignment_bam_matches_sam(tmp_path):
    """model/sam.py write_sam with a .bam path writes real BGZF BAM whose
    records (name/flag/pos/mapq/CIGAR/seq/tags) match the SAM.gz twin
    (the reference's model/bam.rs emits BAM)."""
    import gzip
    import struct

    import jax

    from locityper_tpu import sim
    from locityper_tpu.bg.err_prof import EditDistCache, EditThresh
    from locityper_tpu.model import Params
    from locityper_tpu.model.locs import build_all_alignments
    from locityper_tpu.pipeline import LocusData, genotype_locus
    from locityper_tpu.seq import bam as bamio
    from locityper_tpu.seq.contigs import ContigSet
    from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
    from locityper_tpu.solvers.solve import Scheme

    import sys
    from pathlib import Path as _P
    sys.path.insert(0, str(_P(__file__).parent))
    from test_pipeline import make_bg, make_locus

    rng, locus, data = make_locus(seed=4, n_haps=4)
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    reads = sim.simulate_paired_reads(rng, true_haps, depth=10.0, errors=err)
    pairs = list(zip(reads.reads1, reads.reads2))[:150]
    names = reads.names[:150]
    bg = make_bg()
    params = Params(unmapped_penalty=bg.seq_info.technology
                    .default_unmapped_penalty(), out_sams=1)
    params.set_tweak_size(bg.depth.window_size)
    params.band = 48
    scheme = Scheme.parse(["anneal:i=6,a=6,n=1500,p=800"])

    # SAM.gz run, then BAM run with identical seed/scheme.
    res_s, _ = genotype_locus(data, pairs, names, bg, params=params,
                              scheme=scheme, seed=9,
                              sam_dir=tmp_path / "sams")
    params.out_sams = 0
    params.out_bams = 1
    res_b, _ = genotype_locus(data, pairs, names, bg, params=params,
                              scheme=scheme, seed=9,
                              sam_dir=tmp_path / "bams")
    assert [tuple(g) for g in res_s.genotypes[:1]] == \
        [tuple(g) for g in res_b.genotypes[:1]]

    sam_lines = [l.split("\t") for l in
                 gzip.open(tmp_path / "sams" / "00.sam.gz", "rt")
                 if not l.startswith("@")]
    bam_recs = list(bamio.read_bam_records(tmp_path / "bams" / "00.bam",
                                           keep_flags=0))
    assert len(sam_lines) == len(bam_recs) > 50
    hap_names = data.contig_set.contigs.names
    for sl, br in zip(sam_lines, bam_recs):
        assert sl[0] == br.name
        assert int(sl[1]) == br.flag
        if br.ref_id >= 0:
            assert sl[2] == hap_names[list(sorted(set(
                res_b.genotypes[0])))[br.ref_id]]
            assert int(sl[3]) == br.pos + 1
        assert int(sl[4]) == br.mapq
        cig = "".join(f"{l}{o}" for o, l in br.cigar) if br.cigar else "*"
        assert sl[5] == cig
        if sl[9] != "*":
            from locityper_tpu.seq import dna
            assert dna.decode(br.seq if not (br.flag & 0x10)
                              else dna.revcomp(br.seq)) == sl[9]
        # float tags round-trip
        assert br.tags is not None and br.tags[:2] == b"XF"
        (xf,) = struct.unpack_from("<f", br.tags, 3)
        assert abs(xf - float(sl[11].split(":")[2])) < 2e-3
