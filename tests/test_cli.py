"""Full CLI drive: add → preproc → genotype on simulated files, plus
recruit/align/prune/paf-vcf smoke coverage."""
import gzip
import json

import numpy as np
import pytest

from locityper_tpu import cli, sim
from locityper_tpu.seq import dna, fastx
from locityper_tpu.utils.io import smart_create


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Simulated reference genome with an embedded locus, haplotype panel,
    and a WGS sample from the true genotype + background."""
    root = tmp_path_factory.mktemp("cliworld")
    rng = np.random.default_rng(123)
    locus = sim.simulate_locus(rng, "GENE1", length=4000, n_haps=5,
                               divergence=0.015)
    left = sim.random_genome(rng, 120_000)
    right = sim.random_genome(rng, 120_000)
    genome = np.concatenate([left, locus.haplotypes[0], right])
    locus_start, locus_end = left.size, left.size + locus.haplotypes[0].size

    ref_fa = root / "ref.fa"
    with open(ref_fa, "w") as f:
        fastx.write_fasta(f, "chr1", genome)
    bed = root / "loci.bed"
    bed.write_text(f"chr1\t{locus_start}\t{locus_end}\tGENE1\n")
    haps_fa = root / "haps_GENE1.fa"
    with open(haps_fa, "w") as f:
        for name, seq in zip(locus.hap_names, locus.haplotypes):
            fastx.write_fasta(f, name, seq)

    # Sample: reads from the true genotype haplotypes + genome background.
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    err = sim.ErrorModel(0.002, 0.0002, 0.0002)
    locus_reads = sim.simulate_paired_reads(rng, true_haps, depth=15.0,
                                            errors=err, prefix="loc")
    bg_reads = sim.simulate_paired_reads(rng, [genome], depth=4.0,
                                         errors=err, prefix="bg")
    r1 = root / "reads_1.fq.gz"
    r2 = root / "reads_2.fq.gz"
    order = rng.permutation(len(locus_reads.reads1) + len(bg_reads.reads1))
    all1 = locus_reads.reads1 + bg_reads.reads1
    all2 = locus_reads.reads2 + bg_reads.reads2
    names = locus_reads.names + bg_reads.names
    with smart_create(r1) as f1, smart_create(r2) as f2:
        for i in order:
            fastx.write_fastq(f1, fastx.Read(names[i], all1[i]))
            fastx.write_fastq(f2, fastx.Read(names[i], all2[i]))
    return dict(root=root, locus=locus, ref_fa=ref_fa, bed=bed,
                haps_fa=haps_fa, r1=r1, r2=r2,
                n_locus_reads=len(locus_reads.reads1))


@pytest.fixture(scope="module")
def db(world):
    dbdir = world["root"] / "db"
    rc = cli.main(["add", "-d", str(dbdir), "-r", str(world["ref_fa"]),
                   "-l", str(world["bed"]),
                   "-s", str(world["root"] / "haps_{}.fa")])
    assert rc == 0
    return dbdir


@pytest.fixture(scope="module")
def prep(world):
    out = world["root"] / "sample"
    rc = cli.main(["preproc", "-i", str(world["r1"]), str(world["r2"]),
                   "-r", str(world["ref_fa"]), "-o", str(out),
                   "-b", "chr1:10000-110000", "--max-reads", "8000"])
    assert rc == 0
    return out


class TestAdd:
    def test_db_layout(self, db):
        ldir = db / "loci" / "GENE1"
        assert (ldir / "haplotypes.fa.gz").exists()
        assert (ldir / "kmers.npz").exists()
        assert (ldir / "distances.npz").exists()
        assert (ldir / "success").exists()
        div = np.load(ldir / "distances.npz")["div"]
        assert div.shape[0] == div.shape[1] >= 4
        assert (div >= 0).all() and np.allclose(div, div.T)

    def test_offtarget_counts_unique(self, db):
        from locityper_tpu.seq.counts import KmerCounts
        kc = KmerCounts.load_npz(db / "loci" / "GENE1" / "kmers.npz")
        # Haplotype 0 == embedded reference: fully unique to the locus.
        assert float(np.mean(kc.counts[0] == 0)) > 0.95


class TestPreproc:
    def test_distr_written(self, prep):
        from locityper_tpu.bg import BgDistr
        bg = BgDistr.load(prep / "bg" / "distr.json.gz")
        assert bg.insert_distr.is_paired_end
        # Simulated insert: N(400, 60^2).
        assert bg.insert_distr.distr.mean() == pytest.approx(400, rel=0.1)
        assert np.exp(bg.err_prof.ln_mismatch) == pytest.approx(0.002, rel=0.5)
        # Depth: 4x over genome, haploid first-mate per 100bp window:
        # 4 * 100 / (2*150) / 2 = 0.67
        m = bg.depth.depth_distribution(45).mean()
        assert 0.4 < m < 1.0


class TestGenotype:
    def test_true_genotype_called(self, world, db, prep):
        out = world["root"] / "out"
        rc = cli.main([
            "genotype", "-i", str(world["r1"]), str(world["r2"]),
            "-d", str(db), "-p", str(prep), "-o", str(out),
            "-S", "greedy:i=5k,a=1", "anneal:i=8,a=8,n=3000,p=2000",
            "--seed", "5"])
        assert rc == 0
        res_path = out / "loci" / "GENE1" / "res.json.gz"
        assert res_path.exists()
        with gzip.open(res_path, "rt") as f:
            res = json.load(f)
        locus = world["locus"]
        truth = ",".join(locus.hap_names[i] for i in locus.true_genotype)
        called = ",".join(sorted(res["genotype"].split(",")))
        truth = ",".join(sorted(truth.split(",")))
        assert called == truth, res
        assert res["quality"] > 10
        assert (out / "loci" / "GENE1" / "success").exists()


class TestRecruitCmd:
    def test_standalone(self, world, tmp_path):
        out = tmp_path / "recruited.fq"
        rc = cli.main(["recruit", "-i", str(world["r1"]), str(world["r2"]),
                       "-s", str(world["haps_fa"]), "-o", str(out)])
        assert rc == 0
        n = sum(1 for _ in fastx.read_fastq(out))
        # Should recruit ~ all locus pairs (2 reads per pair), few bg reads.
        assert n > 1.5 * world["n_locus_reads"]
        assert n < 2.6 * world["n_locus_reads"]


class TestAlignCmd:
    def test_paf_output(self, world, tmp_path):
        out = tmp_path / "haps.paf"
        # Pairwise-mutated haps are ~3% divergent -> minimizer Jaccard ~0.6,
        # above the reference's 0.5 pre-filter; disable the gate to force
        # all 10 pairs.
        rc = cli.main(["align", "-i", str(world["haps_fa"]), "-o", str(out),
                       "--max-div", "1.0"])
        assert rc == 0
        rows = [l.split("\t") for l in open(out).read().splitlines()]
        assert len(rows) == 10  # 5 choose 2
        for r in rows:
            assert int(r[9]) > 3000  # matches: haps are 98.5% identical
            cg = [t for t in r[12:] if t.startswith("cg:Z:")]
            assert cg, "PAF rows must carry extended CIGARs"
            # CIGAR consumes exactly the query and target intervals.
            import re
            q_span = t_span = 0
            for ln, op in re.findall(r"(\d+)([=XID])", cg[0][5:]):
                if op in "=XI":
                    q_span += int(ln)
                if op in "=XD":
                    t_span += int(ln)
            assert q_span == int(r[3]) - int(r[2])
            assert t_span == int(r[8]) - int(r[7])

    def test_paf_vcf_roundtrip(self, world, tmp_path):
        """Our own align output feeds our own paf-vcf (dist.rs -> paf_vcf.rs
        chain parity)."""
        paf = tmp_path / "haps.paf"
        rc = cli.main(["align", "-i", str(world["haps_fa"]), "-o", str(paf),
                       "--max-div", "1.0"])
        assert rc == 0
        vcf = tmp_path / "haps.vcf"
        rc = cli.main(["paf-vcf", "-i", str(paf), "-q", str(world["haps_fa"]),
                       "-t", str(world["haps_fa"]), "-o", str(vcf)])
        assert rc == 0
        recs = [l for l in open(vcf).read().splitlines()
                if l and not l.startswith("#")]
        # ~1.5%-mutated 4kb haps, 10 pairs: plenty of SNVs recovered.
        assert len(recs) > 100


class TestPruneCmd:
    def test_prune(self, world, db, tmp_path):
        import shutil
        db2 = tmp_path / "db2"
        shutil.copytree(db, db2)
        rc = cli.main(["prune", "-d", str(db2), "-n", "2"])
        assert rc == 0
        n = sum(1 for _ in fastx.read_fastx_auto(
            db2 / "loci" / "GENE1" / "haplotypes.fa.gz"))
        assert n == 2


class TestPafVcf:
    def test_conversion(self, tmp_path):
        # Hand-built example: query differs from target by 1 SNV and 1 del.
        t = "ACGTACGTACGTACGTACGT"
        q = t[:5] + "T" + t[6:10] + t[12:]       # SNV at pos 5, del of 10..12
        ref_fa = tmp_path / "t.fa"
        q_fa = tmp_path / "q.fa"
        with open(ref_fa, "w") as f:
            fastx.write_fasta(f, "T", dna.encode(t))
        with open(q_fa, "w") as f:
            fastx.write_fasta(f, "Q", dna.encode(q))
        paf = tmp_path / "x.paf"
        cg = "5=1X4=2D8="
        paf.write_text(f"Q\t{len(q)}\t0\t{len(q)}\t+\tT\t{len(t)}\t0\t{len(t)}"
                       f"\t17\t20\t60\tcg:Z:{cg}\n")
        out = tmp_path / "out.vcf"
        rc = cli.main(["paf-vcf", "-i", str(paf), "-q", str(q_fa),
                       "-t", str(ref_fa), "-o", str(out)])
        assert rc == 0
        lines = [l for l in open(out) if not l.startswith("#")]
        assert len(lines) == 2
        snv = lines[0].split("\t")
        assert snv[1] == "6" and snv[3] == "C" and snv[4] == "T"
        dele = lines[1].split("\t")
        assert dele[1] == "10" and len(dele[3]) == 3 and len(dele[4]) == 1


class TestOutSams:
    def test_sam_written(self, world, db, prep, tmp_path):
        out = tmp_path / "outsam"
        rc = cli.main([
            "genotype", "-i", str(world["r1"]), str(world["r2"]),
            "-d", str(db), "-p", str(prep), "-o", str(out),
            "-S", "greedy:i=5k,a=1", "anneal:i=4,a=4,n=1000,p=500",
            "--out-sams", "1", "--seed", "5"])
        assert rc == 0
        sam = out / "loci" / "GENE1" / "alns" / "00.sam.gz"
        assert sam.exists()
        import gzip as _gz
        lines = _gz.open(sam, "rt").read().splitlines()
        assert lines[0].startswith("@HD")
        body = [l for l in lines if not l.startswith("@")]
        assert len(body) > 100
        mapped = [l for l in body if int(l.split("\t")[1]) & 4 == 0]
        assert len(mapped) / len(body) > 0.8
        # CIGAR validity: =/X runs must exactly match the haplotype FASTA.
        import re
        from locityper_tpu.seq import dna as _dna
        seqs = {r.name: r.seq
                for r in fastx.read_fastx_auto(world["haps_fa"])}
        n_checked = 0
        for l in mapped:
            fl = l.split("\t")
            if fl[5] == "*":
                continue
            q = _dna.encode(fl[9])
            ref = seqs[fl[2]]
            qi, tp = 0, int(fl[3]) - 1
            spans = re.findall(r"(\d+)([=XIDS])", fl[5])
            assert sum(int(x) for x, o in spans if o in "=XIS") == len(fl[9])
            for x, op in spans:
                x = int(x)
                if op == "=":
                    assert (q[qi:qi + x] == ref[tp:tp + x]).all(), fl[:6]
                    qi += x
                    tp += x
                elif op == "X":
                    assert (q[qi:qi + x] != ref[tp:tp + x]).all(), fl[:6]
                    qi += x
                    tp += x
                elif op in "IS":
                    qi += x
                else:
                    tp += x
            n_checked += 1
        assert n_checked > 50


class TestPreprocLike:
    def test_like_rescales_depth(self, world, prep, tmp_path):
        from locityper_tpu.bg import BgDistr
        out = tmp_path / "sample2"
        rc = cli.main(["preproc", "-i", str(world["r1"]), str(world["r2"]),
                       "-r", str(world["ref_fa"]), "-o", str(out),
                       "--like", str(prep)])
        assert rc == 0
        bg0 = BgDistr.load(prep / "bg" / "distr.json.gz")
        bg1 = BgDistr.load(out / "bg" / "distr.json.gz")
        # Same input -> ratio 1.0 -> identical depth.
        m0 = bg0.depth.depth_distribution(45).mean()
        m1 = bg1.depth.depth_distribution(45).mean()
        assert m1 == pytest.approx(m0, rel=1e-6)


class TestFastBatches:
    def test_matches_python_reader(self, world):
        from locityper_tpu.seq.fastx import fast_paired_batches, read_pairs
        got = []
        for names, m1, l1, m2, l2, count in fast_paired_batches(
                world["r1"], world["r2"], batch=256, max_len=192):
            for i in range(count):
                got.append((names[i], m1[i, :l1[i]].copy(), m2[i, :l2[i]].copy()))
        want = [(a.name, a.seq, b.seq)
                for a, b in read_pairs(world["r1"], world["r2"])]
        assert len(got) == len(want)
        for (gn, g1, g2), (wn, w1, w2) in zip(got[:200], want[:200]):
            assert gn == wn
            assert np.array_equal(g1, w1)
            assert np.array_equal(g2, w2)


class TestPreprocExtras:
    def test_describe(self, world, prep, capsys):
        rc = cli.main(["preproc", "-i", "x", "-r", "x", "-o", str(prep),
                       "--describe"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "technology: illumina" in out
        assert "insert size:" in out
        assert "read depth" in out

    def test_genome_version_defaults(self):
        from locityper_tpu.commands.preproc import select_bg_region
        from locityper_tpu.seq.contigs import guess_genome_version

        class FakeSeq:
            def __init__(self, size):
                self.size = size

        g38 = {"chr1": FakeSeq(248_956_422), "chr17": FakeSeq(83_257_441)}
        assert guess_genome_version(g38) == "GRCh38"
        chrom, start, end = select_bg_region(g38, None)
        assert (chrom, start, end) == ("chr17", 72_062_000, 76_562_000)
        # GRCh37 with numeric contig names (no 'chr' prefix).
        g37 = {"1": FakeSeq(249_250_621), "17": FakeSeq(81_195_210)}
        assert guess_genome_version(g37) == "GRCh37"
        chrom, start, end = select_bg_region(g37, None)
        assert (chrom, start, end) == ("17", 70_060_000, 74_560_000)
        # Recognized build but truncated chr17 -> actionable error.
        bad = {"chr1": FakeSeq(248_387_328), "chr17": FakeSeq(1000)}
        with pytest.raises(ValueError, match="provide -b"):
            select_bg_region(bad, None)

    def test_clean_cli_error(self, world, db, prep, tmp_path, caplog):
        rc = cli.main(["genotype", "-i", str(tmp_path / "x.cram"),
                       "-d", str(db), "-p", str(prep),
                       "-o", str(tmp_path / "o")])
        assert rc == 1
        assert any("x.cram" in r.message for r in caplog.records)


class TestRegWeights:
    def test_explicit_weights_unit(self):
        from locityper_tpu.model.windows import ExplicitWeights
        ew = ExplicitWeights({"h1": [(100, 200, 0.25), (150, 300, 0.5)]})
        w = ew.per_bp("h1", 400)
        assert w[50] == 1.0
        assert w[120] == 0.25
        assert w[180] == 0.125          # overlap multiplies
        assert w[250] == 0.5
        assert w[350] == 1.0
        assert (ew.per_bp("other", 10) == 1.0).all()

    def test_weights_change_window_weights(self, world, prep):
        from locityper_tpu.bg import BgDistr
        from locityper_tpu.model import Params
        from locityper_tpu.model.windows import (ExplicitWeights,
                                                 build_contig_infos)
        from locityper_tpu.seq.contigs import ContigSet
        from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts

        locus = world["locus"]
        cs = ContigSet("GENE1", locus.hap_names, locus.haplotypes)
        counter = GenomeKmerCounter(25)
        counter.add_seq(locus.haplotypes[0])
        counter.finalize()
        kc = off_target_counts(counter, locus.haplotypes,
                               locus.haplotypes[0])
        bg = BgDistr.load(prep / "bg" / "distr.json.gz")
        params = Params()
        base = build_contig_infos(cs, kc, bg.depth.window_size,
                                  bg.depth.neighb_size, params)
        ew = ExplicitWeights({locus.hap_names[0]: [(500, 1500, 0.1)]})
        mod = build_contig_infos(cs, kc, bg.depth.window_size,
                                 bg.depth.neighb_size, params, explicit=ew)
        # Hap 0 weights drop inside the interval, untouched outside.
        assert mod[0].weight_at[1000] < 0.2 * base[0].weight_at[1000]
        assert mod[0].weight_at[3000] == pytest.approx(
            base[0].weight_at[3000])
        # Other haplotypes unchanged.
        assert np.allclose(mod[1].weight_at, base[1].weight_at)

    def test_cli_reg_weights(self, world, db, prep, tmp_path):
        locus = world["locus"]
        bed = tmp_path / "w.bed"
        bed.write_text(f"{locus.hap_names[0]}\t0\t4000\t0.9\n")
        mapping = tmp_path / "weights.tsv"
        mapping.write_text(f"GENE1\t{bed.name}\n")
        out = tmp_path / "outw"
        rc = cli.main([
            "genotype", "-i", str(world["r1"]), str(world["r2"]),
            "-d", str(db), "-p", str(prep), "-o", str(out),
            "-S", "greedy:i=5k,a=1", "anneal:i=4,a=4,n=1000,p=500",
            "--reg-weights", str(mapping), "--seed", "5"])
        assert rc == 0
        assert (out / "loci" / "GENE1" / "res.json.gz").exists()

    def test_cli_reg_weights_missing_file(self, world, db, prep, tmp_path):
        mapping = tmp_path / "weights.tsv"
        mapping.write_text("GENE1\tnope.bed\n")
        rc = cli.main([
            "genotype", "-i", str(world["r1"]), str(world["r2"]),
            "-d", str(db), "-p", str(prep), "-o", str(tmp_path / "o"),
            "--reg-weights", str(mapping)])
        assert rc == 1


class TestStopAfterMap:
    def test_aln_sam_written(self, world, db, prep, tmp_path):
        out = tmp_path / "outmap"
        rc = cli.main([
            "genotype", "-i", str(world["r1"]), str(world["r2"]),
            "-d", str(db), "-p", str(prep), "-o", str(out),
            "--stop-after", "map"])
        assert rc == 0
        sam = out / "loci" / "GENE1" / "aln.sam.gz"
        assert sam.exists()
        import gzip as _gz
        lines = _gz.open(sam, "rt").read().splitlines()
        sq = [l for l in lines if l.startswith("@SQ")]
        assert len(sq) == 5                      # all haplotypes present
        body = [l.split("\t") for l in lines if not l.startswith("@")]
        assert len(body) > 500
        # Multiple haplotype candidates per read; secondaries flagged.
        by_read = {}
        for f in body:
            by_read.setdefault(f[0], set()).add(f[2])
        assert max(len(v) for v in by_read.values()) >= 3
        assert any(int(f[1]) & 0x100 for f in body)
        assert all(f[5] != "*" for f in body)    # every record has a CIGAR
        # No res.json.gz: solving was skipped.
        assert not (out / "loci" / "GENE1" / "res.json.gz").exists()


class TestGenotypeKnobs:
    def test_leave_out_and_knobs(self, world, db, prep, tmp_path):
        out = tmp_path / "outlo"
        locus = world["locus"]
        lo = [locus.hap_names[i] for i in range(5)
              if i not in locus.true_genotype][:2]
        rc = cli.main([
            "genotype", "-i", str(world["r1"]), str(world["r2"]),
            "-d", str(db), "-p", str(prep), "-o", str(out),
            "-S", "greedy:i=5k,a=1", "anneal:i=4,a=4,n=1000,p=500",
            "--leave-out", *lo, "--skew", "0.8", "-D", "2.5",
            "--seed", "5"])
        assert rc == 0
        import gzip as _gz
        import json as _json
        res = _json.load(_gz.open(out / "loci" / "GENE1" / "res.json.gz",
                                  "rt"))
        called = set(res["genotype"].split(","))
        assert not (called & set(lo))            # left-out haps never called
        truth = {locus.hap_names[i] for i in locus.true_genotype}
        assert called == truth

    def test_leave_out_all_errors(self, world, db, prep, tmp_path):
        locus = world["locus"]
        rc = cli.main([
            "genotype", "-i", str(world["r1"]), str(world["r2"]),
            "-d", str(db), "-p", str(prep), "-o", str(tmp_path / "o"),
            "--leave-out", *locus.hap_names])
        assert rc == 1

    def test_in_list(self, world, db, prep, tmp_path):
        lst = tmp_path / "inputs.txt"
        lst.write_text(f"{world['r1']}\n{world['r2']}\n")
        out = tmp_path / "outil"
        rc = cli.main([
            "genotype", "-I", str(lst), "-d", str(db), "-p", str(prep),
            "-o", str(out), "-S", "greedy:i=5k,a=1",
            "anneal:i=4,a=4,n=1000,p=500", "--seed", "5"])
        assert rc == 0
        assert (out / "loci" / "GENE1" / "res.json.gz").exists()


class TestRecruitPreset:
    def test_preset(self, world, tmp_path):
        out = tmp_path / "rp.fq"
        rc = cli.main(["recruit", "-i", str(world["r1"]), str(world["r2"]),
                       "-s", str(world["haps_fa"]), "-o", str(out),
                       "-x", "illumina"])
        assert rc == 0
        assert sum(1 for _ in fastx.read_fastq(out)) > 100

    def test_bad_preset(self, tmp_path):
        rc = cli.main(["recruit", "-i", "x", "-s", "y", "-o", "z",
                       "-x", "bogus"])
        assert rc == 1


class TestRecruitCheckpoint:
    """Kill-and-rerun: a crash after recruitment resumes from reads.fq.gz
    without re-scanning the input (genotype.rs:662-682, 1153-1156)."""

    def test_crash_resume(self, world, db, prep, tmp_path, monkeypatch):
        from locityper_tpu.commands import genotype as G
        out = tmp_path / "ckpt"
        base = ["genotype", "-i", str(world["r1"]), str(world["r2"]),
                "-d", str(db), "-p", str(prep), "-o", str(out),
                "-S", "greedy:i=5k,a=1", "anneal:i=4,a=4,n=1000,p=500",
                "--seed", "5"]

        def boom(*a, **k):
            raise RuntimeError("simulated crash after recruitment")

        monkeypatch.setattr(G, "genotype_locus", boom)
        assert cli.main(base) == 1
        ldir = out / "loci" / "GENE1"
        ck = ldir / "reads.fq.gz"
        assert ck.exists() and not (ldir / "success").exists()
        pairs, names = G._load_recruited(ldir)
        assert len(pairs) == len(names) > 50
        assert all(c2 is not None for _, c2 in pairs)
        monkeypatch.undo()

        # Rerun must NOT recruit again — checkpoint feeds the solver.
        def no_recruit(*a, **k):
            raise AssertionError("recruitment ran despite checkpoint")

        monkeypatch.setattr(G, "recruit_reads_fast", no_recruit)
        monkeypatch.setattr(G, "recruit_reads", no_recruit)
        assert cli.main(base) == 0
        assert (ldir / "res.json.gz").exists()
        assert (ldir / "success").exists()
        assert not ck.exists()           # deleted once the locus completed
        with gzip.open(ldir / "res.json.gz", "rt") as f:
            res = json.load(f)
        locus = world["locus"]
        truth = {locus.hap_names[i] for i in locus.true_genotype}
        assert set(res["genotype"].split(",")) == truth


class TestParamsStaleness:
    def test_changed_params_abort(self, world, db, prep, tmp_path):
        out = tmp_path / "stale"
        base = ["genotype", "-i", str(world["r1"]), str(world["r2"]),
                "-d", str(db), "-p", str(prep), "-o", str(out),
                "-S", "greedy:i=5k,a=1", "anneal:i=4,a=4,n=1000,p=500",
                "--seed", "5"]
        assert cli.main(base) == 0
        # Same params: clean skip.
        assert cli.main(base) == 0
        # Changed knob: abort with guidance.
        assert cli.main(base + ["--skew", "0.7"]) == 1
        # --rerun all starts clean and adopts the new params.
        assert cli.main(base + ["--skew", "0.7", "--rerun", "all"]) == 0
        assert cli.main(base + ["--skew", "0.7"]) == 0


class TestMultihost:
    def test_shard_loci_single_process(self):
        from locityper_tpu.parallel.multihost import shard_loci
        assert shard_loci(["a", "b", "c"]) == ["a", "b", "c"]

    def test_shard_loci_partitions(self, monkeypatch):
        import jax
        from locityper_tpu.parallel import multihost as mh
        monkeypatch.setattr(jax, "process_count", lambda: 3)
        monkeypatch.setattr(jax, "process_index", lambda: 1)
        assert mh.shard_loci(list("abcdefg")) == ["b", "e"]

    def test_lpt_straggler_balance(self):
        """Strongly uneven per-locus costs (one HLA-class straggler among
        cheap loci): LPT keeps the max host load
        within the 4/3 bound of optimal, where round-robin can be ~n x
        worse."""
        from locityper_tpu.parallel.multihost import lpt_assign
        costs = [1000.0] + [10.0] * 15
        for n in (2, 4):
            bins = lpt_assign(costs, n)
            loads = [sum(c for c, b in zip(costs, bins) if b == j)
                     for j in range(n)]
            opt = max(max(costs), sum(costs) / n)
            assert max(loads) <= (4 / 3) * opt
            # The straggler's host gets few (or no) other loci.
            straggler_host = bins[0]
            assert sum(b == straggler_host for b in bins) <= 2
            # Every locus is assigned to exactly one valid host.
            assert len(bins) == len(costs)
            assert all(0 <= b < n for b in bins)

    def test_lpt_deterministic_and_rr_on_equal_costs(self, monkeypatch):
        import jax
        from locityper_tpu.parallel import multihost as mh
        assert mh.lpt_assign([5.0] * 6, 2) == [0, 1, 0, 1, 0, 1]
        assert mh.lpt_assign([3.0, 1.0, 2.0], 2) == mh.lpt_assign(
            [3.0, 1.0, 2.0], 2)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda: 0)
        got0 = mh.shard_loci(list("abcd"), costs=[9.0, 1.0, 1.0, 1.0])
        monkeypatch.setattr(jax, "process_index", lambda: 1)
        got1 = mh.shard_loci(list("abcd"), costs=[9.0, 1.0, 1.0, 1.0])
        assert sorted(got0 + got1) == list("abcd")
        assert got0 == ["a"] and got1 == ["b", "c", "d"]

    def test_locus_cost_estimate(self, tmp_path):
        import gzip as _gz
        from locityper_tpu.commands.genotype import _locus_cost_estimate
        d = tmp_path / "loci" / "L"
        d.mkdir(parents=True)
        with _gz.open(d / "haplotypes.fa.gz", "wt") as f:
            f.write(">h1\n" + "A" * 100 + "\n>h2\n" + "C" * 300 + "\n")
        cost = _locus_cost_estimate(tmp_path, "L")
        assert cost == pytest.approx(2 * 3 / 2 * 200)
        assert _locus_cost_estimate(tmp_path, "MISSING") == 1.0


def test_stop_after_map_writes_bam(world, db, prep, tmp_path):
    """--stop-after map also writes real BAM (genotype.rs:1023-1074 aln.bam)
    with the same records as the SAM.gz twin."""
    import gzip as _gz

    out = tmp_path / "outmapbam"
    rc = cli.main([
        "genotype", "-i", str(world["r1"]), str(world["r2"]),
        "-d", str(db), "-p", str(prep), "-o", str(out),
        "--stop-after", "map"])
    assert rc == 0
    bam_path = out / "loci" / "GENE1" / "aln.bam"
    assert bam_path.exists()
    from locityper_tpu.seq import bam as bamio
    recs = list(bamio.read_bam_records(bam_path, keep_flags=0))
    sam_lines = [l.split("\t") for l in
                 _gz.open(out / "loci" / "GENE1" / "aln.sam.gz", "rt")
                 if not l.startswith("@")]
    assert len(recs) == len(sam_lines) > 500
    for br, sl in zip(recs, sam_lines):
        assert br.name == sl[0] and br.flag == int(sl[1])
        cig = "".join(f"{l}{o}" for o, l in br.cigar) if br.cigar else "*"
        assert cig == sl[5]


class TestPreprocFlags:
    """Round-4 flag parity: -p/--ploidy, --subsample/--seed, --pval-thresh,
    -I in-lists and --file-size --like (preproc.rs:431-585)."""

    def test_ploidy_scales_haploid_depth(self, world, prep, tmp_path):
        from locityper_tpu.bg import BgDistr
        out = tmp_path / "p4"
        rc = cli.main(["preproc", "-i", str(world["r1"]), str(world["r2"]),
                       "-r", str(world["ref_fa"]), "-o", str(out),
                       "-b", "chr1:10000-110000", "--max-reads", "8000",
                       "--ploidy", "4"])
        assert rc == 0
        bg2 = BgDistr.load(out / "bg" / "distr.json.gz")
        bg1 = BgDistr.load(prep / "bg" / "distr.json.gz")
        # Same data, double the assumed ploidy -> half the haploid depth.
        r = bg2.depth.depth_distribution(45).mean() \
            / bg1.depth.depth_distribution(45).mean()
        assert r == pytest.approx(0.5, rel=0.05)

    def test_subsample_corrected_depth(self, world, prep, tmp_path):
        from locityper_tpu.bg import BgDistr
        out = tmp_path / "sub"
        rc = cli.main(["preproc", "-i", str(world["r1"]), str(world["r2"]),
                       "-r", str(world["ref_fa"]), "-o", str(out),
                       "-b", "chr1:10000-110000", "--max-reads", "8000",
                       "--subsample", "0.5", "--seed", "7"])
        assert rc == 0
        bg2 = BgDistr.load(out / "bg" / "distr.json.gz")
        bg1 = BgDistr.load(prep / "bg" / "distr.json.gz")
        # Depth must be subsampling-corrected back to the full rate.
        r = bg2.depth.depth_distribution(45).mean() \
            / bg1.depth.depth_distribution(45).mean()
        assert r == pytest.approx(1.0, rel=0.25)

    def test_in_list_inputs(self, world, tmp_path):
        lst = tmp_path / "inputs.txt"
        lst.write_text(f"{world['r1']}\n{world['r2']}\n")
        out = tmp_path / "fromlist"
        rc = cli.main(["preproc", "-I", str(lst),
                       "-r", str(world["ref_fa"]), "-o", str(out),
                       "-b", "chr1:10000-110000", "--max-reads", "4000"])
        assert rc == 0
        assert (out / "bg" / "distr.json.gz").exists()

    def test_like_file_size_forced(self, world, prep, tmp_path):
        from locityper_tpu.bg import BgDistr
        out = tmp_path / "likefs"
        rc = cli.main(["preproc", "-i", str(world["r1"]), str(world["r2"]),
                       "-r", str(world["ref_fa"]), "-o", str(out),
                       "--like", str(prep), "--file-size"])
        assert rc == 0
        bg2 = BgDistr.load(out / "bg" / "distr.json.gz")
        bg1 = BgDistr.load(prep / "bg" / "distr.json.gz")
        # Same files -> ratio 1.0 regardless of which measure was used.
        r = bg2.depth.depth_distribution(45).mean() \
            / bg1.depth.depth_distribution(45).mean()
        assert r == pytest.approx(1.0, rel=1e-6)


def test_tail_chunks_cover_exactly():
    """Dispatch plan: contiguous cover of [0, count), pow2 padded sizes
    >= 1024, over-half batches whole (commands/genotype.py:_tail_chunks)."""
    from locityper_tpu.commands.genotype import _tail_chunks
    for Bb in (1024, 16384, 32768):
        for count in (1, 5, 1023, Bb // 2, Bb // 2 + 1,
                      Bb - 1, Bb, 18831 if Bb > 18831 else 3):
            chunks = _tail_chunks(count, Bb)
            pos = 0
            slots = 0
            for st, take, bsz in chunks:
                assert st == pos
                assert 1 <= take <= bsz <= Bb
                assert bsz >= 1024 and (bsz & (bsz - 1)) == 0
                pos += take
                slots += bsz
            assert pos == count
            if count > Bb // 2:
                assert chunks == [(0, count, Bb)]
            else:
                # The split never wastes more than the 1024 floor.
                assert slots < count + 1024
