"""CRAM 3.0 reader/writer (seq/cram.py, the htslib-role owned decoder —
reference fastx.rs:586-887): varint and rANS codecs, writer→reader
round-trips including reference-based feature reconstruction, pairing, and
the genotype CLI on CRAM + mixed multi-file inputs."""
import numpy as np
import pytest

from locityper_tpu.seq import bam, cram, dna, fastx


def _codes(rng, n):
    return rng.integers(0, 4, n).astype(np.int8)


class TestVarints:
    def test_itf8_roundtrip(self):
        vals = [0, 1, 127, 128, 16383, 16384, (1 << 21) - 1, 1 << 21,
                (1 << 28) - 1, 1 << 28, (1 << 31) - 1, -1, -100, -(1 << 31)]
        blob = b"".join(cram.put_itf8(v) for v in vals)
        br = cram.ByteReader(blob)
        assert [br.itf8() for _ in vals] == vals

    def test_ltf8_roundtrip(self):
        vals = [0, 127, 128, 1 << 13, 1 << 20, 1 << 27, 1 << 34, 1 << 41,
                1 << 48, 1 << 55, (1 << 62)]
        blob = b"".join(cram.put_ltf8(v) for v in vals)
        br = cram.ByteReader(blob)
        assert [br.ltf8() for _ in vals] == vals


class TestRans:
    @pytest.mark.parametrize("seed,alpha", [(0, 4), (1, 8), (2, 256),
                                            (3, 1)])
    def test_order0_roundtrip(self, seed, alpha):
        rng = np.random.default_rng(seed)
        data = bytes(rng.integers(0, alpha, 4000, dtype=np.uint8))
        enc = cram.rans4x8_encode_0(data)
        assert cram.rans4x8_decode(enc) == data

    def test_consecutive_symbol_rle(self):
        # Exercises the RLE path of the frequency-table serialization.
        data = bytes(range(60)) * 50
        enc = cram.rans4x8_encode_0(data)
        assert cram.rans4x8_decode(enc) == data

    def test_short_input(self):
        for data in (b"A", b"AB", b"ABCD" * 2):
            assert cram.rans4x8_decode(cram.rans4x8_encode_0(data)) == data

    @pytest.mark.parametrize("seed,kind", [(0, "qual"), (1, "dna"),
                                           (2, "random"), (3, "tail")])
    def test_order1_roundtrip(self, seed, kind):
        """Order-1 decode (per-context tables, interleaved tail) against
        the order-1 encoder."""
        rng = np.random.default_rng(seed)
        if kind == "qual":
            data = bytes(rng.integers(33, 43, 8000, dtype=np.uint8))
        elif kind == "dna":
            data = b"ACGTACGTTTTGGG" * 300
        elif kind == "random":
            data = bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
        else:
            data = bytes(rng.integers(60, 80, 4099, dtype=np.uint8))
        enc = cram.rans4x8_encode_1(data)
        assert enc[0] == 1
        assert cram.rans4x8_decode(enc) == data


class TestRoundTrip:
    def _write_read(self, tmp_path, writer_fn, reference):
        path = tmp_path / "t.cram"
        w = cram.CramWriter(path, list(reference), [len(v) for v in
                                                    reference.values()],
                            reference=reference)
        writer_fn(w)
        w.close()
        return list(cram.read_cram_records(path, reference=reference))

    def test_unmapped_and_mapped(self, tmp_path):
        rng = np.random.default_rng(0)
        ref = _codes(rng, 1000)
        refs = {"chr1": ref}
        seq_u = _codes(rng, 80)
        qual_u = rng.integers(10, 40, 80).astype(np.uint8)
        seq_m = ref[100:190].copy()

        def wr(w):
            w.write("readU", cram.FLAG_UNMAPPED, seq_u, qual_u)
            w.write("readM", 0, seq_m, None, ref_id=0, pos=100, mapq=60)

        ru, rm = self._write_read(tmp_path, wr, refs)
        assert ru.name == "readU" and (ru.flag & cram.FLAG_UNMAPPED)
        np.testing.assert_array_equal(ru.seq, seq_u)
        np.testing.assert_array_equal(ru.qual, qual_u)
        assert rm.pos == 100 and rm.mapq == 60
        np.testing.assert_array_equal(rm.seq, seq_m)

    def test_features(self, tmp_path):
        """Substitution / insertion / deletion / softclip reconstruction
        against the reference slice (spec §10.6 features)."""
        rng = np.random.default_rng(1)
        ref = _codes(rng, 1000)
        refs = {"chr1": ref}
        seq_x = ref[200:290].copy()
        rbase = int(seq_x[10])
        sub = (rbase + 1) % 4
        seq_x[10] = sub
        alts = [x for x in range(5) if x != rbase]
        bscode = alts.index(sub)
        ins = np.array([0, 1, 2], np.int8)
        seq_id = np.concatenate([ref[300:320], ins, ref[325:360]])
        clip = np.array([3, 3, 3, 3], np.int8)
        seq_s = np.concatenate([clip, ref[500:550]])

        def wr(w):
            w.write("rX", 0, seq_x, None, ref_id=0, pos=200, mapq=55,
                    features=[("X", 10, bscode)])
            w.write("rID", 0, seq_id, None, ref_id=0, pos=300, mapq=50,
                    features=[("I", 20, ins), ("D", 23, 5)])
            w.write("rS", 0, seq_s, None, ref_id=0, pos=500, mapq=45,
                    features=[("S", 0, clip)])

        rx, rid_, rs = self._write_read(tmp_path, wr, refs)
        np.testing.assert_array_equal(rx.seq, seq_x)
        np.testing.assert_array_equal(rid_.seq, seq_id)
        np.testing.assert_array_equal(rs.seq, seq_s)

    def test_reverse_strand_restored(self, tmp_path):
        rng = np.random.default_rng(2)
        ref = _codes(rng, 600)
        refs = {"chr1": ref}
        stored = ref[400:460].copy()          # aligned orientation

        def wr(w):
            w.write("rR", cram.FLAG_REVERSE, stored, None, ref_id=0,
                    pos=400, mapq=40)

        (rr,) = self._write_read(tmp_path, wr, refs)
        np.testing.assert_array_equal(rr.seq, dna.revcomp(stored))

    def test_multi_ref_container(self, tmp_path):
        rng = np.random.default_rng(3)
        refs = {"c1": _codes(rng, 300), "c2": _codes(rng, 300)}

        def wr(w):
            w.write("a", 0, refs["c1"][10:80].copy(), None, ref_id=0,
                    pos=10, mapq=9)
            w.write("b", 0, refs["c2"][20:90].copy(), None, ref_id=1,
                    pos=20, mapq=9)

        ra, rb = self._write_read(tmp_path, wr, refs)
        np.testing.assert_array_equal(ra.seq, refs["c1"][10:80])
        np.testing.assert_array_equal(rb.seq, refs["c2"][20:90])
        assert (ra.ref_id, rb.ref_id) == (0, 1)

    def test_reference_required_error(self, tmp_path):
        rng = np.random.default_rng(4)
        ref = _codes(rng, 300)
        path = tmp_path / "rr.cram"
        with cram.CramWriter(path, ["chr1"], [300],
                             reference={"chr1": ref}) as w:
            w.write("m", 0, ref[5:60].copy(), None, ref_id=0, pos=5, mapq=1)
        with pytest.raises(ValueError, match="reference"):
            list(cram.read_cram_records(path))

    def test_many_records_multiple_containers(self, tmp_path):
        rng = np.random.default_rng(5)
        refs = {"chr1": _codes(rng, 100)}
        n = 5000                               # > one 4096-record container
        seqs = [_codes(rng, 70) for _ in range(n)]

        def wr(w):
            for i, s in enumerate(seqs):
                w.write(f"u{i}", cram.FLAG_UNMAPPED, s)

        recs = self._write_read(tmp_path, wr, refs)
        assert len(recs) == n
        for i in (0, 4095, 4096, n - 1):
            np.testing.assert_array_equal(recs[i].seq, seqs[i])


class TestBamLayerIntegration:
    def test_read_bam_pairs_on_cram(self, tmp_path):
        rng = np.random.default_rng(6)
        refs = {"chr1": _codes(rng, 100)}
        path = tmp_path / "p.cram"
        pairs = {}
        with cram.CramWriter(path, ["chr1"], [100], reference=refs) as w:
            for i in range(50):
                nm = f"p{i:02d}"
                c1, c2 = _codes(rng, 80), _codes(rng, 80)
                pairs[nm] = (c1, c2)
                w.write(nm, cram.FLAG_PAIRED | cram.FLAG_UNMAPPED
                        | cram.FLAG_MATE_UNMAPPED | cram.FLAG_READ1, c1)
                w.write(nm, cram.FLAG_PAIRED | cram.FLAG_UNMAPPED
                        | cram.FLAG_MATE_UNMAPPED | cram.FLAG_READ2, c2)
        seen = 0
        for r1, r2 in bam.read_bam_pairs(path):
            c1, c2 = pairs[r1.name]
            np.testing.assert_array_equal(r1.seq, c1)
            np.testing.assert_array_equal(r2.seq, c2)
            seen += 1
        assert seen == 50
        assert bam.is_paired_bam(path)

    def test_fastx_auto_dispatch(self, tmp_path):
        rng = np.random.default_rng(7)
        path = tmp_path / "d.cram"
        with cram.CramWriter(path, ["c"], [10]) as w:
            w.write("x", cram.FLAG_UNMAPPED, _codes(rng, 60))
        got = list(fastx.read_fastx_auto(path))
        assert len(got) == 1 and got[0].name == "x"


def test_genotype_read_iter_mixed_inputs(tmp_path):
    """-I in-lists freely mixing CRAM + multiple BAMs +
    FASTQ, every file an independent read set."""
    from locityper_tpu.commands.genotype import _read_iter

    rng = np.random.default_rng(8)
    # BAM 1 (paired), BAM 2 (single), CRAM (single unmapped), FASTQ.
    bam1 = tmp_path / "a.bam"
    with bam.BamWriter(bam1, [], []) as w:
        w.write("pa", bam.FLAG_PAIRED | bam.FLAG_MATE1, _codes(rng, 50))
        w.write("pa", bam.FLAG_PAIRED | bam.FLAG_MATE2, _codes(rng, 50))
    bam2 = tmp_path / "b.bam"
    with bam.BamWriter(bam2, [], []) as w:
        w.write("sb", 0, _codes(rng, 50))
    cr = tmp_path / "c.cram"
    with cram.CramWriter(cr, ["c"], [10]) as w:
        w.write("sc", cram.FLAG_UNMAPPED, _codes(rng, 50))
    fq = tmp_path / "d.fq"
    with open(fq, "w") as f:
        fastx.write_fastq(f, fastx.Read("sd", _codes(rng, 50)))

    got = list(_read_iter([str(bam1), str(bam2), str(cr), str(fq)], False))
    names = [g[0] for g in got]
    assert names == ["pa", "sb", "sc", "sd"]
    assert got[0][2] is not None               # pair kept mates
    assert all(g[2] is None for g in got[1:])
