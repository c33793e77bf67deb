"""Chained hap-hap alignment (seq/dist.py + native chain_align).

Parity model: the pure-Python fallback in seq/dist.py implements the same
algorithm as the native kernels (LCSk++ event sweep, smart gap fill, Gotoh
affine DP); these tests enforce bit-identical output between the two and
check the reference invariants (dist.rs:238-241 full coverage;
wfa.rs scoring model) plus a "done" criterion: full-length
PAFs for haplotype pairs containing multi-kb indels.
"""
import numpy as np
import pytest

from locityper_tpu import native
from locityper_tpu.seq.dist import (
    PairAligner, Penalties, _py_chain_align, _py_kmer_matches, cigar_stats,
    paf_row,
)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native kernels unavailable")


def mutate(rng, seq, snp_rate):
    out = seq.copy()
    hit = rng.random(out.size) < snp_rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


class TestNativePyParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_bit_identical(self, seed):
        rng = np.random.default_rng(seed)
        a = rng.integers(0, 4, 3000).astype(np.int8)
        b = mutate(rng, a, 0.02)
        # a small indel to exercise the gotoh branch
        b = np.concatenate([b[:1000], rng.integers(0, 4, 120).astype(np.int8),
                            b[1000:2500], b[2700:]])
        nat = PairAligner().align(a, b)
        py = PairAligner(use_native=False).align(a, b)
        assert nat[2] == py[2]
        assert np.array_equal(nat[0], py[0])
        assert np.array_equal(nat[1], py[1])

    def test_kmer_matches_parity(self):
        rng = np.random.default_rng(3)
        a = rng.integers(0, 4, 2000).astype(np.int8)
        b = mutate(rng, a, 0.05)
        a[100:110] = 4  # N run: windows covering it are skipped
        for k in (25, 51):
            fa = native.kmer_fp_sorted(np.ascontiguousarray(a), k)
            fb = native.kmer_fp_sorted(np.ascontiguousarray(b), k)
            n1, n2 = native.kmer_match_join(a, fa, b, fb, k)
            p1, p2 = _py_kmer_matches(a, b, k)
            assert np.array_equal(n1, p1)
            assert np.array_equal(n2, p2)


class TestScoring:
    """WFA-convention score checks (match 0 / mismatch -4 / gap -(6+len))."""

    def test_identical(self):
        a = np.arange(100, dtype=np.int8) % 4
        ops, lens, score = PairAligner().align(a, a)
        assert score == 0
        assert list(ops) == [0] and list(lens) == [100]

    def test_single_mismatch(self):
        rng = np.random.default_rng(4)
        a = rng.integers(0, 4, 400).astype(np.int8)
        b = a.copy()
        b[200] = (b[200] + 1) % 4
        ops, lens, score = PairAligner(ks=(25,)).align(a, b)
        assert score == -4
        m, e = cigar_stats(ops, lens)
        assert (m, e) == (399, 1)

    def test_clean_deletion(self):
        rng = np.random.default_rng(5)
        a = rng.integers(0, 4, 2000).astype(np.int8)
        b = np.concatenate([a[:900], a[1100:]])  # 200bp deletion from query
        ops, lens, score = PairAligner(ks=(25,)).align(a, b)
        assert score == -(6 + 200)
        assert int(lens[ops == 3].sum()) == 200
        assert int(lens[ops == 1].sum()) == 0


class TestStructuralVariants:
    """'Done' criterion: 1-10 kb indels stay in-band."""

    @pytest.mark.parametrize("del_len,ins_len", [(1000, 0), (0, 2500),
                                                 (10000, 1500)])
    def test_multikb_indels(self, del_len, ins_len):
        rng = np.random.default_rng(del_len + ins_len)
        a = rng.integers(0, 4, 30000).astype(np.int8)
        b = mutate(rng, a, 0.01)
        # Deletion around 20000, insertion at 8000 (kept apart so the two
        # SVs cannot merge into one gap + mismatch run).
        parts = [b[:8000]]
        if ins_len:
            parts.append(rng.integers(0, 4, ins_len).astype(np.int8))
        parts.append(b[8000:20000 - del_len // 2])
        parts.append(b[20000 + (del_len + 1) // 2:])
        b = np.concatenate(parts)
        ops, lens, score = PairAligner().align(a, b)
        n_del = int(lens[ops == 3].sum())
        n_ins = int(lens[ops == 2].sum())
        # The SV is recovered as a gap (within 5% slack for anchor jitter).
        assert n_del >= del_len * 0.95
        assert n_ins >= ins_len * 0.95
        m, e = cigar_stats(ops, lens)
        # Full-length: no clipping exists in this CIGAR model, and matches
        # dominate outside the SV.
        assert m > 0.97 * (min(a.size, b.size) - max(del_len, ins_len))

    def test_paf_full_length(self):
        rng = np.random.default_rng(9)
        a = rng.integers(0, 4, 8000).astype(np.int8)
        b = np.concatenate([a[:4000], rng.integers(0, 4, 3000).astype(np.int8),
                            a[4000:]])
        aln = PairAligner().align(a, b)
        row = paf_row("hapA", a, "hapB", b, aln=aln, div=(10, 0.1)).split("\t")
        # query = hapB full length, target = hapA full length (dist.rs:287-289)
        assert row[0] == "hapB" and row[5] == "hapA"
        assert (row[1], row[2], row[3]) == ("11000", "0", "11000")
        assert (row[6], row[7], row[8]) == ("8000", "0", "8000")
        tags = {t.split(":", 1)[0] for t in row[12:]}
        assert {"NM", "AS", "dv", "qv", "um", "md", "cg"} <= tags


class TestPruneConsumesPaf:
    def test_paf_divergences(self, tmp_path):
        from locityper_tpu.commands.prune import load_paf_divergences
        rng = np.random.default_rng(11)
        base = rng.integers(0, 4, 4000).astype(np.int8)
        seqs = [mutate(rng, base, r) for r in (0.0, 0.001, 0.2)]
        names = ["h0", "h1", "h2"]
        al = PairAligner()
        rows = []
        for i in range(3):
            for j in range(i + 1, 3):
                aln = al.align(seqs[i], seqs[j])
                rows.append(paf_row(names[i], seqs[i], names[j], seqs[j],
                                    aln=aln))
        paf = tmp_path / "haps.paf"
        paf.write_text("\n".join(rows) + "\n")
        div = load_paf_divergences(paf, names, "dv", repl_missing=1.0)
        assert div[0, 1] < 0.01      # near-identical pair
        assert div[0, 2] > 0.1       # divergent pair
        assert np.allclose(div, div.T)
