"""Recruitment engine: index build + matching rules on simulated loci."""
import jax
import numpy as np
import pytest

from locityper_tpu.seq import dna
from locityper_tpu.seq.contigs import ContigSet
from locityper_tpu.seq.counts import GenomeKmerCounter, KmerCounts, off_target_counts
from locityper_tpu.seq.recruit import (
    RecruitParams, TargetIndex, recruit_any, recruit_long_read,
    recruit_read_pair, recruit_short_read,
)
from locityper_tpu import sim


def build_world(seed=0, locus_len=4000, genome_len=60000, n_haps=4, divergence=0.02):
    """Genome with an embedded locus + haplotype panel + off-target counts."""
    rng = np.random.default_rng(seed)
    genome = sim.random_genome(rng, genome_len)
    locus_start = genome_len // 2
    locus = sim.simulate_locus(rng, length=locus_len, n_haps=n_haps,
                               divergence=divergence)
    # Embed haplotype 0 into the genome so locus k-mers exist there once.
    genome = genome.copy()
    ref_hap = locus.haplotypes[0]
    genome[locus_start:locus_start + ref_hap.size] = ref_hap[:genome_len - locus_start]

    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    target_seq = genome[locus_start:locus_start + ref_hap.size]
    kc = off_target_counts(counter, locus.haplotypes, target_seq)
    cset = ContigSet("locus", locus.hap_names, locus.haplotypes)
    return rng, genome, locus, cset, kc, locus_start


@pytest.fixture(scope="module")
def world():
    return build_world()


@pytest.fixture(scope="module")
def index(world):
    _, _, locus, cset, kc, _ = world
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    idx.add_locus(cset, kc)
    idx.finalize()
    return idx


class TestOffTargetCounts:
    def test_locus_kmers_mostly_unique(self, world):
        _, _, locus, _, kc, _ = world
        # Haplotype 0 is embedded in the genome exactly once -> off-target
        # counts for its k-mers should be 0 (unique to the locus).
        frac_unique = float(np.mean(kc.counts[0] == 0))
        assert frac_unique > 0.95

    def test_background_kmers_not_unique(self, world):
        rng, genome, locus, _, kc, locus_start = world
        counter = GenomeKmerCounter(25)
        counter.add_seq(genome)
        counter.finalize()
        bg = genome[1000:2000]
        c = counter.seq_counts(bg)
        assert float(np.mean(c >= 1)) > 0.99


class TestIndex:
    def test_built(self, index):
        assert index.keys.size > 100
        assert index.n_loci == 1
        assert index.entry_locus.size == index.offsets[-1]
        # Entries sorted by key.
        assert (np.diff(index.keys.astype(np.int64)) > 0).all()

    def test_lookup_roundtrip(self, index):
        found, start, end = index.lookup(index.keys[:50])
        assert found.all()
        assert (end > start).all()
        missing = np.array([12345], np.uint32)
        if missing[0] not in index.keys:
            f, _, _ = index.lookup(missing)
            assert not f[0]


class TestShortReadRecruitment:
    def test_locus_reads_recruited(self, world, index):
        rng, _, locus, _, _, _ = world
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=4)
        hits = sum(bool(recruit_short_read(index, r)) for r in reads.reads1[:100])
        assert hits / min(len(reads.reads1), 100) > 0.95

    def test_background_reads_rejected(self, world, index):
        rng, genome, _, _, _, locus_start = world
        # Reads from far outside the locus.
        bg_reads = []
        for _ in range(100):
            s = int(rng.integers(0, 20000))
            bg_reads.append(genome[s:s + 150])
        hits = sum(bool(recruit_short_read(index, r)) for r in bg_reads)
        assert hits <= 2

    def test_pairs_recruited(self, world, index):
        rng, _, locus, _, _, _ = world
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=4)
        n = min(len(reads.reads1), 80)
        hits = sum(bool(recruit_read_pair(index, r1, r2))
                   for r1, r2 in zip(reads.reads1[:n], reads.reads2[:n]))
        assert hits / n > 0.95

    def test_mixed_pair_rejected(self, world, index):
        # One locus mate + one background mate: pair rule requires both.
        rng, genome, locus, _, _, _ = world
        hap = locus.haplotypes[0]
        r1 = hap[100:250]
        r2 = dna.revcomp(genome[5000:5150])
        assert recruit_read_pair(index, r1, r2) == []


class TestLongReadRecruitment:
    def test_long_locus_reads_recruited(self, world):
        rng, _, locus, cset, kc, _ = world
        idx = TargetIndex(RecruitParams(match_frac=0.5, match_length=2000))
        idx.add_locus(cset, kc)
        idx.finalize()
        reads = sim.simulate_single_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=2, read_len_mean=3000, read_len_sd=500)
        n = min(len(reads.reads1), 20)
        hits = sum(bool(recruit_long_read(idx, r)) for r in reads.reads1[:n])
        assert hits / n > 0.9

    def test_long_background_rejected(self, world):
        rng, genome, locus, cset, kc, _ = world
        idx = TargetIndex(RecruitParams(match_frac=0.5, match_length=2000))
        idx.add_locus(cset, kc)
        idx.finalize()
        hits = 0
        for _ in range(20):
            s = int(rng.integers(0, 15000))
            if recruit_long_read(idx, genome[s:s + 5000]):
                hits += 1
        assert hits == 0


class TestDispatch:
    def test_recruit_any(self, world, index):
        rng, _, locus, _, _, _ = world
        hap = locus.haplotypes[0]
        assert recruit_any(index, hap[0:150], None) == [0]       # short single
        long_read = hap[0:3000]
        assert recruit_any(index, long_read, None) == [0]        # long single


class TestMultiLocus:
    def test_two_loci_distinguished(self):
        rng = np.random.default_rng(11)
        genome = sim.random_genome(rng, 40000)
        locusA = sim.simulate_locus(rng, "A", length=3000, n_haps=3)
        locusB = sim.simulate_locus(rng, "B", length=3000, n_haps=3)
        counter = GenomeKmerCounter(25)
        counter.add_seq(genome)
        counter.finalize()
        idx = TargetIndex(RecruitParams(match_frac=0.5))
        for locus in (locusA, locusB):
            kc = off_target_counts(counter, locus.haplotypes,
                                   np.empty(0, dtype=np.int8))
            cset = ContigSet(locus.name, locus.hap_names, locus.haplotypes)
            idx.add_locus(cset, kc)
        idx.finalize()
        assert idx.n_loci == 2
        a_read = locusA.haplotypes[0][500:650]
        b_read = locusB.haplotypes[1][500:650]
        assert recruit_short_read(idx, a_read) == [0]
        assert recruit_short_read(idx, b_read) == [1]


class TestDeviceRecruit:
    """Device kernel must reproduce host decisions exactly."""

    def _batch(self, reads, L=160):
        import numpy as np
        B = len(reads)
        out = np.full((B, L), 4, np.int8)
        for i, r in enumerate(reads):
            out[i, :min(r.size, L)] = r[:L]
        return out

    def test_short_matches_host(self, world, index):
        from locityper_tpu.ops.recruit import DeviceIndex, run_short
        rng, genome, locus, _, _, _ = world
        dev = DeviceIndex.from_index(index)
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=2)
        mix = reads.reads1[:60] + [genome[s:s + 150]
                                   for s in range(3000, 12000, 150)]
        got = run_short(dev, self._batch(mix))
        for i, r in enumerate(mix):
            host = recruit_short_read(index, r)
            device = sorted(np.nonzero(got[i])[0].tolist())
            assert device == host, f"read {i}: device={device} host={host}"

    def test_pairs_match_host(self, world, index):
        from locityper_tpu.ops.recruit import DeviceIndex, run_pairs
        rng, genome, locus, _, _, _ = world
        dev = DeviceIndex.from_index(index)
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=2)
        n = min(60, len(reads.reads1))
        r1 = reads.reads1[:n]
        r2 = reads.reads2[:n]
        got = run_pairs(dev, self._batch(r1), self._batch(r2))
        for i in range(n):
            host = recruit_read_pair(index, r1[i], r2[i])
            device = sorted(np.nonzero(got[i])[0].tolist())
            assert device == host, f"pair {i}: device={device} host={host}"

    def test_packed_pairs_match_unpacked(self, world, index):
        """The 4-bit single-upload path must be bit-identical to the
        two-matrix path (pack_reads_host/_unpack_reads4 round-trip +
        recruit_pairs_batch_packed)."""
        from locityper_tpu.ops import recruit as R
        rng, genome, locus, _, _, _ = world
        dev = R.DeviceIndex.from_index(index)
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=2)
        n = min(60, len(reads.reads1))
        m1 = self._batch(reads.reads1[:n])
        m2 = self._batch(reads.reads2[:n])
        m1[rng.integers(0, n, 20), rng.integers(0, 150, 20)] = 4  # Ns
        packed = R.pack_reads_host(m1, m2)
        both = np.asarray(R._unpack_reads4(packed))
        assert np.array_equal(both, np.concatenate([m1, m2], axis=0))
        a = np.asarray(R.run_pairs_async(dev, m1, m2))
        b = np.asarray(R.run_pairs_async_packed(dev, m1, m2))
        assert np.array_equal(a, b)

    def test_multilocus_device(self):
        from locityper_tpu.ops.recruit import DeviceIndex, run_short
        rng = np.random.default_rng(21)
        genome = sim.random_genome(rng, 30000)
        counter = GenomeKmerCounter(25)
        counter.add_seq(genome)
        counter.finalize()
        idx = TargetIndex(RecruitParams(match_frac=0.5))
        loci = []
        for name in "AB":
            locus = sim.simulate_locus(rng, name, length=2500, n_haps=3)
            kc = off_target_counts(counter, locus.haplotypes,
                                   np.empty(0, dtype=np.int8))
            idx.add_locus(ContigSet(name, locus.hap_names, locus.haplotypes), kc)
            loci.append(locus)
        idx.finalize()
        dev = DeviceIndex.from_index(idx)
        reads = [loci[0].haplotypes[0][300:450], loci[1].haplotypes[2][300:450],
                 genome[100:250]]
        got = run_short(dev, self._batch(reads))
        assert got[0].tolist() == [True, False]
        assert got[1].tolist() == [False, True]
        assert got[2].tolist() == [False, False]


class TestDeviceLongRecruit:
    """Device long-read kernel must reproduce host decisions exactly
    (Kadane stretch as an associative scan; recruit.rs:940-997)."""

    def _batch(self, reads, L):
        B = len(reads)
        out = np.full((B, L), 4, np.int8)
        for i, r in enumerate(reads):
            out[i, :min(r.size, L)] = r[:L]
        return out

    def test_long_matches_host(self, world):
        from locityper_tpu.ops.recruit import DeviceIndex, run_long
        rng, genome, locus, cset, kc, _ = world
        params = RecruitParams(match_frac=0.5, match_length=2000)
        idx = TargetIndex(params)
        idx.add_locus(cset, kc)
        idx.finalize()
        dev = DeviceIndex.from_index(idx)
        reads = sim.simulate_single_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype],
            depth=2, read_len_mean=2800, read_len_sd=400)
        mix = reads.reads1[:20]
        # Background reads and chimeras (locus prefix + background tail —
        # exercises the stretch rule specifically).
        for _ in range(10):
            s = int(rng.integers(0, 10000))
            mix.append(genome[s:s + 3000])
        for _ in range(10):
            s = int(rng.integers(0, 10000))
            pre = locus.haplotypes[0][200:1400]
            mix.append(np.concatenate([pre, genome[s:s + 4000]]))
        L = max(r.size for r in mix)
        L = -(-L // 256) * 256
        got = run_long(dev, self._batch(mix, L), params.stretch_minims,
                       params.stretch_score)
        n_hit = 0
        for i, r in enumerate(mix):
            host = recruit_long_read(idx, r)
            device = sorted(np.nonzero(got[i])[0].tolist())
            assert device == host, f"read {i}: device={device} host={host}"
            n_hit += bool(host)
        assert 0 < n_hit < len(mix)


def test_sharded_recruit_matches_single_device():
    """sharded_recruit_pairs over the virtual mesh must equal the
    single-device kernel decisions exactly (P1 as data parallelism)."""
    from locityper_tpu.ops.recruit import (DeviceIndex, run_pairs,
                                           unpack_decisions)
    from locityper_tpu.parallel.mesh import make_mesh, sharded_recruit_pairs

    rng = np.random.default_rng(0)
    locus = sim.simulate_locus(rng, length=2000, n_haps=3)
    counter = GenomeKmerCounter(25)
    counter.add_seq(np.concatenate([sim.random_genome(rng, 5000),
                                    locus.haplotypes[0]]))
    counter.finalize()
    idx = TargetIndex(RecruitParams(match_frac=0.5))
    idx.add_locus(ContigSet(locus.name, locus.hap_names, locus.haplotypes),
                  off_target_counts(counter, locus.haplotypes,
                                    locus.haplotypes[0]))
    idx.finalize()
    dev = DeviceIndex.from_index(idx)
    B, L = 64, 128
    r1 = np.full((B, L), 4, np.int8)
    r2 = np.full((B, L), 4, np.int8)
    for i in range(B):
        s = int(rng.integers(0, 1800))
        r1[i, :120] = locus.haplotypes[i % 3][s:s + 120]
        r2[i, :120] = dna.revcomp(locus.haplotypes[0][s:s + 120])
        if i % 5 == 0:                         # non-recruiting noise
            r1[i, :120] = rng.integers(0, 4, 120)
            r2[i, :120] = rng.integers(0, 4, 120)
    single = run_pairs(dev, r1, r2)
    mesh = make_mesh()
    sharded = unpack_decisions(np.asarray(sharded_recruit_pairs(
        mesh, dev.cfg, r1, r2, *dev.tables())), dev.n_loci)
    np.testing.assert_array_equal(sharded, single)
    assert single.any() and not single.all()


class TestHashLookup:
    """The displacement-hash lookup (ops/recruit.py HASH_MIN_KEYS path)
    must make decisions bit-identical to the sorted-table path — same
    kernels, different (tbl_a, tbl_b) layout + cfg.lookup."""

    def _force_hash(self, index, monkeypatch):
        from locityper_tpu.ops import recruit as R
        monkeypatch.setattr(R, "HASH_MIN_KEYS", 1)
        return R.DeviceIndex.from_index(index)

    def test_build_is_perfect(self, index, monkeypatch):
        from locityper_tpu.ops import recruit as R
        dev = self._force_hash(index, monkeypatch)
        d_tab, shift_b, shift_t, table = dev._hash_tables()
        keys = dev.keys
        with np.errstate(over="ignore"):
            b = (keys * R._HC1) >> np.uint32(shift_b)
            slots = ((keys ^ (d_tab[b.astype(np.int64)] * R._HC3)) * R._HC2) \
                >> np.uint32(shift_t)
        assert np.unique(slots).size == keys.size       # injective
        np.testing.assert_array_equal(table[slots.astype(np.int64), 0], keys)

    def test_pairs_hash_equals_sorted(self, world, index, monkeypatch):
        from locityper_tpu.ops.recruit import DeviceIndex, run_pairs
        rng, genome, locus, _, _, _ = world
        dev_sorted = DeviceIndex.from_index(index)
        assert dev_sorted.cfg.lookup == "sorted"    # evaluated pre-patch
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=2)
        n = min(64, len(reads.reads1))
        B, L = 64, 160
        r1 = np.full((B, L), 4, np.int8)
        r2 = np.full((B, L), 4, np.int8)
        for i in range(n):
            a, b = reads.reads1[i], reads.reads2[i]
            r1[i, :min(a.size, L)] = a[:L]
            r2[i, :min(b.size, L)] = b[:L]
        for i in range(0, n, 4):                       # noise rows
            r1[i, :150] = genome[3000 + 150 * i:3150 + 150 * i]
        got_s = run_pairs(dev_sorted, r1, r2)
        dev_hash = self._force_hash(index, monkeypatch)
        assert dev_hash.cfg.lookup == "hash"
        got_h = run_pairs(dev_hash, r1, r2)
        np.testing.assert_array_equal(got_h, got_s)
        assert got_s.any()

    def test_short_and_long_hash_equal_sorted(self, world, index,
                                              monkeypatch):
        from locityper_tpu.ops.recruit import (DeviceIndex, run_long,
                                               run_short)
        rng, genome, locus, _, _, _ = world
        dev_sorted = DeviceIndex.from_index(index)
        B, L = 32, 192
        m = np.full((B, L), 4, np.int8)
        for i in range(B):
            src = locus.haplotypes[i % 3] if i % 2 else genome
            s = int(rng.integers(0, src.size - L))
            m[i, :150] = src[s:s + 150]
        Ll = 1024
        ml = np.full((8, Ll), 4, np.int8)
        for i in range(8):
            src = locus.haplotypes[i % 3] if i % 2 else genome
            s = int(rng.integers(0, src.size - Ll))
            ml[i] = src[s:s + Ll]
        p = index.params
        short_s = run_short(dev_sorted, m)
        long_s = run_long(dev_sorted, ml, p.stretch_minims, p.stretch_score)
        dev_hash = self._force_hash(index, monkeypatch)
        np.testing.assert_array_equal(run_short(dev_hash, m), short_s)
        np.testing.assert_array_equal(
            run_long(dev_hash, ml, p.stretch_minims, p.stretch_score),
            long_s)

    def test_nonconvergent_build_falls_back_to_sorted(self, world, index,
                                                      monkeypatch):
        """A pathological key set whose displacement search never
        converges must fall back to the sorted-lookup path with a
        warning, not abort the run (advisor r3)."""
        from locityper_tpu.ops import recruit as R

        def boom(keys, packed):
            raise RuntimeError("displacement hash build did not converge")

        monkeypatch.setattr(R, "HASH_MIN_KEYS", 1)
        monkeypatch.setattr(R, "_build_disp_hash", boom)
        dev = R.DeviceIndex.from_index(index)
        assert dev.cfg.lookup == "sorted"
        tbl_a, tbl_b = dev.tables()
        np.testing.assert_array_equal(tbl_a, dev.keys_signed)
        np.testing.assert_array_equal(tbl_b, dev.packed)
        rng, genome, locus, _, _, _ = world
        B, L = 16, 160
        r1 = np.full((B, L), 4, np.int8)
        r2 = np.full((B, L), 4, np.int8)
        reads = sim.simulate_paired_reads(
            rng, [locus.haplotypes[i] for i in locus.true_genotype], depth=1)
        for i in range(min(B, len(reads.reads1))):
            a, b = reads.reads1[i], reads.reads2[i]
            r1[i, :min(a.size, L)] = a[:L]
            r2[i, :min(b.size, L)] = b[:L]
        got = R.run_pairs(dev, r1, r2)
        assert got.shape[0] == B


class TestFrontEnd:
    """Minimizer compaction (_compact_minimizers) keeps the FIRST S
    minimizer positions of each read in position order, including when it
    truncates, against a numpy reference; packed decisions must
    round-trip."""

    @pytest.mark.parametrize("B,L,S_override,n_frac", [
        (64, 152, None, 0.0),
        (64, 152, 8, 0.0),        # truncating
        (32, 251, 16, 0.0),       # truncating, odd length
        (64, 64, None, 0.1),      # with Ns
    ])
    def test_compaction_keeps_first_minimizers(self, B, L, S_override,
                                               n_frac):
        import jax.numpy as jnp
        from locityper_tpu.ops import recruit as R
        rng = np.random.default_rng(L + (S_override or 0))
        k, w = 15, 10
        reads = rng.integers(0, 4, size=(B, L)).astype(np.int8)
        if n_frac:
            reads[rng.random((B, L)) < n_frac] = 4
        reads[:8, 40:60] = 4
        P = L - k + 1
        S = S_override or R._compact_width(P, w)
        hs, is_fw, mask = (np.asarray(x) for x in
                           R._hash_mask(jnp.asarray(reads), k, w))
        hc, fc, mc = (np.asarray(x) for x in R._compact_minimizers(
            jnp.asarray(hs), jnp.asarray(is_fw), jnp.asarray(mask), S))
        assert hc.shape == (B, S)
        for b in range(B):
            pos = np.nonzero(mask[b])[0][:S]
            n = pos.size
            assert mc[b, :n].all() and not mc[b, n:].any()
            np.testing.assert_array_equal(hc[b, :n], hs[b, pos])
            np.testing.assert_array_equal(fc[b, :n], is_fw[b, pos])

    def test_packed_decisions_roundtrip(self):
        import jax.numpy as jnp
        from locityper_tpu.ops.recruit import (_pack_decisions,
                                               unpack_decisions)
        rng = np.random.default_rng(2)
        for B, n_loci in [(16, 1), (64, 31), (64, 32), (32, 33), (8, 100)]:
            dec = rng.random((B, n_loci)) < 0.2
            packed = np.asarray(_pack_decisions(jnp.asarray(dec)))
            assert packed.shape == (B, max(-(-n_loci // 32), 1))
            assert packed.dtype == np.uint32
            np.testing.assert_array_equal(unpack_decisions(packed, n_loci),
                                          dec)
            # bool arrays pass through (host twin path)
            np.testing.assert_array_equal(unpack_decisions(dec, n_loci), dec)
