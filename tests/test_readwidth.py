"""Reads longer than the historical 192 bp batch width must never be
clipped.  The reference recruiter always sees full
sequences (recruit.rs:852-932); the fast native-parser path sizes the
batch width from the input and restarts if a longer read appears
mid-stream."""
from types import SimpleNamespace

import numpy as np
import pytest

from locityper_tpu import sim
from locityper_tpu.commands.genotype import recruit_reads, recruit_reads_fast
from locityper_tpu.seq import fastx
from locityper_tpu.seq.contigs import ContigSet
from locityper_tpu.seq.counts import GenomeKmerCounter, off_target_counts
from locityper_tpu.seq.fastx import (MaxLenExceeded, _bucket_len,
                                     fast_paired_batches,
                                     probe_fastq_max_len)
from locityper_tpu.seq.recruit import RecruitParams
from locityper_tpu.utils.io import smart_create


@pytest.fixture(scope="module")
def world300(tmp_path_factory):
    """Simulated locus + 300 bp paired-end WGS sample (beyond the old
    hard-coded 192 bp width)."""
    root = tmp_path_factory.mktemp("w300")
    rng = np.random.default_rng(77)
    locus = sim.simulate_locus(rng, "G", length=4000, n_haps=4,
                               divergence=0.02)
    genome = np.concatenate([sim.random_genome(rng, 30_000),
                             locus.haplotypes[0],
                             sim.random_genome(rng, 30_000)])
    counter = GenomeKmerCounter(25)
    counter.add_seq(genome)
    counter.finalize()
    kc = off_target_counts(counter, locus.haplotypes, locus.haplotypes[0])
    cset = ContigSet("G", locus.hap_names, locus.haplotypes)
    true_haps = [locus.haplotypes[i] for i in locus.true_genotype]
    loc = sim.simulate_paired_reads(rng, true_haps, depth=6, read_len=300,
                                    insert_mean=700, insert_sd=60,
                                    prefix="loc")
    bg = sim.simulate_paired_reads(rng, [genome[:20_000]], depth=1,
                                   read_len=300, insert_mean=700,
                                   insert_sd=60, prefix="bg")
    r1p, r2p = root / "r_1.fq.gz", root / "r_2.fq.gz"
    names = loc.names + bg.names
    all1 = loc.reads1 + bg.reads1
    all2 = loc.reads2 + bg.reads2
    with smart_create(r1p) as f1, smart_create(r2p) as f2:
        for n, a, b in zip(names, all1, all2):
            fastx.write_fastq(f1, fastx.Read(n, a))
            fastx.write_fastq(f2, fastx.Read(n, b))
    loci = {"G": SimpleNamespace(contig_set=cset, kmer_counts=kc)}
    longest = max(max(a.size for a in all1), max(b.size for b in all2))
    return dict(root=root, loci=loci, r1=r1p, r2=r2p, names=names,
                all1=all1, all2=all2, longest=longest)


def test_probe_and_bucket(world300):
    # Indel errors make simulated reads 299-301 bp around the nominal 300.
    assert world300["longest"] >= 300
    assert probe_fastq_max_len(
        (world300["r1"], world300["r2"])) == world300["longest"]
    assert _bucket_len(300) == 320
    assert _bucket_len(100) == 192
    assert _bucket_len(193) == 256


def test_fast_batches_full_reads(world300):
    """Auto-sized batches carry the FULL 300 bp sequences (no clipping)."""
    got = {}
    for names, m1, l1, m2, l2, count in fast_paired_batches(
            world300["r1"], world300["r2"], batch=64):
        for i in range(count):
            got[names[i]] = (m1[i, :l1[i]].copy(), m2[i, :l2[i]].copy())
    assert len(got) == len(world300["names"])
    for n, a, b in zip(world300["names"], world300["all1"],
                       world300["all2"]):
        assert a.size >= 295
        np.testing.assert_array_equal(got[n][0], a)
        np.testing.assert_array_equal(got[n][1], b)


def test_fast_batches_raise_instead_of_clip(world300):
    """An explicit too-small width raises MaxLenExceeded, never clips."""
    with pytest.raises(MaxLenExceeded) as exc:
        for _ in fast_paired_batches(world300["r1"], world300["r2"],
                                     batch=64, max_len=192):
            pass
    assert exc.value.max_seen >= 295


def test_fast_path_matches_host_at_300bp(world300):
    """recruit_reads_fast (auto width) must make identical recruitment
    decisions to the host-iterator engine on a 300 bp library."""
    rp = RecruitParams(match_frac=0.6)
    fast, _ = recruit_reads_fast(world300["loci"], world300["r1"],
                                 world300["r2"], rp, batch=64)
    host_iter = ((n, a, b) for n, a, b in zip(
        world300["names"], world300["all1"], world300["all2"]))
    host, _ = recruit_reads(world300["loci"], host_iter, rp, batch=64)
    fpairs, fnames = fast["G"]
    hpairs, hnames = host["G"]
    assert sorted(fnames) == sorted(hnames)
    assert len(fnames) > 10
    fmap = {n: p for n, p in zip(fnames, fpairs)}
    hmap = {n: p for n, p in zip(hnames, hpairs)}
    orig = {n: (a, b) for n, a, b in zip(
        world300["names"], world300["all1"], world300["all2"])}
    for n in fmap:
        np.testing.assert_array_equal(fmap[n][0], hmap[n][0])
        np.testing.assert_array_equal(fmap[n][1], hmap[n][1])
        # Full, unclipped reads flow downstream.
        np.testing.assert_array_equal(fmap[n][0], orig[n][0])
        np.testing.assert_array_equal(fmap[n][1], orig[n][1])


def test_fast_path_restarts_on_midstream_long_read(world300):
    """A too-small starting width triggers the restart loop and still
    produces exact full-length results."""
    rp = RecruitParams(match_frac=0.6)
    fast, _ = recruit_reads_fast(world300["loci"], world300["r1"],
                                 world300["r2"], rp, batch=64, max_len=192)
    auto, _ = recruit_reads_fast(world300["loci"], world300["r1"],
                                 world300["r2"], rp, batch=64)
    assert sorted(fast["G"][1]) == sorted(auto["G"][1])
    amap = {n: p for n, p in zip(auto["G"][1], auto["G"][0])}
    for n, p in zip(fast["G"][1], fast["G"][0]):
        np.testing.assert_array_equal(p[0], amap[n][0])
        np.testing.assert_array_equal(p[1], amap[n][1])


def test_fast_path_mesh_equals_single_device(world300, monkeypatch):
    """recruit_reads_fast shards batches over the local mesh when several
    devices are attached; decisions must be identical
    to the single-device kernel path."""
    import jax

    from locityper_tpu.commands import genotype as G

    assert jax.device_count() > 1       # conftest: 8 virtual CPU devices
    rp = RecruitParams(match_frac=0.6)
    meshed, _ = recruit_reads_fast(world300["loci"], world300["r1"],
                                   world300["r2"], rp, batch=64)
    from locityper_tpu.parallel import mesh as M
    monkeypatch.setattr(M, "auto_mesh", lambda: None)
    single, _ = recruit_reads_fast(world300["loci"], world300["r1"],
                                   world300["r2"], rp, batch=64)
    assert sorted(meshed["G"][1]) == sorted(single["G"][1])
    smap = {n: p for n, p in zip(single["G"][1], single["G"][0])}
    for n, p in zip(meshed["G"][1], meshed["G"][0]):
        np.testing.assert_array_equal(p[0], smap[n][0])
        np.testing.assert_array_equal(p[1], smap[n][1])
