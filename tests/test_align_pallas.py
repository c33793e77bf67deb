"""Aligner kernel (ops/align_pallas.py) vs the XLA reference kernel.

On the CPU the kernel runs in Pallas interpret mode; its CUDA lowering is
checked by exporting it for the "cuda" platform (no card needed).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from locityper_tpu.ops import align as A
from locityper_tpu.ops import align_pallas as AP
from locityper_tpu.sim import ErrorModel, random_genome

SC = A.Scores.from_error_rates(0.002, 0.0002, 0.0002)
SCORE_VEC = np.array(SC.astuple(), dtype=np.float32)


def make_batch(rng, B, L, band, err=None):
    err = err or ErrorModel(0.01, 0.003, 0.003)
    hap = random_genome(rng, 50_000)
    reads = np.full((B, L), 4, np.int8)
    lens = np.zeros(B, np.int32)
    wins = np.full((B, L + band), 4, np.int8)
    for i in range(B):
        start = int(rng.integers(0, hap.size - L - 1))
        r = err.apply(rng, hap[start:start + L])[:L]
        lens[i] = r.size
        reads[i, :r.size] = r
        wins[i] = A.extract_windows(hap, np.array([start - band // 2]),
                                    L + band)[0]
    return reads, lens, wins


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


class TestPallasParity:
    @pytest.mark.parametrize("B,L,band", [
        (96, 64, 32),      # batch not a multiple of the program width
        (64, 77, 48),      # odd read length
        (40, 100, 48),
        (40, 100, 96),     # wide band: streamed in chunks of 32 cells
    ])
    def test_matches_xla_kernel(self, B, L, band):
        rng = np.random.default_rng(B + L + band)
        reads, lens, wins = make_batch(rng, B, L, band)
        lens[:3] = [L // 2, 1, L]            # short and full-length reads
        want = _np(A.align_batch(reads, lens, wins, SCORE_VEC, band=band))
        got = _np(AP.align_batch_pallas(reads, lens, wins, SCORE_VEC,
                                        band=band, interpret=True))
        # Same float32 operations in the same order: bit-identical.
        np.testing.assert_array_equal(got["score"], want["score"])
        for k in ("n_mism", "n_ins", "n_del", "n_clip", "start_p", "end_p",
                  "valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_long_deletion_run(self):
        """A deletion run longer than 32 (the old kernel's cap) is scored
        exactly: the band scan is a full sequential max."""
        rng = np.random.default_rng(9)
        hap = random_genome(rng, 5_000)
        band, L = 64, 96
        src = np.concatenate([hap[1000:1048], hap[1088:1136]])  # 40-bp gap
        reads = src[None, :L].astype(np.int8)
        lens = np.array([L], np.int32)
        wins = A.extract_windows(hap, np.array([1000 - 4]),
                                 L + band)[None, 0]
        # Deletions cheap enough to beat clipping the read's second half.
        sv = np.array(A.Scores.from_error_rates(0.002, 0.0002, 0.05)
                      .astuple(), np.float32)
        want = _np(A.align_batch(reads, lens, wins, sv, band=band))
        got = _np(AP.align_batch_pallas(reads, lens, wins, sv, band=band,
                                        interpret=True))
        assert want["n_del"][0] == 40
        np.testing.assert_array_equal(got["n_del"], want["n_del"])
        np.testing.assert_array_equal(got["score"], want["score"])


class TestWrapper:
    def test_tile_choice(self):
        assert AP.tile_for(48) == (64, 2)
        assert AP.tile_for(160) == (32, 1)

    def test_too_long_reads_rejected(self):
        with pytest.raises(ValueError, match="16-bit"):
            AP.align_batch_pallas(
                jnp.zeros((4, AP.MAX_LEN), jnp.int8),
                jnp.zeros(4, jnp.int32),
                jnp.zeros((4, AP.MAX_LEN + 48), jnp.int8), SCORE_VEC,
                band=48, interpret=True)

    def test_dispatch_by_route(self, monkeypatch):
        """align_batch_auto runs the kernel on the "gpu" route and the XLA
        kernel on the "xla" route."""
        from locityper_tpu.ops import device
        calls = []
        monkeypatch.setattr(AP, "align_batch_pallas",
                            lambda *a, **kw: calls.append("kernel"))
        reads = np.full((8, 32), 0, np.int8)
        lens = np.full(8, 32, np.int32)
        wins = np.full((8, 32 + 16), 0, np.int8)
        monkeypatch.setattr(device, "kernel_route", lambda: "gpu")
        A.align_batch_auto(reads, lens, wins, SCORE_VEC, band=16)
        assert calls == ["kernel"]
        monkeypatch.setattr(device, "kernel_route", lambda: "xla")
        res = A.align_batch_auto(reads, lens, wins, SCORE_VEC, band=16)
        assert calls == ["kernel"] and res["score"].shape == (8,)

    @pytest.mark.parametrize("band,L", [(48, 152), (160, 4096)])
    def test_lowers_for_cuda(self, band, L):
        """The kernel lowers to Triton IR for a CUDA target (every
        primitive it uses has a Triton lowering rule)."""
        from jax.export import DisabledSafetyCheck, export
        f = jax.jit(lambda r, n, w, s: AP.align_batch_pallas(
            r, n, w, s, band=band))
        exp = export(f, platforms=["cuda"], disabled_checks=[
            DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(
            jax.ShapeDtypeStruct((256, L), jnp.int8),
            jax.ShapeDtypeStruct((256,), jnp.int32),
            jax.ShapeDtypeStruct((256, L + band), jnp.int8),
            jax.ShapeDtypeStruct((5,), jnp.float32))
        assert "banded_align" in exp.mlir_module()


@pytest.mark.gpu
def test_kernel_on_card():
    """Compiled for the card: parity with the XLA kernel (run with
    LOCITYPER_TEST_GPU=1 on a GPU machine)."""
    rng = np.random.default_rng(0)
    reads, lens, wins = make_batch(rng, 512, 152, 48)
    want = _np(A.align_batch(reads, lens, wins, SCORE_VEC, band=48))
    got = _np(AP.align_batch_pallas(reads, lens, wins, SCORE_VEC, band=48))
    np.testing.assert_allclose(got["score"], want["score"], atol=2e-3)
    differ = np.zeros(512, bool)
    for k in ("n_mism", "n_ins", "n_del", "n_clip", "start_p", "end_p"):
        differ |= got[k] != want[k]
    assert differ.mean() <= 0.01
