"""The device-path choice, the compile cache, the smoke script's refusal
to run without a GPU, meshes of any device count, and the bulk read
simulator the smoke script uses."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from locityper_tpu import cli, sim
from locityper_tpu.ops import device
from locityper_tpu.seq import dna

ROOT = Path(__file__).resolve().parent.parent


class TestKernelRoute:
    def test_xla_on_cpu(self, monkeypatch):
        monkeypatch.delenv(device.ROUTE_ENV, raising=False)
        assert device.kernel_route() == "xla"

    def test_gpu_on_cuda(self, monkeypatch):
        monkeypatch.delenv(device.ROUTE_ENV, raising=False)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert device.kernel_route() == "gpu"

    @pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
    def test_unsupported_backend_raises(self, monkeypatch, backend):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            device.kernel_route()

    def test_forced_xla_route(self, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setenv(device.ROUTE_ENV, "xla")
        assert device.kernel_route() == "xla"

    def test_forced_gpu_route_on_cpu_raises(self, monkeypatch):
        monkeypatch.setenv(device.ROUTE_ENV, "gpu")
        with pytest.raises(RuntimeError, match="not available"):
            device.kernel_route()


class TestCompileCache:
    def test_env_honoured(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cli.compile_cache_dir() == tmp_path

    def test_default_inside_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = cli.compile_cache_dir()
        assert path == ROOT / ".jax_cache"
        assert path == cli.compile_cache_dir()          # fixed: no pid/time
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()

    def test_off_on_cpu(self):
        assert cli._enable_compile_cache() is None


def _run_smoke(cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


class TestSmokeScript:
    def test_refuses_cpu(self):
        res = _run_smoke(ROOT)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout

    def test_fails_alone(self, tmp_path):
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        res = _run_smoke(tmp_path)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


class TestMesh:
    def test_auto_mesh_uses_every_device(self):
        from locityper_tpu.parallel.mesh import auto_mesh
        mesh = auto_mesh()
        assert mesh is not None
        assert mesh.devices.size == jax.local_device_count()

    def test_three_device_stage_solver_pads(self):
        """A genotype chunk that does not divide over the mesh (16 over 3
        devices) is padded and cut back."""
        from test_ilp import small_problem
        from locityper_tpu.ops.solver import SolverConfig, solve_genotypes
        from locityper_tpu.parallel.mesh import (make_mesh,
                                                 sharded_stage_solver)
        tensors, pack, bayes, params = small_problem(0)
        args = (tensors.hap_prob, tensors.hap_mid, tensors.unmapped_prob,
                pack.n_windows, pack.reg_start, pack.contig_len, pack.gc_at,
                pack.weight_at, bayes)
        cfg = SolverConfig(anneal_steps=50, polish_steps=50, tweak=0,
                           window_size=pack.window_size)
        mesh = make_mesh(3)
        assert dict(mesh.shape) == {"read": 1, "gt": 3}
        gts = np.array([(a % 3, 2) for a in range(16)], np.int32)

        def run_solver(key, g):
            return solve_genotypes(key, g, *args, cfg, n_attempts=2,
                                   max_windows=pack.max_windows)

        liks, assgns = sharded_stage_solver(mesh, run_solver,
                                            jax.random.PRNGKey(0), gts)
        assert liks.shape == (16, 2)
        assert assgns.shape[:2] == (16, 2)
        assert np.isfinite(np.asarray(liks)).all()


class TestBulkReads:
    def test_no_errors_is_identity(self):
        rng = np.random.default_rng(0)
        frags = sim.random_genome(rng, 4000).reshape(20, 200)
        out = sim.apply_errors_bulk(rng, frags, sim.ErrorModel(0, 0, 0), 150)
        np.testing.assert_array_equal(out, frags[:, :150])

    def test_error_rates(self):
        rng = np.random.default_rng(1)
        frags = np.tile(sim.random_genome(rng, 200), (4000, 1))
        out = sim.apply_errors_bulk(rng, frags, sim.ErrorModel(0.01, 0, 0),
                                    200)
        assert (out < 4).all()
        rate = float(np.mean(out != frags))
        assert 0.008 < rate < 0.012
        # Indels keep every output base defined while the fragment lasts.
        out = sim.apply_errors_bulk(rng, frags,
                                    sim.ErrorModel(0.0, 0.02, 0.02), 150)
        assert (out < 4).all()

    def test_pairs_come_from_the_sequence(self):
        rng = np.random.default_rng(2)
        seq = sim.random_genome(rng, 20_000)
        text = dna.decode(seq)
        chunks = list(sim.simulate_paired_reads_bulk(
            rng, seq, depth=3.0, errors=sim.ErrorModel(0, 0, 0), chunk=64))
        n = sum(len(a) for a, _ in chunks)
        assert n == int(3.0 * seq.size / 300 + 0.5)
        assert all(len(a) <= 64 for a, _ in chunks)
        for a, b in chunks[:2]:
            for r1, r2 in zip(a[:10], b[:10]):
                s1, s2 = dna.decode(r1), dna.decode(r2)
                # One mate on each strand.
                fw1 = s1 in text
                assert fw1 or dna.revcomp_str(s1) in text
                assert (dna.revcomp_str(s2) in text) if fw1 else (s2 in text)
