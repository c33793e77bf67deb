"""Multi-device execution: device meshes and sharded genotyping steps.

The reference is a single-node multi-threaded CPU tool (SURVEY.md §2.3); its
two worker pools map onto a 2-axis device mesh here:

* axis "read" (data parallel): read batches and the read×haplotype
  likelihood tensors are sharded by read; per-genotype filter scores are
  partial sums reduced with `psum` (counterpart of the recruitment
  and alignment-loading pools, recruit.rs:1103-1311, locs.rs:1120-1146);
* axis "gt" (task parallel): genotype×attempt annealing chains are
  embarrassingly parallel and shard along "gt" (counterpart of the solver
  worker pool, solve.rs:969-1127 — mpsc channels become sharding
  annotations, XLA inserts the gathers).

The cards of one host are joined all to all (NVLink), so the mesh shape
follows the algorithm alone, for any device count.  Loci are independent
(outer loop) and shard across hosts unchanged (parallel/multihost.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..ops.solver import SolverConfig, solve_genotypes


def make_mesh(n_devices: int | None = None, read_axis: int | None = None,
              local: bool = False) -> Mesh:
    """2D mesh {read × gt}.  By default puts min(2, n) on the read axis.
    local=True restricts to this process's devices (multi-host runs shard
    LOCI across processes, never arrays — parallel/multihost.py)."""
    devices = jax.local_devices() if local else jax.devices()
    n = n_devices or len(devices)
    devices = devices[:n]
    if read_axis is None:
        read_axis = 2 if n % 2 == 0 and n > 1 else 1
    arr = np.array(devices).reshape(read_axis, n // read_axis)
    return Mesh(arr, axis_names=("read", "gt"))


def auto_mesh() -> Mesh | None:
    """Production mesh selection: a {read × gt} mesh over all LOCAL devices
    when more than one is attached, else None (single-device path, zero
    overhead).  Only local devices: a mesh spanning processes would make
    per-locus outputs non-addressable, and the multi-host design keeps all
    cross-host parallelism at the locus level (multihost.py)."""
    n = jax.local_device_count()
    return make_mesh(local=True) if n > 1 else None


def sharded_stage_solver(mesh: Mesh, run_solver, key, gts: np.ndarray):
    """Genotype-sharded solver stage: the padded [G, P] genotype chunk splits
    over the FULL mesh and every device runs the stage engine (the annealer
    kernel on the GPU) on its local genotypes — the reference's
    solver worker pool (solve.rs:969-1127) expressed as a shard_map, with
    mpsc channels replaced by the output sharding.

    `run_solver(key, gts) -> (liks [G, A], assgns [G, A, R])` must be
    shape-polymorphic in G.  Each shard folds its linear mesh index into the
    key so chains stay statistically independent across devices.
    """
    n_gt_ax = mesh.shape["gt"]
    G = gts.shape[0]
    pad = (-G) % mesh.devices.size
    if pad:
        gts = np.concatenate([gts, np.repeat(gts[-1:], pad, 0)])

    def local(key_, gts_):
        ix = jax.lax.axis_index("read") * n_gt_ax + jax.lax.axis_index("gt")
        return run_solver(jax.random.fold_in(key_, ix), gts_)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(("read", "gt"), None)),
        out_specs=(P(("read", "gt"), None), P(("read", "gt"), None, None)),
        check_vma=False)
    liks, assgns = fn(key, jnp.asarray(gts))
    return (liks[:G], assgns[:G]) if pad else (liks, assgns)


def sharded_filter_scores(mesh: Mesh, best_aln: jnp.ndarray,
                          genotypes: jnp.ndarray, priors: jnp.ndarray):
    """Stage-0 filter with reads sharded over the "read" axis:
    score[g] = prior[g] + Σ_r max_h∈gt best_aln[h, r] (genotypes [G, P]).
    The read-sum is a psum across devices (solve.rs:87-122
    redistributed)."""
    def local(best_aln_shard, genotypes, priors):
        gt_best = best_aln_shard[genotypes[:, 0]]
        for p in range(1, genotypes.shape[1]):
            gt_best = jnp.maximum(gt_best, best_aln_shard[genotypes[:, p]])
        partial = jnp.sum(gt_best, axis=1)
        total = jax.lax.psum(partial, "read")
        return priors + total

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "read"), P(None), P(None)),
        out_specs=P(None),
        check_vma=False)
    return jax.jit(fn)(best_aln, genotypes, priors)


def sharded_solve(mesh: Mesh, key, genotypes, hap_prob, hap_mid, unmapped_prob,
                  pack_nwin, pack_regstart, pack_len, gc_at, weight_at, bayes,
                  cfg: SolverConfig, n_attempts: int, max_windows: int,
                  random_init: bool = True):
    """Genotype-sharded annealing: genotype batch split along BOTH mesh axes
    (chains are independent; the full mesh works on genotypes)."""
    n = mesh.devices.size
    G = genotypes.shape[0]
    pad = (-G) % n
    if pad:
        genotypes = jnp.concatenate([genotypes,
                                     jnp.repeat(genotypes[-1:], pad, 0)])
    gt_sharding = NamedSharding(mesh, P(("read", "gt"), None))
    rep = NamedSharding(mesh, P())
    genotypes = jax.device_put(genotypes, gt_sharding)
    args = [jax.device_put(a, rep) for a in
            (hap_prob, hap_mid, unmapped_prob, pack_nwin, pack_regstart,
             pack_len, gc_at, weight_at, bayes)]
    liks, assgn = solve_genotypes(key, genotypes, *args, cfg=cfg,
                                  n_attempts=n_attempts,
                                  max_windows=max_windows,
                                  random_init=random_init)
    liks = np.asarray(liks)
    return (liks[:G] if pad else liks)


def sharded_align(mesh: Mesh, reads, rlens, hap_wins, score_vec,
                  band: int = 48):
    """Read-batch-sharded banded alignment (P3/P4 of SURVEY.md §2.3):
    the [N, L] batch splits along the full mesh and each device runs the
    LOCAL kernel (ops/align.align_batch_auto) on its shard — no
    collectives, the embarrassing parallelism of the reference's alignment
    worker pools (locs.rs:1120-1146).  shard_map (not jit auto-sharding) so
    the per-device program is the hand-written kernel, not an XLA
    repartition of it."""
    from ..ops.align import align_batch_auto

    n = mesh.devices.size
    N = reads.shape[0]
    pad = (-N) % n
    if pad:
        reads = np.concatenate([reads, np.full((pad, reads.shape[1]), 4,
                                               reads.dtype)])
        rlens = np.concatenate([rlens, np.zeros(pad, rlens.dtype)])
        hap_wins = np.concatenate(
            [hap_wins, np.full((pad, hap_wins.shape[1]), 4, hap_wins.dtype)])

    def local(r, l, w, sv):
        return align_batch_auto(r, l, w, sv, band=band)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(("read", "gt")), P(("read", "gt")), P(("read", "gt")),
                  P()),
        out_specs=P(("read", "gt")),
        check_vma=False)
    res = fn(jnp.asarray(reads), jnp.asarray(rlens), jnp.asarray(hap_wins),
             jnp.asarray(score_vec))
    return {k: np.asarray(v)[:N] for k, v in res.items()}


def sharded_recruit_pairs(mesh: Mesh, cfg, reads1, reads2, tbl_a, tbl_b):
    """Read-batch-sharded pair recruitment (P1 of SURVEY.md §2.3): the
    [B, L] batches split along the full mesh; each device classifies its
    shard with the local kernel — no collectives (the reference's
    recruitment task farm, recruit.rs:1103-1311).  (tbl_a, tbl_b) are
    DeviceIndex.tables() (sorted or hash layout per cfg.lookup)."""
    from ..ops.recruit import recruit_pairs_batch

    n = mesh.devices.size
    B = reads1.shape[0]
    pad = (-B) % n
    if pad:
        reads1 = np.concatenate(
            [reads1, np.full((pad, reads1.shape[1]), 4, reads1.dtype)])
        reads2 = np.concatenate(
            [reads2, np.full((pad, reads2.shape[1]), 4, reads2.dtype)])

    def local(r1, r2, ta, tb):
        return recruit_pairs_batch(cfg, r1, r2, ta, tb)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(("read", "gt")), P(("read", "gt")), P(), P()),
        out_specs=P(("read", "gt")),
        check_vma=False)
    hits = fn(jnp.asarray(reads1), jnp.asarray(reads2),
              jnp.asarray(tbl_a), jnp.asarray(tbl_b))
    return hits[:B]


class MeshPairRecruiter:
    """Persistent mesh-sharded pair recruitment for the production fast
    path.  Index tables are replicated onto the mesh ONCE; each batch is
    device_put pre-sharded along the read axis and classified by the
    local kernel — no collectives.
    Decisions are bit-identical to the single-device kernel
    (tests/test_recruit.py::test_sharded_recruit_matches_single_device)."""

    def __init__(self, mesh: Mesh, dev):
        import jax.numpy as jnp

        from ..ops.recruit import _pairs_decide, _unpack_reads4

        self.mesh = mesh
        repl = jax.sharding.NamedSharding(mesh, P())
        self._tables = tuple(jax.device_put(a, repl) for a in dev.tables())
        self._in_shard = jax.sharding.NamedSharding(mesh, P(("read", "gt")))
        cfg = dev.cfg

        def local(p1, p2, ta, tb):
            # 4-bit packed per-mate uploads (half the H2D bytes); mates
            # stay row-aligned per shard.
            both = jnp.concatenate([_unpack_reads4(p1), _unpack_reads4(p2)],
                                   axis=0)
            return _pairs_decide(cfg, both, p1.shape[0], ta, tb)

        self._fn = jax.jit(shard_map(
            local, mesh=mesh,
            in_specs=(P(("read", "gt")), P(("read", "gt")), P(), P()),
            out_specs=P(("read", "gt")), check_vma=False))

    def run_async(self, reads1: np.ndarray, reads2: np.ndarray):
        """[B, L] batches -> async [B, n_groups] hit bitmaps."""
        from ..ops.recruit import pack_reads_host
        n = self.mesh.devices.size
        B = reads1.shape[0]
        pad = (-B) % n
        if pad:
            reads1 = np.concatenate(
                [reads1, np.full((pad, reads1.shape[1]), 4, reads1.dtype)])
            reads2 = np.concatenate(
                [reads2, np.full((pad, reads2.shape[1]), 4, reads2.dtype)])
        p1 = jax.device_put(pack_reads_host(reads1), self._in_shard)
        p2 = jax.device_put(pack_reads_host(reads2), self._in_shard)
        return self._fn(p1, p2, *self._tables)[:B]


def full_step(mesh: Mesh, key, tensors, pack, bayes, genotypes, priors,
              cfg: SolverConfig, n_attempts: int = 2):
    """One full sharded genotyping step: read-sharded filter + gt-sharded
    solve (__graft_entry__.dryrun_multichip)."""
    best_aln = jnp.maximum(jnp.max(tensors.hap_prob, axis=2),
                           tensors.unmapped_prob[None, :])
    scores = sharded_filter_scores(mesh, best_aln, jnp.asarray(genotypes),
                                   jnp.asarray(priors))
    liks = sharded_solve(
        mesh, key, jnp.asarray(genotypes), tensors.hap_prob, tensors.hap_mid,
        tensors.unmapped_prob, pack.n_windows, pack.reg_start,
        pack.contig_len, pack.gc_at, pack.weight_at, bayes, cfg,
        n_attempts=n_attempts, max_windows=pack.max_windows)
    return np.asarray(scores), liks
