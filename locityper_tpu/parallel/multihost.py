"""Multi-host execution: loci shard across hosts, cards shard within.

The workload is embarrassingly parallel at the locus level (the reference's
outermost loop, genotype.rs:1278-1298), so the multi-host design keeps ALL
cross-host traffic off the critical path:

* within a host: ONE process owns all of the host's cards, and the
  {read × gt} device mesh (parallel/mesh.py) shards alignment and solving
  over them.  Several processes on one card fail: each JAX process
  reserves most of a card's memory when it starts;
* across hosts: loci partition round-robin by process index — no
  cross-host collectives at all.  Each process writes its own per-locus
  outputs into the shared output directory (distinct subdirectories +
  success files, so results merge trivially and reruns resume per locus).

`maybe_init_distributed` wires `jax.distributed` from the environment
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID — all three
given explicitly); single-process runs are untouched.
"""
from __future__ import annotations

import os

from ..utils.logging import get_logger

logger = get_logger("multihost")

_initialized = False


def maybe_init_distributed() -> bool:
    """Initializes jax.distributed when a coordinator is configured in the
    environment; returns True when running multi-process."""
    global _initialized
    import jax

    if not _initialized and os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize(
            coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
            num_processes=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")))
        _initialized = True
        logger.info("jax.distributed: process %d/%d, %d local / %d global "
                    "devices", jax.process_index(), jax.process_count(),
                    jax.local_device_count(), jax.device_count())
    return jax.process_count() > 1


def lpt_assign(costs: list, n_bins: int) -> list:
    """Longest-processing-time-first assignment of weighted items to
    `n_bins` bins: items sorted by descending cost go to the currently
    lightest bin.  Deterministic (ties break on item index, then bin
    index) so every host computes the identical partition with no
    communication.  Returns the bin index of each item.

    Guarantees max_load <= (4/3 - 1/(3n)) * optimal — the classic LPT
    bound — so one expensive straggler locus can no longer serialize a
    round-robin host while others idle (reference
    outer loop: genotype.rs:1278-1298)."""
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    loads = [0.0] * n_bins
    bin_of = [0] * len(costs)
    for i in order:
        b = min(range(n_bins), key=lambda j: (loads[j], j))
        bin_of[i] = b
        loads[b] += costs[i]
    return bin_of


def shard_loci(names: list, costs: list | None = None) -> list:
    """This process's share of the loci; identity in single-process runs.

    Without `costs`: round-robin by process index.  With per-locus cost
    estimates (any positive proxy — e.g. n_genotypes x locus_len):
    LPT cost-weighted partition, still deterministic across hosts."""
    import jax

    n = jax.process_count()
    if n <= 1:
        return list(names)
    i = jax.process_index()
    if costs is None:
        mine = list(names[i::n])
    else:
        assert len(costs) == len(names)
        bin_of = lpt_assign(list(costs), n)
        mine = [nm for nm, b in zip(names, bin_of) if b == i]
        my_cost = sum(c for c, b in zip(costs, bin_of) if b == i)
        logger.info("Host %d/%d load %.3g/%.3g (cost-weighted)", i, n,
                    my_cost, float(sum(costs)))
    logger.info("Host %d/%d takes %d/%d loci", i, n, len(mine), len(names))
    return mine
