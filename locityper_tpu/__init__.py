"""locityper-tpu: a targeted genotyper in JAX for NVIDIA GPUs.

A from-scratch reimplementation of the Locityper method (Prodanov et al.,
Nature Genetics 2025): JAX/XLA compute path with Pallas kernels for the GPU,
dense batched tensors instead of per-read pointer chasing, massively parallel
stochastic solvers, and `jax.sharding` meshes for multi-device scaling.

The behavioral spec is the reference Rust implementation (see SURVEY.md);
file:line citations in docstrings point into that reference tree.

Layout:
    utils/     host runtime: logging, IO, checkpointing, RNG streams
    mathx/     numeric core: log-space ops, NBinom/BetaBinomial/Bayes, LOESS
    seq/       sequences: DNA encoding, FASTA/FASTQ, k-mers/minimizers, contigs
    ops/       device kernels: minimizers, recruitment, banded alignment, solver
    bg/        background models: insert size, error profile, GC read depth
    model/     genotyping model: windows/weights, read-hap likelihoods
    solvers/   stage scheme, genotype ranking, result JSON
    parallel/  mesh/sharding helpers for multi-chip execution
    commands/  CLI subcommands (add, preproc, genotype, recruit, align, ...)
"""

__version__ = "0.1.0"
