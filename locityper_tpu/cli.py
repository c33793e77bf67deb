"""Command-line interface (counterpart of reference src/main.rs +
command/mod.rs dispatcher).

Subcommands: add, preproc, genotype, recruit, align, prune, paf-vcf.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from .utils.logging import setup_logging


#: Compile cache used when JAX_COMPILATION_CACHE_DIR is not set: one fixed
#: directory inside the checkout (git-ignored), so every run hits it.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> Path:
    """JAX_COMPILATION_CACHE_DIR when set, else DEFAULT_CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_CACHE_DIR


def _enable_compile_cache():
    """Persistent XLA compilation cache for GPU runs.  When
    JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and nothing is
    changed here; otherwise the cache goes to DEFAULT_CACHE_DIR.

    CPU backends are excluded: XLA's CPU cache key does not fingerprint
    the host machine type, so entries compiled on a different machine
    replay with 'machine type ... doesn't match' errors — and CPU
    compiles are fast anyway."""
    import jax
    # Read the pinned platform WITHOUT initializing the backend
    # (jax.default_backend() here would break the later
    # jax.distributed.initialize in multi-process runs).
    platforms = jax.config.jax_platforms or ""
    if platforms.split(",")[0] == "cpu":
        return None
    cache = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(cache))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache


def main(argv=None):
    setup_logging()
    _enable_compile_cache()
    from .utils.malloc import tune_host_allocator
    tune_host_allocator()
    parser = argparse.ArgumentParser(
        prog="locityper-tpu",
        description="Targeted genotyper (Locityper method) on JAX")
    sub = parser.add_subparsers(dest="command", required=True)

    from .commands import (add, preproc, genotype, recruit, align, prune,
                           paf_vcf, index)
    for mod, name, help_ in [
        (add, "add", "Add locus/loci to the database"),
        (preproc, "preproc", "Preprocess a WGS sample (background distributions)"),
        (genotype, "genotype", "Genotype a sample over database loci"),
        (recruit, "recruit", "Recruit reads to target sequences"),
        (align, "align", "All-vs-all haplotype alignment (PAF output)"),
        (prune, "prune", "Prune similar haplotypes from the database"),
        (paf_vcf, "paf-vcf", "Convert haplotype PAF alignments to VCF"),
        (index, "index", "Index a coordinate-sorted BAM (.bai)"),
    ]:
        p = sub.add_parser(name, help=help_)
        mod.add_args(p)
        p.set_defaults(func=mod.run)

    args = parser.parse_args(argv)
    try:
        return args.func(args)
    except (ValueError, OSError) as e:
        # Clean one-line errors for user mistakes (bad inputs/paths), like
        # the reference's Error enum rendering (err.rs:11-150).  Unexpected
        # exception types still raise with a full traceback.
        import logging
        logging.getLogger("locityper").error("%s", e)
        return 1


if __name__ == "__main__":
    sys.exit(main())
