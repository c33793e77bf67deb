"""`recruit` command: standalone read recruitment to arbitrary targets.

Counterpart of reference command/recruit.rs: recruit reads to FASTA target
sequences and write per-target (or single) FASTQ outputs.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..seq import fastx
from ..seq.contigs import ContigSet
from ..seq.counts import KmerCounts
from ..seq.recruit import RecruitParams
from ..utils.io import smart_create
from ..utils.logging import get_logger

logger = get_logger("recruit")


def add_args(p):
    p.add_argument("-i", "--input", nargs="+", required=True)
    p.add_argument("-s", "--seqs", nargs="+", required=True,
                   help="Target FASTA file(s); each file is one target locus")
    p.add_argument("-o", "--output", nargs="+", required=True,
                   help="One output FASTQ per target, or a single file")
    p.add_argument("--interleaved", action="store_true")
    p.add_argument("-x", "--preset", default=None,
                   help="Technology preset setting the match fraction "
                        "(recruit.rs:88-105): illumina/illumina-se/hifi/"
                        "pacbio/ont")
    p.add_argument("--match-frac", type=float, default=None)
    p.add_argument("--match-len", type=int, default=2000)
    p.add_argument("--kmer-thresh", type=int, default=10)
    p.add_argument("--subsample", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p


_PRESETS = {
    "illumina": ("illumina", True), "illumina-pe": ("illumina", True),
    "sr": ("illumina", True), "sr-pe": ("illumina", True),
    "illumina-se": ("illumina", False), "sr-se": ("illumina", False),
    "hifi": ("hifi", False), "pacbio": ("pacbio", False),
    "pb": ("pacbio", False), "ont": ("nanopore", False),
    "nanopore": ("nanopore", False),
}


def run(args):
    match_frac = args.match_frac
    if args.preset is not None:
        if args.preset.lower() not in _PRESETS:
            raise ValueError(f"unknown preset {args.preset!r}; options: "
                             + ", ".join(sorted(_PRESETS)))
        from ..bg import Technology
        tech_name, paired = _PRESETS[args.preset.lower()]
        tech = Technology.parse(tech_name)
        if match_frac is None:
            match_frac = tech.default_match_frac(paired)
    if match_frac is None:
        match_frac = 0.5
    params = RecruitParams(match_frac=match_frac,
                           match_length=args.match_len,
                           thresh_kmer_count=args.kmer_thresh)
    # Standalone mode has no genome counts: treat all k-mers as rare
    # (count 0), as the reference does without jellyfish counts.
    from types import SimpleNamespace

    targets = {}
    for path in args.seqs:
        named = [(r.name, r.seq) for r in fastx.read_fastx_auto(path)]
        cset = ContigSet(Path(path).stem, [n for n, _ in named],
                         [s for _, s in named])
        kc = KmerCounts(25, [np.zeros(max(s.size - 24, 0), np.uint16)
                             for _, s in named])
        targets[cset.tag] = SimpleNamespace(contig_set=cset, kmer_counts=kc)

    single_out = len(args.output) == 1
    if not single_out and len(args.output) != len(targets):
        raise SystemExit("Number of outputs must be 1 or match targets")

    # Stream through the shared batched engine (device kernel,
    # double-buffered) — the standalone command gets the same throughput
    # as the genotype pipeline, including the native-parser fast path for
    # 2-FASTQ inputs (no per-read Python).
    from .genotype import (_is_alignment_file, _read_iter, recruit_reads,
                           recruit_reads_fast)

    from ..seq.fastx import is_fastq_files, probe_fastq_max_len

    if (len(args.input) == 2 and not args.interleaved
            and not _is_alignment_file(args.input[0])
            and not _is_alignment_file(args.input[1])
            and is_fastq_files(args.input)
            # Pair kernel = short-read semantics; long pairs keep the
            # general engine (recruit_reads routes them appropriately).
            and probe_fastq_max_len(args.input) <= 500):
        out, _speed = recruit_reads_fast(
            targets, args.input[0], args.input[1], params,
            subsample=args.subsample, seed=args.seed)
    else:
        out, _speed = recruit_reads(
            targets, _read_iter(args.input, args.interleaved), params,
            subsample=args.subsample, seed=args.seed)

    writers = [smart_create(p) for p in args.output]
    order = list(targets)
    seen_single = set()
    for t, name in enumerate(order):
        pairs, names = out[name]
        w = writers[0] if single_out else writers[t]
        for (c1, c2), nm in zip(pairs, names):
            if single_out:
                if nm in seen_single:
                    continue
                seen_single.add(nm)
            fastx.write_fastq(w, fastx.Read(nm + "/1", c1))
            if c2 is not None:
                fastx.write_fastq(w, fastx.Read(nm + "/2", c2))
    for w in writers:
        w.close()
    return 0
