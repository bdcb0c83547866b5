"""Per-stage wall clock of the alignment pipeline on one genome pair.

    python -m gsalign_tpu_torch.tools.profile_pipeline [DIR] [--device cuda|cpu]

DIR holds ref.fa and qry.fa. Without it the tool reads the 4.6 Mb pair
that the port's bench writes (gsalign_tpu_torch/bench.py: ecoli_4.6mb
under its BENCH_DIR), and makes the pair where it is missing. The index
DIR/ref_idx is built and saved where it is missing. --device cuda (the
default) raises without a card.

One warm-up run, then PROF_REPS (default 2) timed runs of the pipeline's
per-chromosome stages on one thread, in compare_genomes' order: seed
(ops/seeding.find_seeds), chain (chain.generate_alignment_blocks), blocks
(overlap repair, gap and chromosome-span splits, dedup, gap fill), gen
(plan_alignments, ops/dp.align_fragments, finish_alignments), filter,
maf, vars, and vcf once a run. Each timed run prints one line of
`stage=seconds` and TOTAL. Every mark falls after the stage's results are
on the host, and on the card after torch.cuda.synchronize(), so no stage's
device time lands in the next. Writes DIR/prof.maf and DIR/prof.vcf.
"""

from __future__ import annotations

import argparse
import os
import time

from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.genome.coords import ChrLocIndex, gen_coordinate_info
from gsalign_tpu_torch.genome.fasta import read_fasta
from gsalign_tpu_torch.genome.packing import chars_to_codes, pack_genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.index.io import index_loadable, load_index, save_index
from gsalign_tpu_torch.ops import dp as dp_ops
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from gsalign_tpu_torch.ops.seeding import find_seeds
from gsalign_tpu_torch.pipeline import blocks as blk_ops
from gsalign_tpu_torch.pipeline import chain
from gsalign_tpu_torch.pipeline.generate import (finish_alignments,
                                                 plan_alignments)
from gsalign_tpu_torch.pipeline.output import write_maf
from gsalign_tpu_torch.pipeline.variants import (VariantCollector,
                                                 identify_variants, write_vcf)
from gsalign_tpu_torch.utils.device import resolve_device

STAGES = ("seed", "chain", "blocks", "gen", "filter", "maf", "vars", "vcf")


def default_dir() -> str:
    """The bench's 4.6 Mb pair, made where it is missing."""
    from gsalign_tpu_torch.bench import BENCH_DIR, ensure_data
    d = os.path.join(BENCH_DIR, "ecoli_4.6mb")
    ensure_data(d, 4_600_000)
    return d


def load_or_build(d: str):
    prefix = os.path.join(d, "ref_idx")
    if index_loadable(prefix):
        return load_index(prefix)
    fm = build_fmindex(pack_genome(read_fasta(os.path.join(d, "ref.fa"))))
    save_index(fm, prefix)
    return fm


def profile(d: str, device, reps: int) -> list:
    """A warm-up run and `reps` timed runs on the pair in d; returns the
    timed runs' {stage: seconds}, each also printed as one line."""
    import torch
    fm = load_or_build(d)
    qry_records = read_fasta(os.path.join(d, "qry.fa"))
    genome = fm.genome
    cfg = AlignConfig()
    chr_index = ChrLocIndex(genome)
    ref_chars = genome.chars_fwd_rc()
    ref_codes = genome.codes_fwd_rc()
    dfm = DeviceFMIndex.from_host(fm, device)

    def run():
        T = {}

        def mark(k, t0):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            T[k] = T.get(k, 0.0) + time.time() - t0
            return time.time()
        collector = VariantCollector()
        first = True
        for name, qry in qry_records:
            t0 = time.time()
            qc = chars_to_codes(qry)
            q_pos, r_pos, length = find_seeds(
                dfm, qc, min_seed_length=cfg.min_seed_length,
                chunk=cfg.seed_exploration_chunk)
            t0 = mark("seed", t0)
            blocks = chain.generate_alignment_blocks(q_pos, r_pos, length,
                                                     cfg, genome.size)
            t0 = mark("chain", t0)
            for b in blocks:
                blk_ops.remove_overlaps(b)
            nb = []
            for b in blocks:
                s = blk_ops.check_gaps_between_seeds(b, qry, ref_chars, cfg)
                nb.extend([b] if s is None else s)
            blocks = blk_ops.remove_bad_blocks(nb)
            nb = []
            for b in blocks:
                s = blk_ops.check_span_multiple_chrs(b, chr_index, cfg)
                nb.extend([b] if s is None else s)
            blocks = blk_ops.remove_bad_blocks(nb)
            for b in blocks:
                b.b_dup = False
            cs = blk_ops.est_chromosome_similarity(blocks, chr_index)
            blocks = blk_ops.remove_redundant_blocks(blocks, cs, chr_index,
                                                     cfg, 1)
            blocks = blk_ops.remove_redundant_blocks(blocks, cs, chr_index,
                                                     cfg, 2)
            for b in blocks:
                if b.score > 0:
                    blk_ops.fill_block_gaps(b)
            t0 = mark("blocks", t0)
            jobs, rf, qf = plan_alignments(blocks, qry, ref_chars,
                                           ref_codes=ref_codes, qry_codes=qc)
            ops_list = []
            if jobs:
                ops_list = dp_ops.align_fragments(
                    rf, qf, bucket_sizes=cfg.dp_buckets,
                    batch_cells=cfg.dp_batch_cells, device=device)
            finish_alignments(blocks, jobs, ops_list, qry, ref_chars)
            t0 = mark("gen", t0)
            for b in blocks:
                if b.aln_len == 0 or \
                        int(100 * (b.score / b.aln_len)) < cfg.min_seq_idy:
                    b.score = 0
                else:
                    b.coor = gen_coordinate_info(chr_index, int(b.r_pos[0]))
            blocks = blk_ops.remove_bad_blocks(blocks)
            t0 = mark("filter", t0)
            write_maf(os.path.join(d, "prof.maf"), blocks, name, qry,
                      chr_index, first, True)
            first = False
            t0 = mark("maf", t0)
            identify_variants(blocks, qry, ref_chars, chr_index, collector,
                              ref_codes=ref_codes, qry_codes=qc)
            t0 = mark("vars", t0)
        t0 = time.time()
        write_vcf(os.path.join(d, "prof.vcf"), collector, genome.names,
                  genome.lengths, "x")
        mark("vcf", t0)
        return T

    run()                                  # warm-up
    out = []
    for _ in range(reps):
        T = run()
        print(" ".join(f"{k}={v:.2f}" for k, v in T.items()),
              f"TOTAL={sum(T.values()):.2f}", flush=True)
        out.append(T)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.profile_pipeline",
        description="Per-stage wall clock of the alignment pipeline.")
    ap.add_argument("dir", nargs="?", default=None,
                    help="directory of ref.fa and qry.fa (default: the "
                         "bench's 4.6 Mb pair)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    profile(args.dir or default_dir(), device,
            int(os.environ.get("PROF_REPS", "2")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
