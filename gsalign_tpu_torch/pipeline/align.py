"""Top-level genome comparison pipeline.

Equivalent of GenomeComparison (src/GSAlign.cpp:473-552): per query
chromosome, run seeding -> grouping/chaining -> overlap repair -> gap split
-> chromosome-span split -> dedup -> gap fill -> alignment generation ->
identity filter -> output. The reference's per-stage pthread barriers map to
whole-array device launches here (torch tensors on an explicit device);
stage order and all filters are preserved.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np

from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.genome.coords import ChrLocIndex, gen_coordinate_info
from gsalign_tpu_torch.genome.packing import chars_to_codes
from gsalign_tpu_torch.index.fmindex import FMIndex
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from gsalign_tpu_torch.ops.seeding import find_seeds_all
from gsalign_tpu_torch.pipeline import blocks as blk_ops
from gsalign_tpu_torch.pipeline import chain
from gsalign_tpu_torch.ops import dp as dp_ops
from gsalign_tpu_torch.pipeline.generate import (finish_alignments,
                                                 plan_alignments)
from gsalign_tpu_torch.pipeline.output import (write_aln, write_dotplot,
                                               write_maf)
from gsalign_tpu_torch.pipeline.variants import (VariantCollector,
                                                 identify_variants, write_vcf)
from gsalign_tpu_torch.utils.device import resolve_device
from gsalign_tpu_torch.utils.trace import Laps, StageTimer, device_trace


@dataclasses.dataclass
class RunStats:
    local_alignment_num: int = 0
    total_alignment_length: int = 0
    total_alignment_matches: int = 0
    dup_aln_num: int = 0
    stage_times: dict = dataclasses.field(default_factory=dict)
    # compare_genomes' timeline in consecutive spans (utils/trace.Laps),
    # the time outside the stages included
    span_times: dict = dataclasses.field(default_factory=dict)
    seed_scan_iterations: list = dataclasses.field(default_factory=list)
    seed_scan_launches: list = dataclasses.field(default_factory=list)

    @property
    def ani(self) -> float:
        if self.total_alignment_length == 0:
            return 0.0
        return 100.0 * self.total_alignment_matches / self.total_alignment_length


@dataclasses.dataclass
class ChromosomeResult:
    name: str
    blocks: list
    n_alignments: int
    aln_len: int
    aln_score: int


def log(msg: str, verbose: bool = True):
    if verbose:
        print(msg, file=sys.stderr, flush=True)


def debug_dump_blocks(blocks, chr_index: ChrLocIndex, obr_pos: int = -1):
    """-d / -obr dump: chained block boundaries and FragPairs.

    Equivalent of the reference's ShowAlnBlockBoundary / ShowFragPair
    printers (src/tools.cpp:79-118 — parsed but dead in v1.0.22; live
    here). With obr_pos >= 0, only blocks whose reference span covers that
    position are dumped (the observation hook sketched at
    src/GSAlign.cpp:456)."""
    for b in blocks:
        if b.n == 0:
            continue
        q1, q2 = int(b.q_pos[0]), int(b.q_pos[-1] + b.q_len[-1] - 1)
        r1, r2 = int(b.r_pos[0]), int(b.r_pos[-1] + b.r_len[-1] - 1)
        if obr_pos >= 0 and not (r1 <= obr_pos <= r2):
            continue
        chr_idx = int(chr_index.chr_of(np.asarray([r1]))[0])
        name = chr_index.genome.names[chr_idx]
        print(f"AlnBlockBoundary Q[{q1}-{q2}] R[{r1}-{r2}] chr={name} "
              f"score = {b.score} size = {q2 - q1 + 1}")
        if r2 - r1 < 100 or obr_pos >= 0:
            print(f"FragPairVec (N={b.n})")
            for i in range(b.n):
                pd = int(b.r_pos[i]) - int(b.q_pos[i])
                print(f"q[{int(b.q_pos[i])}-{int(b.q_pos[i] + b.q_len[i] - 1)}] "
                      f"r[{int(b.r_pos[i])}-{int(b.r_pos[i] + b.r_len[i] - 1)}] "
                      f"L:{int(b.q_len[i])} D:{pd} ")
            print("End\n")


def chain_blocks(q_pos, r_pos, length, qry_chars, ref_chars, chr_index,
                 genome_size: int, cfg: AlignConfig) -> list:
    """The chain stages of one query chromosome: its seeds grouped and
    chained into blocks, overlaps repaired, blocks split at long gaps and
    at chromosome spans, deduplicated, and their gaps filled."""
    # S2+S3: grouping + chaining
    blocks = chain.generate_alignment_blocks(
        q_pos, r_pos, length, cfg, genome_size)

    # S4: overlap repair
    for b in blocks:
        blk_ops.remove_overlaps(b)

    # S5: gap splitting
    new_blocks = []
    for b in blocks:
        subs = blk_ops.check_gaps_between_seeds(b, qry_chars, ref_chars,
                                                cfg)
        if subs is None:
            new_blocks.append(b)
        else:
            new_blocks.extend(subs)
    blocks = blk_ops.remove_bad_blocks(new_blocks)

    # S6: chromosome-span splitting
    new_blocks = []
    for b in blocks:
        subs = blk_ops.check_span_multiple_chrs(b, chr_index, cfg)
        if subs is None:
            new_blocks.append(b)
        else:
            new_blocks.extend(subs)
    blocks = blk_ops.remove_bad_blocks(new_blocks)

    # S7: dedup
    for b in blocks:
        b.b_dup = False
    chr_scores = blk_ops.est_chromosome_similarity(blocks, chr_index)
    blocks = blk_ops.remove_redundant_blocks(blocks, chr_scores, chr_index,
                                             cfg, axis=1)
    blocks = blk_ops.remove_redundant_blocks(blocks, chr_scores, chr_index,
                                             cfg, axis=2)

    # S8: gap fill
    for b in blocks:
        if b.score > 0:
            blk_ops.fill_block_gaps(b)
    return blocks


def compare_genomes(fm: FMIndex,
                    query_records: List,
                    cfg: AlignConfig,
                    output_prefix: Optional[str] = None,
                    verbose: bool = True,
                    device=None,
                    write_vcf_file: bool = True,
                    plot_prefix: Optional[str] = None,
                    mesh=None,
                    shard_index_rows: bool = False,
                    seed_rounds: Optional[list] = None):
    """Run the full comparison. query_records: [(name, ascii uint8[]), ...].

    With a mesh (parallel/mesh.Mesh) the seed lanes and the DP problems are
    split over its entries, whose first is the device (a `device` that
    names another raises); with shard_index_rows too, the index's t3 and
    sa_samples rows are cut over the entries instead and the seed lanes
    stay whole (mesh.shard_index_rows). The outputs are byte-identical for
    any mesh.

    seed_rounds, a list, receives the seed scan's rounds (find_seeds_all's
    `rounds` hook): the lanes, their final state and their records.

    The two batched device stages — the seed scan and the gap DP — run on
    `device`: the CUDA card when None (an error without one), the CPU for
    "cpu"; everything else is host numpy. On a CUDA device the DP runs in the hand-written kernels
    (ops/dp_cuda.py), on the CPU in their plain torch version. The pass-2 worker threads run host code only: no kernel is
    launched from them.

    write_vcf_file=False leaves `{output_prefix}.vcf` unwritten (the
    variants stay in the returned collector): parallel/distributed writes
    one VCF after merging every shard's collector. Dot-plots go to
    plot_prefix (default output_prefix), so a shard's plots keep the
    user's prefix.

    Returns (RunStats, VariantCollector, [ChromosomeResult]).
    """
    cfg = cfg.effective()
    if mesh is not None:
        from gsalign_tpu_torch.parallel import mesh as mesh_lib
        first = mesh.devices[0]
        if device is not None and mesh_lib.indexed_device(device) != first:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"entry {first}")
        device = first
    device = resolve_device(device)
    # the run's timeline in spans (RunStats.span_times), the time outside
    # the stages included; each lap names the work since the one before
    laps = Laps()
    genome = fm.genome
    chr_index = ChrLocIndex(genome)
    laps.lap("setup")
    ref_chars = genome.chars_fwd_rc()
    laps.lap("chars_fwd_rc")
    dfm = DeviceFMIndex.from_host(fm, device)
    if shard_index_rows and mesh is not None:
        dfm = mesh_lib.shard_index_rows(dfm, mesh)
    laps.lap("from_host")
    stats = RunStats()
    timer = StageTimer()
    collector = VariantCollector()
    results: List[ChromosomeResult] = []
    t0 = time.time()

    maf_path = f"{output_prefix}.maf" if output_prefix else None
    aln_path = f"{output_prefix}.aln" if output_prefix else None

    log("Step2. Sequence analysis for all query chromosomes", verbose)
    # S1: seeding — every chromosome's chunk lanes in ONE device scan
    # (the reference seeds per chromosome with thread chunks,
    # src/GSAlign.cpp:483-493; lane stops make the results identical)
    qcodes_list = [chars_to_codes(q) for _, q in query_records]
    ref_codes_full = genome.codes_fwd_rc()
    if output_prefix and cfg.output_format == 1:
        # pre-fault MAF row buffers on a background thread WHILE the
        # device seeds: the kernel's first-touch page zeroing of the
        # ~chromosome-sized rows then overlaps device wait instead of
        # serializing into the output stage (2 rows per in-flight
        # chromosome, sized with indel slack)
        import threading
        from gsalign_tpu_torch.utils import bufpool
        n_flight = min(len(query_records), max(1, cfg.thread_num))
        sizes = sorted((len(q) for _, q in query_records), reverse=True)
        want = [int(s * 1.08) for s in sizes[:n_flight] for _ in (0, 1)]
        threading.Thread(target=bufpool.prime, args=(want,),
                         daemon=True).start()
    laps.lap("query_codes")
    seed_stats: dict = {}
    with device_trace(), timer.stage("seed"):
        all_seeds = find_seeds_all(
            dfm, qcodes_list,
            min_seed_length=cfg.min_seed_length,
            max_seed_freq=cfg.max_seed_freq,
            sensitive=cfg.sensitive,
            chunk=cfg.seed_exploration_chunk,
            stats=seed_stats, mesh=mesh, fm=fm, rounds=seed_rounds)
    stats.seed_scan_iterations = seed_stats["scan_iterations"]
    stats.seed_scan_launches = seed_stats["scan_launches"]
    log(f"\t[seed] {seed_stats['scan_lanes']} lanes, scan iterations per "
        f"round: {seed_stats['scan_iterations']}", verbose)
    laps.lap("seed")

    # Pass 1 (host): chain stages + DP-pair planning per chromosome. DP
    # fragments stream into an incremental aligner: full buckets DISPATCH
    # while later chromosomes are still chaining on host (device/host
    # overlap), partial buckets POOL across chromosomes, and ALL results
    # arrive in one device->host copy.
    aligner = dp_ops.FragmentAligner(
        bucket_sizes=cfg.dp_buckets, batch_cells=cfg.dp_batch_cells,
        device=device, mesh=mesh)
    planned = []                   # (qname, qry_chars, blocks, jobs, lo, hi)
    for qc_idx, (qname, qry_chars) in enumerate(query_records):
        log(f"\tProcess query chromosome: {qname}...", verbose)
        q_pos, r_pos, length = all_seeds[qc_idx]

        with timer.stage("chain"):
            blocks = chain_blocks(q_pos, r_pos, length, qry_chars,
                                  ref_chars, chr_index, genome.size, cfg)

        if cfg.debug or cfg.obr_pos >= 0:
            debug_dump_blocks(blocks, chr_index, cfg.obr_pos)

        # S9a: classify pairs, submit this chromosome's DP fragments (full
        # buckets start on device now, behind the next chromosome's chain)
        with timer.stage("align"):
            jobs, rf, qf = plan_alignments(
                blocks, qry_chars, ref_chars,
                ref_codes=ref_codes_full, qry_codes=qcodes_list[qc_idx])
            lo = aligner.submit(rf, qf)
            planned.append((qname, qry_chars, qcodes_list[qc_idx], blocks,
                            jobs, lo, lo + len(rf)))

    laps.lap("pass1")
    # S9b: launch leftover partial buckets, ONE copy for every
    # chromosome's gap fragments
    with device_trace(), timer.stage("align"):
        ops_all = aligner.finish()
    laps.lap("dp_finish")

    # Pass 2 (host): expand alignments, filter, emit — chromosome order.
    # The heavy per-chromosome work (alignment expansion, MAF row
    # assembly incl. the clip mutations, variant identification into a
    # PRIVATE collector) is independent across chromosomes, so with
    # -t > 1 it runs on a thread pool (the reference stripes every stage
    # over pthreads, src/GSAlign.cpp:492-526); the main thread then
    # consumes results IN CHROMOSOME ORDER — file chunks are submitted to
    # the ordered sink and private collectors merge via merge_from, so
    # the output bytes and variant emission order are identical to the
    # serial path. MAF disk writes
    # still go through the background sink thread. The workers run host
    # code only; every device launch happened above, on this thread.
    from gsalign_tpu_torch.pipeline.output import AsyncSink, assemble_maf_chunks
    sink = AsyncSink() if (output_prefix and cfg.output_format == 1) \
        else None

    def pass2_work(item):
        qname, qry_chars, qry_codes, blocks, jobs, lo, hi = item
        with timer.stage("align"):
            finish_alignments(blocks, jobs, ops_all[lo:hi], qry_chars,
                              ref_chars)
        # identity filter + stats (src/GSAlign.cpp:528-541)
        n = 0
        aln_len_sum = 0
        aln_score_sum = 0
        dup_n = 0
        for b in blocks:
            if b.aln_len == 0 or \
                    int(100 * (b.score / b.aln_len)) < cfg.min_seq_idy:
                b.score = 0
            else:
                if b.b_dup:
                    dup_n += 1
                n += 1
                aln_len_sum += b.aln_len
                aln_score_sum += b.score
                b.coor = gen_coordinate_info(chr_index, int(b.r_pos[0]))
        blocks = blk_ops.remove_bad_blocks(blocks)
        chunks = private = None
        if n:
            # assembly clips blocks in place, so it runs before variant
            # identification, same as the reference ordering
            if output_prefix and cfg.output_format == 1:
                with timer.stage("output"):
                    chunks = assemble_maf_chunks(
                        blocks, qname, qry_chars, chr_index,
                        cfg.allow_duplication)
            if cfg.emit_vcf and cfg.output_format != 2:
                with timer.stage("variants"):
                    private = VariantCollector()
                    identify_variants(blocks, qry_chars, ref_chars,
                                      chr_index, private,
                                      ref_codes=ref_codes_full,
                                      qry_codes=qry_codes)
        return (qname, qry_chars, qry_codes, blocks, n, aln_len_sum,
                aln_score_sum, dup_n, chunks, private)

    n_workers = min(len(planned), max(1, cfg.thread_num))
    if n_workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=n_workers)
        outcomes = list(pool.map(pass2_work, planned))
        pool.shutdown()
    else:
        outcomes = map(pass2_work, planned)
    laps.lap("pass2")     # one thread: the work runs lazily inside "emit"

    first_out = True
    for (qname, qry_chars, qry_codes, blocks, n, aln_len_sum,
         aln_score_sum, dup_n, chunks, private) in outcomes:
        if n == 0:
            continue
        stats.dup_aln_num += dup_n
        stats.local_alignment_num += n
        stats.total_alignment_length += aln_len_sum
        stats.total_alignment_matches += aln_score_sum
        log(f"\t\tProduce {n} local alignments (length = {aln_len_sum}), "
            f"ANI={100.0 * aln_score_sum / aln_len_sum:.2f}%", verbose)

        if output_prefix:
            with timer.stage("output"):
                if cfg.output_format == 1:
                    write_maf(maf_path, blocks, qname, qry_chars, chr_index,
                              first_out, cfg.allow_duplication, sink=sink,
                              chunks=chunks)
                elif cfg.output_format == 2:
                    write_aln(aln_path, blocks, qname, qry_chars, chr_index,
                              first_out, cfg.allow_duplication)
            first_out = False
        if cfg.emit_vcf:
            with timer.stage("variants"):
                if private is not None:
                    collector.merge_from(private)
                else:
                    identify_variants(blocks, qry_chars, ref_chars,
                                      chr_index, collector,
                                      ref_codes=ref_codes_full,
                                      qry_codes=qry_codes)
        if cfg.show_plot and output_prefix:
            # under sharded runs the dotplot keeps the user-facing prefix
            # (the reference writes {prefix}.gp / {prefix}-{qname}.ps,
            # src/DotPloting.cpp:47-49, regardless of worker)
            write_dotplot(plot_prefix or output_prefix, qname, blocks,
                          chr_index, gnuplot_path=cfg.gnuplot_path)

        results.append(ChromosomeResult(qname, blocks, n, aln_len_sum,
                                        aln_score_sum))

    laps.lap("emit")
    # VCF formatting runs WHILE the sink thread drains the residual MAF
    # disk writes (independent files) — the close() join then returns
    # almost immediately instead of serializing ~0.7 s + ~0.9 s tails.
    try:
        if cfg.emit_vcf and output_prefix and write_vcf_file:
            with timer.stage("variants"):
                write_vcf(f"{output_prefix}.vcf", collector, genome.names,
                          genome.lengths, reference_name=output_prefix)
    finally:
        if sink is not None:
            with timer.stage("output"):   # residual non-overlapped disk time
                sink.close()
    if stats.local_alignment_num > 0:
        log(f"\tAlignment#={stats.local_alignment_num} "
            f"(total alignment length={stats.total_alignment_length}) "
            f"ANI={stats.ani:.2f}%, unique alignment#="
            f"{stats.local_alignment_num - stats.dup_aln_num}", verbose)
    laps.lap("vcf_close")
    stats.stage_times = dict(timer.totals)
    stats.span_times = dict(laps.spans)
    log(f"\t[stages] {timer.report()}", verbose)
    log(f"\tIt took {int(time.time() - t0)} seconds for genome sequence "
        f"alignment.", verbose)

    if cfg.emit_vcf and output_prefix and write_vcf_file:
        log(f"\nGSAlign identifies {collector.n_snv} SNVs, "
            f"{collector.n_ins} insertions, and {collector.n_del} deletions "
            f"[{output_prefix}.vcf].", verbose)
    return stats, collector, results
