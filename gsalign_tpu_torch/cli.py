"""Command-line interface.

Flag-compatible with the reference binary (src/main.cpp:198-334) and with
the JAX package's CLI:

    gsalign-tpu-torch index ref.fa prefix
    gsalign-tpu-torch [-i prefix | -r ref.fa] -q query.fa -o out [options]

The device comes from GSALIGN_PLATFORM: "cuda" (the default; an error when
no CUDA device is present) or "cpu". -resume, a multi-process job (the
environment's WORLD_SIZE > 1; see join_process_group) and -t > 1 with
several query chromosomes run through parallel/distributed.run_distributed.
On a host with more than one visible card the seed lanes and the DP
problems are split over all of them (parallel/mesh.local_mesh); no flag
asks for it, as in the JAX CLI.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

from gsalign_tpu_torch.config import AlignConfig


def select_device():
    """The torch device named by GSALIGN_PLATFORM (cpu | cuda); unset means
    cuda, which raises without a card (utils/device.resolve_device)."""
    from gsalign_tpu_torch.utils.device import resolve_device
    plat = os.environ.get("GSALIGN_PLATFORM", "cuda")
    if plat not in ("cpu", "cuda"):
        raise ValueError(f"GSALIGN_PLATFORM must be cpu or cuda, got {plat!r}")
    return resolve_device("cpu" if plat == "cpu" else None)


def join_process_group():
    """Join the torch.distributed job that the environment names, as
    torchrun and similar launchers name it (WORLD_SIZE > 1, RANK,
    MASTER_ADDR, MASTER_PORT), with the gloo backend: the processes
    exchange only barriers (parallel/distributed.py). Nothing without
    WORLD_SIZE > 1, or when a group is already initialised."""
    import torch.distributed as dist
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
            not dist.is_initialized():
        dist.init_process_group("gloo", init_method="env://")


def show_usage(prog: str, cfg: AlignConfig):
    print(f"""
GSAlign-TPU (torch) v0.1
Usage: {prog} [-i IndexFile Prefix / -r Reference file] -q QueryFile[Fasta]

Options: -t     INT     number of threads [{cfg.thread_num}]
         -o     STR     Set the prefix of the output files [output]
         -fmt   INT     Set the output format 1:maf, 2:aln [{cfg.output_format}]
         -idy   INT     Set the minimal sequence identity (0-100) of a local alignment [{cfg.min_seq_idy}]
         -slen  INT     Set the minimal seed length [{cfg.min_seed_length}]
         -alen  INT     Set the minimal alignment length [{cfg.min_aln_length}]
         -ind   INT     Set the maximal indel size [{cfg.max_indel_size}]
         -clr   INT     Set the minimal cluster size [{cfg.min_aln_block_score}]
         -unique        Output unique alignment only [false]
         -resume        Restartable run (skip per-chromosome shards already committed)
         -sen           Sensitive mode [False]
         -dp            Output Dot-plots
         -one           set one on one alignment mode[false]
""", file=sys.stderr)


def build_index_cmd(fa: str, prefix: str) -> int:
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    from gsalign_tpu_torch.index.io import save_index

    t0 = time.time()
    records = read_fasta(fa)
    genome = pack_genome(records)
    print(f"[bwt_index] packed {genome.size} bases "
          f"({genome.n_chr} sequences), {time.time()-t0:.1f}s", file=sys.stderr)
    fm = build_fmindex(genome)
    save_index(fm, prefix)
    print(f"[bwt_index] index written to {prefix}.npz "
          f"({time.time()-t0:.1f}s total)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "gsalign-tpu-torch"
    args = argv[1:]
    cfg = AlignConfig()

    if not args or args[0] == "-h":
        show_usage(prog, cfg)
        return 0
    if args[0] == "index":
        if len(args) == 3:
            return build_index_cmd(args[1], args[2])
        print(f"usage: {prog} index ref.fa prefix", file=sys.stderr)
        return 1
    if args[0] == "import":
        # convert a reference GSAlign/BWA five-file index (.pac/.ann/.amb/
        # .bwt/.sa, src/bwt_index.cpp:15-147) to our artifact
        if len(args) == 3:
            from gsalign_tpu_torch.index.bwa_import import import_bwa_index
            from gsalign_tpu_torch.index.io import save_index
            t0 = time.time()
            fm = import_bwa_index(args[1])
            save_index(fm, args[2])
            print(f"[import] {args[1]}.pac/.ann/.amb -> {args[2]}.npz "
                  f"({time.time()-t0:.1f}s)", file=sys.stderr)
            return 0
        print(f"usage: {prog} import bwa_prefix out_prefix", file=sys.stderr)
        return 1

    index_prefix = ref_file = query_file = None
    output_prefix = "output"
    resume = False
    updates = {}
    i = 0
    while i < len(args):
        a = args[i]

        def nxt():
            nonlocal i
            i += 1
            return args[i]

        if a == "-i":
            index_prefix = nxt()
        elif a == "-r":
            ref_file = nxt()
        elif a == "-q":
            query_file = nxt()
        elif a == "-t":
            updates["thread_num"] = max(1, int(nxt()))
        elif a == "-slen":
            v = int(nxt())
            if v < 10 or v > 30:
                print("Warning! minimal seed length is between 10~30!",
                      file=sys.stderr)
                return 1
            updates["min_seed_length"] = v
        elif a == "-ind":
            v = int(nxt())
            if v < 10 or v > 100:
                print("Warning! maximal indel size is between 10~100!",
                      file=sys.stderr)
                return 1
            updates["max_indel_size"] = v
        elif a in ("-sen", "-sensitive"):
            updates["sensitive"] = True
        elif a == "-resume":
            resume = True
        elif a == "-unique":
            updates["allow_duplication"] = False
        elif a == "-no_vcf":
            updates["emit_vcf"] = False
        elif a == "-one":
            updates["one_on_one"] = True
        elif a == "-idy":
            updates["min_seq_idy"] = int(nxt())
        elif a == "-alen":
            updates["min_aln_length"] = int(nxt())
        elif a == "-clr":
            updates["min_aln_block_score"] = int(nxt())
        elif a == "-dp":
            updates["show_plot"] = True
        elif a == "-fmt":
            # the reference parses -fmt unchecked (src/main.cpp:286) and a
            # value outside {1,2} silently writes no alignment file
            # (src/main.cpp:146-151); fail loudly instead
            v = int(nxt())
            if v not in (1, 2):
                print("Warning! Output format should be 1 (maf) or 2 (aln)!",
                      file=sys.stderr)
                return 1
            updates["output_format"] = v
        elif a == "-o":
            output_prefix = nxt()
        elif a == "-gp":
            updates["gnuplot_path"] = nxt()
        elif a in ("-d", "-debug"):
            updates["debug"] = True
        elif a == "-obr":
            updates["obr_pos"] = int(nxt())
        else:
            print(f"Warning! Unknown parameter: {a}", file=sys.stderr)
        i += 1

    cfg = dataclasses.replace(cfg, **updates)
    if (index_prefix is None and ref_file is None) or query_file is None:
        show_usage(prog, cfg)
        return 0
    device = select_device()
    join_process_group()

    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    from gsalign_tpu_torch.index.io import index_exists, load_index, save_index
    from gsalign_tpu_torch.pipeline.align import compare_genomes

    print("Step1. Load the two genome sequences...", file=sys.stderr)
    query_records = read_fasta(query_file)
    print(f"\tLoad the query sequences ({len(query_records)} "
          f"{'chromosomes' if len(query_records) > 1 else 'chromosome'})",
          file=sys.stderr)

    fm = None
    if index_prefix is not None and index_exists(index_prefix):
        try:
            fm = load_index(index_prefix)
        except (ValueError, KeyError) as e:
            print(f"Index at {index_prefix} is unreadable ({e}); "
                  f"{'rebuilding from -r' if ref_file else 'aborting'}",
                  file=sys.stderr)
            if ref_file is None:
                return 1
    elif index_prefix is not None and \
            os.path.exists(index_prefix + ".pac") and \
            os.path.exists(index_prefix + ".ann"):
        # -i pointed at a reference GSAlign/BWA five-file index: import it
        # transparently (the reference's bwa_idx_load path,
        # src/main.cpp:306 -> src/bwt_index.cpp:147)
        from gsalign_tpu_torch.index.bwa_import import import_bwa_index
        print(f"Importing BWA-format index at {index_prefix}...",
              file=sys.stderr)
        fm = import_bwa_index(index_prefix, threads=cfg.thread_num)
    if fm is None:
        if ref_file is None:
            print("Please specify a valid reference genome", file=sys.stderr)
            return 1
        prefix = os.path.splitext(ref_file)[0] or ref_file
        fm = build_fmindex(pack_genome(read_fasta(ref_file)),
                           threads=cfg.thread_num)
        save_index(fm, prefix)

    from gsalign_tpu_torch.parallel.distributed import world
    from gsalign_tpu_torch.parallel.mesh import local_mesh
    # a host with several cards: seed lanes and DP problems over all of
    # them (the outputs are byte-identical for any number)
    mesh = local_mesh(device)
    if resume or world()[1] > 1 or \
            (cfg.thread_num > 1 and len(query_records) > 1):
        # restartable / multi-process / threaded path: per-chromosome
        # shards with atomic commit markers, deterministic merge
        from gsalign_tpu_torch.parallel.distributed import run_distributed
        run_distributed(fm, query_records, cfg, output_prefix,
                        resume=resume, device=device, mesh=mesh)
    else:
        compare_genomes(fm, query_records, cfg, output_prefix=output_prefix,
                        device=device, mesh=mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
