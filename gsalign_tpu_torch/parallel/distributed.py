"""Restartable and multi-process runs: per-chromosome shards and a merge.

The reference is strictly single-node (pthreads + one mutex,
src/GSAlign.cpp:8,492-526). Here query chromosomes are partitioned
round-robin across the processes of a torch.distributed job, each process
runs the full per-chromosome pipeline on its device, and process 0 merges
the per-chromosome output shards deterministically: the merged MAF/ALN/VCF
are byte-identical to a one-process run for any process count (the JAX
package's parallel/distributed.py, with the same semantics).

Shard exchange rides the job's shared filesystem (per-chromosome MAF/ALN
shards plus pickled variant collectors and stats). The barrier between
shard production and the merge is torch.distributed.barrier() on a gloo
group: it carries control only, so it also works with several processes
on one card, where NCCL refuses two ranks on one device.

Usage (per process):
    torch.distributed.init_process_group("gloo", init_method=...,
                                         world_size=W, rank=R)
    run_distributed(fm, query_records, cfg, output_prefix)
Without an initialised process group the run is one process (rank 0 of 1).
"""

from __future__ import annotations

import os
import pickle
from typing import List


def world():
    """(rank, world size) of the torch.distributed job, or (0, 1) when no
    process group is initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _control_group():
    """The process group the barriers run on: the default group when it
    is gloo, else a gloo group over the same processes (made by every
    process, as new_group requires). None without a job."""
    import torch.distributed as dist
    if world()[1] == 1:
        return None
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    return dist.new_group(backend="gloo")


def _barrier(group) -> None:
    if group is not None:
        import torch.distributed as dist
        dist.barrier(group=group)


def run_distributed(fm, query_records: List, cfg, output_prefix: str,
                    verbose: bool = True, resume: bool = False,
                    device=None, mesh=None):
    """Distributed compare_genomes: returns (stats, collector, results)
    on process 0 and (local stats, None, local results) elsewhere.

    Chromosome ci is processed by process (ci mod world size); each
    produces `{output_prefix}.part{ci}` shards merged by process 0 in
    chromosome order, reproducing the one-process emission order exactly
    (variant sequence numbers are offset per shard, see
    VariantCollector.merge_from). device and mesh are compare_genomes'
    (device None: the CUDA card); with no mesh given, a run on a card builds
    one over every card where more than one is visible
    (parallel/mesh.local_mesh), as the JAX package meshes its local
    devices.

    resume=True makes the run restartable (the per-fragment resumability
    the reference lacks; its appended outputs are corrupt after a crash,
    src/tools.cpp:158-163): each chromosome's shard is committed by an
    atomic rename of its .pkl marker AFTER the output shard is complete,
    so a restart recomputes only chromosomes without a marker and the
    final merge is byte-identical to an uninterrupted run. The marker holds
    numpy arrays and Python objects only (RunStats, VariantCollector), so
    any process can load it, with or without a card.
    """
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    from gsalign_tpu_torch.pipeline import align as align_mod
    from gsalign_tpu_torch.pipeline.variants import VariantCollector, write_vcf
    from gsalign_tpu_torch.utils.device import resolve_device

    if mesh is None:
        mesh = mesh_lib.local_mesh(resolve_device(device))
    pid, nproc = world()
    group = _control_group()
    cfg = cfg.effective()
    my_results = []
    my_stats = align_mod.RunStats()
    ext = ".maf" if cfg.output_format == 1 else ".aln"
    owned = [ci for ci in range(len(query_records)) if ci % nproc == pid]

    def run_one(ci: int):
        part = f"{output_prefix}.part{ci}"
        if resume and os.path.exists(part + ".pkl"):
            with open(part + ".pkl", "rb") as fh:
                st, _ = pickle.load(fh)
            # the marker commits AFTER the shard: presence of the .pkl
            # guarantees the shard (absent only for 0-alignment chromosomes)
            if os.path.exists(part + ext) or st.local_alignment_num == 0:
                return st, []
        st, coll, res = align_mod.compare_genomes(
            fm, [query_records[ci]], cfg, output_prefix=part,
            verbose=verbose, device=device, write_vcf_file=False,
            plot_prefix=output_prefix, mesh=mesh)
        with open(part + ".pkl.tmp", "wb") as fh:
            pickle.dump((st, coll), fh)
        os.replace(part + ".pkl.tmp", part + ".pkl")       # commit marker
        return st, res

    # host-side chromosome threading (the reference's -t maps to pthread
    # stage workers, src/GSAlign.cpp:492-526): threads overlap one
    # chromosome's host stages with another's device stages. Every thread
    # launches on the device's current stream, or on the mesh's streams
    # (made with the mesh), which they share, so the launches of a stream
    # run one after another on the card; outputs merge by index.
    n_workers = min(max(1, cfg.thread_num), max(1, len(owned)))
    if n_workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(n_workers) as pool:
            outs = list(pool.map(run_one, owned))
    else:
        outs = [run_one(ci) for ci in owned]
    for st, res in outs:
        my_results.extend(res)
        my_stats.local_alignment_num += st.local_alignment_num
        my_stats.total_alignment_length += st.total_alignment_length
        my_stats.total_alignment_matches += st.total_alignment_matches
        my_stats.dup_aln_num += st.dup_aln_num

    _barrier(group)                          # every shard is written
    if pid != 0:
        _barrier(group)                      # process 0 has merged
        return my_stats, None, my_results

    # ---- process 0: deterministic merge in chromosome order ----
    stats = align_mod.RunStats()
    collector = VariantCollector()
    with open(output_prefix + ext, "wb") as out:
        if ext == ".maf":
            out.write(b"##maf version=1\n")
        for ci in range(len(query_records)):
            part = f"{output_prefix}.part{ci}"
            with open(part + ".pkl", "rb") as fh:
                st, coll = pickle.load(fh)
            stats.local_alignment_num += st.local_alignment_num
            stats.total_alignment_length += st.total_alignment_length
            stats.total_alignment_matches += st.total_alignment_matches
            stats.dup_aln_num += st.dup_aln_num
            collector.merge_from(coll)
            if os.path.exists(part + ext):
                with open(part + ext, "rb") as fh:
                    data = fh.read()
                if ext == ".maf" and data.startswith(b"##maf version=1\n"):
                    data = data[len(b"##maf version=1\n"):]
                out.write(data)
            for f in (part + ext, part + ".pkl"):
                if os.path.exists(f):
                    os.remove(f)
    if cfg.emit_vcf:
        write_vcf(f"{output_prefix}.vcf", collector, fm.genome.names,
                  fm.genome.lengths, reference_name=output_prefix)
    _barrier(group)
    return stats, collector, my_results
