"""Worker process of the PyTorch port's multi-process tests
(test_torch_distributed.py): joins a gloo process group through a file
and runs parallel/distributed.run_distributed on the CPU. Imports no JAX.
Usage:
    python torch_dist_worker.py <init_file> <world> <rank> <workdir>
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    init_file, world, rank, workdir = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]), sys.argv[4])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.index.io import load_index
    from gsalign_tpu_torch.parallel.distributed import run_distributed

    fm = load_index(os.path.join(workdir, "idx"))
    qry = read_fasta(os.path.join(workdir, "qry.fa"))
    try:
        stats, _, _ = run_distributed(
            fm, qry, AlignConfig(), os.path.join(workdir, "dist_out"),
            verbose=False, device="cpu")
    finally:
        dist.destroy_process_group()
    print(f"worker {rank}/{world}: alignments={stats.local_alignment_num}",
          flush=True)


if __name__ == "__main__":
    main()
