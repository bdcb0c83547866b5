"""Entry points on the flagship compute path.

entry() -> (fn, example_args), the counterpart of the JAX package's
__graft_entry__.entry() on the same inputs: 32 problems of 256 bases from
numpy's default_rng(0), the target a copy of the query with 5 % of its
bases changed. fn is ops/dp_cuda.dp_align: the hand-written DP kernels on
the CUDA card, their plain torch version (ops/dp.dp_align_batch) on CPU
tensors, where the CPU is asked for. It returns reverse-order op codes
uint8 [B, 2L] with OP_PAD holes.

dryrun_multichip(n) runs the whole pipeline over an n-entry mesh
(parallel/mesh.py), the counterpart of __graft_entry__.dryrun_multichip:
one small genome comparison with the seed lanes and the DP problems split
over the entries.

    python -m gsalign_tpu_torch.entry          # both, on the card
"""

from __future__ import annotations

import numpy as np
import torch

from gsalign_tpu_torch.utils.device import resolve_device

L = 256
B = 32


def example_inputs():
    """(q, t, ql, tl) as numpy: uint8 codes [B, L] and int32 lengths [B]."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, (B, L)).astype(np.int32)
    q = base.copy()
    t = base.copy()
    # sprinkle edits so the aligner has real work
    mask = rng.random((B, L)) < 0.05
    t[mask] = (t[mask] + 1) % 4
    ql = np.full(B, L, dtype=np.int32)
    tl = np.full(B, L, dtype=np.int32)
    return q.astype(np.uint8), t.astype(np.uint8), ql, tl


def entry(device=None):
    """(fn, example_args) on `device` (None: the CUDA card, an error
    without one; "cpu": the plain DP on the CPU)."""
    from gsalign_tpu_torch.ops import dp_cuda
    dev = resolve_device(device)

    def fn(q, t, ql, tl):
        return dp_cuda.dp_align(q, t, ql, tl, L)

    example_args = tuple(torch.from_numpy(a).to(dev)
                         for a in example_inputs())
    return fn, example_args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """compare_genomes over an n_devices-entry mesh on a 30 kb random genome
    (numpy's default_rng(7)) and its copy with 1 % of its bases changed,
    with seed_exploration_chunk 1000 so that every entry owns seed lanes;
    asserts at least one alignment and an ANI above 95. device None: every
    card, or where fewer than n_devices are visible the first card
    n_devices times, a stream an entry; "cpu": n_devices CPU entries."""
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.packing import Genome, codes_to_chars
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    from gsalign_tpu_torch.pipeline.align import compare_genomes

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    mesh = mesh_lib.make_mesh(devices)

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, 30_000).astype(np.uint8)
    genome = Genome(names=["c"], lengths=np.asarray([len(codes)]),
                    offsets=np.asarray([0]), holes=[], codes_fwd=codes)
    fm = build_fmindex(genome, prefer_device=False)
    qry = codes.copy()
    subs = rng.random(len(qry)) < 0.01
    qry[subs] = (qry[subs] + rng.integers(1, 4, subs.sum())) % 4
    # small chunks, so that every entry owns seed lanes
    cfg = AlignConfig(seed_exploration_chunk=1000)
    stats, collector, _ = compare_genomes(
        fm, [("q", codes_to_chars(qry))], cfg, output_prefix=None,
        verbose=False, mesh=mesh)
    assert stats.local_alignment_num >= 1
    assert stats.ani > 95.0
    print(f"dryrun_multichip({n_devices}): pipeline ok on {mesh} - "
          f"alignments={stats.local_alignment_num} ani={stats.ani:.2f} "
          f"snv={collector.n_snv}")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape))
    dryrun_multichip(max(4, torch.cuda.device_count()))
