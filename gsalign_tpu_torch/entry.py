"""Entry point on the flagship compute path: the batched DP aligner.

entry() -> (fn, example_args), the counterpart of the JAX package's
__graft_entry__.entry() on the same inputs: 32 problems of 256 bases from
numpy's default_rng(0), the target a copy of the query with 5 % of its
bases changed. fn is ops/dp_cuda.dp_align: the hand-written DP kernels on
the CUDA card, their plain torch version (ops/dp.dp_align_batch) on CPU
tensors, where the CPU is asked for. It returns reverse-order op codes
uint8 [B, 2L] with OP_PAD holes.

    python -m gsalign_tpu_torch.entry          # on the card
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


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape))
