"""Masked gather of int32 words: the port of the JAX package's Pallas kernel
gsalign_tpu/ops/gather_pallas.py (masked_row_gather -> _kernel).

    out[i] = table[idx[i]] where idx[i] >= 0, else 0

masked_gather launches the hand-written kernel (csrc/gather.cu) on a CUDA
tensor and runs masked_gather_plain, the plain torch version, on a CPU
tensor; a build or launch failure raises. It counts its launches in
`.launches`. The seed scan's pallas SA mode no longer calls it on a card:
the kernel's one read (csrc/gather_dev.cuh) runs inside the seed_lockstep
kernel, where the slots are made (ops/seed_cuda.py), and the plain
lock-step loop uses masked_gather_plain. Unlike the TPU kernel it needs neither K % 8 == 0 nor a table
padded to 1024 words. An index of len(table) or more is a caller error, as
in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from gsalign_tpu_torch.ops import cuda_build


def build() -> ctypes.CDLL:
    """Build (see ops/cuda_build.py) and load csrc/gather.cu."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return cuda_build.bind("gather",
                           {"gsalign_masked_gather": [vp, vp, ci, vp, vp]})


def masked_gather_plain(table: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """The plain torch version of masked_gather."""
    return torch.where(idx >= 0, table[idx.clamp(min=0)],
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))


def masked_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel masked_gather: int32 table [n], int32 idx [K] -> int32 [K]."""
    if table.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError(f"table and idx must be int32, got {table.dtype}/"
                        f"{idx.dtype}")
    if table.dim() != 1 or idx.dim() != 1:
        raise ValueError(f"table and idx must be 1-D, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.device != idx.device:
        raise ValueError("table and idx must be on one device")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.device.type == "cpu":
        return masked_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    lib = build()
    K = idx.shape[0]
    out = torch.empty(K, dtype=torch.int32, device=idx.device)
    if K:
        cuda_build.raise_on(lib.gsalign_masked_gather(
            table.data_ptr(), idx.data_ptr(), K, out.data_ptr(),
            cuda_build.stream(idx.device)), "masked_gather")
        cuda_build.count(masked_gather)
    return out


masked_gather.launches = 0
