"""Hand-written Hopper DP kernels (csrc/dp.cu) and their wrappers.

Two kernels replace the JAX package's Pallas DP (gsalign_tpu/ops/
dp_pallas.py; the source names what each replaces and what bounds it):

    dp_small  L <= 256, direction nibbles in shared memory
    dp_any    any L, direction nibbles in a global scratch

Both take ksw2 query/target codes uint8 [B, L] (pad 4) and int32 [B]
lengths, and return uint8 [B, 2L]: reverse-order ops, then OP_PAD. Op codes
equal the plain torch version's (ops/dp.py) after PADs are stripped.

On a CPU tensor a wrapper runs the plain version. On a CUDA tensor it
launches its kernel or raises: a build or launch failure is an error, never
a silent fallback. Each wrapper counts its launches in `.launches`.

The kernels are compiled with nvcc from csrc/ at first use (route: plain C
entry points, loaded with ctypes; see ops/cuda_build.py).
"""

from __future__ import annotations

import ctypes

import torch

from gsalign_tpu_torch.ops import cuda_build
from gsalign_tpu_torch.ops import dp as dp_ops

SMALL_MAX_L = 256          # dp_small keeps L*L + 6L bytes in shared memory
STATE_SMEM_MAX_L = 32768   # dp_any keeps its 6L state bytes on chip up to here

_vp, _ci = ctypes.c_void_p, ctypes.c_int


def build() -> ctypes.CDLL:
    """Build (see ops/cuda_build.py) and load csrc/dp.cu."""
    return cuda_build.bind("dp", {
        "gsalign_dp_small": [_vp, _vp, _vp, _vp, _ci, _ci, _vp, _vp],
        "gsalign_dp_any": [_vp, _vp, _vp, _vp, _ci, _ci, _vp, _vp, _vp,
                           _vp]})


def _check(q, t, ql, tl, L):
    if q.dtype != torch.uint8 or t.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {q.dtype}/{t.dtype}")
    if ql.dtype != torch.int32 or tl.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {ql.dtype}/{tl.dtype}")
    if q.dim() != 2 or q.shape != t.shape or q.shape[1] != L:
        raise ValueError(f"codes must be [B, {L}], got {tuple(q.shape)} "
                         f"and {tuple(t.shape)}")
    if ql.shape != (q.shape[0],) or tl.shape != (q.shape[0],):
        raise ValueError("lengths must be [B]")
    if len({a.device for a in (q, t, ql, tl)}) != 1:
        raise ValueError("all inputs must be on one device")
    if not all(a.is_contiguous() for a in (q, t, ql, tl)):
        raise ValueError("inputs must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def dp_small(q, t, ql, tl, L: int) -> torch.Tensor:
    """Kernel dp_small (L <= SMALL_MAX_L). Lengths are clamped to [0, L]
    on the device."""
    _check(q, t, ql, tl, L)
    if L > SMALL_MAX_L:
        raise ValueError(f"dp_small takes L <= {SMALL_MAX_L}, got {L}")
    if q.device.type == "cpu":
        return dp_ops.dp_align_batch(q, t, ql, tl, L)
    lib = build()
    B = q.shape[0]
    out = torch.empty((B, 2 * L), dtype=torch.uint8, device=q.device)
    if B:
        cuda_build.raise_on(lib.gsalign_dp_small(
            q.data_ptr(), t.data_ptr(), ql.data_ptr(), tl.data_ptr(), B, L,
            out.data_ptr(), cuda_build.stream(q.device)), "dp_small")
        dp_small.launches += 1
    return out


dp_small.launches = 0


def dp_any(q, t, ql, tl, L: int) -> torch.Tensor:
    """Kernel dp_any (any L); allocates B*L*L bytes of direction scratch
    (and B*6L state bytes above STATE_SMEM_MAX_L)."""
    _check(q, t, ql, tl, L)
    if q.device.type == "cpu":
        return dp_ops.dp_align_batch(q, t, ql, tl, L)
    lib = build()
    B = q.shape[0]
    out = torch.empty((B, 2 * L), dtype=torch.uint8, device=q.device)
    if B:
        dirs = torch.empty(B * L * L, dtype=torch.uint8, device=q.device)
        state = (torch.empty(B * 6 * L, dtype=torch.int8, device=q.device)
                 if L > STATE_SMEM_MAX_L else None)
        cuda_build.raise_on(lib.gsalign_dp_any(
            q.data_ptr(), t.data_ptr(), ql.data_ptr(), tl.data_ptr(), B, L,
            out.data_ptr(), dirs.data_ptr(),
            None if state is None else state.data_ptr(),
            cuda_build.stream(q.device)), "dp_any")
        dp_any.launches += 1
    return out


dp_any.launches = 0


def dp_align(q, t, ql, tl, L: int) -> torch.Tensor:
    """dp_fn for ops/dp.FragmentAligner: dp_small up to SMALL_MAX_L,
    dp_any above."""
    fn = dp_small if L <= SMALL_MAX_L else dp_any
    return fn(q, t, ql, tl, L)
