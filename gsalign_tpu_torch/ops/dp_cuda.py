"""Hand-written Hopper DP kernels (csrc/dp.cu) and their wrappers.

Two kernels replace the JAX package's Pallas DP (gsalign_tpu/ops/
dp_pallas.py; the source names what each replaces and what bounds it).
Both are built from one core, a warp that owns a strip of 32*K target rows
(K a lane, in registers) and streams the query's columns through it:

    dp_small  L <= 256: a warp a problem, packed directions in shared memory
    dp_any    any L: a chain of warps a problem, over the blocks of a thread
              block cluster when the batch is small, packed directions in a
              global scratch of B*L*L/2 bytes, a windowed traceback

Both take ksw2 query/target codes uint8 [B, L] (pad 4; L a multiple of 32)
and int32 [B] lengths, and return uint8 [B, 2L]: reverse-order ops, then
OP_PAD. Op codes equal the plain torch version's (ops/dp.py) after PADs are
stripped.

On a CPU tensor a wrapper runs the plain version. On a CUDA tensor it
launches its kernel or raises: a build or launch failure is an error, never
a silent fallback. Each wrapper counts its launches in `.launches` and keeps
its last launches' inputs (L, q, t, ql, tl) in `.shapes`: references, no
copy, at most 0.5 MB of codes a launch at the aligner's batch size.

The kernels are compiled with nvcc from csrc/ at first use (route: plain C
entry points, loaded with ctypes; see ops/cuda_build.py).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from gsalign_tpu_torch.ops import cuda_build
from gsalign_tpu_torch.ops import dp as dp_ops

SMALL_MAX_L = 256      # dp_small: one warp holds 32 * 8 rows
SMALL_BEST_L = 128     # above it dp_any's one warp is faster (see dp_align)
N_SM = 132             # SMs of an H100 SXM; the wrapper asks the card
KEPT_SHAPES = 16       # launches whose inputs `.shapes` keeps
MAX_CLUSTER = 8        # blocks a cluster, the portable limit
MAX_WARPS = 16         # warps a block of dp_any: its registers fit an SM
CHUNK = 8              # columns a direction word holds

_vp, _ci = ctypes.c_void_p, ctypes.c_int


def build() -> ctypes.CDLL:
    """Build (see ops/cuda_build.py) and load csrc/dp.cu."""
    return cuda_build.bind("dp", {
        "gsalign_dp_small": [_vp, _vp, _vp, _vp, _ci, _ci, _vp, _ci, _ci,
                             _vp],
        "gsalign_dp_any": [_vp, _vp, _vp, _vp, _ci, _ci, _vp, _vp, _vp, _ci,
                           _ci, _ci, _vp]})


def dir_word_index(L: int, kr: int, row: int, col: int):
    """(word, nibble) of cell (row, col)'s direction in a problem's packed
    directions, as csrc/dp.cu lays them out: strips of 32*kr rows, kr
    consecutive rows a lane; lane l keeps column j at position (j + l) mod L
    of its row, 8 positions a 32-bit word; a strip's words are ordered by
    chunk, then row of the lane, then lane. With 32*kr dividing L the words
    of a problem are exactly [0, L*L/8)."""
    strip, r = divmod(row, 32 * kr)
    lane, k = divmod(r, kr)
    pos = (col + lane) % L
    n_chunks = L // CHUNK
    word = ((strip * n_chunks + pos // CHUNK) * kr + k) * 32 + lane
    return word, pos % CHUNK


def small_plan(L: int):
    """(K rows a lane, warps a block) of dp_small at width L."""
    K = 2 if L <= 64 else 4 if L <= 128 else 8
    return K, (8 if L <= 128 else 1)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def any_plan(B: int, L: int, n_sm: int = N_SM):
    """(K rows a lane, warps a block, blocks a cluster) of dp_any for B
    problems of width L on a card of n_sm SMs. Up to 256 rows one warp takes
    the problem (8 rows a lane). Above, a chain of warps of 4 rows a lane: a
    full batch takes a block a problem; a batch that leaves SMs idle spreads
    each problem's chain over a cluster, as long as a block keeps two
    warps."""
    if L <= 256:
        return 8, 1, 1
    K = 4
    chain = -(-L // (32 * K))              # warps that cover L rows
    cs = 1
    while cs < MAX_CLUSTER and B * cs * 2 <= n_sm and chain // (cs * 2) >= 2:
        cs *= 2
    return K, min(MAX_WARPS, -(-chain // cs)), cs


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
    if q.device.type == "cuda" and (L < 32 or L % 32):
        raise ValueError(f"the kernels take L a multiple of 32, got {L}")


def _plain(q, t, ql, tl, L):
    """The plain version under the kernels' contract: lengths clamped to
    [0, L]."""
    return dp_ops.dp_align_batch(q, t, ql.clamp(0, L), tl.clamp(0, L), L)


def dp_small(q, t, ql, tl, L: int) -> torch.Tensor:
    """Kernel dp_small (L <= SMALL_MAX_L). Lengths are clamped to [0, L]."""
    _check(q, t, ql, tl, L)
    if L > SMALL_MAX_L:
        raise ValueError(f"dp_small takes L <= {SMALL_MAX_L}, got {L}")
    if q.device.type == "cpu":
        return _plain(q, t, ql, tl, L)
    lib = build()
    B = q.shape[0]
    out = torch.empty((B, 2 * L), dtype=torch.uint8, device=q.device)
    if B:
        K, wpb = small_plan(L)
        cuda_build.raise_on(lib.gsalign_dp_small(
            q.data_ptr(), t.data_ptr(), ql.data_ptr(), tl.data_ptr(), B, L,
            out.data_ptr(), K, wpb, cuda_build.stream(q.device)), "dp_small")
        cuda_build.count(dp_small)
        dp_small.shapes.append((L, q, t, ql, tl))
    return out


dp_small.launches = 0
dp_small.shapes = collections.deque(maxlen=KEPT_SHAPES)


def any_scratch(B: int, L: int, K: int, device):
    """dp_any's scratch: the packed directions (B * L*L/2 bytes where 32*K
    divides L, whole strips otherwise) and two last-row buffers a problem."""
    strips = -(-L // (32 * K))
    dirs = torch.empty(B * strips * (L // CHUNK) * K * 32, dtype=torch.int32,
                       device=device)
    rows = torch.empty(B * 2 * L, dtype=torch.int16, device=device)
    return dirs, rows


def dp_any(q, t, ql, tl, L: int) -> torch.Tensor:
    """Kernel dp_any (any L that is a multiple of 32). Lengths are clamped
    to [0, L]."""
    _check(q, t, ql, tl, L)
    if q.device.type == "cpu":
        return _plain(q, t, ql, tl, L)
    lib = build()
    B = q.shape[0]
    out = torch.empty((B, 2 * L), dtype=torch.uint8, device=q.device)
    if B:
        K, wpb, cs = any_plan(B, L, sm_count(q.device))
        dirs, rows = any_scratch(B, L, K, q.device)
        cuda_build.raise_on(lib.gsalign_dp_any(
            q.data_ptr(), t.data_ptr(), ql.data_ptr(), tl.data_ptr(), B, L,
            out.data_ptr(), dirs.data_ptr(), rows.data_ptr(), K, wpb, cs,
            cuda_build.stream(q.device)), "dp_any")
        cuda_build.count(dp_any)
        dp_any.shapes.append((L, q, t, ql, tl))
    return out


dp_any.launches = 0
dp_any.shapes = collections.deque(maxlen=KEPT_SHAPES)


def dp_align(q, t, ql, tl, L: int) -> torch.Tensor:
    """dp_fn for ops/dp.FragmentAligner: dp_small up to SMALL_BEST_L, dp_any
    above. At L = 256 dp_small's 32 KB of directions a warp leave an SM six
    warps, and dp_any, whose directions are in global memory, is faster."""
    fn = dp_small if L <= SMALL_BEST_L else dp_any
    return fn(q, t, ql, tl, L)
