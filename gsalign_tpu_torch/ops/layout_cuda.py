"""The INIT-10 jump rows of comb_pairs built on the card (csrc/layout.cu).

    init10_rows   the 4^10 10-mer counts of an index text (its packed
                  2-bit words, 16 bases a word), their exclusive scan with
                  the short-suffix steps, packed as the rows
                  (start_k | start_{k+1} << 32) that DeviceFMIndex.host_tables
                  writes after comb_pairs' class rows (ops/rank.INIT_OFF).

It replaces no TPU kernel: the JAX package builds the rows on the host in
numpy. That numpy pass (ops/rank._build_c10 with _c10_from_counts and
host_tables' packing) is the plain version, and DeviceFMIndex.from_host
runs it for a CPU device; on a card it launches the kernel through this
wrapper, which raises for any other device (no fallback). The step keys
come from the host (ops/rank._c10_steps), as do the init_corr entries made
from them. init10_rows counts its calls in `.launches` (one a table: the
call zeroes the counts and runs three kernels in order on the current
stream, and does not synchronise).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gsalign_tpu_torch.ops import cuda_build

N_KEYS = 4 ** 10
TILE = 1024                # bins a warp scans (csrc/layout.cu kTile)
MAX_STEPS = 10             # short suffixes of the text: lengths 0-9
# words from one group of 16 words to the next: packed words, text_rows
STRIDES = (16, 32)

_vp, _ll = ctypes.c_void_p, ctypes.c_longlong


class _Init10Args(ctypes.Structure):
    """csrc/layout.cu Init10Args, field for field."""
    _fields_ = [(n, _vp) for n in ("text", "counts", "tile_sums", "rows")] + [
        (n, _ll) for n in ("stride", "n", "base", "n_bumps")] + [
            ("bumps", _ll * MAX_STEPS), ("max_blocks", _ll)]


SIGNATURES = {"gsalign_init10_rows": [ctypes.POINTER(_Init10Args), _vp]}


def build() -> ctypes.CDLL:
    """Build (see ops/cuda_build.py) and load csrc/layout.cu."""
    return cuda_build.bind("layout", SIGNATURES)


def start_words(n: int) -> int:
    """Words of an n-base text that hold a 10-mer start."""
    return (n - 10) // 16 + 1 if n >= 10 else 0


def init10_launch(lib, stream, text: torch.Tensor, stride: int, n: int,
                  steps: np.ndarray, rows: torch.Tensor,
                  max_blocks: int = 0) -> None:
    """One call of the kernels through `lib` (the card's library, or a host
    build of layout.cu) on `stream`: the rows of an n-base text into `rows`
    (int64 [4^10], 16-byte aligned). text: int32 words (the uint32 bit
    patterns), word w of the text at (w >> 4) * stride + (w & 15), the word
    after it one further. steps: the lb of each short suffix
    (ops/rank._c10_steps). max_blocks > 0 caps each grid."""
    dev = rows.device
    if stride not in STRIDES:
        raise ValueError(f"stride must be one of {STRIDES}, got {stride}")
    steps = np.asarray(steps, dtype=np.int64)
    if steps.shape[0] > MAX_STEPS or not (
            (steps >= 0) & (steps < N_KEYS)).all():
        raise ValueError(f"at most {MAX_STEPS} step keys in [0, 4^10), got "
                         f"{steps}")
    for name, t, dtype in (("text", text, torch.int32),
                           ("rows", rows, torch.int64)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} vector")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
    if rows.shape[0] != N_KEYS or rows.data_ptr() % 16:
        raise ValueError(f"rows must hold {N_KEYS} 16-byte aligned entries")
    w = start_words(n) - 1
    if w >= 0 and (w >> 4) * stride + (w & 15) + 1 >= text.shape[0]:
        raise ValueError(f"a {n}-base text needs more than {text.shape[0]} "
                         f"words at stride {stride}")
    bumps = steps[steps > 0]
    counts = torch.empty(N_KEYS, dtype=torch.int32, device=dev)
    tile_sums = torch.empty(N_KEYS // TILE, dtype=torch.int32, device=dev)
    args = _Init10Args(
        text=text.data_ptr() if text.numel() else None,
        counts=counts.data_ptr(), tile_sums=tile_sums.data_ptr(),
        rows=rows.data_ptr(), stride=stride, n=n,
        base=int((steps == 0).sum()), n_bumps=bumps.shape[0],
        bumps=(_ll * MAX_STEPS)(*bumps.tolist()), max_blocks=max_blocks)
    cuda_build.raise_on(lib.gsalign_init10_rows(ctypes.byref(args), stream),
                        "init10_rows")


def init10_rows(text: torch.Tensor, stride: int, n: int, steps: np.ndarray,
                rows: torch.Tensor) -> None:
    """Kernel init10_rows on the current stream of rows' card, that card
    made current for the launch (see init10_launch for the arguments);
    raises for a tensor that is not on a card."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"init10_rows runs on a card, not {dev} (the plain "
                         f"version is ops/rank._build_c10 on the host)")
    lib = build()
    with torch.cuda.device(dev):
        init10_launch(lib, cuda_build.stream(dev), text, stride, n, steps,
                      rows)
    cuda_build.count(init10_rows)


init10_rows.launches = 0
