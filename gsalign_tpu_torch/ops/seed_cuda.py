"""Hand-written Hopper kernels of the seed stage (csrc/seed.cu) and their
wrappers.

    seed_scan   every scan lane run to its end in one launch, a warp per
                lane; replaces the JAX package's whole seed-scan while_loop
                (ops/seeding.py _seed_scan_impl) in the xla and none SA
                modes. Plain version: seeding.seed_scan_plain.
    seed_step   one lock-step iteration of every scan lane; replaces that
                loop's body. pallas SA mode runs it, and it is the
                lane-by-lane diffing tool of the other modes. Plain
                version: seeding.seed_step_plain.
    resolve_sa  LF-walk ranks to their sampled SA rows; replaces the JAX
                package's rank.resolve_sa while_loop. Plain version:
                rank.resolve_sa.

On a CPU tensor a wrapper runs the plain version. On a CUDA tensor it
launches its kernel or raises: a build or launch failure is an error, never
a silent fallback. Each wrapper counts its launches in `.launches`. The
kernels read the DeviceFMIndex tensors as they are (see ops/rank.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from gsalign_tpu_torch.ops import cuda_build
from gsalign_tpu_torch.ops import rank as rank_ops
from gsalign_tpu_torch.ops import seeding

_vp, _ll = ctypes.c_void_p, ctypes.c_longlong


class _SeedArgs(ctypes.Structure):
    """csrc/seed.cu SeedArgs, field for field."""
    _fields_ = [(n, _vp) for n in (
        "q_rows", "t3", "t3_major", "t3_exc_pos", "t3_exc_chr",
        "comb_pairs", "init_corr", "text_rows", "sa_rows", "starts", "stops",
        "state", "out", "slot", "res_k", "live")] + [(n, _ll) for n in (
            "B", "max_out", "min_seed_length", "max_seed_freq", "sensitive",
            "order", "use_init", "use8", "seq_len", "n_look", "mode", "it",
            "win_words", "step_cap")]


class _ResolveArgs(ctypes.Structure):
    """csrc/seed.cu ResolveArgs, field for field."""
    _fields_ = [(n, _vp) for n in (
        "t3", "t3_major", "t3_exc_pos", "t3_exc_chr", "l2", "sa", "k",
        "out")] + [(n, _ll) for n in ("n", "primary", "seq_len", "sa_intv")]


def build() -> ctypes.CDLL:
    """Build (see ops/cuda_build.py) and load csrc/seed.cu."""
    return cuda_build.bind("seed", {
        "gsalign_seed_scan": [ctypes.POINTER(_SeedArgs), _vp],
        "gsalign_seed_step": [ctypes.POINTER(_SeedArgs), _vp],
        "gsalign_resolve_sa": [ctypes.POINTER(_ResolveArgs), _vp]})


def _ptr(t: Optional[torch.Tensor], dtype, dev, name: str):
    """Device pointer of a contiguous tensor of `dtype` on `dev`."""
    if t is None:
        return None
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, not {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _seed_args(dfm, q_rows, lanes, prm, it=0, slot=None, res_k=None,
               win_words=0, step_cap=0) -> _SeedArgs:
    """The argument struct of seed_step and seed_scan, after checking every
    tensor."""
    dev = lanes.st.device
    mode = seeding.SA_MODES.index(prm.sa_mode)
    if prm.sa_mode == "pallas" and (slot is None or res_k is None):
        raise ValueError("pallas mode needs slot and res_k")
    if prm.sa_mode != "none" and not dfm.direct_ok:
        raise ValueError("direct mode needs a full-SA index")
    B = lanes.st.shape[1]
    if lanes.st.shape != (seeding.N_FIELDS, B) or \
            lanes.out.shape != (B, prm.max_out, 3) or \
            lanes.starts.shape != (B,) or lanes.stops.shape != (B,) or \
            lanes.live.shape != (2,) or \
            (slot is not None and slot.shape != (B,)):
        raise ValueError("lane tensors disagree in shape")
    if q_rows.dim() != 2 or q_rows.shape[0] < 1 or q_rows.shape[1] != 64:
        raise ValueError(f"q_rows must be [R >= 1, 64], got "
                         f"{tuple(q_rows.shape)}")
    i64, i32 = torch.int64, torch.int32
    direct = prm.sa_mode != "none"
    return _SeedArgs(
        q_rows=_ptr(q_rows, i32, dev, "q_rows"),
        t3=_ptr(dfm.t3, i32, dev, "t3"),
        t3_major=_ptr(dfm.t3_major, i32, dev, "t3_major"),
        t3_exc_pos=_ptr(dfm.t3_exc_pos, i64, dev, "t3_exc_pos"),
        t3_exc_chr=_ptr(dfm.t3_exc_chr, i64, dev, "t3_exc_chr"),
        comb_pairs=_ptr(dfm.comb_pairs, i64, dev, "comb_pairs"),
        init_corr=_ptr(dfm.init_corr, i64, dev, "init_corr"),
        text_rows=_ptr(dfm.text_rows, i32, dev, "text_rows")
        if direct else None,
        sa_rows=_ptr(dfm.sa_rows, i32, dev, "sa_rows") if direct else None,
        starts=_ptr(lanes.starts, i64, dev, "starts"),
        stops=_ptr(lanes.stops, i64, dev, "stops"),
        state=_ptr(lanes.st, i64, dev, "state"),
        out=_ptr(lanes.out, i64, dev, "out"),
        slot=_ptr(slot, i64, dev, "slot"),
        res_k=_ptr(res_k, i32, dev, "res_k"),
        live=_ptr(lanes.live, i32, dev, "live"),
        B=B, max_out=prm.max_out, min_seed_length=prm.min_seed_length,
        max_seed_freq=prm.max_seed_freq, sensitive=int(prm.sensitive),
        order=dfm.init_order,
        use_init=int(prm.min_seed_length > dfm.init_order),
        use8=int(prm.min_seed_length > 8), seq_len=dfm.seq_len,
        n_look=q_rows.shape[0] * 256, mode=mode, it=it,
        win_words=win_words, step_cap=step_cap)


# seed_scan stages each lane's query window in shared memory, four lanes a
# block: a block may use 227 KB (232,448 bytes) on an H100
_SCAN_WARPS = 4
_SCAN_HEAD_BYTES = (136 + 12 + 3 + 3) * 8
_MAX_SHARED_BYTES = 232448


def _step_cap(max_len: int) -> int:
    """The most steps a lane of max_len bases can take, seed_scan's limit.
    From a cursor c an extension is one INIT step, then EXT steps that each
    move ext_pos forward (to at most the lane's stop), each preceded by at
    most one triple miss that moves nothing, then one finalizing step, again
    after at most one triple miss: at most 2 * (stop - c) + 3 steps, after
    which the cursor stands at c + 1 or further. An INIT step that starts
    no extension moves the cursor by one. Summed over every c of the lane:
    max_len * (max_len + 1) + 3 * max_len."""
    return max_len * (max_len + 4)


def seed_scan(dfm, q_rows: torch.Tensor, lanes, prm) -> np.ndarray:
    """Kernel seed_scan: every lane of `lanes` (seeding.ScanLanes) run to
    its end, in place, in one launch. Returns the final lane state on the
    host (int64 [N_FIELDS, B]): reading it back is the scan's one
    synchronisation. Raises if a lane exceeded the step limit."""
    dev = lanes.st.device
    if dev.type == "cpu":
        return seeding.seed_scan_plain(dfm, q_rows, lanes, prm)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if prm.sa_mode == "pallas":
        raise ValueError("seed_scan runs the xla and none SA modes: pallas "
                         "mode couples the lanes and needs the lock step")
    # a lane reads from its start's word to 16 words of compare and one of
    # shift past its stop's word
    win_words = (lanes.max_len >> 4) + 20
    shared = _SCAN_HEAD_BYTES + _SCAN_WARPS * 2 * win_words * 4
    if shared > _MAX_SHARED_BYTES:
        raise ValueError(f"lanes of {lanes.max_len} bases need {shared} "
                         f"bytes of shared memory a block; the card has "
                         f"{_MAX_SHARED_BYTES}")
    args = _seed_args(dfm, q_rows, lanes, prm, win_words=win_words,
                      step_cap=_step_cap(lanes.max_len))
    if lanes.st.shape[1]:
        cuda_build.raise_on(build().gsalign_seed_scan(
            ctypes.byref(args), cuda_build.stream(dev)), "seed_scan")
        seed_scan.launches += 1
    st = lanes.st.cpu().numpy()
    over = np.flatnonzero(st[seeding.F_STEPS] < 0)
    if over.size:
        raise RuntimeError(f"seed_scan: lanes {over[:8].tolist()} exceeded "
                           f"the step limit {args.step_cap}")
    return st


seed_scan.launches = 0


def seed_step(dfm, q_rows: torch.Tensor, lanes, prm, it: int,
              slot: Optional[torch.Tensor] = None,
              res_k: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel seed_step: one iteration of every lane of `lanes`
    (seeding.ScanLanes), in place. Returns the count of lanes still live as
    a 0-d device tensor (reading it is the loop's host sync). `it` is the
    iteration number: its parity picks the live counter."""
    dev = lanes.st.device
    if dev.type == "cpu":
        return seeding.seed_step_plain(dfm, q_rows, lanes, prm, it, slot,
                                       res_k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    args = _seed_args(dfm, q_rows, lanes, prm, it, slot, res_k)
    cuda_build.raise_on(build().gsalign_seed_step(
        ctypes.byref(args), cuda_build.stream(dev)), "seed_step")
    seed_step.launches += 1
    return lanes.live[it & 1]


seed_step.launches = 0


def _resolve_args(dfm, k: torch.Tensor, out: torch.Tensor) -> _ResolveArgs:
    """The kernel's argument struct, after checking every tensor."""
    dev, i64 = k.device, torch.int64
    i32 = torch.int32
    return _ResolveArgs(
        t3=_ptr(dfm.t3, i32, dev, "t3"),
        t3_major=_ptr(dfm.t3_major, i32, dev, "t3_major"),
        t3_exc_pos=_ptr(dfm.t3_exc_pos, i64, dev, "t3_exc_pos"),
        t3_exc_chr=_ptr(dfm.t3_exc_chr, i64, dev, "t3_exc_chr"),
        l2=_ptr(dfm.l2, i64, dev, "l2"),
        sa=_ptr(rank_ops.sa_table(dfm), i32, dev, "sa"),
        k=_ptr(k, i64, dev, "k"), out=_ptr(out, i64, dev, "out"),
        n=k.shape[0], primary=dfm.primary, seq_len=dfm.seq_len,
        sa_intv=dfm.sa_intv)


def resolve_sa(dfm, k: torch.Tensor) -> torch.Tensor:
    """Kernel resolve_sa: SA values of ranks k (int64 [n]) -> int64 [n]."""
    if k.dtype != torch.int64 or k.dim() != 1:
        raise TypeError(f"ranks must be int64 [n], got {k.dtype} "
                        f"{tuple(k.shape)}")
    dev = k.device
    if dev.type == "cpu":
        return rank_ops.resolve_sa(dfm, k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k = k.contiguous()
    out = torch.empty_like(k)
    if k.shape[0]:
        args = _resolve_args(dfm, k, out)
        cuda_build.raise_on(build().gsalign_resolve_sa(
            ctypes.byref(args), cuda_build.stream(dev)), "resolve_sa")
        resolve_sa.launches += 1
    return out


resolve_sa.launches = 0
