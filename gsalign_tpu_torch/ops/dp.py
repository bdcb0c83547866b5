"""Batched global affine-gap alignment with traceback (plain torch).

The ksw2 `extz2_sse` + `ksw_backtrack` semantics of the JAX package's
ops/dp.py (reference src/ksw2_alignment.cpp:25-249; scoring: match 1,
mismatch -1, gap open 2, extend 1, full band) as a loop over anti-diagonals
on [B, L] tensors. This is the plain version of the hand-written kernels in
ops/dp_cuda.py: the CPU path runs it, and the kernels are held against it.

Direction codes use the compact 4-bit layout of the JAX package's Pallas
kernel: dmain in {0, 1, 2} on bits 0-1, the x>0 (E-continue) bit on bit 2
and the y>0 (F-continue) bit on bit 3. ksw2's backtrack only ever tests
"the bit for state s", so this is behaviourally identical to its 5-bit
codes; the traceback tests bit state+1.

Conventions follow ksw2: "query" Q = the reference-genome fragment (s1),
"target" T = the query-genome fragment (s2); op codes 0=M, 1=D (consumes T,
gap in Q row), 2=I (consumes Q, gap in T row), 3=pad.
"""

from __future__ import annotations

import collections
import os
import sys
from typing import Tuple

import numpy as np
import torch

from gsalign_tpu_torch.utils.device import resolve_device

MATCH = 1
MISMATCH = -1
GAP_OPEN = 2      # q
GAP_EXTEND = 1    # e
QE = GAP_OPEN + GAP_EXTEND
QE2 = 2 * QE
MAX_SC = MATCH + QE2
WILDCARD = 4

OP_M, OP_D, OP_I, OP_PAD = 0, 1, 2, 3


def _dp_forward(q: torch.Tensor, t: torch.Tensor, ql: torch.Tensor,
                tl: torch.Tensor, L: int) -> torch.Tensor:
    """Direction nibbles for a batch: uint8 [2L-1, B, L], row r = the
    anti-diagonal r over DP rows t (target index). q/t [B, L] (pad 4).

    Diagonals past a problem's last one (r > ql+tl-2) have an empty band
    and write zeros; the traceback never reads them."""
    i32 = torch.int32
    dev = q.device
    B = q.shape[0]
    q = q.to(i32)
    t = t.to(i32)
    ql = ql.to(i32)[:, None]
    tl = tl.to(i32)[:, None]
    q_pad = torch.cat([q, torch.full((B, L), WILDCARD, dtype=i32,
                                     device=dev)], dim=1)        # Q[:, r]
    t_wild = t >= WILDCARD
    t_idx = torch.arange(L, dtype=i32, device=dev)[None, :]
    zero = torch.zeros((B, L), dtype=i32, device=dev)
    u, v, x, y = zero, zero, zero, zero
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    qrr = torch.full((B, L), WILDCARD, dtype=i32, device=dev)
    d_rows = torch.empty((2 * L - 1, B, L), dtype=torch.uint8, device=dev)
    for r in range(2 * L - 1):
        top = GAP_OPEN if r > 0 else 0
        # boundary pre-set at t == r (top DP row), when that row exists
        pre = (t_idx == r) & (tl > r)
        u = torch.where(pre, top, u)
        y = torch.where(pre, 0, y)
        # qrr[t] = Q[r-t]: shift the previous diagonal, insert Q[:, r]
        qrr = torch.cat([q_pad[:, r:r + 1], qrr[:, :-1]], dim=1)
        s = torch.where(t_wild | (qrr >= WILDCARD), 0,
                        torch.where(t == qrr, MATCH, MISMATCH))
        xt1 = torch.cat([zcol, x[:, :-1]], dim=1)          # x[t-1]
        vt1 = torch.cat([zcol + top, v[:, :-1]], dim=1)    # v[t-1]
        z = s + QE2
        a = xt1 + vt1
        b = y + u
        d = (a > z).to(i32)
        z = torch.maximum(z, a)
        d = torch.where(b > z, 2, d)
        z = torch.clamp(torch.maximum(z, b), max=MAX_SC)
        u_new = z - vt1
        v_new = z - u
        z2 = z - GAP_OPEN
        a2 = a - z2
        b2 = b - z2
        d = d | torch.where(a2 > 0, 4, 0) | torch.where(b2 > 0, 8, 0)
        in_band = (t_idx >= r - ql + 1) & (t_idx <= torch.clamp(tl - 1,
                                                                 max=r))
        u = torch.where(in_band, u_new, u)
        v = torch.where(in_band, v_new, v)
        x = torch.where(in_band, torch.clamp(a2, min=0), x)
        y = torch.where(in_band, torch.clamp(b2, min=0), y)
        d_rows[r] = torch.where(in_band, d, 0).to(torch.uint8)
    return d_rows


def _traceback(d_rows: torch.Tensor, ql: torch.Tensor, tl: torch.Tensor,
               L: int) -> torch.Tensor:
    """ksw_backtrack (src/ksw2_alignment.cpp:25-68), full band: no forcing.

    A reverse walk over anti-diagonals in lock step over the batch: at step
    r every problem whose current cell (i, j) lies on diagonal r (i + j == r)
    emits one op and steps back; an M consumes two diagonals, so that
    problem idles (emits OP_PAD) on the next step. One extra step at
    r = -1 lets a leading-gap tail op fire when the other sequence is
    already exhausted. Returns uint8 [B, 2L]: reverse-order ops with
    OP_PAD holes."""
    i64 = torch.int64
    dev = d_rows.device
    B = ql.shape[0]
    i = tl.to(i64) - 1
    j = ql.to(i64) - 1
    state = torch.zeros(B, dtype=i64, device=dev)
    ops = torch.empty((B, 2 * L), dtype=torch.uint8, device=dev)
    for step, r in enumerate(range(2 * L - 2, -2, -1)):
        both = (i >= 0) & (j >= 0)
        act = (i + j) == r
        d_row = d_rows[max(r, 0)]
        tmp = d_row.gather(1, i.clamp(0, L - 1)[:, None])[:, 0].to(i64)
        tmp = torch.where(both, tmp, 0)
        bit = (tmp >> (state + 1)) & 1
        s1 = torch.where(state == 0, tmp & 3,
                         torch.where(bit == 0, 0, state))
        s2 = torch.where(s1 == 0, tmp & 3, s1)
        is_m = s2 == 0
        is_d = (s2 == 1) | (s2 == 3)
        op_main = torch.where(is_m, OP_M, torch.where(is_d, OP_D, OP_I))
        op_tail = torch.where(i >= 0, OP_D,
                              torch.where(j >= 0, OP_I, OP_PAD))
        op = torch.where(act, torch.where(both, op_main, op_tail), OP_PAD)
        di = torch.where(both, is_m | is_d, i >= 0)
        dj = torch.where(both, is_m | ~is_d, (i < 0) & (j >= 0))
        i = torch.where(act, i - di.to(i64), i)
        j = torch.where(act, j - dj.to(i64), j)
        state = torch.where(act & both, s2, state)
        ops[:, step] = op.to(torch.uint8)
    return ops


def dp_align_batch(q_codes: torch.Tensor,   # [B, L] ref fragments (pad 4)
                   t_codes: torch.Tensor,   # [B, L] qry fragments (pad 4)
                   ql: torch.Tensor,        # int [B]
                   tl: torch.Tensor,        # int [B]
                   L: int) -> torch.Tensor:
    """Plain torch DP on the tensors' own device. Returns reverse-order op
    codes uint8 [B, 2L] with OP_PAD holes (callers strip PADs)."""
    d_rows = _dp_forward(q_codes, t_codes, ql, tl, L)
    return _traceback(d_rows, ql, tl, L)


def bucket_of(m: int, bucket_sizes) -> int:
    """Padded problem width for a longest side of m bases: the first
    bucket that holds it, else the next multiple of 1024."""
    for Lb in bucket_sizes:
        if m <= Lb:
            return Lb
    return int(np.ceil(m / 1024) * 1024)


class FragmentAligner:
    """Incremental fragment DP: submit per-chromosome fragment batches as
    the host plans them, collect all results with ONE device->host copy.

    Problems bucket by max(len) into padded batches; a bucket launches
    (asynchronously) as soon as it holds batch_cells // L^2 problems, so the
    DP runs behind the host's chain stage for the next chromosome. Leftover
    partial buckets pool across submits and launch at finish(). Results are
    independent of packing (each DP problem is its own lane), so outputs
    are identical for any submit() split.

    dp_fn(q, t, ql, tl, L) takes uint8 [B, L] codes and int32 [B] lengths on
    `device` and returns reverse-order uint8 ops [B, W] with OP_PAD holes;
    by default the hand-written kernels (ops/dp_cuda.dp_align, which runs
    the plain version on CPU tensors). device=None is the CUDA card and
    raises without one; "cpu" asks for the CPU.

    With a mesh (parallel/mesh.Mesh) each launch's problems are padded to a
    multiple of the mesh size with WILDCARD problems of length 1 and cut
    into contiguous stripes, one dp_fn launch a stripe on its entry's
    device and stream; the pad problems' ops are dropped. The mesh's
    devices replace `device`.
    """

    def __init__(self, bucket_sizes=(64, 128, 256, 512, 1024, 2048, 5120),
                 batch_cells: int = 1 << 26, dp_fn=None, device=None,
                 mesh=None):
        if dp_fn is None:
            from gsalign_tpu_torch.ops.dp_cuda import dp_align as dp_fn
        self.bucket_sizes = bucket_sizes
        self.batch_cells = batch_cells
        self.dp_fn = dp_fn
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None \
            else resolve_device(device)
        self.frags: list = []          # (rf, qf) by global index
        self.queue: dict = {}          # Lb -> [global index]
        self.pending: list = []        # (part_idxs, [device ops a stripe])

    def submit(self, ref_frags, qry_frags) -> int:
        """Queue fragments; returns the base global index of this batch.
        Full buckets launch immediately (asynchronously)."""
        base = len(self.frags)
        for rf, qf in zip(ref_frags, qry_frags):
            i = len(self.frags)
            self.frags.append((rf, qf))
            Lb = bucket_of(max(len(rf), len(qf)), self.bucket_sizes)
            q = self.queue.setdefault(Lb, [])
            q.append(i)
            if len(q) >= max(1, self.batch_cells // (Lb * Lb)):
                self._dispatch(Lb, q)
                self.queue[Lb] = []
        return base

    def _dispatch(self, Lb, part):
        B = len(part)
        q = np.full((B, Lb), WILDCARD, dtype=np.uint8)
        t = np.full((B, Lb), WILDCARD, dtype=np.uint8)
        ql = np.empty(B, dtype=np.int32)
        tl = np.empty(B, dtype=np.int32)
        for bi, i in enumerate(part):
            rf, qf = self.frags[i]
            q[bi, :len(rf)] = rf
            t[bi, :len(qf)] = qf
            ql[bi] = len(rf)
            tl[bi] = len(qf)
        if self.mesh is None:
            args = [torch.from_numpy(a).to(self.device)
                    for a in (q, t, ql, tl)]
            self.pending.append((list(part), [self.dp_fn(*args, Lb)]))
            return
        from gsalign_tpu_torch.parallel import mesh as mesh_lib
        mesh = self.mesh
        stripes = zip(*(mesh_lib.shard_lanes(a, mesh, pad) for a, pad in
                        ((q, WILDCARD), (t, WILDCARD), (ql, 1), (tl, 1))))
        ops = []
        for i, args in enumerate(stripes):
            with mesh.on(i):
                ops.append(self.dp_fn(*args, Lb))
        self.pending.append((list(part), ops))

    def finish(self) -> list:
        """Launch leftovers, copy every batch's ops to the host in ONE
        transfer, and return per-pair FORWARD-order op arrays by submit
        order."""
        for Lb, part in sorted(self.queue.items()):
            mb = max(1, self.batch_cells // (Lb * Lb))
            for s in range(0, len(part), mb):
                self._dispatch(Lb, part[s:s + mb])
        self.queue = {}
        if os.environ.get("GSALIGN_DP_STATS"):
            hist = collections.Counter(
                bucket_of(max(len(rf), len(qf)), self.bucket_sizes)
                for rf, qf in self.frags)
            print("[dp_stats] " + " ".join(
                f"L{Lb}:n={hist[Lb]},Mcells={hist[Lb] * Lb * Lb / 1e6:.0f}"
                for Lb in sorted(hist)), file=sys.stderr)
        results: list = [None] * len(self.frags)
        if not self.pending:
            return results
        # one copy a device: every stripe's ops on that device, in order
        by_dev: dict = {}
        for _, stripes in self.pending:
            for i, d in enumerate(stripes):
                by_dev.setdefault(d.device, []).append((i, d))
        flat = {}
        for dev, parts in by_dev.items():
            if self.mesh is not None and dev.type == "cuda":
                cur = torch.cuda.current_stream(dev)
                for i, d in parts:
                    cur.wait_stream(self.mesh.streams[i])
                    d.record_stream(cur)
            host = torch.cat([d.reshape(-1) for _, d in parts]).cpu().numpy()
            flat[dev] = iter(np.split(host, np.cumsum(
                [d.numel() for _, d in parts])[:-1]))
        for part, stripes in self.pending:
            w = stripes[0].shape[1]
            ops = np.concatenate([next(flat[d.device]) for d in stripes]
                                 ).reshape(-1, w)[:len(part)]
            # strip pads + reverse for the whole batch at once: reversing
            # first keeps the flat extraction in forward order
            rev = ops[:, ::-1]
            keep = rev != OP_PAD
            flat_ops = rev[keep]
            ends = np.cumsum(keep.sum(axis=1))
            lo = 0
            for bi, i in enumerate(part):
                hi = int(ends[bi])
                results[i] = flat_ops[lo:hi]
                lo = hi
        self.pending = []
        return results


def align_fragments(ref_frags, qry_frags, bucket_sizes=(64, 128, 256, 512,
                                                        1024, 2048, 5120),
                    batch_cells: int = 1 << 26, dp_fn=None,
                    device=None, mesh=None) -> list:
    """Align a list of (ref_codes, qry_codes) numpy fragment pairs; returns
    per-pair op arrays in FORWARD order (one-shot FragmentAligner, whose
    device and mesh rules apply: None is the card, "cpu" the CPU)."""
    fa = FragmentAligner(bucket_sizes=bucket_sizes, batch_cells=batch_cells,
                         dp_fn=dp_fn, device=device, mesh=mesh)
    fa.submit(ref_frags, qry_frags)
    return fa.finish()


def ops_to_alignment(ops: np.ndarray, ref_chars: np.ndarray,
                     qry_chars: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Expand forward-order ops into gapped aligned rows (ASCII uint8).

    Mirrors the gap-insertion loop of ksw2_alignment
    (src/ksw2_alignment.cpp:264-272): OP_D puts '-' in the ref row,
    OP_I puts '-' in the qry row.
    """
    take_ref = ops != OP_D        # M and I consume ref chars
    take_qry = ops != OP_I        # M and D consume qry chars
    ref_idx = np.cumsum(take_ref) - 1
    qry_idx = np.cumsum(take_qry) - 1
    a1 = np.where(take_ref, ref_chars[np.maximum(ref_idx, 0)],
                  ord("-")).astype(np.uint8)
    a2 = np.where(take_qry, qry_chars[np.maximum(qry_idx, 0)],
                  ord("-")).astype(np.uint8)
    return a1, a2
