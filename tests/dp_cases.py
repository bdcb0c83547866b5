"""DP problem batches and the ksw2 oracle cases, shared by the PyTorch
port's DP tests and chip_smoke.py (no JAX)."""

from __future__ import annotations

import gzip
import os

import numpy as np

from gsalign_tpu_torch.genome.packing import NT4_TABLE
from gsalign_tpu_torch.ops.dp import OP_PAD, ops_to_alignment

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")


def make_batch(rng, L, B):
    """Random, related (5% substitutions + short indels) and N-containing
    problems with lengths in (L/2, L]: uint8 codes q, t [B, L] (pad 4) and
    int32 lengths ql, tl."""
    q = np.full((B, L), 4, np.uint8)
    t = np.full((B, L), 4, np.uint8)
    ql = np.empty(B, np.int32)
    tl = np.empty(B, np.int32)
    for i in range(B):
        n = int(rng.integers(L // 2 + 1, L + 1))
        a = rng.integers(0, 4, n).astype(np.uint8)
        kind = i % 3
        if kind == 0:
            b = rng.integers(0, 4, int(rng.integers(L // 2 + 1, L + 1)))
        else:
            b = a.copy()
            sub = rng.random(n) < 0.05
            b[sub] = (b[sub] + rng.integers(1, 4, sub.sum())) % 4
            for _ in range(int(rng.integers(1, 4))):
                p = int(rng.integers(0, len(b)))
                if rng.random() < 0.5:
                    b = np.delete(b, slice(p, p + int(rng.integers(1, 8))))
                else:
                    b = np.insert(b, p, rng.integers(0, 4, int(
                        rng.integers(1, 8))))
            if kind == 2:
                p = int(rng.integers(0, max(1, len(b) - 5)))
                b[p:p + 5] = 4
                a[int(rng.integers(0, n))] = 4
        b = np.asarray(b, np.uint8)[:L]
        q[i, :n] = a
        t[i, :len(b)] = b
        ql[i] = n
        tl[i] = len(b)
    return q, t, ql, tl


def max_abs_err(got: np.ndarray, want: np.ndarray) -> int:
    """Largest |op difference| between two [B, *] reverse-order op arrays
    after OP_PAD is stripped; raises when a problem's op counts differ."""
    worst = 0
    for i in range(want.shape[0]):
        a = got[i][got[i] != OP_PAD].astype(np.int64)
        b = want[i][want[i] != OP_PAD].astype(np.int64)
        if a.shape != b.shape:
            raise AssertionError(f"problem {i}: {a.size} ops vs {b.size}")
        if a.size:
            worst = max(worst, int(np.abs(a - b).max()))
    return worst


def load_oracle():
    """The ksw2 oracle: 120 (ref, qry) string pairs and the reference's
    aligned rows for each."""
    with gzip.open(os.path.join(GOLDEN_DIR, "ksw_oracle_cases.txt.gz"),
                   "rt") as fh:
        cases = [ln.split() for ln in fh.read().strip().splitlines()]
    with gzip.open(os.path.join(GOLDEN_DIR, "ksw_oracle_out.txt.gz"),
                   "rt") as fh:
        outs = [ln.split() for ln in fh.read().strip().splitlines()]
    return cases, outs


def oracle_batch(cases, L):
    """The oracle cases as one padded batch (q, t, ql, tl)."""
    B = len(cases)
    q = np.full((B, L), 4, np.uint8)
    t = np.full((B, L), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for i, (s1, s2) in enumerate(cases):
        qc = NT4_TABLE[np.frombuffer(s1.encode(), np.uint8)]
        tc = NT4_TABLE[np.frombuffer(s2.encode(), np.uint8)]
        q[i, :len(qc)] = qc
        t[i, :len(tc)] = tc
        ql[i], tl[i] = len(qc), len(tc)
    return q, t, ql, tl


def oracle_rows(cases, ops: np.ndarray):
    """Aligned (ref, qry) rows from reverse-order ops, as the oracle file
    writes them."""
    rows = []
    for i, (s1, s2) in enumerate(cases):
        a1, a2 = ops_to_alignment(ops[i][ops[i] != OP_PAD][::-1],
                                  np.frombuffer(s1.encode(), np.uint8),
                                  np.frombuffer(s2.encode(), np.uint8))
        rows.append([a1.tobytes().decode(), a2.tobytes().decode()])
    return rows


def edge_batch(rng, L):
    """Eight problems at the edges of the contract: an empty query, an
    empty target, both empty, one base against a full row and the reverse,
    both full, lengths above L (the wrappers clamp them to L), and a
    target one row into a second warp's strip at 32 rows a warp."""
    q, t, ql, tl = make_batch(rng, L, 8)
    ql[:] = [0, 5, 0, 1, L, L, L + 9, 3]
    tl[:] = [7, 0, 0, L, 1, L, L + 5, 33]
    return q, t, ql, tl


def strip_fill(q, t, ql, tl, strip_rows):
    """Direction nibbles of one problem, D[i][j] for target row i and query
    column j, filled column by column in strips of `strip_rows` rows (the
    order of the CUDA kernels' warp strips). A scalar reference that uses
    only what the recurrence allows: x and v of the cell above, u and y of
    the cell to the left, and the cell-local borders (column 0: u = gap
    open if i > 0 else 0, y = 0; row 0: x = 0, v = gap open if j > 0 else
    0)."""
    from gsalign_tpu_torch.ops.dp import (GAP_OPEN, MATCH, MAX_SC, MISMATCH,
                                          QE2, WILDCARD)
    q = [int(c) for c in q[:ql]]
    t = [int(c) for c in t[:tl]]
    D = np.zeros((tl, ql), np.uint8)
    x_row = [0] * ql                      # x, v of the strip above's last row
    v_row = [GAP_OPEN if j > 0 else 0 for j in range(ql)]
    for i0 in range(0, tl, strip_rows):
        rows = range(i0, min(i0 + strip_rows, tl))
        u = {i: (GAP_OPEN if i > 0 else 0) for i in rows}
        y = {i: 0 for i in rows}
        for j in range(ql):
            x, v = x_row[j], v_row[j]
            for i in rows:
                uu, yy = u[i], y[i]
                sc = 0 if t[i] >= WILDCARD or q[j] >= WILDCARD else (
                    MATCH if t[i] == q[j] else MISMATCH)
                a, b, z = x + v, yy + uu, sc + QE2
                d = 1 if a > z else 0
                z = max(z, a)
                d = 2 if b > z else d
                z = min(max(z, b), MAX_SC)
                u[i], v = z - v, z - uu
                a2, b2 = a - (z - GAP_OPEN), b - (z - GAP_OPEN)
                x, y[i] = max(a2, 0), max(b2, 0)
                D[i, j] = d | (4 if a2 > 0 else 0) | (8 if b2 > 0 else 0)
            x_row[j], v_row[j] = x, v
    return D


def scalar_backtrack(D, ql, tl):
    """ksw2's backtrack state machine over D[i][j]: reverse-order ops."""
    i, j, st, ops = tl - 1, ql - 1, 0, []
    while i >= 0 and j >= 0:
        tmp = int(D[i, j])
        s = (tmp & 3) if st == 0 else (st if (tmp >> (st + 1)) & 1 else 0)
        if s == 0:
            s = tmp & 3
        st = s
        if s == 0:
            ops.append(0)
            i -= 1
            j -= 1
        elif s in (1, 3):
            ops.append(1)
            i -= 1
        else:
            ops.append(2)
            j -= 1
    ops += [1] * (i + 1) + [2] * (j + 1)
    return np.asarray(ops, np.uint8)
