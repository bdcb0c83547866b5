"""Alignment generation for gap FragPairs (stage S9).

Emulates GenerateFragAlignment (src/ProcessCandidateAlignment.cpp:290-351):
seeds contribute length to score/aln_len; pure insertions/deletions become
all-gap rows; equal-length pairs with <= 5 mismatches pair up directly;
everything else goes to the batched device DP (ops/dp_cuda.py) — all DP
problems across all blocks are collected first and dispatched in padded,
size-bucketed batches, replacing the reference's per-pair pthread striding.

Vectorization: per-pair classification and the equal-length mismatch counts
run as concatenated segmented numpy ops over all pairs of all blocks at
once; aligned rows are only materialized for DP pairs (bytes), everything
else is derived on demand from the raw sequences (see pair_rows)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gsalign_tpu_torch.genome.packing import NT4_TABLE
from gsalign_tpu_torch.ops import dp as dp_ops
from gsalign_tpu_torch.pipeline.chain import Block

_GAP = ord("-")


def count_identical(a1: np.ndarray, a2: np.ndarray) -> int:
    """CountIdenticalPairs (src/ProcessCandidateAlignment.cpp:38-47):
    nt4-code equality, so N matches N and '-' (both code 4)."""
    return int((NT4_TABLE[a1] == NT4_TABLE[a2]).sum())


def fragpair_mismatch(ref_chars: np.ndarray, qry_chars: np.ndarray,
                      r_pos: int, q_pos: int, length: int) -> int:
    """CheckFragPairMismatch (src/ProcessCandidateAlignment.cpp:49-61):
    query-N positions are skipped."""
    rf = NT4_TABLE[ref_chars[r_pos:r_pos + length]]
    qf = NT4_TABLE[qry_chars[q_pos:q_pos + length]]
    return int(((qf != 4) & (qf != rf)).sum())


def _segment_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenated [starts[i], starts[i]+lens[i]) ranges: ONE repeat of the
    (start - flat offset) deltas plus an in-place arange add (hot path of
    the writers). int32 when the index space allows — at multi-Mb row sizes
    the first-touch page faults of fresh int64 temporaries dominate the
    writers' host time, so halving the bytes matters more than the ALU."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    hi = int(starts.max()) + total
    dtype = np.int32 if (total < 2**31 and hi < 2**31) else np.int64
    adj = (starts.astype(np.int64)
           - (np.cumsum(lens, dtype=np.int64) - lens)).astype(dtype)
    out = np.repeat(adj, lens)
    out += np.arange(total, dtype=dtype)
    return out


def pair_rows(blk: Block, j: int, qry_chars: np.ndarray,
              ref_chars: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Aligned rows (aln1=ref, aln2=qry) for a non-seed pair, materializing
    the implied rows of non-DP pairs on demand."""
    if blk.aln1[j] is not None:
        return blk.aln1[j], blk.aln2[j]
    q_pos, r_pos = int(blk.q_pos[j]), int(blk.r_pos[j])
    q_len, r_len = int(blk.q_len[j]), int(blk.r_len[j])
    if q_len == 0:
        return (ref_chars[r_pos:r_pos + r_len],
                np.full(r_len, _GAP, dtype=np.uint8))
    if r_len == 0:
        return (np.full(q_len, _GAP, dtype=np.uint8),
                qry_chars[q_pos:q_pos + q_len])
    return (ref_chars[r_pos:r_pos + r_len], qry_chars[q_pos:q_pos + q_len])


def plan_alignments(blocks: List[Block], qry_chars: np.ndarray,
                    ref_chars: np.ndarray, ref_codes=None, qry_codes=None):
    """Classify every pair of every block (seeds / pure indels / direct
    match-ups / DP jobs), set the non-DP part of score/aln_len, and return
    (dp_jobs, ref_frags, qry_frags) for the device DP batch — callers may
    pool the fragments across chromosomes into one batch.

    ref_codes/qry_codes: optional precomputed NT4 codes of the char arrays
    (genome.codes_fwd_rc() / chars_to_codes(qry) are bit-identical to the
    NT4 decode and already exist in the pipeline — recomputing them here
    was a full-genome table gather per chromosome)."""
    if ref_codes is None:
        ref_codes = NT4_TABLE[ref_chars]
    if qry_codes is None:
        qry_codes = NT4_TABLE[qry_chars]

    dp_jobs = []          # (block_idx, pair_idx)
    for bi, blk in enumerate(blocks):
        n = blk.n
        blk.aln1 = [None] * n
        blk.aln2 = [None] * n
        seeds = blk.b_seed
        q_len = blk.q_len
        r_len = blk.r_len
        is_gap_r = (~seeds) & (q_len == 0)
        is_gap_q = (~seeds) & (r_len == 0) & (q_len > 0)
        is_eq = (~seeds) & (q_len == r_len) & (q_len > 0)
        # vectorized mismatch counts for equal-length candidates (native
        # threaded scan when available: no segment-index materialization,
        # no full gathers — the numpy chain dominated plan time)
        eq_idx = np.nonzero(is_eq)[0]
        mism = np.zeros(n, dtype=np.int64)
        if eq_idx.size:
            from gsalign_tpu_torch import native_lib
            lens = q_len[eq_idx]
            counts = native_lib.seg_mismatch(
                qry_codes, ref_codes, blk.q_pos[eq_idx], blk.r_pos[eq_idx],
                lens)
            if counts is not None:
                mism[eq_idx] = counts
            else:
                qi = _segment_indices(blk.q_pos[eq_idx], lens)
                ri = _segment_indices(blk.r_pos[eq_idx], lens)
                qf = qry_codes[qi]
                bad = (qf != 4) & (qf != ref_codes[ri])
                bounds = np.cumsum(lens)[:-1]
                mism[eq_idx] = np.add.reduceat(
                    bad, np.concatenate([[0], bounds])) if lens.size else 0
                # reduceat quirk: empty segments impossible (q_len > 0)
        direct = is_eq & (mism <= 5)
        needs_dp = (~seeds) & (q_len > 0) & (r_len > 0) & ~direct

        score = int(q_len[seeds].sum()) + \
            int((q_len[direct] - mism[direct]).sum())
        aln_len = int(q_len[seeds].sum()) + int(q_len[direct].sum()) + \
            int(r_len[is_gap_r].sum()) + int(q_len[is_gap_q].sum())
        blk.score = score
        blk.aln_len = aln_len
        for j in np.nonzero(needs_dp)[0]:
            dp_jobs.append((bi, int(j)))

    ref_frags = []
    qry_frags = []
    for bi, j in dp_jobs:
        blk = blocks[bi]
        r_pos, q_pos = int(blk.r_pos[j]), int(blk.q_pos[j])
        # zero-copy uint8 views: the DP batch assembler copies them into
        # its padded uint8 batch arrays
        ref_frags.append(ref_codes[r_pos:r_pos + int(blk.r_len[j])])
        qry_frags.append(qry_codes[q_pos:q_pos + int(blk.q_len[j])])
    return dp_jobs, ref_frags, qry_frags


def finish_alignments(blocks: List[Block], dp_jobs, ops_list,
                      qry_chars: np.ndarray, ref_chars: np.ndarray) -> None:
    """Expand the DP op lists into aligned rows and fold score/aln_len into
    the blocks (one cumsum-rebased pass over all pairs, no per-pair loop)."""
    if dp_jobs:
        ops_all = np.concatenate(ops_list)
        lens = np.asarray([len(o) for o in ops_list], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lens)])
        total = int(starts[-1])
        pid = np.repeat(np.arange(len(dp_jobs)), lens)
        take_ref = ops_all != dp_ops.OP_D
        take_qry = ops_all != dp_ops.OP_I
        cr = np.concatenate([[0], np.cumsum(take_ref)])[:total]
        cq = np.concatenate([[0], np.cumsum(take_qry)])[:total]
        r0 = np.asarray([int(blocks[bi].r_pos[j]) for bi, j in dp_jobs],
                        dtype=np.int64)
        q0 = np.asarray([int(blocks[bi].q_pos[j]) for bi, j in dp_jobs],
                        dtype=np.int64)
        r_glob = r0[pid] + (cr - cr[starts[pid]])
        q_glob = q0[pid] + (cq - cq[starts[pid]])
        a1_all = np.where(take_ref, ref_chars[r_glob], _GAP) \
            .astype(np.uint8)
        a2_all = np.where(take_qry, qry_chars[q_glob], _GAP) \
            .astype(np.uint8)
        ident = (NT4_TABLE[a1_all] == NT4_TABLE[a2_all])
        per_ident = np.add.reduceat(ident, starts[:-1]) if total else \
            np.zeros(0, dtype=np.int64)
        for k, (bi, j) in enumerate(dp_jobs):
            blk = blocks[bi]
            s, e = int(starts[k]), int(starts[k + 1])
            blk.aln1[j] = a1_all[s:e]
            blk.aln2[j] = a2_all[s:e]
            blk.aln_len += e - s
            blk.score += int(per_ident[k])


def generate_alignments(blocks: List[Block], qry_chars: np.ndarray,
                        ref_chars: np.ndarray, cfg, dp_fn=None, device=None,
                        mesh=None) -> None:
    """Fill aln rows for DP pairs; set per-block score/aln_len.

    One-chromosome convenience wrapper over plan / ops/dp.FragmentAligner /
    finish (compare_genomes pools DP fragments across chromosomes
    instead). cfg is an AlignConfig (its dp_buckets and dp_batch_cells);
    dp_fn, device and mesh are FragmentAligner's: device None is the card
    and raises without one, "cpu" asks for the CPU."""
    dp_jobs, ref_frags, qry_frags = plan_alignments(blocks, qry_chars,
                                                    ref_chars)
    ops_list = []
    if dp_jobs:
        aligner = dp_ops.FragmentAligner(
            bucket_sizes=cfg.dp_buckets, batch_cells=cfg.dp_batch_cells,
            dp_fn=dp_fn, device=device, mesh=mesh)
        aligner.submit(ref_frags, qry_frags)
        ops_list = aligner.finish()
    finish_alignments(blocks, dp_jobs, ops_list, qry_chars, ref_chars)
