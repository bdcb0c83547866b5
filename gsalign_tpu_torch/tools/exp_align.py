"""The align stage cut into its parts (chain / plan / DP submit / the rest
of the DP's launches / the wait for the device / the DP's read-back /
finish), the PyTorch port's counterpart of the JAX package's
tools/exp_align.py.

    python -m gsalign_tpu_torch.tools.exp_align [TAG] [REPS]
        [--dir DIR] [--device cuda|cpu]

TAG (default ecoli_4.6mb) names a pair directory under DIR (default: the
bench's cache); a bench configuration's pair and index are made there where
they are missing (tools/common.pair_dir). --device cuda (the default)
raises without a card.

The seeds are found once (find_seeds_all). Then, REPS (default 3) times:
the chain stages of every query chromosome (chain: pipeline/align's
chain_blocks), plan_alignments (plan), one ops/dp.FragmentAligner given
every fragment (dp_submit: the full buckets launch), the leftover buckets
launched as FragmentAligner.finish launches them (dp_rest), the wait for
the device (dp_device: torch.cuda.synchronize(); nothing on the CPU, where
the DP ran inside the launches), FragmentAligner.finish, the read-back and
the unpacking (dp_fetch), and finish_alignments (finish), in seconds; the
number of DP problems (n_dp) and the problems of each bucket width (a
problem longer than the last bucket is counted at its launch width, the
next multiple of 1024, where the JAX tool leaves it out). On a card the
tool also wraps the aligner's dp_fn (ops/dp.py is not changed) to record
each DP launch: its kernel (dp_small or dp_any), L, B, cells (the sum of
its problems' length products) and its device milliseconds by CUDA events
around the launch, and prints their sum beside dp_device: the DP's device
time within the align stage. The JAX tool's GSALIGN_EXP_PALLAS, an A/B
switch of its TPU DP, is not carried. Last, one JSON line with the same
numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.genome.coords import ChrLocIndex
from gsalign_tpu_torch.ops import dp as dp_ops
from gsalign_tpu_torch.ops.seeding import find_seeds_all
from gsalign_tpu_torch.pipeline.align import chain_blocks
from gsalign_tpu_torch.pipeline.generate import (finish_alignments,
                                                 plan_alignments)
from gsalign_tpu_torch.tools.common import (add_pair_args, card_name,
                                            device_of, load_pair, pair_dir,
                                            sync)


def recorded(dp_fn, launches: list):
    """dp_fn, recording each launch in `launches`: its kernel, L, inputs
    and a CUDA event before and after it."""
    from gsalign_tpu_torch.ops import dp_cuda

    def fn(q, t, ql, tl, L):
        n0 = dp_cuda.dp_small.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ops = dp_fn(q, t, ql, tl, L)
        end.record()
        kernel = "dp_small" if dp_cuda.dp_small.launches > n0 else "dp_any"
        launches.append((kernel, (L, q, t, ql, tl), start, end))
        return ops
    return fn


def launch_row(kernel, inputs, start, end) -> dict:
    """A recorded launch's numbers, once the device has finished it."""
    L, q, _, ql, tl = inputs
    cells = int((ql.clamp(0, L).long() * tl.clamp(0, L).long()).sum())
    return {"kernel": kernel, "L": L, "B": int(q.shape[0]), "cells": cells,
            "ms": start.elapsed_time(end)}


def probe(d: str, tag: str, reps: int, device, inputs: list = None) -> dict:
    """The breakdown of the pair directory d (module docstring). With
    `inputs` (a list) on a card, appends each DP launch of the last rep as
    (kernel, (L, q, t, ql, tl)), the inputs it was given."""
    fm, dfm, qry_records, qcodes = load_pair(d, device)
    genome = fm.genome
    cfg = AlignConfig().effective()
    chr_index = ChrLocIndex(genome)
    ref_chars = genome.chars_fwd_rc()
    ref_codes = genome.codes_fwd_rc()
    seeds = find_seeds_all(dfm, qcodes)
    out = {"tag": tag, "reps": [], "card": card_name(device)}
    for rep in range(reps):
        T = dict.fromkeys(("chain", "plan"), 0.0)
        all_rf, all_qf, planned = [], [], []
        for qi, (_, qry_chars) in enumerate(qry_records):
            t0 = time.perf_counter()
            blocks = chain_blocks(*seeds[qi], qry_chars, ref_chars,
                                  chr_index, genome.size, cfg)
            T["chain"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            jobs, rf, qf = plan_alignments(blocks, qry_chars, ref_chars,
                                           ref_codes=ref_codes,
                                           qry_codes=qcodes[qi])
            T["plan"] += time.perf_counter() - t0
            lo = len(all_rf)
            all_rf += rf
            all_qf += qf
            planned.append((qry_chars, blocks, jobs, lo, len(all_rf)))
        launches = []
        t0 = time.perf_counter()
        aligner = dp_ops.FragmentAligner(
            bucket_sizes=cfg.dp_buckets, batch_cells=cfg.dp_batch_cells,
            device=device)
        if device.type == "cuda":
            aligner.dp_fn = recorded(aligner.dp_fn, launches)
        aligner.submit(all_rf, all_qf)
        T["dp_submit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for Lb, part in sorted(aligner.queue.items()):
            mb = max(1, aligner.batch_cells // (Lb * Lb))
            for s in range(0, len(part), mb):
                aligner._dispatch(Lb, part[s:s + mb])
        aligner.queue = {}
        T["dp_rest"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sync(device)
        T["dp_device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ops_all = aligner.finish()
        T["dp_fetch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for qry_chars, blocks, jobs, lo, hi in planned:
            finish_alignments(blocks, jobs, ops_all[lo:hi], qry_chars,
                              ref_chars)
        T["finish"] = time.perf_counter() - t0
        hist = {}
        for rf, qf in zip(all_rf, all_qf):
            Lb = dp_ops.bucket_of(max(len(rf), len(qf)), cfg.dp_buckets)
            hist[Lb] = hist.get(Lb, 0) + 1
        rows = [launch_row(k, x, s, e) for k, x, s, e in launches]
        out["reps"].append({
            "times": T, "n_dp": len(all_rf),
            "buckets": dict(sorted(hist.items())), "launches": rows,
            "dp_event_ms": sum(r["ms"] for r in rows)})
        if inputs is not None and rep == reps - 1:
            inputs.extend((k, x) for k, x, _, _ in launches)
    return out


def report(out: dict) -> None:
    """The JAX tool's lines, and on a card the DP's launches."""
    for r, rep in enumerate(out["reps"]):
        print(f"rep{r}:", {k: round(v, 3) for k, v in rep["times"].items()},
              "n_dp:", rep["n_dp"], "buckets:", rep["buckets"])
        for ln in rep["launches"]:
            print(f"  launch {ln['kernel']} L={ln['L']} B={ln['B']} "
                  f"cells={ln['cells']} {ln['ms']:.4f} ms")
        if rep["launches"]:
            print(f"  dp launches: {len(rep['launches'])}, device "
                  f"{rep['dp_event_ms']:.4f} ms by CUDA events; dp_device "
                  f"{rep['times']['dp_device'] * 1e3:.4f} ms")
    print(f"card: {out['card']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.exp_align",
        description="The align stage cut into plan, DP and finish.")
    ap.add_argument("tag", nargs="?", default="ecoli_4.6mb")
    ap.add_argument("reps", nargs="?", type=int, default=3)
    add_pair_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    out = probe(pair_dir(args.dir, args.tag), args.tag, max(1, args.reps),
                device)
    report(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
