"""Seed-stage profile: rounds, lanes, steps and the cost of a step, the
PyTorch port's counterpart of the JAX package's tools/exp_seedprof.py.

    python -m gsalign_tpu_torch.tools.exp_seedprof [TAG] [REPS]
        [--dir DIR] [--device cuda|cpu]

TAG (default ecoli_4.6mb) names a pair directory under DIR (default: the
bench's cache); a bench configuration's pair and index are made there where
they are missing (tools/common.pair_dir). --device cuda (the default)
raises without a card.

Prints the device tables of DeviceFMIndex (MB and shape), then REPS
(default 3) runs of find_seeds_all over every query chromosome, each ended
by its seeds on the host (on a card by torch.cuda.synchronize()). For each
scan round (one kernel launch; the JAX tool's 4096-lane slabs are not
carried): its lanes, the longest lane's steps (the JAX tool's iterations),
the seconds from its launch to its results on the host, and the
microseconds a step of the longest lane; the per-lane steps (F_STEPS, the
JAX finish_iters): max, mean, p50/75/90/99, and their sum, the lane-step
integral, as a share of lanes x max (the lane skew). Then the run's host
seconds outside the rounds. The last run goes under
utils/trace.device_trace when GSALIGN_TRACE names a directory; on a card
the tool then prints the share of that run's wall in which the device was
busy and its top device operations by time. Last, one JSON line with the
same numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import torch

from gsalign_tpu_torch.ops import seeding
from gsalign_tpu_torch.tools.common import (add_pair_args, card_name,
                                            device_of, int_percentiles,
                                            load_pair, pair_dir, sync)
from gsalign_tpu_torch.utils import trace

TOP_OPS = 8         # device operations listed from a trace


def tables(dfm) -> dict:
    """{field: [MB, shape]} of every device table of dfm."""
    out = {}
    for f in dataclasses.fields(dfm):
        t = getattr(dfm, f.name)
        if isinstance(t, torch.Tensor):
            out[f.name] = [t.numel() * t.element_size() / 1e6, list(t.shape)]
    return out


def round_row(st, seconds: float) -> dict:
    """One scan round's numbers from its final lane state st."""
    steps = st[seeding.F_STEPS]
    top = int(steps.max()) if steps.size else 0
    integral = int(steps.sum())
    return {"lanes": int(steps.size), "steps": top, "wall_s": seconds,
            "us_per_step": seconds / max(top, 1) * 1e6,
            "mean": float(steps.mean()) if steps.size else 0.0,
            "p50_75_90_99": int_percentiles(steps, [50, 75, 90, 99])
            if steps.size else [0] * 4,
            "integral": integral,
            "integral_pct": 100.0 * integral / max(steps.size * top, 1)}


def profile(d: str, tag: str, reps: int, device,
            trace_dir: str = None) -> dict:
    """The profile of the pair directory d (module docstring); the last
    run is traced into trace_dir (default GSALIGN_TRACE) when one is
    named."""
    _, dfm, _, qcodes = load_pair(d, device)
    out = {"tag": tag, "seq_len": dfm.seq_len, "init_order": dfm.init_order,
           "sa_intv": dfm.sa_intv, "direct_ok": dfm.direct_ok,
           "wide": dfm.wide, "tables": tables(dfm), "reps": [],
           "trace": None, "card": card_name(device)}
    for r in range(reps):
        rounds, round_s = [], []
        traced = trace.device_trace(trace_dir) if r == reps - 1 \
            else contextlib.nullcontext()
        with traced as prof:
            t0 = time.perf_counter()
            seeds = seeding.find_seeds_all(dfm, qcodes, rounds=rounds,
                                           round_s=round_s)
            sync(device)
            total = time.perf_counter() - t0
        out["reps"].append({
            "total_s": total, "seeds": sum(len(s[0]) for s in seeds),
            "rounds": [round_row(rnd[4], s)
                       for rnd, s in zip(rounds, round_s)],
            "host_s": total - sum(round_s)})
        if prof is not None and device.type == "cuda":
            ops = trace.device_ops(prof)
            out["trace"] = {
                "wall_s": total, "busy_s": ops["busy_s"],
                "busy_share": ops["busy_s"] / total, "n_ops": ops["n"],
                "top": [[name, n, us] for name, (n, us) in sorted(
                    ops["ops"].items(), key=lambda kv: -kv[1][1])[:TOP_OPS]]}
    return out


def report(out: dict) -> None:
    """The JAX tool's lines."""
    print(f"tag={out['tag']} seq_len={out['seq_len']} "
          f"init_order={out['init_order']} sa_intv={out['sa_intv']} "
          f"direct_ok={out['direct_ok']} wide={out['wide']}")
    for name, (mb, shape) in out["tables"].items():
        print(f"  table {name}: {mb:8.2f} MB shape={tuple(shape)}")
    for r, rep in enumerate(out["reps"]):
        print(f"rep {r}: total={rep['total_s']:.3f}s seeds={rep['seeds']}")
        for i, rnd in enumerate(rep["rounds"]):
            print(f"  round {i}: lanes={rnd['lanes']:6d} "
                  f"iters={rnd['steps']:6d} wall={rnd['wall_s']:.3f}s -> "
                  f"{rnd['us_per_step']:.1f} us/iter")
            print(f"    finish_iters: max={rnd['steps']} "
                  f"mean={rnd['mean']:.0f} "
                  f"p50/75/90/99={rnd['p50_75_90_99']} "
                  f"integral={rnd['integral']} "
                  f"({rnd['integral_pct']:.1f}% of B*max)")
        print(f"  host/overhead: {rep['host_s']:.3f}s")
    tr = out["trace"]
    if tr is not None:
        print(f"  trace: device busy {tr['busy_s']:.4f} s of "
              f"{tr['wall_s']:.4f} s traced wall "
              f"({100 * tr['busy_share']:.1f} %), {tr['n_ops']} device "
              f"operations")
        for name, n, us in tr["top"]:
            print(f"    {n:6d} x {us / n:8.2f} us  {name[:90]}")
    print(f"card: {out['card']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.exp_seedprof",
        description="Seed-stage rounds, lanes, steps and time a step.")
    ap.add_argument("tag", nargs="?", default="ecoli_4.6mb")
    ap.add_argument("reps", nargs="?", type=int, default=3)
    add_pair_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    out = profile(pair_dir(args.dir, args.tag), args.tag, max(1, args.reps),
                  device)
    report(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
