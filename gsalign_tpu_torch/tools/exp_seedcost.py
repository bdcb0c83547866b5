"""The seed step's cost piece by piece over a configuration's real index
tables, the PyTorch port's counterpart of the JAX package's
tools/exp_seedcost.py.

    python -m gsalign_tpu_torch.tools.exp_seedcost [TAG] [B] [K] [MAX_OUT]
        [--dir DIR] [--device cuda|cpu] [--index NAME]

TAG (default ecoli_4.6mb) names a pair directory under DIR (default: the
bench's cache); a bench configuration's pair and index are made there
where they are missing (tools/common.pair_dir). --index picks the index
in it (default ref_idx). --device cuda (the default) raises without a
card.

B lanes (default 512) take K iterations (default 500) of each of six
bodies, each the one before plus one piece of the seed scan's step (the
seedcost kernel, csrc/probe.cu; ops/probe.PIECES): 0 the loop alone, 1
the query words and their metadata, 2 two comb_pairs reads, 3 two
order-3 ranks, 4 a 256-base text compare, 5 the record planes (MAX_OUT a
lane, default 128). Prints the JAX tool's header line (tag, B, K and the
tables' MB) with, on a card, each instance's registers a thread and
resident warps an SM and seed_scan's beside them, then its line a piece:
the best of 3 launches' device time (CUDA events) over K, in µs an
iteration; then one JSON line. Pieces 4 and 5 need text rows, which only
a direct (full-SA, narrow) index has: on another index their lines say
so, where the JAX tool fails. The pieces do not add up to a scan step:
the probes read the query from q_rows in device memory (their look jumps
across the whole query), where seed_scan stages a lane's window in shared
memory.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.ops import probe, seeding
from gsalign_tpu_torch.tools.common import (add_pair_args, card_name,
                                            device_ms, device_of, load_pair,
                                            pair_dir)


def tables(d: str, device, index: str = "ref_idx"):
    """(device tables, query rows) of the pair directory d: the index
    d/<index> and every query chromosome's codes in one run, as the JAX
    tool reads them."""
    _, dfm, _, codes = load_pair(d, device, index)
    q_rows = seeding.build_qrows(torch.from_numpy(np.concatenate(codes))
                                 .to(device))
    return dfm, q_rows


def label(piece: int) -> str:
    """The JAX tool's label of a piece's line."""
    return f"{piece} {probe.PIECES[piece]:<21s}:"


def measure(dfm, q_rows, B: int, K: int, max_out: int, device,
            reps: int = 3) -> dict:
    """Every piece the index allows, one warm-up launch and `reps` timed
    ones each: {"us": {piece: best µs an iteration, or None where the
    index has no text rows}, "outs": {piece: its SeedcostOut}}."""
    us, outs = {}, {}
    for piece in range(len(probe.PIECES)):
        if piece in probe.TEXT_PIECES and not dfm.direct_ok:
            us[piece] = None
            continue
        out = probe.seedcost(dfm, q_rows, piece, B, K, max_out)
        outs[piece] = out
        best = min(device_ms(lambda: probe.seedcost(
            dfm, q_rows, piece, B, K, max_out, out=out), device)
            for _ in range(reps))
        us[piece] = best * 1e3 / K
    return {"us": us, "outs": outs}


def cost(d: str, tag: str, B: int, K: int, max_out: int, device,
         index: str = "ref_idx") -> dict:
    """The whole tool on the pair directory d (module docstring)."""
    dfm, q_rows = tables(d, device, index)
    mb = {name: t.numel() * t.element_size() / 1e6 for name, t in (
        ("comb", dfm.comb_pairs), ("t3", dfm.t3), ("qrows", q_rows),
        ("text", dfm.text_rows))}
    occ = probe.occupancy(dfm.wide, AlignConfig().seed_exploration_chunk) \
        if device.type == "cuda" else {}
    res = measure(dfm, q_rows, B, K, max_out, device)
    return {"tag": tag, "index": index, "B": B, "K": K, "max_out": max_out,
            "wide": dfm.wide, "mb": mb, "occupancy": occ, "us": res["us"],
            "outs": res["outs"], "device": str(device),
            "card": card_name(device)}


def report(out: dict) -> None:
    """The JAX tool's lines (the header with the occupancy readings)."""
    mb = out["mb"]
    occ = " ".join(f"{name}={r['regs']}r/{r['warps_per_sm']}w"
                   for name, r in out["occupancy"].items())
    print(f"tag={out['tag']} B={out['B']} K={out['K']} "
          f"comb={mb['comb']:.1f}MB t3={mb['t3']:.1f}MB "
          f"qrows={mb['qrows']:.1f}MB text={mb['text']:.1f}MB"
          + (f" regs/warps-per-SM: {occ}" if occ else ""), flush=True)
    for piece, us in out["us"].items():
        if us is None:
            print(label(piece), "- (no text rows: the index is not direct)",
                  flush=True)
        else:
            print(label(piece), round(us, 1), "us/iter", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.exp_seedcost",
        description="The seed step's cost piece by piece.")
    ap.add_argument("tag", nargs="?", default="ecoli_4.6mb")
    ap.add_argument("B", nargs="?", type=int, default=512)
    ap.add_argument("K", nargs="?", type=int, default=500)
    ap.add_argument("max_out", nargs="?", type=int, default=128)
    ap.add_argument("--index", default="ref_idx",
                    help="the index in the pair directory (default ref_idx)")
    add_pair_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    out = cost(pair_dir(args.dir, args.tag), args.tag, args.B, args.K,
               args.max_out, device, args.index)
    report(out)
    print(json.dumps({k: v for k, v in out.items() if k != "outs"}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
