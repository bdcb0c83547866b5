"""Dependent random reads against table size, the PyTorch port's
counterpart of the JAX package's tools/exp_sweep.py.

    python -m gsalign_tpu_torch.tools.exp_sweep [--mb 8,32,...]
        [--device cuda|cpu]

For each table of MB megabytes of arange int32 (default the JAX tool's
grid, 8 to 1,024 MB) and each B of 512, 4,096 and 16,384 lanes, K = 300
dependent reads a lane (the gather_sweep kernel, csrc/probe.cu: v =
table[idx]; idx = (5 idx + v) mod n; acc += v), then the same at B 4,096
over the table's two halves read at one index (the tool's two-call
split). Prints the JAX tool's line for each: the best of 3 launches'
device time (CUDA events) over K, in µs an iteration; then one JSON line
with the gather_sweep instances' registers and resident warps an SM. On
these tables the one-table walk collapses: v = idx, so the next index is
6 idx mod 2^m, 0 within m steps, after which every lane reads word 0; the
two-table walk (7 idx mod the half) stays spread. The grid is the tool's,
as it is.
"""

from __future__ import annotations

import argparse
import json

import torch

from gsalign_tpu_torch.ops import probe
from gsalign_tpu_torch.tools.common import card_name, device_ms
from gsalign_tpu_torch.utils.device import resolve_device

GRID_MB = (8, 32, 64, 128, 256, 512, 1024)
GRID_B = (512, 4096, 16384)
SPLIT_B = 4096
K = 300


def timed(ta, tb, B: int, n: int, device, reps: int = 3) -> dict:
    """One grid point: a warm-up launch, then the best of `reps` timed
    ones. {"us": µs an iteration, "acc", "idx": the last launch's
    results}."""
    idx0 = probe.sweep_start(B, n, device)
    acc, idx = probe.gather_sweep(ta, tb, idx0, K, n)
    best = min(device_ms(lambda: probe.gather_sweep(ta, tb, idx0, K, n),
                         device) for _ in range(reps))
    return {"us": best * 1e3 / K, "acc": acc, "idx": idx}


def sweep(device, mbs=GRID_MB, Bs=GRID_B, on_row=None) -> list:
    """The tool's grid (module docstring): a row {mb, B, form, us} a
    point, each passed to on_row(row, result) as it is measured."""
    rows = []
    for mb in mbs:
        n = mb * (1 << 20) // 4
        table = torch.arange(n, dtype=torch.int32, device=device)
        points = [(B, "one-call", table, None, n) for B in Bs]
        points.append((SPLIT_B, "two-call", table[:n // 2], table[n // 2:],
                       n // 2))
        for B, form, ta, tb, m in points:
            res = timed(ta, tb, B, m, device)
            row = {"mb": mb, "B": B, "form": form, "us": res["us"]}
            rows.append(row)
            if on_row is not None:
                on_row(row, res)
        del table
    return rows


def line(row: dict) -> str:
    """The JAX tool's line of a grid point."""
    if row["form"] == "one-call":
        return (f"table={row['mb']:5d}MB B={row['B']:6d} one-call: "
                f"{row['us']:9.1f} us/iter")
    return (f"table={row['mb']:5d}MB B=4096   two-call: {row['us']:9.1f} "
            f"us/iter")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.exp_sweep",
        description="Dependent random reads against table size.")
    ap.add_argument("--mb", default=",".join(map(str, GRID_MB)),
                    help="table sizes in MB, comma-separated (default the "
                         "JAX tool's grid)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    occ = {}
    if device.type == "cuda":
        occ = {k: v for k, v in probe.occupancy(False, 0).items()
               if k.startswith("gather_sweep")}
        print("gather_sweep regs/warps-per-SM: " + " ".join(
            f"{k}={v['regs']}r/{v['warps_per_sm']}w" for k, v in occ.items()),
            flush=True)
    rows = sweep(device, [int(x) for x in args.mb.split(",")],
                 on_row=lambda row, _: print(line(row), flush=True))
    print(json.dumps({"K": K, "rows": rows, "occupancy": occ,
                      "device": str(device), "card": card_name(device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
