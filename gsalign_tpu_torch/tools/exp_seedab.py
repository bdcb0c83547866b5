"""The seed scan with the INIT-order jump (INIT-12) on and off, the PyTorch
port's counterpart of the JAX package's tools/exp_seedab.py.

    python -m gsalign_tpu_torch.tools.exp_seedab [TAG ...]
        [--dir DIR] [--device cuda|cpu]

Each TAG (default ecoli_4.6mb celegans_100mb) names a pair directory under
DIR (default: the bench's cache); a bench configuration's pair and index
are made there where they are missing (tools/common.pair_dir). --device
cuda (the default) raises without a card.

For each tag, find_seeds_all over every query chromosome with init12 on,
then off, 1 + 2 times each, each run ended by its seeds on the host (on a
card by torch.cuda.synchronize()). Prints a line for each: the best wall
of the runs, the sum over the rounds of the longest lane's steps (iters),
and whether the seeds equal those with INIT-12 on (same). The JAX tool
also sweeps its 4096-lane slab size (MAX_LANES_PER_CALL 8192 and 16384);
the port launches one scan a round with no slabs, so it has no such
rows. Last, one JSON line with the same numbers and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.ops import seeding
from gsalign_tpu_torch.tools.common import (add_pair_args, card_name,
                                            device_of, load_pair, pair_dir,
                                            sync)

DEFAULT_TAGS = ("ecoli_4.6mb", "celegans_100mb")


def ab(d: str, tag: str, device, reps: int = 2) -> dict:
    """INIT-12 on and off on the pair directory d (module docstring)."""
    _, dfm, _, codes = load_pair(d, device)
    cfg = AlignConfig()
    rows, base = [], None
    for init12 in (True, False):
        best, iters, res = float("inf"), None, None
        for _ in range(1 + reps):       # the first run lays out and builds
            stats = {}
            t0 = time.perf_counter()
            res = seeding.find_seeds_all(
                dfm, codes, min_seed_length=cfg.min_seed_length,
                chunk=cfg.seed_exploration_chunk, init12=init12,
                stats=stats)
            sync(device)
            dt = time.perf_counter() - t0
            if dt < best:
                best, iters = dt, sum(stats["scan_iterations"])
        if base is None:
            base = res
        same = all(np.array_equal(a[i], b[i])
                   for a, b in zip(base, res) for i in range(3))
        rows.append({"init12": init12, "wall_s": best, "iters": iters,
                     "same": same})
    return {"tag": tag, "rows": rows}


def report(out: dict) -> None:
    """The JAX tool's lines for one tag."""
    for r in out["rows"]:
        print(f"{out['tag']} init12={int(r['init12'])} "
              f"wall={r['wall_s']:.3f}s iters={r['iters']} "
              f"same={r['same']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.exp_seedab",
        description="The seed scan with INIT-12 on and off.")
    ap.add_argument("tags", nargs="*", default=list(DEFAULT_TAGS))
    add_pair_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    outs = []
    for tag in args.tags:
        out = ab(pair_dir(args.dir, tag), tag, device)
        report(out)
        outs.append(out)
    print(json.dumps({"tags": outs, "card": card_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
