"""Seed-scan diagnostics one query chromosome at a time: each round's lanes,
its seconds, the longest lane's steps and the lane skew, the PyTorch port's
counterpart of the JAX package's tools/seed_stats.py.

    python -m gsalign_tpu_torch.tools.seed_stats [PAIR_DIR ...]
        [--dir DIR] [--device cuda|cpu]

Each PAIR_DIR holds ref.fa, qry.fa and the index ref_idx; one whose name is
a bench configuration's tag has its pair and index made where they are
missing (tools/common.pair_dir). The default is DIR/ecoli_4.6mb and
DIR/celegans_100mb, DIR the bench's cache. --device cuda (the default)
raises without a card.

For each directory, two passes of find_seeds over the query chromosomes in
turn (AlignConfig's seed length and chunk), the first a warm-up, each ended
by its seeds on the host (on a card by torch.cuda.synchronize()). For the
second it prints the pass's wall and, for each scan round, the lanes (B),
the seconds from the round's launch to its results on the host
(fetchwait), the longest lane's steps (max_iter), and p50, p90 and p99 of
the steps of the lanes that took any, and their count (lanes); then the
sum of the rounds' longest steps (total_max_iters). The JAX tool prints a
line a 4096-lane slab; the port launches a round whole, so its lines are
rounds. Last, one JSON line with the same numbers and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.ops import seeding
from gsalign_tpu_torch.tools.common import (add_pair_args, card_name,
                                            device_of, int_percentiles,
                                            load_pair, pair_dir, sync)

DEFAULT_TAGS = ("ecoli_4.6mb", "celegans_100mb")


def stats_of(d: str, device) -> dict:
    """The diagnostics of the pair directory d (module docstring)."""
    _, dfm, _, qcodes = load_pair(d, device)
    cfg = AlignConfig()
    for _ in range(2):                  # the first pass is the warm-up
        rounds, round_s = [], []
        t0 = time.perf_counter()
        for qc in qcodes:
            seeding.find_seeds(dfm, qc, min_seed_length=cfg.min_seed_length,
                               chunk=cfg.seed_exploration_chunk,
                               rounds=rounds, round_s=round_s)
        sync(device)
        wall = time.perf_counter() - t0
    rows = []
    for rnd, secs in zip(rounds, round_s):
        steps = rnd[4][seeding.F_STEPS]
        live = steps[steps > 0]
        rows.append({"B": int(steps.size), "fetchwait_s": secs,
                     "max_iter": int(steps.max()) if steps.size else 0,
                     "p50_90_99": int_percentiles(live, [50, 90, 99])
                     if live.size else [0, 0, 0],
                     "lanes": int(live.size)})
    return {"dir": os.path.basename(os.path.normpath(d)), "wall_s": wall,
            "rounds": rows,
            "total_max_iters": sum(r["max_iter"] for r in rows)}


def report(out: dict) -> None:
    """The JAX tool's lines for one directory."""
    print(f"== {out['dir']} seed wall={out['wall_s']:.3f}s "
          f"rounds={len(out['rounds'])}")
    for r in out["rounds"]:
        p50, p90, p99 = r["p50_90_99"]
        print(f"   round B={r['B']:5d} fetchwait={r['fetchwait_s']:.3f}s "
              f"max_iter={r['max_iter']:5d} p50={p50} p90={p90} p99={p99} "
              f"lanes={r['lanes']}")
    print(f"   total_max_iters={out['total_max_iters']}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.seed_stats",
        description="Seed-scan rounds one query chromosome at a time.")
    ap.add_argument("dirs", nargs="*")
    add_pair_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    dirs = args.dirs or [os.path.join(args.dir, t) for t in DEFAULT_TAGS]
    outs = []
    for d in dirs:
        out = stats_of(pair_dir(*os.path.split(os.path.abspath(d))), device)
        report(out)
        outs.append(out)
    print(json.dumps({"dirs": outs, "card": card_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
