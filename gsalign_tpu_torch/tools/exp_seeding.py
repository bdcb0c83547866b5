"""Wall clock of the seed stage (find_seeds_all) at a number of speculative
segments, the PyTorch port's counterpart of the JAX package's
tools/exp_seeding.py.

    python -m gsalign_tpu_torch.tools.exp_seeding TAG N_SEGMENTS [REPS]
        [--dir DIR] [--device cuda|cpu]

TAG names a pair directory under DIR (default: the bench's cache,
gsalign_tpu_torch/bench.BENCH_DIR) that holds ref.fa, qry.fa and the index
ref_idx. A bench configuration's tag (ecoli_4.6mb, yeast_12mb,
celegans_100mb, human_250mb) has its pair and index made there where they
are missing, as the bench makes them. --device cuda (the default) raises
without a card.

One untimed run, then REPS (default 3) timed runs of find_seeds_all on
every query chromosome with n_segments = N_SEGMENTS (the default slack,
600), each ended by the results on the host (and on the card by
torch.cuda.synchronize()). Prints one JSON line: the JAX tool's keys (tag,
n_segments, best_s, all_s, n_seeds, and finish_iter_pct, the 50th, 90th,
99th and 100th percentile of the per-lane steps, F_STEPS, of the last scan
round, as the JAX tool reads its last round's finish iterations), and
the same percentiles of the first round (round1_steps_pct), the
steps of the longest lane of each round (scan_iterations), the
lanes of each round, the lanes poisoned at a bound and with a full buffer
in the first round, the seconds of the host's work on the records of
the last run's rounds (its seed.hits spans: record positions, keep masks
and the segments' reconciliation), and the device with, on a card, its power limit in watts.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from gsalign_tpu_torch.ops import seeding
from gsalign_tpu_torch.tools.common import (add_pair_args, device_of,
                                            load_pair, pair_dir, sync)
from gsalign_tpu_torch.utils import trace


def run(d: str, tag: str, n_segments: int, reps: int, device) -> dict:
    from gsalign_tpu_torch.bench import card_info
    _, dfm, _, codes = load_pair(d, device)
    times, res, stats, rounds = [], None, {}, []
    for r in range(reps + 1):
        stats, rounds, rec = {}, [], trace.Recorder()
        t0 = time.time()
        with trace.bind(rec):
            res = seeding.find_seeds_all(dfm, codes, n_segments=n_segments,
                                         stats=stats, rounds=rounds)
        sync(device)
        dt = time.time() - t0
        if r > 0:                     # run 0 lays out caches and builds
            times.append(dt)

    def pct(st):
        steps = np.sort(st[seeding.F_STEPS])
        return {f"p{p}": int(steps[min(len(steps) - 1,
                                       len(steps) * p // 100)])
                for p in (50, 90, 99, 100)} if steps.size else {}
    name, watts = card_info(device)
    return {
        "tag": tag, "n_segments": n_segments,
        "best_s": min(times), "all_s": times,
        "n_seeds": sum(int(x[0].shape[0]) for x in res),
        "finish_iter_pct": pct(rounds[-1][4]),
        "round1_steps_pct": pct(rounds[0][4]),
        "scan_iterations": stats["scan_iterations"],
        "round_lanes": [len(rnd[1]) for rnd in rounds],
        "poisoned_at_bound": stats["poisoned_at_bound"][0],
        "poisoned_full": stats["poisoned_full"][0],
        # the host's work on the rounds' records (spans seed.hits)
        "host_s": sum(rec.seconds("seed.hits")),
        "device": name, "power_limit_w": watts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.exp_seeding",
        description="Seed-stage wall clock at a number of segments.")
    ap.add_argument("tag", nargs="?", default="yeast_12mb")
    ap.add_argument("n_segments", nargs="?", type=int, default=1)
    ap.add_argument("reps", nargs="?", type=int, default=3)
    add_pair_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    out = run(pair_dir(args.dir, args.tag), args.tag, args.n_segments,
              max(1, args.reps), device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
