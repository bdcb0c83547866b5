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
in the first round, the seconds of host reconciliation of the last run,
and the device with, on a card, its power limit in watts.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from gsalign_tpu_torch.genome.fasta import read_fasta
from gsalign_tpu_torch.genome.packing import chars_to_codes
from gsalign_tpu_torch.index.io import load_index
from gsalign_tpu_torch.ops import seeding
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from gsalign_tpu_torch.utils.device import resolve_device


def pair_dir(root: str, tag: str) -> str:
    """root/tag, with a bench configuration's pair and index made there
    where they are missing."""
    from gsalign_tpu_torch import bench
    d = os.path.join(root, tag)
    sizes = {"ecoli_4.6mb": 4_600_000, "yeast_12mb": 12_000_000,
             "celegans_100mb": 100_000_000, "human_250mb": 250_000_000}
    if tag in sizes:
        ref_fa, _ = bench.ensure_data(d, sizes[tag])
        bench.ensure_index(d, ref_fa)
    return d


def run(d: str, tag: str, n_segments: int, reps: int, device) -> dict:
    import torch
    from gsalign_tpu_torch.bench import card_info
    dfm = DeviceFMIndex.from_host(load_index(os.path.join(d, "ref_idx")),
                                  device)
    codes = [chars_to_codes(q) for _, q in
             read_fasta(os.path.join(d, "qry.fa"))]
    times, res, stats, rounds = [], None, {}, []
    for r in range(reps + 1):
        stats, rounds = {}, []
        t0 = time.time()
        res = seeding.find_seeds_all(dfm, codes, n_segments=n_segments,
                                     stats=stats, rounds=rounds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
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
        "round_lanes": stats["round_lanes"],
        "poisoned_at_bound": stats["poisoned_at_bound"][0],
        "poisoned_full": stats["poisoned_full"][0],
        "host_s": stats.get("host_s", 0.0),
        "device": name, "power_limit_w": watts}


def main(argv=None) -> int:
    from gsalign_tpu_torch.bench import BENCH_DIR
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.exp_seeding",
        description="Seed-stage wall clock at a number of segments.")
    ap.add_argument("tag", nargs="?", default="yeast_12mb")
    ap.add_argument("n_segments", nargs="?", type=int, default=1)
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("--dir", default=BENCH_DIR,
                    help=f"directory of the pair directories (default "
                         f"{BENCH_DIR})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    out = run(pair_dir(args.dir, args.tag), args.tag, args.n_segments,
              max(1, args.reps), device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
