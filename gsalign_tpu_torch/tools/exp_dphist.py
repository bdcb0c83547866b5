"""The DP problems by bucket and the seed hits per lane of one align, the
PyTorch port's counterpart of the JAX package's tools/exp_dphist.py.

    python -m gsalign_tpu_torch.tools.exp_dphist [TAG]
        [--dir DIR] [--device cuda|cpu]

TAG (default human_250mb) names a pair directory under DIR (default: the
bench's cache); a bench configuration's pair and index are made there where
they are missing (tools/common.pair_dir). --device cuda (the default)
raises without a card.

Runs compare_genomes once on the pair (outputs to TAG/hist_out.*) with
GSALIGN_DP_STATS=1, and prints: the [dp_stats] line that
ops/dp.FragmentAligner.finish writes (problems and Mcells a bucket); the
records each seed-scan lane emitted, over every round (the lane state's
F_OUT_N, the JAX scan's per-lane n; they size the emit buffers): lanes,
mean, p50, p90, p99, p99.9 and max; and the run's stage seconds. Last, one
JSON line with the same numbers, the run's counts (ANI, SNVs, insertions,
deletions) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np

from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.genome.fasta import read_fasta
from gsalign_tpu_torch.index.io import load_index
from gsalign_tpu_torch.ops import seeding
from gsalign_tpu_torch.pipeline.align import compare_genomes
from gsalign_tpu_torch.tools.common import (add_pair_args, card_name,
                                            device_of, pair_dir, sync)


@contextlib.contextmanager
def dp_stats_env():
    """GSALIGN_DP_STATS=1 inside the block, as it was after."""
    old = os.environ.get("GSALIGN_DP_STATS")
    os.environ["GSALIGN_DP_STATS"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("GSALIGN_DP_STATS")
        else:
            os.environ["GSALIGN_DP_STATS"] = old


def dphist(d: str, tag: str, device) -> dict:
    """The histogram of the pair directory d (module docstring)."""
    fm = load_index(os.path.join(d, "ref_idx"))
    qry = read_fasta(os.path.join(d, "qry.fa"))
    rounds, err = [], io.StringIO()
    with dp_stats_env(), contextlib.redirect_stderr(err):
        stats, collector, _ = compare_genomes(
            fm, qry, AlignConfig(), output_prefix=os.path.join(d, "hist_out"),
            verbose=False, device=device, seed_rounds=rounds)
        sync(device)
    lines = err.getvalue().splitlines(keepends=True)
    sys.stderr.writelines(ln for ln in lines
                          if not ln.startswith("[dp_stats]"))
    n = np.concatenate([rnd[4][seeding.F_OUT_N] for rnd in rounds])
    p50, p90, p99, p999 = (float(p) for p in
                           np.percentile(n, [50, 90, 99, 99.9]))
    return {"tag": tag,
            "dp_stats": "".join(ln for ln in lines
                                if ln.startswith("[dp_stats]")).strip(),
            "lanes": int(n.size), "mean": float(n.mean()), "p50": p50,
            "p90": p90, "p99": p99, "p99.9": p999, "max": int(n.max()),
            "stage_times": dict(stats.stage_times),
            "alignments": stats.local_alignment_num,
            "counts": [f"{stats.ani:.2f}", collector.n_snv, collector.n_ins,
                       collector.n_del],
            "card": card_name(device)}


def report(out: dict) -> None:
    """The JAX tool's lines, after the [dp_stats] line."""
    print(out["dp_stats"])
    print(f"lanes={out['lanes']} emit-per-lane: mean={out['mean']:.1f} "
          f"p50={out['p50']:.0f} p90={out['p90']:.0f} p99={out['p99']:.0f} "
          f"p99.9={out['p99.9']:.0f} max={out['max']}")
    print("stage_times:", {k: round(v, 3)
                           for k, v in out["stage_times"].items()},
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.exp_dphist",
        description="DP problems by bucket and seed hits per lane.")
    ap.add_argument("tag", nargs="?", default="human_250mb")
    add_pair_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    out = dphist(pair_dir(args.dir, args.tag), args.tag, device)
    report(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
