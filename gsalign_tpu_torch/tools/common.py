"""What the port's measurement tools share: the pair directories they read
(a bench configuration's pair and index made where missing), their --dir
and --device arguments, the device they run on, the wait for it, and the
card's name.

A pair directory holds ref.fa, qry.fa and the index ref_idx (the bench's
layout, gsalign_tpu_torch/bench.py).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from gsalign_tpu_torch.utils.device import resolve_device

# the bench's configurations (bench.configs) by tag: genome bases
BENCH_SIZES = {"ecoli_4.6mb": 4_600_000, "yeast_12mb": 12_000_000,
               "celegans_100mb": 100_000_000, "human_250mb": 250_000_000}


def pair_dir(root: str, tag: str) -> str:
    """root/tag, with a bench configuration's pair and index made there
    where they are missing."""
    from gsalign_tpu_torch import bench
    d = os.path.join(root, tag)
    if tag in BENCH_SIZES:
        ref_fa, _ = bench.ensure_data(d, BENCH_SIZES[tag])
        bench.ensure_index(d, ref_fa)
    return d


def add_pair_args(ap: argparse.ArgumentParser) -> None:
    """--dir (the pair directories' parent) and --device."""
    from gsalign_tpu_torch.bench import BENCH_DIR
    ap.add_argument("--dir", default=BENCH_DIR,
                    help=f"directory of the pair directories (default "
                         f"{BENCH_DIR})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu")


def device_of(args) -> torch.device:
    """The device --device names: the card raises where there is none."""
    return resolve_device(None if args.device == "cuda" else args.device)


def sync(device: torch.device) -> None:
    """Wait for the work queued on device (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, device) -> float:
    """Milliseconds of one fn() (which launches kernels): on a card by CUDA
    events, the launches queued behind a spin kernel (about 0.2 ms) so that
    the events read the card and not the host's call; on the CPU by the
    host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(350_000)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def card_name(device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def load_pair(d: str, device, index: str = "ref_idx"):
    """(host index, its device tables, query records, query codes) of the
    pair directory d, with the index d/<index>."""
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import chars_to_codes
    from gsalign_tpu_torch.index.io import load_index
    from gsalign_tpu_torch.ops.rank import DeviceFMIndex
    fm = load_index(os.path.join(d, index))
    dfm = DeviceFMIndex.from_host(fm, device)
    records = read_fasta(os.path.join(d, "qry.fa"))
    return fm, dfm, records, [chars_to_codes(q) for _, q in records]


def int_percentiles(x, qs) -> list:
    """np.percentile of x at qs, each truncated to an int (as the JAX tools
    print them)."""
    return [int(v) for v in np.percentile(x, qs).astype(int)]
