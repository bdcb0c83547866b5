"""Benchmark of the PyTorch port on one CUDA card.

    python -m gsalign_tpu_torch.bench

Prints one JSON line per configuration, then the DP kernels' rates and a
headline line (the largest configuration that ran). The configurations
are the JAX package's bench.py ones, from tests/make_testdata.make_pair:
4.6 Mb (E. coli scale), 12 Mb (yeast scale), 100 Mb (C. elegans scale) and
250 Mb. GSALIGN_BENCH_SMALL=1 keeps the first two; GSALIGN_BENCH_ONLY=<tag>
runs one.

For each configuration the data and the index are made once and kept
under <tmp>/gsalign_bench_torch/<tag> (tempfile.gettempdir(); the JAX
bench's directory is another); the index is built in a fresh process and
its build seconds kept beside it. Then one process lays out the device
tables (kept on the index), aligns the pair once to warm up (the kernels'
build, where it is not done yet, falls there) and REPS[tag] times more. A row reports the median of the timed runs as
`value`, with their count (`runs`) and `spread` (max - min), the seconds
of the table layout (timed apart, before the warm-up: it is paid once per
index and process) and of the warm-up, the output counts (and whether they
equal the JAX package's record, BENCH_r05.json), the index build seconds,
and the median run's stage seconds, scan iterations and kernel launches,
tagged with the backend, the device's name and its power limit.
vs_baseline is null: the C reference's seconds in bench.py were taken on
another host, and the port carries no C-reference run.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(tempfile.gettempdir(), "gsalign_bench_torch")
REPS = {"ecoli_4.6mb": 5, "yeast_12mb": 3, "celegans_100mb": 3,
        "human_250mb": 2}
# (ANI %, SNVs, insertions, deletions) of the JAX package's runs of the
# same pairs (BENCH_r05.json; 4.6 Mb: its CLI run, chip_smoke.EXPECT_46)
JAX_RECORD = {"ecoli_4.6mb": ("99.22", 22909, 1163, 1120),
              "yeast_12mb": ("99.22", 59984, 3014, 3068),
              "celegans_100mb": ("99.23", 499968, 24987, 24987),
              "human_250mb": ("99.23", 1249596, 62398, 62396)}


def configs():
    """[(tag, total_len)] after GSALIGN_BENCH_SMALL / GSALIGN_BENCH_ONLY."""
    out = [("ecoli_4.6mb", 4_600_000), ("yeast_12mb", 12_000_000)]
    if not os.environ.get("GSALIGN_BENCH_SMALL"):
        out += [("celegans_100mb", 100_000_000), ("human_250mb", 250_000_000)]
    only = os.environ.get("GSALIGN_BENCH_ONLY")
    if only:
        out = [c for c in out if c[0] == only]
    return out


def ensure_data(d: str, total_len: int):
    """(ref.fa, qry.fa) of make_pair(total_len) in d, made once."""
    os.makedirs(d, exist_ok=True)
    ref_fa = os.path.join(d, "ref.fa")
    qry_fa = os.path.join(d, "qry.fa")
    if not (os.path.exists(ref_fa) and os.path.exists(qry_fa)):
        tests = os.path.join(_REPO, "tests")
        if tests not in sys.path:
            sys.path.insert(0, tests)
        from make_testdata import make_pair, write_fasta
        ref, qry = make_pair(total_len=total_len)
        write_fasta(ref_fa, ref)
        write_fasta(qry_fa, qry)
    return ref_fa, qry_fa


def ensure_index(d: str, ref_fa: str):
    """(index prefix, build seconds) of ref_fa's index in d. A missing
    index is built in a fresh process (an index built after another
    configuration's runs in this one would time this process's state), and
    its seconds, taken after the imports and before the save, kept in
    build_seconds.json."""
    from gsalign_tpu_torch.index.io import index_loadable
    prefix = os.path.join(d, "ref_idx")
    marker = os.path.join(d, "build_seconds.json")
    if not (index_loadable(prefix) and os.path.exists(marker)):
        code = (
            "import json, time\n"
            "from gsalign_tpu_torch.genome.fasta import read_fasta\n"
            "from gsalign_tpu_torch.genome.packing import pack_genome\n"
            "from gsalign_tpu_torch.index.fmindex import build_fmindex\n"
            "from gsalign_tpu_torch.index.io import save_index\n"
            "t0 = time.time()\n"
            f"fm = build_fmindex(pack_genome(read_fasta({ref_fa!r})))\n"
            "dt = time.time() - t0\n"
            f"save_index(fm, {prefix!r})\n"
            f"json.dump({{'seconds': dt}}, open({marker!r}, 'w'))\n")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        subprocess.run([sys.executable, "-c", code], env=env, check=True)
    with open(marker) as fh:
        return prefix, json.load(fh)["seconds"]


def card_info(device):
    """(device name, power limit in W or None) of a torch device."""
    import torch
    if device.type != "cuda":
        return str(device), None
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, check=True, timeout=60)
        return name, float(smi.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return name, None


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the align path, by kernel name (each counts
    its launches in `.launches`; on CPU tensors none launches)."""
    from gsalign_tpu_torch.ops import dp_cuda, gather, seed_cuda
    return {"dp_small": dp_cuda.dp_small, "dp_any": dp_cuda.dp_any,
            "masked_gather": gather.masked_gather,
            "seed_scan": seed_cuda.seed_scan,
            "seed_lockstep": seed_cuda.seed_lockstep,
            "resolve_sa": seed_cuda.resolve_sa}


def run_config(tag: str, total_len: int, bench_dir: str = BENCH_DIR,
               reps=None, device=None) -> dict:
    """One configuration's row (module docstring). reps defaults to
    REPS[tag]; device as compare_genomes' (None: the CUDA card)."""
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.index.io import load_index
    from gsalign_tpu_torch.ops.rank import DeviceFMIndex
    from gsalign_tpu_torch.pipeline.align import compare_genomes
    from gsalign_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    d = os.path.join(bench_dir, tag)
    ref_fa, qry_fa = ensure_data(d, total_len)
    prefix, build_s = ensure_index(d, ref_fa)
    fm = load_index(prefix)
    qry_records = read_fasta(qry_fa)
    cfg = AlignConfig()
    out = os.path.join(d, "bench_out")

    wrappers = kernel_wrappers()

    def align():
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.time()
        res = compare_genomes(fm, qry_records, cfg, output_prefix=out,
                              verbose=False, device=dev)
        return time.time() - t0, res, {k: fn.launches
                                       for k, fn in wrappers.items()}

    # the device tables, laid out once and kept on the index: timed apart,
    # so neither the warm-up nor a timed run holds the layout
    t0 = time.time()
    DeviceFMIndex.from_host(fm, dev)
    tables_s = time.time() - t0
    warm_s = align()[0]
    runs = [align() for _ in range(REPS.get(tag, 3) if reps is None
                                   else reps)]
    walls = [w for w, _, _ in runs]
    median = statistics.median(walls)
    # the run whose wall is nearest the median gives the counts and stages
    _, (stats, collector, _), launches = min(
        runs, key=lambda r: abs(r[0] - median))
    name, power = card_info(dev)
    ani = f"{stats.ani:.2f}"
    counts = (ani, collector.n_snv, collector.n_ins, collector.n_del)
    return {
        "metric": f"{tag}_align_wallclock",
        "value": median,
        "unit": "seconds",
        "vs_baseline": None,
        "runs": len(walls),
        "spread": max(walls) - min(walls),
        "walls": walls,
        "warmup_seconds": warm_s,
        "table_layout_seconds": tables_s,
        "aligned_bp_per_s": stats.total_alignment_length / median,
        "ani_pct": float(ani),
        "alignments": stats.local_alignment_num,
        "snv": collector.n_snv,
        "ins": collector.n_ins,
        "dele": collector.n_del,
        "counts_equal_jax_record": (counts == JAX_RECORD[tag]
                                    if tag in JAX_RECORD else None),
        "index_build_seconds": build_s,
        "index_build_fresh_process": True,
        "stage_seconds": dict(stats.stage_times),
        "seed_lanes": sum(-(-len(q) // cfg.seed_exploration_chunk)
                          for _, q in qry_records),
        "scan_iterations": list(stats.seed_scan_iterations),
        "kernel_launches": launches,
        "sa_mode": os.environ.get("GSALIGN_SA_MODE", "xla"),
        "backend": "torch-cuda" if dev.type == "cuda" else "torch-cpu",
        "device": name,
        "power_limit_w": power,
    }


def dp_gcells(L: int = 128, B: int = 2048, iters: int = 4,
              device=None) -> float:
    """DP cells a second, traceback included, of ops/dp_cuda.dp_align on
    B problems of L bases (bench.py's dp_gcells inputs): the best of three
    timings of `iters` launches, each ended by a synchronisation."""
    import numpy as np
    import torch
    from gsalign_tpu_torch.ops import dp_cuda
    from gsalign_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (B, L)).astype(np.uint8)
    t = q.copy()
    m = rng.random((B, L)) < 0.05
    t[m] = (t[m] + rng.integers(1, 4, m.sum())) % 4
    ql = np.full(B, L, np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (q, t, ql, ql.copy())]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dp_cuda.dp_align(*args, L)
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        for _ in range(iters):
            dp_cuda.dp_align(*args, L)
        sync()
        best = min(best, time.time() - t0)
    return float(B) * L * L * iters / best / 1e9


def main() -> int:
    headline = None
    for tag, total_len in configs():
        row = run_config(tag, total_len)
        print(json.dumps(row), flush=True)    # rows stream as they finish
        headline = dict(row, metric="pair_align_wallclock", config=tag)
    for metric, L, B in (("dp_cuda_gcells_per_s", 128, 2048),
                         ("dp_cuda_gcells_per_s_L256", 256, 1024)):
        print(json.dumps({"metric": metric, "value": dp_gcells(L, B),
                          "unit": "Gcells/s", "vs_baseline": None}),
              flush=True)
    if headline is not None:
        print(json.dumps(headline), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
