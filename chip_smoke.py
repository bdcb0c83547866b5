#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gsalign_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the card (nvidia-smi name and power limit), the torch and CUDA
     versions, and the build of every kernel source in
     gsalign_tpu_torch/csrc/ (one nvcc each, in parallel);
  2. each DP kernel (dp_small, dp_any) against its plain torch version on
     the card at every bucket width the aligner uses, and on the ksw2
     oracle cases of tests/golden: op codes must be equal;
  3. 100 kb: the port's CLI on the card, byte-identical to the C reference
     outputs in tests/golden (default, -sen, -fmt 2);
  4. 4.6 Mb (E. coli scale, make_pair(4_600_000)): index build and align
     through the CLI on the card (the main path), with the JAX package's
     output counts and sha256 values, and the DP kernels and seed_step
     launched; then the same align with GSALIGN_SA_MODE=pallas, which
     also launches masked_gather;
  5. 12 Mb (yeast scale, make_pair(12_000_000)): align through the CLI in
     the xla and pallas SA modes and on an sa_intv=8 index built through
     the API (resolve_sa launched), each with the JAX package's counts and
     sha256 values;
  6. the seed-stage kernels against their plain torch versions on the
     card: masked_gather on the 12 Mb sa_rows at K = 512; seed_step as the
     whole scan at 4.6 and 12 Mb in both SA modes (equal seeds and equal
     iteration counts per round); resolve_sa on every rank the 12 Mb
     sampled run resolves, against the full suffix array too;
  7. the seed scan's device operations per iteration, under torch.profiler.
Every align run sets the kernels' launch counts to 0 just before it and
reads them just after. The last two lines are the kernels JSON and
{"ok": true, "device": ...}. Without a CUDA device, or without the
repository around it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "_smoke")          # git-ignored scratch, removed
GOLDEN = os.path.join(REPO, "tests", "golden")

SMALL_LS = (64, 128, 256)                    # dp_small's buckets
ANY_LS = (512, 1024, 2048, 3072, 5120)       # dp_any: 3072 = ceil(m/1024)*1024
BATCH_CELLS = 1 << 26                        # AlignConfig.dp_batch_cells

# The JAX package's CPU runs of `gsalign_tpu.cli -r ref.fa -q qry.fa -o out
# -t 1` on make_pair(4_600_000) and make_pair(12_000_000).
EXPECT_46 = {
    "alignments": 3, "aln_len": 4596373, "ani": "99.22",
    "snv": 22909, "ins": 1163, "del": 1120,
    "maf_sha256":
        "53e952e60451789c576d956df421988201be8554be28d92a847f8ec44f954ce6",
    "vcf_sha256_no_reference_line":
        "fce3c3b2753cd3ed03e8650eed2a84aba70677ad339ad67f8df90aea0758f68d",
}
EXPECT_12 = {
    "alignments": 3, "aln_len": 12006256, "ani": "99.22",
    "snv": 59984, "ins": 3014, "del": 3068,
    "maf_sha256":
        "6aabccd9cd01d8de64b6d9e894ec7b77e9fed41b99d5cc382b06866c44632b0e",
    "vcf_sha256_no_reference_line":
        "61e0bc023155c4d73416a16fc28fcb22646c1e449c3633d3132b906eeff8fe6d",
}


def say(*a):
    print(*a, flush=True)


def strip_reference_line(text: bytes) -> bytes:
    return b"\n".join(ln for ln in text.split(b"\n")
                      if not ln.startswith(b"##reference="))


def read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def golden(name: str) -> bytes:
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rb") as fh:
        return fh.read()


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(*argv) -> str:
    """Run the port's CLI in this process; returns its stderr log (also
    echoed)."""
    from gsalign_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        rc = cli.main(["gsalign-tpu-torch", *argv])
    if rc != 0:
        raise RuntimeError(f"CLI {argv} exited {rc}")
    return buf.getvalue()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card() -> str:
    import torch
    from gsalign_tpu_torch.ops import cuda_build, dp_cuda, gather, seed_cuda
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")
    libs = cuda_build.build_all()
    for name in sorted(libs):
        info = cuda_build.build_info[name]
        say(f"[build] gsalign_tpu_torch/csrc/{name}.cu in "
            f"{info['seconds']:.1f} s (all sources in parallel)")
        for ln in info.get("ptxas", "").splitlines():
            if "registers" in ln or "Compiling entry" in ln:
                say(f"[ptxas] {ln.strip()}")
    dp_cuda.build()
    gather.build()
    seed_cuda.build()
    return card


def phase_kernels(seed: int = 0, lengths=None) -> dict:
    """Each kernel against its plain version at full aligner batches.
    Returns per-kernel totals {name: {ms, plain_ms, max_abs_err}}."""
    import torch
    from gsalign_tpu_torch.ops import dp as dp_ops
    from gsalign_tpu_torch.ops import dp_cuda
    from dp_cases import make_batch, max_abs_err
    rng = np.random.default_rng(seed)
    totals = {}
    # one small plain call first: CUDA context and allocator set-up stay
    # out of the timed calls
    warm = [torch.from_numpy(a).cuda() for a in make_batch(rng, 64, 8)]
    dp_ops.dp_align_batch(*warm, 64)
    plan = [(L, dp_cuda.dp_small) for L in SMALL_LS] + \
        [(L, dp_cuda.dp_any) for L in ANY_LS]
    for L, fn in plan:
        if lengths is not None and L not in lengths:
            continue
        B = min(1024, max(1, BATCH_CELLS // (L * L)))
        args = [torch.from_numpy(a).cuda()
                for a in make_batch(rng, L, B)]
        t0 = time.time()
        plain = dp_ops.dp_align_batch(*args, L)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        got = fn(*args, L)
        torch.cuda.synchronize()
        err = max_abs_err(got.cpu().numpy(), plain.cpu().numpy())
        if err:
            raise AssertionError(f"{fn.__name__} L={L}: ops differ from "
                                 f"the plain version (max |diff| {err})")
        ms = cuda_ms(lambda: fn(*args, L), reps=5)
        say(f"[kernel] {fn.__name__:8s} L={L:5d} B={B:5d}  kernel "
            f"{ms:10.3f} ms  plain {plain_ms:10.1f} ms  ops equal")
        tot = totals.setdefault(fn.__name__, {"ms": 0.0, "plain_ms": 0.0,
                                              "max_abs_err": 0})
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
    return totals


def phase_oracle():
    """Both kernels on the ksw2 oracle cases: the reference's aligned rows
    exactly, and the plain version's ops."""
    import torch
    from gsalign_tpu_torch.ops import dp as dp_ops
    from gsalign_tpu_torch.ops import dp_cuda
    from dp_cases import load_oracle, max_abs_err, oracle_batch, oracle_rows
    cases, outs = load_oracle()
    args = [torch.from_numpy(a).cuda() for a in oracle_batch(cases, 256)]
    plain = dp_ops.dp_align_batch(*args, 256).cpu().numpy()
    for fn in (dp_cuda.dp_small, dp_cuda.dp_any):
        ops = fn(*args, 256).cpu().numpy()
        if max_abs_err(ops, plain):
            raise AssertionError(f"{fn.__name__}: oracle ops differ from "
                                 f"the plain version")
        if oracle_rows(cases, ops) != outs:
            raise AssertionError(f"{fn.__name__}: ksw2 oracle rows differ")
    say(f"[oracle] dp_small and dp_any reproduce all {len(cases)} ksw2 "
        f"oracle cases")


def make_data(tag: str, total_len: int) -> str:
    from make_testdata import make_pair, write_fasta
    d = os.path.join(WORK, tag)
    os.makedirs(d, exist_ok=True)
    ref, qry = make_pair(total_len=total_len)
    write_fasta(os.path.join(d, "ref.fa"), ref)
    write_fasta(os.path.join(d, "qry.fa"), qry)
    return d


def phase_100kb():
    d = make_data("100kb", 100_000)
    run_cli("index", f"{d}/ref.fa", f"{d}/idx")
    for tag, flags, files in (
            ("d", [], [("maf", "g_default.maf"), ("vcf", "g_default.vcf")]),
            ("s", ["-sen"], [("maf", "g_sen.maf"), ("vcf", "g_sen.vcf")]),
            ("a", ["-fmt", "2"], [("aln", "g_aln.aln"),
                                  ("vcf", "g_aln.vcf")])):
        t0 = time.time()
        run_cli("-i", f"{d}/idx", "-q", f"{d}/qry.fa", "-o", f"{d}/{tag}",
                *flags)
        wall = time.time() - t0
        for ext, gold in files:
            got = read(f"{d}/{tag}.{ext}")
            want = golden(gold)
            if ext == "vcf":
                got, want = strip_reference_line(got), \
                    strip_reference_line(want)
            if got != want:
                raise AssertionError(f"100 kb {flags or 'default'}: "
                                     f"{tag}.{ext} differs from {gold}")
        say(f"[100kb] {' '.join(flags) or 'default'}: byte-identical to "
            f"{', '.join(g for _, g in files)} ({wall:.2f} s wall)")


def counters():
    """Every kernel wrapper, by kernel name."""
    from gsalign_tpu_torch.ops import dp_cuda, gather, seed_cuda
    return {"dp_small": dp_cuda.dp_small, "dp_any": dp_cuda.dp_any,
            "masked_gather": gather.masked_gather,
            "seed_step": seed_cuda.seed_step,
            "resolve_sa": seed_cuda.resolve_sa}


@contextlib.contextmanager
def sa_mode_env(mode):
    """GSALIGN_SA_MODE set to mode (unset for None) inside the block."""
    if mode is None:
        os.environ.pop("GSALIGN_SA_MODE", None)
    else:
        os.environ["GSALIGN_SA_MODE"] = mode
    try:
        yield
    finally:
        os.environ.pop("GSALIGN_SA_MODE", None)


def align_run(tag: str, d: str, idx: str, expect: dict, sa_mode=None,
              must_launch=(), must_not_launch=()) -> dict:
    """One align through the CLI on the card, with GSALIGN_SA_MODE set to
    sa_mode (unset for None). Launch counts start at 0 just before it and
    are read just after. Checks the outputs against `expect`."""
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.time()
    with sa_mode_env(sa_mode):
        out = run_cli("-i", idx, "-q", f"{d}/qry.fa", "-o", f"{d}/out",
                      "-t", "1")
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    m = re.search(r"Alignment#=(\d+) \(total alignment length=(\d+)\) "
                  r"ANI=([\d.]+)%", out)
    v = re.search(r"identifies (\d+) SNVs, (\d+) insertions, and (\d+) "
                  r"deletions", out)
    it = re.search(r"\[seed\] (\d+) lanes, scan iterations per round: "
                   r"\[([\d, ]+)\]", out)
    st = re.search(r"\[stages\] (.*)", out)
    got = {
        "alignments": int(m.group(1)), "aln_len": int(m.group(2)),
        "ani": m.group(3), "snv": int(v.group(1)), "ins": int(v.group(2)),
        "del": int(v.group(3)),
        "maf_sha256": hashlib.sha256(read(f"{d}/out.maf")).hexdigest(),
        "vcf_sha256_no_reference_line": hashlib.sha256(
            strip_reference_line(read(f"{d}/out.vcf"))).hexdigest(),
    }
    seed_s = float(re.search(r"seed=([\d.]+)s", st.group(1)).group(1))
    say(f"[{tag}] align wall {wall:.2f} s; stages {st.group(1)}")
    say(f"[{tag}] seed scan: {it.group(1)} lanes, iterations per round "
        f"[{it.group(2)}]")
    say(f"[{tag}] kernel launches in the run: {launches}")
    say(f"[{tag}] outputs {json.dumps(got)}")
    if got != expect:
        raise AssertionError(f"{tag} outputs differ from the JAX run: "
                             f"expected {expect}")
    missing = [k for k in must_launch if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: {missing} never ran on the path: "
                             f"{launches}")
    extra = [k for k in must_not_launch if launches[k] != 0]
    if extra:
        raise AssertionError(f"{tag}: {extra} ran off its path: {launches}")
    return {"launches": launches, "wall": wall, "seed_s": seed_s,
            "iterations": [int(x) for x in it.group(2).split(",")]}


def phase_46mb() -> dict:
    t0 = time.time()
    d = make_data("4.6mb", 4_600_000)
    say(f"[4.6mb] data generated in {time.time() - t0:.1f} s")
    t0 = time.time()
    run_cli("index", f"{d}/ref.fa", f"{d}/idx")
    say(f"[4.6mb] index build {time.time() - t0:.2f} s")
    # the main path: counts start at 0 just before it runs
    runs = {"4.6mb": align_run(
        "4.6mb", d, f"{d}/idx", EXPECT_46,
        must_launch=("dp_small", "dp_any", "seed_step"),
        must_not_launch=("masked_gather", "resolve_sa"))}
    runs["4.6mb-pallas"] = align_run(
        "4.6mb-pallas", d, f"{d}/idx", EXPECT_46, sa_mode="pallas",
        must_launch=("dp_small", "dp_any", "seed_step", "masked_gather"),
        must_not_launch=("resolve_sa",))
    return runs


def phase_12mb() -> dict:
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    from gsalign_tpu_torch.index.io import save_index
    t0 = time.time()
    d = make_data("12mb", 12_000_000)
    say(f"[12mb] data generated in {time.time() - t0:.1f} s")
    t0 = time.time()
    run_cli("index", f"{d}/ref.fa", f"{d}/idx")
    say(f"[12mb] index build {time.time() - t0:.2f} s")
    t0 = time.time()
    # every-8th SA sampling is what build_fmindex picks above 640 M text
    # rows; here it is asked for at 24 M rows
    fm8 = build_fmindex(pack_genome(read_fasta(f"{d}/ref.fa")), sa_intv=8)
    save_index(fm8, f"{d}/idx8")
    say(f"[12mb] sa_intv=8 index build {time.time() - t0:.2f} s")
    seedy = ("dp_small", "seed_step")
    return {
        "12mb": align_run("12mb", d, f"{d}/idx", EXPECT_12,
                          must_launch=seedy,
                          must_not_launch=("masked_gather", "resolve_sa")),
        "12mb-pallas": align_run(
            "12mb-pallas", d, f"{d}/idx", EXPECT_12, sa_mode="pallas",
            must_launch=seedy + ("masked_gather",),
            must_not_launch=("resolve_sa",)),
        "12mb-sa8": align_run(
            "12mb-sa8", d, f"{d}/idx8", EXPECT_12,
            must_launch=seedy + ("resolve_sa",),
            must_not_launch=("masked_gather",)),
    }


def load_case(tag: str, idx: str):
    """(DeviceFMIndex on the card, query codes) of a generated pair."""
    import torch
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import chars_to_codes
    from gsalign_tpu_torch.index.io import load_index
    from gsalign_tpu_torch.ops.rank import DeviceFMIndex
    t0 = time.time()
    fm = load_index(os.path.join(WORK, tag, idx))
    t1 = time.time()
    dfm = DeviceFMIndex.from_host(fm, torch.device("cuda"))
    torch.cuda.synchronize()
    say(f"[tables] {tag} {idx}: load_index {t1 - t0:.2f} s, "
        f"DeviceFMIndex.from_host (build and upload) {time.time() - t1:.2f} "
        f"s, {torch.cuda.memory_allocated() / 2 ** 20:.0f} MiB on the card")
    queries = [chars_to_codes(q) for _, q in
               read_fasta(os.path.join(WORK, tag, "qry.fa"))]
    return dfm, queries


def timed(fn):
    """(result, milliseconds) of one call, by CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def phase_seed_kernels() -> dict:
    """masked_gather, seed_step and resolve_sa against their plain torch
    versions on the card. Returns per-kernel {ms, plain_ms, max_abs_err}."""
    import torch
    from gsalign_tpu_torch.ops import gather, rank, seed_cuda, seeding
    totals = {}
    dfm12, q12 = load_case("12mb", "idx")

    # masked_gather on the 12 Mb sa_rows, K slots, a third of them empty
    K = seeding._SA_GATHER_K
    rng = np.random.default_rng(12)
    idx = rng.integers(0, dfm12.seq_len + 1, K).astype(np.int32)
    idx[rng.random(K) < 1 / 3] = -1
    idx = torch.from_numpy(idx).cuda()
    plain = gather.masked_gather_plain(dfm12.sa_rows, idx)
    got = gather.masked_gather(dfm12.sa_rows, idx)
    err = int((got.long() - plain.long()).abs().max())
    if err:
        raise AssertionError("masked_gather differs from the plain version")
    ms = cuda_ms(lambda: gather.masked_gather(dfm12.sa_rows, idx), 200)
    plain_ms = cuda_ms(lambda: gather.masked_gather_plain(dfm12.sa_rows, idx),
                       200)
    say(f"[kernel] masked_gather K={K} on sa_rows "
        f"[{dfm12.sa_rows.shape[0]}]  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  equal")
    totals["masked_gather"] = {"ms": ms, "plain_ms": plain_ms,
                               "max_abs_err": err}

    # seed_step: the whole scan, kernel against plain, both SA modes
    cases = [("4.6mb",) + load_case("4.6mb", "idx"), ("12mb", dfm12, q12)]
    for tag, dfm, queries in cases:
        for mode in ("xla", "pallas"):
            runs = {}
            for plain in (True, False):
                stats = {}
                with sa_mode_env(mode):
                    seeds, ms = timed(lambda: seeding.find_seeds_all(
                        dfm, queries, plain=plain, stats=stats))
                runs[plain] = (seeds, stats, ms)
            (ps, pst, pms), (ks, kst, kms) = runs[True], runs[False]
            same = all(np.array_equal(x, y) for a, b in zip(ks, ps)
                       for x, y in zip(a, b))
            if not same or kst != pst:
                raise AssertionError(
                    f"seed_step {tag} {mode}: the kernel scan differs from "
                    f"the plain one ({kst} against {pst})")
            n_seeds = sum(len(c[0]) for c in ks)
            say(f"[kernel] seed_step scan {tag} {mode}: {n_seeds} seeds, "
                f"iterations {kst['scan_iterations']} (plain "
                f"{pst['scan_iterations']}), kernel {kms:.1f} ms  plain "
                f"{pms:.1f} ms  equal")
            if tag == "12mb" and mode == "xla":
                totals["seed_step"] = {"ms": kms, "plain_ms": pms,
                                       "max_abs_err": 0}

    # resolve_sa: every rank the 12 Mb sampled run resolves
    dfm8, q8 = load_case("12mb", "idx8")
    captured = []
    expand = seeding._expand_hits

    def capture(dfm, qs, ls, k0, fr, plain=False):
        captured.append((k0, fr))
        return expand(dfm, qs, ls, k0, fr, plain)
    seeding._expand_hits = capture
    try:
        seeding.find_seeds_all(dfm8, q8)
    finally:
        seeding._expand_hits = expand
    k = torch.from_numpy(seeding.hit_ranks(*captured[0])[1]).cuda()
    got, ms = timed(lambda: seed_cuda.resolve_sa(dfm8, k))
    plain, plain_ms = timed(lambda: rank.resolve_sa(dfm8, k))
    full = dfm12.host_sa[k.cpu().numpy()]
    err = int((got - plain).abs().max()) if k.numel() else 0
    if err or not np.array_equal(got.cpu().numpy(), full):
        raise AssertionError("resolve_sa differs from the plain version or "
                             "from the full suffix array")
    say(f"[kernel] resolve_sa on {k.numel()} ranks of the 12 Mb hits "
        f"(sa_intv 8)  kernel {ms:.3f} ms  plain {plain_ms:.1f} ms  equal "
        f"to the plain version and to the full SA")
    totals["resolve_sa"] = {"ms": ms, "plain_ms": plain_ms,
                            "max_abs_err": err}
    return totals


def phase_profile():
    """Device operations per scan iteration (kernels, copies and sets),
    under torch.profiler, at 4.6 Mb in both SA modes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gsalign_tpu_torch.ops import seeding
    dfm, queries = load_case("4.6mb", "idx")
    for mode in ("xla", "pallas"):
        stats = {}
        with sa_mode_env(mode):
            seeding.find_seeds_all(dfm, queries)                  # warm
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                seeding.find_seeds_all(dfm, queries, stats=stats)
                torch.cuda.synchronize()
                wall = time.time() - t0
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        n_iter = sum(stats["scan_iterations"])
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
        names = {}
        for e in dev:
            n, us = names.get(e.name, (0, 0.0))
            names[e.name] = (n + 1, us + e.time_range.elapsed_us())
        say(f"[profile] seed scan 4.6mb {mode}: {len(dev)} device "
            f"operations over {n_iter} iterations "
            f"({len(dev) / max(1, n_iter):.2f} per iteration); device busy "
            f"{busy:.4f} s of {wall:.3f} s traced wall")
        for name, (n, us) in sorted(names.items(), key=lambda kv: -kv[1][0]
                                    )[:8]:
            say(f"[profile]   {n:6d} x {us / n:8.2f} us  {name[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "gsalign_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    # tests/ by its own path: an installed package named `tests` would
    # shadow the repository's (it has no __init__.py)
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    os.environ["GSALIGN_PLATFORM"] = "cuda"
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        phase_card()
        totals = phase_kernels()
        phase_oracle()
        phase_100kb()
        runs = phase_46mb()
        runs.update(phase_12mb())
        totals.update(phase_seed_kernels())
        phase_profile()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    main_path = runs["4.6mb"]["launches"]
    say("[summary] " + "; ".join(
        f"{tag}: wall {r['wall']:.2f} s, seed {r['seed_s']:.2f} s, "
        f"iterations {r['iterations']}" for tag, r in runs.items()))

    def entry(name, source, replaces, launches):
        return {"name": name, "route": "cuda",
                "source": f"gsalign_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, **totals[name]}
    kernels = [
        entry("dp_small", "dp.cu", "gsalign_tpu/ops/dp_pallas.py:80",
              main_path["dp_small"]),
        entry("dp_any", "dp.cu", "gsalign_tpu/ops/dp_pallas.py:457",
              main_path["dp_any"]),
        entry("masked_gather", "gather.cu",
              "gsalign_tpu/ops/gather_pallas.py:34",
              runs["4.6mb-pallas"]["launches"]["masked_gather"]),
        entry("seed_step", "seed.cu", "gsalign_tpu/ops/seeding.py:221",
              main_path["seed_step"]),
        entry("resolve_sa", "seed.cu", "gsalign_tpu/ops/rank.py:625",
              runs["12mb-sa8"]["launches"]["resolve_sa"]),
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
