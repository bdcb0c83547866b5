#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gsalign_tpu_torch) once on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py dp         # phases 1 and 2 only (the DP kernels)
    python3 chip_smoke.py dp-sweep   # those, and the DP launch plans timed
    python3 chip_smoke.py seed       # phases 1 and 6 (the seed kernels)
    python3 chip_smoke.py segments   # phase 1 and 6b (speculative segments)
    python3 chip_smoke.py wide-big   # phase 1, then a 1.08 Gb wide index
                                     # (2N > 2^31): minutes, tens of GB
    python3 chip_smoke.py tools      # phase 1, the 4.6 Mb pair, phase 9
    python3 chip_smoke.py probes     # phase 1, then phase 10 at 100 Mb
                                     # and at 250 Mb (about 10 min)
    python3 chip_smoke.py shard-times  # phase 1, the row-sharded seed
                                     # kernels timed at 4, 8 and 16 blocks
    python3 chip_smoke.py seedcost [OLD_TREE]  # phase 1, then phase 11 in
                                     # full: exp_seedcost at 4.6, 12
                                     # (wide), 100 and 250 Mb, exp_sweep's
                                     # grid; with OLD_TREE (an unpacked
                                     # older tree's gsalign_tpu_torch/csrc)
                                     # seed_scan in both in turns
    python3 chip_smoke.py layout     # phases 1 and 12 (the INIT-10 rows
                                     # built on the card)
    python3 chip_smoke.py 3gb [LEN]  # phase 1, then config 5 (3.1 Gb, or
                                     # LEN bases) through tools/run_3gb,
                                     # whole and over 8 row blocks, and its
                                     # --index restore over 8 row blocks:
                                     # 20-25 min, ~13.3 B a text row

Phases (each raises on failure; nothing is caught):
  1. the card (nvidia-smi name and power limit), the torch and CUDA
     versions, and the build of every kernel source in
     gsalign_tpu_torch/csrc/ (one nvcc each, in parallel);
  2. each DP kernel (dp_small, dp_any) against its plain torch version on
     the card at every bucket width the aligner uses (L 256 through both),
     and on the ksw2 oracle cases of tests/golden: op codes must be equal;
     entry()'s fn (gsalign_tpu_torch/entry.py) launched once on the card,
     its ops equal to the plain DP's;
  3. 100 kb: the port's CLI on the card, byte-identical to the C reference
     outputs in tests/golden (default, -sen, -fmt 2);
  4. 4.6 Mb (E. coli scale, make_pair(4_600_000)): index build and align
     through the CLI on the card (the main path), with the JAX package's
     output counts and sha256 values, and the DP kernels and seed_scan
     launched (and no seed_step), one [dp] line for each DP launch of that
     run and both DP kernels held against the plain version on each launch's
     own inputs (ops equal) and timed there; then the same align with
     GSALIGN_SA_MODE=pallas, which launches seed_lockstep once a scan round
     (the lock-step scan with the slot compaction and the masked gather
     inside it) and no other seed kernel, and must gather SA words;
     then the same pair through parallel/distributed and an imported
     index, each with the JAX package's sha256 values: a -resume run
     killed (kill -9) once its first shard is committed, then resumed
     (only the uncommitted chromosomes recomputed); -t 2 (a thread a
     chromosome, the device tables laid out once); two CLI processes on
     the one card in a gloo group (WORLD_SIZE, RANK, MASTER_ADDR,
     MASTER_PORT), each launching the seed and DP kernels; the reference
     written as BWA files, imported and aligned;
  5. 12 Mb (yeast scale, make_pair(12_000_000)): align through the CLI in
     the xla and pallas SA modes, on an sa_intv=8 index and on a
     forced-wide index (the layout of seq_len >= 2^31; sa_intv 8), both
     built through the API (seed_scan and resolve_sa launched), each with
     the JAX package's counts and sha256 values; build_suffix_array_torch
     on the card against the native SA-IS on its 24 M-row text, both timed;
  6. the seed-stage kernels against their plain torch versions on the
     card: the stand-alone masked_gather on the 12 Mb sa_rows at K = 512;
     seed_scan at 4.6 Mb and 12 Mb (xla) and on the sa_intv=8 index (equal
     records, lane state and iteration counts); seed_lockstep against the
     host loop scan_lockstep(plain=True) on the first round's lanes, in xla
     mode at 4.6 Mb and in pallas mode at 4.6 Mb and 12 Mb (equal lane
     state, records, iterations, words gathered and stalls; lanes must
     stall at 12 Mb), there also with the grid capped so that a warp owns
     several lanes, and without slots on the wide index; seed_step
     (seed_lockstep for one iteration) against seed_step_plain iteration
     by iteration; seed_scan on the wide index; resolve_sa (16 threads a
     rank narrow, 32 wide) on every rank the 12 Mb sampled and wide runs
     resolve, against the full suffix array too;
  6b. speculative seed segments (segment_runs): find_seeds_all at
     n_segments 1, 4, 8 and 16, slack 600, on phase 6's indexes and queries
     (4.6 Mb full-SA in xla mode and, through seed_lockstep, pallas mode;
     12 Mb sa_intv=8, forced-wide, and sa_intv=8 in 4 row blocks), each
     run's seeds equal to n_segments 1, and 4.6 Mb at slack 20, which must
     poison lanes at their bounds; at 8 segments the first round's lanes
     and a fixup round's through the kernel against the plain scan (lane
     state, records, F_STEPS) and the first round's bound; one [segments]
     line a run;
  7. the mesh (parallel/mesh.py) on the one card, four entries of it, a CUDA
     stream each: 4.6 Mb through compare_genomes with the seed lanes and the
     DP problems in four stripes, in xla mode and, in a process of its own
     under a time limit, in pallas mode (the lock-step stripes in turn on
     one stream) and with the index's rows cut in four; 12 Mb sa_intv=8 and
     forced-wide with t3 and sa_samples in four row blocks; each with the
     unsharded runs' output, one scan launch a stripe and four DP launches
     for each of the unsharded run's; the row-sharded instances of
     seed_scan, seed_lockstep and resolve_sa against their plain versions
     on the cut tables and timed beside the whole-table instances, and
     seed_scan and resolve_sa again over 16 row blocks;
     dryrun_multichip(4);
  8. the seed stage's device operations per scan in both SA modes, under
     torch.profiler;
  9. the port's tools (gsalign_tpu_torch/tools/): run_3gb at 2 Mb with
     whole tables and, from the index it saved, with the rows cut over 4
     entries of the card, each with the JAX tool's counts and equal MAF
     and VCF bytes; profile_pipeline on the 4.6 Mb pair, one timed run;
 10. the port's stage probes (gsalign_tpu_torch/tools/exp_seedprof,
     seed_stats, exp_seedab, exp_dphist, exp_align) once each on the
     bench's 100 Mb pair (celegans_100mb; its pair and index made by a
     process started after phase 1, beside the other phases): the JAX
     record's counts, the bench's seed lanes, the same seeds with INIT-12
     off, seed_scan and the DP kernels launched inside the tools, n_dp
     equal to its buckets and to its launches' problems, the seed stage's
     device busy share under torch.profiler, and every DP launch of
     exp_align held against the plain version (ops equal) and timed
     against its bound, one [dp] line each; seed_scan on the first round's
     lanes against the plain scan and its bound. The probes mode runs it
     at 100 and 250 Mb (human_250mb);
 11. the cost probes (gsalign_tpu_torch/tools/exp_seedcost, exp_sweep;
     kernels seedcost and gather_sweep, csrc/probe.cu) through the tools'
     functions, the counts set to 0 just before and read just after:
     exp_seedcost on phase 4's 4.6 Mb index at B 512, K 50, exp_sweep over
     8 and 64 MB; then every seedcost instance (pieces 0-5 narrow; 0-3 on
     phase 5's forced-wide index) and both gather_sweep forms held against
     their plain versions on the same inputs (acc, checksum, planes; the
     sums and last indices), each with its bound;
 12. the INIT-10 rows of comb_pairs (init10_rows, csrc/layout.cu) at the
     synth_ecoli benchmark configuration's shape (a random genome of
     NC_000913.3's 4,641,652 bp, 9,283,304 text bases, its full-SA index):
     the card's layout against the CPU layout (comb_pairs and init_corr
     equal), the host's layout with and without the histogram, the spans
     and bytes of from_host on the card; the kernels on the index's text
     rows against the plain numpy pass (rows equal), timed against their
     bound, and their device operations under torch.profiler.
wide-big: a 1,080,000,000-base random genome (2N = 2.16e9 > 2^31; the
JAX package's tests/test_wide_e2e.py), its index built once; a 200 kb
query seeded (coordinates past 2^31, seeds equal to the text), seed_scan
and resolve_sa held against their plain versions on that run's lanes and
ranks, and a mutated 2 Mb slice aligned through compare_genomes.
3gb: BASELINE.json config 5 (two chromosomes, 3.1 Gb: a 6.2 G-row wide
index, sa_intv 8) built, saved, laid out on the card and aligned by
gsalign_tpu_torch/tools/run_3gb.py (three 8 Mb slices) in a process of
its own, the host memory of every phase printed in bytes a text row, its
counts held against the JAX tool's record; a 200 kb query whose seeds lie
past 2^32, seed_scan and resolve_sa held against their plain versions on
it; occ_rows against the plain occ_t3 on ranks in t3 rows past word 2^32
(of the real t3 where it holds more than 2^32 words, else of a synthetic
one). Then, as the JAX tool's record did, over a mesh of 8 entries of the
card with t3 and sa_samples cut into 8 row blocks (views of the tables the
align used): seed_scan's and resolve_sa's row-sharded instances against
their plain versions on that query's lanes and ranks and on every block's
edge ranks (past 2^32 in the upper blocks), timed beside the whole-table
instances, and the three-slice align through the mesh: the same counts
and out.maf and out.vcf bytes, the sharded instances alone launched. Once
that process has exited, a second one restores the saved index (run_3gb
--index --entries 8), lays it out and aligns over the 8 row blocks: the
same counts and the same out.maf and out.vcf bytes.
seedcost: exp_seedcost at B 512 and at the main path's lanes (460, 1,200,
10,001, 25,000), K 500, on the bench's 4.6, 100 and 250 Mb pairs (made by
processes started at once) and the 12 Mb forced-wide index, every
instance against its plain version on the same inputs with its bound, the
instances' registers and resident warps an SM beside seed_scan's; then
exp_sweep's whole grid, each point against plain at K 20. Given an older
tree, its csrc/seed.cu is built with this tree's flags, its machine code
compared with this tree's kernel by kernel, and seed_scan run through
both libraries in turns (P, C, C, P, twice) on the first round's lanes at
12 Mb sa_intv=8 and 100 Mb, each result equal to the plain scan's.
shard-times: seed_scan and resolve_sa over 4, 8 and 16 row blocks of the
card on the 12 Mb sampled and forced-wide indexes, each beside the
whole-table instance in turns; a cut that the kernels refuse is printed
as refused (copied into an older checkout, it times that tree's kernels).
Every align run sets the kernels' launch counts to 0 just before it and
reads them just after. Each kernel's bound is the larger of its bytes over
the card's memory rate and its operations over the card's integer rate,
counted from this run's data: of a table only the distinct rows that the
run reads, each once (scan_work). The last two lines are the kernels JSON and
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

# Published peaks of one H100 SXM at its full 700 W: 3.35 TB/s of device
# memory; 67 TFLOP/s of float32 outside the tensor cores is 33.5 T lane
# instructions a second (a fused multiply-add counts two), and an SM has
# half as many int32 lanes as float32 lanes: 16.75 T int32 operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 16.75e12
# integer operations of one DP cell (csrc/dp.cu's inner loop: 6 for the
# score, 10 for z and its direction, 7 for u, v, x, y, 7 for the
# continuation bits and the nibble store)
DP_OPS_PER_CELL = 30
# integer operations of one single-class rank over a 32-word symbol row
# (8 a word: xor, byte compare, mask, popcount, add) with up to 16
# checkpoint adds for each half of the packed minors. A scan step in
# interval extension does two ranks; every step does about 100 more for
# the lane's state machine (a direct-compare step spends them on its 16
# words). An LF-walk step is one rank.
RANK_OPS = 32 * 8 + 2 * 16
STEP_OPS = 100
MAJOR_ROW_BYTES = 256    # a row of a narrow index's major checkpoints
TEXT_SEG_BYTES = 64      # 256 bases of packed text
WIDE_BIG_LEN = 1_080_000_000   # genome bases of wide-big: 2N > 2^31

def bound(n_bytes: float, n_ops: float) -> dict:
    """{bound_ms, bound_by} of work that must move n_bytes and do n_ops
    integer operations."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_INT_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}

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
    """Mean device milliseconds of fn() over reps runs, by CUDA events.
    The launches queue up behind a spin kernel (about 0.2 ms a run), so
    where a kernel is shorter than the host's call that launches it the
    events read the card, not the host."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 3.5e5))
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
            if "registers" in ln or "Compiling entry" in ln \
                    or "spill" in ln:
                say(f"[ptxas] {ln.strip()}")
    dp_cuda.build()
    gather.build()
    seed_cuda.build()
    return card


def phase_kernels(seed: int = 0) -> dict:
    """Each kernel against its plain version at full aligner batches, at
    every bucket width it can take; L 256 through both. Returns per-kernel
    totals {name: {ms, plain_ms, max_abs_err, bound_ms, bound_by}}, summed
    over the widths at which dp_align takes that kernel (dp_small's L 256
    is checked and printed, and left out of the sums)."""
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
    for L in SMALL_LS + ANY_LS:
        B = min(1024, max(1, BATCH_CELLS // (L * L)))
        host = make_batch(rng, L, B)
        args = [torch.from_numpy(a).cuda() for a in host]
        # codes and lengths in, 2L ops a problem out; the cells of this
        # batch's problems
        cells = int((host[2].astype(np.int64) * host[3]).sum())
        bnd = bound(2 * B * L + 8 * B + 2 * B * L, cells * DP_OPS_PER_CELL)
        t0 = time.time()
        plain = dp_ops.dp_align_batch(*args, L)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        plain = plain.cpu().numpy()
        # dp_any as its plan has it; at L 256 also as a chain of two warps
        # of 4 rows a lane, beside its one warp of 8
        runs = [(dp_cuda.dp_small, None)] if L <= dp_cuda.SMALL_MAX_L else []
        if L > dp_cuda.SMALL_BEST_L:
            runs.append((dp_cuda.dp_any, None))
        if L == dp_cuda.SMALL_MAX_L:
            runs.append((dp_cuda.dp_any, (4, 2, 1)))
        for fn, forced in runs:
            with forced_plan(forced):
                err = max_abs_err(fn(*args, L).cpu().numpy(), plain)
                if err:
                    raise AssertionError(
                        f"{fn.__name__} L={L} {forced or ''}: ops differ "
                        f"from the plain version (max |diff| {err})")
                ms = cuda_ms(lambda: fn(*args, L), reps=5)
            taken = forced is None and \
                (fn is dp_cuda.dp_small) == (L <= dp_cuda.SMALL_BEST_L)
            say(f"[kernel] {fn.__name__:8s} L={L:5d} B={B:5d}  kernel "
                f"{ms:10.3f} ms  plain {plain_ms:10.1f} ms  bound "
                f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, {cells} cells)  "
                f"ops equal" + ("" if taken else
                                f"  (not what dp_align takes at this width"
                                f"{f', plan {forced}' if forced else ''}: "
                                f"not in the sums)"))
            if not taken:
                continue
            tot = totals.setdefault(fn.__name__, {
                "ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0, "bound_ms": 0.0,
                "bound_by": bnd["bound_by"]})
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bnd["bound_ms"]
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
    return totals


@contextlib.contextmanager
def forced_plan(plan):
    """dp_any launched with `plan` (K, warps a block, blocks a cluster)
    inside the block; its own plan for None."""
    from gsalign_tpu_torch.ops import dp_cuda
    own = dp_cuda.any_plan
    if plan is not None:
        dp_cuda.any_plan = lambda B, L, n_sm: plan
    try:
        yield
    finally:
        dp_cuda.any_plan = own


def phase_main_shapes(shapes) -> dict:
    """The DP launches of the main path, with the inputs FragmentAligner
    gave them: one [dp] line a launch, and each kernel that takes the width
    held against the plain version on those inputs (ops must be equal) and
    timed there against the bound of phase_kernels. Returns {kernel: max
    |diff|} (all 0, or it raises)."""
    import torch
    from gsalign_tpu_torch.ops import dp as dp_ops
    from gsalign_tpu_torch.ops import dp_cuda
    from dp_cases import max_abs_err
    errs = {}
    for name, (L, q, t, ql_d, tl_d) in shapes:
        B = q.shape[0]
        ql_d, tl_d = ql_d.clamp(0, L), tl_d.clamp(0, L)
        ql, tl = ql_d.cpu().numpy(), tl_d.cpu().numpy()
        cells = int((ql.astype(np.int64) * tl).sum())
        plan = dp_cuda.any_plan(B, L, dp_cuda.sm_count(q.device)) \
            if name == "dp_any" else dp_cuda.small_plan(L)
        say(f"[dp] {name} L={L} B={B} cells={cells} (longest query {ql.max()}"
            f", longest target {tl.max()}; plan {plan})")
        args = (q, t, ql_d, tl_d)
        bnd = bound(2 * B * L + 8 * B + 2 * B * L, cells * DP_OPS_PER_CELL)
        t0 = time.time()
        plain = dp_ops.dp_align_batch(*args, L).cpu().numpy()
        plain_ms = (time.time() - t0) * 1e3
        for fn in (dp_cuda.dp_small, dp_cuda.dp_any):
            if fn is dp_cuda.dp_small and L > dp_cuda.SMALL_MAX_L:
                continue
            err = max_abs_err(fn(*args, L).cpu().numpy(), plain)
            if err:
                raise AssertionError(
                    f"{fn.__name__} at the main path's L={L} B={B}: ops "
                    f"differ from the plain version (max |diff| {err})")
            errs[fn.__name__] = max(errs.get(fn.__name__, 0), err)
            ms = cuda_ms(lambda: fn(*args, L), reps=20)
            say(f"[kernel] {fn.__name__:8s} L={L:5d} B={B:5d}  kernel "
                f"{ms:10.3f} ms  plain {plain_ms:10.1f} ms  bound "
                f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}, {cells} "
                f"cells)  ops equal  the inputs of a main-path launch of "
                f"{name}")
    return errs


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
    from gsalign_tpu_torch.ops import (dp_cuda, gather, layout_cuda, probe,
                                       seed_cuda)
    return {"dp_small": dp_cuda.dp_small, "dp_any": dp_cuda.dp_any,
            "init10_rows": layout_cuda.init10_rows,
            "masked_gather": gather.masked_gather,
            "seed_scan": seed_cuda.seed_scan,
            "seed_lockstep": seed_cuda.seed_lockstep,
            "seed_step": seed_cuda.seed_step,
            "resolve_sa": seed_cuda.resolve_sa,
            "seedcost": probe.seedcost,
            "gather_sweep": probe.gather_sweep}


# the kernels with a row-sharded instance (csrc/seed.cu ShardedTable),
# counted by their wrapper's .sharded_launches
SHARDED = ("seed_scan", "seed_lockstep", "resolve_sa")


def zero_counts():
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    for name in SHARDED:
        fns[name].sharded_launches = 0


def launch_counts() -> dict:
    """{kernel: launches} of every wrapper, and {kernel_sharded: launches}
    of each row-sharded instance."""
    fns = counters()
    out = {name: fn.launches for name, fn in fns.items()}
    out.update({f"{name}_sharded": fns[name].sharded_launches
                for name in SHARDED})
    return out


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
    are read just after, and with them seed_lockstep's counts of the SA
    words it gathered and the lane-iterations it stalled. Checks the
    outputs against `expect`; a pallas run must have gathered words."""
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    lock = fns["seed_lockstep"]
    lock.gathered = lock.stalled = 0
    for name in ("dp_small", "dp_any"):
        fns[name].shapes.clear()
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
    say(f"[{tag}] kernel launches in the run: {launches}; SA words "
        f"gathered inside seed_lockstep {lock.gathered}, lane-iterations "
        f"stalled {lock.stalled}")
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
    rounds = len(it.group(2).split(","))
    if sa_mode == "pallas" and (launches["seed_lockstep"] != rounds
                                or lock.gathered <= 0):
        raise AssertionError(
            f"{tag}: {launches['seed_lockstep']} seed_lockstep launches in "
            f"{rounds} scan round(s), {lock.gathered} words gathered")
    return {"launches": launches, "wall": wall, "seed_s": seed_s,
            "gathered": lock.gathered, "stalled": lock.stalled,
            "iterations": [int(x) for x in it.group(2).split(",")],
            "dp_shapes": [(name, shape) for name in ("dp_small", "dp_any")
                          for shape in fns[name].shapes]}


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
        must_launch=("dp_small", "dp_any", "seed_scan"),
        must_not_launch=("seed_lockstep", "seed_step", "masked_gather",
                         "resolve_sa"))}
    main = runs["4.6mb"]
    if len(main["dp_shapes"]) != main["launches"]["dp_small"] \
            + main["launches"]["dp_any"]:
        raise AssertionError("4.6mb: the wrappers kept fewer launches' "
                             "inputs than the main path made")
    main["dp_errs"] = phase_main_shapes(main.pop("dp_shapes"))
    runs["4.6mb-pallas"] = align_run(
        "4.6mb-pallas", d, f"{d}/idx", EXPECT_46, sa_mode="pallas",
        must_launch=("dp_small", "dp_any", "seed_lockstep"),
        must_not_launch=("seed_scan", "seed_step", "masked_gather",
                         "resolve_sa"))
    return runs


def shard_outputs(tag: str, prefix: str, log, expect: dict) -> dict:
    """A run through parallel/distributed: the merged files' sha256
    values, and where `log` holds every chromosome's shard (a resumed run
    logs only those it recomputed; None) the alignments and lengths summed
    over its Alignment# lines, checked against `expect`. The run logs no
    variant line; the sha256 values carry the other counts."""
    got = {
        "maf_sha256": hashlib.sha256(read(f"{prefix}.maf")).hexdigest(),
        "vcf_sha256_no_reference_line": hashlib.sha256(
            strip_reference_line(read(f"{prefix}.vcf"))).hexdigest(),
    }
    if log is not None:
        m = re.findall(r"Alignment#=(\d+) \(total alignment length="
                       r"(\d+)\)", log)
        got["alignments"] = sum(int(n) for n, _ in m)
        got["aln_len"] = sum(int(ln) for _, ln in m)
    want = {k: expect[k] for k in got}
    say(f"[{tag}] outputs {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"{tag}: outputs differ from the JAX run: "
                             f"expected {want}")
    left = [f for f in os.listdir(os.path.dirname(prefix))
            if f.startswith(os.path.basename(prefix) + ".part")]
    if left:
        raise AssertionError(f"{tag}: shards left after the merge: {left}")
    return got


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


# a CLI run in a process of its own that prints, as its last stdout line,
# the launches it made of every kernel
WORKER = """
import json, sys
sys.path[:0] = [{repo!r}, {tests!r}]
from gsalign_tpu_torch import cli
from chip_smoke import counters
rc = cli.main(["gsalign-tpu-torch"] + sys.argv[1:])
print(json.dumps({{"rc": rc, "launches": {{k: f.launches for k, f in
                                        counters().items()}}}}))
"""


def cli_process(*argv, env=None) -> subprocess.Popen:
    code = WORKER.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    return subprocess.Popen([sys.executable, "-c", code, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def finish(procs, timeout: float = 600):
    """Wait for every process; stop any left. Returns [(rc, launches,
    stderr)]."""
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            res = json.loads(so.strip().splitlines()[-1]) \
                if p.returncode == 0 else {}
            if p.returncode != 0 or res.get("rc") != 0:
                raise RuntimeError(f"CLI process exited {p.returncode}:\n"
                                   f"{se[-4000:]}")
            out.append((res["rc"], res["launches"], se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def phase_restartable() -> dict:
    """4.6 Mb through the paths of parallel/distributed and an imported
    index, each on the card with the JAX package's output: a -resume run
    killed once its first shard committed, then resumed; -t 2 (the two
    chromosomes on two threads, the device tables laid out once); two
    processes on the one card (gloo, joined by the CLI from WORLD_SIZE,
    RANK, MASTER_ADDR, MASTER_PORT); the BWA files of the reference
    imported with the import subcommand and aligned. Returns {tag: wall}."""
    import signal
    from gsalign_tpu_torch.index.io import load_index
    from gsalign_tpu_torch.ops.rank import DeviceFMIndex
    from bwa_files import write_bwa_files
    d = os.path.join(WORK, "4.6mb")
    idx, qry = f"{d}/idx", f"{d}/qry.fa"
    walls = {}

    # -resume: kill -9 once the first chromosome's marker is committed
    t0 = time.time()
    p = cli_process("-i", idx, "-q", qry, "-o", f"{d}/res", "-resume",
                    "-t", "1")
    marker = f"{d}/res.part0.pkl"
    try:
        while p.poll() is None and not os.path.exists(marker) \
                and time.time() - t0 < 600:
            time.sleep(0.01)
    finally:
        if p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
        p.communicate()
    committed = sorted(f for f in os.listdir(d)
                       if f.startswith("res.part") and f.endswith(".pkl"))
    merged = os.path.exists(f"{d}/res.vcf")
    say(f"[resume] first run killed after {time.time() - t0:.2f} s with "
        f"markers {committed} committed, merge "
        f"{'done' if merged else 'not reached'}")
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.time()
    log = run_cli("-i", idx, "-q", qry, "-o", f"{d}/res", "-resume")
    walls["resume"] = time.time() - t0
    launches = {k: f.launches for k, f in fns.items()}
    shard_outputs("resume", f"{d}/res", None, EXPECT_46)
    # the restart recomputes only the chromosomes without a marker (all of
    # them where the merge had consumed the markers)
    n_chr = sum(1 for ln in read(qry).split(b"\n") if ln.startswith(b">"))
    redone = log.count("Process query chromosome:")
    if redone != (n_chr if merged else n_chr - len(committed)) or \
            (redone and launches["seed_scan"] <= 0):
        raise AssertionError(f"resume: {redone} chromosomes recomputed with "
                             f"{committed} committed of {n_chr}")
    say(f"[resume] resumed run {walls['resume']:.2f} s, {redone} "
        f"chromosome(s) recomputed, kernel launches {launches}")

    # -t 2: two threads, one chromosome each, launching on one card
    laid_out = []
    real = DeviceFMIndex.host_tables

    def counting(fm, **kw):
        laid_out.append(fm)
        return real(fm, **kw)
    DeviceFMIndex.host_tables = staticmethod(counting)
    for fn in fns.values():
        fn.launches = 0
    try:
        t0 = time.time()
        log = run_cli("-i", idx, "-q", qry, "-o", f"{d}/thr", "-t", "2")
        walls["t2"] = time.time() - t0
    finally:
        DeviceFMIndex.host_tables = staticmethod(real)
    launches = {k: f.launches for k, f in fns.items()}
    shard_outputs("t2", f"{d}/thr", log, EXPECT_46)
    say(f"[t2] wall {walls['t2']:.2f} s, device tables laid out "
        f"{len(laid_out)} time(s), kernel launches {launches}")
    if len(laid_out) != 1:
        raise AssertionError(f"-t 2 laid the tables out {len(laid_out)} "
                             f"times")
    missing = [k for k in ("dp_small", "dp_any", "seed_scan")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"-t 2: {missing} never ran: {launches}")

    # two processes on the one card
    port = free_port()
    t0 = time.time()
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs.append(cli_process("-i", idx, "-q", qry, "-o", f"{d}/mp",
                                 "-t", "1", env=env))
    res = finish(procs)
    walls["2proc"] = time.time() - t0
    log = "".join(se for _, _, se in res)
    shard_outputs("2proc", f"{d}/mp", log, EXPECT_46)
    for rank, (_, launches, _) in enumerate(res):
        say(f"[2proc] rank {rank} kernel launches {launches}")
        if launches["seed_scan"] <= 0 or launches["dp_small"] <= 0:
            raise AssertionError(f"2proc rank {rank} launched no seed or "
                                 f"DP kernel: {launches}")
    say(f"[2proc] wall {walls['2proc']:.2f} s (two processes started, "
        f"index loaded and tables laid out in each)")

    # a BWA five-file index of the reference: import, then align
    fm = load_index(idx)
    write_bwa_files(f"{d}/bwa", fm.genome, fm.primary, fm.l2)
    t0 = time.time()
    run_cli("import", f"{d}/bwa", f"{d}/imp")
    say(f"[import] BWA files -> {d}/imp in {time.time() - t0:.2f} s")
    walls["import"] = align_run(
        "import", d, f"{d}/imp", EXPECT_46,
        must_launch=("dp_small", "dp_any", "seed_scan"),
        must_not_launch=("seed_lockstep", "seed_step", "masked_gather",
                         "resolve_sa"))["wall"]
    return walls


def phase_suffix_array() -> dict:
    """build_suffix_array_torch on the card against the native SA-IS on
    the 12 Mb reference's text (24 M rows), each timed."""
    import torch
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index import suffix_array as tsa
    codes = pack_genome(read_fasta(f"{WORK}/12mb/ref.fa")).codes_fwd_rc()
    t0 = time.time()
    native = tsa.build_suffix_array_native(codes)
    native_s = time.time() - t0
    tsa.build_suffix_array_torch(codes[:1 << 16])       # CUDA set-up
    torch.cuda.synchronize()
    t0 = time.time()
    got = tsa.build_suffix_array_torch(codes)
    torch_s = time.time() - t0
    if not np.array_equal(got, native):
        raise AssertionError("build_suffix_array_torch differs from the "
                             "native SA-IS at 12 Mb")
    say(f"[sa] {codes.shape[0] + 1} rows: build_suffix_array_torch on the "
        f"card {torch_s:.3f} s (read-back included), native SA-IS "
        f"{native_s:.3f} s; equal")
    return {"torch_s": torch_s, "native_s": native_s}


def phase_entry():
    """entry()'s fn launched once on the card; ops equal to the plain
    DP's on the same inputs."""
    from gsalign_tpu_torch import entry
    from gsalign_tpu_torch.ops import dp as dp_ops
    from gsalign_tpu_torch.ops import dp_cuda
    from dp_cases import max_abs_err
    fn, args = entry.entry()
    n0 = dp_cuda.dp_small.launches + dp_cuda.dp_any.launches
    ops = fn(*args).cpu().numpy()
    n = dp_cuda.dp_small.launches + dp_cuda.dp_any.launches - n0
    err = max_abs_err(ops, dp_ops.dp_align_batch(*args, entry.L).cpu()
                      .numpy())
    if n != 1 or err:
        raise AssertionError(f"entry(): {n} kernel launches, max |diff| "
                             f"{err} against the plain DP")
    say(f"[entry] fn(*example_args) on the card: one launch, "
        f"{tuple(ops.shape)} ops equal to the plain DP's")


def sampled_indexes(d: str):
    """Two indexes of d/ref.fa built through the API: an sa_intv=8 one at
    d/idx8 (every-8th SA sampling is what build_fmindex picks above 640 M
    text rows; here it is asked for at 24 M rows) and a forced-wide one at
    d/idxw (the layout of seq_len >= 2^31, which is always sampled every
    8th row)."""
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    from gsalign_tpu_torch.index.io import save_index
    g = pack_genome(read_fasta(f"{d}/ref.fa"))
    for idx, kw in (("idx8", dict(sa_intv=8)),
                    ("idxw", dict(force_wide=True))):
        t0 = time.time()
        fm = build_fmindex(g, **kw)
        save_index(fm, f"{d}/{idx}")
        layout = "wide" if fm.rank_dtype == np.int64 else "narrow"
        say(f"[12mb] {idx} ({layout}, sa_intv={fm.sa_intv}) index build "
            f"{time.time() - t0:.2f} s")


def phase_12mb() -> dict:
    t0 = time.time()
    d = make_data("12mb", 12_000_000)
    say(f"[12mb] data generated in {time.time() - t0:.1f} s")
    t0 = time.time()
    run_cli("index", f"{d}/ref.fa", f"{d}/idx")
    say(f"[12mb] index build {time.time() - t0:.2f} s")
    sampled_indexes(d)
    return {
        "12mb": align_run(
            "12mb", d, f"{d}/idx", EXPECT_12,
            must_launch=("dp_small", "seed_scan"),
            must_not_launch=("seed_lockstep", "seed_step", "masked_gather",
                             "resolve_sa")),
        "12mb-pallas": align_run(
            "12mb-pallas", d, f"{d}/idx", EXPECT_12, sa_mode="pallas",
            must_launch=("dp_small", "seed_lockstep"),
            must_not_launch=("seed_scan", "seed_step", "masked_gather",
                             "resolve_sa")),
        "12mb-sa8": align_run(
            "12mb-sa8", d, f"{d}/idx8", EXPECT_12,
            must_launch=("dp_small", "seed_scan", "resolve_sa"),
            must_not_launch=("seed_lockstep", "seed_step",
                             "masked_gather")),
        "12mb-wide": align_run(
            "12mb-wide", d, f"{d}/idxw", EXPECT_12,
            must_launch=("dp_small", "seed_scan", "resolve_sa"),
            must_not_launch=("seed_lockstep", "seed_step",
                             "masked_gather")),
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
    # DeviceFMIndex.from_host, in its two halves
    tabs = DeviceFMIndex.host_tables(fm)
    t2 = time.time()
    dfm = DeviceFMIndex.from_tables(
        tabs, host_sa=np.asarray(fm.sa_samples) if tabs["direct_ok"]
        else None, seq_len=fm.seq_len, primary=fm.primary,
        device=torch.device("cuda"))
    torch.cuda.synchronize()
    t3 = time.time()
    n_bytes = sum(v.numel() * v.element_size() for v in vars(dfm).values()
                  if isinstance(v, torch.Tensor))
    say(f"[tables] {tag} {idx}: load_index {t1 - t0:.2f} s, "
        f"DeviceFMIndex.from_host {t3 - t1:.2f} s = host layout "
        f"(host_tables) {t2 - t1:.2f} s + upload (from_tables) "
        f"{t3 - t2:.2f} s; device tables {n_bytes} bytes "
        f"({n_bytes / 2 ** 20:.1f} MiB)")
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


class Touched:
    """Marks which rows of a table have been read; no host sync."""

    def __init__(self, n_rows: int, row_bytes: int, device):
        import torch
        # the last slot takes the lanes that read nothing
        self.seen = torch.zeros(n_rows + 1, dtype=torch.bool, device=device)
        self.row_bytes = row_bytes

    def mark(self, rows, where=None):
        import torch
        spare = self.seen.shape[0] - 1
        rows = rows.clamp(0, spare - 1)
        self.seen[rows if where is None
                  else torch.where(where, rows, spare)] = True

    def bytes(self) -> int:
        return int(self.seen[:-1].sum()) * self.row_bytes


def rank_rows(dfm, device):
    """Touched markers of the t3 rows and of the major-checkpoint rows (a
    wide index has none: nothing is counted for them)."""
    t3 = Touched(dfm.t3.shape[0], 4 * dfm.t3.shape[1], device)
    major = Touched(dfm.t3_major.shape[0],
                    0 if dfm.wide else MAJOR_ROW_BYTES, device)
    return t3, major


def scan_work(dfm, q_rows, starts, stops, prm) -> dict:
    """The bytes and integer operations that the scan of these lanes (xla
    or none mode; stops [B] or the bounds [3, B] of segment lanes) needs,
    each input read once and each output written once. The plain scan runs once more, and before each step the table
    rows its live lanes are about to read are marked: an interval-extension
    step reads the t3 rows (and the major-checkpoint rows) of its two
    ranks, one row where both fall in one (a narrow index's 256-byte rows
    with their major rows, a wide one's 400-byte rows, which have none); a
    direct-compare step reads two
    256-base segments of the text, and on entering one SA word; an INIT
    step reads one comb_pairs word (8 bytes a step, at most the table) and
    no rank row. Per lane besides: its query window (code and ambiguity
    words), its start and three bounds in, the lane state out, its records
    out.
    Returns {n_bytes, n_ops, steps, rank_steps, direct_steps, init_steps,
    table_bytes}."""
    import torch
    from gsalign_tpu_torch.ops import seeding as sd
    dev = q_rows.device
    lanes = sd.ScanLanes.start(starts, stops, prm.max_out, dev)
    B = len(starts)
    t3, major = rank_rows(dfm, dev)
    text = Touched(-(-dfm.seq_len // 256) + 1, TEXT_SEG_BYTES, dev)
    n = torch.zeros(4, dtype=torch.int64, device=dev)  # rank, dir, init, sa
    direct = prm.sa_mode != "none"
    while lanes.max_len > 0:
        st = lanes.st
        ext = st[sd.F_PHASE] == sd.PHASE_EXT
        init = ~ext & (st[sd.F_CURSOR] < lanes.emit_stops)
        in_dir = ext & (st[sd.F_IK2] == 1) if direct \
            else torch.zeros_like(ext)
        iv = ext & ~in_dir
        for k in (st[sd.F_IK1], st[sd.F_IK1] + st[sd.F_IK2]):
            t3.mark(k >> 7, iv)
            major.mark(k >> 15, iv)
        enter = in_dir & (st[sd.F_DIR_SET] == 0)
        if direct:
            rc = dfm.sa_rows[st[sd.F_IK1].clamp(0, dfm.seq_len)].long()
            off = torch.where(enter, dfm.seq_len - rc - st[sd.F_EXT_POS],
                              st[sd.F_DIR_OFF])
            seg = (off + st[sd.F_EXT_POS]).clamp(0, dfm.seq_len - 1) >> 8
            text.mark(seg, in_dir)
            text.mark(seg + 1, in_dir)
        n += torch.stack([iv.sum(), in_dir.sum(), init.sum(), enter.sum()])
        if int(sd.seed_step_plain(dfm, q_rows, lanes, prm)) == 0:
            break
    rank_steps, direct_steps, init_steps, sa_words = n.tolist()
    steps = rank_steps + direct_steps + init_steps
    st = lanes.st.cpu().numpy()
    if steps != int(st[sd.F_STEPS].sum()):
        raise AssertionError("scan_work: the steps counted by kind are not "
                             "the steps the lanes took")
    comb = min(8 * init_steps,
               dfm.comb_pairs.numel() * dfm.comb_pairs.element_size())
    table_bytes = t3.bytes() + major.bytes() + text.bytes() \
        + 4 * sa_words + comb
    window = 2 * 4 * ((lanes.max_len >> 4) + 20)
    # per lane in: its start and its emit, ext and hard bounds
    n_bytes = table_bytes + B * (window + 4 * 8 + 8 * sd.N_FIELDS) \
        + 24 * int(st[sd.F_OUT_N].sum())
    return {"n_bytes": n_bytes, "table_bytes": table_bytes,
            "n_ops": 2 * RANK_OPS * rank_steps + STEP_OPS * steps,
            "steps": steps, "rank_steps": rank_steps,
            "direct_steps": direct_steps, "init_steps": init_steps}


def first_round(dfm, queries):
    """scan_lanes' arguments (q_rows, starts, stops, prm) of the first
    round of find_seeds_all on `queries`, in the default (xla) SA mode."""
    from gsalign_tpu_torch.ops import seeding
    rounds = []
    with sa_mode_env(None):
        seeding.find_seeds_all(dfm, queries, rounds=rounds)
    return rounds[0][:4]


def scan_check(tag: str, dfm, queries):
    """seed_scan against the plain scan on the first round's lanes of
    `queries`: records and lane state must be equal. Returns ({ms,
    plain_ms, max_abs_err, bound_ms, bound_by}, the round's scan_lanes
    arguments (q_rows, starts, stops, prm), the plain scan's lanes)."""
    from gsalign_tpu_torch.ops import seed_cuda, seeding
    args = first_round(dfm, queries)
    q_rows, starts, stops, prm = args

    def fresh():
        return fresh_lanes(args)

    def err_of(lanes, st, plain_lanes, plain_st):
        return max(int(np.abs(st - plain_st).max()),
                   int((lanes.out - plain_lanes.out).abs().max()))
    p_lanes = fresh()
    p_st, plain_ms = timed(lambda: seeding.seed_scan_plain(dfm, q_rows,
                                                           p_lanes, prm))
    lanes = fresh()
    st = seed_cuda.seed_scan(dfm, q_rows, lanes, prm)    # also the warm-up
    err = err_of(lanes, st, p_lanes, p_st)
    if err:
        bad = np.argwhere(st != p_st)[:5].tolist()
        raise AssertionError(f"seed_scan {tag}: records or lane state "
                             f"differ from the plain scan (max |diff| "
                             f"{err}; state rows, lanes {bad})")
    reps = []
    for _ in range(5):                # the launch and the state read-back
        again = fresh()
        reps.append(timed(lambda: seed_cuda.seed_scan(dfm, q_rows, again,
                                                      prm))[1])
    ms = sum(reps) / len(reps)
    steps = st[seeding.F_STEPS]
    n_rec = int(st[seeding.F_OUT_N].sum())
    work = scan_work(dfm, q_rows, starts, stops, prm)
    if work["steps"] != int(steps.sum()):
        raise AssertionError(f"seed_scan {tag}: the work count's scan took "
                             f"other steps than the kernel's")
    bnd = bound(work["n_bytes"], work["n_ops"])
    say(f"[kernel] seed_scan {tag} {prm.sa_mode}: {len(starts)} lanes, "
        f"{work['steps']} steps in all ({work['init_steps']} INIT, "
        f"{work['rank_steps']} interval, {work['direct_steps']} direct), "
        f"longest lane {int(steps.max())} (plain loop: "
        f"{int(p_st[seeding.F_STEPS].max())} iterations), {n_rec} records; "
        f"kernel {ms:.3f} ms (5 launches: "
        f"{', '.join(f'{r:.3f}' for r in reps)})  plain {plain_ms:.1f} ms  "
        f"bound {bnd['bound_ms']:.5f} ms ({bnd['bound_by']}: "
        f"{work['n_bytes']} bytes, {work['table_bytes']} of them distinct "
        f"table rows; {work['n_ops']} operations)  equal")
    return ({"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **bnd},
            (q_rows, starts, stops, prm), p_lanes)


def lockstep_check(tag: str, dfm, case, sa_mode: str, bnd: dict,
                   plain=None, max_blocks=None, need_stalls=False):
    """seed_lockstep in `sa_mode` against the host loop
    scan_lockstep(plain=True) on the lanes of `case` (scan_lanes' arguments):
    lane state, counters (iterations, live, words gathered, stalls) and
    records must be equal. `plain` is (lanes, ms) of a plain scan already
    run in this mode. `bnd` is the scan's bound (scan_work): the same lanes
    take the same steps in every mode, a stall needs no work, and the fused
    gather's words are the SA words that scan_work counts. Times: the launch
    alone, 5 launches on fresh lanes queued behind the spin kernel
    (cuda_ms), and one wrapper call with its read-back. Returns ({ms,
    plain_ms, max_abs_err, bound_ms, bound_by}, counters, (lanes, ms) of the
    plain scan, the call's ms)."""
    import dataclasses
    import torch
    from gsalign_tpu_torch.ops import cuda_build, seed_cuda, seeding
    q_rows, starts, stops, prm = case
    prm = dataclasses.replace(prm, sa_mode=sa_mode)
    dev = q_rows.device

    def fresh():
        return seeding.ScanLanes.start(starts, stops, prm.max_out, dev)
    if plain is None:
        p_lanes = fresh()
        plain = (p_lanes, timed(lambda: seeding.scan_lockstep(
            dfm, q_rows, p_lanes, prm, plain=True))[1])
    p_lanes, plain_ms = plain
    lanes = fresh()
    _, c = seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm,
                                   max_blocks=max_blocks)
    err = max(int((lanes.buf - p_lanes.buf).abs().max()),
              int((lanes.out - p_lanes.out).abs().max()))
    if err:
        raise AssertionError(
            f"seed_lockstep {tag} {sa_mode}: lane state, counters or records "
            f"differ from the plain lock-step scan (max |diff| {err}; "
            f"counters {c.tolist()} against {p_lanes.counters.tolist()})")
    n_iter, _, gathered, stalled = c.tolist()
    if need_stalls and stalled <= 0:
        raise AssertionError(f"seed_lockstep {tag}: no lane stalled, so the "
                             f"case does not test the slots")
    lib = seed_cuda.build()
    plan = seed_cuda.lockstep_plan(
        len(starts), seed_cuda.resident_blocks(
            lib, seed_cuda._win_words(lanes.max_len), dfm.wide),
        seed_cuda.resident_blocks(lib, -1, dfm.wide), max_blocks)
    batch = [fresh() for _ in range(5)]
    todo = iter(batch)
    ms = cuda_ms(lambda: seed_cuda.launch_lockstep(
        lib, cuda_build.stream(dev), dfm, q_rows, next(todo), prm, 0,
        max_blocks), 5)
    if not all(torch.equal(x.buf, p_lanes.buf) for x in batch):
        raise AssertionError(f"seed_lockstep {tag} {sa_mode}: a timed launch "
                             f"differs from the plain scan")
    again = fresh()
    call_ms = timed(lambda: seed_cuda.seed_lockstep(
        dfm, q_rows, again, prm, max_blocks=max_blocks))[1]
    fused = bound(4 * gathered, gathered)
    say(f"[kernel] seed_lockstep {tag} {sa_mode}: {len(starts)} lanes in "
        f"{plan[0]} blocks, {plan[1]} lane(s) a warp, window "
        f"{'staged' if plan[2] else 'in q_rows'}"
        f"{f' (grid capped at {max_blocks} blocks)' if max_blocks else ''}; "
        f"{n_iter} iterations, {gathered} SA words gathered in the scan "
        f"(their bytes alone: bound {fused['bound_ms']:.7f} ms), {stalled} "
        f"lane-iterations stalled; kernel {ms:.3f} ms "
        f"({1e3 * ms / max(1, n_iter):.2f} us an iteration; the call with "
        f"its read-back {call_ms:.3f} ms)  plain {plain_ms:.1f} ms  bound "
        f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}, the scan's)  equal")
    return ({"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
             "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"]},
            c, plain, call_ms)


def barrier_cost(tag: str, dfm, case, plain_lanes, reps: int = 5):
    """What seed_lockstep's grid barrier and counts cost an iteration, apart
    from lanes waiting for each other: the lanes of `case` with every lane
    but the longest emptied (its block and warp still arrive at every
    barrier), through seed_lockstep and through seed_scan, which runs the
    same steps of that one lane with no barrier; both as calls with their
    read-back, in turns."""
    from gsalign_tpu_torch.ops import seed_cuda, seeding
    q_rows, starts, stops, prm = case
    steps = plain_lanes.st[seeding.F_STEPS].cpu().numpy()
    lone = int(np.argmax(steps))
    stops1 = starts.copy()
    stops1[lone] = stops[lone]
    ms = {"seed_lockstep": 0.0, "seed_scan": 0.0}
    for _ in range(reps):
        got = {}
        for name in ms:
            lanes = seeding.ScanLanes.start(starts, stops1, prm.max_out,
                                            q_rows.device)
            res, t = timed(lambda: getattr(seed_cuda, name)(
                dfm, q_rows, lanes, prm))
            ms[name] += t / reps
            got[name] = res[0] if name == "seed_lockstep" else res
        if not np.array_equal(got["seed_lockstep"], got["seed_scan"]) \
                or got["seed_scan"][seeding.F_STEPS].max() != steps[lone]:
            raise AssertionError(f"barrier_cost {tag}: the lone lane's scans "
                                 f"differ")
    say(f"[kernel] seed_lockstep {tag} with one live lane of {len(starts)} "
        f"({steps[lone]} iterations): {ms['seed_lockstep']:.3f} ms against "
        f"seed_scan's {ms['seed_scan']:.3f} ms on the same lane: the grid "
        f"barrier and the counts cost "
        f"{1e3 * (ms['seed_lockstep'] - ms['seed_scan']) / steps[lone]:.2f} "
        f"us an iteration")


def seed_step_check(tag: str, dfm, case, n_iters: int = 64):
    """seed_step (seed_lockstep for one iteration, its slots and gather
    inside) against _sa_slots, masked_gather_plain and seed_step_plain,
    iteration by iteration in pallas mode: live count, lane state and
    records equal after each. Returns its mean milliseconds a call."""
    import dataclasses
    import torch
    from gsalign_tpu_torch.ops import gather, seed_cuda, seeding
    q_rows, starts, stops, prm = case
    prm = dataclasses.replace(prm, sa_mode="pallas")
    k_lanes, p_lanes = (seeding.ScanLanes.start(starts, stops, prm.max_out,
                                                q_rows.device)
                        for _ in range(2))
    K = min(seeding._SA_GATHER_K, len(starts))
    n0, total = seed_cuda.seed_step.launches, 0.0
    for i in range(n_iters):
        live, ms = timed(lambda: seed_cuda.seed_step(dfm, q_rows, k_lanes,
                                                     prm))
        total += ms
        slot, res_k = seeding._sa_slots(dfm, p_lanes, K,
                                        gather.masked_gather_plain)
        p_live = int(seeding.seed_step_plain(dfm, q_rows, p_lanes, prm, slot,
                                             res_k))
        if live != p_live or not torch.equal(k_lanes.st, p_lanes.st) \
                or not torch.equal(k_lanes.out, p_lanes.out):
            raise AssertionError(f"seed_step {tag}: iteration {i} differs "
                                 f"from seed_step_plain (live {live} "
                                 f"against {p_live})")
    if seed_cuda.seed_step.launches - n0 != n_iters:
        raise AssertionError("seed_step: a call made no launch")
    say(f"[kernel] seed_step {tag} pallas: {n_iters} iterations, one launch "
        f"each, equal to seed_step_plain after every one; "
        f"{total / n_iters:.3f} ms a call with its read-back")
    return total / n_iters


def phase_seed_kernels() -> dict:
    """masked_gather, seed_scan, seed_lockstep (as which seed_step is
    listed) and resolve_sa against their plain torch versions on the card,
    on narrow and wide indexes. Returns per-kernel {ms, plain_ms,
    max_abs_err, bound_ms, bound_by}."""
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
    # K indices in, K words out, and the words that the valid indices name
    bnd = bound(4 * K + 4 * K + 4 * int((idx >= 0).sum()), K)
    totals["masked_gather"] = {"ms": ms, "plain_ms": plain_ms,
                               "max_abs_err": err, **bnd}

    # seed_scan against its plain version (the lock-step plain scan) at
    # 4.6 Mb and 12 Mb (xla) and on the sampled index (none)
    dfm46, q46 = load_case("4.6mb", "idx")
    dfm8, q8 = load_case("12mb", "idx8")
    scans = {tag: scan_check(tag, dfm, queries)
             for tag, dfm, queries in (("4.6mb", dfm46, q46),
                                       ("12mb", dfm12, q12),
                                       ("12mb-sa8", dfm8, q8))}
    CASES.update({"4.6mb": (dfm46, q46, scans["4.6mb"]),
                  "12mb-sa8": (dfm8, q8, scans["12mb-sa8"])})
    totals["seed_scan"] = scans["4.6mb"][0]       # the main path's shapes

    # seed_lockstep against the host loop of the plain step: in xla mode at
    # 4.6 Mb against the plain scan that seed_scan was held against; in
    # pallas mode at 4.6 Mb and at 12 Mb, where 1,200 lanes contend for the
    # K slots (stall and retry), there also with several lanes a warp
    res, case46, plain46 = scans["4.6mb"]
    _, c, _, call_ms = lockstep_check("4.6mb", dfm46, case46, "xla", res,
                                      plain=(plain46, res["plain_ms"]))
    say(f"[kernel] the lock step at 4.6mb xla costs "
        f"{1e3 * (call_ms - res['ms']) / c[0]:.2f} us an iteration over "
        f"seed_scan (both as calls with their read-back): the grid barrier, "
        f"the counts, and every lane waiting for the slowest step")
    totals["seed_step"], c46 = lockstep_check("4.6mb", dfm46, case46,
                                              "pallas", res)[:2]
    res, case12, _ = scans["12mb"]
    _, c12, plain12, _ = lockstep_check("12mb", dfm12, case12, "pallas", res,
                                        need_stalls=True)
    lockstep_check("12mb", dfm12, case12, "pallas", res, plain=plain12,
                   max_blocks=64, need_stalls=True)
    for tag, c_, expect in (("4.6mb", c46, 737), ("12mb", c12, 862)):
        if c_[0] != expect:
            raise AssertionError(f"seed_lockstep {tag} pallas: {c_[0]} "
                                 f"iterations, the JAX package's scan takes "
                                 f"{expect}")
    seed_step_check("4.6mb", dfm46, case46)
    barrier_cost("4.6mb", dfm46, case46, plain46)

    # the forced-wide index: seed_scan against its plain version, and
    # seed_lockstep without slots (the lane-by-lane diffing tool) against
    # the same plain scan
    dfmw, qw = load_case("12mb", "idxw")
    scans["12mb-wide"] = scan_check("12mb-wide", dfmw, qw)
    res, casew, plainw = scans["12mb-wide"]
    lockstep_check("12mb-wide", dfmw, casew, "none", res,
                   plain=(plainw, res["plain_ms"]))

    # resolve_sa: every rank the 12 Mb sampled and wide runs resolve; the
    # kernels line takes the wide run's
    resolve_check("12mb-sa8", dfm8, q8, dfm12.host_sa)
    totals["resolve_sa"] = resolve_check("12mb-wide", dfmw, qw,
                                         dfm12.host_sa)
    CASES["12mb-wide"] = (dfmw, qw, scans["12mb-wide"])
    CASES["bounds"] = dict(totals)
    return totals


# phase_seed_kernels' indexes, queries and scan_check results by tag, and
# its totals ("bounds"), which phase_mesh holds the row-sharded instances
# against
CASES: dict = {}


def hit_ranks_of(dfm, queries):
    """The ranks that find_seeds_all's hit expansion resolves for
    `queries` (the first round's hits), int64 on the index's device."""
    import torch
    from gsalign_tpu_torch.ops import seeding
    captured = []
    expand = seeding._expand_hits

    def capture(dfm, qs, ls, k0, fr, plain=False):
        captured.append((k0, fr))
        return expand(dfm, qs, ls, k0, fr, plain)
    seeding._expand_hits = capture
    try:
        seeding.find_seeds_all(dfm, queries)
    finally:
        seeding._expand_hits = expand
    return torch.from_numpy(seeding.hit_ranks(*captured[0])[1]).to(
        dfm.device)


def resolve_check(tag: str, dfm, queries, full_sa=None) -> dict:
    """resolve_sa on every rank that the run of `queries` resolves,
    against the plain LF walk and (given) the full suffix array. Times: 20
    launches queued behind the spin kernel (cuda_ms), and one wrapper call
    on the host clock (timed). Returns {ms, plain_ms, max_abs_err,
    bound_ms, bound_by}."""
    import torch
    from gsalign_tpu_torch.ops import rank, seed_cuda
    k = hit_ranks_of(dfm, queries)
    plain, plain_ms = timed(lambda: rank.resolve_sa(dfm, k))
    if full_sa is not None and not np.array_equal(plain.cpu().numpy(),
                                                  full_sa[k.cpu().numpy()]):
        raise AssertionError(f"resolve_sa {tag}: the plain walk differs "
                             f"from the full suffix array")
    # the LF steps these ranks need, and the distinct t3 (and, narrow,
    # major) rows they read; the rank in, its sample in and the SA value
    # out
    t3, major = rank_rows(dfm, k.device)
    walk, steps, longest = k.clone(), 0, 0
    while True:
        active = (walk & (dfm.sa_intv - 1)) != 0
        n_active = int(active.sum())
        if n_active == 0:
            break
        steps += n_active
        longest += 1
        t3.mark(walk >> 7, active)
        major.mark(walk >> 15, active)
        walk = torch.where(active, rank.lf_t3(dfm, walk), walk)
    n_bytes = t3.bytes() + major.bytes() + k.numel() * (
        8 + dfm.sa_samples.element_size() + 8)
    bnd = bound(n_bytes, steps * RANK_OPS)
    got = seed_cuda.resolve_sa(dfm, k)
    err = int((got - plain).abs().max()) if k.numel() else 0
    if err:
        raise AssertionError(f"resolve_sa {tag} differs from the plain "
                             f"version")
    ms = cuda_ms(lambda: seed_cuda.resolve_sa(dfm, k), 20)
    call_ms = timed(lambda: seed_cuda.resolve_sa(dfm, k))[1]
    say(f"[kernel] resolve_sa {tag}: {k.numel()} ranks "
        f"({'wide' if dfm.wide else 'narrow'}, sa_intv {dfm.sa_intv}, "
        f"{steps} LF steps, longest walk {longest})  kernel {ms:.4f} ms"
        f" ({100 * bnd['bound_ms'] / ms:.1f} % of the bound; one call "
        f"{call_ms:.3f} ms)  plain {plain_ms:.1f} ms  bound "
        f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}: {n_bytes} bytes, "
        f"{steps * RANK_OPS} operations)  equal to the plain version"
        + ("" if full_sa is None else " and to the full SA"))
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **bnd}


SEGMENTS = (1, 4, 8, 16)     # n_segments of the segments phase
SEG_SLACK = 600              # its slack (the JAX package's default)
SEG_CHECKED = 8              # the n_segments held against the plain scan


def segment_lanes_check(tag: str, dfm, rnd, kernel, plain_of=None) -> dict:
    """The kernel (seed_scan, or seed_lockstep in pallas mode) on one scan
    round's lanes (find_seeds_all's rounds entry) against the plain scan of
    the same lanes on `plain_of` (dfm's whole tables; dfm itself for None):
    equal lane state (exits, poison, F_STEPS), records and, in the lock
    step, counters; the plain scan timed on the host clock after a
    synchronise. Returns {plain_ms, lanes (the plain scan's), max_abs_err}."""
    from gsalign_tpu_torch.ops import seed_cuda, seeding
    q_rows, starts, bounds, prm, _, _ = rnd
    args = (q_rows, starts, bounds, prm)
    p_lanes = fresh_lanes(args)
    plain_ms = timed(lambda: seeding.scan_lockstep(
        plain_of or dfm, q_rows, p_lanes, prm, plain=True))[1]
    lanes = fresh_lanes(args)
    getattr(seed_cuda, kernel)(dfm, q_rows, lanes, prm)
    # the lock step's counters too (seed_scan fills none)
    key = "buf" if kernel == "seed_lockstep" else "st"
    err = max(int((getattr(lanes, key) - getattr(p_lanes, key)).abs().max()),
              int((lanes.out - p_lanes.out).abs().max()))
    if err:
        raise AssertionError(f"{kernel} {tag}: segment lanes differ from the "
                             f"plain scan (max |diff| {err})")
    return {"plain_ms": plain_ms, "lanes": p_lanes, "max_abs_err": err}


def segment_runs(tag: str, dfm, queries, sa_mode, slacks=None, base=None,
                 whole=None) -> dict:
    """find_seeds_all on `queries` at n_segments 1, 4, 8 and 16 (slack
    SEG_SLACK, or n: slack of `slacks`), each run's seeds equal to the
    n_segments=1 run's; one [segments] line a run. The kernel (seed_scan,
    or seed_lockstep in pallas mode) is timed on each run's first round
    (launch and state read-back, mean of 3, warm). At SEG_CHECKED segments
    the first round's lanes and a fixup round's are held against the plain
    scan (of `whole`'s tables where dfm is cut into row blocks) and the
    first round's bound computed (scan_work; the bound of `base`, a result
    of this function on the same lanes in xla mode, where given). Returns
    {n_segments: {stats, ms, wall_s}, "kernel": {ms, plain_ms, max_abs_err,
    bound_ms, bound_by, longest, lanes, steps}}."""
    import torch
    from gsalign_tpu_torch.ops import seed_cuda, seeding
    from gsalign_tpu_torch.utils import trace
    kernel = "seed_lockstep" if sa_mode == "pallas" else "seed_scan"
    wrapper = getattr(seed_cuda, kernel)
    out, one = {}, None
    runs = [(n, SEG_SLACK) for n in SEGMENTS] + list((slacks or {}).items())
    with sa_mode_env(sa_mode):
        for n, slack in runs:
            stats, rounds, rec = {}, [], trace.Recorder()
            torch.cuda.synchronize()
            t0 = time.time()
            with trace.bind(rec):
                seeds = seeding.find_seeds_all(dfm, queries, n_segments=n,
                                               slack=slack, stats=stats,
                                               rounds=rounds)
            wall = time.time() - t0
            lanes_by_round = [len(r[1]) for r in rounds]
            if one is None:
                one = seeds
            elif any(not np.array_equal(a, b) for x, y in zip(seeds, one)
                     for a, b in zip(x, y)):
                raise AssertionError(f"segments {tag} n_segments={n} slack="
                                     f"{slack}: seeds differ from "
                                     f"n_segments=1")
            rnd = rounds[0]
            reps = []
            for _ in range(3):
                lanes = fresh_lanes(rnd[:4])
                reps.append(timed(lambda: wrapper(dfm, rnd[0], lanes,
                                                  rnd[3]))[1])
            ms = sum(reps) / len(reps)
            key = n if slack == SEG_SLACK else f"{n}/{slack}"
            out[key] = {"stats": stats, "ms": ms, "wall_s": wall}
            say(f"[segments] {tag} {rnd[3].sa_mode} n_segments={n} slack="
                f"{slack}: "
                f"{stats['scan_lanes']} lanes, poisoned at a bound "
                f"{stats['poisoned_at_bound'][0]}, with a full buffer "
                f"{stats['poisoned_full'][0]}; fixup rounds "
                f"{len(lanes_by_round) - 1} of "
                f"{lanes_by_round[1:]} lanes (poisoned "
                f"{stats['poisoned_full'][1:]}); longest lane "
                f"{stats['scan_iterations'][0]} steps (rounds "
                f"{stats['scan_iterations']}); round 1 {kernel} {ms:.3f} ms "
                f"({', '.join(f'{r:.3f}' for r in reps)}); host "
                f"reconciliation {sum(rec.seconds('seed.hits')):.4f} s; "
                f"find_seeds_all {wall:.3f} s; seeds equal to n_segments=1")
            if n != SEG_CHECKED or slack != SEG_SLACK:
                continue
            chk = segment_lanes_check(tag, dfm, rnd, kernel, whole)
            if len(rounds) > 1:
                segment_lanes_check(f"{tag} fixup", dfm, rounds[1], kernel,
                                    whole)
            if base is None:
                work = scan_work(whole or dfm, *rnd[:4])
                bnd = bound(work["n_bytes"], work["n_ops"])
            else:
                bnd = base["kernel"]
            st = chk["lanes"].st.cpu().numpy()
            out["kernel"] = {
                "ms": ms, "plain_ms": chk["plain_ms"],
                "max_abs_err": chk["max_abs_err"],
                "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                "lanes": len(rnd[1]),
                "steps": int(st[seeding.F_STEPS].sum()),
                "longest": int(st[seeding.F_STEPS].max())}
            say(f"[kernel] {kernel} {tag} {rnd[3].sa_mode} segments "
                f"(n_segments={n}, slack={slack}): {len(rnd[1])} lanes, "
                f"{out['kernel']['steps']} steps, longest "
                f"{out['kernel']['longest']}  kernel {ms:.3f} ms  plain "
                f"{chk['plain_ms']:.1f} ms  bound {bnd['bound_ms']:.5f} ms "
                f"({bnd['bound_by']})  equal, and a fixup round's "
                f"{len(rounds[1][1]) if len(rounds) > 1 else 0} lanes equal")
    return out


def phase_segments(card: str) -> dict:
    """Speculative seed segments on the card (find_seeds_all n_segments 1,
    4, 8, 16, slack SEG_SLACK; segment_runs) on the indexes and queries of
    phase 6: 4.6 Mb full-SA in xla mode (seed_scan; and slack 20 at 8
    segments, which must poison lanes at their bounds) and in pallas mode
    (seed_lockstep), 12 Mb sa_intv=8, 12 Mb forced-wide, and 12 Mb
    sa_intv=8 with t3 and sa_samples in MESH_ENTRIES row blocks of the
    card. Returns {tag: segment_runs result}."""
    import torch
    from gsalign_tpu_torch.parallel.mesh import make_mesh, shard_index_rows
    for tag, idx in (("4.6mb", "idx"), ("12mb-sa8", "idx8"),
                     ("12mb-wide", "idxw")):
        if tag not in CASES:
            CASES[tag] = load_case(tag.split("-")[0], idx)
    dfm46, q46 = CASES["4.6mb"][:2]
    dfm8, q8 = CASES["12mb-sa8"][:2]
    dfmw, qw = CASES["12mb-wide"][:2]
    out = {"4.6mb": segment_runs("4.6mb", dfm46, q46, "xla",
                                 slacks={SEG_CHECKED: 20})}
    clipped = out["4.6mb"][f"{SEG_CHECKED}/20"]["stats"]
    if clipped["poisoned_at_bound"][0] <= 0:
        raise AssertionError("segments 4.6mb slack 20: no lane poisoned at "
                             "its bound")
    out["4.6mb-pallas"] = segment_runs("4.6mb", dfm46, q46, "pallas",
                                       base=out["4.6mb"])
    out["12mb-sa8"] = segment_runs("12mb-sa8", dfm8, q8, None)
    out["12mb-wide"] = segment_runs("12mb-wide", dfmw, qw, None)
    cut = shard_index_rows(dfm8, make_mesh([torch.device("cuda")]
                                           * MESH_ENTRIES))
    out["12mb-sa8-rows"] = segment_runs(
        f"12mb-sa8-rows ({MESH_ENTRIES} blocks)", cut, q8, None,
        base=out["12mb-sa8"], whole=dfm8)
    say(f"[segments] card: {card}")
    return out


MESH_ENTRIES = 4     # the card four times, a stream each (parallel/mesh.py)


def mesh_run(tag: str, d: str, idx: str, expect: dict, sa_mode=None,
             row_shard: bool = False) -> dict:
    """compare_genomes on the card over a MESH_ENTRIES-entry mesh (with
    row_shard: the index's t3 and sa_samples cut into MESH_ENTRIES row
    blocks, the lanes whole), GSALIGN_SA_MODE sa_mode, -t 1. Launch counts
    start at 0 just before the run and are read just after. Checks the
    outputs against `expect`. Returns {launches, wall, scan_launches,
    iterations}."""
    import torch
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.index.io import load_index
    from gsalign_tpu_torch.parallel.mesh import make_mesh
    from gsalign_tpu_torch.pipeline.align import compare_genomes
    fm = load_index(idx)
    records = read_fasta(f"{d}/qry.fa")
    mesh = make_mesh([torch.device("cuda")] * MESH_ENTRIES)
    zero_counts()
    t0 = time.time()
    with sa_mode_env(sa_mode):
        stats, coll, _ = compare_genomes(
            fm, records, AlignConfig(thread_num=1),
            output_prefix=f"{d}/{tag}", verbose=False, mesh=mesh,
            shard_index_rows=row_shard)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    got = {
        "alignments": stats.local_alignment_num,
        "aln_len": stats.total_alignment_length, "ani": f"{stats.ani:.2f}",
        "snv": coll.n_snv, "ins": coll.n_ins, "del": coll.n_del,
        "maf_sha256": hashlib.sha256(read(f"{d}/{tag}.maf")).hexdigest(),
        "vcf_sha256_no_reference_line": hashlib.sha256(
            strip_reference_line(read(f"{d}/{tag}.vcf"))).hexdigest(),
    }
    say(f"[mesh] {tag}: {mesh}, {'row blocks' if row_shard else 'stripes'}"
        f", align wall {wall:.2f} s (load_index and table layout "
        f"included); scan launches per round {stats.seed_scan_launches}, "
        f"iterations per round {stats.seed_scan_iterations}; kernel "
        f"launches {launches}")
    if got != expect:
        raise AssertionError(f"{tag}: outputs {got} differ from the "
                             f"unsharded run's {expect}")
    return {"launches": launches, "wall": wall,
            "scan_launches": stats.seed_scan_launches,
            "iterations": stats.seed_scan_iterations}


# calls of this module's functions in a process of their own, which prints
# their results as its last stdout line: a cooperative launch that never
# ends then stops the process at its time limit, not this one
MESH_WORKER = """
import json, os, sys
sys.path[:0] = [{repo!r}, {tests!r}]
import chip_smoke
print(json.dumps([getattr(chip_smoke, fn)(*a, **kw)
                  for fn, a, kw in {calls!r}]))
"""


def mesh_runs_apart(calls, timeout: float = 300) -> list:
    code = MESH_WORKER.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                              calls=calls)
    p = subprocess.Popen([sys.executable, "-c", code],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        so, se = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    for ln in so.splitlines()[:-1]:
        say(ln)
    if p.returncode != 0:
        raise RuntimeError(f"mesh runs {calls} exited {p.returncode}:\n"
                           f"{se[-4000:]}")
    return json.loads(so.strip().splitlines()[-1])


def sharded_times(run, whole, cut, fresh, reps: int = 5, queued=False):
    """Mean ms of run(dfm, lanes) on the whole tables and on the row-sharded
    ones, in turns (whole, cut, cut, whole), each on fresh lanes made before
    the clock starts: each call on the host clock with its synchronisation
    (timed), or with queued the launches behind the spin kernel
    (cuda_ms)."""
    ms = {"whole": 0.0, "cut": 0.0}
    for key in ("whole", "cut", "cut", "whole"):
        dfm = whole if key == "whole" else cut
        batch = [fresh() for _ in range(reps)]
        if queued:
            todo = iter(batch)
            t = cuda_ms(lambda: run(dfm, next(todo)), reps)
        else:
            t = sum(timed(lambda: run(dfm, lanes))[1] for lanes in batch
                    ) / reps
        ms[key] += t / 2
    return ms["whole"], ms["cut"]


def say_sharded(name: str, blocks: int, what: str, r: dict) -> None:
    say(f"[kernel] {name} row-sharded ({blocks} blocks) {what}: kernel "
        f"{r['ms']:.4f} ms beside the whole-table instance's "
        f"{r['whole_ms']:.4f} ms on the same inputs "
        f"({100 * (r['ms'] / r['whole_ms'] - 1):+.1f} %)  plain "
        f"{r['plain_ms']:.1f} ms  "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, the whole-table "
        f"instance's: the same bytes)  max |diff| {r['max_abs_err']}")


def sharded_result(ms, whole_ms, plain_ms, err, bnd) -> dict:
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "whole_ms": whole_ms}


def fresh_lanes(scan_args):
    """New lanes of a scan round (scan_lanes' arguments)."""
    from gsalign_tpu_torch.ops import seeding
    q_rows, starts, stops, prm = scan_args
    return seeding.ScanLanes.start(starts, stops, prm.max_out, q_rows.device)


def sharded_scan_check(whole, cut, scan_args, p_lanes, bnd,
                       cut_plain=None) -> dict:
    """seed_scan's ShardedTable instance on `cut` (whole's rows in blocks)
    against the plain scan of the cut tables (through t3_row_fetch) on the
    lanes of scan_args, itself equal to p_lanes, the plain scan of the
    whole tables; then timed beside the whole-table instance, in turns
    (sharded_times), launch and read-back. cut_plain, (lanes, ms) of that
    plain scan through another cut of the same tables, stands in for it.
    Returns sharded_result's dict and the plain scan's (lanes, ms)."""
    from gsalign_tpu_torch.ops import seed_cuda, seeding
    q_rows, _, _, prm = scan_args

    def fresh():
        return fresh_lanes(scan_args)
    if cut_plain is None:
        plain = fresh()
        plain_ms = timed(lambda: seeding.seed_scan_plain(cut, q_rows, plain,
                                                         prm))[1]
    else:
        plain, plain_ms = cut_plain
    lanes = fresh()
    seed_cuda.seed_scan(cut, q_rows, lanes, prm)
    err = max(int((a - b).abs().max()) for a, b in (
        (lanes.st, plain.st), (lanes.out, plain.out),
        (plain.st, p_lanes.st), (plain.out, p_lanes.out)))
    if err:
        raise AssertionError(f"seed_scan row-sharded differs from the plain "
                             f"scan (max |diff| {err})")
    whole_ms, ms = sharded_times(
        lambda t, lanes: seed_cuda.seed_scan(t, q_rows, lanes, prm),
        whole, cut, fresh)
    return (sharded_result(ms, whole_ms, plain_ms, err, bnd),
            (plain, plain_ms))


def sharded_resolve_check(whole, cut, k, bnd, edges=None) -> dict:
    """resolve_sa's ShardedTable instance on `cut` against the plain walk
    through plane_fetch on the cut tables, itself equal to the plain walk
    on the whole tables, on the ranks k and (checked, not timed) `edges`;
    then timed on k beside the whole-table instance, in turns, 20 launches
    queued behind the spin kernel. Returns sharded_result's dict."""
    from gsalign_tpu_torch.ops import rank, seed_cuda
    want, plain_ms = timed(lambda: rank.resolve_sa(cut, k))
    checks = [(k, want)] if edges is None else \
        [(k, want), (edges, rank.resolve_sa(cut, edges))]
    err = max(max(int((seed_cuda.resolve_sa(cut, kk) - w).abs().max()),
                  int((rank.resolve_sa(whole, kk) - w).abs().max()))
              for kk, w in checks)
    if err:
        raise AssertionError(f"resolve_sa row-sharded differs from the plain "
                             f"walk (max |diff| {err})")
    whole_ms, ms = sharded_times(lambda t, _: seed_cuda.resolve_sa(t, k),
                                 whole, cut, lambda: None, reps=20,
                                 queued=True)
    return sharded_result(ms, whole_ms, plain_ms, err, bnd)


# row blocks of the mesh phase's one check past the 8 blocks that the
# kernels took before their bound was raised (seed_cuda.MAX_SHARDS)
MANY_BLOCKS = 16


def sharded_checks() -> dict:
    """The row-sharded instances against their plain versions (the plain
    scan, loop and walk reading the same cut tables through t3_row_fetch
    and plane_fetch) on the inputs of phase_seed_kernels, and timed beside
    the whole-table instances on the same inputs, in turns: seed_scan on the
    12 Mb sa_intv=8 index's first round, seed_lockstep in pallas mode on
    the 4.6 Mb full-SA index's, resolve_sa on the ranks of the 12 Mb
    forced-wide run, each over MESH_ENTRIES blocks; then over MANY_BLOCKS
    blocks seed_scan and resolve_sa.
    Their bounds are the whole-table instances' (the same bytes and
    operations). Returns {kernel_sharded: {ms, plain_ms, max_abs_err,
    bound_ms, bound_by, whole_ms}} of the MESH_ENTRIES-block checks."""
    import dataclasses
    import torch
    from gsalign_tpu_torch.ops import cuda_build, seed_cuda, seeding
    from gsalign_tpu_torch.parallel.mesh import make_mesh, shard_index_rows
    mesh = make_mesh([torch.device("cuda")] * MESH_ENTRIES)
    out = {}

    # seed_scan, 12 Mb sa_intv=8
    dfm8, _, (res, args8, p_lanes8) = CASES["12mb-sa8"]
    out["seed_scan_sharded"], cut_plain = sharded_scan_check(
        dfm8, shard_index_rows(dfm8, mesh), args8, p_lanes8, res)
    say_sharded("seed_scan", MESH_ENTRIES, f"12mb-sa8, {len(args8[1])} "
                f"lanes, launch and read-back", out["seed_scan_sharded"])

    # seed_lockstep, 4.6 Mb pallas
    dfm, _, (_, (q_rows, starts, stops, prm), _) = CASES["4.6mb"]
    prm = dataclasses.replace(prm, sa_mode="pallas")
    cut = shard_index_rows(dfm, mesh)

    def fresh():
        return fresh_lanes((q_rows, starts, stops, prm))
    plain = fresh()
    plain_ms = timed(lambda: seeding.scan_lockstep(cut, q_rows, plain, prm,
                                                   plain=True))[1]
    lanes = fresh()
    seed_cuda.seed_lockstep(cut, q_rows, lanes, prm)
    ref = fresh()
    seed_cuda.seed_lockstep(dfm, q_rows, ref, prm)
    err = max(int((lanes.buf - plain.buf).abs().max()),
              int((lanes.out - plain.out).abs().max()),
              int((ref.buf - plain.buf).abs().max()))
    if err:
        raise AssertionError(f"seed_lockstep row-sharded differs from the "
                             f"plain loop (max |diff| {err})")
    lib, stream = seed_cuda.build(), cuda_build.stream(q_rows.device)
    whole_ms, ms = sharded_times(
        lambda t, lanes: seed_cuda.launch_lockstep(lib, stream, t, q_rows,
                                                   lanes, prm, 0, None),
        dfm, cut, fresh, queued=True)
    out["seed_lockstep_sharded"] = sharded_result(
        ms, whole_ms, plain_ms, err, CASES["bounds"]["seed_step"])
    say_sharded("seed_lockstep", MESH_ENTRIES, f"4.6mb pallas, "
                f"{int(plain.counters[0])} iterations",
                out["seed_lockstep_sharded"])

    # resolve_sa, the 12 Mb forced-wide run's ranks
    dfmw, queries, _ = CASES["12mb-wide"]
    k = hit_ranks_of(dfmw, queries)
    out["resolve_sa_sharded"] = sharded_resolve_check(
        dfmw, shard_index_rows(dfmw, mesh), k, CASES["bounds"]["resolve_sa"])
    say_sharded("resolve_sa", MESH_ENTRIES, f"12mb-wide, {k.numel()} ranks",
                out["resolve_sa_sharded"])

    # MANY_BLOCKS blocks of the one card; seed_scan against the plain scan
    # through the MESH_ENTRIES blocks (the same function on the same lanes,
    # and the slowest plain run of the default run: not run twice)
    many = make_mesh([torch.device("cuda")] * MANY_BLOCKS)
    say_sharded("seed_scan", MANY_BLOCKS, f"12mb-sa8, {len(args8[1])} lanes; "
                f"plain: through {MESH_ENTRIES} blocks",
                sharded_scan_check(dfm8, shard_index_rows(dfm8, many), args8,
                                   p_lanes8, res, cut_plain=cut_plain)[0])
    say_sharded("resolve_sa", MANY_BLOCKS, f"12mb-wide, {k.numel()} ranks",
                sharded_resolve_check(dfmw, shard_index_rows(dfmw, many), k,
                                      CASES["bounds"]["resolve_sa"]))
    return out


# row blocks that phase_shard_times cuts the 12 Mb tables into
SHARD_TIMES_BLOCKS = (4, 8, MANY_BLOCKS)


def phase_shard_times() -> None:
    """The row-sharded instances of seed_scan (the 12 Mb sa_intv=8 index's
    first round, 1,200 lanes, launch and read-back) and resolve_sa (the 12
    Mb forced-wide run's ranks, 20 launches queued) timed beside their
    whole-table instances, in turns (sharded_times), over
    SHARD_TIMES_BLOCKS row blocks of the one card, each cut's results
    equal to the whole-table instance's. A cut that the kernels refuse
    (ValueError: more blocks than seed_cuda takes) is printed as refused.
    It uses nothing that this module's earlier versions' package lacks,
    so copied into a checkout of one it times that tree's kernels: run it
    in two trees in turns to compare them on one card."""
    import torch
    from gsalign_tpu_torch.ops import seed_cuda
    from gsalign_tpu_torch.parallel.mesh import make_mesh, shard_index_rows
    d = make_data("12mb", 12_000_000)
    sampled_indexes(d)
    dfm8, q8 = load_case("12mb", "idx8")
    dfmw, qw = load_case("12mb", "idxw")
    args = first_round(dfm8, q8)
    q_rows, _, _, prm = args
    ref = fresh_lanes(args)
    seed_cuda.seed_scan(dfm8, q_rows, ref, prm)
    k = hit_ranks_of(dfmw, qw)
    ref_sa = seed_cuda.resolve_sa(dfmw, k)
    src = "gsalign_tpu_torch/csrc/seed.cu"
    with open(os.path.join(REPO, src), "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    for n in SHARD_TIMES_BLOCKS:
        mesh = make_mesh([torch.device("cuda")] * n)
        cut8, cutw = shard_index_rows(dfm8, mesh), shard_index_rows(dfmw, mesh)
        lanes = fresh_lanes(args)
        try:
            seed_cuda.seed_scan(cut8, q_rows, lanes, prm)
        except ValueError as e:
            say(f"[shard-times] {src} {digest}, {n} blocks: refused ({e})")
            continue
        got = seed_cuda.resolve_sa(cutw, k)
        if not (torch.equal(lanes.st, ref.st) and torch.equal(lanes.out,
                                                              ref.out)
                and torch.equal(got, ref_sa)):
            raise AssertionError(f"shard-times: {n} blocks differ from the "
                                 f"whole tables")
        scan = sharded_times(
            lambda t, lanes: seed_cuda.seed_scan(t, q_rows, lanes, prm),
            dfm8, cut8, lambda: fresh_lanes(args))
        walk = sharded_times(lambda t, _: seed_cuda.resolve_sa(t, k), dfmw,
                             cutw, lambda: None, reps=20, queued=True)
        for name, (whole_ms, ms), what in (
                ("seed_scan", scan, f"12mb-sa8, {len(args[1])} lanes"),
                ("resolve_sa", walk, f"12mb-wide, {k.numel()} ranks")):
            say(f"[shard-times] {src} {digest}, {n} blocks: {name} ({what}) "
                f"row-sharded {ms:.4f} ms, whole-table {whole_ms:.4f} ms "
                f"({100 * (ms / whole_ms - 1):+.1f} %), equal")


def mesh_seed_times(mode: str, reps: int = 3) -> list:
    """find_seeds_all on the 4.6 Mb case (every round, hit expansion and the
    read-backs included) in SA mode `mode`, without and with the
    MESH_ENTRIES-entry mesh, in turns (none, mesh, mesh, none) after one
    untimed run of each, host clock after a synchronise; seeds equal.
    Returns [none ms, mesh ms]."""
    import torch
    from gsalign_tpu_torch.ops import seeding
    from gsalign_tpu_torch.parallel.mesh import make_mesh
    dfm, queries = CASES["4.6mb"][:2] if "4.6mb" in CASES \
        else load_case("4.6mb", "idx")
    mesh = make_mesh([dfm.device] * MESH_ENTRIES)
    ms = {None: 0.0, mesh: 0.0}
    seeds = {}
    with sa_mode_env(mode):
        for m in (None, mesh):          # warm-up: a new process's first run
            seeding.find_seeds_all(dfm, queries, mesh=m)
        for m in (None, mesh, mesh, None) * reps:
            torch.cuda.synchronize()
            t0 = time.time()
            seeds[m] = seeding.find_seeds_all(dfm, queries, mesh=m)
            ms[m] += (time.time() - t0) * 1e3 / (2 * reps)
    if any(not np.array_equal(a, b) for x, y in zip(seeds[None], seeds[mesh])
           for a, b in zip(x, y)):
        raise AssertionError(f"4.6mb {mode}: seeds over the mesh differ")
    say(f"[mesh] 4.6mb seed stage {mode}: {ms[None]:.2f} ms without a "
        f"mesh, {ms[mesh]:.2f} ms over {MESH_ENTRIES} entries of the card "
        f"({2 * reps} runs each, in turns); seeds equal")
    return [ms[None], ms[mesh]]


def phase_mesh(card: str, runs: dict) -> dict:
    """The mesh (parallel/mesh.py) on the one card, MESH_ENTRIES entries of
    it, a stream each: 4.6 Mb with the lanes and the DP problems in
    stripes, xla mode here and pallas mode (with a row-sharded pallas run)
    in a process of its own under a time limit; 12 Mb sa_intv=8 and
    forced-wide over row blocks; each with the unsharded runs' bytes, a
    scan launch a stripe and DP launches MESH_ENTRIES times the unsharded
    run's. Then the row-sharded instances against their plain versions
    (sharded_checks) and dryrun_multichip(MESH_ENTRIES). Returns {"runs":
    {tag: mesh_run result}, "kernels": sharded_checks result}."""
    from gsalign_tpu_torch.entry import dryrun_multichip
    d46, d12 = os.path.join(WORK, "4.6mb"), os.path.join(WORK, "12mb")
    out = {"4.6mb-mesh": mesh_run("4.6mb-mesh", d46, f"{d46}/idx",
                                  EXPECT_46)}
    t0 = time.time()
    apart = mesh_runs_apart([
        ("mesh_run", ("4.6mb-mesh-pallas", d46, f"{d46}/idx", EXPECT_46),
         {"sa_mode": "pallas"}),
        ("mesh_run", ("4.6mb-rows-pallas", d46, f"{d46}/idx", EXPECT_46),
         {"sa_mode": "pallas", "row_shard": True}),
        ("mesh_seed_times", ("pallas",), {})])
    say(f"[mesh] the pallas runs' process: {time.time() - t0:.1f} s")
    out["4.6mb-mesh-pallas"], out["4.6mb-rows-pallas"], _ = apart
    out["12mb-sa8-rows"] = mesh_run("12mb-sa8-rows", d12, f"{d12}/idx8",
                                    EXPECT_12, row_shard=True)
    out["12mb-wide-rows"] = mesh_run("12mb-wide-rows", d12, f"{d12}/idxw",
                                     EXPECT_12, row_shard=True)
    for tag, base in (("4.6mb-mesh", "4.6mb"),
                      ("4.6mb-mesh-pallas", "4.6mb-pallas"),
                      ("4.6mb-rows-pallas", "4.6mb-pallas"),
                      ("12mb-sa8-rows", "12mb-sa8"),
                      ("12mb-wide-rows", "12mb-wide")):
        r, b = out[tag], runs[base]["launches"]
        n = r["launches"]
        rows = "rows" in tag
        scan = "seed_lockstep" if "pallas" in tag else "seed_scan"
        checks = {
            # one scan a stripe that holds lanes; the row-sharded scan one
            # a round, by the sharded instance alone
            "scan": n[scan + ("_sharded" if rows else "")]
            == sum(r["scan_launches"]),
            "stripes": rows or r["scan_launches"][0] == MESH_ENTRIES,
            "whole scan unused": not rows or n[scan] == 0,
            "resolve": n["resolve_sa_sharded" if rows else "resolve_sa"]
            == b["resolve_sa"],
            "dp": all(n[k] == MESH_ENTRIES * b[k]
                      for k in ("dp_small", "dp_any")),
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"{tag}: launches {n} fail {failed} against "
                                 f"the unsharded run's {b}")
    kernels = sharded_checks()
    mesh_seed_times("xla")
    t0 = time.time()
    dryrun_multichip(MESH_ENTRIES)
    say(f"[mesh] dryrun_multichip({MESH_ENTRIES}) {time.time() - t0:.2f} s")
    say(f"[mesh] card: {card}")
    return {"runs": out, "kernels": kernels}


def phase_profile():
    """Device operations (kernels, copies and sets) of the seed stage under
    torch.profiler at 4.6 Mb, per scan, in both SA modes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gsalign_tpu_torch.ops import seeding
    from gsalign_tpu_torch.utils.trace import device_ops
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
        dev = device_ops(prof)
        n_iter = sum(stats["scan_iterations"])
        n_scan = len(stats["scan_iterations"])
        say(f"[profile] seed stage 4.6mb {mode}: {dev['n']} device "
            f"operations over {n_scan} scan(s) of {n_iter} iterations "
            f"({dev['n'] / max(1, n_scan):.1f} per scan, query rows and hit "
            f"expansion included); device busy {dev['busy_s']:.4f} s of "
            f"{wall:.3f} s traced wall")
        for name, (n, us) in sorted(dev["ops"].items(),
                                    key=lambda kv: -kv[1][1])[:8]:
            say(f"[profile]   {n:6d} x {us / n:8.2f} us  {name[:90]}")


ECOLI_LEN = 4_641_652     # the synth_ecoli configuration's genome


def phase_layout() -> dict:
    """Phase 12: init10_rows at the synth_ecoli shape. Returns its totals
    {init10_rows: {ms, plain_ms, max_abs_err, bound_ms, bound_by}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gsalign_tpu_torch.genome.packing import Genome
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    from gsalign_tpu_torch.ops import layout_cuda, rank
    from gsalign_tpu_torch.utils import trace
    from gsalign_tpu_torch.utils.trace import device_ops
    rng = np.random.default_rng(18)
    g = Genome(names=["chr"], lengths=np.asarray([ECOLI_LEN]),
               offsets=np.zeros(1, np.int64), holes=[],
               codes_fwd=rng.integers(0, 4, ECOLI_LEN).astype(np.uint8))
    fm = build_fmindex(g)
    n, text = fm.seq_len, g.codes_fwd_rc()
    t0 = time.time()
    rank.DeviceFMIndex.host_tables(fm)
    t1 = time.time()
    rank.DeviceFMIndex.host_tables(fm, card_init10=True)
    t2 = time.time()
    rec = trace.Recorder()
    with trace.bind(rec):
        dfm = rank.DeviceFMIndex.from_host(fm, "cuda")
    spans = {name: sum(rec.seconds(name)) for name in (
        "layout.host_tables", "layout.upload", "layout.init10")}
    torch.cuda.synchronize()
    t3 = time.time()
    cpu = rank.DeviceFMIndex.from_host(fm, "cpu")
    if not (torch.equal(dfm.comb_pairs.cpu(), cpu.comb_pairs)
            and torch.equal(dfm.init_corr.cpu(), cpu.init_corr)):
        raise AssertionError("the card's comb_pairs or init_corr differ "
                             "from the CPU layout's")
    say(f"[layout] synth_ecoli shape ({n} text bases, direct {dfm.direct_ok})"
        f": host_tables {t1 - t0:.4f} s with the histogram, "
        f"{t2 - t1:.4f} s without; from_host on the card: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in spans.items())
        + f" (host clock; {t3 - t2:.4f} s to the synchronise), "
        f"h2d.layout {rec.counters.get('h2d.layout', 0)} bytes, "
        f"layout.init10_card {rec.counters.get('layout.init10_card', 0)}; "
        f"comb_pairs and init_corr equal to the CPU layout's")
    t0 = time.time()
    starts, _ = rank._build_c10(text, n)
    ext = np.append(starts, n + 1).astype(np.uint64)
    plain = (ext[:-1] | (ext[1:] << np.uint64(32))).view(np.int64)
    plain_ms = (time.time() - t0) * 1e3
    rows = torch.empty(layout_cuda.N_KEYS, dtype=torch.int64, device="cuda")
    text_rows, steps = dfm.text_rows.view(-1), rank._c10_steps(text, n)

    def run():
        layout_cuda.init10_rows(text_rows, 32, n, steps, rows)
    run()
    err = int((rows.cpu().numpy() != plain).sum())
    if err:
        raise AssertionError(f"init10_rows: {err} rows differ from plain")
    ms = cuda_ms(run, reps=50)
    # the packed text read once, the rows written once; the counts live
    # in L2 between the passes
    bnd = bound(n // 4 + 8 * layout_cuda.N_KEYS, 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    dev = device_ops(prof)
    say(f"[kernel] init10_rows n={n} keys={layout_cuda.N_KEYS}  kernel "
        f"{ms:10.4f} ms  plain {plain_ms:10.1f} ms  bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: packed text and "
        f"rows); {n - 9} atomic adds, {(n - 9) / (ms * 1e-3) / 1e9:.2f} G/s;"
        f" rows equal")
    for name, (k, us) in sorted(dev["ops"].items(), key=lambda kv: -kv[1][1]):
        say(f"[profile]   {k:4d} x {us / k:9.2f} us  {name[:90]}")
    return {"init10_rows": {"ms": ms, "plain_ms": plain_ms,
                            "max_abs_err": err, "bound_ms": bnd["bound_ms"],
                            "bound_by": bnd["bound_by"]}}


def phase_wide_big():
    """wide-big: the JAX package's tests/test_wide_e2e.py on the card. A
    WIDE_BIG_LEN-base random genome (seed 40; 2N > 2^31), its index built
    once (auto: wide, sa_intv 8); a 200 kb query, the reverse complement of
    the mutated start of the genome, seeded (its loci lie past 2^31) with
    seed_scan and resolve_sa held against their plain versions on its lanes
    and ranks; a mutated 2 Mb slice aligned through compare_genomes."""
    import resource
    import torch
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.packing import Genome
    from gsalign_tpu_torch.index.fmindex import build_fmindex
    from gsalign_tpu_torch.ops import seeding
    from gsalign_tpu_torch.ops.rank import DeviceFMIndex
    from gsalign_tpu_torch.pipeline.align import compare_genomes

    def rss_gb():
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6

    def mutate(sl, rng, rate=0.005):
        out = sl.copy()
        subs = rng.random(len(out)) < rate
        out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
        return out.astype(np.uint8)
    t0 = time.time()
    rng = np.random.default_rng(40)
    codes = rng.integers(0, 4, WIDE_BIG_LEN, dtype=np.int64).astype(np.uint8)
    g = Genome(names=["big1"], lengths=np.asarray([WIDE_BIG_LEN]),
               offsets=np.asarray([0]), holes=[], codes_fwd=codes)
    say(f"[wide-big] genome of {WIDE_BIG_LEN} bases made in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    fm = build_fmindex(g)
    say(f"[wide-big] index build ({fm.seq_len} text rows, sa_intv "
        f"{fm.sa_intv}, {np.dtype(fm.rank_dtype).name} ranks): "
        f"{time.time() - t0:.1f} s, peak RSS {rss_gb():.1f} GB")
    if not (fm.seq_len > 2 ** 31 and fm.rank_dtype == np.int64):
        raise AssertionError("wide-big: the index is not wide")
    t0 = time.time()
    tabs = DeviceFMIndex.host_tables(fm)
    t1 = time.time()
    dfm = DeviceFMIndex.from_tables(tabs, None, fm.seq_len, fm.primary,
                                    device=torch.device("cuda"))
    torch.cuda.synchronize()
    del tabs
    n_bytes = sum(v.numel() * v.element_size() for v in vars(dfm).values()
                  if isinstance(v, torch.Tensor))
    say(f"[tables] wide-big: host layout (host_tables) {t1 - t0:.2f} s + "
        f"upload (from_tables) {time.time() - t1:.2f} s; device tables "
        f"{n_bytes} bytes ({n_bytes / 2 ** 30:.2f} GiB); peak RSS "
        f"{rss_gb():.1f} GB")

    # seeds of the reverse complement of the genome's mutated start
    sl = mutate(codes[:200_000], np.random.default_rng(7))
    qry = (3 - sl[::-1]).astype(np.uint8)
    seeding.find_seeds_all(dfm, [qry])                      # warm
    torch.cuda.synchronize()
    t0 = time.time()
    q_pos, r_pos, length = seeding.find_seeds_all(dfm, [qry])[0]
    seed_s = time.time() - t0
    text = fm.genome.codes_fwd_rc()
    for i in np.random.default_rng(1).integers(0, len(q_pos), 20):
        qp, rp, ln = int(q_pos[i]), int(r_pos[i]), int(length[i])
        if not np.array_equal(qry[qp:qp + ln], text[rp:rp + ln]):
            raise AssertionError(f"wide-big: seed {i} differs from the text")
    if len(q_pos) <= 100 or not (r_pos >= 2 ** 31).any():
        raise AssertionError(f"wide-big: {len(q_pos)} seeds, none past "
                             f"2^31")
    say(f"[wide-big] 200 kb query: {len(q_pos)} seeds, "
        f"{int((r_pos >= 2 ** 31).sum())} of them at text positions >= 2^31 "
        f"(largest {int(r_pos.max())}); 20 checked against the text; seed "
        f"stage {seed_s:.3f} s")
    scan_check("wide-big", dfm, [qry])
    resolve_check("wide-big", dfm, [qry])
    del dfm
    torch.cuda.empty_cache()

    # a mutated 2 Mb slice through the whole pipeline
    sl = mutate(codes[500_000_000:502_000_000], np.random.default_rng(11))
    records = [("slice_m", np.frombuffer(b"ACGT", dtype=np.uint8)[sl])]
    os.makedirs(WORK, exist_ok=True)
    t0 = time.time()
    stats, collector, _ = compare_genomes(
        fm, records, AlignConfig(), output_prefix=f"{WORK}/wide_e2e",
        verbose=False, device=torch.device("cuda"))
    wall = time.time() - t0
    stages = " ".join(f"{k}={v:.2f}s" for k, v in stats.stage_times.items())
    say(f"[wide-big] 2 Mb slice: align wall {wall:.1f} s (DeviceFMIndex."
        f"from_host included; stages {stages}), {stats.local_alignment_num} "
        f"alignments, ANI {stats.ani:.2f}, {collector.n_snv} SNVs; peak RSS "
        f"{rss_gb():.1f} GB")
    if not (stats.local_alignment_num >= 1 and stats.ani > 98.5
            and collector.n_snv > 5000):
        raise AssertionError("wide-big: the 2 Mb slice did not align as the "
                             "JAX package's test requires")


# run_3gb at 2 Mb (--len 2000000 --slice-len 100000): the counts of the
# JAX tool's run, which tests/test_torch_run3gb_driver.py holds the port's
# CPU run to (with byte-identical MAF and VCF)
TOOLS_ARGS = ["--len", "2000000", "--slice-len", "100000"]
EXPECT_RUN3GB_2MB = {"alignments": 3, "aligned_bp": 300_000,
                     "query_bp": 300_000, "ani_pct": 99.51, "snv": 1456,
                     "ins": 0, "dele": 0, "wide": False, "sa_intv": 1}
# The JAX tool's run of BASELINE.json config 5 (docs/SCALING_3GB.md:40-48)
CONFIG5_LEN = 3_100_000_000
JAX_3GB = {"alignments": 3, "aligned_bp": 24_000_000, "ani_pct": 99.5,
           "snv": 120_141, "ins": 0, "dele": 0,
           "max_text_rpos": 5_735_000_000, "wide": True, "sa_intv": 8}


def phase_tools(d46: str) -> dict:
    """The port's tools on the card. run_3gb at 2 Mb twice into one
    directory: whole tables (--entries 1, the card's default), then the
    index it saved (--index) with its rows cut over MESH_ENTRIES entries of
    the card (--entries MESH_ENTRIES); each with EXPECT_RUN3GB_2MB's counts
    and the seed_scan instance of its tables launched, counts set to 0 just
    before it and read just after; their MAF and VCF bytes equal. Then
    profile_pipeline on the 4.6 Mb pair in d46, one timed run after the
    warm-up, every stage printed. Returns {tag: run}."""
    import torch
    from gsalign_tpu_torch.tools import profile_pipeline, run_3gb
    out = os.path.join(WORK, "run3gb")
    runs, files = {}, {}
    for entries in (1, MESH_ENTRIES):
        tag = f"run3gb-2mb-{entries}"
        argv = TOOLS_ARGS + ["--out", out, "--device", "cuda", "--entries",
                             str(entries)]
        if entries > 1:
            argv += ["--index", f"{out}/idx"]
        zero_counts()
        t0 = time.time()
        res = run_3gb.run(run_3gb.parse_args(argv))[0]
        wall = time.time() - t0
        launches = launch_counts()
        files[entries] = (read(f"{out}/out.maf"), read(f"{out}/out.vcf"))
        got = {k: res[k] for k in EXPECT_RUN3GB_2MB}
        say(f"[tools] {tag}: wall {wall:.2f} s; result {json.dumps(res)}; "
            f"kernel launches {launches}")
        if got != EXPECT_RUN3GB_2MB or res["mesh_devices"] != entries:
            raise AssertionError(f"{tag}: {got} differs from the JAX "
                                 f"tool's counts {EXPECT_RUN3GB_2MB}")
        scan = "seed_scan" if entries == 1 else "seed_scan_sharded"
        if launches[scan] <= 0:
            raise AssertionError(f"{tag}: {scan} never ran: {launches}")
        runs[tag] = {"wall": wall, "launches": launches}
    if files[1] != files[MESH_ENTRIES]:
        raise AssertionError("run_3gb: the row-sharded run's MAF or VCF "
                             "differs from the whole-table run's")
    say(f"[tools] run_3gb 2 Mb: whole tables and {MESH_ENTRIES} row blocks "
        f"give the same out.maf ({len(files[1][0])} bytes) and out.vcf "
        f"({len(files[1][1])} bytes)")
    times = profile_pipeline.profile(d46, torch.device("cuda"), 1)[0]
    if tuple(times) != profile_pipeline.STAGES:
        raise AssertionError(f"profile_pipeline timed {list(times)}")
    say("[tools] profile_pipeline 4.6 Mb (PROF_REPS=1): " + " ".join(
        f"{k}={v:.4f}" for k, v in times.items())
        + f" TOTAL={sum(times.values()):.4f}")
    return runs


# the bench configurations of the probes phase: the first in the default
# run, both in the probes mode (the 250 Mb index build alone takes minutes)
PROBE_TAGS = ("celegans_100mb", "human_250mb")


def start_pair(tag: str):
    """(process, start time): a process that makes the bench configuration
    tag's pair and index under WORK (tools/common.pair_dir, the bench's
    make_pair and index build), started early so that make_pair's host loop
    and the build run beside the card's phases; at the lowest CPU priority,
    so that it takes the cores they leave idle."""
    code = ("import os\n"
            "os.nice(19)\n"
            "from gsalign_tpu_torch.tools.common import pair_dir\n"
            f"pair_dir({WORK!r}, {tag!r})\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO), \
        time.time()


def stop(procs) -> None:
    """Kill and reap every process of procs still running."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def probe_run(fn, *args, **kw):
    """(fn's result, the kernel launches inside it, its wall seconds): the
    counts set to 0 just before it and read just after."""
    zero_counts()
    t0 = time.time()
    res = fn(*args, **kw)
    wall = time.time() - t0
    return res, {k: n for k, n in launch_counts().items() if n}, wall


def phase_probes(tag: str, prep) -> dict:
    """The port's five stage probes (gsalign_tpu_torch/tools/) on the card
    at the bench configuration tag, once each, through their functions, on
    the pair and index that prep's process made (start_pair). Each prints
    the JAX tool's lines and one [probes] line. Checks: exp_dphist's
    compare_genomes gives the JAX record's counts (bench.JAX_RECORD);
    exp_align's n_dp is the sum of its buckets and of its recorded DP
    launches' problems; exp_seedprof's first round has the bench's seed
    lanes (a lane a 10 kb chunk); exp_seedab's seeds are the same with
    INIT-12 off, in no fewer steps; seed_scan launched inside each seed
    tool, and a DP kernel inside exp_align and exp_dphist. Then every DP
    launch that exp_align recorded (its last rep) goes through
    phase_main_shapes: each kernel that takes its width held against the
    plain version on the launch's whole inputs (ops equal) and timed
    against its bound. exp_seedprof's last run is traced (torch.profiler)
    for the device's busy share. Last, seed_scan on the main path's first
    round of lanes against the plain scan, timed against its bound
    (scan_check). Returns {"walls": {tool: s}, "errs": {kernel: max
    |diff|}}."""
    import torch
    from gsalign_tpu_torch import bench
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.tools import (exp_align, exp_dphist, exp_seedab,
                                         exp_seedprof, seed_stats)
    proc, started = prep
    if proc.wait(timeout=1200) != 0:
        raise RuntimeError(f"{tag}: making the pair and index exited "
                           f"{proc.returncode}")
    d = os.path.join(WORK, tag)
    with open(os.path.join(d, "build_seconds.json")) as fh:
        build_s = json.load(fh)["seconds"]
    say(f"[probes] {tag}: pair and index ready {time.time() - started:.1f} "
        f"s after their process started (index build {build_s:.1f} s)")
    dev = torch.device("cuda")
    walls = {}

    def launched(tool, launches, kernels):
        if not any(launches.get(k, 0) > 0 for k in kernels):
            raise AssertionError(f"{tag} {tool}: none of {kernels} "
                                 f"launched: {launches}")

    prof, launches, walls["exp_seedprof"] = probe_run(
        exp_seedprof.profile, d, tag, 3, dev,
        trace_dir=os.path.join(WORK, "trace", tag))
    exp_seedprof.report(prof)
    launched("exp_seedprof", launches, ("seed_scan",))
    chunk = AlignConfig().seed_exploration_chunk
    lanes = sum(-(-len(q) // chunk) for _, q in
                read_fasta(os.path.join(d, "qry.fa")))
    rounds = prof["reps"][-1]["rounds"]
    if rounds[0]["lanes"] != lanes:
        raise AssertionError(f"{tag} exp_seedprof: {rounds[0]['lanes']} "
                             f"lanes in round 1, the bench's {lanes}")
    tr = prof["trace"]
    say(f"[probes] exp_seedprof {tag}: rounds' lanes "
        f"{[r['lanes'] for r in rounds]}, longest lane's steps "
        f"{[r['steps'] for r in rounds]}, round seconds "
        f"{[round(r['wall_s'], 4) for r in rounds]}, us a step "
        f"{[round(r['us_per_step'], 3) for r in rounds]}, lane-step "
        f"integral {[round(r['integral_pct'], 1) for r in rounds]} % of B x "
        f"max; run {prof['reps'][-1]['total_s']:.4f} s, host outside the "
        f"rounds {prof['reps'][-1]['host_s']:.4f} s; device busy "
        f"{tr['busy_s']:.4f} s of {tr['wall_s']:.4f} s traced "
        f"({100 * tr['busy_share']:.1f} %); launches {launches}")

    st, launches, walls["seed_stats"] = probe_run(seed_stats.stats_of, d, dev)
    seed_stats.report(st)
    launched("seed_stats", launches, ("seed_scan",))
    say(f"[probes] seed_stats {tag}: a round a chromosome, B "
        f"{[r['B'] for r in st['rounds']]}, longest steps "
        f"{[r['max_iter'] for r in st['rounds']]}, total_max_iters "
        f"{st['total_max_iters']}, pass {st['wall_s']:.4f} s; launches "
        f"{launches}")

    ab, launches, walls["exp_seedab"] = probe_run(exp_seedab.ab, d, tag, dev)
    exp_seedab.report(ab)
    launched("exp_seedab", launches, ("seed_scan",))
    on, off = ab["rows"]
    if not (on["same"] and off["same"] and off["iters"] >= on["iters"]):
        raise AssertionError(f"{tag} exp_seedab: {ab['rows']}")
    say(f"[probes] exp_seedab {tag}: INIT-12 on {on['wall_s']:.4f} s, "
        f"{on['iters']} steps; off {off['wall_s']:.4f} s, {off['iters']} "
        f"steps; same seeds; launches {launches}")

    hist, launches, walls["exp_dphist"] = probe_run(exp_dphist.dphist, d,
                                                    tag, dev)
    exp_dphist.report(hist)
    launched("exp_dphist", launches, ("seed_scan",))
    launched("exp_dphist", launches, ("dp_small", "dp_any"))
    if tuple(hist["counts"]) != bench.JAX_RECORD[tag]:
        raise AssertionError(f"{tag} exp_dphist: counts {hist['counts']}, "
                             f"the JAX record's {bench.JAX_RECORD[tag]}")
    say(f"[probes] exp_dphist {tag}: {hist['dp_stats']}; hits a lane over "
        f"{hist['lanes']} lanes: mean {hist['mean']:.2f}, p50/90/99/99.9 "
        f"{hist['p50']:.0f}/{hist['p90']:.0f}/{hist['p99']:.0f}/"
        f"{hist['p99.9']:.0f}, max {hist['max']}; counts {hist['counts']} "
        f"(the JAX record's); stages "
        f"{ {k: round(v, 4) for k, v in hist['stage_times'].items()} }; "
        f"launches {launches}")

    inputs = []
    aln, launches, walls["exp_align"] = probe_run(exp_align.probe, d, tag, 2,
                                                  dev, inputs=inputs)
    exp_align.report(aln)
    launched("exp_align", launches, ("dp_small", "dp_any"))
    for rep in aln["reps"]:
        n_b = sum(rep["buckets"].values())
        n_l = sum(ln["B"] for ln in rep["launches"])
        if not rep["n_dp"] == n_b == n_l:
            raise AssertionError(f"{tag} exp_align: n_dp {rep['n_dp']}, "
                                 f"{n_b} in the buckets, {n_l} launched")
    rep = aln["reps"][-1]
    say(f"[probes] exp_align {tag}: n_dp {rep['n_dp']}, buckets "
        f"{rep['buckets']}; seconds "
        f"{ {k: round(v, 4) for k, v in rep['times'].items()} }; "
        f"{len(rep['launches'])} DP launches "
        + ", ".join(f"{ln['kernel']} L={ln['L']} B={ln['B']} "
                    f"{ln['ms']:.4f} ms" for ln in rep["launches"])
        + f"; their CUDA-event sum {rep['dp_event_ms']:.4f} ms beside "
        f"dp_device {rep['times']['dp_device'] * 1e3:.4f} ms; launches "
        f"{launches}")
    errs = phase_main_shapes(inputs)
    say(f"[probes] {tag}: every DP launch of exp_align's last rep "
        f"({len(inputs)}) held against the plain version on its whole "
        f"inputs: ops equal")
    dfm, queries = load_case(tag, "ref_idx")
    errs["seed_scan"] = scan_check(tag, dfm, queries)[0]["max_abs_err"]
    return {"walls": walls, "errs": errs}


# rows of the synthetic t3 of rows_past_2_32: 2^32 words and 102,400 more
PAST_2_32_ROWS = (1 << 32) // 100 + 1024


def rows_past_2_32(dfm):
    """A t3 of more than 2^32 words through the port's layout, upload and
    row decode: random checkpoints below 2^34 and symbol bytes below 0x40
    for PAST_2_32_ROWS rows, laid out by the wide layout (rank._wide_rows)
    on the host and uploaded by DeviceFMIndex.from_tables beside dfm's
    other tables; rows sampled on the card equal the host's; then the
    occ_rows kernel (WholeTable) against the plain occ_t3, which gathers
    the rows by torch indexing, on 50,000 ranks in the last 4,096 rows and
    on 50,000 anywhere (occ_rows_check)."""
    import torch
    from gsalign_tpu_torch.ops import rank
    from gsalign_tpu_torch.ops.rank import DeviceFMIndex
    dev = dfm.device
    n3 = PAST_2_32_ROWS
    rng = np.random.default_rng(17)
    t0 = time.time()
    t3_cp = rng.integers(0, 1 << 34, (n3, 64), dtype=np.int64)
    t3_packed = rng.integers(0, 1 << 32, n3 * 32, dtype=np.uint32)
    t3_packed &= 0x3F3F3F3F
    t1 = time.time()
    rows3 = rank._wide_rows(t3_cp, t3_packed)
    del t3_cp, t3_packed
    t2 = time.time()
    tabs = {f: getattr(dfm, f).cpu().numpy()
            for f in ("union", "t3_major", "l2", "c64", "t3_exc_pos",
                      "t3_exc_chr", "comb_pairs", "init_corr", "text_rows",
                      "sa_rows")}
    tabs.update(t3=rows3, sa_samples=dfm.sa_samples[:1].cpu().numpy(),
                init_order=dfm.init_order, sa_intv=dfm.sa_intv,
                direct_ok=dfm.direct_ok, wide=dfm.wide)
    syn = DeviceFMIndex.from_tables(tabs, None, dfm.seq_len, dfm.primary,
                                    device=dev)
    torch.cuda.synchronize()
    t_up = time.time()
    pick = np.concatenate([[0, n3 // 2], np.arange(n3 - 4, n3)])
    if not np.array_equal(syn.t3[torch.from_numpy(pick).to(dev)].cpu()
                          .numpy().view(np.uint32), rows3[pick]):
        raise AssertionError("the uploaded t3 rows differ from the host's")
    words = rows3.size
    del rows3, tabs
    say(f"[3gb] a t3 of {words} words (> 2^32, synthetic): random planes "
        f"{t1 - t0:.1f} s, wide layout {t2 - t1:.1f} s, upload "
        f"{t_up - t2:.1f} s, rows on the card equal the host's")
    occ_rows_check(syn, 0, "synthetic", None)
    del syn
    torch.cuda.empty_cache()


# the first t3 row of a wide table whose words all lie past word 2^32
# (a wide row is T3_ROW_WIDE = 100 words)
FIRST_ROW_PAST_2_32 = -(-(1 << 32) // 100)


def occ_rows_check(dfm, first_row: int, what: str, max_rank) -> None:
    """The occ_rows kernel (WholeTable) against the plain occ_t3, which
    gathers the rows by torch indexing, on 50,000 ranks in the last 4,096
    t3 rows and 50,000 in rows from first_row on, triple and single-char
    classes mixed; ranks above max_rank (the text's rows; None for a
    synthetic table) are clamped to it."""
    import torch
    from gsalign_tpu_torch.ops import rank, seed_cuda
    dev = dfm.device
    n3 = dfm.t3.shape[0]
    n = 50_000
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = torch.cat([
        n3 - 1 - torch.randint(0, 4096, (n,), device=dev, generator=gen),
        torch.randint(first_row, n3, (n,), device=dev, generator=gen)])
    k = rows * 128 + torch.randint(0, 128, (2 * n,), device=dev,
                                   generator=gen)
    if max_rank is not None:
        k = k.clamp(max=max_rank)
    tri = torch.randint(0, 2, (2 * n,), device=dev, generator=gen) == 1
    cls = torch.randint(0, 64, (2 * n,), device=dev, generator=gen)
    cls = torch.where(tri, cls, cls & 3)
    got = seed_cuda.occ_rows(dfm, k, cls, tri.long())
    want = rank.occ_t3(dfm, k, tri, cls)
    err = int((got - want).abs().max())
    if err:
        raise AssertionError(f"occ_rows differs from the plain occ_t3 on "
                             f"the {what} t3's rows past 2^32 words "
                             f"(max abs err {err})")
    say(f"[3gb] occ_rows equal to the plain occ_t3 on the {what} t3 "
        f"({n3} rows x {dfm.t3.shape[1]} words): {2 * n} ranks, {n} in "
        f"the last 4096 rows, {n} in rows >= {first_row} (words >= "
        f"{first_row * dfm.t3.shape[1]})")


# the host memory the build may take at its peak, bytes a text row, held
# from 2^31 rows on, where the process's fixed memory is under 0.3 B a row
# (an H100 host with 96 GiB free holds 6.2 G rows at 14.5, 10 GB to spare)
BUILD_B_PER_ROW = 14.5


# the JAX tool's record of config 5 aligned through a mesh of 8 devices
# with t3 and sa_samples cut into their row blocks (docs/SCALING_3GB.md)
CONFIG5_ENTRIES = 8


def config5_args(total_len: int) -> list:
    """run_3gb's arguments for phase_3gb at total_len: the tool's 8 Mb
    slices; a genome under 160 Mb (a quick rehearsal of the phase) gets
    slices of a twentieth of it."""
    return ["--len", str(total_len), "--slice-len",
            str(min(8_000_000, total_len // 20)), "--device", "cuda"]


def memory_lines(tag: str, res: dict) -> None:
    """run_3gb's memory phases, a line each, in bytes a text row: the
    phase's peak (from the kernel's peak reset phase by phase, or the RSS
    sampled where the reset is refused, up to the layout; the align's is
    its RSS at the end), the resident set at its end, the process's peak
    so far."""
    how = ("reset phase by phase" if res["memory_resets"]
           else "RSS sampled every 20 ms up to the layout")
    say(f"[3gb] {tag}memory, bytes a text row (peaks: {how}):")
    for ph in res["memory"]:
        say(f"[3gb] {tag}memory {ph['phase']:<28} peak "
            f"{ph['peak_b_per_row']:7.3f} ({ph['peak_bytes'] / 1e9:5.1f} GB)"
            f"  resident {ph['rss_b_per_row']:7.3f}  peak so far "
            f"{ph['peak_so_far_b_per_row']:7.3f} "
            f"({ph['peak_so_far_bytes'] / 1e9:5.1f} GB)")


def phase_3gb(total_len: int):
    """BASELINE.json config 5 through gsalign_tpu_torch.tools.run_3gb on
    the card (whole tables): the build, the save, the table layout and the
    three-slice align, kernel counts set to 0 just before the tool and read
    just after it (seed_scan, and resolve_sa on a sampled index, must
    launch; the layout launches none), the host memory of each phase in
    bytes a text row, result.json held against the JAX tool's record at
    CONFIG5_LEN, and on a shorter genome (a rung that the host's memory
    allows) 3 alignments over every query base at ANI > 99, wide past 2^31
    text rows and coordinates past 2^31 past 2^32 rows. Then, on the
    tables the align used: a 200 kb query, the reverse complement of a
    mutated slice at 1 Mb, seeded (its loci lie past 2^32 where 2N >
    2^32), 20 seeds checked against the text; seed_scan and resolve_sa
    against their plain versions on its lanes and ranks; occ_rows against
    the plain occ_t3 on t3 rows past word 2^32: the index's own where its
    t3 holds more than 2^32 words, else a synthetic t3 laid out, uploaded
    and decoded (rows_past_2_32). The result's counts are checked last:
    the log has them before any check can stop the phase."""
    import torch
    from gsalign_tpu_torch.ops import seeding
    from gsalign_tpu_torch.ops.rank import DeviceFMIndex
    from gsalign_tpu_torch.tools import run_3gb
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          check=True, timeout=60).stdout
    say(f"[3gb] host: {os.cpu_count()} cores; free -g:\n{free.rstrip()}")

    zero_counts()
    res, fm = run_3gb.run(run_3gb.parse_args(
        config5_args(total_len) + ["--out", os.path.join(WORK, "3gb")]))
    launches = launch_counts()
    say(f"[3gb] align: kernel launches {launches}")
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          check=True, timeout=60).stdout
    say(f"[3gb] host memory, bytes a text row ({fm.seq_len} rows), the "
        f"peak of each phase and what it left resident; free -g after the "
        f"align:\n{free.rstrip()}")
    memory_lines("", res)
    build = max(ph["peak_so_far_bytes"] for ph in res["memory"]
                if ph["phase"] not in ("save", "layout", "align"))
    build_b = build / fm.seq_len
    say(f"[3gb] the build's peak: {build_b:.3f} B/row ({build / 1e9:.1f} "
        f"GB); the align's spans (s): {json.dumps(res['span_s'])}")
    peak = res["peak_rss_gb"]
    say(f"[3gb] peak RSS {peak:.1f} GB; device tables "
        f"{res['device_table_gib']} GiB; seconds: build "
        f"{res['build_wall_s']} (SA-IS {res['sa_wall_s']}), save "
        f"{res['save_wall_s']}, table layout {res['table_layout_s']}, align "
        f"{res['align_wall_s']} (" + ", ".join(
            f"{k} {res[f'{k}_s']}" for k in run_3gb.STAGES) + ")")
    dfm = DeviceFMIndex.from_host(fm, torch.device("cuda"))
    past = 2 ** 32 if fm.seq_len > 2 ** 32 + 4_000_000 else 2 ** 31
    sl = run_3gb.mutate(fm.genome.codes_fwd[1_000_000:1_200_000],
                        np.random.default_rng(13))
    qry = (3 - sl[::-1]).astype(np.uint8)
    seeding.find_seeds_all(dfm, [qry])                   # warm
    torch.cuda.synchronize()
    t0 = time.time()
    q_pos, r_pos, length = seeding.find_seeds_all(dfm, [qry])[0]
    seed_s = time.time() - t0
    text = fm.genome.codes_fwd_rc()
    for i in np.random.default_rng(1).integers(0, len(q_pos), 20):
        qp, rp, ln = int(q_pos[i]), int(r_pos[i]), int(length[i])
        if not np.array_equal(qry[qp:qp + ln], text[rp:rp + ln]):
            raise AssertionError(f"3gb: seed {i} differs from the text")
    if len(q_pos) <= 100 or (fm.seq_len > past
                             and not (r_pos >= past).any()):
        raise AssertionError(f"3gb: {len(q_pos)} seeds, none past {past}")
    words = dfm.t3.numel()
    say(f"[3gb] 200 kb query: {len(q_pos)} seeds, "
        f"{int((r_pos >= past).sum())} of them at text positions >= "
        f"{past} (largest {int(r_pos.max())}); 20 checked against the "
        f"text; seed stage {seed_s:.3f} s; t3 {dfm.t3.shape[0]} rows x "
        f"{dfm.t3.shape[1]} = {words} words "
        f"({'past' if words > 2 ** 32 else 'below'} 2^32)")
    scan = scan_check("3gb", dfm, [qry])
    rs = None
    if not dfm.direct_ok:
        rs = resolve_check("3gb", dfm, [qry])
        k = hit_ranks_of(dfm, [qry])
        say(f"[3gb] resolve_sa: {int((k >= 2 ** 32).sum())} of "
            f"{k.numel()} ranks >= 2^32 (largest {int(k.max())}); "
            f"{rs['ms']:.4f} ms against plain {rs['plain_ms']:.1f} ms")
    if dfm.wide and words > 2 ** 32:
        occ_rows_check(dfm, FIRST_ROW_PAST_2_32, "index's own",
                       dfm.seq_len + 1)
    elif dfm.wide:
        rows_past_2_32(dfm)
    want = ("seed_scan",) + (() if dfm.direct_ok else ("resolve_sa",))
    missing = [k for k in want if launches[k] <= 0]
    if missing:
        raise AssertionError(f"3gb: {missing} never ran in the align")
    if fm.seq_len >= 2 ** 31 and build_b > BUILD_B_PER_ROW:
        raise AssertionError(f"3gb: the build's peak {build_b:.3f} bytes a "
                             f"text row exceeds {BUILD_B_PER_ROW}")
    if total_len == CONFIG5_LEN:
        got = {k: res[k] for k in JAX_3GB}
        if got != JAX_3GB:
            raise AssertionError(f"3gb: {got} differs from the JAX tool's "
                                 f"record {JAX_3GB}")
        say("[3gb] every count equals the JAX tool's record")
    elif not (res["alignments"] == 3
              and res["aligned_bp"] == res["query_bp"]
              and res["ani_pct"] > 99
              and res["wide"] == (fm.seq_len >= 2 ** 31)
              and (res["int64_coords_seen"] or fm.seq_len < 2 ** 32)):
        raise AssertionError(f"3gb at {total_len} bases: {res}")
    else:
        say(f"[3gb] {total_len} bases (no JAX record at this length): 3 "
            f"alignments over every query base, ANI {res['ani_pct']}, "
            f"max text position {res['max_text_rpos']}")
    t0 = time.time()
    mesh_3gb(fm, dfm, [qry], scan, rs, res)
    say(f"[3gb] the 8-block checks and align: {time.time() - t0:.1f} s")


def block_edge_ranks(dfm, cut) -> "torch.Tensor":
    """Ranks at the edges of every row block of a cut index: the first and
    the last rank of the first and the last t3 row of each t3 block (128
    ranks a row), and the ranks of the first and the last sample of each
    sa_samples block and the rank after each (a walk of one LF step into
    the block), within [0, seq_len]."""
    import torch
    k = []
    t3 = cut.row_shards["t3"]
    for b in range(len(t3.blocks)):
        for r in (b * t3.rows, (b + 1) * t3.rows - 1):
            k += [128 * r, 128 * r + 127]
    sa = cut.row_shards["sa_samples"]
    for b in range(len(sa.blocks)):
        for smp in (b * sa.rows, (b + 1) * sa.rows - 1):
            k += [smp * dfm.sa_intv, smp * dfm.sa_intv + 1]
    return torch.tensor(k, dtype=torch.int64, device=dfm.device).clamp(
        0, dfm.seq_len)


def mesh_3gb(fm, dfm, queries, scan, rs, whole: dict) -> None:
    """Config 5 through the CONFIG5_ENTRIES-entry row-sharded mesh, as the
    JAX tool's record ran it, on the device tables that the whole-table
    align used: t3 and sa_samples cut into CONFIG5_ENTRIES row blocks of
    the one card (parallel/mesh.shard_index_rows: views, but for the
    zero-padded last blocks, which are copies). seed_scan's instance of
    the blocks against the plain scan of the cut tables on the lanes of
    scan_check's round (`scan`); on a sampled index resolve_sa's against
    the plain walk on the query's ranks and on every block's edge ranks
    (block_edge_ranks), the upper blocks' past 2^32 on a 6.2 G-row index;
    both timed beside the whole-table instances in turns, with their bounds
    (rs: resolve_check's). Then run_3gb.align over the mesh: the whole-table
    run's counts (`whole`; at CONFIG5_LEN the JAX record's), mesh_devices
    CONFIG5_ENTRIES, its out.maf and out.vcf bytes, and the sharded
    instances alone launched, counts set to 0 just before it and read just
    after."""
    import torch
    from gsalign_tpu_torch.parallel.mesh import make_mesh, shard_index_rows
    from gsalign_tpu_torch.tools import run_3gb
    dev = dfm.device
    mesh = make_mesh([dev] * CONFIG5_ENTRIES)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    cut = shard_index_rows(dfm, mesh)
    torch.cuda.synchronize()
    copied = torch.cuda.memory_allocated(dev) - before
    for f, sh in cut.row_shards.items():
        base = getattr(dfm, f).untyped_storage().data_ptr()
        views = sum(b.untyped_storage().data_ptr() == base
                    for b in sh.blocks)
        say(f"[3gb] {f} {tuple(getattr(dfm, f).shape)} cut into "
            f"{len(sh.blocks)} blocks of {sh.rows} rows; {views} of them "
            f"views of the whole table")
    say(f"[3gb] the cut: {time.time() - t0:.2f} s, {copied} bytes copied on "
        f"the card (the zero-padded last blocks), beside "
        f"{before / 2 ** 30:.2f} GiB allocated")
    r = sharded_scan_check(dfm, cut, scan[1], scan[2], scan[0])[0]
    say_sharded("seed_scan", CONFIG5_ENTRIES, f"3gb, {len(scan[1][1])} "
                f"lanes of the 200 kb query, launch and read-back", r)
    if rs is not None:
        k = hit_ranks_of(dfm, queries)
        edges = block_edge_ranks(dfm, cut)
        rows = cut.row_shards["sa_samples"].rows * dfm.sa_intv
        upper = [b for b in range(CONFIG5_ENTRIES) if b * rows >= 2 ** 32]
        if dfm.seq_len > 2 ** 32 + 4_000_000 and not upper:
            raise AssertionError("3gb: no sa_samples block starts past 2^32")
        r = sharded_resolve_check(dfm, cut, k, rs, edges=edges)
        say_sharded("resolve_sa", CONFIG5_ENTRIES, f"3gb, {k.numel()} ranks "
                    f"({int((k >= 2 ** 32).sum())} >= 2^32) timed; checked "
                    f"also on {edges.numel()} block-edge ranks "
                    f"({int((edges >= 2 ** 32).sum())} >= 2^32; sa_samples "
                    f"blocks {upper} start past 2^32)", r)
    del cut
    torch.cuda.empty_cache()

    out = os.path.join(WORK, "3gb")
    files = {x: read(os.path.join(out, f"out.{x}")) for x in ("maf", "vcf")}
    records = run_3gb.make_queries(fm.genome, whole["query_bp"] // 3)
    zero_counts()
    res = run_3gb.align(fm, records, dev, CONFIG5_ENTRIES, out)
    launches = launch_counts()
    say(f"[3gb] align over {CONFIG5_ENTRIES} row blocks: {json.dumps(res)}; "
        f"kernel launches {launches}")
    keys = [k for k in JAX_3GB if k not in ("wide", "sa_intv")] \
        + ["query_bp"]
    got = {k: res[k] for k in keys}
    if got != {k: whole[k] for k in keys}:
        raise AssertionError(f"3gb over {CONFIG5_ENTRIES} blocks: {got} "
                             f"differs from the whole-table run's")
    if res["mesh_devices"] != CONFIG5_ENTRIES:
        raise AssertionError(f"3gb: mesh_devices {res['mesh_devices']}")
    want = ("seed_scan_sharded",) + (() if rs is None
                                     else ("resolve_sa_sharded",))
    if any(launches[k] <= 0 for k in want) or launches["seed_scan"] or \
            launches["resolve_sa"]:
        raise AssertionError(f"3gb over {CONFIG5_ENTRIES} blocks: launches "
                             f"{launches}: the sharded instances {want} "
                             f"must run, the whole-table ones not")
    for x, data in files.items():
        if read(os.path.join(out, f"out.{x}")) != data:
            raise AssertionError(f"3gb over {CONFIG5_ENTRIES} blocks: out.{x}"
                                 f" differs from the whole-table run's")
    say(f"[3gb] over {CONFIG5_ENTRIES} row blocks: the whole-table run's "
        f"counts, mesh_devices {res['mesh_devices']}, the same out.maf "
        f"({len(files['maf'])} bytes) and out.vcf ({len(files['vcf'])} "
        f"bytes); align {res['align_wall_s']} s")


def phase_3gb_processes(total_len: int) -> None:
    """phase_3gb in a process of its own (`chip_smoke.py 3gb-build LEN`);
    once it has exited (and its memory with it), the restore as the JAX
    tool's record did it: `python -m gsalign_tpu_torch.tools.run_3gb
    --index … --entries CONFIG5_ENTRIES` in a second process loads the
    saved index, lays it out on the card and aligns through the mesh with
    t3 and sa_samples cut into CONFIG5_ENTRIES row blocks; its counts and
    its out.maf and out.vcf bytes must equal the build run's, and only the
    seed kernels' sharded instances may launch. The earlier artifacts are
    cleared first: the index alone is about 7 bytes a text row of disk."""
    shutil.rmtree(WORK, ignore_errors=True)
    out = os.path.join(WORK, "3gb")
    t0 = time.time()
    subprocess.run([sys.executable, os.path.abspath(__file__), "3gb-build",
                    str(total_len)], check=True, cwd=REPO)
    say(f"[3gb] the build process exited 0 after {time.time() - t0:.1f} s")
    with open(os.path.join(out, "result.json")) as fh:
        built = json.load(fh)
    files = {k: read(os.path.join(out, f"out.{k}")) for k in ("maf", "vcf")}
    idx_bytes = sum(os.path.getsize(os.path.join(out, f))
                    for f in os.listdir(out) if f.startswith("idx"))
    # the same --out, so that the VCF's ##reference line (the output
    # prefix) is the same too: the build's files are held in memory above
    for k in ("maf", "vcf"):
        os.unlink(os.path.join(out, f"out.{k}"))
    t0 = time.time()
    subprocess.run([sys.executable, "-m", "gsalign_tpu_torch.tools.run_3gb"]
                   + config5_args(total_len)
                   + ["--index", os.path.join(out, "idx"), "--out", out,
                      "--entries", str(CONFIG5_ENTRIES)],
                   check=True, cwd=REPO)
    wall = time.time() - t0
    with open(os.path.join(out, "result.json")) as fh:
        again = json.load(fh)
    keys = list(JAX_3GB) + ["query_bp"]
    got = {k: again[k] for k in keys}
    want = {k: built[k] for k in keys}
    peak = max(ph["peak_so_far_bytes"] for ph in again["memory"])
    say(f"[3gb] restore (run_3gb --index --entries {CONFIG5_ENTRIES}, a "
        f"second process): {wall:.1f} s; index {idx_bytes} bytes on disk, "
        f"loaded in {again['load_wall_s']} s, laid out in "
        f"{again['table_layout_s']} s, aligned over "
        f"{again['mesh_devices']} row blocks in {again['align_wall_s']} s "
        f"(spans {json.dumps(again['span_s'])}), peak RSS "
        f"{again['peak_rss_gb']} GB ({peak / (2 * total_len):.3f} B a text "
        f"row); kernel launches {json.dumps(again['kernel_launches'])}; "
        f"counts {json.dumps(got)}")
    memory_lines("restore ", again)
    if got != want:
        raise AssertionError(f"3gb restore: {got} differs from the build "
                             f"run's {want}")
    n = again["kernel_launches"]
    if again["mesh_devices"] != CONFIG5_ENTRIES or \
            n["seed_scan_sharded"] <= 0 or n["seed_scan"] or n["resolve_sa"] \
            or (built["sa_intv"] != 1 and n["resolve_sa_sharded"] <= 0):
        raise AssertionError(f"3gb restore: mesh_devices "
                             f"{again['mesh_devices']}, launches {n}: not "
                             f"the sharded instances over "
                             f"{CONFIG5_ENTRIES} blocks")
    for k, data in files.items():
        if read(os.path.join(out, f"out.{k}")) != data:
            raise AssertionError(f"3gb restore: out.{k} differs from the "
                                 f"build run's")
    say(f"[3gb] the restored index over {CONFIG5_ENTRIES} row blocks gives "
        f"the build run's counts and the same out.maf "
        f"({len(files['maf'])} bytes) and out.vcf ({len(files['vcf'])} "
        f"bytes)")


def phase_sweep():
    """Times the plans the wrappers could pick (rows a lane K, warps a
    block, blocks a cluster) at the widths and batches of phase_kernels and
    at a few problems a launch, in turns within one process; ops must equal
    the default plan's. Prints [sweep] lines; changes nothing."""
    import torch
    from gsalign_tpu_torch.ops import dp_cuda
    from dp_cases import make_batch, max_abs_err
    rng = np.random.default_rng(0)
    small_plan, any_plan = dp_cuda.small_plan, dp_cuda.any_plan

    def run(fn, args, L, tag):
        got = fn(*args, L).cpu().numpy()
        return got, cuda_ms(lambda: fn(*args, L), reps=10), tag
    try:
        for L in SMALL_LS:
            B = min(1024, BATCH_CELLS // (L * L))
            args = [torch.from_numpy(a).cuda() for a in make_batch(rng, L, B)]
            dp_cuda.small_plan = small_plan
            ref = dp_cuda.dp_small(*args, L).cpu().numpy()
            K0 = small_plan(L)[0]
            for K in sorted({K0, 8}):
                for wpb in (1, 2, 3, 4, 6, 8, 16):  # warps (problems) a block
                    if wpb * (L * K * 16 + L) > 227 * 1024:
                        continue
                    dp_cuda.small_plan = lambda L, p=(K, wpb): p
                    got, ms, _ = run(dp_cuda.dp_small, args, L, "")
                    if max_abs_err(got, ref):
                        raise AssertionError(f"dp_small K={K} wpb={wpb}")
                    say(f"[sweep] dp_small L={L} B={B} K={K} wpb={wpb}: "
                        f"{ms:.4f} ms")
        for L, Bs in ((256, (1024,)), (512, (256, 4)), (1024, (64, 2)),
                      (2048, (16, 1)), (3072, (7,)), (5120, (2, 1))):
            for B in Bs:
                args = [torch.from_numpy(a).cuda()
                        for a in make_batch(rng, L, B)]
                dp_cuda.any_plan = any_plan
                ref = dp_cuda.dp_any(*args, L).cpu().numpy()
                say(f"[sweep] dp_any L={L} B={B} default plan "
                    f"{any_plan(B, L, dp_cuda.sm_count(args[0].device))}")
                for K in (2, 4, 8):
                    chain = -(-L // (32 * K))
                    for cs in (1, 2, 4, 8):
                        if B * cs > 1024 or (cs > 1 and chain < 2 * cs):
                            continue
                        wpb = min(dp_cuda.MAX_WARPS, -(-chain // cs))
                        dp_cuda.any_plan = lambda B, L, n_sm, p=(K, wpb, cs): p
                        got, ms, _ = run(dp_cuda.dp_any, args, L, "")
                        if max_abs_err(got, ref):
                            raise AssertionError(f"dp_any {K} {wpb} {cs}")
                        say(f"[sweep] dp_any L={L} B={B} K={K} wpb={wpb} "
                            f"cs={cs}: {ms:.4f} ms")
    finally:
        dp_cuda.small_plan, dp_cuda.any_plan = small_plan, any_plan


# ---- the seed step's cost probes (csrc/probe.cu; tools/exp_seedcost,
# tools/exp_sweep): instruments, off every align path ----

# the bench configurations the seedcost mode reads, and the lanes of each
# one's main-path scan round (a lane a 10 kb chunk; PERF.md §4-5)
SEEDCOST_TAGS = ("ecoli_4.6mb", "celegans_100mb", "human_250mb")
MAIN_LANES = {"ecoli_4.6mb": 460, "yeast_12mb": 1200,
              "celegans_100mb": 10_001, "human_250mb": 25_000}
SEEDCOST_K = 500             # the JAX tool's default K
SEEDCOST_MAX_OUT = 128       # and max_out
SHORT_K = 50                 # the default run's short phase
# integer operations of one lane-iteration of each seedcost body: the look
# update (4); the three query-word reads and the metadata decode (40); the
# two class-row reads and their selects (12); two ranks (RANK_OPS each); the
# 16-word compare, ballot and find-first-set (100); the record (8)
PIECE_OPS = (4, 44, 56, 56 + 2 * RANK_OPS, 156 + 2 * RANK_OPS,
             164 + 2 * RANK_OPS)
SWEEP_OPS = 6                # a gather_sweep step: read, multiply-add, mod
# bytes of a table row each probe reads: a query row (both planes), a
# comb_pairs entry, the tool's 128-word text row
SEEDCOST_ROW_BYTES = {"q_rows": 256, "comb": 8, "t3_major": MAJOR_ROW_BYTES,
                      "text_rows": 512}


def distinct(parts) -> int:
    """Distinct values over a list of index tensors."""
    import torch
    return int(torch.unique(torch.cat([p.reshape(-1) for p in parts]))
               .numel())


def seedcost_plain_work(dfm, q_rows, piece: int, B: int, K: int):
    """(the plain version's result, its ms, the body's bound): each table
    row it reads counted once (SEEDCOST_ROW_BYTES, t3 rows at their width),
    acc, chk and out_n written once, and a record's 9 bytes; PIECE_OPS a
    lane-iteration."""
    from gsalign_tpu_torch.ops import probe
    reads = {}
    out, plain_ms = timed(lambda: probe.seedcost_plain(
        dfm, q_rows, piece, B, K, SEEDCOST_MAX_OUT, reads=reads))
    row_bytes = dict(SEEDCOST_ROW_BYTES, t3=4 * dfm.t3.shape[1])
    n_bytes = sum(distinct(v) * row_bytes[k] for k, v in reads.items())
    n_bytes += 12 * B + 9 * int(out.out_n.clamp(max=SEEDCOST_MAX_OUT).sum())
    return out, plain_ms, bound(n_bytes, PIECE_OPS[piece] * B * K)


def seedcost_equal(what: str, got, want) -> None:
    import torch
    for name in ("acc", "chk", "out_meta", "out_k0", "out_fr", "out_n"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"seedcost {what}: {name} differs from the "
                                 f"plain version")


def seedcost_readings(tag: str, dfm, q_rows, B: int, K: int) -> dict:
    """Every seedcost instance the index allows at B lanes and K
    iterations: its µs an iteration by the tool's measure (best of 3
    launches), its result held against the plain version's on the same
    inputs, and its bound. One [seedcost] line each; returns {piece:
    {us, ms, plain_ms, bound_ms, bound_by}}."""
    from gsalign_tpu_torch.tools import exp_seedcost
    res = exp_seedcost.measure(dfm, q_rows, B, K, SEEDCOST_MAX_OUT,
                               dfm.t3.device)
    out = {}
    for piece, us in res["us"].items():
        if us is None:
            say(f"[seedcost] {tag} B={B} K={K}: {exp_seedcost.label(piece)}"
                f" - (no text rows: the index is not direct)")
            continue
        want, plain_ms, bnd = seedcost_plain_work(dfm, q_rows, piece, B, K)
        seedcost_equal(f"{tag} B={B} piece {piece}", res["outs"][piece], want)
        ms = us * K / 1e3
        out[piece] = {"us": us, "ms": ms, "plain_ms": plain_ms, **bnd}
        say(f"[seedcost] {tag} B={B} K={K}: {exp_seedcost.label(piece)} "
            f"{us:.4f} us/iter (kernel {ms:.4f} ms, "
            f"{100 * bnd['bound_ms'] / ms:.2f} % of its bound "
            f"{bnd['bound_ms']:.5f} ms by {bnd['bound_by']}; plain "
            f"{plain_ms:.1f} ms); equal to plain (acc, chk, planes)")
    return out


def say_occupancy(tag: str, wide: bool) -> dict:
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.ops import probe
    occ = probe.occupancy(wide, AlignConfig().seed_exploration_chunk)
    say(f"[seedcost] {tag} ({'wide' if wide else 'narrow'} rows): registers "
        f"a thread / resident warps an SM: " + ", ".join(
            f"{k} {v['regs']} / {v['warps_per_sm']}" for k, v in occ.items()))
    return occ


def sweep_check(ta, tb, B: int, K: int, n: int, got=None):
    """gather_sweep against the plain version on the same inputs: (plain
    ms, bound): each table word read once, 4 bytes (two tables: 8), the
    start indices read and acc and the last index written."""
    import torch
    from gsalign_tpu_torch.ops import probe
    idx0 = probe.sweep_start(B, n, ta.device)
    if got is None:
        got = probe.gather_sweep(ta, tb, idx0, K, n)
    reads = []
    want, plain_ms = timed(lambda: probe.gather_sweep_plain(
        ta, tb, idx0, K, n, reads=reads))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"gather_sweep B={B} n={n} "
                             f"{'two' if tb is not None else 'one'}: differs "
                             f"from the plain version")
    words = distinct(reads) * (2 if tb is not None else 1)
    return plain_ms, bound(4 * words + 12 * B, SWEEP_OPS * B * K)


def sweep_rows(mbs, dev) -> list:
    """exp_sweep's grid over the table sizes mbs, each point held against
    the plain version at K 20 (K 300 for the 64 MB two-table point, the
    kernels line's), one [sweep] line each."""
    import torch
    from gsalign_tpu_torch.tools import exp_sweep
    rows = []

    def on_row(row, res):
        n = row["mb"] * (1 << 20) // 4
        table = torch.arange(n, dtype=torch.int32, device=dev)
        two = row["form"] == "two-call"
        ta, tb, m = (table[:n // 2], table[n // 2:], n // 2) if two \
            else (table, None, n)
        full = two and row["mb"] == 64
        k = exp_sweep.K if full else 20
        got = (res["acc"], res["idx"]) if full else None
        plain_ms, bnd = sweep_check(ta, tb, row["B"], k, m, got)
        if full:
            row.update(plain_ms=plain_ms, **bnd)
        say(f"[sweep] {exp_sweep.line(row)}; B x K = "
            f"{row['B'] * exp_sweep.K} dependent reads in "
            f"{row['us'] * exp_sweep.K / 1e3:.4f} ms: "
            f"{row['B'] / row['us']:.1f} reads/us; equal to plain at K {k}")
        rows.append(row)
    exp_sweep.sweep(dev, mbs, on_row=on_row)
    return rows


def phase_seedcost(d46: str, d12: str, dev=None) -> dict:
    """Phase 11: the two probes on the 4.6 Mb pair of phase 4 (its index
    idx) and phase 5's forced-wide 12 Mb index, at a short K. Their path,
    the tools' functions (exp_seedcost.measure at B 512, K SHORT_K;
    exp_sweep.sweep over 8 and 64 MB), runs with the counts set to 0 just
    before and read just after; then every seedcost instance (pieces 0-5
    narrow, 0-3 wide) and both gather_sweep forms against their plain
    versions. Returns the kernels line's totals and the path's launches."""
    import torch
    from gsalign_tpu_torch.ops import probe
    from gsalign_tpu_torch.tools import exp_seedcost, exp_sweep
    dev = dev or torch.device("cuda")
    dfm, q_rows = exp_seedcost.tables(d46, dev, "idx")
    say_occupancy("4.6mb", False)
    zero_counts()
    res = exp_seedcost.measure(dfm, q_rows, 512, SHORT_K, SEEDCOST_MAX_OUT,
                               dev)
    sweep = exp_sweep.sweep(dev, (8, 64))
    launches = {k: n for k, n in launch_counts().items()
                if k in ("seedcost", "gather_sweep")}
    say(f"[seedcost] the tools' run: launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a probe kernel did not launch: {launches}")
    per = seedcost_readings("4.6mb", dfm, q_rows, 512, SHORT_K)
    if set(per) != set(range(len(probe.PIECES))):
        raise AssertionError("seedcost: a narrow piece is missing")
    del dfm, q_rows
    dfmw, qw = exp_seedcost.tables(d12, dev, "idxw")
    say_occupancy("12mb wide", True)
    seedcost_readings("12mb wide", dfmw, qw, 512, 20)
    del dfmw, qw
    n = 64 * (1 << 20) // 4
    table = torch.arange(n, dtype=torch.int32, device=dev)
    for two in (False, True):
        m = n // 2 if two else n
        sweep_check(table[:m], table[m:] if two else None, 4096, 20, m)
    two64 = [r for r in sweep if r["mb"] == 64 and r["form"] == "two-call"][0]
    plain_ms, bnd = sweep_check(table[:n // 2], table[n // 2:], 4096,
                                exp_sweep.K, n // 2)
    del table
    say("[sweep] " + "; ".join(exp_sweep.line(r) for r in sweep)
        + "; every form equal to plain")
    top = per[len(probe.PIECES) - 1]
    return {"launches": launches, "totals": {
        "seedcost": {"ms": top["ms"], "plain_ms": top["plain_ms"],
                     "max_abs_err": 0, "bound_ms": top["bound_ms"],
                     "bound_by": top["bound_by"]},
        "gather_sweep": {"ms": two64["us"] * exp_sweep.K / 1e3,
                         "plain_ms": plain_ms, "max_abs_err": 0, **bnd}}}


def parent_seed_lib(parent: str):
    """(nvcc process, library path) of a parent tree's csrc/seed.cu, built
    with this tree's flags into WORK; None without a parent."""
    from gsalign_tpu_torch.ops import cuda_build
    if parent is None:
        return None
    src = os.path.join(parent, "gsalign_tpu_torch", "csrc", "seed.cu")
    if not os.path.exists(src):
        raise RuntimeError(f"no {src}")
    os.makedirs(WORK, exist_ok=True)
    out = os.path.join(WORK, "parent_seed.so")
    return subprocess.Popen([cuda_build._find_nvcc()] + cuda_build._NVCC_FLAGS
                            + ["-o", out, src], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), out


def load_parent_lib(build):
    import ctypes
    from gsalign_tpu_torch.ops import seed_cuda
    proc, path = build
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the parent's seed.cu did not build:\n{err}")
    lib = ctypes.CDLL(path)
    for fn in ("gsalign_seed_scan",):
        getattr(lib, fn).argtypes = seed_cuda.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def scan_turns(tag: str, dfm, queries, libs: dict, reps: int = 5) -> None:
    """seed_scan on the first round's lanes through each library of libs
    ({"C": this tree's, "P": the parent's}) in turns P, C, C, P, P, C, C,
    P, each turn `reps` launches with their read-back on fresh lanes; every
    result equal to the plain scan's. One [scan-times] line: the change is
    within the parent's spread where the two trees' mean turns differ by
    no more than the parent's slowest and fastest turns do."""
    import ctypes
    import torch
    from gsalign_tpu_torch.ops import cuda_build, seed_cuda, seeding
    args = first_round(dfm, queries)
    q_rows, _, _, prm = args
    ref = fresh_lanes(args)
    ref_st = seeding.seed_scan_plain(dfm, q_rows, ref, prm)

    def scan(lib, lanes):
        win = seed_cuda._win_words(lanes.max_len)
        a = seed_cuda._seed_args(dfm, q_rows, lanes, prm, win_words=win,
                                 step_cap=seed_cuda._step_cap(lanes.max_emit,
                                                              lanes.max_len))
        cuda_build.raise_on(lib.gsalign_seed_scan(
            ctypes.byref(a), cuda_build.stream(q_rows.device)), "seed_scan")
        return seed_cuda.scan_result(lanes, a.step_cap)
    times = {"P": [], "C": []}
    for key in ("P", "C", "C", "P") * 2:
        batch = [fresh_lanes(args) for _ in range(reps)]
        ms = []
        for lanes in batch:
            st, t = timed(lambda: scan(libs[key], lanes))
            ms.append(t)
            if not (np.array_equal(st, ref_st)
                    and torch.equal(lanes.out, ref.out)):
                raise AssertionError(f"seed_scan {tag} ({key}): differs from "
                                     f"the plain scan")
        times[key].append(sum(ms) / reps)
    p, c = times["P"], times["C"]
    spread = max(p) - min(p)
    change = sum(c) / len(c) - sum(p) / len(p)
    say(f"[scan-times] seed_scan {tag}, {len(args[1])} lanes, {reps} "
        f"launches a turn with their read-back, turns P, C, C, P, P, C, C, "
        f"P: parent {', '.join(f'{t:.4f}' for t in p)} ms, this tree "
        f"{', '.join(f'{t:.4f}' for t in c)} ms; the change {change:+.4f} "
        f"ms beside the parent's spread {spread:.4f} ms: "
        f"{'within' if abs(change) <= spread else 'outside'}; equal to "
        f"plain")


def sass_compare(parent_path: str) -> None:
    """The machine code (cuobjdump -sass) of every kernel in the parent's
    seed library against this tree's, function by function (by name, less
    the anonymous namespace's per-build tag): one [scan-times] line saying
    which are identical."""
    from gsalign_tpu_torch.ops import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build._find_nvcc()), "cuobjdump")

    def functions(path):
        text = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        out, name = {}, None
        for ln in text.splitlines():
            if "Function : " in ln:
                name = re.sub(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_seed_cu_"
                              r"[0-9a-f]{8}", "ANON",
                              ln.split("Function : ")[1].strip())
                out[name] = []
            elif name is not None and ln.strip():
                out[name].append(ln.strip())
        return out
    old = functions(parent_path)
    new = functions(cuda_build.build_info["seed"]["path"])
    same = sorted(f for f in old if new.get(f) == old[f])
    differ = sorted(f for f in old if f in new and new[f] != old[f])
    say(f"[scan-times] seed.cu machine code, parent against this tree: "
        f"{len(same)} of {len(old)} kernels identical, {len(differ)} differ "
        f"({', '.join(differ) or 'none'}), {len(set(new) - set(old))} new "
        f"({', '.join(sorted(set(new) - set(old))) or 'none'})")


def phase_seedcost_full(build) -> None:
    """The seedcost mode (module docstring), after phase 1."""
    import torch
    from gsalign_tpu_torch.ops import seed_cuda, seeding
    from gsalign_tpu_torch.tools import exp_seedcost, exp_sweep
    dev = torch.device("cuda")
    preps = {tag: start_pair(tag) for tag in SEEDCOST_TAGS}
    try:
        libs = {"C": seed_cuda.build()}
        if build is not None:
            libs["P"] = load_parent_lib(build)
            sass_compare(build[1])
        d12 = make_data("12mb", 12_000_000)
        sampled_indexes(d12)
        dfmw, qw = exp_seedcost.tables(d12, dev, "idxw")
        say_occupancy("12mb wide", True)
        for B in (512, MAIN_LANES["yeast_12mb"]):
            seedcost_readings("12mb wide", dfmw, qw, B, SEEDCOST_K)
        del dfmw, qw
        if "P" in libs:
            dfm8, q8 = load_case("12mb", "idx8")
            scan_turns("12mb-sa8", dfm8, q8, libs)
            del dfm8
        for tag in SEEDCOST_TAGS:
            proc, started = preps[tag]
            if proc.wait(timeout=1500) != 0:
                raise RuntimeError(f"{tag}: making the pair and index "
                                   f"exited {proc.returncode}")
            say(f"[seedcost] {tag}: pair and index ready "
                f"{time.time() - started:.1f} s after their process started")
            dfm, queries = load_case(tag, "ref_idx")
            q_rows = seeding.build_qrows(torch.from_numpy(
                np.concatenate(queries)).to(dev))
            say(f"[seedcost] {tag}: tables comb "
                f"{dfm.comb_pairs.numel() * 8 / 1e6:.1f} MB, t3 "
                f"{dfm.t3.numel() * 4 / 1e6:.1f} MB, q_rows "
                f"{q_rows.numel() * 4 / 1e6:.1f} MB, text "
                f"{dfm.text_rows.numel() * 4 / 1e6:.1f} MB")
            if tag == SEEDCOST_TAGS[0]:
                say_occupancy(tag, False)
            for B in (512, MAIN_LANES[tag]):
                seedcost_readings(tag, dfm, q_rows, B, SEEDCOST_K)
            if tag == "celegans_100mb" and "P" in libs:
                scan_turns(tag, dfm, queries, libs)
            del dfm, q_rows, queries
            torch.cuda.empty_cache()
        sweep_rows(exp_sweep.GRID_MB, dev)
    finally:
        stop(p for p, _ in preps.values())


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
    if sys.argv[1:] in (["dp"], ["dp-sweep"]):
        # the DP kernels alone (seconds): build, kernel against plain,
        # oracle; with dp-sweep also the plans' times. No result lines.
        phase_card()
        phase_kernels()
        phase_oracle()
        if sys.argv[1] == "dp-sweep":
            phase_sweep()
        return 0
    if sys.argv[1:] == ["wide-big"]:
        # a genome with 2N > 2^31 on its wide index: tens of GB of host
        # memory and minutes of build. No result lines.
        try:
            phase_card()
            phase_wide_big()
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        return 0
    if sys.argv[1:2] == ["3gb"] and len(sys.argv) <= 3:
        # BASELINE.json config 5 (or a shorter genome, LEN bases): about
        # 13.3 bytes of host memory a text row (PERF.md) and 20-25 minutes
        # at full scale. No result lines.
        try:
            phase_card()
            phase_3gb_processes(int(sys.argv[2]) if len(sys.argv) == 3
                                else CONFIG5_LEN)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        return 0
    if sys.argv[1:2] == ["3gb-build"] and len(sys.argv) == 3:
        # phase_3gb alone, in the process phase_3gb_processes starts; it
        # leaves its index and outputs in _smoke/3gb for the restore
        phase_3gb(int(sys.argv[2]))
        return 0
    if sys.argv[1:] == ["tools"]:
        # the tools phase alone (about a minute). No result lines.
        try:
            phase_card()
            d = make_data("4.6mb", 4_600_000)
            phase_tools(d)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        return 0
    if sys.argv[1:] == ["probes"]:
        # the probes phase at 100 and 250 Mb, both pairs and indexes made
        # beside it from the start (about 10 min). No result lines.
        preps = {}
        try:
            phase_card()
            preps = {tag: start_pair(tag) for tag in PROBE_TAGS}
            for tag in PROBE_TAGS:
                t0 = time.time()
                phase_probes(tag, preps[tag])
                say(f"[phase] phase_probes {tag} {time.time() - t0:.1f} s")
        finally:
            stop(p for p, _ in preps.values())
            shutil.rmtree(WORK, ignore_errors=True)
        return 0
    if sys.argv[1:] == ["shard-times"]:
        # the row-sharded instances timed beside the whole-table ones at
        # 4, 8 and 16 blocks (about a minute). No result lines.
        try:
            phase_card()
            phase_shard_times()
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        return 0
    if sys.argv[1:2] == ["seedcost"] and len(sys.argv) <= 3:
        # the probes at 4.6, 12 (wide), 100 and 250 Mb and the sweep grid;
        # with a parent tree, seed_scan in it and here in turns. No result
        # lines.
        parent = sys.argv[2] if len(sys.argv) == 3 else None
        build = None
        try:
            build = parent_seed_lib(parent)
            phase_card()
            phase_seedcost_full(build)
        finally:
            if build is not None and build[0].poll() is None:
                build[0].kill()
                build[0].wait()
            shutil.rmtree(WORK, ignore_errors=True)
        return 0
    if sys.argv[1:] == ["layout"]:
        # the INIT-10 rows alone (about a minute). No result lines.
        phase_card()
        phase_layout()
        return 0
    if sys.argv[1:] in (["seed"], ["segments"]):
        # the seed-stage kernels alone, or the segments phase alone: build,
        # the 4.6 Mb and 12 Mb data and indexes, kernel against plain. No
        # result lines.
        try:
            card = phase_card()
            for tag, n in (("4.6mb", 4_600_000), ("12mb", 12_000_000)):
                run_cli("index", f"{make_data(tag, n)}/ref.fa",
                        f"{WORK}/{tag}/idx")
            sampled_indexes(f"{WORK}/12mb")
            if sys.argv[1] == "seed":
                phase_seed_kernels()
            else:
                phase_segments(card)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        return 0
    def phase(fn, *args):
        t0 = time.time()
        out = fn(*args)
        say(f"[phase] {fn.__name__} {time.time() - t0:.1f} s")
        return out
    prep = None
    try:
        card = phase(phase_card)
        # the probes phase's pair and index, made beside the phases before it
        prep = start_pair(PROBE_TAGS[0])
        totals = phase(phase_kernels)
        phase(phase_oracle)
        phase(phase_entry)
        phase(phase_100kb)
        runs = phase(phase_46mb)
        walls = phase(phase_restartable)
        runs.update(phase(phase_12mb))
        sa = phase(phase_suffix_array)
        totals.update(phase(phase_seed_kernels))
        phase(phase_segments, card)
        mesh = phase(phase_mesh, card, runs)
        totals.update(mesh["kernels"])
        phase(phase_profile)
        tools = phase(phase_tools, os.path.join(WORK, "4.6mb"))
        probes = phase(phase_probes, PROBE_TAGS[0], prep)
        costs = phase(phase_seedcost, os.path.join(WORK, "4.6mb"),
                      os.path.join(WORK, "12mb"))
        totals.update(costs["totals"])
        totals.update(phase(phase_layout))
    finally:
        if prep is not None:
            stop([prep[0]])
        shutil.rmtree(WORK, ignore_errors=True)
    main_path = runs["4.6mb"]["launches"]
    for errs in (runs["4.6mb"]["dp_errs"], probes["errs"]):
        for name, err in errs.items():
            totals[name]["max_abs_err"] = max(totals[name]["max_abs_err"],
                                              err)
    say("[summary] " + "; ".join(
        f"{tag}: wall {r['wall']:.2f} s, seed {r['seed_s']:.2f} s, "
        f"iterations {r['iterations']}" for tag, r in runs.items()))
    say("[summary] mesh: " + "; ".join(
        f"{tag}: wall {r['wall']:.2f} s, scan launches {r['scan_launches']}"
        for tag, r in mesh["runs"].items()) + f" ({card})")
    say("[summary] tools: " + "; ".join(
        f"{tag}: wall {r['wall']:.2f} s" for tag, r in tools.items())
        + f" ({card})")
    say(f"[summary] probes at {PROBE_TAGS[0]}: " + "; ".join(
        f"{tool}: wall {w:.2f} s" for tool, w in probes["walls"].items())
        + f" ({card})")
    say("[summary] 4.6 Mb walls: " + ", ".join(
        f"{tag} {w:.2f} s" for tag, w in walls.items())
        + f"; suffix array at 12 Mb: torch on the card {sa['torch_s']:.3f} "
        f"s, native SA-IS {sa['native_s']:.3f} s")

    def entry(name, source, replaces, launches, **more):
        # no single PyTorch call computes any of these functions
        return {"name": name, "route": "cuda",
                "source": f"gsalign_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, **totals[name],
                "library_ms": None, **more}
    pallas = runs["4.6mb-pallas"]
    kernels = [
        entry("dp_small", "dp.cu", "gsalign_tpu/ops/dp_pallas.py:80",
              main_path["dp_small"]),
        entry("dp_any", "dp.cu", "gsalign_tpu/ops/dp_pallas.py:457",
              main_path["dp_any"]),
        # the masked gather runs inside seed_lockstep (gather_dev.cuh): its
        # launches on the pallas path are that kernel's; the stand-alone
        # kernel, which the times here are of, is launched by the
        # comparisons only
        entry("masked_gather", "gather.cu",
              "gsalign_tpu/ops/gather_pallas.py:34",
              pallas["launches"]["seed_lockstep"],
              fused_into="seed_lockstep",
              words_gathered=pallas["gathered"],
              standalone_launches=pallas["launches"]["masked_gather"]),
        entry("seed_scan", "seed.cu", "gsalign_tpu/ops/seeding.py:150",
              main_path["seed_scan"]),
        # the loop body's kernel is seed_lockstep, counted by its own
        # wrapper (seed_step is that kernel for one iteration)
        entry("seed_step", "seed.cu", "gsalign_tpu/ops/seeding.py:221",
              pallas["launches"]["seed_lockstep"], kernel="seed_lockstep",
              lanes_stalled=pallas["stalled"]),
        # the slice's main path for resolve_sa: the forced-wide 12 Mb run
        entry("resolve_sa", "seed.cu", "gsalign_tpu/ops/rank.py:625",
              runs["12mb-wide"]["launches"]["resolve_sa"]),
        # the row-sharded instances (t3 and sa_samples read by blocks, the
        # JAX package's masked gather and psum at rank.py:468 and :485),
        # with their launches on the mesh phase's row-sharded runs
        entry("seed_scan_sharded", "seed.cu", "gsalign_tpu/ops/seeding.py:644",
              mesh["runs"]["12mb-sa8-rows"]["launches"]["seed_scan_sharded"],
              kernel="seed_scan"),
        entry("seed_lockstep_sharded", "seed.cu",
              "gsalign_tpu/ops/seeding.py:644",
              mesh["runs"]["4.6mb-rows-pallas"]["launches"][
                  "seed_lockstep_sharded"], kernel="seed_lockstep"),
        entry("resolve_sa_sharded", "seed.cu",
              "gsalign_tpu/ops/seeding.py:674",
              mesh["runs"]["12mb-wide-rows"]["launches"][
                  "resolve_sa_sharded"], kernel="resolve_sa"),
        # the probes (phase 11): their launches in the tools' run, their
        # times of piece 5 at 4.6 Mb (B 512, K SHORT_K) and of the 64 MB
        # two-table sweep (B 4096, K 300)
        entry("seedcost", "probe.cu", "tools/exp_seedcost.py:66",
              costs["launches"]["seedcost"], piece=5, B=512, K=SHORT_K),
        entry("gather_sweep", "probe.cu", "tools/exp_sweep.py:43",
              costs["launches"]["gather_sweep"], table_mb=64, tables=2,
              B=4096, K=300),
        # no TPU kernel: the JAX package builds these rows in host numpy
        # (gsalign_tpu/ops/rank.py:317 _build_c10); its launches on the
        # 4.6 Mb main path, its times at the synth_ecoli shape (phase 12)
        entry("init10_rows", "layout.cu", None, main_path["init10_rows"],
              host_numpy="gsalign_tpu/ops/rank.py:317"),
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
