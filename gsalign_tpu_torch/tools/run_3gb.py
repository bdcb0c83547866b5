"""Run BASELINE.json configuration 5 (3 Gb, the GRCh38-vs-CHM13 regime)
through the port: build the ~6.2 G-row wide index on the host, lay its
tables out on the device and align three query slices.

    python -m gsalign_tpu_torch.tools.run_3gb [--len 3100000000] [--out DIR]
        [--slice-len 8000000] [--device cuda|cpu] [--entries N]
        [--index PREFIX]

The data are the JAX package's tools/run_3gb.py data, so that the counts
can be held against its record (docs/SCALING_3GB.md): default_rng(2026)'s
uniform bases over two chromosomes (3/5 and 2/5 of --len), and
default_rng(7)'s three query slices of --slice-len bases, a mutated forward
slice of each chromosome and a mutated reverse-complemented slice of the
first, whose locus lies past 2^31 in the index text at full scale.

The index is built with build_fmindex(prefer_device=False) (native SA-IS),
the suffix array timed inside the build so that the build still frees it
early, and saved to {out}/idx; --index PREFIX loads an index that an
earlier run saved instead. --device cuda (the default) raises without a
card. The tables are laid out on the device once; then the host's rank
planes are freed. With --entries 1 (the default on the card) the tables
are whole: compare_genomes on the device, the main path. With --entries
N > 1 (8 by default on the CPU, the JAX tool's 8 virtual devices) the
index's t3 and sa_samples rows are cut over a mesh of N entries of the one
device (compare_genomes(mesh=, shard_index_rows=True)).

Writes {out}/result.json, the JAX tool's keys with the same meanings plus
device, table_layout_s, device_table_gib, the stage seconds (seed_s,
chain_s, align_s, output_s, variants_s), the align's spans (span_s:
compare_genomes' timeline, the time outside the stages included), the seed
kernels' launches during the align (kernel_launches) and the
host memory phase by phase (memory: peak and current resident bytes and
their bytes a text row, SA-IS's levels included), and {out}/out.maf,
{out}/out.vcf. The build needs about 12.5 bytes of host memory a text row
at its peak (the suffix array, the text and what is taken from them in
one pass; PERF.md), about 78 GB at the full 6.2 G rows.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import tempfile
import time
import numpy as np

from gsalign_tpu_torch.tools.common import card_name
from gsalign_tpu_torch.utils import trace

DNA = np.frombuffer(b"ACGT", dtype=np.uint8)
STAGES = ("seed", "chain", "align", "output", "variants")


def say(msg: str) -> None:
    print(f"[3gb] {msg}", flush=True)


def make_genome(total_len: int):
    """The two-chromosome random genome (3/5 and 2/5 of total_len), so
    that multi-chromosome coordinates are exercised at int64 scale (the RC
    half of chr2 lies wholly past 2^31 at full scale)."""
    from gsalign_tpu_torch.genome.packing import Genome
    l1 = total_len * 3 // 5
    l2 = total_len - l1
    codes = np.random.default_rng(2026).integers(0, 4, total_len,
                                                 dtype=np.uint8)
    return Genome(names=["big1", "big2"],
                  lengths=np.asarray([l1, l2], dtype=np.int64),
                  offsets=np.asarray([0, l1], dtype=np.int64),
                  holes=[], codes_fwd=codes)


def mutate(sl: np.ndarray, rng, rate: float = 0.005) -> np.ndarray:
    """sl with a `rate` share of its bases substituted."""
    out = sl.copy()
    subs = rng.random(len(out)) < rate
    out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
    return out.astype(np.uint8)


def make_queries(genome, slice_len: int) -> list:
    """[(name, ASCII bases)]: mutated forward slices of both chromosomes
    and a reverse-complemented mutated slice of the first, whose blocks
    carry text positions 2N - l1/4 - slice_len."""
    codes = genome.codes_fwd
    l1, l2 = (int(x) for x in genome.lengths)
    qrng = np.random.default_rng(7)
    s1, s2, s_rc = l1 // 3, l1 + l2 // 2, l1 // 4
    sl_rc = mutate(codes[s_rc:s_rc + slice_len], qrng)
    return [
        ("q_chr1_fwd", DNA[mutate(codes[s1:s1 + slice_len], qrng)]),
        ("q_chr2_fwd", DNA[mutate(codes[s2:s2 + slice_len], qrng)]),
        ("q_chr1_rc", DNA[(3 - sl_rc[::-1]).astype(np.uint8)]),
    ]


class Memory:
    """The host memory of the run, phase by phase (utils/trace.PhasePeaks):
    mark(name) records, in bytes and in bytes a text row, the peak of the
    phase that ends there, the resident set at its end, and the process's
    peak so far. After the "sa" phase come SA-IS's levels, from its own
    milestones (native_lib.sais_marks): the largest resident set at a
    level's milestones and the peak so far at its last."""

    def __init__(self, rows: int):
        self.rows = rows
        self.peaks = trace.PhasePeaks()
        self.phases = []

    def add(self, name: str, peak: int, rss: int, so_far: int) -> None:
        self.phases.append({
            "phase": name, "peak_bytes": peak, "rss_bytes": rss,
            "peak_so_far_bytes": so_far,
            "peak_b_per_row": round(peak / self.rows, 3),
            "rss_b_per_row": round(rss / self.rows, 3),
            "peak_so_far_b_per_row": round(so_far / self.rows, 3)})

    def mark(self, name: str) -> None:
        first = len(self.phases)
        m = self.peaks.mark(name)
        self.add(name, m["peak_rss"], m["rss"], m["peak_so_far"])
        if name == "sa":
            from gsalign_tpu_torch import native_lib
            levels = {}
            for k in native_lib.sais_marks():
                lv = levels.setdefault(k["depth"], [0, 0, 0, k["n"]])
                lv[0] = max(lv[0], k["rss"])
                lv[1] = k["rss"]
                lv[2] = max(lv[2], k["peak_rss"])
            for d, (peak, rss, so_far, n) in sorted(levels.items()):
                self.add(f"sais-depth{d} (n={n})", peak, rss, so_far)
        for p in self.phases[first:]:
            say(f"memory {p['phase']}: peak {p['peak_b_per_row']} B/row "
                f"({p['peak_bytes'] / 1e9:.1f} GB), now "
                f"{p['rss_b_per_row']} B/row, peak so far "
                f"{p['peak_so_far_b_per_row']} B/row")

    def peak_gb(self) -> float:
        """The largest peak so far, of the phases marked and the one now
        running, in GB."""
        return round(self.peaks.peak / 1e9, 1)


def build_index(genome, result: dict, mem: Memory):
    """build_fmindex(prefer_device=False) with the suffix array timed
    inside it (a reference to the suffix array held here would keep the
    build from freeing it before the t3 tables are made), and the memory
    of each of its phases in mem."""
    from gsalign_tpu_torch.index import fmindex as fmindex_mod
    orig = fmindex_mod.build_suffix_array

    def timed_sa(codes, prefer_device=True, wide=False):
        t = time.time()
        sa = orig(codes, prefer_device=False, wide=wide)
        result["sa_wall_s"] = round(time.time() - t, 1)
        say(f"SA-IS over {len(codes)} rows: {result['sa_wall_s']} s")
        return sa

    fmindex_mod.build_suffix_array = timed_sa
    t0 = time.time()
    try:
        fm = fmindex_mod.build_fmindex(genome, prefer_device=False,
                                       on_phase=mem.mark)
    finally:
        fmindex_mod.build_suffix_array = orig
    result["build_wall_s"] = round(time.time() - t0, 1)
    result["build_rss_gb"] = mem.peak_gb()
    return fm


def lay_out_tables(fm, device, result: dict, mem: Memory) -> None:
    """The device tables (kept on fm for compare_genomes), their layout
    seconds and bytes; then the host planes they were made from are freed.
    Nothing the port keeps refers to those planes afterwards: the table
    cache holds device tensors (uploaded copies, also on the CPU), and the
    host_sa of a direct index keeps its own reference to sa_samples."""
    import torch
    from gsalign_tpu_torch.ops.rank import DeviceFMIndex
    t0 = time.time()
    dfm = DeviceFMIndex.from_host(fm, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    result["table_layout_s"] = round(time.time() - t0, 1)
    n_bytes = sum(v.numel() * v.element_size() for v in vars(dfm).values()
                  if isinstance(v, torch.Tensor))
    result["device_table_gib"] = round(n_bytes / 2 ** 30, 2)
    mem.mark("layout")
    fm.t3_cp = fm.t3_packed = fm.occ_cp = fm.bwt_packed = None
    fm.sa_samples = fm.c8 = fm.c12 = None
    gc.collect()
    say(f"tables on {device} in {result['table_layout_s']} s: "
        f"{result['device_table_gib']} GiB; host rank planes freed")


# the seed kernels' launch counters that align() reports (kernel_launches):
# each wrapper's whole-table and row-sharded (ShardedTable) instances
LAUNCH_COUNTERS = {"seed_scan": ("seed_scan", "launches"),
                   "seed_scan_sharded": ("seed_scan", "sharded_launches"),
                   "resolve_sa": ("resolve_sa", "launches"),
                   "resolve_sa_sharded": ("resolve_sa", "sharded_launches")}


def align(fm, records, device, entries: int, out: str) -> dict:
    """compare_genomes of `records` into {out}/out.maf and {out}/out.vcf:
    on whole tables (entries 1), or with the index's t3 and sa_samples rows
    cut over a mesh of `entries` entries of `device`
    (compare_genomes(mesh=, shard_index_rows=True)). Returns the align's
    result.json keys: mesh_devices, align_wall_s, query_bp, the counts,
    span_s and the stage seconds, max_text_rpos, int64_coords_seen, and
    kernel_launches, each seed kernel instance's launches during the align
    (on the CPU the wrappers run their plain versions and count none)."""
    import torch
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.ops import seed_cuda
    from gsalign_tpu_torch.parallel.mesh import make_mesh
    from gsalign_tpu_torch.pipeline.align import compare_genomes

    def launches():
        return {name: getattr(getattr(seed_cuda, fn), field)
                for name, (fn, field) in LAUNCH_COUNTERS.items()}
    mesh = make_mesh([device] * entries) if entries > 1 else None
    before = launches()
    t0 = time.time()
    stats, collector, results = compare_genomes(
        fm, records, AlignConfig(), output_prefix=os.path.join(out, "out"),
        verbose=True, device=device, mesh=mesh,
        shard_index_rows=mesh is not None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    res = {
        "mesh_devices": entries,
        "align_wall_s": round(time.time() - t0, 1),
        "query_bp": sum(len(q) for _, q in records),
        "ani_pct": round(stats.ani, 2),
        "alignments": stats.local_alignment_num,
        "aligned_bp": stats.total_alignment_length,
        "snv": collector.n_snv, "ins": collector.n_ins,
        "dele": collector.n_del,
        "kernel_launches": {k: v - before[k]
                            for k, v in launches().items()},
    }
    res["span_s"] = {k: round(v, 3) for k, v in stats.span_times.items()}
    for k in STAGES:
        res[f"{k}_s"] = round(stats.stage_times.get(k, 0.0), 3)
    # int64-coordinate evidence: the end of the last pair of a block on
    # the RC strand lies past 2^31 at full scale
    max_rpos = 0
    for r in results:
        for blk in r.blocks:
            if blk.n:
                max_rpos = max(max_rpos, int(blk.r_pos[-1] + blk.r_len[-1]))
    res["max_text_rpos"] = max_rpos
    res["int64_coords_seen"] = bool(max_rpos >= (1 << 31))
    return res


def run(args):
    """The tool on parsed arguments; returns (result.json's contents, the
    FMIndex, whose device tables DeviceFMIndex.from_host(fm, device) still
    returns)."""
    from gsalign_tpu_torch.index.io import load_index, save_index
    from gsalign_tpu_torch.utils.device import resolve_device

    device = resolve_device(None if args.device == "cuda" else args.device)
    entries = args.entries or (1 if device.type == "cuda" else 8)
    os.makedirs(args.out, exist_ok=True)
    result = {"total_len": args.total_len, "device": card_name(device)}
    l1 = args.total_len * 3 // 5
    mem = Memory(2 * args.total_len)
    if args.index:
        t0 = time.time()
        fm = load_index(args.index)
        result["index"] = args.index
        result["load_wall_s"] = round(time.time() - t0, 1)
        mem.mark("load")
        g = fm.genome
        if g.names != ["big1", "big2"] or g.lengths.tolist() != [
                l1, args.total_len - l1]:
            raise ValueError(f"{args.index} is not this tool's index at "
                             f"--len {args.total_len}")
        say(f"index loaded from {args.index}: {result['load_wall_s']} s")
    else:
        say(f"generating {args.total_len} bp over 2 chromosomes "
            f"({l1} + {args.total_len - l1})")
        g = make_genome(args.total_len)
        fm = build_index(g, result, mem)
    result["wide"] = bool(fm.rank_dtype == np.int64)
    result["sa_intv"] = int(fm.sa_intv)
    if fm.seq_len != 2 * args.total_len:
        raise AssertionError(f"index of {fm.seq_len} text rows for "
                             f"{args.total_len} bases")
    if fm.seq_len > (1 << 31) and not result["wide"]:
        raise AssertionError("an index of more than 2^31 rows is not wide")
    if not args.index:
        say(f"index built: {result['build_wall_s']} s, wide="
            f"{result['wide']}, sa_intv={fm.sa_intv}, peak RSS "
            f"{result['build_rss_gb']} GB")
        # insurance: a failure past here never costs the build again
        t0 = time.time()
        save_index(fm, os.path.join(args.out, "idx"))
        result["save_wall_s"] = round(time.time() - t0, 1)
        mem.mark("save")
        say(f"index saved to {args.out}/idx ({result['save_wall_s']} s)")
    records = make_queries(g, args.slice_len)

    lay_out_tables(fm, device, result, mem)
    # the build's and the layout's peaks are read; a sampling thread
    # would take the interpreter lock during the timed align
    mem.peaks.stop()
    result.update(align(fm, records, device, entries, args.out))
    mem.mark("align")
    result["peak_rss_gb"] = mem.peak_gb()
    result["memory"] = mem.phases
    result["memory_resets"] = mem.peaks.resets
    with open(os.path.join(args.out, "result.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    say(json.dumps(result))
    return result, fm


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m gsalign_tpu_torch.tools.run_3gb",
        description="Build and align BASELINE.json configuration 5 (3 Gb) "
                    "on the port.")
    ap.add_argument("--len", type=int, default=3_100_000_000,
                    dest="total_len", help="genome bases (default 3.1 G)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "run3gb_torch"))
    ap.add_argument("--slice-len", type=int, default=8_000_000,
                    help="bases of each of the three query slices")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--entries", type=int, default=None,
                    help="mesh entries over which t3 and sa_samples rows "
                         "are cut (default 1 on the card, 8 on the CPU)")
    ap.add_argument("--index", default=None, metavar="PREFIX",
                    help="load this saved index instead of building one")
    args = ap.parse_args(argv)
    if args.entries is not None and args.entries < 1:
        ap.error("--entries must be at least 1")
    return args


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
