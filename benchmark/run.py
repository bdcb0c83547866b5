"""The benchmark of the PyTorch and CUDA port (gsalign_tpu_torch) on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell of BENCHMARK.json names a configuration (benchmark/configs/<name>.json:
a deployment's reference genome, its mutation model and the aligner's
settings) and a traffic mix (benchmark/traffic/<name>.json: how the pairs
reach the aligner). The run:

1. set-up: makes the reference genome from the configuration's seed, loads
   its index (built and saved into benchmark/.cache on a checkout's first
   run), makes a pool of query genomes from --seed, lays out the device
   tables where the mix keeps the index resident, and aligns one warm-up
   pair;
2. window: a closed loop, one user sending the next pair when the last has
   completed, the queries cycled from the pool, until the last pair that
   started before --seconds has completed. Every pair runs the program's
   MAF and VCF writers in full into links to the null device, except the
   judged pairs (drawn from --seed), whose writers run into links to
   in-memory files of this process; nothing is written to disk;
3. --trace 1 runs the window under torch.profiler and reports the
   per-layer metrics (benchmark/metrics/<name>.py, one reader a metric),
   --trace 0 the end-to-end ones;
4. after the window, with the program's state freed, the plain reference
   (reference.py) checks the judged pairs' MAF, VCF and seeds.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), then "checks": each
number compared with its limit. The run exits 1 without a CUDA card, or
with fewer cards than the cell asks for, and 1 if a module named jax, jaxlib,
flax or gsalign_tpu is loaded once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import bisect  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "gsalign_tpu")
PAIR_MARK = "bench.pair"    # the profiler range around each timed pair

if HERE not in sys.path:
    sys.path.insert(0, HERE)


def fail(msg: str):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    keep libraries from loading JAX."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("GSALIGN_TRACE", None)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Spec:
    """The cell's entries of BENCHMARK.json, with its configuration and
    traffic files and the metrics it reports."""

    def __init__(self, workload: str, root: str = ROOT,
                 traffic_dir: str = os.path.join(HERE, "traffic")):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(root, configs[
            self.cell["config"]]["file"]))
        self.traffic = load_json(os.path.join(
            traffic_dir, self.cell["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m["workloads"]]


def metric_reader(name: str,
                  metrics_dir: str = os.path.join(HERE, "metrics")):
    """The read(ctx) function of benchmark/metrics/<name>.py."""
    path = os.path.join(metrics_dir, name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Capture:
    """What the program writes to one path, kept in memory: the path is a
    link to an anonymous in-memory file of this process (memfd), which the
    program's writers, opening the path once per write, fill at memory
    speed, with no reader to wait for and nothing written to disk."""

    def __init__(self, path: str):
        self.fd = os.memfd_create(os.path.basename(path))
        self.path = path
        os.symlink(f"/proc/self/fd/{self.fd}", path)

    def close(self) -> bytes:
        """Every byte written (call once the writers are done)."""
        size = os.fstat(self.fd).st_size
        chunks, off = [], 0
        while off < size:
            chunks.append(os.pread(self.fd, size - off, off))
            off += len(chunks[-1])
        os.close(self.fd)
        os.unlink(self.path)
        return b"".join(chunks)


def seed_from(*parts) -> list:
    """A SeedSequence entropy list from --seed (any whole number) and
    stream numbers."""
    return [int(p) % (1 << 64) for p in parts]


class Bench:
    """One run of one cell: set-up, window, checks."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool,
                 device=None, cache: str = CACHE, program_overrides=None):
        self.cache = cache
        self.overrides = dict(program_overrides or {})
        self.cfg_file = spec.config
        self.traffic = spec.traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.pairs = []
        self.failed = 0
        self.errors = []

    # ---------------------------------------------------------------- set-up
    def setup(self):
        import numpy as np
        import torch
        import gen
        from gsalign_tpu_torch.config import AlignConfig
        from gsalign_tpu_torch.utils.device import resolve_device
        self.np, self.torch = np, torch
        self.dev = resolve_device(self.device)
        align = self.cfg_file["align"]
        # the settings the configuration states, which the checks hold the
        # answers to; the program runs them (a control overrides some)
        self.stated = AlignConfig(**align)
        self.acfg = AlignConfig(**dict(align, **self.overrides))
        self.reference = gen.reference_genome(self.cfg_file)
        self.index_prefix = self.ensure_index()
        pool = int(self.traffic["pool"])
        self.queries, self.truths = [], []
        for i in range(pool):
            q, t = gen.mutant(self.cfg_file, self.reference,
                              seed_from(self.seed, i))
            self.queries.append(q)
            self.truths.append(t)
        self.bases = [sum(len(s) for _, s in q) for q in self.queries]
        self.tmp = tempfile.mkdtemp(prefix="gsalign_bench_")
        self.null_prefix = os.path.join(self.tmp, "null")
        for ext in (".maf", ".vcf"):
            os.symlink(os.devnull, self.null_prefix + ext)
        rng = np.random.default_rng(seed_from(self.seed, 1 << 20))
        judged = int(self.traffic["judged"])
        self.judged = sorted(int(j) for j in rng.choice(
            int(self.traffic["judge_from"]), judged, replace=False))
        if self.traffic["index"] == "resident":
            from gsalign_tpu_torch.index.io import load_index
            from gsalign_tpu_torch.ops.rank import DeviceFMIndex
            self.fm = load_index(self.index_prefix)
            DeviceFMIndex.from_host(self.fm, self.dev)
            self.fm.genome.chars_fwd_rc()
        elif self.traffic["index"] == "load_each":
            self.fm = None
            self.fasta = []
            for i, q in enumerate(self.queries):
                path = os.path.join(self.tmp, f"query{i}.fa")
                write_fasta(path, q)
                self.fasta.append(path)
        else:
            raise ValueError(f"unknown index mode {self.traffic['index']!r}")
        # the warm-up pair: the cell's own shapes, every kernel loaded
        self.pair(len(self.queries) - 1, None)
        self.sync()

    def ensure_index(self) -> str:
        """The prefix of the reference genome's index under benchmark/.cache
        (index_dir), built with the program's build_fmindex and save_index
        where it is missing (a checkout's first run)."""
        from gsalign_tpu_torch.genome.packing import pack_genome
        from gsalign_tpu_torch.index.fmindex import build_fmindex
        from gsalign_tpu_torch.index.io import index_loadable, save_index
        d = index_dir(self.cache, self.cfg_file)
        prefix = os.path.join(d, "ref")
        if not index_loadable(prefix):
            os.makedirs(d, exist_ok=True)
            fm = build_fmindex(pack_genome(self.reference))
            save_index(fm, prefix)
            del fm
            gc.collect()
        self.index_bytes = sum(
            os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        return prefix

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    # ---------------------------------------------------------------- a pair
    def pair(self, i: int, record):
        """Align query i of the pool as the mix says; record, a dict, gets
        the pair's spans, its seed rounds and its captured outputs."""
        from gsalign_tpu_torch.pipeline.align import compare_genomes
        spans = {}
        prefix = self.null_prefix
        caps = None
        rounds = None
        if record is not None and record.get("judged"):
            prefix = os.path.join(self.tmp, f"judged{len(self.pairs)}")
            caps = [Capture(prefix + ext) for ext in (".maf", ".vcf")]
            rounds = []
        t = time.time()
        if self.fm is None:
            from gsalign_tpu_torch.genome.fasta import read_fasta
            from gsalign_tpu_torch.index.io import load_index
            fm = load_index(self.index_prefix)
            t1 = time.time()
            spans["load_index"] = t1 - t
            query = read_fasta(self.fasta[i])
            spans["read_fasta"] = time.time() - t1
        else:
            fm = self.fm
            query = self.queries[i]
        stats, collector, _ = compare_genomes(
            fm, query, self.acfg, output_prefix=prefix, verbose=False,
            device=self.dev, seed_rounds=rounds)
        spans.update(stats.span_times)
        if record is not None:
            record["spans"] = spans
            if caps is not None:
                record["maf"], record["vcf"] = (c.close() for c in caps)
                record["rounds"] = [
                    (self.np.asarray(r[1], dtype=self.np.int64), r[4], r[5])
                    for r in rounds]
        return stats

    # ---------------------------------------------------------------- window
    def window(self):
        from gsalign_tpu_torch.ops import dp_cuda
        torch = self.torch
        prof = None
        if self.trace:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        self.t_window = time.time()
        n = 0
        while time.time() - self.t_window < self.seconds:
            i = n % len(self.queries)
            rec = {"index": n, "query": i, "bases": self.bases[i],
                   "judged": n in self.judged}
            dp0 = (dp_cuda.dp_small.launches, dp_cuda.dp_any.launches)
            rec["start"] = time.time()
            try:
                if prof is not None:
                    with record_function(PAIR_MARK):
                        self.pair(i, rec)
                else:
                    self.pair(i, rec)
                self.sync()
            except Exception as exc:          # a pair that fails is counted
                import traceback
                traceback.print_exc()
                self.failed += 1
                self.errors.append(f"pair {n}: {exc!r}")
            rec["end"] = time.time()
            rec["wall"] = rec["end"] - rec["start"]
            if prof is not None:
                rec["dp_cells"] = dp_cells(dp_cuda, dp0)
            self.pairs.append(rec)
            n += 1
        self.t_end = time.time()
        self.window_s = self.t_end - self.t_window
        self.memory_peak = (torch.cuda.max_memory_allocated(self.dev)
                            if self.dev.type == "cuda" else 0)
        self.trace_summary = None
        if prof is not None:
            prof.__exit__(None, None, None)
            self.trace_summary = summarize_trace(prof, self)
            del prof

    # ---------------------------------------------------------------- checks
    def free(self):
        """Drop the program's state before the reference runs."""
        self.fm = None
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self) -> dict:
        """Every number compared, over the judged pairs: {name: value}."""
        import reference as ref_mod
        np = self.np
        from gen import CODE
        acfg = self.stated.effective()
        ref = dict(self.reference)
        ref_codes = np.concatenate([CODE[s] for _, s in self.reference])
        dev = "cuda" if self.dev.type == "cuda" else "cpu"
        totals = {}
        judged = [p for p in self.pairs if p.get("judged")]
        if len(judged) < len(self.judged):
            totals["judged_missing"] = len(self.judged) - len(judged)
        for p in judged:
            if "maf" not in p:
                totals["judged_missing"] = totals.get("judged_missing",
                                                      0) + 1
                continue
            qry = dict(self.queries[p["query"]])
            t = [time.time()]
            blocks, bad = ref_mod.parse_maf(p.pop("maf"))
            res = {"maf_blocks": len(blocks),
                   "maf_bad": bad + ref_mod.check_maf(
                       blocks, ref, qry, acfg.min_seq_idy)}
            t.append(time.time())
            dp, anchored = ref_mod.check_dp(blocks, acfg.min_seed_length,
                                            acfg.sensitive)
            res.update(dp)
            t.append(time.time())
            recs, bad = ref_mod.parse_vcf(p.pop("vcf"))
            res.update(ref_mod.check_vcf(recs, bad, blocks))
            truths = {name: tr for (name, _), tr in
                      zip(self.reference, self.truths[p["query"]])}
            res.update(ref_mod.check_snvs(recs, ref, truths, anchored))
            t.append(time.time())
            lanes, got = self.seed_lanes(p)
            res.update(ref_mod.check_seeds(
                ref_codes, lanes, got, acfg.min_seed_length,
                acfg.max_seed_freq, acfg.sensitive, device=dev))
            t.append(time.time())
            print("check seconds: maf %.3f, dp %.3f, vcf %.3f, seeds %.3f"
                  % tuple(b - a for a, b in zip(t, t[1:])), file=sys.stderr)
            for k, v in res.items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def seed_lanes(self, p):
        """The sampled lanes of a judged pair, and the program's hits in
        them from its seed rounds: ([(lane, codes, start, stop)],
        {lane: [(start, length, occurrences, position or -1)]})."""
        np = self.np
        from gen import CODE
        from gsalign_tpu_torch.ops.seeding import (F_OUT_N, F_POISON)
        chunk = self.stated.seed_exploration_chunk
        query = self.queries[p["query"]]
        offs, lanes_all = [], []
        off = 0
        for k, (_, s) in enumerate(query):
            n_chunks = max(1, -(-len(s) // chunk))
            offs.append(off)
            lanes_all += [(k, c) for c in range(n_chunks)]
            off += n_chunks * chunk
        rng = np.random.default_rng(seed_from(self.seed, 2 << 20,
                                              p["index"]))
        pick = rng.choice(len(lanes_all), min(len(lanes_all), int(
            self.traffic["seed_lanes"])), replace=False)
        chosen = [lanes_all[int(j)] for j in pick]
        codes = {k: CODE[query[k][1]] for k, _ in chosen}
        lanes = [((k, c), codes[k], c * chunk,
                  min((c + 1) * chunk, len(codes[k]))) for k, c in chosen]
        got = {lane: [] for lane in chosen}
        offs = np.asarray(offs)
        want = np.asarray([k * (1 << 32) + c for k, c in chosen], np.int64)
        for starts, st, recs in p.pop("rounds"):
            lane = np.repeat(np.arange(len(starts)), st[F_OUT_N])
            qs = (recs[:, 0] & 0xFFFF) + starts[lane]
            k = np.searchsorted(offs, qs, side="right") - 1
            pos = qs - offs[k]
            keep = (qs < st[F_POISON][lane]) & np.isin(
                k * (1 << 32) + pos // chunk, want)
            for ki, pi, ln, k0, fr in zip(k[keep], pos[keep],
                                          recs[keep, 0] >> 16,
                                          recs[keep, 1], recs[keep, 2]):
                got[(int(ki), int(pi) // chunk)].append(
                    (int(pi), int(ln), int(fr),
                     int(-k0 - 1) if k0 < 0 else -1))
        return lanes, got

    def close(self):
        import shutil
        shutil.rmtree(self.tmp, ignore_errors=True)


def index_dir(cache: str, cfg: dict) -> str:
    """The directory of a configuration's index: keyed by its genome
    (chromosomes and genome_seed) alone, so configurations that differ only
    in the aligner's settings share one index."""
    import hashlib
    key = hashlib.sha256(json.dumps(
        [cfg["chromosomes"], cfg["genome_seed"]],
        sort_keys=True).encode()).hexdigest()[:16]
    return os.path.join(cache, "index", key)


def write_fasta(path: str, records, width: int = 70) -> None:
    """FASTA of [(name, ASCII uint8[])] in lines of `width` bases."""
    import numpy as np
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b">" + name.encode() + b"\n")
            n = len(seq)
            full = n // width
            body = np.empty((full, width + 1), dtype=np.uint8)
            body[:, :width] = seq[:full * width].reshape(full, width)
            body[:, width] = ord("\n")
            fh.write(body.tobytes())
            if n % width:
                fh.write(seq[full * width:].tobytes() + b"\n")


def dp_cells(dp_cuda, before) -> int:
    """DP cells (query length x target length summed over problems) of the
    kernel launches since `before` (dp_small's and dp_any's launch counts),
    from the launches' inputs the wrappers keep."""
    total = 0
    for fn, n0 in zip((dp_cuda.dp_small, dp_cuda.dp_any), before):
        new = fn.launches - n0
        if new > len(fn.shapes):
            raise RuntimeError(f"{new} launches of {fn.__name__} in one pair, "
                               f"more than the {len(fn.shapes)} it keeps")
        for L, q, t, ql, tl in list(fn.shapes)[len(fn.shapes) - new:]:
            c = ql.clamp(0, L).long() * tl.clamp(0, L).long()
            total += int(c.sum())
    return total


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespaces,
    arguments and long template arguments."""
    head = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(head)
    for i, ch in enumerate(head):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    head = head[:cut]
    if head.startswith("void "):
        head = head[5:]
    lt = head.find("<")
    if lt >= 0 and len(head) - lt > 24:
        head = head[:lt] + "<...>"
    return (head.split("::")[-1] if "<" not in head else head).strip()


def summarize_trace(prof, bench) -> dict:
    """From the profile of the window: busy_s (the seconds in which an
    operation ran on the card), window_s, device seconds by operation, and
    the idle seconds of the card by the host span they fell in. The host
    clock is tied to the trace by the bench.pair ranges."""
    from torch.autograd import DeviceType
    dev, marks = [], []
    for e in prof.events():
        if e.name == PAIR_MARK:
            if e.device_type != DeviceType.CUDA:
                marks.append(e.time_range.start)
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.time_range.start, e.time_range.end, e.name))
    marks.sort()
    ops = {}
    for lo, hi, name in dev:
        o = ops.setdefault(short_name(name), [0, 0.0])
        o[0] += 1
        o[1] += (hi - lo) / 1e6
    pairs = bench.pairs
    if marks and len(marks) == len(pairs):
        t0_us = marks[0] - (pairs[0]["start"] - bench.t_window) * 1e6
    else:
        t0_us = min((lo for lo, _, _ in dev), default=0.0)
    w_us = bench.window_s * 1e6
    busy, end = 0.0, t0_us
    gaps = []
    for lo, hi in sorted((lo, hi) for lo, hi, _ in dev):
        lo, hi = max(lo, t0_us), min(hi, t0_us + w_us)
        if hi <= lo:
            continue
        if lo > end:
            gaps.append((end, lo))
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    if t0_us + w_us > end:
        gaps.append((end, t0_us + w_us))
    # the idle gaps on the host clock, cut by the host spans they overlap
    idle = {}
    spans = host_timeline(bench)
    starts = [s for s, _, _ in spans]
    for lo, hi in gaps:
        a = bench.t_window + (lo - t0_us) / 1e6
        b = bench.t_window + (hi - t0_us) / 1e6
        i = max(0, bisect.bisect_right(starts, a) - 1)
        covered = 0.0
        while i < len(spans) and spans[i][0] < b:
            s, e, label = spans[i]
            part = min(b, e) - max(a, s)
            if part > 0:
                idle[label] = idle.get(label, 0.0) + part
                covered += part
            i += 1
        if b - a - covered > 1e-9:
            idle["between"] = idle.get("between", 0.0) + (b - a - covered)
    return {"busy_s": busy / 1e6, "window_s": bench.window_s, "ops": ops,
            "idle": idle}


def host_timeline(bench) -> list:
    """[(start, end, span)] on the host clock, in order: each pair's spans
    laid end to end from its start (the benchmark's own spans first), the
    rest of the pair as "between"."""
    out = []
    order = ("load_index", "read_fasta", "setup", "chars_fwd_rc",
             "from_host", "query_codes", "seed", "pass1", "dp_finish",
             "pass2", "emit", "vcf_close")
    for p in bench.pairs:
        t = p["start"]
        spans = p.get("spans", {})
        for name in list(order) + [k for k in spans if k not in order]:
            if name in spans:
                out.append((t, t + spans[name], name))
                t += spans[name]
        out.append((t, max(t, p["end"]), "between"))
    return out


def power_limit():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, check=True, timeout=60)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    spec = Spec(args.workload)
    import torch
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA card(s), found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    sys.path.insert(0, ROOT)
    import gsalign_tpu_torch
    if not os.path.abspath(gsalign_tpu_torch.__file__).startswith(ROOT):
        fail(f"gsalign_tpu_torch comes from {gsalign_tpu_torch.__file__}, "
             f"not this checkout")
    run(spec, args.seed, args.seconds, bool(args.trace))
    return 0


def run(spec: Spec, seed: int, seconds: float, trace: bool,
        device=None, cache: str = CACHE, program_overrides=None) -> dict:
    """One run of a cell; prints the checks and the result line, and
    returns the result."""
    bench = Bench(spec, seed, seconds, trace, device=device, cache=cache,
                  program_overrides=program_overrides)
    bench.setup()
    setup_s = time.time() - T_START
    bench.window()
    ctx = {"pairs": bench.pairs, "window_s": bench.window_s,
           "setup_s": setup_s, "trace": bench.trace_summary,
           "config": spec.config, "traffic": spec.traffic}
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bench.free()
    t_check = time.time()
    totals = bench.check()
    check_s = time.time() - t_check
    bench.close()
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        fail(f"modules loaded in the run: {', '.join(found)}")
    limits = {k: 0 for k in ("maf_bad", "dp_subopt", "vcf_bad", "seed_bad",
                             "snv_missed", "judged_missing")}
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in totals.items() if k in limits}
    checks["failed_pairs"] = {"value": bench.failed, "limit": 0}
    counts = {k: v for k, v in totals.items() if k not in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and \
        totals.get("maf_blocks", 0) > 0 and totals.get("seed_hits", 0) > 0
    import torch
    dev = bench.dev
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": int(spec.cell["chips"]),
              "memory_peak_bytes": int(bench.memory_peak),
              "power_limit_w": power_limit() if dev.type == "cuda" else None}
    out = {"correct": bool(correct), "attempted": len(bench.pairs),
           "failed": bench.failed, "metrics": metrics, "device": device}
    if trace:
        ts = bench.trace_summary
        device["busy_s"] = ts["busy_s"]
        device["window_s"] = ts["window_s"]
        out["breakdown"] = {
            "device_ops": [[k, v[1]] for k, v in sorted(
                ts["ops"].items(), key=lambda kv: -kv[1][1])[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(
                ts["idle"].items(), key=lambda kv: -kv[1])[:10]]}
    out["counts"] = counts
    out["checks"] = checks
    import resource
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    for e in bench.errors:
        print(f"benchmark: {e}", file=sys.stderr)
    print(f"host peak RSS {rss} bytes; set-up {setup_s:.3f} s; window "
          f"{bench.window_s:.3f} s, {len(bench.pairs)} pairs; checks "
          f"{check_s:.3f} s; index {bench.index_bytes} bytes", file=sys.stderr)
    walls = sorted(p["wall"] for p in bench.pairs)
    if len(walls) >= 4:
        import statistics
        q = statistics.quantiles(walls, n=4)
        first = [p["wall"] for p in bench.pairs[:20]]
        last = [p["wall"] for p in bench.pairs[-20:]]
        print(f"pair wall quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, max "
              f"{walls[-1]:.4f}; first 20 {sum(first) / len(first):.4f}, "
              f"last 20 {sum(last) / len(last):.4f}", file=sys.stderr)
    spans = {}
    for p in bench.pairs:
        for k, v in p.get("spans", {}).items():
            spans[k] = spans.get(k, 0.0) + v / len(bench.pairs)
    print("spans a pair: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       spans.items()), file=sys.stderr)
    print(f"correct = {correct}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
