"""csrc/seed.cu rehearsed on the host: the CUDA source, unchanged, compiled
as C++ by g++ over the stand-in headers of tests/dp_host_rehearsal and
tests/seed_host_rehearsal (a std::thread a CUDA thread, the grid barrier by
the kernel's own protocol over host atomics, an exchange that waits only
for the threads its mask names) into a shared library, which the wrappers'
argument builders in ops/seed_cuda drive with CPU tensors as they drive
the card's. On lanes of the 100 kb pair, narrow and forced-wide:
seed_lockstep against the host loop scan_lockstep(plain=True) (equal lane
state, records and counters: iterations, live lanes, words gathered,
stalls) and seed_scan against seed_scan_plain. resolve_sa, a group of 16
(narrow) or 32 (wide) threads a rank, groups that leave the walk at
different depths side by side, against rank.resolve_sa on a narrow sampled
and a forced-wide index; and the row decode alone (occ_rows) against
rank.occ_t3 on a narrow index's rows and on wide rows whose checkpoints
pass 2^32. It covers the kernels' arithmetic, their slot
prefix across warps and blocks, their barrier protocol and their group
masks, not what nvcc accepts (tests/test_torch_cuda.py runs on a card).
Integers throughout: every comparison is exact. Skips without g++."""

import ctypes
import dataclasses
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsalign_tpu_torch.genome.packing import chars_to_codes, pack_genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import cuda_build, seed_cuda
from gsalign_tpu_torch.ops import rank as trank
from gsalign_tpu_torch.ops import seeding as tseeding
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from tests.make_testdata import make_pair
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
LANES, LANE_LEN = 40, 320        # three blocks of 16 warps


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("seed_rehearsal")
    for src in (os.path.join(HERE, "dp_host_rehearsal", "cuda_runtime.h"),
                os.path.join(HERE, "dp_host_rehearsal",
                             "cooperative_groups.h"),
                os.path.join(HERE, "seed_host_rehearsal", "seed_dev.cuh"),
                os.path.join(cuda_build.CSRC_DIR, "gather_dev.cuh"),
                os.path.join(cuda_build.CSRC_DIR, "seed_core.cuh"),
                os.path.join(cuda_build.CSRC_DIR, "seed.cu")):
        shutil.copy(src, d)
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-I.", "-x", "c++", "seed.cu", "-o",
                    "libseed_host.so"], cwd=d, check=True, timeout=600)
    lib = ctypes.CDLL(str(d / "libseed_host.so"))
    for fn, argtypes in seed_cuda.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def pair():
    return make_pair(total_len=100_000)


def lanes_of(dfm, qry):
    """(index tables, query rows, lane starts, lane stops) on the CPU:
    LANES lanes of LANE_LEN bases from the 100 kb pair's first query
    chromosome, across the start of its inversion."""
    codes = chars_to_codes(qry[0][1])
    q_rows = tseeding.build_qrows(torch.from_numpy(codes))
    first = 50_000 // 3 - LANES * LANE_LEN // 2
    starts = first + LANE_LEN * np.arange(LANES, dtype=np.int64)
    return dfm, q_rows, starts, starts + LANE_LEN


@pytest.fixture(scope="module")
def case(pair):
    ref, qry = pair
    return lanes_of(DeviceFMIndex.from_host(build_fmindex(pack_genome(ref)),
                                            "cpu"), qry)


@pytest.fixture(scope="module")
def sampled(pair):
    """The 100 kb reference's sa_intv=8 index, narrow and forced-wide."""
    g = pack_genome(pair[0])
    return {wide: DeviceFMIndex.from_host(
        build_fmindex(g, sa_intv=8, force_wide=wide), "cpu")
        for wide in (False, True)}


@pytest.fixture(scope="module")
def wide_case(pair, sampled):
    return lanes_of(sampled[True], pair[1])


def params(sa_mode):
    return tseeding.ScanParams(min_seed_length=15, max_seed_freq=100,
                               sensitive=False, max_out=8, sa_mode=sa_mode)


@pytest.mark.parametrize("sa_mode,K,max_blocks,max_iters", [
    ("pallas", 2, None, 0),     # a warp a lane, lanes stall for the slots
    ("pallas", 2, 1, 0),        # three lanes a warp, one block
    ("pallas", 512, 2, 0),      # two lanes a warp, the last warps idle
    ("xla", 512, None, 0),      # no slots: the diffing tool's scan
    ("pallas", 2, None, 9),     # stopped after nine iterations
    ("pallas", 2, 2, 1),        # seed_step: one iteration
    ("none", 512, None, 0),     # a forced-wide index: wide rows
    ("none", 512, 1, 0),        # and three lanes a warp
])
def test_seed_lockstep_on_host_threads(monkeypatch, host_lib, case,
                                       wide_case, sa_mode, K, max_blocks,
                                       max_iters):
    dfm, q_rows, starts, stops = wide_case if sa_mode == "none" else case
    prm = params(sa_mode)
    monkeypatch.setattr(tseeding, "_SA_GATHER_K", K)
    want = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    n_iter = tseeding.scan_lockstep(dfm, q_rows, want, prm, plain=True,
                                    max_iters=max_iters)
    got = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    seed_cuda.launch_lockstep(host_lib, None, dfm, q_rows, got, prm,
                              max_iters, max_blocks)
    st, counters = got.read_back()
    want_st, want_counters = want.read_back()
    np.testing.assert_array_equal(counters, want_counters)
    np.testing.assert_array_equal(st, want_st)
    assert torch.equal(got.out, want.out)
    assert counters[tseeding.C_ITERS] == n_iter == (max_iters or n_iter)
    assert (counters[tseeding.C_LIVE] > 0) == (max_iters > 0)
    if sa_mode == "pallas":
        assert counters[tseeding.C_GATHERED] > 0 or max_iters == 1
        assert (counters[tseeding.C_STALLED] > 0) == (K == 2
                                                      and max_iters != 1)
    else:
        assert counters[tseeding.C_GATHERED] == 0
    if max_iters == 0:
        assert st[tseeding.F_OUT_N].sum() > 0
        assert n_iter == st[tseeding.F_STEPS].max()


def test_the_stand_in_device_holds_ten_blocks(host_lib):
    assert seed_cuda.resident_blocks(host_lib, 40) == 10
    assert seed_cuda.resident_blocks(host_lib, -1) == 10
    # a window that no block's shared memory holds
    assert seed_cuda.resident_blocks(host_lib, 1 << 20) == 0


def test_a_grid_short_of_the_lanes_is_refused(host_lib, case):
    """The C entry point checks the plan it is given."""
    dfm, q_rows, starts, stops = case
    prm = params("xla")
    lanes = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    counts = torch.zeros(2 * 2 + 1, dtype=torch.int64)
    args = seed_cuda._seed_args(dfm, q_rows, lanes, prm, block_counts=counts,
                                gather_k=2, max_iters=0, blocks=2,
                                lanes_per_warp=1)
    assert host_lib.gsalign_seed_lockstep(ctypes.byref(args), None) != 0


@pytest.mark.parametrize("sensitive", [False, True])
@pytest.mark.parametrize("wide", [False, True])
def test_seed_scan_on_host_threads(host_lib, case, wide_case, wide,
                                   sensitive):
    """seed_scan (a warp a lane, run to its end) against seed_scan_plain
    on the full-SA index in xla mode and on the forced-wide index, with
    and without sensitive seeding."""
    dfm, q_rows, starts, stops = wide_case if wide else case
    prm = dataclasses.replace(params("none" if wide else "xla"),
                              sensitive=sensitive)
    want = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    want_st = tseeding.seed_scan_plain(dfm, q_rows, want, prm)
    got = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    win_words = seed_cuda._win_words(got.max_len)
    args = seed_cuda._seed_args(dfm, q_rows, got, prm, win_words=win_words,
                                step_cap=seed_cuda._step_cap(got.max_len))
    assert host_lib.gsalign_seed_scan(ctypes.byref(args), None) == 0
    np.testing.assert_array_equal(got.read_back()[0], want_st)
    assert torch.equal(got.out, want.out)
    assert want_st[tseeding.F_OUT_N].sum() > 0


def probe_ranks(dfm, n: int) -> torch.Tensor:
    """n ranks: the primary, the SA < 3 exception rows, row 0, the last
    rank, and random ones (uneven walk depths side by side)."""
    rng = np.random.default_rng(dfm.seq_len)
    k = rng.integers(0, dfm.seq_len + 1, n)
    special = [dfm.primary, 0, dfm.seq_len] + dfm.t3_exc_pos.tolist()
    k[:len(special)] = special
    return torch.from_numpy(k.astype(np.int64))


@pytest.mark.parametrize("wide", [False, True])
def test_resolve_sa_on_host_threads(host_lib, sampled, wide):
    """The group-a-rank resolve_sa against the plain LF walk on 40 ranks
    (the last block's last groups idle)."""
    dfm = sampled[wide]
    k = probe_ranks(dfm, 40)
    out = torch.full_like(k, -1)
    args = seed_cuda._resolve_args(dfm, k, out)
    assert host_lib.gsalign_resolve_sa(ctypes.byref(args), None) == 0
    assert torch.equal(out, trank.resolve_sa(dfm, k))


@pytest.mark.parametrize("wide", [False, True])
def test_row_decode_on_carry_rows(host_lib, wide):
    """occ_rows against rank.occ_t3 in both modes: on the synthetic wide
    rows of tests/test_torch_wide.py (checkpoints past 2^32, carries 1 to
    3), or on a narrow index's rows, row edges included."""
    if wide:
        from tests.test_torch_wide import carry_case
        dfm, _, k, tri, cls = carry_case(n=48)
    else:
        rng = np.random.default_rng(16)
        dfm = DeviceFMIndex.from_host(build_fmindex(pack_genome(
            make_pair(total_len=20_000)[0])), "cpu")
        k = rng.integers(0, dfm.seq_len + 1, 48)
        k[:4] = [0, 1, 127, 128]
        tri = rng.random(48) < 0.5
        cls = np.where(tri, rng.integers(0, 64, 48), rng.integers(0, 4, 48))
    k, tri, cls = (torch.from_numpy(np.asarray(x, dtype=np.int64))
                   for x in (k, tri, cls))
    out = torch.full_like(k, -1)
    args = seed_cuda.occ_args(dfm, k, cls, tri, out)
    assert host_lib.gsalign_occ_rows(ctypes.byref(args), None) == 0
    want = trank.occ_t3(dfm, k, tri != 0, cls)
    assert torch.equal(out, want)
    assert (int(want.min()) >= 2 ** 32) == wide


def boundary_ranks(dfm, rows: int, n: int) -> torch.Tensor:
    """Ranks in the first and the last row of every block of `rows` t3
    rows (each row holds 128 ranks), within [0, seq_len]."""
    k = []
    for s in range(n):
        for r in (s * rows, (s + 1) * rows - 1):
            k += [128 * r, 128 * r + 127]
    return torch.from_numpy(np.clip(np.asarray(k, dtype=np.int64), 0,
                                    dfm.seq_len))


@pytest.mark.parametrize("blocks", [3, 16])
@pytest.mark.parametrize("kernel,wide", [
    ("resolve_sa", False), ("resolve_sa", True), ("seed_scan", False),
    ("seed_scan", True), ("seed_lockstep", False)])
def test_row_sharded_tables_on_host_threads(host_lib, pair, case, sampled,
                                            kernel, wide, blocks):
    """The kernels' ShardedTable instances on tables cut in 3 and in 16
    (parallel/mesh.shard_index_rows over that many CPU entries; 16 is past
    the 8 blocks the kernels once took): resolve_sa from the first and
    last rank of every block, and others, against the plain walk over the
    whole tables, and the scans against the plain scan on the whole tables
    (seed_scan on the sampled indexes; seed_lockstep in pallas mode on the
    full-SA index, whose narrow rows are the only ones it takes cut)."""
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh(["cpu"] * blocks)
    whole = case[0] if kernel == "seed_lockstep" else sampled[wide]
    cut = mesh_lib.shard_index_rows(whole, mesh)
    rows = cut.row_shards["t3"].rows
    assert cut.t3.shape[0] == 0 and \
        len(cut.row_shards["t3"].blocks) == blocks
    if kernel == "resolve_sa":
        k = torch.cat([probe_ranks(whole, 40), boundary_ranks(whole, rows,
                                                              blocks)])
        out = torch.full_like(k, -1)
        args = seed_cuda._resolve_args(cut, k, out)
        assert args.t3_shards.rows == rows
        assert host_lib.gsalign_resolve_sa(ctypes.byref(args), None) == 0
        assert torch.equal(out, trank.resolve_sa(whole, k))
    else:
        _, q_rows, starts, stops = lanes_of(whole, pair[1])
        prm = params("pallas" if kernel == "seed_lockstep" else "none")
        want = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
        tseeding.scan_lockstep(whole, q_rows, want, prm, plain=True)
        got = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
        if kernel == "seed_lockstep":
            seed_cuda.launch_lockstep(host_lib, None, cut, q_rows, got, prm,
                                      0, None)
        else:
            args = seed_cuda._seed_args(
                cut, q_rows, got, prm,
                win_words=seed_cuda._win_words(got.max_len),
                step_cap=seed_cuda._step_cap(got.max_len))
            assert host_lib.gsalign_seed_scan(ctypes.byref(args), None) == 0
        np.testing.assert_array_equal(got.read_back()[0],
                                      want.read_back()[0])
        assert torch.equal(got.out, want.out)
        assert want.read_back()[0][tseeding.F_OUT_N].sum() > 0


@pytest.mark.parametrize("wide", [False, True])
def test_row_blocks_up_to_the_bound_on_host_threads(host_lib, sampled, wide):
    """resolve_sa over seed_cuda.MAX_SHARDS row blocks (the argument
    struct full: every block address in use, most blocks zero padding)
    against the plain walk on the whole tables; one block more is refused
    before any launch, with the bound named."""
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    whole = sampled[wide]
    n = seed_cuda.MAX_SHARDS
    cut = mesh_lib.shard_index_rows(whole, mesh_lib.make_mesh(["cpu"] * n))
    # every 64th block's edges and the last block that holds t3 rows (a
    # thread a CUDA thread: keep the ranks few)
    rows = cut.row_shards["t3"].rows
    last = (whole.t3.shape[0] - 1) // rows
    edges = boundary_ranks(whole, rows, last + 1).view(-1, 4)
    k = torch.cat([probe_ranks(whole, 24),
                   edges[list(range(0, last, 64)) + [last]].reshape(-1)])
    out = torch.full_like(k, -1)
    args = seed_cuda._resolve_args(cut, k, out)
    assert args.sa_shards.block[n - 1] is not None
    assert host_lib.gsalign_resolve_sa(ctypes.byref(args), None) == 0
    assert torch.equal(out, trank.resolve_sa(whole, k))
    over = mesh_lib.shard_index_rows(whole,
                                     mesh_lib.make_mesh(["cpu"] * (n + 1)))
    with pytest.raises(ValueError, match=f"at most MAX_SHARDS = {n}"):
        seed_cuda._resolve_args(over, k, out)


SEG_LEN, SLACK = 80, 12          # four segments a 320-base chunk


def segment_lanes_of(dfm, qry):
    """(index tables, query rows, lane starts, lane bounds [3, B]) of
    speculative segment lanes on the CPU: the LANES chunks of lanes_of cut
    into segments of SEG_LEN bases, each recording over its segment and
    extending SLACK bases past it (the chunk's end for the last): a tiny
    slack, so that the 100 kb pair's long exact matches clip at the
    artificial bounds and poison lanes."""
    dfm, q_rows, chunk_starts, _ = lanes_of(dfm, qry)
    n = LANE_LEN // SEG_LEN
    first = chunk_starts[:LANES // n]
    starts = (first[:, None] + SEG_LEN * np.arange(n)).reshape(-1)
    hard = np.repeat(first + LANE_LEN, n)
    bounds = np.stack([starts + SEG_LEN,
                       np.minimum(starts + SEG_LEN + SLACK, hard), hard])
    return dfm, q_rows, starts, bounds


@pytest.mark.parametrize("kernel,wide,blocks", [
    ("seed_scan", False, 0), ("seed_scan", True, 0),
    ("seed_lockstep", False, 0), ("seed_lockstep", True, 0),
    ("seed_scan", False, 3), ("seed_scan", True, 3),
    ("seed_lockstep", False, 3)])
def test_segment_lanes_on_host_threads(monkeypatch, host_lib, pair, case,
                                       sampled, kernel, wide, blocks):
    """seed_scan and seed_lockstep on speculative segment lanes (emit <
    ext < hard, lanes poisoned at their ext bound) against the plain scan:
    equal lane state (exits, poison positions, steps) and records. seed_scan
    on the full-SA index in xla mode (direct extensions clip at the bound
    too) and on the forced-wide index, seed_lockstep in pallas mode with 2
    slots and on the forced-wide index; whole, and on tables cut in 3 row
    blocks (the sampled indexes for seed_scan)."""
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    monkeypatch.setattr(tseeding, "_SA_GATHER_K", 2)
    if blocks:
        whole = case[0] if kernel == "seed_lockstep" else sampled[wide]
    else:
        whole = sampled[True] if wide else case[0]
    mode = "none" if not whole.direct_ok else \
        ("pallas" if kernel == "seed_lockstep" else "xla")
    _, q_rows, starts, bounds = segment_lanes_of(whole, pair[1])
    tables = mesh_lib.shard_index_rows(
        whole, mesh_lib.make_mesh(["cpu"] * blocks)) if blocks else whole
    prm = params(mode)
    want = tseeding.ScanLanes.start(starts, bounds, prm.max_out, "cpu")
    tseeding.scan_lockstep(whole, q_rows, want, prm, plain=True)
    got = tseeding.ScanLanes.start(starts, bounds, prm.max_out, "cpu")
    if kernel == "seed_lockstep":
        seed_cuda.launch_lockstep(host_lib, None, tables, q_rows, got, prm,
                                  0, None)
    else:
        args = seed_cuda._seed_args(
            tables, q_rows, got, prm,
            win_words=seed_cuda._win_words(got.max_len),
            step_cap=seed_cuda._step_cap(got.max_emit, got.max_len))
        assert host_lib.gsalign_seed_scan(ctypes.byref(args), None) == 0
    st, want_st = got.read_back()[0], want.read_back()[0]
    np.testing.assert_array_equal(st, want_st)
    assert torch.equal(got.out, want.out)
    recs = got.out[torch.arange(prm.max_out)[None, :]
                   < got.st[tseeding.F_OUT_N][:, None]].numpy()
    at_bound, _ = tseeding.poison_causes(
        st, tseeding.record_starts(starts, st, recs), prm.max_out)
    assert at_bound > 0 and st[tseeding.F_OUT_N].sum() > 0
