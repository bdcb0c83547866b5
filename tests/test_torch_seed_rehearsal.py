"""csrc/seed.cu rehearsed on the host: the CUDA source, unchanged, compiled
as C++ by g++ over the stand-in headers of tests/dp_host_rehearsal and
tests/seed_host_rehearsal (a std::thread a CUDA thread, the grid barrier by
the kernel's own protocol over host atomics) into a shared library, which
ops/seed_cuda.launch_lockstep drives with CPU tensors as it drives the
card's. seed_lockstep is held against the host loop
scan_lockstep(plain=True) on lanes of the 100 kb pair: equal lane state,
records and counters (iterations, live lanes, words gathered, stalls). It
covers the kernel's arithmetic, its slot prefix across warps and blocks and
its barrier protocol, not what nvcc accepts (tests/test_torch_cuda.py runs
on a card). Integers throughout: every comparison is exact. Skips without
g++."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsalign_tpu_torch.genome.packing import chars_to_codes, pack_genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import cuda_build, seed_cuda
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
def case():
    """(index tables, query rows, lane starts, lane stops) on the CPU:
    LANES lanes of LANE_LEN bases from the 100 kb pair's first query
    chromosome, across the start of its inversion."""
    ref, qry = make_pair(total_len=100_000)
    dfm = DeviceFMIndex.from_host(build_fmindex(pack_genome(ref)), "cpu")
    codes = chars_to_codes(qry[0][1])
    q_rows = tseeding.build_qrows(torch.from_numpy(codes))
    first = 50_000 // 3 - LANES * LANE_LEN // 2
    starts = first + LANE_LEN * np.arange(LANES, dtype=np.int64)
    return dfm, q_rows, starts, starts + LANE_LEN


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
])
def test_seed_lockstep_on_host_threads(monkeypatch, host_lib, case, sa_mode,
                                       K, max_blocks, max_iters):
    dfm, q_rows, starts, stops = case
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
