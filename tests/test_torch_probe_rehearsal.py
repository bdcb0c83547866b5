"""csrc/probe.cu rehearsed on the host: the CUDA source, unchanged, with
csrc/seed_core.cuh (the scan's device functions it shares), compiled as
C++ by g++ over the stand-in headers of tests/dp_host_rehearsal and
tests/seed_host_rehearsal (a std::thread a CUDA thread, warp exchanges
between barriers) into a shared library, which ops/probe's launch
functions drive with CPU tensors as they drive the card's. Every seedcost
instance (pieces 0-5 narrow, 0-3 wide) against seedcost_plain on the
40 kb pair of tests/test_torch_seedcost.py (its N runs and last INIT
row), acc, checksum and planes equal; gather_sweep, one table and two,
against gather_sweep_plain. It checks the kernels' arithmetic, clamps and
warp protocol, not what nvcc accepts (tests/test_torch_cuda.py runs on a
card). Integers throughout: every comparison is exact. Skips without
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
from gsalign_tpu_torch.ops import cuda_build, probe
from gsalign_tpu_torch.ops import seeding as tseeding
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from tests.make_testdata import make_pair
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
B, K, MAX_OUT = 12, 20, 8       # three blocks of four warps


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("probe_rehearsal")
    for src in (os.path.join(HERE, "dp_host_rehearsal", "cuda_runtime.h"),
                os.path.join(HERE, "seed_host_rehearsal", "seed_dev.cuh"),
                os.path.join(cuda_build.CSRC_DIR, "seed_core.cuh"),
                os.path.join(cuda_build.CSRC_DIR, "probe.cu")):
        shutil.copy(src, d)
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-I.", "-x", "c++", "probe.cu", "-o",
                    "libprobe_host.so"], cwd=d, check=True, timeout=600)
    lib = ctypes.CDLL(str(d / "libprobe_host.so"))
    for fn, argtypes in probe.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def case():
    """Query rows of the 40 kb pair with the N and poly-A runs of
    test_torch_seedcost.py, and its reference's index, narrow and
    forced-wide."""
    ref, qry = make_pair(total_len=40_000)
    codes = np.concatenate([chars_to_codes(q) for _, q in qry])
    codes[9973 + 14: 9973 + 40] = 0
    codes[19946 + 30: 19946 + 45] = 4
    codes[19946 + 62: 19946 + 66] = 4
    codes[19946 + 100: 19946 + 200: 9] = 4
    q_rows = tseeding.build_qrows(torch.from_numpy(codes))
    g = pack_genome(ref)
    return q_rows, {wide: DeviceFMIndex.from_host(
        build_fmindex(g, force_wide=wide), "cpu") for wide in (False, True)}


@pytest.mark.parametrize("piece,wide", [(p, False) for p in range(6)]
                         + [(p, True) for p in range(4)])
def test_seedcost_on_host_threads(host_lib, case, piece, wide):
    q_rows, tables = case
    dfm = tables[wide]
    want = probe.seedcost_plain(dfm, q_rows, piece, B, K, MAX_OUT)
    got = probe.SeedcostOut.zeros(B, MAX_OUT, "cpu")
    probe.seedcost_launch(host_lib, None, dfm, q_rows, piece, B, K, MAX_OUT,
                          got)
    for name in ("acc", "chk", "out_meta", "out_k0", "out_fr", "out_n"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if piece == 5:
        assert int(got.out_n.sum()) > 0


def test_a_wide_text_piece_is_refused(host_lib, case):
    q_rows, tables = case
    with pytest.raises(ValueError, match="text rows"):
        probe.seedcost_launch(host_lib, None, tables[True], q_rows, 4, B, K,
                              MAX_OUT, probe.SeedcostOut.zeros(B, MAX_OUT,
                                                               "cpu"))


@pytest.mark.parametrize("two", [False, True], ids=["one", "two"])
def test_gather_sweep_on_host_threads(host_lib, two):
    n_all = 1 << 12
    t = torch.arange(n_all, dtype=torch.int32)
    n = n_all // 2 if two else n_all
    ta, tb = (t[:n], t[n:]) if two else (t, None)
    idx0 = probe.sweep_start(300, n)
    want = probe.gather_sweep_plain(ta, tb, idx0, 40, n)
    got = probe.gather_sweep_launch(host_lib, None, ta, tb, idx0, 40, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
