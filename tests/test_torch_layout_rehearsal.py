"""csrc/layout.cu rehearsed on the host: the CUDA source, unchanged,
compiled as C++ by g++ over the stand-in cuda_runtime.h of
tests/dp_host_rehearsal (a std::thread a CUDA thread, warp exchanges
between barriers) into a shared library, which ops/layout_cuda's
init10_launch drives with CPU tensors as it drives the card's. The INIT-10
rows it writes against the plain version (ops/rank._build_c10 with
_c10_from_counts, packed as DeviceFMIndex.host_tables packs them), bit for
bit: texts around the 10-mer edge, texts whose last bases make steps at
key 0 and above it, a 200 kb random text, texts with long repeats; and the
whole card layout (host_tables with card_init10, from_tables,
rank.with_init10) against the CPU layout's comb_pairs and init_corr, on a
direct and a sampled index. It checks the kernels' arithmetic, indexing and
warp protocol, not what nvcc accepts (tests/test_torch_cuda.py runs on a
card). Skips without g++."""

import ctypes
import functools
import os
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from gsalign_tpu_torch.genome.packing import pack_genome
from gsalign_tpu_torch.index.fmindex import build_fmindex, pack_bwt_codes
from gsalign_tpu_torch.ops import cuda_build, layout_cuda, rank
from tests.make_testdata import make_pair
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("layout_rehearsal")
    for src in (os.path.join(HERE, "dp_host_rehearsal", "cuda_runtime.h"),
                os.path.join(cuda_build.CSRC_DIR, "layout.cu")):
        shutil.copy(src, d)
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-I.", "-x", "c++", "layout.cu", "-o",
                    "liblayout_host.so"], cwd=d, check=True, timeout=600)
    lib = ctypes.CDLL(str(d / "liblayout_host.so"))
    for fn, argtypes in layout_cuda.SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def plain_rows(text: np.ndarray, n: int) -> np.ndarray:
    """The INIT rows as DeviceFMIndex.host_tables lays them out."""
    starts, _ = rank._build_c10(text, n)
    ext = np.append(starts, n + 1).astype(np.uint64)
    return (ext[:-1] | (ext[1:] << np.uint64(32))).view(np.int64)


def card_rows(lib, text: np.ndarray, n: int, max_blocks: int) -> np.ndarray:
    words = np.concatenate([pack_bwt_codes(text), np.zeros(1, np.uint32)])
    rows = torch.empty(layout_cuda.N_KEYS, dtype=torch.int64)
    layout_cuda.init10_launch(lib, None,
                              torch.from_numpy(words.view(np.int32)), 16, n,
                              rank._c10_steps(text, n), rows,
                              max_blocks=max_blocks)
    return rows.numpy()


def text_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("len"):
        return rng.integers(0, 4, int(name[3:])).astype(np.uint8)
    if name == "ends_in_a":             # steps at key 0 beside the empty one
        t = rng.integers(0, 4, 3001).astype(np.uint8)
        t[-6:] = 0
        return t
    if name == "steps_above_0":         # nine steps at keys above 0
        t = rng.integers(0, 4, 5003).astype(np.uint8)
        t[-9:] = [3, 1, 0, 2, 2, 0, 1, 3, 1]
        return t
    if name == "random_200kb":
        return rng.integers(0, 4, 200_000).astype(np.uint8)
    # long repeats: a 40 kb run of one base and 60 kb of an 8-base period,
    # so that a few bins hold tens of thousands of counts
    t = rng.integers(0, 4, 150_000).astype(np.uint8)
    t[20_000:60_000] = 2
    t[80_000:140_000] = np.tile(np.array([0, 1, 2, 3, 3, 2, 1, 0], np.uint8),
                                7_500)
    return t


@pytest.mark.parametrize("name,max_blocks", [
    ("len0", 1), ("len5", 1), ("len9", 1), ("len10", 1), ("len11", 1),
    ("ends_in_a", 1), ("steps_above_0", 2), ("random_200kb", 1),
    ("repeats", 3)])
def test_init10_rows_on_host_threads(host_lib, name, max_blocks):
    text = text_case(name)
    n = text.shape[0]
    got = card_rows(host_lib, text, n, max_blocks)
    np.testing.assert_array_equal(got, plain_rows(text, n))
    if n >= 10:
        # the last row ends at n + 1: every 10-mer and step was counted
        assert int(got[-1]) >> 32 == n + 1


@pytest.mark.parametrize("sa_intv", [1, 8])
def test_card_layout_on_host_threads(host_lib, sa_intv):
    ref, _ = make_pair(total_len=30_000, seed=5, inversion=False)
    fm = build_fmindex(pack_genome(ref), sa_intv=sa_intv)
    want = rank.DeviceFMIndex.from_host(fm, "cpu")
    tabs = rank.DeviceFMIndex.host_tables(fm, card_init10=True)
    assert tabs["comb_pairs"].shape[0] == rank.INIT_OFF
    assert (tabs["init10"]["words"] is None) == (sa_intv == 1)
    head = rank.DeviceFMIndex.from_tables(
        tabs, host_sa=None, seq_len=fm.seq_len, primary=fm.primary,
        device="cpu")
    launch = functools.partial(layout_cuda.init10_launch, host_lib, None,
                               max_blocks=2)
    got = rank.with_init10(head, tabs["init10"], launch=launch)
    assert torch.equal(got.comb_pairs, want.comb_pairs)
    assert torch.equal(got.init_corr, want.init_corr)


def test_init10_launch_refuses_a_short_text(host_lib):
    text = np.zeros(100, np.uint8)
    rows = torch.empty(layout_cuda.N_KEYS, dtype=torch.int64)
    with pytest.raises(ValueError, match="needs more than"):
        layout_cuda.init10_launch(host_lib, None,
                                  torch.zeros(6, dtype=torch.int32), 16, 100,
                                  rank._c10_steps(text, 100), rows)


def test_init10_rows_raises_off_a_card():
    with pytest.raises(ValueError, match="runs on a card"):
        layout_cuda.init10_rows(torch.zeros(2, dtype=torch.int32), 16, 5,
                                np.zeros(1, np.int64),
                                torch.empty(layout_cuda.N_KEYS,
                                            dtype=torch.int64))
