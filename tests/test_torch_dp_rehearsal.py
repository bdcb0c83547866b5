"""csrc/dp.cu rehearsed on the host: the CUDA source, unchanged, compiled
as C++ by g++ over the stand-in headers of tests/dp_host_rehearsal (a
std::thread a CUDA thread) and held against the plain torch DP: equal ops,
contiguous from column 0 and then OP_PAD, and for dp_any direction words
that decode through dir_word_index to the plain forward pass's nibbles. It
covers the kernels' arithmetic, indexing and the hand-over between warps,
not what nvcc accepts (tests/test_torch_cuda.py runs on a card). Skips
without g++."""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsalign_tpu_torch.ops import cuda_build
from gsalign_tpu_torch.ops import dp as tdp
from gsalign_tpu_torch.ops.dp_cuda import dir_word_index
from tests.dp_cases import edge_batch, make_batch, max_abs_err
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "dp_host_rehearsal")


@pytest.fixture(scope="module")
def rehearse(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("dp_rehearsal")
    for name in os.listdir(HERE):
        shutil.copy(os.path.join(HERE, name), d)
    shutil.copy(os.path.join(cuda_build.CSRC_DIR, "dp.cu"), d)
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-I.", "-x",
                    "c++", "main.cpp", "-o", "rehearse"], cwd=d, check=True,
                   timeout=600)
    return d


def run_kernel(d, kernel, L, K, wpb, cs, host):
    """One launch on the stand-in: (ops [B, 2L], direction words)."""
    B = len(host[2])
    with open(d / "in.bin", "wb") as fh:
        fh.write(np.array([kernel, B, L, K, wpb, cs], np.int32).tobytes())
        for a in host:
            fh.write(np.ascontiguousarray(a).tobytes())
    subprocess.run([str(d / "rehearse"), "in.bin", "out.bin"], cwd=d,
                   check=True, timeout=600)
    raw = np.fromfile(d / "out.bin", np.uint8)
    return (raw[:B * 2 * L].reshape(B, 2 * L),
            raw[B * 2 * L:].view(np.uint32).reshape(B, -1))


def check(d, kernel, L, K, wpb, cs, host):
    q, t, ql, tl = host
    ops, words = run_kernel(d, kernel, L, K, wpb, cs, host)
    args = [torch.from_numpy(a)
            for a in (q, t, np.clip(ql, 0, L), np.clip(tl, 0, L))]
    assert max_abs_err(ops, tdp.dp_align_batch(*args, L).numpy()) == 0
    n = (ops != tdp.OP_PAD).sum(axis=1)
    assert ((np.arange(2 * L)[None, :] < n[:, None])
            == (ops != tdp.OP_PAD)).all()
    if kernel == 1:
        nib = tdp._dp_forward(*args, L).numpy()          # [2L-1, B, L]
        for b in range(len(ql)):
            i, j = np.meshgrid(np.arange(int(args[3][b])),
                               np.arange(int(args[2][b])), indexing="ij")
            w, at = dir_word_index(L, K, i, j)
            got = (words[b][w] >> (4 * at).astype(np.uint32)) & 15
            np.testing.assert_array_equal(got, nib[i + j, b, i])


@pytest.mark.parametrize("L,K,wpb,B", [(64, 2, 4, 7), (64, 4, 2, 3),
                                       (128, 4, 2, 3), (32, 2, 2, 3)])
def test_dp_small_on_host_threads(rehearse, L, K, wpb, B):
    check(rehearse, 0, L, K, wpb, 1,
          make_batch(np.random.default_rng(L + K), L, B))


@pytest.mark.parametrize("L,K,wpb,cs", [
    (64, 2, 1, 1),      # one warp
    (128, 2, 2, 1),     # a chain of two warps in one block
    (128, 2, 1, 2),     # the chain over two blocks of a cluster
    (128, 2, 1, 1),     # two passes through the row buffer
    (256, 2, 2, 2),     # two blocks of two warps
    (256, 2, 1, 2),     # a cluster and two passes
    (96, 2, 1, 1),      # strips that do not divide L
])
def test_dp_any_on_host_threads(rehearse, L, K, wpb, cs):
    check(rehearse, 1, L, K, wpb, cs,
          make_batch(np.random.default_rng(L + wpb + cs), L, 2))


@pytest.mark.parametrize("kernel,L,K,wpb", [(0, 64, 2, 4), (1, 128, 2, 1)])
def test_edge_problems_on_host_threads(rehearse, kernel, L, K, wpb):
    check(rehearse, kernel, L, K, wpb, 1,
          edge_batch(np.random.default_rng(L), L))
