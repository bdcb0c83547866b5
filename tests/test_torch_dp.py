"""DP parity of the PyTorch port (gsalign_tpu_torch.ops.dp / dp_cuda)
against the JAX package's DP (the lax.scan path, the Pallas kernel in
interpret mode) and the ksw2 oracle. Op codes are integers: every
comparison is exact, after OP_PAD is stripped. The kernels' own cases on a
CUDA card are in test_torch_cuda.py, which imports no JAX."""

import gzip
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsalign_tpu.ops import dp as jdp
from gsalign_tpu_torch.ops import dp as tdp
from gsalign_tpu_torch.ops import dp_cuda
from tests.dp_cases import (edge_batch, load_oracle, make_batch,
                            oracle_batch, oracle_rows, scalar_backtrack,
                            strip_fill)
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def strip(ops_row):
    return ops_row[ops_row != tdp.OP_PAD]


def torch_ops(q, t, ql, tl, L, fn=tdp.dp_align_batch):
    return fn(*(torch.from_numpy(np.ascontiguousarray(a))
                for a in (q, t, ql, tl)), L).numpy()


def assert_same_ops(a, b):
    assert a.shape[0] == b.shape[0]
    for i in range(a.shape[0]):
        np.testing.assert_array_equal(strip(a[i]), strip(b[i]),
                                      err_msg=f"problem {i}")


@pytest.mark.parametrize("L,B", [(64, 24), (128, 12), (256, 6), (512, 3)])
def test_plain_dp_matches_jax_scan(L, B):
    q, t, ql, tl = make_batch(np.random.default_rng(L), L, B)
    want = np.asarray(jdp.dp_align_batch(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(t.astype(np.int32)),
        jnp.asarray(ql), jnp.asarray(tl), L))
    assert_same_ops(torch_ops(q, t, ql, tl, L), want)


def test_plain_dp_matches_pallas_interpret():
    from gsalign_tpu.ops.dp_pallas import dp_align_batch_pallas
    L, B = 64, 12
    q, t, ql, tl = make_batch(np.random.default_rng(7), L, B)
    want = np.asarray(dp_align_batch_pallas(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(t.astype(np.int32)),
        jnp.asarray(ql), jnp.asarray(tl), L, interpret=True))
    assert_same_ops(torch_ops(q, t, ql, tl, L), want)


def test_plain_dp_matches_ksw2_oracle():
    cases, outs = load_oracle()
    assert oracle_rows(cases, torch_ops(*oracle_batch(cases, 256), 256)) \
        == outs


def pair3000():
    """The 3000-base pair of tests/golden/dp_pair3000_ops.txt.gz, whose
    forward ops the JAX package's align_fragments produced (buckets up to
    2048, so the pair runs in the ceil(m/1024)*1024 bucket: 3072). The JAX
    lax.scan takes minutes at that width on a CPU, so it ran once."""
    rng = np.random.default_rng(3000)
    a = rng.integers(0, 4, 3000).astype(np.uint8)
    b = a.copy()
    sub = rng.random(3000) < 0.05
    b[sub] = (b[sub] + 1) % 4
    b = np.delete(b, slice(1000, 1060))
    b = np.insert(b, 2000, rng.integers(0, 4, 25).astype(np.uint8))
    b[500:520] = 4
    with gzip.open(os.path.join(GOLDEN_DIR, "dp_pair3000_ops.txt.gz"),
                   "rt") as fh:
        ops = np.frombuffer(fh.read().strip().encode(), np.uint8) - ord("0")
    return a, b, ops


def test_fragment_aligner_matches_jax_align_fragments():
    rng = np.random.default_rng(3)
    lens = [10, 40, 63, 64, 65, 100, 200, 256, 300, 500]
    rfs, qfs = [], []
    for n in lens:
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = a.copy()
        sub = rng.random(n) < 0.05
        b[sub] = (b[sub] + 1) % 4
        b = np.delete(b, slice(n // 3, n // 3 + max(1, n // 50)))
        rfs.append(a)
        qfs.append(b)
    buckets = (64, 128, 256, 512, 1024, 2048)
    want = jdp.align_fragments(rfs, qfs, bucket_sizes=buckets)
    a, b, ops3000 = pair3000()
    assert tdp.bucket_of(max(len(a), len(b)), buckets) == 3072
    want.append(ops3000)
    got = tdp.align_fragments(rfs + [a], qfs + [b], bucket_sizes=buckets,
                              device="cpu")
    assert len(got) == len(want) == len(lens) + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fragment_aligner_results_independent_of_submit_split():
    rng = np.random.default_rng(5)
    rfs = [rng.integers(0, 4, int(n)).astype(np.uint8)
           for n in rng.integers(5, 300, 20)]
    qfs = [np.roll(r, 1) for r in rfs]
    one = tdp.align_fragments(rfs, qfs, device="cpu")
    fa = tdp.FragmentAligner(batch_cells=1 << 14, device="cpu")
    assert fa.submit(rfs[:7], qfs[:7]) == 0
    assert fa.submit(rfs[7:], qfs[7:]) == 7
    for a, b in zip(one, fa.finish()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["dp_small", "dp_any", "dp_align"])
def test_cuda_wrappers_take_plain_path_on_cpu(name):
    fn = getattr(dp_cuda, name)
    L, B = 64, 9
    q, t, ql, tl = make_batch(np.random.default_rng(11), L, B)
    before = (dp_cuda.dp_small.launches, dp_cuda.dp_any.launches)
    got = torch_ops(q, t, ql, tl, L, fn=fn)
    assert (dp_cuda.dp_small.launches, dp_cuda.dp_any.launches) == before
    np.testing.assert_array_equal(got, torch_ops(q, t, ql, tl, L))


def test_cuda_wrappers_check_inputs():
    L, B = 64, 2
    q, t, ql, tl = (torch.from_numpy(a) for a in
                    make_batch(np.random.default_rng(1), L, B))
    with pytest.raises(TypeError):
        dp_cuda.dp_small(q.to(torch.int32), t, ql, tl, L)
    with pytest.raises(TypeError):
        dp_cuda.dp_small(q, t, ql.to(torch.int64), tl, L)
    with pytest.raises(ValueError):
        dp_cuda.dp_small(q, t, ql, tl, 128)
    with pytest.raises(ValueError):
        dp_cuda.dp_any(q[:, ::2], t[:, ::2], ql, tl, 32)
    with pytest.raises(ValueError):
        dp_cuda.dp_small(torch.zeros((1, 512), dtype=torch.uint8),
                         torch.zeros((1, 512), dtype=torch.uint8),
                         ql[:1], tl[:1], 512)


def assert_strip_fill_matches_plain(host, L, strip_rows):
    """strip_fill's nibbles equal _dp_forward's on every cell, and the
    scalar backtrack over them equals _traceback's ops."""
    args = [torch.from_numpy(a) for a in host]
    nib = tdp._dp_forward(*args, L).numpy()             # [2L-1, B, L]
    ops = tdp._traceback(torch.from_numpy(nib), args[2], args[3], L).numpy()
    for b in range(len(host[2])):
        ql, tl = int(host[2][b]), int(host[3][b])
        D = strip_fill(host[0][b], host[1][b], ql, tl, strip_rows)
        i, j = np.meshgrid(np.arange(tl), np.arange(ql), indexing="ij")
        np.testing.assert_array_equal(D, nib[i + j, b, i],
                                      err_msg=f"problem {b}")
        np.testing.assert_array_equal(scalar_backtrack(D, ql, tl),
                                      strip(ops[b]), err_msg=f"problem {b}")


@pytest.mark.parametrize("L,B,strip_rows", [(64, 9, 64), (64, 9, 32),
                                            (128, 6, 64), (128, 6, 128)])
def test_strip_order_fill_matches_plain_forward(L, B, strip_rows):
    """The schedule of the CUDA kernels (columns through strips of rows)
    gives the anti-diagonal schedule's nibbles: only the two arrows and the
    cell-local borders matter."""
    assert_strip_fill_matches_plain(
        make_batch(np.random.default_rng(L + strip_rows), L, B), L,
        strip_rows)


@pytest.mark.parametrize("part", range(4))
def test_strip_order_fill_matches_plain_on_ksw2_oracle(part):
    cases, _ = load_oracle()
    assert len(cases) == 120
    host = [a[part * 30:(part + 1) * 30] for a in oracle_batch(cases, 256)]
    assert_strip_fill_matches_plain(host, 256, 64)


@pytest.mark.parametrize("L,kr,strips", [(64, 2, 1), (128, 4, 1),
                                         (256, 8, 1), (256, 4, 2),
                                         (512, 2, 8), (64, 1, 2)])
def test_dir_word_index_is_a_bijection(L, kr, strips):
    """Every cell of an L x L problem has its own nibble, and the words are
    exactly [0, L*L/8): one warp's strip (K = 2, 4, 8), chains of strips,
    and the fewer rows a lane that dp_small takes for a short target."""
    assert strips * 32 * kr == L
    i, j = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    word, nib = dp_cuda.dir_word_index(L, kr, i, j)
    assert nib.min() == 0 and nib.max() == 7
    slots = (word * 8 + nib).ravel()
    assert np.array_equal(np.sort(slots), np.arange(L * L))
    assert word.min() == 0 and word.max() == L * L // 8 - 1


def test_dir_word_index_short_target_fits_one_warp():
    """dp_small with tl <= 32 * kr rows: kr rows a lane use the first
    L/8 * kr * 32 words, each nibble once."""
    L, kr = 128, 3
    i, j = np.meshgrid(np.arange(32 * kr), np.arange(L), indexing="ij")
    word, nib = dp_cuda.dir_word_index(L, kr, i, j)
    assert len(np.unique(word * 8 + nib)) == 32 * kr * L
    assert word.max() == L // 8 * kr * 32 - 1


@pytest.mark.parametrize("name", ["dp_small", "dp_any", "dp_align"])
@pytest.mark.parametrize("L", [64, 128])
def test_edge_problems_through_the_plain_path(name, L):
    """ql = 0, tl = 0, both, one base, full width and lengths above L
    (clamped): the wrappers' CPU path against the scalar reference."""
    host = edge_batch(np.random.default_rng(L), L)
    got = torch_ops(*host, L, fn=getattr(dp_cuda, name))
    for b in range(len(host[2])):
        ql, tl = min(int(host[2][b]), L), min(int(host[3][b]), L)
        D = strip_fill(host[0][b], host[1][b], ql, tl, 32)
        want = scalar_backtrack(D, ql, tl)
        assert len(want) <= 2 * L
        np.testing.assert_array_equal(strip(got[b]), want,
                                      err_msg=f"problem {b}")


@pytest.mark.parametrize("B,L,chain_rows", [(1024, 512, 512), (3, 512, 512),
                                            (2, 5120, 5120), (16, 2048, 2048),
                                            (1, 65536, 0)])
def test_any_plan_is_launchable(B, L, chain_rows):
    """At most 8 blocks a cluster and 32 warps a block; a full batch keeps
    one block a problem; the bucket widths run in one pass."""
    K, wpb, cs = dp_cuda.any_plan(B, L)
    assert K in (2, 4, 8) and 1 <= wpb <= dp_cuda.MAX_WARPS \
        and 1 <= cs <= 8
    if B >= dp_cuda.N_SM:
        assert cs == 1
    # a card with fewer SMs never gets larger clusters
    assert dp_cuda.any_plan(B, L, 114)[2] <= cs
    assert cs * wpb * 32 * K >= chain_rows
