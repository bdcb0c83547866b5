"""masked_gather, the port of the JAX package's Pallas masked_row_gather
(gsalign_tpu/ops/gather_pallas.py), against that kernel run in interpret
mode on the CPU. int32 words: every comparison is exact."""

import numpy as np
import pytest
import torch

from gsalign_tpu.ops import gather_pallas
from gsalign_tpu_torch.ops import gather
from gsalign_tpu_torch.ops.rank import SA_ROW_BLOCK
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def padded_table(rng, n):
    """n random int32 words, zero-padded to SA_ROW_BLOCK as ops/rank pads
    sa_rows."""
    t = np.zeros(-(-n // SA_ROW_BLOCK) * SA_ROW_BLOCK, dtype=np.int32)
    t[:n] = rng.integers(0, 2 ** 31 - 1, n, dtype=np.int32)
    return t


def indices(rng, n, K):
    """K indices into [0, n), about a third of them -1."""
    idx = rng.integers(0, n, K).astype(np.int32)
    idx[rng.random(K) < 1 / 3] = -1
    return idx


@pytest.mark.parametrize("K", [8, 64, 512])
@pytest.mark.parametrize("n", [4096, 3000])
def test_masked_gather_matches_pallas_interpret(n, K):
    rng = np.random.default_rng(n + K)
    table = padded_table(rng, n)
    idx = indices(rng, n, K)
    want = np.asarray(gather_pallas.masked_row_gather(table, idx,
                                                      interpret=True))
    got = gather.masked_gather(torch.from_numpy(table),
                               torch.from_numpy(idx)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[idx < 0] == 0).all()


def test_masked_gather_probe_case():
    """The JAX package's probe() input, with its expected output."""
    table = torch.arange(4096, dtype=torch.int32)
    ix = [5, -1, 4000, 7, -1, 0, 1023, 1024]
    want = np.asarray(gather_pallas.masked_row_gather(
        table.numpy(), np.asarray(ix, np.int32), interpret=True))
    got = gather.masked_gather(table, torch.tensor(ix, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [5, 0, 4000, 7, 0, 0, 1023, 1024]


@pytest.mark.parametrize("n,K", [(3000, 5), (1, 1), (17, 0)])
def test_masked_gather_needs_no_tpu_block_shapes(n, K):
    """Neither K % 8 == 0 nor a 1024-padded table is required."""
    rng = np.random.default_rng(K)
    table = rng.integers(-5, 5, n).astype(np.int32)
    idx = indices(rng, n, K)
    got = gather.masked_gather(torch.from_numpy(table),
                               torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.where(idx >= 0, table[idx], 0))


def test_masked_gather_checks_inputs_and_counts_no_cpu_launch():
    t = torch.zeros(16, dtype=torch.int32)
    i = torch.zeros(4, dtype=torch.int32)
    before = gather.masked_gather.launches
    gather.masked_gather(t, i)
    assert gather.masked_gather.launches == before
    with pytest.raises(TypeError):
        gather.masked_gather(t.long(), i)
    with pytest.raises(TypeError):
        gather.masked_gather(t, i.long())
    with pytest.raises(ValueError):
        gather.masked_gather(t.view(4, 4), i)
    with pytest.raises(ValueError):
        gather.masked_gather(t, torch.zeros(8, dtype=torch.int32)[::2])
