"""The PyTorch port's entry() (gsalign_tpu_torch/entry.py) against the
JAX package's (__graft_entry__.entry): the same inputs, and on the CPU op
codes equal to gsalign_tpu.ops.dp.dp_align_batch's after OP_PAD is
stripped (exact). On the card the same holds against the plain DP
(test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsalign_tpu.ops import dp as jdp
from gsalign_tpu_torch import entry as tentry
from gsalign_tpu_torch.ops import dp as tdp
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def strip(row):
    return row[row != tdp.OP_PAD]


def test_inputs_equal_the_jax_entry():
    import __graft_entry__
    _, jargs = __graft_entry__.entry()
    fn, targs = tentry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in targs)
    for j, t in zip(jargs, targs):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert targs[0].shape == (tentry.B, tentry.L)
    assert targs[0].dtype == torch.uint8 and targs[2].dtype == torch.int32


def test_ops_equal_jax_dp_align_batch():
    fn, args = tentry.entry(device="cpu")
    got = fn(*args).numpy()
    q, t, ql, tl = (jnp.asarray(a.numpy().astype(np.int32)) for a in args)
    want = np.asarray(jdp.dp_align_batch(q, t, ql, tl, tentry.L))
    assert got.shape == (tentry.B, 2 * tentry.L)
    for i in range(tentry.B):
        np.testing.assert_array_equal(strip(got[i]), strip(want[i]),
                                      err_msg=f"problem {i}")


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
