"""The port's exp_sweep loops (gsalign_tpu_torch/ops/probe.py
gather_sweep_plain, what the gather_sweep kernel is held against on a card)
against the JAX tool tools/exp_sweep.py's loops on the CPU, on 64 Ki-word
tables of arange int32: the one-table loop (:43-50) at the tool's three
B, and the two-table split (:59-67) at its B of 4,096, K 300 each, the
tool's start indices. The last index and the sum are equal, exactly.

On these power-of-two tables the one-table walk is not random for long:
the table holds its indices, so the next index is 6 idx mod 2^m, which is
0 after at most m steps; from there every lane reads word 0. The
two-table walk (7 idx mod the half) stays spread. The port keeps the
tool's grid as it is; PERF.md reads the random-read rate off the
two-table rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsalign_tpu_torch.ops import probe
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

K = 300
N = 1 << 16          # 64 Ki int32 words: a 256 KB table


def jax_sweep(table_np, B, two):
    """The JAX tool's loop (or its two-table split) over table_np, as
    tools/exp_sweep.py writes it; returns (acc, last index)."""
    i32 = jnp.int32
    table = jnp.asarray(table_np)
    if two:
        n = table.shape[0] // 2
        ta, tb = table[:n], table[n:]
    else:
        n = table.shape[0]
    idx0 = jnp.asarray((np.arange(B) * 2654435761) % n, i32)

    @jax.jit
    def loop(idx):
        def body(s):
            k, idx, acc = s
            v = ta[idx] + tb[idx] if two else table[idx]
            return (k + 1, (idx * 5 + v) % n, acc + v)
        return jax.lax.while_loop(lambda s: s[0] < K, body,
                                  (jnp.zeros((), i32), idx,
                                   jnp.zeros(B, i32)))
    _, idx, acc = loop(idx0)
    return np.asarray(acc), np.asarray(idx)


@pytest.mark.parametrize("B,two", [(512, False), (4096, False),
                                   (16384, False), (4096, True)],
                         ids=["one-512", "one-4096", "one-16384", "two-4096"])
def test_gather_sweep_equals_the_jax_tool(B, two):
    table = np.arange(N, dtype=np.int32)
    want_acc, want_idx = jax_sweep(table, B, two)
    t = torch.from_numpy(table)
    n = N // 2 if two else N
    ta, tb = (t[:n], t[n:]) if two else (t, None)
    idx0 = probe.sweep_start(B, n)
    acc, idx = probe.gather_sweep(ta, tb, idx0, K, n)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    if two:
        # 7 idx + half mod half: an odd multiplier, the lanes stay apart
        assert len(np.unique(want_idx)) > B // 4
    else:
        # v = idx on an arange table: idx becomes 6 idx mod 2^16, which
        # reaches 0 within 16 steps, so after them every lane reads word 0
        assert not want_idx.any()


def test_gather_sweep_refuses_bad_starts():
    t = torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[0, n\)"):
        probe.gather_sweep(t, None, torch.tensor([16], dtype=torch.int32),
                           3, 16)


def test_the_tool_prints_the_jax_lines(capsys):
    """exp_sweep on the CPU at one small table: the JAX tool's four lines
    and one JSON line."""
    import json
    import re

    from gsalign_tpu_torch.tools import exp_sweep
    assert exp_sweep.main(["--mb", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for ln, B in zip(lines[:3], exp_sweep.GRID_B):
        assert re.match(rf"table=    1MB B=\s*{B} one-call: \s*[\d.]+ "
                        rf"us/iter$", ln), ln
    assert re.match(r"table=    1MB B=4096   two-call: \s*[\d.]+ us/iter$",
                    lines[3])
    out = json.loads(lines[4])
    assert [r["form"] for r in out["rows"]] == ["one-call"] * 3 + ["two-call"]
