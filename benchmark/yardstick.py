"""Frozen yardsticks: the peaks of one H100 and the work of the kernels.

Copied from chip_smoke.py (PEAK_BYTES_PER_S and PEAK_INT_OPS_PER_S at
chip_smoke.py:198-199, DP_OPS_PER_CELL :203, bound :216) so that a change
to the program cannot move them.

Caveats. The integer rate is derived, not published: 67 TFLOP/s of
float32 outside the tensor cores (NVIDIA's data sheet, SXM, 700 W) is
33.5 T lane instructions a second, and an SM has half as many int32 lanes,
so 16.75 T int32 operations/s. The bytes bound divides by 3.35 TB/s, which
dependent random reads never reach: 4,096 lanes reach 8-10 G random 4-byte
reads/s from HBM (0.26-0.32 TB/s of 32-byte sectors), so a bound by bytes
is about ten times too low for the seed scan.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 16.75e12
# integer operations of one DP cell (csrc/dp.cu's inner loop: 6 for the
# score, 10 for z and its direction, 7 for u, v, x, y, 7 for the
# continuation bits and the nibble store)
DP_OPS_PER_CELL = 30


def bound(n_bytes: float, n_ops: float) -> dict:
    """{bound_ms, bound_by} of work that must move n_bytes and do n_ops
    integer operations."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_INT_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def dp_bound_s(cells: int) -> float:
    """The least seconds of `cells` DP cells: their operations over the
    integer peak (the bytes, 4 a cell's row and column at most, bound
    far less)."""
    return bound(0.0, cells * DP_OPS_PER_CELL)["bound_ms"] / 1e3

