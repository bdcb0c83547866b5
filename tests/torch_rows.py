"""Synthetic t3 rows for the PyTorch port's tests (imports no JAX, so the
card's tests can use it too)."""

import numpy as np

from gsalign_tpu_torch.ops.rank import T3_ROW_WIDE


def carry_rows(rng, n_rows: int) -> np.ndarray:
    """Synthetic wide t3 rows: low checkpoint words within 2^20 of 2^32,
    every carry field 1 to 3, symbol bytes below 64."""
    rows = np.empty((n_rows, T3_ROW_WIDE), dtype=np.uint32)
    rows[:, :64] = (2 ** 32 - rng.integers(1, 2 ** 20, (n_rows, 64))
                    ).astype(np.uint32)
    fields = rng.integers(1, 4, (n_rows, 4, 16)).astype(np.uint32)
    rows[:, 64:68] = np.bitwise_or.reduce(
        fields << (2 * np.arange(16, dtype=np.uint32)), axis=2)
    syms = rng.integers(0, 64, (n_rows, 32, 4)).astype(np.uint32)
    rows[:, 68:] = np.bitwise_or.reduce(
        syms << (8 * np.arange(3, -1, -1, dtype=np.uint32)), axis=2)
    return rows
