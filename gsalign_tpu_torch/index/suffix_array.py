"""Suffix array construction: the native O(n) SA-IS (the package's
native/sais.cpp, through native_lib), prefix doubling in torch on a
device, and prefix doubling in numpy, tried in that order
(build_suffix_array).

Prefix doubling replaces the reference's incremental BWT-SW construction +
Larsson-Sadakane sorter (src/BWT_Index/bwt_gen.c, src/BWT_Index/QSufSort.c):
O(log n) rounds of (sort by (rank, rank[i+h]), re-rank), each round one
large sort plus elementwise scans.

The returned suffix array is over T$ (text plus a unique smallest sentinel):
sa[0] == n always, and sa has n+1 entries.
"""

from __future__ import annotations

import numpy as np

from gsalign_tpu_torch.utils.device import resolve_device


def _initial_rank_np(t: np.ndarray, k: int = 8) -> np.ndarray:
    """Rank of the k-gram starting at each position (3 bits per symbol)."""
    n = t.shape[0]
    key = np.zeros(n, dtype=np.int64)
    for j in range(min(k, n)):
        shifted = np.zeros(n, dtype=np.int64)
        shifted[: n - j] = t[j:]
        key = (key << 3) | shifted
    order = np.argsort(key, kind="stable")
    ks = key[order]
    neq = np.zeros(n, dtype=np.int64)
    neq[1:] = ks[1:] != ks[:-1]
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.cumsum(neq)
    return rank


def build_suffix_array_np(codes: np.ndarray) -> np.ndarray:
    """Numpy prefix-doubling suffix array of codes+sentinel. Returns int64[n+1]."""
    n = int(codes.shape[0]) + 1
    t = np.zeros(n, dtype=np.int64)
    t[:-1] = codes.astype(np.int64) + 1
    rank = _initial_rank_np(t, k=8)
    h = 8
    order = np.argsort(rank, kind="stable")
    while rank[order[-1]] != n - 1:
        key2 = np.zeros(n, dtype=np.int64)
        key2[: n - h] = rank[h:]
        order = np.lexsort((key2, rank))
        r_s, k_s = rank[order], key2[order]
        neq = np.zeros(n, dtype=np.int64)
        neq[1:] = (r_s[1:] != r_s[:-1]) | (k_s[1:] != k_s[:-1])
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.cumsum(neq)
        h *= 2
    return order.astype(np.int64)


def build_suffix_array_torch(codes: np.ndarray, device=None) -> np.ndarray:
    """Prefix-doubling suffix array of codes+sentinel in torch on `device`
    (None: the CUDA card, an error without one; "cpu": the CPU). Returns
    int64[n+1] on the host.

    The JAX package's build_suffix_array_jax: an 8-symbol initial key
    ((key << 3) | t[j]), then rounds that sort combined = rank * (n + 1) +
    rank[i + h] (int64) and re-rank by a cumulative sum of inequalities,
    until the largest rank is n - 1; the loop runs on the host, one
    read-back a round. Ties among equal keys get equal ranks whatever
    their order, so the sort need not be stable. combined fits in int64
    only while n + 1 < 2^31: larger texts raise NotImplementedError.
    """
    import torch
    n = int(codes.shape[0]) + 1
    if n >= (1 << 31):
        raise NotImplementedError("single-device SA build limited to n < 2^31")
    dev = resolve_device(device)
    t = torch.zeros(n, dtype=torch.int64, device=dev)
    t[:-1] = torch.from_numpy(np.ascontiguousarray(codes)).to(dev) + 1
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(min(8, n)):
        shifted = torch.zeros(n, dtype=torch.int64, device=dev)
        shifted[: n - j] = t[j:]
        key = (key << 3) | shifted
    del t, shifted

    def rerank(keys):
        """(order, rank) of `keys`: the sort order and each position's
        count of distinct smaller keys."""
        ks, order = torch.sort(keys)
        neq = torch.zeros(n, dtype=torch.int64, device=dev)
        neq[1:] = ks[1:] != ks[:-1]
        rank = torch.empty(n, dtype=torch.int64, device=dev)
        rank[order] = torch.cumsum(neq, 0)
        return order, rank

    order, rank = rerank(key)
    del key
    h = 8
    while int(rank[order[-1]]) != n - 1:
        key2 = torch.zeros(n, dtype=torch.int64, device=dev)
        key2[: n - h] = rank[h:]
        order, rank = rerank(rank * (n + 1) + key2)
        h *= 2
    return order.cpu().numpy()


def build_suffix_array_native(codes: np.ndarray, wide: bool = False):
    """O(n) SA-IS via the native library (native/sais.cpp), read straight
    from `codes` (the +1 and the sentinel are the library's): the build
    holds the SA, the codes and one byte of types a row. int32 below 2^31
    rows, else int64; `wide` forces int64. None if the library cannot be
    built (it needs g++)."""
    from gsalign_tpu_torch import native_lib
    return native_lib.sais_codes(codes, wide=wide)


def build_suffix_array(codes: np.ndarray, prefer_device: bool = True,
                       wide: bool = False) -> np.ndarray:
    """Preference order: native SA-IS (fastest, O(n), any size; an int64
    SA for a wide index, else int32 below 2^31 rows) -> torch prefix
    doubling on the CUDA card (only with prefer_device, from 2^16 symbols
    on, below 2^31; an error without a card) -> numpy prefix doubling."""
    sa = (build_suffix_array_native(codes, wide=True) if wide
          else build_suffix_array_native(codes))
    if sa is not None:
        return sa
    if prefer_device and codes.shape[0] >= (1 << 16):
        try:
            return build_suffix_array_torch(codes)
        except NotImplementedError:
            pass
    return build_suffix_array_np(codes)
