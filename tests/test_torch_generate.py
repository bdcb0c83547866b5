"""The port's count_identical, fragpair_mismatch and generate_alignments
(gsalign_tpu_torch/pipeline/generate.py) against the JAX package's
(gsalign_tpu/pipeline/generate.py:29-43, :198-215) on the CPU: the same
counts, and over hand-made blocks whose gap pairs take every class (pure
insertions and deletions, equal-length pairs with few and with many
mismatches, unequal lengths for the DP, query Ns) the same aligned rows,
scores and lengths; the port's DP goes through ops/dp.FragmentAligner on
the CPU, where it runs the plain version. Exact."""

import numpy as np
import pytest

from gsalign_tpu.config import AlignConfig as JConfig
from gsalign_tpu.pipeline import chain as jchain
from gsalign_tpu.pipeline import generate as jgen
from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.pipeline import chain as tchain
from gsalign_tpu_torch.pipeline import generate as tgen
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def chars(rng, n):
    return ACGT[rng.integers(0, 4, n)]


def test_counts_equal_the_jax_package():
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGTNacgtn-", dtype=np.uint8)
    for _ in range(20):
        n = int(rng.integers(0, 300))
        a1, a2 = (alphabet[rng.integers(0, len(alphabet), n)]
                  for _ in range(2))
        assert tgen.count_identical(a1, a2) == jgen.count_identical(a1, a2)
        ref = alphabet[rng.integers(0, len(alphabet), 400)]
        qry = alphabet[rng.integers(0, len(alphabet), 400)]
        r, q = int(rng.integers(0, 100)), int(rng.integers(0, 100))
        ln = int(rng.integers(0, 300))
        assert tgen.fragpair_mismatch(ref, qry, r, q, ln) \
            == jgen.fragpair_mismatch(ref, qry, r, q, ln)


def blocks_case(seed):
    """(ref chars, query chars, rows): blocks of seeds and the gap pairs
    between them; each row (q_pos, r_pos, q_len, r_len, is_seed)."""
    rng = np.random.default_rng(seed)
    ref = chars(rng, 40_000)
    qry = [ref[:200]]
    rows, blocks = [], []
    q, r = 200, 200
    kinds = ["ins", "del", "eq_few", "eq_many", "dp", "dp", "eq_n"]
    for b in range(3):
        rows = []
        for j in range(12):
            L = int(rng.integers(20, 60))                 # a seed
            qry.append(ref[r:r + L])
            rows.append((q, r, L, L, True))
            q, r = q + L, r + L
            kind = kinds[(b * 12 + j) % len(kinds)]
            if kind == "ins":
                n = int(rng.integers(1, 12))
                qry.append(chars(rng, n))
                rows.append((q, r, n, 0, False))
                q += n
            elif kind == "del":
                n = int(rng.integers(1, 12))
                rows.append((q, r, 0, n, False))
                r += n
            elif kind in ("eq_few", "eq_many", "eq_n"):
                n = int(rng.integers(10, 200))
                seg = ref[r:r + n].copy()
                k = 3 if kind == "eq_few" else n // 3
                at = rng.integers(0, n, k)
                seg[at] = ACGT[(np.searchsorted(ACGT, seg[at]) + 1) % 4]
                if kind == "eq_n":
                    seg[at[:5]] = ord("N")
                qry.append(seg)
                rows.append((q, r, n, n, False))
                q, r = q + n, r + n
            else:
                nq, nr = int(rng.integers(30, 700)), int(rng.integers(30, 700))
                qry.append(np.concatenate([ref[r:r + nr // 2],
                                           chars(rng, nq - nr // 2)])
                           if nq > nr // 2 else ref[r:r + nq])
                rows.append((q, r, nq, nr, False))
                q, r = q + nq, r + nr
        L = int(rng.integers(20, 60))
        qry.append(ref[r:r + L])
        rows.append((q, r, L, L, True))
        q, r = q + L + 500, r + L + 500
        qry.append(ref[r - 500:r])
        blocks.append(rows)
    return ref, np.concatenate(qry), blocks


def make_blocks(pkg_chain, rows_list):
    out = []
    for rows in rows_list:
        a = np.asarray(rows, dtype=np.int64)
        seeds = a[:, 4].astype(bool)
        out.append(pkg_chain.Block(
            q_pos=a[:, 0].copy(), r_pos=a[:, 1].copy(), q_len=a[:, 2].copy(),
            r_len=a[:, 3].copy(), b_seed=seeds,
            score=int(a[seeds, 2].sum()), aln1=[None] * len(a),
            aln2=[None] * len(a)))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_generate_alignments_equals_the_jax_package(seed):
    ref, qry, rows = blocks_case(seed)
    want = make_blocks(jchain, rows)
    got = make_blocks(tchain, rows)
    jgen.generate_alignments(want, qry, ref, JConfig())
    tgen.generate_alignments(got, qry, ref, AlignConfig(), device="cpu")
    n_dp = 0
    for a, b in zip(want, got):
        assert (a.score, a.aln_len) == (b.score, b.aln_len)
        for x1, x2, y1, y2 in zip(a.aln1, a.aln2, b.aln1, b.aln2):
            assert (x1 is None) == (y1 is None)
            if x1 is not None:
                n_dp += 1
                assert bytes(x1) == bytes(y1) and bytes(x2) == bytes(y2)
    assert n_dp > 0
