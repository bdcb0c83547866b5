"""The benchmark's genome generator: seeded, vectorised NumPy.

A configuration's reference genome comes from its own fixed seed, so
every run aligns against the same genome; the query genomes (mutants) come
from the run's --seed. The reference's bases are uniform random (the
configuration's "bases": "uniform_random"; no assembly is in the
repository), so it has none of a real genome's repeats. The mutation model
is the repository's own (tests/make_testdata.make_pair): per reference base
a substitution with probability sub_rate, or an indel with probability
indel_rate (half deletions, half insertions, 1..max_indel bases each), and
one inversion (reverse complement) of inversion_len bases at a third of
the first chromosome of the query.

Every mutant also returns what was planted (`Truth`): the substitutions,
insertions and deletions in reference coordinates and the inverted span.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

DNA = np.frombuffer(b"ACGT", dtype=np.uint8)
# ASCII -> 2-bit code, 4 for anything else
CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
    CODE[ord(chr(_c).lower())] = _i
COMPLEMENT = np.frombuffer(bytes(range(256)), dtype=np.uint8).copy()
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMPLEMENT[_a] = _b


def revcomp(chars: np.ndarray) -> np.ndarray:
    """Reverse complement of an ASCII array."""
    return COMPLEMENT[chars[::-1]]


@dataclasses.dataclass
class Truth:
    """What one mutant chromosome carries against its reference chromosome
    (0-based reference coordinates)."""
    snv_pos: np.ndarray        # int64 [n]
    snv_alt: np.ndarray        # uint8 ASCII [n]
    del_pos: np.ndarray        # int64 [n], first deleted base
    del_len: np.ndarray        # int64 [n]
    ins_pos: np.ndarray        # int64 [n], the bases go before this one
    ins_len: np.ndarray        # int64 [n]
    ins_off: np.ndarray        # int64 [n+1] into ins_seq
    ins_seq: np.ndarray        # uint8 ASCII
    inverted: Tuple[int, int]  # query span [lo, hi) reverse-complemented,
    inverted_ref: Tuple[int, int]   # and the reference span it came from


def reference_genome(cfg: dict) -> List[Tuple[str, np.ndarray]]:
    """[(name, ASCII uint8[])] of the configuration's reference: uniform
    random bases from its genome_seed, one record a chromosome at its stated
    length."""
    if cfg["bases"] != "uniform_random":
        raise ValueError(f"unknown bases {cfg['bases']!r}")
    rng = np.random.default_rng(int(cfg["genome_seed"]))
    return [(name, DNA[rng.integers(0, 4, int(length), dtype=np.uint8)])
            for name, length in cfg["chromosomes"]]


def _mutate(ref: np.ndarray, rng: np.random.Generator, sub_rate: float,
            indel_rate: float, max_indel: int):
    """(mutant ASCII, Truth without the inversion) of one chromosome. An
    event falling inside an earlier deletion is dropped."""
    n = ref.shape[0]
    rate = sub_rate + indel_rate
    # event positions: geometric gaps between events, as a Bernoulli draw
    # at every base would give them
    gaps = rng.geometric(rate, size=int(n * rate * 1.1) + 64)
    ev = np.cumsum(gaps) - 1
    while ev[-1] < n:
        more = rng.geometric(rate, size=int(n * rate * 0.1) + 64)
        ev = np.concatenate([ev, ev[-1] + np.cumsum(more)])
    ev = ev[ev < n]
    u = rng.random(ev.shape[0]) * rate
    kind = np.where(u < sub_rate, 0,
                    np.where(u < sub_rate + indel_rate / 2, 1, 2))
    ln = rng.integers(1, max_indel + 1, ev.shape[0])
    # drop events inside a deletion that starts before them
    dend = np.where(kind == 1, ev + ln, 0)
    prev_end = np.maximum.accumulate(np.concatenate([[0], dend[:-1]]))
    keep = ev >= prev_end
    ev, kind, ln = ev[keep], kind[keep], ln[keep]
    # the remaining deletions may still run past the chromosome's end
    is_del = kind == 1
    ln = np.where(is_del, np.minimum(ln, n - ev), ln)

    out = ref.copy()
    sub = ev[kind == 0]
    shift = rng.integers(1, 4, sub.shape[0], dtype=np.uint8)
    alt = DNA[(CODE[out[sub]] + shift) % 4]
    out[sub] = alt

    dpos, dlen = ev[is_del], ln[is_del]
    alive = np.ones(n, dtype=bool)
    if dpos.size:
        idx = np.repeat(dpos, dlen) + (
            np.arange(int(dlen.sum())) - np.repeat(np.cumsum(dlen) - dlen,
                                                   dlen))
        alive[idx] = False
    ipos, ilen = ev[kind == 2], ln[kind == 2]
    iseq = DNA[rng.integers(0, 4, int(ilen.sum()), dtype=np.uint8)]
    # insertion points in the coordinates of the kept bases: no insertion
    # lies inside a deletion, so the bases deleted before it are whole
    # deletions
    dsum = np.concatenate([[0], np.cumsum(dlen)])
    where = ipos - dsum[np.searchsorted(dpos, ipos)]
    mutant = np.insert(out[alive], np.repeat(where, ilen), iseq)
    ioff = np.concatenate([[0], np.cumsum(ilen)]).astype(np.int64)
    return mutant, dict(snv_pos=sub.astype(np.int64), snv_alt=alt,
                        del_pos=dpos.astype(np.int64),
                        del_len=dlen.astype(np.int64),
                        ins_pos=ipos.astype(np.int64),
                        ins_len=ilen.astype(np.int64), ins_off=ioff,
                        ins_seq=iseq)


def mutant(cfg: dict, reference, seed: int):
    """([(name, ASCII uint8[])], [Truth]) of one query genome drawn from
    `seed`: every chromosome mutated by the configuration's model, the
    first one also inverted over inversion_len bases at a third of its
    length (where it is longer than four times that)."""
    m = cfg["mutation"]
    rng = np.random.default_rng(seed)
    records, truths = [], []
    for ci, (name, ref) in enumerate(reference):
        q, t = _mutate(ref, rng, float(m["sub_rate"]),
                       float(m["indel_rate"]), int(m["max_indel"]))
        inv = (0, 0)
        inv_ref = (0, 0)
        span = int(m["inversion_len"])
        if ci == int(m["inversion_chromosome"]) and q.shape[0] > 4 * span:
            lo = q.shape[0] // 3
            inv = (lo, lo + span)
            q = np.concatenate([q[:lo], revcomp(q[lo:lo + span]),
                                q[lo + span:]])
            inv_ref = _ref_span(t, ref.shape[0], inv)
        records.append((name + "m", q))
        truths.append(Truth(inverted=inv, inverted_ref=inv_ref, **t))
    return records, truths


def _ref_span(t: dict, n: int, qspan) -> Tuple[int, int]:
    """The reference span [lo, hi) that a query span came from (to the
    nearest base; inserted bases map to the base they precede)."""
    ref_of = query_to_ref(t, n)
    return int(ref_of[qspan[0]]), int(ref_of[qspan[1] - 1]) + 1


def query_to_ref(t: dict, n: int) -> np.ndarray:
    """For every base of the (uninverted) mutant, the reference base it
    stands for: a kept base its own position, an inserted base the position
    of the base it precedes. t: what _mutate planted."""
    alive = np.ones(n, dtype=bool)
    dpos, dlen = t["del_pos"], t["del_len"]
    if dpos.size:
        idx = np.repeat(dpos, dlen) + (
            np.arange(int(dlen.sum())) - np.repeat(np.cumsum(dlen) - dlen,
                                                   dlen))
        alive[idx] = False
    kept = np.flatnonzero(alive)
    where = np.cumsum(alive) - alive
    ipos, ilen = t["ins_pos"], t["ins_len"]
    return np.insert(kept, np.repeat(where[ipos], ilen),
                     np.repeat(ipos, ilen))
