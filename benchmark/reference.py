"""The plain reference that decides `correct`: NumPy and plain PyTorch.

It imports nothing of the program. It reads the genomes that the
benchmark generated (gen.py) and the program's answers for a pair: the MAF
and VCF text, and the seed scan's records. Each check works out again what
the program derived and counts the answers that disagree:

  maf_bad      MAF blocks that are malformed, whose rows are not the
               reference and the query (or its reverse complement) at the
               stated coordinates, whose score is not the count of
               matching columns, or whose identity is under -idy.
  dp_subopt    gapped windows of the alignments (maximal stretches between
               runs of at least min_seed_length matching columns that hold
               a gap) whose score under GSAlign's ksw2 scoring (match 1,
               mismatch -1, a gap of k bases -(2 + k); src/GSAlign.cpp's
               ksw_extz2_sse call) is below the optimum of a plain global
               affine-gap alignment of the same bases. A window lies inside
               one gap between two seeds, where the aligner's DP is global,
               so an optimal DP gives the optimum there. Under -sen a seed
               cut under min_seed_length by overlap removal stays an anchor
               inside a window; so in sensitive mode a window below the
               optimum is judged through its anchors (`anchor_runs`): the
               runs of matching columns of its alignment on a diagonal other
               than the flanking runs' own that lie in an exact common run
               of at least min_seed_length bases (with min_seed_length - 1
               bases of flank on each side), where a seed of the program's
               kind lies. Its score must then equal the optimum through
               them: the pieces between them aligned optimally, plus their
               matches. A window without such runs is held to the plain
               optimum.
  dp_anchored  (printed, not compared) the windows below the plain optimum
               that equal the optimum through their anchors.
  vcf_bad      the VCF against the variants the MAF blocks imply (every
               mismatching column a substitution; every gap run an insertion
               or deletion at the base before it), as multisets of
               (chromosome, position, kind, allele): records missing, extra,
               or malformed.
  seed_bad     the seed records of sampled lanes against a plain scan of the
               same lane (IdentifyLocalMEM, src/GSAlign.cpp:51-107): from
               the lane's cursor, the longest prefix of the query that occurs
               in the forward + reverse-complement text, clipped at the
               lane's end; a hit when it is at least min_seed_length long
               and occurs 1 to max_seed_freq times, after which the cursor
               moves past it (+len+1, or +5 in sensitive mode), else by one.
               Differences in (start, length, occurrences) and, for a record
               that carries its position, the position.
  snv_missed   planted substitutions at least 50 bases from any other
               planted variant, from a chromosome's ends and from the
               inverted span, that the VCF does not report; those inside
               the reference span of a window counted in dp_anchored are
               not judged (its alignment is the one through its anchors),
               and are counted as snv_anchored (printed, not compared).

Each number compared is a count of disagreements, with the limit 0.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List

import numpy as np

from gen import revcomp

GAP = ord("-")
# ksw2 scoring of GSAlign's gap DP (match, mismatch, gap open, extend)
MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = 1, -1, 2, 1


@dataclasses.dataclass
class MafBlock:
    score: int
    ref: str
    r_start: int
    r_size: int
    r_src: int
    r_row: np.ndarray
    qry: str
    q_start: int
    q_size: int
    q_src: int
    q_row: np.ndarray
    reverse: bool = False


def parse_maf(data: bytes):
    """([MafBlock], malformed count) of a MAF file's bytes."""
    blocks, bad = [], 0
    lines = data.split(b"\n")
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if not line.startswith(b"a "):
            if line and not line.startswith(b"#"):
                bad += 1
            i += 1
            continue
        try:
            score = int(line.split(b"score=")[1])
            r = lines[i + 1].split()
            q = lines[i + 2].split()
            if r[0] != b"s" or q[0] != b"s" or len(r) != 7 or len(q) != 7 \
                    or r[4] != b"+" or q[4] != b"+" \
                    or not r[1].startswith(b"ref.") \
                    or not q[1].startswith(b"qry."):
                raise ValueError
            blocks.append(MafBlock(
                score, r[1][4:].decode(), int(r[2]), int(r[3]), int(r[5]),
                np.frombuffer(r[6], dtype=np.uint8),
                q[1][4:].decode(), int(q[2]), int(q[3]), int(q[5]),
                np.frombuffer(q[6], dtype=np.uint8)))
        except (IndexError, ValueError):
            bad += 1
        i += 3
    return blocks, bad


def check_maf(blocks: List[MafBlock], ref: Dict[str, np.ndarray],
              qry: Dict[str, np.ndarray], min_idy: int) -> int:
    """Blocks at fault (module docstring); sets each block's `reverse`."""
    bad = 0
    for b in blocks:
        r, q = ref.get(b.ref), qry.get(b.qry)
        a1, a2 = b.r_row, b.q_row
        ok = (r is not None and q is not None and len(a1) == len(a2)
              and b.r_src == len(r) and b.q_src == len(q)
              and not ((a1 == GAP) & (a2 == GAP)).any())
        if ok:
            g1, g2 = a1[a1 != GAP], a2[a2 != GAP]
            ok = (len(g1) == b.r_size and len(g2) == b.q_size
                  and np.array_equal(g1, r[b.r_start:b.r_start + b.r_size]))
        if ok:
            if np.array_equal(g2, q[b.q_start:b.q_start + b.q_size]):
                b.reverse = False
            else:
                rq = revcomp(q)
                b.reverse = True
                ok = np.array_equal(g2, rq[b.q_start:b.q_start + b.q_size])
        if ok:
            matches = int(((a1 == a2) & (a1 != GAP)).sum())
            ok = b.score in (matches, 1) and \
                int(100 * (matches / len(a1))) >= min_idy
        bad += not ok
    return bad


def _runs(mask: np.ndarray):
    """(starts, ends) of the runs of True in a boolean array."""
    d = np.diff(np.concatenate([[0], mask.view(np.int8), [0]]))
    return np.flatnonzero(d == 1), np.flatnonzero(d == -1)


def _segments(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The indices of the ranges [lo, hi), back to back."""
    lens = hi - lo
    return np.repeat(lo - np.cumsum(lens) + lens, lens) + \
        np.arange(int(lens.sum()))


def gapped_windows(b: MafBlock, anchor: int):
    """(ref bases, query bases, the program's score, first column, end
    column) of every window of a block: a maximal stretch of columns
    between two runs of at least `anchor` matching columns, holding a
    gap."""
    a1, a2 = b.r_row, b.q_row
    s, e = _runs((a1 == a2) & (a1 != GAP))
    long_ = (e - s) >= anchor
    lo, hi = e[long_][:-1], s[long_][1:]
    gap_cols = np.flatnonzero((a1 == GAP) | (a2 == GAP))
    keep = np.searchsorted(gap_cols, hi) > np.searchsorted(gap_cols, lo)
    lo, hi = lo[keep], hi[keep]
    if not lo.size:
        return []
    cols = _segments(lo, hi)
    c1, c2 = a1[cols], a2[cols]
    h1, h2 = c1 == GAP, c2 == GAP
    first = np.zeros(cols.shape[0], dtype=bool)
    starts = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    first[starts] = True
    # a column's score: +-1 for two bases, -1 for a gap base, -2 more
    # where a gap run opens (the column before a window is a match)
    col = np.where(~h1 & ~h2, np.where(c1 == c2, MATCH, MISMATCH), 0)
    for h in (h1, h2):
        opens = h & (first | ~np.concatenate([[False], h[:-1]]))
        col = col - h * GAP_EXTEND - opens * GAP_OPEN
    scores = np.add.reduceat(col, starts)
    ends = np.concatenate([starts[1:], [cols.shape[0]]])
    return [(c1[x:y][~h1[x:y]], c2[x:y][~h2[x:y]], int(sc), int(c0), int(c))
            for x, y, sc, c0, c in zip(starts, ends, scores, lo, hi)]


def optimal_scores(pairs) -> np.ndarray:
    """Global affine-gap optimum (ksw2 scoring) of each (ref, query) pair,
    batched over pairs of one padded size: Gotoh's recurrence row by row,
    the horizontal gaps of a row by a running maximum."""
    out = np.zeros(len(pairs), dtype=np.int64)
    if not pairs:
        return out
    lens = np.array([(len(a), len(b)) for a, b in pairs])
    size = np.maximum(lens.max(1), 1)
    bucket = 1 << np.ceil(np.log2(size)).astype(np.int64)
    qe = GAP_OPEN + GAP_EXTEND
    neg = -(1 << 40)
    for L in np.unique(bucket):
        idx = np.flatnonzero(bucket == L)
        B = len(idx)
        n, m = lens[idx, 0], lens[idx, 1]
        A = np.full((B, L), 250, dtype=np.uint8)
        C = np.full((B, L), 251, dtype=np.uint8)
        for k, i in enumerate(idx):
            A[k, :n[k]] = pairs[i][0]
            C[k, :m[k]] = pairs[i][1]
        j = np.arange(L + 1)
        H = np.where(j == 0, 0, -(GAP_OPEN + j * GAP_EXTEND))[None, :] \
            .repeat(B, 0).astype(np.int64)
        F = np.full((B, L + 1), neg, dtype=np.int64)
        best = np.where(n == 0, H[np.arange(B), m], 0)
        for i in range(1, int(n.max()) + 1):
            s = np.where(A[:, i - 1:i] == C, MATCH, MISMATCH)
            F = np.maximum(H - qe, F - GAP_EXTEND)
            hd = np.empty_like(H)
            hd[:, 0] = -(GAP_OPEN + i * GAP_EXTEND)
            hd[:, 1:] = np.maximum(H[:, :-1] + s, F[:, 1:])
            # E[j] = max over k < j of hd[k] - q - (j - k) e
            run = np.maximum.accumulate(hd + j * GAP_EXTEND, axis=1)
            E = np.full_like(H, neg)
            E[:, 1:] = run[:, :-1] - GAP_OPEN - j[1:] * GAP_EXTEND
            F[:, 0] = neg
            H = np.maximum(hd, E)
            H[:, 0] = hd[:, 0]
            hit = n == i
            best[hit] = H[np.flatnonzero(hit), m[hit]]
        out[idx] = best
    return out


def anchor_runs(b: MafBlock, lo: int, hi: int, k: int) -> list:
    """The anchors of the window of columns [lo, hi) of a block: each run
    of matching columns in it on a diagonal other than the flanking runs'
    own (0 and the right flank's) that lies in an exact common run of at
    least k bases of the window's reference and query bases with k - 1
    bases of flank on each side (the flanking runs' matching columns), as
    (reference offset, query offset, length) from the window's start, in
    order."""
    a1, a2 = b.r_row, b.q_row
    f1, f2 = a1[lo - (k - 1):hi + (k - 1)], a2[lo - (k - 1):hi + (k - 1)]
    r, q = f1[f1 != GAP], f2[f2 != GAP]
    c1, c2 = a1[lo:hi], a2[lo:hi]
    # reference and query offsets of each column within the window
    ro = np.cumsum(c1 != GAP) - (c1 != GAP)
    qo = np.cumsum(c2 != GAP) - (c2 != GAP)
    right = len(q) - len(r)
    out = []
    for s, e in zip(*_runs((c1 == c2) & (c1 != GAP))):
        ri, qi, n = int(ro[s]), int(qo[s]), int(e - s)
        if qi - ri in (0, right):
            continue
        i, j = ri + k - 1, qi + k - 1
        while i > 0 and j > 0 and r[i - 1] == q[j - 1]:
            i, j = i - 1, j - 1
        end_i, end_j = ri + n + k - 1, qi + n + k - 1
        while end_i < len(r) and end_j < len(q) and r[end_i] == q[end_j]:
            end_i, end_j = end_i + 1, end_j + 1
        if end_i - i >= k:
            out.append((ri, qi, n))
    return out


def check_dp(blocks: List[MafBlock], anchor: int, sensitive: bool = False):
    """({windows, dp_subopt, dp_anchored}, spans): gapped windows, those
    below the optimum, and (sensitive mode) those below it that equal the
    optimum through their anchors (`anchor_runs`), which dp_subopt leaves
    out; spans: the reference spans [(chromosome, lo, hi)] of the last."""
    found, pairs, scores = [], [], []
    for b in blocks:
        if b.score == 1:          # a duplicate: the aligner's output as-is
            continue
        for w1, w2, sc, lo, hi in gapped_windows(b, anchor):
            found.append((b, lo, hi))
            pairs.append((w1, w2))
            scores.append(sc)
    low = np.flatnonzero(np.asarray(scores, np.int64) < optimal_scores(pairs))
    spans = []
    if sensitive:
        # each window below the optimum, split at its anchors into pieces
        pieces, owner, matched = [], [], {}
        for w in low:
            (b, lo, hi), (w1, w2) = found[w], pairs[w]
            runs = anchor_runs(b, lo, hi, anchor)
            if not runs:
                continue
            ri = qi = 0
            for r0, q0, n in runs + [(len(w1), len(w2), 0)]:
                pieces.append((w1[ri:r0], w2[qi:q0]))
                owner.append(w)
                ri, qi = r0 + n, q0 + n
            matched[w] = sum(n for _, _, n in runs)
        best = dict(matched)
        for w, sc in zip(owner, optimal_scores(pieces)):
            best[w] += int(sc)
        for w, through in best.items():
            b, lo, hi = found[w]
            if scores[w] == through:
                r0 = b.r_start + int(np.count_nonzero(b.r_row[:lo] != GAP))
                spans.append((b.ref, r0, r0 + int(
                    np.count_nonzero(b.r_row[lo:hi] != GAP))))
    return {"windows": len(pairs), "dp_subopt": int(low.size) - len(spans),
            "dp_anchored": len(spans)}, spans


_VCF_LINE = re.compile(rb"^([^#\t\n][^\t\n]*)\t(\d+)\t[^\t\n]*\t([^\t\n]+)\t"
                       rb"([^\t\n]+)\t[^\t\n]*\t[^\t\n]*\t([^\t\n]+)$", re.M)


def parse_vcf(data: bytes):
    """(records, malformed count). records: {"snv": int64 keys (snv_key of
    chromosome, position, alternative and reference base), "indel":
    [(chromosome, position, kind, bases)]} with kind I (the inserted
    bases) or D (the deleted bases)."""
    lines = [ln for ln in data.split(b"\n") if ln and not ln.startswith(b"#")]
    found = _VCF_LINE.findall(data)
    bad = len(lines) - len(found)
    snv, indel = [], []
    for chrom, pos, ref, alt, info in found:
        if info == b"TYPE=SUBSTITUTE" and len(ref) == 1 and len(alt) == 1:
            snv.append((chrom, pos, alt[0], ref[0]))
        elif info == b"TYPE=INSERT" and len(ref) == 1 and len(alt) > 1:
            indel.append((chrom.decode(), int(pos), "I", alt[1:]))
        elif info == b"TYPE=DELETE" and len(alt) == 1 and len(ref) > 1:
            indel.append((chrom.decode(), int(pos), "D", ref[1:]))
        else:
            bad += 1
    names = sorted({c for c, _, _, _ in snv})
    cid = {c: i for i, c in enumerate(names)}
    if snv:
        c, p, a, r = zip(*snv)
        keys = snv_key(np.array([cid[x] for x in c], dtype=np.int64),
                       np.array(p, dtype=np.int64),
                       np.array(a, dtype=np.int64),
                       np.array(r, dtype=np.int64))
    else:
        keys = np.zeros(0, dtype=np.int64)
    return {"snv": keys, "snv_names": [c.decode() for c in names],
            "indel": indel}, bad


def snv_key(chrom, pos, alt, ref):
    """One int64 for a substitution (pos < 2^40), elementwise."""
    i64 = np.int64
    return (np.asarray(chrom, i64) << 56) | (np.asarray(pos, i64) << 16) \
        | (np.asarray(alt, i64) << 8) | np.asarray(ref, i64)


def implied_variants(blocks: List[MafBlock], names: List[str]):
    """The variants the forward, non-duplicate MAF blocks imply, as
    parse_vcf gives them (1-based positions of the reference); chromosome
    numbers of the substitutions index `names`."""
    keys, indel = [], []
    cid = {c: i for i, c in enumerate(names)}
    for b in blocks:
        if b.score == 1 or b.reverse:
            continue
        a1, a2 = b.r_row, b.q_row
        g1, g2 = a1 == GAP, a2 == GAP
        ins_cols = np.flatnonzero(g1)

        def rpos(c):
            """The reference coordinate (0-based) of columns c; of the next
            reference base for a column in an insertion."""
            return b.r_start + c - np.searchsorted(ins_cols, c)
        mm = np.flatnonzero((a1 != a2) & ~g1 & ~g2 & (a2 != ord("N")))
        if mm.size:
            if b.ref not in cid:
                cid[b.ref] = len(names)
                names.append(b.ref)
            keys.append(snv_key(cid[b.ref], rpos(mm) + 1,
                                a2[mm].astype(np.int64),
                                a1[mm].astype(np.int64)))
        for g, kind, row in ((g2, "D", a1), (g1, "I", a2)):
            gs, ge = _runs(g)
            for lo, hi, p in zip(gs, ge, rpos(gs)):
                indel.append((b.ref, int(p), kind, row[lo:hi].tobytes()))
    return {"snv": np.concatenate(keys) if keys else np.zeros(0, np.int64),
            "indel": indel}


def _multiset_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Size of the symmetric difference of two multisets of int64."""
    va, ca = np.unique(a, return_counts=True)
    vb, cb = np.unique(b, return_counts=True)
    both = np.union1d(va, vb)
    na = np.zeros(both.shape[0], np.int64)
    nb = np.zeros(both.shape[0], np.int64)
    na[np.searchsorted(both, va)] = ca
    nb[np.searchsorted(both, vb)] = cb
    return int(np.abs(na - nb).sum())


def check_vcf(recs: dict, bad: int, blocks: List[MafBlock]) -> dict:
    """{variants, vcf_bad}: the VCF's records (parse_vcf's records and
    malformed count), and the records in the symmetric difference of the
    VCF and the MAF's implied variants (as multisets) plus the malformed
    ones. Reverse-strand blocks report in their own coordinates and are
    left out of both sides."""
    from collections import Counter
    names = list(recs["snv_names"])
    want = implied_variants(blocks, names)
    rev = [(names.index(b.ref) if b.ref in names else -1, b.ref,
            b.r_start, b.r_start + b.r_size)
           for b in blocks if b.reverse and b.score != 1]

    def snv_out(keys):
        pos = (keys >> 16) & ((1 << 40) - 1)
        chrom = keys >> 56
        drop = np.zeros(keys.shape[0], dtype=bool)
        for ci, _, lo, hi in rev:
            drop |= (chrom == ci) & (pos > lo) & (pos <= hi + 1)
        return keys[~drop]

    def indel_out(rs):
        return Counter(r for r in rs if not any(
            r[0] == c and lo < r[1] <= hi + 1 for _, c, lo, hi in rev))
    got, exp = indel_out(recs["indel"]), indel_out(want["indel"])
    diff = _multiset_diff(snv_out(recs["snv"]), snv_out(want["snv"])) + \
        sum(((got - exp) + (exp - got)).values())
    return {"variants": int(recs["snv"].shape[0] + len(recs["indel"])),
            "vcf_bad": bad + diff}


def check_snvs(vcf_recs: dict, ref: Dict[str, np.ndarray], truths: dict,
               left_out=(), margin: int = 50, edge: int = 1000) -> dict:
    """{isolated_snvs, snv_missed, snv_anchored}: planted substitutions at
    least `margin` bases from every other planted variant, `edge` bases
    from the chromosome's ends and from the inverted span, and those the
    VCF lacks. vcf_recs: parse_vcf's records; truths: {reference
    chromosome: Truth}; left_out: the reference spans [(chromosome, lo,
    hi)] of the windows check_dp counted in dp_anchored, whose
    substitutions are not judged and are counted as snv_anchored."""
    names = vcf_recs["snv_names"]
    n = missed = anchored = 0
    for name, t in truths.items():
        r = ref[name]
        ev = np.sort(np.concatenate([t.snv_pos, t.del_pos, t.ins_pos,
                                     t.del_pos + t.del_len - 1]))
        p = t.snv_pos
        k = np.searchsorted(ev, p)
        before = np.where(k > 0, p - ev[np.maximum(k - 1, 0)], 1 << 40)
        # ev holds p itself at k; the next event is at k + 1
        after = np.where(k + 1 < len(ev),
                         ev[np.minimum(k + 1, len(ev) - 1)] - p, 1 << 40)
        lo, hi = t.inverted_ref
        ok = (before >= margin) & (after >= margin) & (p >= edge) \
            & (p < len(r) - edge) & ((p < lo - edge) | (p >= hi + edge))
        for c, a, z in left_out:
            if c == name:
                inside = ok & (p >= a) & (p < z)
                anchored += int(inside.sum())
                ok &= ~inside
        n += int(ok.sum())
        if name not in names:
            missed += int(ok.sum())
            continue
        keys = snv_key(names.index(name), p[ok] + 1,
                       t.snv_alt[ok].astype(np.int64),
                       r[p[ok]].astype(np.int64))
        missed += int((~np.isin(keys, vcf_recs["snv"])).sum())
    return {"isolated_snvs": n, "snv_missed": missed,
            "snv_anchored": anchored}


class TextKmers:
    """Every occurrence, in a text of 2-bit codes, of the k-mers a set of
    query windows needs: built once by one pass over the text (plain
    torch, on the device given), looked up per k-mer."""

    def __init__(self, text, keys: np.ndarray, k: int, device="cpu"):
        import torch
        self.k = k
        t = torch.as_tensor(text, device=device)
        n = t.shape[0] - k + 1
        v = torch.zeros(max(n, 0), dtype=torch.int64, device=device)
        for i in range(k):
            v = v * 4 + t[i:i + n].to(torch.int64)
        want = torch.as_tensor(np.unique(keys), device=device)
        hit = torch.isin(v, want)
        pos = torch.nonzero(hit).flatten()
        val = v[pos]
        order = torch.argsort(val, stable=True)
        self.val = val[order].cpu().numpy()
        self.pos = pos[order].cpu().numpy()
        del v, hit

    def find(self, key: int) -> np.ndarray:
        lo, hi = np.searchsorted(self.val, [key, key + 1])
        return self.pos[lo:hi]


def kmer_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """The k-mer value at every start of codes (-1 where the k bases run
    past the end or hold a code above 3)."""
    n = codes.shape[0]
    out = np.full(n, -1, dtype=np.int64)
    m = n - k + 1
    if m <= 0:
        return out
    v = np.zeros(m, dtype=np.int64)
    bad = np.zeros(m, dtype=bool)
    for i in range(k):
        c = codes[i:i + m].astype(np.int64)
        v = v * 4 + np.minimum(c, 3)
        bad |= c > 3
    out[:m] = np.where(bad, -1, v)
    return out


def _lcp(text: np.ndarray, q: np.ndarray, pos: np.ndarray,
         cap: int) -> np.ndarray:
    """Length of the common prefix of q[:cap] and text[p:] for each p."""
    out = np.zeros(pos.shape[0], dtype=np.int64)
    live = np.arange(pos.shape[0])
    off = 0
    step = 64
    while live.size and off < cap:
        w = min(step, cap - off)
        idx = pos[live, None] + off + np.arange(w)[None, :]
        inside = idx < text.shape[0]
        tv = np.where(inside, text[np.minimum(idx, text.shape[0] - 1)], 9)
        eq = tv == q[None, off:off + w]
        first = np.where(eq.all(1), w, np.argmin(eq, axis=1))
        out[live] += first
        live = live[first == w]
        off += w
        step *= 4
    return out


def plain_lane(text: np.ndarray, kmers: TextKmers, qcodes: np.ndarray,
               start: int, stop: int, min_len: int, max_freq: int,
               sensitive: bool) -> list:
    """The hits of one lane [start, stop) of a query chromosome's codes:
    [(start, length, occurrences, position if unique else -1)], by the
    plain scan (module docstring). text: the forward + reverse-complement
    codes; kmers: its occurrences of the lane's min_len-mers."""
    keys = kmer_keys(qcodes[start:stop], min_len)
    hits = []
    c = start
    while c < stop:
        key = int(keys[c - start])
        cap = stop - c
        if key < 0 or cap < min_len:
            c += 1
            continue
        cand = kmers.find(key)
        if cand.size == 0:
            c += 1
            continue
        lcp = _lcp(text, qcodes[c:stop], cand, cap)
        L = int(lcp.max())
        at = cand[lcp == L]
        if L >= min_len and 0 < at.size <= max_freq:
            hits.append((c, L, int(at.size),
                         int(at[0]) if at.size == 1 else -1))
            c += 5 if sensitive else L + 1
        else:
            c += 1
    return hits


def check_seeds(ref_codes: np.ndarray, lanes: list, got: dict,
                min_len: int, max_freq: int, sensitive: bool,
                device="cpu") -> dict:
    """{seed_lanes, seed_hits, seed_bad}. ref_codes: the reference genome's
    codes, chromosomes back to back; lanes: [(lane id, query codes, start,
    stop)]; got: {lane id: [(start, length, occurrences, position or -1)]}
    from the program (its position where its record carries one, else -1).
    A hit counts as bad where it is in one list and not the other, or
    where both give a position and they differ."""
    text = np.concatenate([ref_codes, 3 - ref_codes[::-1]])
    keys = np.concatenate([kmer_keys(q[s:e], min_len) for _, q, s, e in lanes]
                          or [np.zeros(0, np.int64)])
    kmers = TextKmers(text, keys[keys >= 0], min_len, device)
    bad = n = 0
    for lid, q, s, e in lanes:
        want = plain_lane(text, kmers, q, s, e, min_len, max_freq, sensitive)
        n += len(want)
        have = {h[:3]: h[3] for h in got.get(lid, [])}
        bad += len(set(have) ^ {h[:3] for h in want})
        for h in want:
            p = have.get(h[:3], -1)
            bad += p >= 0 and h[3] >= 0 and p != h[3]
    return {"seed_lanes": len(lanes), "seed_hits": n, "seed_bad": int(bad)}
