"""The generator and the plain reference, on the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH

import gen
import reference as R

CFG = {"bases": "uniform_random", "genome_seed": 11,
       "chromosomes": [["a", 60_000], ["b", 9_000]],
       "mutation": {"sub_rate": 0.005, "indel_rate": 0.0005, "max_indel": 10,
                    "inversion_len": 10_000, "inversion_chromosome": 0}}


def naive_global(a, b, q=R.GAP_OPEN, e=R.GAP_EXTEND):
    """Gotoh's recurrence cell by cell."""
    neg = -10 ** 9
    n, m = len(a), len(b)
    H = [[neg] * (m + 1) for _ in range(n + 1)]
    E = [[neg] * (m + 1) for _ in range(n + 1)]
    F = [[neg] * (m + 1) for _ in range(n + 1)]
    H[0][0] = 0
    for j in range(1, m + 1):
        H[0][j] = -(q + j * e)
    for i in range(1, n + 1):
        H[i][0] = -(q + i * e)
        for j in range(1, m + 1):
            E[i][j] = max(H[i][j - 1] - q - e, E[i][j - 1] - e)
            F[i][j] = max(H[i - 1][j] - q - e, F[i - 1][j] - e)
            s = R.MATCH if a[i - 1] == b[j - 1] else R.MISMATCH
            H[i][j] = max(H[i - 1][j - 1] + s, E[i][j], F[i][j])
    return H[n][m]


def test_optimal_scores_equal_the_cell_by_cell_recurrence():
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(300):
        n, m = (int(x) for x in rng.integers(0, 30, 2))
        a = gen.DNA[rng.integers(0, 4, n)]
        b = np.concatenate([a[:m], gen.DNA[rng.integers(0, 4, max(0, m - n))]])
        if len(b):
            b[rng.integers(0, len(b), 2)] = gen.DNA[rng.integers(0, 4, 2)]
        if n + len(b) == 0:
            continue
        pairs.append((a, b))
    got = R.optimal_scores(pairs)
    assert got.tolist() == [naive_global(a, b) for a, b in pairs]


def apply_truth(ref, t):
    """The mutant, rebuilt base by base from what was planted."""
    out = []
    snv = dict(zip(t.snv_pos.tolist(), t.snv_alt.tolist()))
    dels = dict(zip(t.del_pos.tolist(), t.del_len.tolist()))
    ins = {int(p): t.ins_seq[t.ins_off[k]:t.ins_off[k + 1]].tolist()
           for k, p in enumerate(t.ins_pos)}
    i = 0
    while i < len(ref):
        out += ins.get(i, [])
        if i in dels:
            i += dels[i]
            continue
        out.append(snv.get(i, int(ref[i])))
        i += 1
    return np.asarray(out, dtype=np.uint8)


def test_mutants_are_what_the_truth_says_and_follow_the_seed():
    ref = gen.reference_genome(CFG)
    assert [len(s) for _, s in ref] == [60_000, 9_000]
    q, truths = gen.mutant(CFG, ref, [2 ** 31 + 5, 0])
    q2, _ = gen.mutant(CFG, ref, [2 ** 31 + 5, 0])
    q3, _ = gen.mutant(CFG, ref, [2 ** 31 + 5, 1])
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(q, q2))
    assert not np.array_equal(q[0][1], q3[0][1])
    for (_, r), (_, m), t in zip(ref, q, truths):
        plain = apply_truth(r, t)
        lo, hi = t.inverted
        if hi:
            plain[lo:hi] = gen.revcomp(plain[lo:hi])
        assert np.array_equal(m, plain)
        assert t.snv_pos.size > 0.003 * len(r)
    lo, hi = truths[0].inverted
    assert hi - lo == 10_000 and abs(lo - len(q[0][1]) // 3) <= 1
    assert truths[1].inverted == (0, 0)


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "gen.py", "yardstick.py"):
        tree = ast.parse(open(os.path.join(BENCH, name)).read())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                mods.add((node.module or "").split(".")[0])
        assert not mods & {"gsalign_tpu_torch", "gsalign_tpu", "jax",
                           "jaxlib", "flax"}, (name, mods)
    code = ("import sys; sys.path.insert(0, %r); import reference, gen, "
            "yardstick; print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'gsalign_tpu_torch', 'gsalign_tpu', 'jax'}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def block(ref_row: bytes, qry_row: bytes, r_start=0, q_start=0, score=None):
    a1 = np.frombuffer(ref_row, dtype=np.uint8)
    a2 = np.frombuffer(qry_row, dtype=np.uint8)
    matches = int(((a1 == a2) & (a1 != R.GAP)).sum())
    return R.MafBlock(matches if score is None else score, "r", r_start,
                      int((a1 != R.GAP).sum()), 0, a1, "q", q_start,
                      int((a2 != R.GAP).sum()), 0, a2)


def test_dp_check_finds_a_gap_placed_worse_than_the_optimum():
    anchor = "ACGTTGCAAGCTTAGC"
    # the deletion of one G from a GG run: either place is optimal
    good = block((anchor + "CAGGTA" + anchor).encode(),
                 (anchor + "CA-GTA" + anchor).encode())
    # a deletion placed where it costs two mismatches more
    bad = block((anchor + "CAGGTACGT" + anchor).encode(),
                (anchor + "-CAGGTCGT" + anchor).encode())
    for sensitive in (False, True):
        assert R.check_dp([good], 15, sensitive) == (
            {"windows": 1, "dp_subopt": 0, "dp_anchored": 0}, [])
        assert R.check_dp([bad], 15, sensitive) == (
            {"windows": 1, "dp_subopt": 1, "dp_anchored": 0}, [])


def test_vcf_check_against_the_alignment():
    anchor = "ACGTTGCAAGCTTAGC"
    b = block((anchor + "CAGGTAT" + anchor).encode(),
              (anchor + "CA-GTTT" + anchor).encode(), r_start=100)
    want = R.implied_variants([b], ["r"])
    assert want["indel"] == [("r", 118, "D", b"G")]
    assert want["snv"].tolist() == [R.snv_key(0, 122, ord("T"), ord("A"))]
    vcf = (b"##fileformat=VCFv4.1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
           b"\tINFO\nr\t118\t.\tAG\tA\t100\t*\tTYPE=DELETE\n"
           b"r\t122\t.\tA\tT\t100\t*\tTYPE=SUBSTITUTE\n")

    def bad(text):
        return R.check_vcf(*R.parse_vcf(text), [b])["vcf_bad"]
    assert bad(vcf) == 0
    assert bad(vcf.replace(b"\tT\t100", b"\tG\t100")) == 2
    assert bad(vcf.split(b"r\t122")[0]) == 1
    assert bad(vcf.replace(b"TYPE=DELETE", b"TYPE=INSERT")) == 2


@pytest.mark.parametrize("sensitive", [False, True])
def test_plain_seed_scan_on_a_known_text(sensitive):
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 4, 5_000).astype(np.uint8)
    q = ref[1_000:3_000].copy()
    q[[300, 700, 701, 1500]] ^= 1
    text = np.concatenate([ref, 3 - ref[::-1]])
    min_len = 10 if sensitive else 15
    keys = R.kmer_keys(q, min_len)
    km = R.TextKmers(text, keys[keys >= 0], min_len)
    hits = R.plain_lane(text, km, q, 0, len(q), min_len, 100, sensitive)
    assert hits[0] == (0, 300, 1, 1_000)
    if not sensitive:
        assert hits[1] == (301, 399, 1, 1_301)
    got = {0: hits}
    lanes = [(0, q, 0, len(q))]
    res = R.check_seeds(ref, lanes, got, min_len, 100, sensitive)
    assert res["seed_bad"] == 0 and res["seed_hits"] == len(hits)
    assert R.check_seeds(ref, lanes, {0: hits[1:]}, min_len, 100,
                         sensitive)["seed_bad"] == 1
    moved = [(s, ln, f, p + 1 if p >= 0 else p) for s, ln, f, p in hits]
    assert R.check_seeds(ref, lanes, {0: moved}, min_len, 100,
                         sensitive)["seed_bad"] == len(hits)


# seed 3100000233's judged pair under -sen: a planted C>G inside a tandem
# repeat aligned as a 4-base insertion, 5 matches on the repeat's diagonal
# +4 (a seed cut by overlap removal) and a 4-base deletion
SEN_REF = "TTGT----GATGGATGCATGCATG"
SEN_QRY = "TTGTGATGGATGG----ATGCATG"
SEN_START = 1_000


def sen_case(ref_row=SEN_REF):
    """The block between two random 20-base flanks at SEN_START of a
    3,000-base chromosome "r", the chromosome, and the truth of the one
    planted substitution (the C at the rows' 13th reference base)."""
    rng = np.random.default_rng(17)
    left, right = (gen.DNA[rng.integers(0, 4, 20)].tobytes() for _ in "lr")
    b = block(left + ref_row.encode() + right,
              left + SEN_QRY.encode() + right, r_start=SEN_START)
    chrom = gen.DNA[rng.integers(0, 4, 3_000)]
    chrom[SEN_START:SEN_START + b.r_size] = b.r_row[b.r_row != R.GAP]
    p = SEN_START + len(left) + 12
    assert chrom[p] == ord("C")
    none = np.zeros(0, np.int64)
    truth = gen.Truth(np.array([p]), np.array([ord("G")], np.uint8), none,
                      none, none, none, np.zeros(1, np.int64),
                      np.zeros(0, np.uint8), (0, 0), (0, 0))
    return b, {"r": chrom}, {"r": truth}


def snv_check(b, ref, truths, left_out=()):
    vcf = b"##fileformat=VCFv4.1\n"        # the indels hold no substitution
    return R.check_snvs(R.parse_vcf(vcf)[0], ref, truths, left_out)


def test_an_anchored_window_is_judged_through_its_anchor():
    b, ref, truths = sen_case()
    # the window: 9 reference bases between the two runs; its one anchor,
    # the 5 matches on diagonal +4, in a 12-base exact run there
    assert R.anchor_runs(b, 24, 37, 10) == [(0, 4, 5)]
    lo = SEN_START + 20 + 4
    assert R.check_dp([b], 10, sensitive=True) == (
        {"windows": 1, "dp_subopt": 0, "dp_anchored": 1}, [("r", lo, lo + 9)])
    assert snv_check(b, ref, truths, [("r", lo, lo + 9)]) == {
        "isolated_snvs": 0, "snv_missed": 0, "snv_anchored": 1}
    # not sensitive: every check reads as it did before the rule
    assert R.check_dp([b], 10) == (
        {"windows": 1, "dp_subopt": 1, "dp_anchored": 0}, [])
    assert snv_check(b, ref, truths) == {
        "isolated_snvs": 1, "snv_missed": 1, "snv_anchored": 0}


def test_a_window_without_a_shifted_run_is_judged():
    # the run on diagonal +4 (GATGGATGCATG in both) broken at its 6th base
    broken = SEN_REF[:13] + "C" + SEN_REF[14:]
    for sensitive in (True, False):
        b, ref, truths = sen_case(broken)
        assert R.anchor_runs(b, 24, 37, 10) == []
        assert R.check_dp([b], 10, sensitive) == (
            {"windows": 1, "dp_subopt": 1, "dp_anchored": 0}, [])
        assert snv_check(b, ref, truths)["snv_missed"] == 1


def test_a_window_below_the_optimum_through_its_anchor_is_judged():
    """An anchor in a tandem repeat (the insertion GATG repeats the left
    flank, so the 5 matches on diagonal +4 lie in a 10-base exact run),
    and after it a piece aligned worse than its optimum: dp_subopt."""
    rng = np.random.default_rng(5)
    left = gen.DNA[rng.integers(0, 4, 12)].tobytes() + b"GATGGATG"
    right = gen.DNA[rng.integers(0, 4, 20)].tobytes()
    piece = {"worse": ("CAGGTACGT", "-CAGGTCGT"),
             "optimal": ("CAGGTACGT", "CAGGT-CGT")}
    got = {}
    for name, (pr, pq) in piece.items():
        b = block(left + b"----GATGGATGC" + pr.encode() + right,
                  left + b"GATGGATGG----" + pq.encode() + right)
        got[name] = R.check_dp([b], 10, sensitive=True)[0]
        assert R.anchor_runs(b, 20, 39, 10) == [(0, 4, 5)]
    assert got["worse"] == {"windows": 1, "dp_subopt": 1, "dp_anchored": 0}
    assert got["optimal"] == {"windows": 1, "dp_subopt": 0,
                              "dp_anchored": 1}
