"""The columnar variant-event machinery of both packages on the same
cases: tests/test_variant_units.py's unit tests (allele fragment gathers
with python-slice edge semantics, the columnar collector, the bufpool
prime path), each run through the JAX package (gsalign_tpu) and the port
(gsalign_tpu_torch), and the gathers of both on the same random
descriptors."""

import importlib

import numpy as np
import pytest

PKGS = ("gsalign_tpu", "gsalign_tpu_torch")


@pytest.fixture(params=PKGS)
def variants(request):
    return importlib.import_module(f"{request.param}.pipeline.variants")


def desc(cols):
    """[(src, start, len), ...] -> the [3, n] descriptor array."""
    return np.asarray(cols, dtype=np.int64).T.reshape(3, -1)


REF = np.frombuffer(b"ACGTACGT", dtype=np.uint8).copy()
QRY = np.frombuffer(b"TTTTGGGG", dtype=np.uint8).copy()


def test_gather_frags_both_sources(variants):
    buf, offs = variants._gather_frags(desc([(0, 1, 3), (1, 4, 2)]), REF, QRY)
    assert bytes(buf[offs[0]:offs[1]]) == b"CGT"
    assert bytes(buf[offs[1]:offs[2]]) == b"GG"


def test_gather_frags_negative_start_is_empty(variants):
    # python semantics: chars[-1 : small_stop] == empty slice; arises from
    # the reference's `pos - 1` anchors at position 0
    buf, offs = variants._gather_frags(desc([(0, -1, 3), (1, 0, 2)]),
                                       REF, QRY)
    assert offs.tolist() == [0, 0, 2]
    assert bytes(buf) == b"TT"
    assert bytes(REF[-1:3]) == b""          # the emulated behavior


def test_gather_frags_stop_clamps_at_array_end(variants):
    buf, offs = variants._gather_frags(desc([(0, 6, 5)]), REF, QRY)
    assert bytes(buf) == b"GT"              # ref[6:11] -> ref[6:8]
    assert offs.tolist() == [0, 2]


def random_frags(seed):
    rng = np.random.default_rng(seed)
    ref = rng.integers(65, 91, 100).astype(np.uint8)
    qry = rng.integers(97, 123, 80).astype(np.uint8)
    cols = [(int(rng.integers(0, 2)), int(rng.integers(-1, 110)),
             int(rng.integers(0, 15))) for _ in range(200)]
    return ref, qry, cols


def test_gather_frags_matches_python_slices_random(variants):
    ref, qry, cols = random_frags(3)
    buf, offs = variants._gather_frags(desc(cols), ref, qry)
    for k, (s, st, ln) in enumerate(cols):
        arr = ref if s == 0 else qry
        assert bytes(buf[offs[k]:offs[k + 1]]) == bytes(arr[st:st + ln])


def test_gather_frags_equal_in_both_packages():
    ref, qry, cols = random_frags(4)
    jv, tv = (importlib.import_module(f"{p}.pipeline.variants") for p in PKGS)
    for a, b in zip(jv._gather_frags(desc(cols), ref, qry),
                    tv._gather_frags(desc(cols), ref, qry)):
        np.testing.assert_array_equal(a, b)


def add_chunk(variants, coll, chr_idx, events, seq0):
    # events: (r_raw, typ, ref bytes, alt bytes)
    rb = b"".join(e[2] for e in events)
    ab = b"".join(e[3] for e in events)
    roff = np.concatenate([[0], np.cumsum([len(e[2]) for e in events])])
    aoff = np.concatenate([[0], np.cumsum([len(e[3]) for e in events])])
    coll.add_other_block(
        chr_idx, np.asarray([e[0] for e in events], dtype=np.int64),
        np.asarray([e[1] for e in events], dtype=np.uint8),
        np.arange(seq0, seq0 + len(events)),
        np.frombuffer(rb, dtype=np.uint8), roff,
        np.frombuffer(ab, dtype=np.uint8), aoff)


def finalize(coll, n):
    """What the pipeline's finalize does to the other-variant positions."""
    coll.oth_pos = [r.copy() for r in coll.oth_rraw]
    coll._finalized_other = n


def test_collector_counts_and_columns(variants):
    DEL, INS = variants.TYPE_DEL, variants.TYPE_INS
    c = variants.VariantCollector()
    c.take_seq(2)
    add_chunk(variants, c, 0, [(10, DEL, b"ACG", b"A"),
                               (20, INS, b"T", b"TGG")], 0)
    add_chunk(variants, c, 1, [(5, INS, b"C", b"CC")], 2)
    assert (c.n_ins, c.n_del) == (2, 1)
    finalize(c, 2)
    o_chr, o_pos, o_seq, o_typ, rbuf, roff, abuf, aoff = c.other_columns()
    assert o_chr.tolist() == [0, 0, 1]
    assert o_pos.tolist() == [10, 20, 5]
    assert bytes(rbuf[roff[1]:roff[2]]) == b"T"
    assert bytes(abuf[aoff[2]:aoff[3]]) == b"CC"
    assert o_typ.tolist() == [DEL, INS, INS]


def test_collector_merge_from_offsets_sequences(variants):
    a, b = variants.VariantCollector(), variants.VariantCollector()
    a.take_seq(3)
    add_chunk(variants, a, 0, [(1, variants.TYPE_DEL, b"AC", b"A")], 0)
    finalize(a, 1)
    b.take_seq(1)
    add_chunk(variants, b, 0, [(2, variants.TYPE_INS, b"G", b"GT")], 0)
    finalize(b, 1)
    a.merge_from(b)
    _, _, o_seq, _, _, _, _, _ = a.other_columns()
    assert o_seq.tolist() == [0, 3]              # b's seq offset by 3
    assert (a.n_ins, a.n_del) == (1, 1)


def test_collector_variants_property_roundtrip(variants):
    c = variants.VariantCollector()
    c.take_seq(1)
    add_chunk(variants, c, 0, [(7, variants.TYPE_DEL, b"ACGT", b"A")], 0)
    finalize(c, 1)
    assert c.variants == [(0, 7, b"ACGT", b"A", variants.TYPE_DEL, 0)]


@pytest.mark.parametrize("pkg", PKGS)
def test_bufpool_prime_adds_prefaulted_and_skips_covered(pkg):
    bufpool = importlib.import_module(f"{pkg}.utils.bufpool")
    with bufpool._LOCK:
        saved = bufpool._POOL[:]
        bufpool._POOL.clear()
    try:
        bufpool.prime([1 << 20, 1 << 16])
        with bufpool._LOCK:
            sizes = sorted(b.shape[0] for b in bufpool._POOL)
        assert sizes == [1 << 16, 1 << 20]
        bufpool.prime([1 << 20])     # covered: no growth
        with bufpool._LOCK:
            assert len(bufpool._POOL) == 2
        assert bufpool.get(1 << 20).shape[0] >= 1 << 20
    finally:
        with bufpool._LOCK:
            bufpool._POOL.clear()
            bufpool._POOL.extend(saved)
