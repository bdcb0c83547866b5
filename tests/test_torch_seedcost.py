"""The port's exp_seedcost bodies (gsalign_tpu_torch/ops/probe.py
seedcost_plain, what the seedcost kernel is held against on a card)
against the JAX tool tools/exp_seedcost.py on the CPU.

The JAX tool's bodies are nested in its main(), so jax_seedcost below
composes the JAX package's own functions as the tool does (its loop, :66;
bodies :82-200: seeding._build_qrows, _meta16, _extract256, rank.occ_t3 on
DeviceFMIndex.from_host), over a 40 kb make_pair index, narrow and
forced-wide, at B 64, K 20 and max_out 16. The query carries N runs (lanes
whose first base is ambiguous, or whose 3 and 8 bases are not real) and a
poly-A run on which a lane reads the last INIT row, whose neighbour lies
one past comb_pairs: JAX clamps that read, and so must the port. Each body
gives the same acc, and body 5 the same record planes; the checksum of
the reads the tool's acc leaves unused (the compare's query words, the rank
at k2 + 100) is composed on the JAX side too. Two departures, both the
JAX tool's own failures: its body 5 stores an int64 sum into its int32
out_k0 carry, which does not trace, so the composition keeps the sum's low
32 bits (astype), as the port does; bodies 4 and 5 need text rows, which a
wide index lacks: there the JAX bodies raise and so does the port.
Integers throughout: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsalign_tpu.genome.packing import pack_genome as jpack
from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.ops import rank as jrank
from gsalign_tpu.ops import seeding as jseeding
from gsalign_tpu_torch.genome.packing import chars_to_codes, pack_genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import probe
from gsalign_tpu_torch.ops import rank as trank
from gsalign_tpu_torch.ops import seeding as tseeding
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from tests.make_testdata import make_pair
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

B, K, MAX_OUT = 64, 20, 16
i32, u32 = jnp.int32, jnp.uint32


def jax_seedcost(dfm, q_rows, piece, B, K, max_out):
    """The JAX tool's body `piece`, K iterations over B lanes, composed as
    tools/exp_seedcost.py:66-200 composes it. Returns numpy acc, the
    checksum of the unused reads, and body 5's planes and counts."""
    n_qrow = q_rows.shape[0]
    n_trow = dfm.text_rows.shape[0]
    sl = dfm.seq_len
    order = dfm.init_order
    half = 65536 + 136

    def loop(body, st0):
        st0 = dict(st0, k=jnp.zeros((), i32))

        def wrap(s):
            s = body(s)
            return dict(s, k=s["k"] + 1)
        return jax.lax.while_loop(lambda s: s["k"] < K, wrap, st0)

    def mk_look(s):
        return (s["idx"] + s["k"] * 7) % (n_qrow * 256 - 600)

    def qmeta(s):
        look = mk_look(s)
        qrows2 = q_rows[jnp.concatenate([look >> 8, look >> 8])]
        cls12, real3, b1ok, real8, _ = jseeding._meta16(qrows2[:B],
                                                        look & 255)
        return look, qrows2, cls12, b1ok

    def comb_part(s):
        look, qrows2, cls12, b1ok = qmeta(s)
        cls_init = cls12 & ((1 << (2 * order)) - 1)
        cls8 = cls12 & 0xFFFF
        idx_a = jnp.where(b1ok, jrank.INIT_OFF + cls_init, cls8)
        idx_b = jnp.where(b1ok, idx_a + 1, idx_a + half)
        vals = dfm.comb_pairs[jnp.concatenate([idx_a, idx_b])]
        return look, qrows2, cls12, vals[:B], vals[B:]

    def qwords(look, qrows2):
        # the compare's query words: the tool's second copy of the rows
        return jseeding._extract256(qrows2[B:][:, :32], look & 255)

    def unused(s, look, qrows2, cnt=None):
        c = s["chk"] + jnp.sum(qwords(look, qrows2), axis=1, dtype=u32)
        return c if cnt is None else c + cnt[B:].astype(u32)

    def ranks(look, cls12):
        k2 = (look % (sl - 300)).astype(dfm.rdtype)
        return jrank.occ_t3(dfm, jnp.concatenate([k2, k2 + 100]),
                            jnp.ones(2 * B, jnp.bool_),
                            jnp.concatenate([cls12 & 63] * 2))

    def compare(look, qrows2):
        p = (look * 3) % (n_trow * 256 - 600)
        trow = dfm.text_rows[p >> 8]
        tw = jseeding._extract256(trow, p & 255)
        x = tw ^ qwords(look, qrows2)
        mm = (x | (x >> u32(1))) & u32(0x55555555)
        clzs = jax.lax.clz(mm.astype(i32)) >> 1
        j16 = jnp.arange(16, dtype=i32)[None, :] * 16
        cand = jnp.where(mm == 0, 4096, j16 + clzs)
        return jnp.minimum(jnp.min(cand, axis=1), 256)

    def body0(s):
        return dict(s, acc=s["acc"] + mk_look(s))

    def body1(s):
        look, qrows2, cls12, b1ok = qmeta(s)
        return dict(s, acc=s["acc"] + cls12 + b1ok.astype(i32),
                    chk=unused(s, look, qrows2))

    def body2(s):
        look, qrows2, cls12, a, b = comb_part(s)
        return dict(s, acc=s["acc"] + (b - a).astype(i32),
                    chk=unused(s, look, qrows2))

    def body3(s):
        look, qrows2, cls12, a, b = comb_part(s)
        cnt = ranks(look, cls12)
        return dict(s, acc=s["acc"] + (b - a).astype(i32)
                    + cnt[:B].astype(i32), chk=unused(s, look, qrows2, cnt))

    def body4(s):
        look, qrows2, cls12, a, b = comb_part(s)
        cnt = ranks(look, cls12)
        run = compare(look, qrows2)
        return dict(s, acc=s["acc"] + (b - a).astype(i32)
                    + cnt[:B].astype(i32) + run,
                    chk=unused(s, look, qrows2, cnt))

    def body5(s):
        look, qrows2, cls12, a, b = comb_part(s)
        cnt = ranks(look, cls12)
        run = compare(look, qrows2)
        do = (run & 7) == 0
        slot = jnp.minimum(s["out_n"], max_out - 1)
        hot = (jnp.arange(max_out, dtype=i32)[None, :] == slot[:, None]) \
            & do[:, None]
        out_meta = jnp.where(hot, cls12.astype(u32)[:, None], s["out_meta"])
        # the tool's int64 a + cnt, stored in the carry's dtype
        out_k0 = jnp.where(hot, (a + cnt[:B]).astype(dfm.rdtype)[:, None],
                           s["out_k0"])
        out_fr = jnp.where(hot, run.astype(jnp.int8)[:, None], s["out_fr"])
        return dict(s, acc=s["acc"] + (b - a).astype(i32)
                    + cnt[:B].astype(i32) + run,
                    chk=unused(s, look, qrows2, cnt),
                    out_meta=out_meta, out_k0=out_k0, out_fr=out_fr,
                    out_n=s["out_n"] + do.astype(i32))

    st = dict(idx=(jnp.arange(B, dtype=i32) * 9973) % (n_qrow * 256 - 600),
              acc=jnp.zeros(B, i32), chk=jnp.zeros(B, u32),
              out_meta=jnp.zeros((B, max_out), u32),
              out_k0=jnp.zeros((B, max_out), dfm.rdtype),
              out_fr=jnp.zeros((B, max_out), jnp.int8),
              out_n=jnp.zeros(B, i32))
    body = (body0, body1, body2, body3, body4, body5)[piece]
    r = jax.jit(lambda: loop(body, st))()
    return {k: np.asarray(v) for k, v in r.items()}


@pytest.fixture(scope="module")
def case():
    """The 40 kb pair's query codes, with N runs and a poly-A run placed
    on lanes 1 and 2's look sequences (lane i starts at 9973 i), and both
    packages' indexes of its reference, narrow and forced-wide."""
    ref, qry = make_pair(total_len=40_000)
    codes = np.concatenate([chars_to_codes(q) for _, q in qry])
    codes[9973 + 14: 9973 + 40] = 0          # A: class 4^order - 1
    codes[19946 + 30: 19946 + 45] = 4         # N: b1ok false on lane 2
    codes[19946 + 62: 19946 + 66] = 4         # real3 and real8 false
    codes[19946 + 100: 19946 + 200: 9] = 4
    tables = {}
    for wide in (False, True):
        tables[wide] = (
            jrank.DeviceFMIndex.from_host(jbuild(jpack(ref),
                                                 force_wide=wide)),
            DeviceFMIndex.from_host(build_fmindex(pack_genome(ref),
                                                  force_wide=wide), "cpu"))
    return codes, tables


def test_the_case_reaches_the_edges(case):
    """Lane 1 reads the last INIT row (so its neighbour past comb_pairs),
    lane 2 looks at a query word whose first base is N."""
    codes, tables = case
    dfm = tables[False][1]
    q_rows = tseeding.build_qrows(torch.from_numpy(codes))
    look_mod = q_rows.shape[0] * 256 - 600
    look = (torch.arange(B)[:, None] * 9973 + 7 * torch.arange(K)) % look_mod
    rows = q_rows.to(torch.int64)[look >> 8].reshape(B * K, 64) & 0xFFFFFFFF
    cls12, _, b1ok, _, _ = tseeding._meta16(rows, (look & 255).reshape(-1))
    last = (1 << (2 * dfm.init_order)) - 1
    hit = b1ok & ((cls12 & last) == last)
    assert bool(hit.reshape(B, K)[1].any())
    assert trank.INIT_OFF + last + 1 == dfm.comb_pairs.shape[0]
    assert not bool(b1ok.reshape(B, K)[2].all())


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("piece", range(6))
def test_seedcost_bodies_equal_the_jax_tool(case, piece, wide):
    codes, tables = case
    jdfm, dfm = tables[wide]
    jq = jseeding._build_qrows(jnp.asarray(codes))
    tq = tseeding.build_qrows(torch.from_numpy(codes))
    if piece in probe.TEXT_PIECES and wide:
        # the tool's bodies 4 and 5 need text rows: JAX fails, the port
        # refuses
        with pytest.raises(TypeError):
            jax_seedcost(jdfm, jq, piece, B, K, MAX_OUT)
        with pytest.raises(ValueError, match="text rows"):
            probe.seedcost(dfm, tq, piece, B, K, MAX_OUT)
        return
    want = jax_seedcost(jdfm, jq, piece, B, K, MAX_OUT)
    got = probe.seedcost(dfm, tq, piece, B, K, MAX_OUT)
    np.testing.assert_array_equal(got.acc.numpy(), want["acc"])
    np.testing.assert_array_equal(got.chk.numpy(),
                                  want["chk"].view(np.int32))
    if piece == 5:
        np.testing.assert_array_equal(got.out_n.numpy(), want["out_n"])
        np.testing.assert_array_equal(got.out_meta.numpy(),
                                      want["out_meta"].view(np.int32))
        np.testing.assert_array_equal(got.out_k0.numpy(), want["out_k0"])
        np.testing.assert_array_equal(got.out_fr.numpy(), want["out_fr"])
        assert got.out_n.sum() > 0 and got.out_n.max() > 1
    else:
        assert not got.out_n.any() and not got.out_meta.any()


def test_the_tool_prints_the_jax_lines(tmp_path, capsys):
    """exp_seedcost on a pair directory, on the CPU: the JAX tool's header
    and six piece lines, then one JSON line; on a forced-wide index the
    text pieces' lines say why they are missing."""
    import json
    import re

    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.index.io import save_index
    from gsalign_tpu_torch.tools import exp_seedcost
    from tests.make_testdata import write_fasta
    ref, qry = make_pair(total_len=40_000)
    d = tmp_path / "small"
    d.mkdir()
    write_fasta(str(d / "ref.fa"), ref)
    write_fasta(str(d / "qry.fa"), qry)
    g = pack_genome(read_fasta(str(d / "ref.fa")))
    for name, wide in (("ref_idx", False), ("idxw", True)):
        save_index(build_fmindex(g, force_wide=wide), str(d / name))
        assert exp_seedcost.main(["small", "16", "10", "8", "--dir",
                                  str(tmp_path), "--device", "cpu",
                                  "--index", name]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert re.match(r"tag=small B=16 K=10 comb=[\d.]+MB t3=[\d.]+MB "
                        r"qrows=[\d.]+MB text=[\d.]+MB$", lines[0])
        for piece, ln in enumerate(lines[1:7]):
            assert ln.startswith(exp_seedcost.label(piece) + " ")
            text_less = wide and piece in probe.TEXT_PIECES
            assert ln.endswith("(no text rows: the index is not direct)"
                               if text_less else " us/iter"), ln
        out = json.loads(lines[7])
        assert out["wide"] == wide and len(out["us"]) == 6
