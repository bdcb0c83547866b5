"""Speculative seed segments in the PyTorch port (find_seeds_all with
n_segments > 1, slack and init12) against the naive reference scan
(tests/helpers.naive_lmem_seeds) and the JAX package's find_seeds with the
same arguments, mirroring tests/test_seeding.py (n_segments 8, 4 and 16;
lanes poisoned at their segment bounds), and the first round's lanes
(records, poison and exit cursor of the plain step seed_step_plain)
against the JAX scan's on the same emit, ext and hard bounds. Also on a
forced-wide index, over a CPU mesh, on row blocks, in pallas mode (seeds
and per-lane iteration counts against the JAX package's Pallas gather in
interpret mode) and with init12=False. Integer results: every comparison
is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.ops import rank as jrank
from gsalign_tpu.ops import seeding as jseeding
from gsalign_tpu_torch.genome.packing import Genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import seed_cuda
from gsalign_tpu_torch.ops import seeding as tseeding
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from gsalign_tpu_torch.parallel import mesh as mesh_lib
from tests.helpers import naive_lmem_seeds, random_genome
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def indexes(ref, sa_intv=8, force_wide=False):
    """(port host index, port device index on the CPU, JAX device index)
    of one chromosome."""
    g = Genome(names=["c"], lengths=np.asarray([len(ref)]),
               offsets=np.asarray([0]), holes=[], codes_fwd=ref)
    tfm = build_fmindex(g, sa_intv=sa_intv, force_wide=force_wide)
    jfm = jbuild(g, sa_intv=sa_intv, force_wide=force_wide,
                 prefer_device=False)
    return (tfm, DeviceFMIndex.from_host(tfm, "cpu"),
            jrank.DeviceFMIndex.from_host(jfm))


def mutate(codes, rng, sub_rate):
    out = codes.copy()
    subs = rng.random(len(out)) < sub_rate
    out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
    return out.astype(np.uint8)


def check(fm, got, want, qry, **kw):
    """got (the port's seeds) equal want (the JAX package's) array for
    array and the naive scan as a set."""
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    naive = naive_lmem_seeds(
        fm.genome.codes_fwd_rc(), qry, min_seed_length=kw["min_seed_length"],
        max_seed_freq=kw.get("max_seed_freq", 100), chunk=kw["chunk"],
        sensitive=kw.get("sensitive", False))
    assert sorted(zip(*(x.tolist() for x in got))) == sorted(naive)


@pytest.mark.parametrize("seed,chunk,sensitive,n_segments", [
    (4, 500, False, 8), (5, 400, True, 4), (6, 512, False, 16)])
def test_segments_match_naive_and_jax(seed, chunk, sensitive, n_segments):
    """tests/test_seeding.py::test_seeding_matches_naive with segments."""
    rng = np.random.default_rng(seed)
    ref = random_genome(rng, 2000)
    fm, dfm, jdfm = indexes(ref)
    qry = mutate(ref, rng, 0.02)
    qry[100:103] = 4
    kw = dict(min_seed_length=12, max_seed_freq=100, sensitive=sensitive,
              chunk=chunk, n_segments=n_segments)
    stats = {}
    got = tseeding.find_seeds(dfm, qry, stats=stats, **kw)
    check(fm, got, jseeding.find_seeds(jdfm, qry, **kw), qry, **kw)
    assert stats["scan_lanes"] == sum(-(-min(chunk, 2000 - c) //
                                        (chunk // n_segments))
                                      for c in range(0, 2000, chunk))
    assert stats["host_s"] >= 0


@pytest.mark.parametrize("slack,n_segments", [(20, 8), (40, 4), (10, 16)])
def test_poisoned_segments_match_naive_and_jax(slack, n_segments):
    """tests/test_seeding.py::test_seeding_poisoned_segments_match_naive:
    a tiny slack and an exact 600 bp region clip extensions at the
    artificial bounds; the poisoned lanes' spans are re-scanned in fixup
    rounds."""
    rng = np.random.default_rng(123)
    ref = random_genome(rng, 3000)
    fm, dfm, jdfm = indexes(ref)
    qry = mutate(ref, rng, 0.01)
    qry[800:1400] = ref[800:1400]
    kw = dict(min_seed_length=12, max_seed_freq=100, chunk=1000,
              n_segments=n_segments, slack=slack)
    stats = {}
    got = tseeding.find_seeds(dfm, qry, stats=stats, **kw)
    check(fm, got, jseeding.find_seeds(jdfm, qry, **kw), qry, **kw)
    assert stats["poisoned_at_bound"][0] > 0
    assert len(stats["scan_iterations"]) > 1
    # the fixup rounds clip at the chunks' ends: never at a bound
    assert sum(stats["poisoned_at_bound"][1:]) == 0


def jax_lane(jdfm, qc, starts, bounds, prm):
    """The JAX package's scan (_run_scan) of the lanes, as a list of
    (qs, ls, k0, fr, n, exit, poison) per lane."""
    q_rows = jseeding._build_qrows(jnp.asarray(qc))
    res = jseeding._run_scan(
        jdfm, q_rows, starts.astype(np.int32),
        *(b.astype(np.int32) for b in bounds), prm.min_seed_length,
        prm.max_seed_freq, prm.sensitive, prm.max_out, init12=prm.init12)
    return [res.lane(i) for i in range(len(starts))]


@pytest.mark.parametrize("sa_intv", [8, 1])
def test_first_round_lanes_match_the_jax_scan(sa_intv):
    """The first round's segment lanes (slack 20: many poisoned at their
    bound; on the full-SA index in direct mode too): each lane's records,
    count, exit cursor and poison position from the plain step equal the
    JAX _seed_scan_impl's on the same emit, ext and hard bounds, and so do
    a fixup round's."""
    rng = np.random.default_rng(123)
    ref = random_genome(rng, 3000)
    _, dfm, jdfm = indexes(ref, sa_intv=sa_intv)
    qry = mutate(ref, rng, 0.01)
    qry[800:1400] = ref[800:1400]
    rounds = []
    tseeding.find_seeds(dfm, qry, rounds=rounds, min_seed_length=12,
                        chunk=1000, n_segments=8, slack=20)
    assert len(rounds) > 1
    qc = np.full(3000, 4, np.uint8)
    qc[:len(qry)] = qry
    for r, (q_rows, starts, bounds, prm, st, recs) in enumerate(rounds[:2]):
        assert bounds.shape == (3, len(starts))
        # segment lanes clip before the chunk's end, fixup lanes at it
        assert (bounds[1] < bounds[2]).any() == (r == 0)
        want = jax_lane(jdfm, qc, starts, bounds, prm)
        qs = tseeding.record_starts(starts, st, recs)
        ends = np.cumsum(st[tseeding.F_OUT_N])
        for i, (wq, wl, wk, wf, wn, wexit, wpoi) in enumerate(want):
            b, e = ends[i] - st[tseeding.F_OUT_N, i], ends[i]
            assert st[tseeding.F_OUT_N, i] == wn
            np.testing.assert_array_equal(qs[b:e], wq)
            np.testing.assert_array_equal(recs[b:e, 0] >> 16, wl)
            np.testing.assert_array_equal(recs[b:e, 1], wk)
            np.testing.assert_array_equal(recs[b:e, 2], wf)
            assert (st[tseeding.F_CURSOR, i], st[tseeding.F_POISON, i]) \
                == (wexit, wpoi)
    st0 = rounds[0][4]
    assert (st0[tseeding.F_POISON] != tseeding.POISON_NONE).sum() > 2


@pytest.mark.parametrize("where", ["wide", "mesh", "row_blocks"])
def test_segments_on_wide_meshed_and_row_sharded_tables(where):
    """Segments (n_segments 8, and 16 with slack 10) on a forced-wide
    index, over a 2-entry CPU mesh (the lanes of each round in two
    stripes, the bounds cut with them) and on an index cut into 3 row
    blocks (lanes whole): the JAX package's seeds and the naive scan's."""
    rng = np.random.default_rng(77)
    ref = random_genome(rng, 2500)
    fm, dfm, jdfm = indexes(ref, force_wide=where == "wide")
    qry = mutate(ref, rng, 0.01)
    qry[900:1500] = ref[900:1500]
    kw = {}
    if where == "mesh":
        kw["mesh"] = mesh_lib.make_mesh(["cpu"] * 2)
    elif where == "row_blocks":
        dfm = mesh_lib.shard_index_rows(dfm, mesh_lib.make_mesh(["cpu"] * 3))
        assert dfm.row_shards is not None
    for n_segments, slack in ((8, 600), (16, 10)):
        args = dict(min_seed_length=12, chunk=700, n_segments=n_segments,
                    slack=slack)
        stats = {}
        got = tseeding.find_seeds(dfm, qry, stats=stats, **args, **kw)
        check(fm, got, jseeding.find_seeds(jdfm, qry, **args), qry, **args)
        assert stats["scan_launches"][0] == (2 if where == "mesh" else 1)
        if slack == 10:
            assert stats["poisoned_at_bound"][0] > 0


def test_segments_in_pallas_mode_match_jax_pallas(monkeypatch):
    """GSALIGN_SA_MODE=pallas with segments and 8 compaction slots: the
    JAX package's seeds under its Pallas gather in interpret mode and, lane
    for lane on the first round's segment lanes, its iteration counts
    (lanes stall for the slots)."""
    rng = np.random.default_rng(78)
    ref = random_genome(rng, 2500)
    fm, dfm, jdfm = indexes(ref, sa_intv=1)
    qry = mutate(ref, rng, 0.003)
    kw = dict(min_seed_length=12, max_seed_freq=100, chunk=400,
              n_segments=4, slack=20)
    monkeypatch.setenv("GSALIGN_SA_MODE", "pallas_interp")
    monkeypatch.setattr(jseeding, "_SA_GATHER_K", 8)
    jax.clear_caches()           # _SA_GATHER_K is read at trace time
    try:
        want = jseeding.find_seeds(jdfm, qry, **kw)
        monkeypatch.setenv("GSALIGN_SA_MODE", "pallas")
        monkeypatch.setattr(tseeding, "_SA_GATHER_K", 8)
        rounds, stats = [], {}
        got = tseeding.find_seeds(dfm, qry, rounds=rounds, stats=stats, **kw)
        check(fm, got, want, qry, **kw)
        q_rows, starts, bounds, prm, st, _ = rounds[0]
        assert prm.sa_mode == "pallas" and len(starts) == 25
        lanes = tseeding.ScanLanes.start(starts, bounds, prm.max_out, "cpu")
        tseeding.scan_lockstep(dfm, q_rows, lanes, prm, plain=True)
        assert lanes.counters[tseeding.C_STALLED] > 0
        monkeypatch.setenv("GSALIGN_SA_MODE", "pallas_interp")
        qc = np.full(2800, 4, np.uint8)          # 7 chunks of 400
        qc[:len(qry)] = qry
        jax_lane(jdfm, qc, starts, bounds, prm)
        np.testing.assert_array_equal(
            st[tseeding.F_STEPS], jseeding._fetch_scan.last_finish_iters)
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("n_segments", [1, 8])
def test_init12_off_matches_jax(n_segments):
    """init12=False (no INIT-order jump, so more steps): the JAX package's
    seeds, with and without segments."""
    rng = np.random.default_rng(31)
    ref = random_genome(rng, 2000)
    fm, dfm, jdfm = indexes(ref, sa_intv=1)
    qry = mutate(ref, rng, 0.02)
    kw = dict(min_seed_length=15, chunk=500, n_segments=n_segments,
              slack=40)
    on, off = [], []
    got = tseeding.find_seeds(dfm, qry, init12=False, rounds=off, **kw)
    check(fm, got, jseeding.find_seeds(jdfm, qry, init12=False, **kw), qry,
          **kw)
    tseeding.find_seeds(dfm, qry, rounds=on, **kw)
    assert not off[0][3].init12 and on[0][3].init12
    assert off[0][4][tseeding.F_STEPS].sum() > on[0][4][tseeding.F_STEPS].sum()


def test_lane_bounds_take_one_or_three_rows():
    starts = np.array([0, 10, 20])
    one = tseeding.lane_bounds(starts, np.array([5, 15, 25]))
    assert one.tolist() == [[5, 15, 25]] * 3
    three = np.array([[5, 15, 25], [8, 18, 25], [9, 30, 40]])
    lanes = tseeding.ScanLanes.start(starts, three, 4, "cpu")
    assert lanes.emit_stops.tolist() == [5, 15, 25]
    assert lanes.ext_stops.tolist() == [8, 18, 25]
    assert lanes.hard_stops.tolist() == [9, 30, 40]
    assert (lanes.max_emit, lanes.max_len) == (5, 8)
    with pytest.raises(ValueError, match="emit <= ext <= hard"):
        tseeding.lane_bounds(starts, three[[1, 0, 2]])
    with pytest.raises(ValueError, match=r"\[B\] or \[3, B\]"):
        tseeding.lane_bounds(starts, three[:2])


def test_step_cap_bounds_segment_lanes():
    """_step_cap(E, X) = E (2 X - E + 4): X (X + 4) for one bound, and at
    least the sum over the E cursors of 2 (X - i) + 3 steps."""
    for E, X in ((0, 0), (1, 1), (7, 7), (5, 30), (1250, 1850)):
        assert seed_cuda._step_cap(E, X) == \
            sum(2 * (X - i) + 3 for i in range(E))
    assert seed_cuda._step_cap(7) == seed_cuda._step_cap(7, 7) == 7 * 11
    assert seed_cuda._win_words(1850) == (1850 >> 4) + 20


def test_poison_causes_tell_a_bound_from_a_full_buffer():
    st = np.zeros((tseeding.N_FIELDS, 4), np.int64)
    st[tseeding.F_POISON] = [tseeding.POISON_NONE, 30, 50, 70]
    st[tseeding.F_OUT_N] = [1, 1, 2, 2]
    # lane 1 has room; lane 2 is full with its last record at its poison
    # (a clipped hit); lane 3 is full below its poison (an overflow)
    qs = np.array([5, 10, 20, 50, 60, 65])
    assert tseeding.poison_causes(st, qs, max_out=2) == (2, 1)


def test_segments_reject_what_jax_refuses():
    rng = np.random.default_rng(2)
    _, dfm, _ = indexes(random_genome(rng, 300))
    qry = random_genome(rng, 100)
    with pytest.raises(ValueError, match="plus slack"):
        tseeding.find_seeds(dfm, qry, chunk=65_000, slack=600)
    with pytest.raises(ValueError, match="n_segments"):
        tseeding.find_seeds(dfm, qry, chunk=50, n_segments=0)
    tseeding.find_seeds(dfm, qry, chunk=65_000, slack=535)
    # one-base segments (more segments than bases a chunk): every start its
    # own lane, the seeds of one lane a chunk
    a = tseeding.find_seeds(dfm, qry, min_seed_length=8, chunk=100)
    b = tseeding.find_seeds(dfm, qry, min_seed_length=8, chunk=100,
                            n_segments=128, slack=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_exp_seeding_tool_on_the_cpu(tmp_path, capsys):
    """gsalign_tpu_torch/tools/exp_seeding.py on a pair directory of its
    own: the JAX tool's JSON keys, and at 8 segments the seeds of 1."""
    import json
    from gsalign_tpu_torch.genome.fasta import read_fasta
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index.io import save_index
    from gsalign_tpu_torch.tools import exp_seeding
    from tests.make_testdata import make_pair, write_fasta
    d = tmp_path / "pair"
    d.mkdir()
    ref, qry = make_pair(total_len=30_000)
    write_fasta(str(d / "ref.fa"), ref)
    write_fasta(str(d / "qry.fa"), qry)
    save_index(build_fmindex(pack_genome(read_fasta(str(d / "ref.fa")))),
               str(d / "ref_idx"))
    out = {}
    for n in (1, 8):
        assert exp_seeding.main(["pair", str(n), "1", "--dir", str(tmp_path),
                                 "--device", "cpu"]) == 0
        out[n] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("tag", "n_segments", "best_s", "all_s", "n_seeds",
                "finish_iter_pct"):
        assert key in out[8]
    assert out[8]["n_seeds"] == out[1]["n_seeds"] > 0
    assert out[8]["n_segments"] == 8 and out[8]["device"] == "cpu"
    assert out[8]["round_lanes"][0] > out[1]["round_lanes"][0]
    assert out[8]["finish_iter_pct"]["p100"] > 0
