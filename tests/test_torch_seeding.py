"""Seeding parity of the PyTorch port (gsalign_tpu_torch.ops.seeding)
against the naive reference scan (tests/helpers.naive_lmem_seeds) and the
JAX package's find_seeds_all, mirroring tests/test_seeding.py. Seed sets
are integer triples: every comparison is exact."""

import jax
import numpy as np
import pytest
import torch

from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.ops import rank as jrank
from gsalign_tpu.ops import seeding as jseeding
from gsalign_tpu_torch.genome.packing import Genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import seeding as tseeding
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from gsalign_tpu_torch.ops.seeding import find_seeds, find_seeds_all
from tests.helpers import naive_lmem_seeds, random_genome
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def genome_of(chroms):
    lens = np.asarray([len(c) for c in chroms])
    return Genome(names=[f"c{i}" for i in range(len(chroms))], lengths=lens,
                  offsets=np.concatenate([[0], np.cumsum(lens)[:-1]]),
                  holes=[], codes_fwd=np.concatenate(chroms))


def index_pair(chroms):
    g = genome_of(chroms)
    tfm = build_fmindex(g, sa_intv=1)
    jfm = jbuild(g, sa_intv=1, prefer_device=False)
    return (tfm, DeviceFMIndex.from_host(tfm, "cpu"),
            jrank.DeviceFMIndex.from_host(jfm))


def mutate(codes, rng, sub_rate=0.02):
    out = codes.copy()
    subs = rng.random(len(out)) < sub_rate
    out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
    return out.astype(np.uint8)


def as_set(res):
    q_pos, r_pos, length = res
    return sorted(zip(q_pos.tolist(), r_pos.tolist(), length.tolist()))


def check_all(fm, dfm, jdfm, queries, **kw):
    """Port == JAX per chromosome (same order), and == the naive scan."""
    got = find_seeds_all(dfm, queries, **kw)
    want = jseeding.find_seeds_all(jdfm, queries, **kw)
    text = fm.genome.codes_fwd_rc()
    for g, w, q in zip(got, want, queries):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        naive = naive_lmem_seeds(
            text, q, min_seed_length=kw["min_seed_length"],
            max_seed_freq=kw.get("max_seed_freq", 100), chunk=kw["chunk"],
            sensitive=kw.get("sensitive", False))
        assert as_set(g) == sorted(naive)
    return got


@pytest.mark.parametrize("seed,chunk,sensitive", [
    (1, 500, False), (2, 300, False), (3, 500, True)])
def test_seeding_matches_naive_and_jax(seed, chunk, sensitive):
    rng = np.random.default_rng(seed)
    ref = random_genome(rng, 2000)
    fm, dfm, jdfm = index_pair([ref])
    qry = mutate(ref, rng)
    qry[100:103] = 4                       # ambiguous bases
    got = check_all(fm, dfm, jdfm, [qry], min_seed_length=12,
                    max_seed_freq=100, sensitive=sensitive, chunk=chunk)
    assert len(got[0][0]) > 0


def test_seeding_output_sorted_by_posdiff():
    rng = np.random.default_rng(9)
    ref = random_genome(rng, 1500)
    _, dfm, _ = index_pair([ref])
    q_pos, r_pos, _ = find_seeds(dfm, mutate(ref, rng, 0.01),
                                 min_seed_length=12, chunk=400)
    key = list(zip((r_pos - q_pos).tolist(), q_pos.tolist()))
    assert key == sorted(key)


def test_seeding_rc_strand():
    """Seeds on the reverse-complement strand are found (rPos >= N)."""
    rng = np.random.default_rng(11)
    ref = random_genome(rng, 800)
    fm, dfm, jdfm = index_pair([ref])
    qry = (3 - ref[100:400][::-1]).astype(np.uint8)
    got = check_all(fm, dfm, jdfm, [qry], min_seed_length=12, chunk=500)
    assert (got[0][1] >= fm.genome.size).any()


def test_seeding_multi_chromosome_with_ambiguity():
    rng = np.random.default_rng(21)
    refs = [random_genome(rng, n) for n in (900, 1300, 700)]
    fm, dfm, jdfm = index_pair(refs)
    queries = [mutate(r, rng) for r in refs[::-1]]
    queries[0][50:70] = 4
    queries[1][5] = 4
    queries.append(np.full(40, 4, np.uint8))      # all-N chromosome
    got = check_all(fm, dfm, jdfm, queries, min_seed_length=12, chunk=450)
    assert [len(g[0]) > 0 for g in got] == [True, True, True, False]


@pytest.mark.parametrize("cap,sensitive", [(2, False), (5, False),
                                           (3, True)])
def test_seeding_emit_overflow_matches_naive_and_jax(cap, sensitive):
    """A tiny emit buffer forces overflow -> poison -> re-scan rounds."""
    rng = np.random.default_rng(77)
    ref = random_genome(rng, 2500)
    fm, dfm, jdfm = index_pair([ref])
    stats = {}
    qry = mutate(ref, rng)
    check_all(fm, dfm, jdfm, [qry], min_seed_length=12, max_seed_freq=100,
              chunk=600, sensitive=sensitive, max_out_cap=cap)
    find_seeds_all(dfm, [qry], min_seed_length=12, chunk=600,
                   sensitive=sensitive, max_out_cap=cap, stats=stats)
    assert len(stats["scan_iterations"]) > 1
    assert stats["scan_lanes"] == 5


def test_seeding_on_jax_built_tables():
    """The scan over tables taken from the JAX DeviceFMIndex gives the same
    seeds as over the port's own tables."""
    from gsalign_tpu_torch.ops.rank import tables_from_jax
    rng = np.random.default_rng(5)
    ref = random_genome(rng, 1800)
    fm, dfm, jdfm = index_pair([ref])
    alt = DeviceFMIndex.from_tables(
        tables_from_jax(jdfm), host_sa=np.asarray(jdfm._host_sa),
        seq_len=jdfm.seq_len, primary=jdfm.primary, device="cpu")
    qry = mutate(ref, rng)
    a = find_seeds(dfm, qry, min_seed_length=15, chunk=700)
    b = find_seeds(alt, qry, min_seed_length=15, chunk=700)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_seeding_rejects_oversized_chunk():
    rng = np.random.default_rng(1)
    _, dfm, _ = index_pair([random_genome(rng, 300)])
    with pytest.raises(ValueError):
        find_seeds(dfm, random_genome(rng, 100), chunk=70000)
    assert dfm.device == torch.device("cpu")


_JAX_PALLAS = {}     # K -> JAX seeds under pallas_interp (computed once)


def jax_pallas_seeds(monkeypatch, jdfm, qry, K, **kw):
    """The JAX package's find_seeds_all with its Pallas masked gather in
    interpret mode and K compaction slots (as tests/test_seeding.py)."""
    if K not in _JAX_PALLAS:
        monkeypatch.setenv("GSALIGN_SA_MODE", "pallas_interp")
        monkeypatch.setattr(jseeding, "_SA_GATHER_K", K)
        # _SA_GATHER_K is read at trace time inside the jitted scan
        jax.clear_caches()
        _JAX_PALLAS[K] = jseeding.find_seeds_all(jdfm, [qry], **kw)[0]
        monkeypatch.delenv("GSALIGN_SA_MODE")
        jax.clear_caches()
    return _JAX_PALLAS[K]


@pytest.mark.parametrize("gather_k", [8, 64])
@pytest.mark.parametrize("sa_mode", ["xla", "pallas"])
def test_seeding_sa_modes_match_naive_and_jax_pallas(monkeypatch, sa_mode,
                                                     gather_k):
    """Both direct-mode SA reads give the naive scan's seeds and the JAX
    package's under its Pallas gather with the same K; a K far below the
    lane count makes lanes stall and retry in pallas mode, which costs
    iterations and changes no seed."""
    rng = np.random.default_rng(77)
    ref = random_genome(rng, 2500)
    fm, dfm, jdfm = index_pair([ref])
    assert dfm.direct_ok
    qry = mutate(ref, rng, sub_rate=0.02)
    kw = dict(min_seed_length=12, max_seed_freq=100, chunk=100)
    want = jax_pallas_seeds(monkeypatch, jdfm, qry, gather_k, **kw)
    monkeypatch.setattr(tseeding, "_SA_GATHER_K", gather_k)
    monkeypatch.setenv("GSALIGN_SA_MODE", sa_mode)
    stats, xla_stats = {}, {}
    got = find_seeds_all(dfm, [qry], stats=stats, **kw)[0]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    naive = naive_lmem_seeds(fm.genome.codes_fwd_rc(), qry, **kw)
    assert as_set(got) == sorted(naive)
    monkeypatch.setenv("GSALIGN_SA_MODE", "xla")
    find_seeds_all(dfm, [qry], stats=xla_stats, **kw)
    monkeypatch.setenv("GSALIGN_SA_MODE", sa_mode)
    assert stats["scan_lanes"] == 25
    if sa_mode == "xla":
        assert stats == xla_stats
    else:
        # one slot: every iteration with two entering lanes stalls one
        monkeypatch.setattr(tseeding, "_SA_GATHER_K", 1)
        one = {}
        got1 = find_seeds_all(dfm, [qry], stats=one, **kw)
        for a, b in zip(got1[0], want):
            np.testing.assert_array_equal(a, b)
        assert one["scan_iterations"][0] > xla_stats["scan_iterations"][0]
        assert stats["scan_iterations"][0] >= \
            xla_stats["scan_iterations"][0]


def test_sa_mode_comes_from_the_environment(monkeypatch):
    rng = np.random.default_rng(3)
    _, dfm, _ = index_pair([random_genome(rng, 400)])
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    assert tseeding.pick_sa_mode(dfm) == "xla"
    for mode in ("xla", "pallas"):
        monkeypatch.setenv("GSALIGN_SA_MODE", mode)
        assert tseeding.pick_sa_mode(dfm) == mode
    for mode in ("xlak", "pallas_interp", "none", "bogus"):
        monkeypatch.setenv("GSALIGN_SA_MODE", mode)
        with pytest.raises(ValueError, match="not carried"):
            tseeding.pick_sa_mode(dfm)
        with pytest.raises(ValueError):
            find_seeds(dfm, random_genome(rng, 100), chunk=50)


def test_sa_slots_compact_in_lane_order():
    """pallas mode's compaction: needy lanes take slots 0, 1, ... in lane
    order, lanes past K get -1, and unused slots read index -1."""
    rng = np.random.default_rng(4)
    _, dfm, _ = index_pair([random_genome(rng, 400)])
    B, K = 7, 3
    lanes = tseeding.ScanLanes.start(np.zeros(B), np.full(B, 10), 4, "cpu")
    need = np.array([0, 1, 1, 0, 1, 1, 0], bool)
    lanes.st[tseeding.F_PHASE] = torch.from_numpy(need.astype(np.int64))
    lanes.st[tseeding.F_IK2] = 1
    lanes.st[tseeding.F_DIR_SET, 2] = 1          # lane 2 already resolved
    lanes.st[tseeding.F_IK1] = torch.arange(B) * 10
    seen = []

    def fake_gather(table, idx):
        seen.append(idx.tolist())
        return idx
    slot, res = tseeding._sa_slots(dfm, lanes, K, fake_gather)
    assert slot.tolist() == [-1, 0, -1, -1, 1, 2, -1]
    assert seen == [[10, 40, 50]]
    lanes.st[tseeding.F_PHASE] = 0
    lanes.st[tseeding.F_PHASE, 5] = 1
    slot, _ = tseeding._sa_slots(dfm, lanes, K, fake_gather)
    assert slot.tolist() == [-1, -1, -1, -1, -1, 0, -1]
    assert seen[-1] == [50, -1, -1]


_JAX_LOCKSTEP = {}   # K -> (JAX seeds, per-lane finish iterations)


@pytest.mark.parametrize("gather_k", [2, 8, 512])
def test_scan_lockstep_pallas_matches_jax_seeds_and_iterations(monkeypatch,
                                                               gather_k):
    """scan_lockstep(plain=True), the plain version of the seed_lockstep
    kernel, in pallas mode with K slots: the JAX package's seeds under its
    Pallas gather in interpret mode and, lane for lane, its iteration
    counts (a near-identical query sends all 25 lanes into direct mode in
    the same iterations, so K = 8 stalls lanes). The JAX kernel needs
    K % 8 == 0, so K = 2 is held against its K = 8 seeds and must take
    more iterations."""
    rng = np.random.default_rng(78)
    ref = random_genome(rng, 2500)
    fm, dfm, jdfm = index_pair([ref])
    qry = mutate(ref, rng, sub_rate=0.003)
    kw = dict(min_seed_length=12, max_seed_freq=100, chunk=100)
    jax_k = max(gather_k, 8)
    if jax_k not in _JAX_LOCKSTEP:
        monkeypatch.setenv("GSALIGN_SA_MODE", "pallas_interp")
        monkeypatch.setattr(jseeding, "_SA_GATHER_K", jax_k)
        jax.clear_caches()     # _SA_GATHER_K is read at trace time
        seeds = jseeding.find_seeds_all(jdfm, [qry], **kw)[0]
        _JAX_LOCKSTEP[jax_k] = (
            seeds, np.asarray(jseeding._fetch_scan.last_finish_iters))
        jax.clear_caches()
    want, want_iters = _JAX_LOCKSTEP[jax_k]
    monkeypatch.setattr(tseeding, "_SA_GATHER_K", gather_k)
    monkeypatch.setenv("GSALIGN_SA_MODE", "pallas")
    rounds, stats = [], {}
    got = find_seeds_all(dfm, [qry], stats=stats, rounds=rounds, **kw)[0]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(rounds) == 1 and stats["scan_lanes"] == 25
    q_rows, starts, stops, prm, st, _ = rounds[0]
    assert prm.sa_mode == "pallas"
    lanes = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    n_iter = tseeding.scan_lockstep(dfm, q_rows, lanes, prm, plain=True)
    np.testing.assert_array_equal(lanes.st.numpy(), st)
    c = lanes.counters.tolist()
    assert c[tseeding.C_ITERS] == n_iter == stats["scan_iterations"][0]
    assert c[tseeding.C_LIVE] == 0 and c[tseeding.C_GATHERED] > 0
    assert (c[tseeding.C_STALLED] > 0) == (gather_k < 25)
    if gather_k == jax_k:
        np.testing.assert_array_equal(st[tseeding.F_STEPS], want_iters)
    else:
        assert n_iter > want_iters.max()


@pytest.mark.parametrize("sa_mode,max_iters", [("pallas", 5), ("xla", 3),
                                               ("pallas", 1)])
def test_max_iters_leaves_the_state_of_that_many_plain_steps(monkeypatch,
                                                             sa_mode,
                                                             max_iters):
    """seed_lockstep on CPU tensors runs its plain version: max_iters = n
    leaves the state, records and counters that n calls of seed_step_plain
    (after _sa_slots in pallas mode) leave, no launch is counted, and
    seed_step is one such iteration."""
    from gsalign_tpu_torch.ops import seed_cuda
    from gsalign_tpu_torch.ops.gather import masked_gather_plain
    rng = np.random.default_rng(79)
    ref = random_genome(rng, 2500)
    _, dfm, _ = index_pair([ref])
    qry = mutate(ref, rng, sub_rate=0.003)
    monkeypatch.setattr(tseeding, "_SA_GATHER_K", 4)
    monkeypatch.setenv("GSALIGN_SA_MODE", sa_mode)
    rounds = []
    find_seeds_all(dfm, [qry], rounds=rounds, min_seed_length=12, chunk=100)
    q_rows, starts, stops, prm = rounds[0][:4]
    want = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    gathered = stalled = 0
    for _ in range(max_iters):
        slot = res_k = None
        if sa_mode == "pallas":
            slot, res_k = tseeding._sa_slots(dfm, want, 4,
                                             masked_gather_plain)
            gathered += int((slot >= 0).sum())
            stalled += int(tseeding._sa_need(want.st).sum()
                           - (slot >= 0).sum())
        live = int(tseeding.seed_step_plain(dfm, q_rows, want, prm, slot,
                                            res_k))
    lanes = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    n0 = (seed_cuda.seed_lockstep.launches, seed_cuda.seed_step.launches)
    if max_iters == 1:
        assert seed_cuda.seed_step(dfm, q_rows, lanes, prm) == live
        counters = lanes.counters.numpy()
    else:
        st, counters = seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm,
                                               max_iters=max_iters)
        np.testing.assert_array_equal(st, want.st.numpy())
    assert (seed_cuda.seed_lockstep.launches,
            seed_cuda.seed_step.launches) == n0
    assert torch.equal(lanes.st, want.st)
    assert torch.equal(lanes.out, want.out)
    assert counters.tolist() == [max_iters, live, gathered, stalled]
    assert live > 0
    # going on from there ends where an uninterrupted scan ends
    whole = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    n_iter = tseeding.scan_lockstep(dfm, q_rows, whole, prm, plain=True)
    rest = seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm)[1]
    assert rest[tseeding.C_ITERS] == n_iter - max_iters
    assert torch.equal(lanes.st, whole.st)
    assert torch.equal(lanes.out, whole.out)
