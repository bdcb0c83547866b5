"""The hand-written kernels (DP, masked_gather, seed_scan, seed_lockstep
and as one iteration of it seed_step, resolve_sa, and the row decode alone,
occ_rows) against their plain torch versions on a CUDA card, on narrow and
wide indexes, the five stage probes of gsalign_tpu_torch/tools/ on the
bench's 4.6 Mb pair, and the cost probes (seedcost, gather_sweep) against
their plain versions and through exp_seedcost and exp_sweep. Every test skips
without a card. This file imports no JAX, so it runs on a machine without
it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gsalign_tpu_torch.genome.packing import Genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import dp as tdp
from gsalign_tpu_torch.ops import dp_cuda, gather, rank, seed_cuda, seeding
# by module name: pytest puts tests/ on sys.path, and `tests.` would find
# an installed package of that name first where one exists
from dp_cases import (edge_batch, load_oracle, make_batch, max_abs_err,
                      oracle_batch, oracle_rows)
from torch_rows import carry_rows


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L,B", [(64, 256), (256, 64), (512, 16),
                                 (2048, 2), (3072, 1)])
def test_kernels_match_plain_on_card(card, L, B):
    args = [torch.from_numpy(a).to(card)
            for a in make_batch(np.random.default_rng(L + 1), L, B)]
    plain = tdp.dp_align_batch(*args, L).cpu().numpy()
    kernels = [dp_cuda.dp_any] + ([dp_cuda.dp_small]
                                  if L <= dp_cuda.SMALL_MAX_L else [])
    for fn in kernels:
        n0 = fn.launches
        got = fn(*args, L)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        assert max_abs_err(got.cpu().numpy(), plain) == 0


@pytest.mark.cuda
def test_kernels_match_ksw2_oracle_on_card(card):
    cases, outs = load_oracle()
    args = [torch.from_numpy(a).to(card) for a in oracle_batch(cases, 256)]
    for fn in (dp_cuda.dp_small, dp_cuda.dp_any):
        assert oracle_rows(cases, fn(*args, 256).cpu().numpy()) == outs


def on_card(card, host):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in host]


def plain_ops(args, L):
    """The plain version on the card under the kernels' contract (lengths
    clamped to [0, L])."""
    q, t, ql, tl = args
    return tdp.dp_align_batch(q, t, ql.clamp(0, L), tl.clamp(0, L),
                              L).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("L", [64, 256, 512])
def test_kernels_take_edge_problems_on_card(card, L):
    """Empty, one-base, full-width and over-long (clamped) problems."""
    args = on_card(card, edge_batch(np.random.default_rng(L), L))
    want = plain_ops(args, L)
    kernels = [dp_cuda.dp_any] + ([dp_cuda.dp_small]
                                  if L <= dp_cuda.SMALL_MAX_L else [])
    for fn in kernels:
        got = fn(*args, L).cpu().numpy()
        assert max_abs_err(got, want) == 0
        n = (got != tdp.OP_PAD).sum(axis=1)
        # ops from column 0 without holes, then OP_PAD to the end
        assert ((np.arange(2 * L)[None, :] < n[:, None])
                == (got != tdp.OP_PAD)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 4, 8])
def test_every_rows_a_lane_on_card(card, monkeypatch, K):
    """Each instance of the core (K rows a lane) through both kernels, with
    a batch that is not a multiple of the warps a block."""
    L, B = 64, 13
    args = on_card(card, make_batch(np.random.default_rng(K), L, B))
    want = plain_ops(args, L)
    monkeypatch.setattr(dp_cuda, "small_plan", lambda L: (K, 4))
    assert max_abs_err(dp_cuda.dp_small(*args, L).cpu().numpy(), want) == 0
    L, B = 512, 5
    args = on_card(card, make_batch(np.random.default_rng(K + 10), L, B))
    want = plain_ops(args, L)
    monkeypatch.setattr(dp_cuda, "any_plan",
                        lambda B, L, n_sm: (K, L // (32 * K), 1))
    assert max_abs_err(dp_cuda.dp_any(*args, L).cpu().numpy(), want) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("K,wpb,cs", [(4, 1, 1), (2, 3, 1), (4, 1, 2)])
def test_dp_any_runs_further_passes_when_the_chain_is_short(
        card, monkeypatch, K, wpb, cs):
    """A chain that covers fewer rows than the problem has runs two or more
    passes, the last row of a pass kept in the global row buffer."""
    L, B = 512, 6
    assert cs * wpb * 32 * K * 2 <= L
    monkeypatch.setattr(dp_cuda, "any_plan",
                        lambda B, L, n_sm: (K, wpb, cs))
    args = on_card(card, make_batch(np.random.default_rng(9), L, B))
    assert max_abs_err(dp_cuda.dp_any(*args, L).cpu().numpy(),
                       plain_ops(args, L)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,K", [(512, 3, 2), (2048, 2, 4)])
def test_dp_any_gives_equal_ops_for_every_cluster_size(card, monkeypatch, L,
                                                       B, K):
    """The chain spread over 1, 2 and 8 blocks of a cluster: the same ops."""
    args = on_card(card, make_batch(np.random.default_rng(L + 2), L, B))
    want = plain_ops(args, L)
    outs = []
    for cs in (1, 2, 8):
        monkeypatch.setattr(dp_cuda, "any_plan",
                            lambda B, L, n_sm: (K, L // (32 * K * cs),
                                                 cs))
        outs.append(dp_cuda.dp_any(*args, L).cpu().numpy())
        assert max_abs_err(outs[-1], want) == 0
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("L,plan", [(256, (4, 2, 1)), (512, (2, 2, 4)),
                                    (512, (8, 1, 1))])
def test_dp_any_scratch_decodes_to_the_plain_directions(card, monkeypatch, L,
                                                        plan):
    """The packed directions dp_any leaves in its scratch, read through
    dir_word_index, are the plain forward pass's nibbles, cell for cell.
    (dp_small's directions never leave shared memory; it shares the core.)"""
    B = 3
    kept = []
    scratch = dp_cuda.any_scratch

    def keep(*a):
        kept.append(scratch(*a))
        return kept[-1]
    monkeypatch.setattr(dp_cuda, "any_scratch", keep)
    monkeypatch.setattr(dp_cuda, "any_plan", lambda B, L, n_sm: plan)
    host = make_batch(np.random.default_rng(L + 3), L, B)
    args = on_card(card, host)
    dp_cuda.dp_any(*args, L)
    torch.cuda.synchronize()
    words = kept[0][0].cpu().numpy().view(np.uint32).reshape(B, -1)
    assert words.shape[1] * 4 == L * L // 2
    nib = tdp._dp_forward(*args, L).cpu().numpy()       # [2L-1, B, L]
    for b in range(B):
        i, j = np.meshgrid(np.arange(host[3][b]), np.arange(host[2][b]),
                           indexing="ij")
        w, n = dp_cuda.dir_word_index(L, plan[0], i, j)
        got = (words[b][w] >> (4 * n).astype(np.uint32)) & 15
        np.testing.assert_array_equal(got, nib[i + j, b, i])


@pytest.mark.cuda
def test_wrappers_keep_the_shapes_they_launched(card):
    L, B = 64, 5
    args = on_card(card, make_batch(np.random.default_rng(4), L, B))
    dp_cuda.dp_small(*args, L)
    dp_cuda.dp_any(*args, L)
    for fn in (dp_cuda.dp_small, dp_cuda.dp_any):
        got = fn.shapes[-1]
        assert got[0] == L and len(got) == 5
        assert all(a is b for a, b in zip(got[1:], args))
        assert len(fn.shapes) <= dp_cuda.KEPT_SHAPES


@pytest.mark.cuda
def test_dp_any_plans_for_the_card_it_runs_on(card):
    n_sm = dp_cuda.sm_count(card)
    assert n_sm == torch.cuda.get_device_properties(card).multi_processor_count
    # a batch that fills the card keeps a block a problem
    assert dp_cuda.any_plan(n_sm, 2048, n_sm)[2] == 1
    assert dp_cuda.any_plan(1, 2048, n_sm)[2] == dp_cuda.MAX_CLUSTER


@pytest.mark.cuda
def test_wrappers_raise_for_other_devices(card):
    q = torch.zeros((1, 64), dtype=torch.uint8, device=card)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="one device"):
        dp_cuda.dp_small(q, q, ln, ln, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("n,K", [(4096, 512), (3000, 64), (5, 3)])
def test_masked_gather_matches_plain_on_card(card, n, K):
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, n,
                                          dtype=np.int32)).to(card)
    idx = rng.integers(0, n, K).astype(np.int32)
    idx[rng.random(K) < 1 / 3] = -1
    idx = torch.from_numpy(idx).to(card)
    n0 = gather.masked_gather.launches
    got = gather.masked_gather(table, idx)
    torch.cuda.synchronize()
    assert gather.masked_gather.launches == n0 + 1
    assert torch.equal(got, gather.masked_gather_plain(table, idx))


def genome_and_queries(seed, lens=(3000, 1200)):
    rng = np.random.default_rng(seed)
    refs = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    g = Genome(names=[f"c{i}" for i in range(len(refs))],
               lengths=np.asarray(lens),
               offsets=np.concatenate([[0], np.cumsum(lens)[:-1]]),
               holes=[], codes_fwd=np.concatenate(refs))
    queries = []
    for r in refs[::-1]:
        q = r.copy()
        subs = rng.random(len(q)) < 0.02
        q[subs] = (q[subs] + rng.integers(1, 4, subs.sum())) % 4
        queries.append(q)
    queries[0][40:60] = 4
    queries.append((3 - refs[0][200:900][::-1]).astype(np.uint8))
    return g, queries


@pytest.mark.cuda
@pytest.mark.parametrize("sa_intv,sa_mode,K", [
    (1, "xla", 512), (1, "pallas", 512), (1, "pallas", 2), (8, "xla", 512)])
@pytest.mark.parametrize("sensitive", [False, True])
def test_seed_scan_kernels_match_plain_on_card(card, monkeypatch, sa_intv,
                                               sa_mode, K, sensitive):
    """The whole scan through its kernels (seed_scan, or in pallas mode
    seed_lockstep with the slots and the gather inside it; resolve_sa on a
    sampled index) against the plain step on the same card: the same
    seeds, and the same iteration count in every round."""
    monkeypatch.setattr(seeding, "_SA_GATHER_K", K)
    monkeypatch.setenv("GSALIGN_SA_MODE", sa_mode)
    g, queries = genome_and_queries(sa_intv + K)
    dfm = rank.DeviceFMIndex.from_host(build_fmindex(g, sa_intv=sa_intv),
                                       card)
    kw = dict(min_seed_length=12, sensitive=sensitive, chunk=300,
              max_out_cap=4)
    plain_stats, stats = {}, {}
    want = seeding.find_seeds_all(dfm, queries, plain=True,
                                  stats=plain_stats, **kw)
    n0 = (seed_cuda.seed_lockstep.launches, gather.masked_gather.launches,
          seed_cuda.resolve_sa.launches, seed_cuda.seed_scan.launches,
          seed_cuda.seed_lockstep.gathered, seed_cuda.seed_lockstep.stalled,
          seed_cuda.seed_step.launches)
    got = seeding.find_seeds_all(dfm, queries, stats=stats, **kw)
    assert stats == plain_stats
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    lock = sa_mode == "pallas" and sa_intv == 1
    # one launch a round: seed_lockstep in pallas mode, else seed_scan;
    # no launch an iteration, and the gather runs inside seed_lockstep
    rounds = len(stats["scan_iterations"])
    assert seed_cuda.seed_lockstep.launches - n0[0] == (rounds if lock else 0)
    assert seed_cuda.seed_scan.launches - n0[3] == (0 if lock else rounds)
    assert seed_cuda.seed_step.launches == n0[6]
    assert gather.masked_gather.launches == n0[1]
    assert (seed_cuda.seed_lockstep.gathered > n0[4]) == lock
    assert (seed_cuda.seed_lockstep.stalled > n0[5]) == (lock and K == 2)
    assert (seed_cuda.resolve_sa.launches > n0[2]) == (sa_intv > 1)


def scan_cases(dfm, queries, **kw):
    """find_seeds_all's scan_lanes inputs, one per round: [(q_rows, starts,
    stops, prm)]."""
    rounds = []
    seeding.find_seeds_all(dfm, queries, rounds=rounds, **kw)
    return [r[:4] for r in rounds]


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 4])
@pytest.mark.parametrize("sensitive", [False, True])
@pytest.mark.parametrize("sa_intv", [1, 8])
def test_seed_scan_matches_plain_and_lockstep_on_card(card, monkeypatch,
                                                      sa_intv, sensitive,
                                                      cap):
    """seed_scan against the plain scan and against the seed_lockstep
    scan, round by round (a small emit buffer forces overflow
    re-scans): equal records and equal final lane state (exits, poison,
    per-lane steps), on all lanes, on one lane and on a lane count that is
    not a multiple of the block's four."""
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    g, queries = genome_and_queries(sa_intv + 50)
    queries.append(g.codes_fwd[100:1100].copy())   # direct mode past 256
    dfm = rank.DeviceFMIndex.from_host(build_fmindex(g, sa_intv=sa_intv),
                                       card)
    cases = scan_cases(dfm, queries, min_seed_length=12,
                       sensitive=sensitive, chunk=300, max_out_cap=cap)
    assert (len(cases) > 1) == (cap is not None)
    assert len(cases[0][1]) % 4 != 0
    for q_rows, starts, stops, prm in cases:
        for sub in (slice(None), slice(0, 1), slice(1, 7)):
            s, e = starts[sub], stops[sub]
            if len(s) == 0:
                continue
            n0 = (seed_cuda.seed_scan.launches,
                  seed_cuda.seed_lockstep.launches)
            st, recs = seeding.scan_lanes(dfm, q_rows, s, e, prm)
            assert seed_cuda.seed_scan.launches == n0[0] + 1
            assert seed_cuda.seed_lockstep.launches == n0[1]
            st_p, recs_p = seeding.scan_lanes(dfm, q_rows, s, e, prm,
                                              plain=True)
            np.testing.assert_array_equal(st, st_p)
            np.testing.assert_array_equal(recs, recs_p)
            lanes = seeding.ScanLanes.start(s, e, prm.max_out, card)
            n_iter = seeding.scan_lockstep(dfm, q_rows, lanes, prm,
                                           plain=False)
            assert seed_cuda.seed_lockstep.launches == n0[1] + 1
            assert n_iter == st[seeding.F_STEPS].max()
            assert lanes.counters.tolist() == [n_iter, 0, 0, 0]
            np.testing.assert_array_equal(lanes.st.cpu().numpy(), st)
            keep = np.arange(prm.max_out)[None, :] \
                < st[seeding.F_OUT_N][:, None]
            np.testing.assert_array_equal(lanes.out.cpu().numpy()[keep],
                                          recs)


def pallas_case(card, K, monkeypatch, seed=11):
    """(tables, q_rows, starts, stops, prm) of a first scan round in pallas
    mode with K compaction slots, and the plain lock-step scan's lanes."""
    import dataclasses
    monkeypatch.setattr(seeding, "_SA_GATHER_K", K)
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    g, queries = genome_and_queries(seed)
    dfm = rank.DeviceFMIndex.from_host(build_fmindex(g), card)
    q_rows, starts, stops, prm = scan_cases(
        dfm, queries, min_seed_length=12, chunk=150)[0]
    prm = dataclasses.replace(prm, sa_mode="pallas")
    plain = seeding.ScanLanes.start(starts, stops, prm.max_out, card)
    seeding.scan_lockstep(dfm, q_rows, plain, prm, plain=True)
    return dfm, q_rows, starts, stops, prm, plain


@pytest.mark.cuda
@pytest.mark.parametrize("K,max_blocks", [
    (512, None), (2, None), (2, 1), (2, 2), (512, 1)])
def test_seed_lockstep_matches_the_plain_loop_on_card(card, monkeypatch, K,
                                                      max_blocks):
    """seed_lockstep in pallas mode against the host loop of the plain
    step, slots and gather: equal lane state, counters (iterations, live,
    words gathered, stalls) and records, a warp a lane and with the grid
    capped so that a warp owns several lanes."""
    dfm, q_rows, starts, stops, prm, plain = pallas_case(card, K,
                                                         monkeypatch)
    assert len(starts) > 20
    lanes = seeding.ScanLanes.start(starts, stops, prm.max_out, card)
    n0 = seed_cuda.seed_lockstep.launches
    st, counters = seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm,
                                           max_blocks=max_blocks)
    assert seed_cuda.seed_lockstep.launches == n0 + 1
    assert torch.equal(lanes.buf, plain.buf)
    assert torch.equal(lanes.out, plain.out)
    np.testing.assert_array_equal(st, plain.st.cpu().numpy())
    assert counters[seeding.C_ITERS] == st[seeding.F_STEPS].max()
    assert counters[seeding.C_LIVE] == 0
    assert counters[seeding.C_GATHERED] > 0
    assert (counters[seeding.C_STALLED] > 0) == (K == 2)


@pytest.mark.cuda
@pytest.mark.parametrize("max_blocks", [None, 2])
def test_seed_lockstep_stops_after_max_iters_on_card(card, monkeypatch,
                                                     max_blocks):
    """max_iters = n leaves the state of n plain iterations, and going on
    from there reaches the plain scan's end; seed_step is one iteration."""
    dfm, q_rows, starts, stops, prm, plain = pallas_case(card, 2,
                                                         monkeypatch)
    part = seeding.ScanLanes.start(starts, stops, prm.max_out, card)
    seeding.scan_lockstep(dfm, q_rows, part, prm, plain=True, max_iters=7)
    lanes = seeding.ScanLanes.start(starts, stops, prm.max_out, card)
    _, counters = seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm,
                                          max_iters=7, max_blocks=max_blocks)
    assert counters[seeding.C_ITERS] == 7 and counters[seeding.C_LIVE] > 0
    assert torch.equal(lanes.buf, part.buf)
    assert torch.equal(lanes.out, part.out)
    n0 = (seed_cuda.seed_step.launches, seed_cuda.seed_lockstep.launches)
    live = seed_cuda.seed_step(dfm, q_rows, lanes, prm)
    assert (seed_cuda.seed_step.launches, seed_cuda.seed_lockstep.launches) \
        == (n0[0] + 1, n0[1] + 1)
    seeding.scan_lockstep(dfm, q_rows, part, prm, plain=True, max_iters=1)
    assert live == int(part.counters[seeding.C_LIVE]) > 0
    assert torch.equal(lanes.st, part.st)
    seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm, max_blocks=max_blocks)
    assert torch.equal(lanes.st, plain.st)
    assert torch.equal(lanes.out, plain.out)


@pytest.mark.cuda
def test_seed_lockstep_raises_on_a_grid_the_card_cannot_hold(card,
                                                             monkeypatch):
    """A plan for more blocks than are resident at once is refused by the
    cooperative launch: an error, not a smaller grid."""
    g, _ = genome_and_queries(5, lens=(60_000,))
    dfm = rank.DeviceFMIndex.from_host(build_fmindex(g), card)
    B = 16 * 1024                      # more blocks than any card holds
    starts = np.arange(B, dtype=np.int64) * 3
    q_rows = seeding.build_qrows(torch.from_numpy(g.codes_fwd).to(card))
    prm = seeding.ScanParams(12, 100, False, 4, "pallas")
    lanes = seeding.ScanLanes.start(starts, starts + 3, prm.max_out, card)
    monkeypatch.setattr(seed_cuda, "resident_blocks",
                        lambda lib, w, wide=False: 1 << 20)
    n0 = seed_cuda.seed_lockstep.launches
    with pytest.raises(RuntimeError, match="seed_lockstep launch failed"):
        seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm)
    assert seed_cuda.seed_lockstep.launches == n0
    monkeypatch.undo()
    # the same lanes under the card's own plan: several lanes a warp
    seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm)
    want = seeding.ScanLanes.start(starts, starts + 3, prm.max_out, card)
    seeding.scan_lockstep(dfm, q_rows, want, prm, plain=True)
    assert torch.equal(lanes.buf, want.buf)


@pytest.mark.cuda
@pytest.mark.parametrize("sa_intv,sa_mode,wide", [
    (1, "xla", False), (1, "pallas", False), (8, "xla", False),
    (8, "xla", True)])
def test_segments_match_plain_on_card(card, monkeypatch, sa_intv, sa_mode,
                                      wide):
    """Speculative segments (n_segments 8, slack 20: lanes poisoned at
    their bounds, fixup rounds) through the kernels against the plain
    versions on the same card: the same seeds and round statistics; then
    the first round's segment lanes and a fixup round's through seed_scan
    (or in pallas mode seed_lockstep with 2 slots) on the whole tables and
    on 4 row blocks, and through the lock step without slots, each equal
    to the plain scan (lane state, records)."""
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    monkeypatch.setattr(seeding, "_SA_GATHER_K", 2)
    monkeypatch.setenv("GSALIGN_SA_MODE", sa_mode)
    g, queries = genome_and_queries(61)
    queries.append(g.codes_fwd[100:1100].copy())     # clips at the bounds
    dfm = rank.DeviceFMIndex.from_host(
        build_fmindex(g, sa_intv=sa_intv, force_wide=wide), card)
    cut = mesh_lib.shard_index_rows(dfm, four_entries(card))
    kw = dict(min_seed_length=12, chunk=300, n_segments=8, slack=20)
    plain_stats, stats, rounds = {}, {}, []
    want = seeding.find_seeds_all(dfm, queries, plain=True,
                                  stats=plain_stats, **kw)
    got = seeding.find_seeds_all(dfm, queries, stats=stats, rounds=rounds,
                                 **kw)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert stats == plain_stats
    assert stats["poisoned_at_bound"][0] > 0 and len(rounds) > 1
    lock = sa_mode == "pallas"
    wrapper = seed_cuda.seed_lockstep if lock else seed_cuda.seed_scan
    for q_rows, starts, bounds, prm, st, recs in rounds[:2]:
        st_p, recs_p = seeding.scan_lanes(dfm, q_rows, starts, bounds, prm,
                                          plain=True)
        np.testing.assert_array_equal(st, st_p)
        np.testing.assert_array_equal(recs, recs_p)
        n0 = wrapper.sharded_launches
        st_c, recs_c = seeding.scan_lanes(cut, q_rows, starts, bounds, prm)
        assert wrapper.sharded_launches == n0 + 1
        np.testing.assert_array_equal(st_c, st_p)
        np.testing.assert_array_equal(recs_c, recs_p)
        if not lock:
            lanes = seeding.ScanLanes.start(starts, bounds, prm.max_out,
                                            card)
            seeding.scan_lockstep(dfm, q_rows, lanes, prm, plain=False)
            np.testing.assert_array_equal(lanes.st.cpu().numpy(), st_p)


@pytest.mark.cuda
def test_seed_scan_raises_on_the_step_limit(card, monkeypatch):
    """A lane that would take more steps than the limit sets the flag
    that the wrapper turns into an exception."""
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    g, queries = genome_and_queries(7)
    dfm = rank.DeviceFMIndex.from_host(build_fmindex(g), card)
    q_rows, starts, stops, prm = scan_cases(
        dfm, queries, min_seed_length=12, chunk=300)[0]
    monkeypatch.setattr(seed_cuda, "_step_cap", lambda *spans: 5)
    with pytest.raises(RuntimeError, match="step limit 5"):
        seeding.scan_lanes(dfm, q_rows, starts, stops, prm)


@pytest.mark.cuda
@pytest.mark.parametrize("sa_intv", [1, 8, 32])
def test_resolve_sa_matches_plain_on_card(card, sa_intv):
    g, _ = genome_and_queries(sa_intv)
    full = build_fmindex(g, sa_intv=1).sa_samples
    dfm = rank.DeviceFMIndex.from_host(build_fmindex(g, sa_intv=sa_intv),
                                       card)
    k = torch.arange(dfm.seq_len + 1, dtype=torch.int64, device=card)
    got = seed_cuda.resolve_sa(dfm, k)
    assert torch.equal(got, rank.resolve_sa(dfm, k))
    np.testing.assert_array_equal(got.cpu().numpy(), full)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_resolve_sa_layouts_match_plain_on_card(card, wide):
    """resolve_sa on every rank of a narrow sampled and of a forced-wide
    index (sa_intv 8): the plain LF walk's values and the full suffix
    array's."""
    g, _ = genome_and_queries(48)
    full = build_fmindex(g, sa_intv=1).sa_samples
    dfm = rank.DeviceFMIndex.from_host(
        build_fmindex(g, sa_intv=8, force_wide=wide), card)
    assert dfm.wide == wide
    k = torch.arange(dfm.seq_len + 1, dtype=torch.int64, device=card)
    n0 = seed_cuda.resolve_sa.launches
    got = seed_cuda.resolve_sa(dfm, k)
    assert seed_cuda.resolve_sa.launches == n0 + 1
    assert torch.equal(got, rank.resolve_sa(dfm, k))
    np.testing.assert_array_equal(got.cpu().numpy(), full)


@pytest.mark.cuda
@pytest.mark.parametrize("sensitive", [False, True])
def test_wide_seed_scan_matches_plain_on_card(card, monkeypatch, sensitive):
    """seed_scan and seed_lockstep (no slots) on a forced-wide index
    against the plain scan, round by round; the seeds of the whole scan
    equal the narrow sampled index's."""
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    g, queries = genome_and_queries(77)
    dfm = rank.DeviceFMIndex.from_host(build_fmindex(g, force_wide=True),
                                       card)
    assert dfm.wide and seeding.pick_sa_mode(dfm) == "none"
    monkeypatch.setenv("GSALIGN_SA_MODE", "pallas")
    assert seeding.pick_sa_mode(dfm) == "none"
    kw = dict(min_seed_length=12, sensitive=sensitive, chunk=300,
              max_out_cap=4)
    for q_rows, starts, stops, prm in scan_cases(dfm, queries, **kw):
        n0 = seed_cuda.seed_scan.launches
        st, recs = seeding.scan_lanes(dfm, q_rows, starts, stops, prm)
        assert seed_cuda.seed_scan.launches == n0 + 1
        st_p, recs_p = seeding.scan_lanes(dfm, q_rows, starts, stops, prm,
                                          plain=True)
        np.testing.assert_array_equal(st, st_p)
        np.testing.assert_array_equal(recs, recs_p)
        lanes = seeding.ScanLanes.start(starts, stops, prm.max_out, card)
        seed_cuda.seed_lockstep(dfm, q_rows, lanes, prm)
        np.testing.assert_array_equal(lanes.st.cpu().numpy(), st)
    narrow = rank.DeviceFMIndex.from_host(build_fmindex(g, sa_intv=8), card)
    for a, b in zip(seeding.find_seeds_all(dfm, queries, **kw),
                    seeding.find_seeds_all(narrow, queries, **kw)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_occ_rows_matches_plain_on_card(card, wide):
    """The row decode alone against the plain occ_t3 in both modes: on a
    narrow index's rows, and on synthetic wide rows whose checkpoints pass
    2^32 (ranks up to 2^38)."""
    import dataclasses
    rng = np.random.default_rng(16)
    g, _ = genome_and_queries(9)
    dfm = rank.DeviceFMIndex.from_host(
        build_fmindex(g, sa_intv=8, force_wide=wide), card)
    if wide:
        rows = carry_rows(rng, dfm.t3.shape[0])
        dfm = dataclasses.replace(dfm, t3=torch.from_numpy(
            rows.view(np.int32)).to(card))
    n = 50_000
    k = torch.from_numpy(rng.integers(0, dfm.t3.shape[0] * 128, n)).to(card)
    tri = torch.from_numpy(rng.random(n) < 0.5).to(card)
    cls = torch.from_numpy(rng.integers(0, 64, n)).to(card)
    cls = torch.where(tri, cls, cls & 3)
    got = seed_cuda.occ_rows(dfm, k, cls, tri.long())
    want = rank.occ_t3(dfm, k, tri, cls)
    assert torch.equal(got, want)
    assert (int(want.min()) >= 2 ** 32) == wide


@pytest.mark.cuda
def test_seed_wrappers_raise_for_other_devices(card):
    """Tables on the CPU with ranks on the card: the kernel is not
    launched on them."""
    g, _ = genome_and_queries(3)
    cpu_tables = rank.DeviceFMIndex.from_host(build_fmindex(g, sa_intv=8),
                                              "cpu")
    k = torch.zeros(3, dtype=torch.int64, device=card)
    n0 = seed_cuda.resolve_sa.launches
    with pytest.raises(ValueError, match="not cuda"):
        seed_cuda.resolve_sa(cpu_tables, k)
    assert seed_cuda.resolve_sa.launches == n0
    with pytest.raises(ValueError, match="one device"):
        gather.masked_gather(torch.zeros(4, dtype=torch.int32, device=card),
                             torch.zeros(2, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [70_000, 2_000_000])
def test_suffix_array_torch_matches_native_on_card(card, n):
    from gsalign_tpu_torch.index import suffix_array as tsa
    codes = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    codes[n // 2: n // 2 + 20_000] = codes[:20_000]        # a long repeat
    np.testing.assert_array_equal(tsa.build_suffix_array_torch(codes),
                                  tsa.build_suffix_array_native(codes))


@pytest.mark.cuda
def test_entry_matches_plain_dp_on_card(card):
    from gsalign_tpu_torch import entry
    fn, args = entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    n0 = dp_cuda.dp_any.launches + dp_cuda.dp_small.launches
    got = fn(*args).cpu().numpy()
    assert dp_cuda.dp_any.launches + dp_cuda.dp_small.launches == n0 + 1
    plain = tdp.dp_align_batch(*args, entry.L).cpu().numpy()
    assert max_abs_err(got, plain) == 0


@pytest.mark.cuda
def test_device_tables_are_laid_out_once_per_device(card):
    g, _ = genome_and_queries(3)
    fm = build_fmindex(g)
    on_card = rank.DeviceFMIndex.from_host(fm)
    assert rank.DeviceFMIndex.from_host(fm, card) is on_card
    assert on_card.device.type == "cuda"
    on_cpu = rank.DeviceFMIndex.from_host(fm, "cpu")
    assert on_cpu is not on_card and on_cpu.device.type == "cpu"
    assert torch.equal(on_cpu.t3, on_card.t3.cpu())


def four_entries(card):
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.make_mesh([card] * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("entries", [4, 16])
@pytest.mark.parametrize("wide", [False, True])
def test_row_sharded_kernels_match_plain_on_card(card, monkeypatch, wide,
                                                 entries):
    """The ShardedTable instances of seed_scan and resolve_sa on an sa_intv
    8 index cut into 4 and into 16 row blocks (entries of the one card; 16
    is past the 8 blocks the kernels once took): equal to the plain
    versions on the whole tables (resolve_sa at every rank, so at every
    block edge), each launch counted as the sharded instance's."""
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    g, queries = genome_and_queries(91)
    dfm = rank.DeviceFMIndex.from_host(
        build_fmindex(g, sa_intv=8, force_wide=wide), card)
    cut = mesh_lib.shard_index_rows(dfm,
                                    mesh_lib.make_mesh([card] * entries))
    assert len(cut.row_shards["t3"].blocks) == entries
    for q_rows, starts, stops, prm in scan_cases(
            dfm, queries, min_seed_length=12, chunk=300, max_out_cap=4):
        n0 = (seed_cuda.seed_scan.launches,
              seed_cuda.seed_scan.sharded_launches)
        st, recs = seeding.scan_lanes(cut, q_rows, starts, stops, prm)
        assert (seed_cuda.seed_scan.launches,
                seed_cuda.seed_scan.sharded_launches) == (n0[0], n0[1] + 1)
        st_p, recs_p = seeding.scan_lanes(dfm, q_rows, starts, stops, prm,
                                          plain=True)
        np.testing.assert_array_equal(st, st_p)
        np.testing.assert_array_equal(recs, recs_p)
    k = torch.arange(dfm.seq_len + 1, dtype=torch.int64, device=card)
    n0 = seed_cuda.resolve_sa.sharded_launches
    assert torch.equal(seed_cuda.resolve_sa(cut, k),
                       rank.resolve_sa(dfm, k))
    assert seed_cuda.resolve_sa.sharded_launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("K", [512, 2])
def test_row_sharded_lockstep_matches_plain_on_card(card, monkeypatch, K):
    """seed_lockstep's ShardedTable instance in pallas mode on a full-SA
    index with t3 cut into 4 blocks: the host loop's lane state, counters
    and records on the whole tables."""
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    monkeypatch.setattr(seeding, "_SA_GATHER_K", K)
    monkeypatch.setenv("GSALIGN_SA_MODE", "pallas")
    g, queries = genome_and_queries(92)
    dfm = rank.DeviceFMIndex.from_host(build_fmindex(g, sa_intv=1), card)
    cut = mesh_lib.shard_index_rows(dfm, four_entries(card))
    assert set(cut.row_shards) == {"t3"}
    for q_rows, starts, stops, prm in scan_cases(
            dfm, queries, min_seed_length=12, chunk=300, max_out_cap=4):
        want = seeding.ScanLanes.start(starts, stops, prm.max_out, card)
        seeding.scan_lockstep(dfm, q_rows, want, prm, plain=True)
        got = seeding.ScanLanes.start(starts, stops, prm.max_out, card)
        n0 = seed_cuda.seed_lockstep.sharded_launches
        seed_cuda.seed_lockstep(cut, q_rows, got, prm)
        assert seed_cuda.seed_lockstep.sharded_launches == n0 + 1
        assert torch.equal(got.buf, want.buf)
        assert torch.equal(got.out, want.out)


@pytest.mark.cuda
@pytest.mark.parametrize("sa_mode", ["xla", "pallas"])
def test_mesh_of_four_entries_on_one_card(card, monkeypatch, sa_mode):
    """A mesh of 4 entries on the one card (a stream each): the seeds of
    the run without a mesh, one scan launch a stripe that holds lanes (in
    pallas mode on one shared stream), and FragmentAligner's ops with every
    DP launch cut in four."""
    from gsalign_tpu_torch.parallel import mesh as mesh_lib
    monkeypatch.setenv("GSALIGN_SA_MODE", sa_mode)
    g, queries = genome_and_queries(93)
    dfm = rank.DeviceFMIndex.from_host(build_fmindex(g, sa_intv=1), card)
    mesh = four_entries(card)
    assert mesh.devices == (torch.device("cuda", 0),) * 4
    kw = dict(min_seed_length=12, chunk=300, max_out_cap=4)
    want = seeding.find_seeds_all(dfm, queries, **kw)
    wrapper = seed_cuda.seed_lockstep if sa_mode == "pallas" \
        else seed_cuda.seed_scan
    n0, stats = wrapper.launches, {}
    got = seeding.find_seeds_all(dfm, queries, mesh=mesh, stats=stats, **kw)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    B = stats["scan_lanes"]
    assert wrapper.launches - n0 == sum(stats["scan_launches"])
    assert stats["scan_launches"][0] == -(-B // -(-B // 4)) > 1
    rng = np.random.default_rng(4)
    rf = [rng.integers(0, 4, int(rng.integers(1, 600))).astype(np.uint8)
          for _ in range(11)]
    qf = [np.where(rng.random(len(r)) < 0.05, (r + 1) % 4, r)
          .astype(np.uint8) for r in rf]
    base = tdp.align_fragments(rf, qf, device=card)
    d0 = dp_cuda.dp_small.launches + dp_cuda.dp_any.launches
    split = tdp.align_fragments(rf, qf, mesh=mesh)
    n_buckets = len({tdp.bucket_of(max(len(a), len(b)), (64, 128, 256, 512,
                                                         1024))
                     for a, b in zip(rf, qf)})
    assert dp_cuda.dp_small.launches + dp_cuda.dp_any.launches - d0 \
        == 4 * n_buckets
    for a, b in zip(base, split):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_threads_share_a_mesh_of_four_entries_on_one_card(card, monkeypatch,
                                                           tmp_path):
    """run_distributed with -t 2 over a mesh of 4 entries on the card, in
    pallas mode: both threads launch their lock-step stripes on the one
    stream the mesh made for the card, and the bytes are the run's without
    a mesh."""
    import dataclasses
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.parallel import distributed
    from gsalign_tpu_torch.pipeline.align import compare_genomes
    from make_testdata import make_pair
    monkeypatch.setenv("GSALIGN_SA_MODE", "pallas")
    ref, qry = make_pair(total_len=60_000, n_chr=2, seed=5)
    fm = build_fmindex(pack_genome(ref))
    cfg = dataclasses.replace(AlignConfig(), thread_num=2)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    compare_genomes(fm, qry, cfg, output_prefix=one, verbose=False,
                    device=card)
    n0 = seed_cuda.seed_lockstep.launches
    distributed.run_distributed(fm, qry, cfg, two, verbose=False,
                                device=card, mesh=four_entries(card))
    assert seed_cuda.seed_lockstep.launches > n0
    for ext in (".maf", ".vcf"):
        with open(one + ext, "rb") as a, open(two + ext, "rb") as b:
            assert [ln for ln in a if not ln.startswith(b"##reference")] \
                == [ln for ln in b if not ln.startswith(b"##reference")]


@pytest.fixture(scope="module")
def pair_46(tmp_path_factory):
    """The bench's 4.6 Mb pair (ecoli_4.6mb) and its index, made once by
    tools/common.pair_dir; skips without a card before making anything."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gsalign_tpu_torch.tools.common import pair_dir
    return pair_dir(str(tmp_path_factory.mktemp("probes")), "ecoli_4.6mb")


def launched_in(fn, *args, **kw):
    """(fn's result, each kernel wrapper's launches inside it)."""
    from gsalign_tpu_torch.bench import kernel_wrappers
    wrappers = kernel_wrappers()
    n0 = {k: w.launches for k, w in wrappers.items()}
    res = fn(*args, **kw)
    return res, {k: w.launches - n0[k] for k, w in wrappers.items()}


@pytest.mark.cuda
def test_exp_seedprof_on_card(card, pair_46, tmp_path):
    """exp_seedprof at 4.6 Mb: the first round holds the bench's 460 seed
    lanes, through seed_scan; the traced last run gives a device busy
    share."""
    from gsalign_tpu_torch.tools import exp_seedprof
    prof, n = launched_in(exp_seedprof.profile, pair_46, "ecoli_4.6mb", 2,
                          card, trace_dir=str(tmp_path))
    rounds = prof["reps"][-1]["rounds"]
    assert rounds[0]["lanes"] == 460 and rounds[0]["steps"] > 0
    assert n["seed_scan"] == 2 * len(rounds)
    assert 0 < prof["trace"]["busy_share"] <= 1 and prof["trace"]["top"]
    assert prof["card"].startswith(torch.cuda.get_device_name(card))


@pytest.mark.cuda
def test_seed_stats_on_card(card, pair_46):
    """seed_stats at 4.6 Mb: a round a chromosome, 460 lanes in all, each
    through seed_scan."""
    from gsalign_tpu_torch.tools import seed_stats
    st, n = launched_in(seed_stats.stats_of, pair_46, card)
    assert sum(r["B"] for r in st["rounds"]) == 460
    assert st["total_max_iters"] == sum(r["max_iter"] for r in st["rounds"])
    assert n["seed_scan"] == 2 * len(st["rounds"])


@pytest.mark.cuda
def test_exp_seedab_on_card(card, pair_46):
    """exp_seedab at 4.6 Mb: the same seeds with INIT-12 off, in no fewer
    steps."""
    from gsalign_tpu_torch.tools import exp_seedab
    ab, n = launched_in(exp_seedab.ab, pair_46, "ecoli_4.6mb", card)
    on, off = ab["rows"]
    assert on["same"] and off["same"] and off["iters"] >= on["iters"] > 0
    assert n["seed_scan"] > 0


@pytest.mark.cuda
def test_exp_dphist_on_card(card, pair_46):
    """exp_dphist at 4.6 Mb: the JAX record's counts, a [dp_stats] line,
    the seed and DP kernels launched."""
    from gsalign_tpu_torch.bench import JAX_RECORD
    from gsalign_tpu_torch.tools import exp_dphist
    hist, n = launched_in(exp_dphist.dphist, pair_46, "ecoli_4.6mb", card)
    assert tuple(hist["counts"]) == JAX_RECORD["ecoli_4.6mb"]
    assert hist["dp_stats"].startswith("[dp_stats] L64:n=")
    assert hist["lanes"] >= 460 and hist["max"] >= hist["mean"] > 0
    assert n["seed_scan"] > 0 and n["dp_small"] + n["dp_any"] > 0


@pytest.mark.cuda
def test_exp_align_on_card(card, pair_46):
    """exp_align at 4.6 Mb: n_dp is the sum of its buckets and of its
    recorded launches' problems, each launch timed by CUDA events; every
    recorded launch's kernel gives the plain version's ops on its inputs."""
    from gsalign_tpu_torch.tools import exp_align
    inputs = []
    aln, n = launched_in(exp_align.probe, pair_46, "ecoli_4.6mb", 2, card,
                         inputs=inputs)
    for rep in aln["reps"]:
        assert rep["n_dp"] == sum(rep["buckets"].values()) \
            == sum(ln["B"] for ln in rep["launches"]) > 0
        assert all(ln["ms"] > 0 for ln in rep["launches"])
        assert rep["dp_event_ms"] > 0
    assert n["dp_small"] + n["dp_any"] == sum(len(r["launches"])
                                              for r in aln["reps"])
    assert len(inputs) == len(aln["reps"][-1]["launches"])
    for kernel, (L, q, t, ql, tl) in inputs:
        got = getattr(dp_cuda, kernel)(q, t, ql, tl, L).cpu().numpy()
        want = tdp.dp_align_batch(q, t, ql.clamp(0, L), tl.clamp(0, L),
                                  L).cpu().numpy()
        assert max_abs_err(got, want) == 0


@pytest.fixture(scope="module")
def probe_case():
    """A 200 kb make_pair's query rows and its reference's indexes on the
    card, narrow (direct) and forced-wide."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from make_testdata import make_pair
    from gsalign_tpu_torch.genome.packing import chars_to_codes, pack_genome
    ref, qry = make_pair(total_len=200_000)
    codes = np.concatenate([chars_to_codes(q) for _, q in qry])
    codes[5000:5040] = 4
    q_rows = seeding.build_qrows(torch.from_numpy(codes).cuda())
    g = pack_genome(ref)
    return q_rows, {wide: rank.DeviceFMIndex.from_host(
        build_fmindex(g, force_wide=wide), "cuda") for wide in (False, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_seedcost_matches_plain_on_card(card, probe_case, wide):
    """Every seedcost instance of the layout against seedcost_plain on the
    same inputs: acc, checksum, planes and records equal."""
    from gsalign_tpu_torch.ops import probe
    q_rows, tables = probe_case
    dfm = tables[wide]
    for piece in range(len(probe.PIECES)):
        if wide and piece in probe.TEXT_PIECES:
            continue
        n0 = probe.seedcost.launches
        got = probe.seedcost(dfm, q_rows, piece, 300, 40, 16)
        torch.cuda.synchronize()
        assert probe.seedcost.launches == n0 + 1
        want = probe.seedcost_plain(dfm, q_rows, piece, 300, 40, 16)
        for name in ("acc", "chk", "out_meta", "out_k0", "out_fr", "out_n"):
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                (piece, name)


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True], ids=["one", "two"])
def test_gather_sweep_matches_plain_on_card(card, two):
    from gsalign_tpu_torch.ops import probe
    n_all = 16 << 20                       # a 64 MB table
    t = torch.arange(n_all, dtype=torch.int32, device=card)
    n = n_all // 2 if two else n_all
    ta, tb = (t[:n], t[n:]) if two else (t, None)
    idx0 = probe.sweep_start(4096, n, card)
    n0 = probe.gather_sweep.launches
    got = probe.gather_sweep(ta, tb, idx0, 60, n)
    assert probe.gather_sweep.launches == n0 + 1
    want = probe.gather_sweep_plain(ta, tb, idx0, 60, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_exp_seedcost_and_exp_sweep_on_card(card, pair_46):
    """The two tools at 4.6 Mb and on an 8 MB table: every piece timed,
    the occupancy readings of each instance and of seed_scan read."""
    from gsalign_tpu_torch.ops import probe
    from gsalign_tpu_torch.tools import exp_seedcost, exp_sweep
    out = exp_seedcost.cost(pair_46, "ecoli_4.6mb", 512, 50, 128, card)
    assert all(us > 0 for us in out["us"].values())
    occ = out["occupancy"]
    assert {f"seedcost{p}" for p in range(6)} | {"seed_scan"} <= set(occ)
    assert all(r["regs"] > 0 and r["warps_per_sm"] > 0 for r in occ.values())
    n0 = probe.gather_sweep.launches
    rows = exp_sweep.sweep(card, (8,))
    assert [r["form"] for r in rows] == ["one-call"] * 3 + ["two-call"]
    assert all(r["us"] > 0 for r in rows)
    assert probe.gather_sweep.launches == n0 + 4 * 4


def random_genome(lens, seed):
    rng = np.random.default_rng(seed)
    return Genome(names=[f"c{i}" for i in range(len(lens))],
                  lengths=np.asarray(lens),
                  offsets=np.concatenate([[0], np.cumsum(lens)[:-1]]),
                  holes=[], codes_fwd=rng.integers(0, 4, sum(lens)).astype(
                      np.uint8))


def card_layout(fm, dev):
    """from_host(fm, dev) with a recorder bound: (the tables, init10_rows
    launches, layout.init10_card counted)."""
    from gsalign_tpu_torch.ops import layout_cuda
    from gsalign_tpu_torch.utils import trace
    rec = trace.Recorder()
    n0 = layout_cuda.init10_rows.launches
    with trace.bind(rec):
        dfm = rank.DeviceFMIndex.from_host(fm, dev)
    torch.cuda.synchronize()
    return (dfm, layout_cuda.init10_rows.launches - n0,
            rec.counters.get("layout.init10_card", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("sa_intv", [1, 8])
def test_init10_rows_laid_out_on_card_equal_the_cpu_layout(card, sa_intv):
    fm = build_fmindex(random_genome((120_000, 33_333), sa_intv),
                       sa_intv=sa_intv)
    got, launches, counted = card_layout(fm, card)
    assert got.init_order == 10 and (launches, counted) == (1, 1)
    want = rank.DeviceFMIndex.from_host(fm, "cpu")
    assert torch.equal(got.comb_pairs.cpu(), want.comb_pairs)
    assert torch.equal(got.init_corr.cpu(), want.init_corr)
    again, launches, counted = card_layout(fm, card)      # a cache hit
    assert again is got and (launches, counted) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [10, 12])
def test_a_c12_carrying_index_launches_no_init10_rows(card, monkeypatch,
                                                      order):
    import dataclasses
    from gsalign_tpu_torch.index.fmindex import _build_c12
    g = random_genome((20_000,), 7)
    fm = build_fmindex(g)
    fm = dataclasses.replace(fm, c12=_build_c12(g.codes_fwd_rc(),
                                                fm.seq_len))
    if order == 12:
        monkeypatch.setattr(rank, "INIT12_MIN_SEQLEN", fm.seq_len - 1)
    got, launches, counted = card_layout(fm, card)
    assert got.init_order == order and (launches, counted) == (0, 0)
    want = rank.DeviceFMIndex.from_host(fm, "cpu")
    assert torch.equal(got.comb_pairs.cpu(), want.comb_pairs)
