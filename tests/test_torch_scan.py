"""The run-to-completion seed scan of the PyTorch port on the CPU, where
the plain versions run: (i) lane independence, the property the seed_scan
kernel rests on; (ii) the 32-bit word tables against the JAX package's,
word for word; (iii) find_seeds_all through the new dispatch against the
JAX package's find_seeds_all; and the entry points' device rule. All values
are integers: every comparison is exact."""

import numpy as np
import pytest
import torch

from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.ops import rank as jrank
from gsalign_tpu.ops import seeding as jseeding
from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.genome.packing import Genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import dp as tdp
from gsalign_tpu_torch.ops import rank as trank
from gsalign_tpu_torch.ops import seed_cuda
from gsalign_tpu_torch.ops import seeding as tseeding
from gsalign_tpu_torch.pipeline.align import compare_genomes
from gsalign_tpu_torch.utils.device import resolve_device
from tests.helpers import random_genome
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def genome_of(chroms):
    lens = np.asarray([len(c) for c in chroms])
    return Genome(names=[f"c{i}" for i in range(len(chroms))], lengths=lens,
                  offsets=np.concatenate([[0], np.cumsum(lens)[:-1]]),
                  holes=[], codes_fwd=np.concatenate(chroms))


def mutate(codes, rng, sub_rate=0.02):
    out = codes.copy()
    subs = rng.random(len(out)) < sub_rate
    out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
    return out.astype(np.uint8)


def multi_chromosome_case(seed=21):
    """Three reference chromosomes; the queries are their mutated copies in
    reverse order with ambiguous runs, a reverse-complement piece and an
    exact copy (a long unique match: direct mode goes on past 256 bases)."""
    rng = np.random.default_rng(seed)
    refs = [random_genome(rng, n) for n in (500, 800, 400)]
    queries = [mutate(r, rng) for r in refs[::-1]]
    queries[0][50:70] = 4
    queries[1][5] = 4
    queries.append((3 - refs[1][100:400][::-1]).astype(np.uint8))
    queries.append(refs[0][100:480].copy())
    return refs, queries


def scan_rounds(dfm, queries, **kw):
    """find_seeds_all's scan rounds: [(q_rows, starts, stops, prm, st,
    recs)]."""
    rounds, stats = [], {}
    tseeding.find_seeds_all(dfm, queries, stats=stats, rounds=rounds, **kw)
    assert stats["scan_iterations"] == [int(r[4][tseeding.F_STEPS].max())
                                        for r in rounds]
    return rounds


@pytest.mark.parametrize("cap", [None, 3])
@pytest.mark.parametrize("sensitive", [False, True])
@pytest.mark.parametrize("sa_intv,sa_mode", [(1, "xla"), (8, "none")])
def test_lanes_are_independent(monkeypatch, sa_intv, sa_mode, sensitive,
                               cap):
    """Each lane scanned alone (B = 1) gives the records, final state and
    step count it has in the batch scan, and the batch's lock-step
    iteration count is the most steps any lane took: so the lanes may run
    to completion on their own, in any order."""
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    refs, queries = multi_chromosome_case()
    dfm = trank.DeviceFMIndex.from_host(
        build_fmindex(genome_of(refs), sa_intv=sa_intv), "cpu")
    kw = dict(min_seed_length=10 if sensitive else 12, sensitive=sensitive,
              chunk=300, max_out_cap=cap)
    rounds = scan_rounds(dfm, queries, **kw)
    assert (len(rounds) > 1) == (cap is not None)
    # every round but at most three of them: the first and the last two
    for q_rows, starts, stops, prm, st, recs in rounds[:1] + rounds[1:][-2:]:
        assert prm.sa_mode == sa_mode
        lanes = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
        n_iter = tseeding.scan_lockstep(dfm, q_rows, lanes, prm, plain=True)
        assert n_iter == st[tseeding.F_STEPS].max()
        np.testing.assert_array_equal(lanes.st.numpy(), st)
        ends = np.cumsum(st[tseeding.F_OUT_N])
        for i in range(len(starts)):
            st1, recs1 = tseeding.scan_lanes(
                dfm, q_rows, starts[i:i + 1], stops[i:i + 1], prm,
                plain=True)
            np.testing.assert_array_equal(st1[:, 0], st[:, i])
            np.testing.assert_array_equal(
                recs1, recs[ends[i] - st[tseeding.F_OUT_N, i]:ends[i]])


def test_seed_scan_wrapper_runs_the_plain_scan_on_cpu(monkeypatch):
    """On CPU tensors seed_scan is its plain version: no launch is
    counted, and pallas mode is refused (its slots couple the lanes)."""
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    refs, queries = multi_chromosome_case(5)
    dfm = trank.DeviceFMIndex.from_host(build_fmindex(genome_of(refs)),
                                        "cpu")
    q_rows, starts, stops, prm, st, _ = scan_rounds(
        dfm, queries, min_seed_length=12, chunk=600)[0]
    lanes = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
    n0 = seed_cuda.seed_scan.launches
    got = seed_cuda.seed_scan(dfm, q_rows, lanes, prm)
    assert seed_cuda.seed_scan.launches == n0
    np.testing.assert_array_equal(got, st)
    pallas = tseeding.ScanParams(**{**prm.__dict__, "sa_mode": "pallas"})
    with pytest.raises(ValueError, match="lock step"):
        seed_cuda.seed_scan(dfm, q_rows, lanes, pallas)
    lanes = tseeding.ScanLanes.start([0], [5], 2, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        seed_cuda.seed_scan(None, None, lanes, None)


def test_step_cap_bounds_every_lane():
    """The kernel's step limit is above what any lane takes; a lane of one
    base takes at most five steps."""
    assert seed_cuda._step_cap(1) == 5
    assert seed_cuda._step_cap(10_000) == 100_040_000
    assert seed_cuda._step_cap(0) == 0


@pytest.mark.parametrize("sa_intv", [1, 8])
def test_device_tables_are_32_bit_and_match_jax(sa_intv):
    """Every table of the port's DeviceFMIndex equals the JAX package's,
    word for word, with the word tables held in 32 bits."""
    rng = np.random.default_rng(sa_intv)
    g = genome_of([random_genome(rng, 3000), random_genome(rng, 1100)])
    jd = jrank.DeviceFMIndex.from_host(
        jbuild(g, sa_intv=sa_intv, prefer_device=False))
    want = trank.tables_from_jax(jd)
    dfm = trank.DeviceFMIndex.from_host(build_fmindex(g, sa_intv=sa_intv),
                                        "cpu")
    names = [n for n, v in want.items() if isinstance(v, np.ndarray)]
    assert set(trank.WORD_TABLES) < set(names)
    for name in names:
        t = getattr(dfm, name)
        a = t.numpy()
        if name in trank.WORD_TABLES:
            assert t.dtype == torch.int32, name
            # half of what the same words took in int64
            assert t.numel() * t.element_size() == want[name].size * 4
            a = a.view(np.uint32)
        elif name in ("sa_rows", "sa_samples"):
            assert t.dtype == torch.int32, name
        else:
            assert t.dtype == torch.int64, name
        assert a.shape == want[name].shape, name
        np.testing.assert_array_equal(a.astype(np.int64),
                                      want[name].astype(np.int64),
                                      err_msg=name)
    # the same tables through from_tables give the same index
    alt = trank.DeviceFMIndex.from_tables(
        want, host_sa=dfm.host_sa, seq_len=jd.seq_len, primary=jd.primary,
        device="cpu")
    for name in names:
        assert torch.equal(getattr(alt, name), getattr(dfm, name)), name
    bad = dict(want, t3=want["t3"].astype(np.int64))
    with pytest.raises(TypeError, match="32-bit words"):
        trank.DeviceFMIndex.from_tables(bad, None, jd.seq_len, jd.primary,
                                        device="cpu")


def test_query_rows_are_32_bit_and_match_jax():
    rng = np.random.default_rng(8)
    q = rng.integers(0, 5, 1000).astype(np.uint8)     # with ambiguous bases
    q[:16] = 3                                        # a word of all ones
    got = tseeding.build_qrows(torch.from_numpy(q))
    want = np.asarray(jseeding._build_qrows(q))
    assert got.dtype == torch.int32 and want.dtype == np.uint32
    assert got.numel() * got.element_size() == want.nbytes
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert int(trank.widen(got).max()) == 0xFFFFFFFF


@pytest.mark.parametrize("sa_intv,sensitive,cap", [
    (1, False, None), (1, True, None), (1, False, 3), (8, False, None),
    (8, True, 4)])
def test_find_seeds_all_matches_jax_through_the_new_dispatch(
        monkeypatch, sa_intv, sensitive, cap):
    """find_seeds_all through scan_lanes and seed_scan's wrapper (its
    launch half, scan_launch; on the CPU the plain version) equals the JAX
    package's find_seeds_all, and records one iteration count per round."""
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    refs, queries = multi_chromosome_case(31)
    g = genome_of(refs)
    dfm = trank.DeviceFMIndex.from_host(build_fmindex(g, sa_intv=sa_intv),
                                        "cpu")
    jdfm = jrank.DeviceFMIndex.from_host(
        jbuild(g, sa_intv=sa_intv, prefer_device=False))
    kw = dict(min_seed_length=10 if sensitive else 12, sensitive=sensitive,
              chunk=300, max_out_cap=cap)
    want = jseeding.find_seeds_all(jdfm, queries, **kw)
    stats = {}
    n0 = seed_cuda.seed_scan.launches
    calls = []
    wrapper, launch = seed_cuda.seed_scan, seed_cuda.scan_launch
    monkeypatch.setattr(seed_cuda, "scan_launch", lambda *a: (
        calls.append(1), launch(*a))[1])
    got = tseeding.find_seeds_all(dfm, queries, stats=stats, **kw)
    # one wrapper call per round, and no launch on the CPU
    assert len(calls) == len(stats["scan_iterations"])
    assert wrapper.launches == n0
    assert (len(stats["scan_iterations"]) > 1) == (cap is not None)
    assert stats["scan_lanes"] == 10
    assert sum(len(w[0]) for w in want) > 0
    for g_, w_ in zip(got, want):
        for a, b in zip(g_, w_):
            np.testing.assert_array_equal(a, b)


def test_entry_points_take_the_card_by_default_and_raise_without_one(
        monkeypatch):
    """No device given means the CUDA card: without one, every entry point
    raises and none carries on on the CPU; "cpu" asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    fm = build_fmindex(genome_of([random_genome(rng, 400)]))
    frag = [rng.integers(0, 4, 30).astype(np.uint8)]
    calls = [
        lambda: resolve_device(),
        lambda: trank.DeviceFMIndex.from_host(fm),
        lambda: trank.DeviceFMIndex.from_tables(
            trank.DeviceFMIndex.host_tables(fm), None, fm.seq_len,
            fm.primary),
        lambda: tdp.FragmentAligner(),
        lambda: tdp.align_fragments(frag, frag),
        lambda: compare_genomes(fm, [("q", np.full(50, 65, np.uint8))],
                                AlignConfig(), verbose=False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert trank.DeviceFMIndex.from_host(fm, "cpu").device.type == "cpu"
    assert tdp.FragmentAligner(device="cpu").device.type == "cpu"


def need_lanes(need, ik1=None):
    """Lanes whose state makes exactly the lanes of `need` enter direct
    mode with their SA word to read."""
    B = len(need)
    lanes = tseeding.ScanLanes.start(np.zeros(B), np.full(B, 10), 2, "cpu")
    lanes.st[tseeding.F_PHASE] = torch.from_numpy(need.astype(np.int64))
    lanes.st[tseeding.F_IK2] = 1
    if ik1 is not None:
        lanes.st[tseeding.F_IK1] = torch.from_numpy(ik1)
    return lanes


@pytest.mark.parametrize("K", [1, 8, 512])
@pytest.mark.parametrize("lanes_per_block", [1, 4, 7])
def test_blockwise_slot_prefix_equals_sa_slots(lanes_per_block, K):
    """The slots as the seed_lockstep kernel makes them (per-block counts,
    their exclusive sum, the rank inside the block) are _sa_slots' slots,
    for random need vectors of every density and B up to 3,000."""
    rng = np.random.default_rng(100 * K + lanes_per_block)
    dfm = trank.DeviceFMIndex.from_host(
        build_fmindex(genome_of([random_genome(rng, 300)])), "cpu")
    for B in (1, 2, 5, 31, 460, 1200, 3000):
        for density in (0.0, 0.02, 0.5, 1.0):
            need = rng.random(B) < density
            slot, _ = tseeding._sa_slots(dfm, need_lanes(need), min(K, B),
                                         lambda table, idx: idx)
            got = seed_cuda.slots_blockwise(need, lanes_per_block,
                                            min(K, B))
            np.testing.assert_array_equal(got, slot.numpy())
            assert (got >= 0).sum() == min(need.sum(), K, B)


def test_sa_slots_gather_reads_the_slot_owners_ranks():
    """Slot s reads the SA word of the lane that owns it: what each lane
    reads for itself inside the kernel."""
    rng = np.random.default_rng(6)
    dfm = trank.DeviceFMIndex.from_host(
        build_fmindex(genome_of([random_genome(rng, 500)])), "cpu")
    B, K = 40, 8
    need = rng.random(B) < 0.4
    ik1 = rng.integers(0, dfm.seq_len + 1, B)
    from gsalign_tpu_torch.ops.gather import masked_gather_plain
    slot, res_k = tseeding._sa_slots(dfm, need_lanes(need, ik1), K,
                                     masked_gather_plain)
    own = slot.numpy() >= 0
    assert own.sum() == min(need.sum(), K) > 0
    np.testing.assert_array_equal(
        res_k.numpy()[slot.numpy()[own]], dfm.sa_rows.numpy()[ik1[own]])
    assert (res_k.numpy()[own.sum():] == 0).all()


@pytest.mark.parametrize("B,staged,bare,max_blocks,want", [
    (460, 132, 132, None, (29, 1, True)),        # a warp a lane
    (1200, 132, 132, None, (75, 1, True)),
    (25_000, 132, 132, None, (131, 12, False)),  # 250 Mb: twelve a warp
    (1200, 132, 132, 64, (38, 2, False)),        # a capped grid
    (1200, 0, 132, None, (75, 1, False)),        # a window too large to stage
    (3, 10, 10, None, (1, 1, True)),
    (161, 10, 10, 10, (6, 2, False)),
])
def test_lockstep_plan_fills_the_grid_in_lane_order(B, staged, bare,
                                                    max_blocks, want):
    got = seed_cuda.lockstep_plan(B, staged, bare, max_blocks)
    assert got == want
    blocks, per, _ = got
    assert blocks * seed_cuda._LOCK_WARPS * per >= B
    assert (blocks - 1) * seed_cuda._LOCK_WARPS * per < B
    assert blocks <= (max_blocks or max(staged, bare))


def test_lockstep_plan_refuses_an_empty_grid():
    with pytest.raises(ValueError, match="at least one block"):
        seed_cuda.lockstep_plan(100, 0, 0)
    with pytest.raises(ValueError, match="at least one block"):
        seed_cuda.lockstep_plan(100, 10, 10, max_blocks=0)


def test_seed_lockstep_wrapper_runs_the_plain_loop_on_cpu(monkeypatch):
    """On CPU tensors seed_lockstep and seed_step are their plain versions
    in every SA mode: no launch is counted and no library is built."""
    monkeypatch.delenv("GSALIGN_SA_MODE", raising=False)
    monkeypatch.setattr(seed_cuda, "build", lambda: pytest.fail("built"))
    refs, queries = multi_chromosome_case(5)
    dfm = trank.DeviceFMIndex.from_host(build_fmindex(genome_of(refs)),
                                        "cpu")
    q_rows, starts, stops, prm, st, _ = scan_rounds(
        dfm, queries, min_seed_length=12, chunk=600)[0]
    n0 = (seed_cuda.seed_lockstep.launches, seed_cuda.seed_step.launches,
          seed_cuda.seed_lockstep.gathered)
    for sa_mode in ("xla", "pallas"):
        mode = tseeding.ScanParams(**{**prm.__dict__, "sa_mode": sa_mode})
        lanes = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
        got, counters = seed_cuda.seed_lockstep(dfm, q_rows, lanes, mode)
        np.testing.assert_array_equal(got, st)
        assert counters[tseeding.C_ITERS] == st[tseeding.F_STEPS].max()
        assert (counters[tseeding.C_GATHERED] > 0) == (sa_mode == "pallas")
        lanes = tseeding.ScanLanes.start(starts, stops, prm.max_out, "cpu")
        assert seed_cuda.seed_step(dfm, q_rows, lanes, mode) == len(starts)
    assert (seed_cuda.seed_lockstep.launches, seed_cuda.seed_step.launches,
            seed_cuda.seed_lockstep.gathered) == n0
    lanes = tseeding.ScanLanes.start([0], [5], 2, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        seed_cuda.seed_lockstep(None, None, lanes, None)
