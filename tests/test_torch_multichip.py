"""The PyTorch port over a device mesh (gsalign_tpu_torch.parallel.mesh) on
the CPU, mirroring tests/test_multichip.py: seed lanes and DP problems
split over 8 and 3 CPU entries must give the seeds, ops and output bytes of
the unsplit run, and the seeds of the JAX package (whose own sharded run
tests/test_multichip.py pins to its unsharded one). Exact throughout."""

import numpy as np
import pytest
import torch

from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.ops.rank import DeviceFMIndex as JDeviceFMIndex
from gsalign_tpu.ops.seeding import find_seeds as jfind_seeds
from gsalign_tpu_torch.genome.packing import Genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import dp as tdp
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from gsalign_tpu_torch.ops.seeding import find_seeds, find_seeds_all
from gsalign_tpu_torch.parallel import mesh as mesh_lib
from tests.helpers import random_genome
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def cpu_mesh(n: int):
    return mesh_lib.make_mesh(["cpu"] * n)


class FakeStream:
    """torch.cuda.Stream where no card is: a Mesh over card entries makes
    one a card entry when it is built."""
    made: list = []

    def __init__(self, device):
        FakeStream.made.append(device)


def stripes_with_lanes(B: int, n: int) -> int:
    """Stripes of B lanes over n entries that hold a lane (each stripe
    ceil(B / n) lanes)."""
    return -(-B // -(-B // n))


def strip_reference_line(b: bytes) -> bytes:
    return b"\n".join(ln for ln in b.split(b"\n")
                      if not ln.startswith(b"##reference"))


@pytest.fixture(scope="module", params=["sampled", "direct"])
def index_case(request):
    """(port index, query, JAX seeds): the 3 kb sampled (sa_intv=8) and
    2.5 kb direct (sa_intv=1) cases of tests/test_multichip.py."""
    seed, n, sa_intv = {"sampled": (5, 3000, 8),
                        "direct": (21, 2500, 1)}[request.param]
    rng = np.random.default_rng(seed)
    ref = random_genome(rng, n)
    qry = ref.copy()
    subs = rng.random(len(qry)) < 0.02
    qry[subs] = (qry[subs] + 1) % 4
    qry = qry.astype(np.uint8)
    kw = dict(names=["c"], lengths=np.asarray([len(ref)]),
              offsets=np.asarray([0]), holes=[])
    jfm = jbuild(Genome(codes_fwd=ref, **kw), sa_intv=sa_intv,
                 prefer_device=False)
    jseeds = jfind_seeds(JDeviceFMIndex.from_host(jfm), qry,
                         min_seed_length=12, chunk=500)
    fm = build_fmindex(Genome(codes_fwd=ref, **kw), sa_intv=sa_intv,
                       prefer_device=False)
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    assert dfm.direct_ok == (request.param == "direct")
    return dfm, qry, [np.asarray(a) for a in jseeds]


@pytest.mark.parametrize("n", [8, 3])
def test_mesh_seeds_match_unsharded_and_jax(index_case, n):
    """Lanes (6 or 5 of them) cut into n stripes, padded where n does not
    divide them: the seeds of the port without a mesh, which are the JAX
    package's; one scan a stripe that holds lanes."""
    dfm, qry, jseeds = index_case
    base = find_seeds(dfm, qry, min_seed_length=12, chunk=500)
    stats = {}
    got = find_seeds_all(dfm, [qry], min_seed_length=12, chunk=500,
                         mesh=cpu_mesh(n), stats=stats)[0]
    for a, b, j in zip(base, got, jseeds):
        np.testing.assert_array_equal(a, j)
        np.testing.assert_array_equal(b, a)
    assert len(base[0]) > 20
    B = -(-len(qry) // 500)
    assert stats["scan_lanes"] == B
    assert stats["scan_launches"][0] == stripes_with_lanes(B, n)


def test_one_entry_mesh_is_the_unsharded_scan(index_case):
    """A mesh of one entry: one scan a round, as without a mesh."""
    dfm, qry, _ = index_case
    plain, one = {}, {}
    a = find_seeds_all(dfm, [qry], min_seed_length=12, chunk=500,
                       stats=plain)[0]
    b = find_seeds_all(dfm, [qry], min_seed_length=12, chunk=500,
                       mesh=cpu_mesh(1), stats=one)[0]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert one["scan_launches"] == plain["scan_launches"] \
        == [1] * len(plain["scan_iterations"])


@pytest.mark.parametrize("n_problems,n", [(13, 8), (13, 3), (5, 8)])
def test_fragment_aligner_mesh_ops_equal(n_problems, n):
    """FragmentAligner(mesh=): problems of several buckets, a count the
    mesh does not divide, pad problems dropped; every launch cut into n
    stripes. Ops equal the unsplit run's, pair by pair."""
    rng = np.random.default_rng(n_problems + n)
    rf = [rng.integers(0, 4, int(rng.integers(1, 250))).astype(np.uint8)
          for _ in range(n_problems)]
    qf = [np.where(rng.random(len(r)) < 0.05, (r + 1) % 4, r)
          .astype(np.uint8) for r in rf]
    calls = []

    def counting_dp(q, t, ql, tl, L):
        calls.append(q.shape[0])
        return tdp.dp_align_batch(q, t, ql, tl, L)
    base = tdp.align_fragments(rf, qf, device="cpu")
    n_buckets = len({tdp.bucket_of(max(len(a), len(b)), (64, 128, 256, 512))
                     for a, b in zip(rf, qf)})
    got = tdp.align_fragments(rf, qf, mesh=cpu_mesh(n), dp_fn=counting_dp)
    assert len(got) == len(base) == n_problems
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a, b)
    assert len(calls) == n * n_buckets
    assert len(set(calls)) <= n_buckets


def test_dryrun_multichip_on_cpu_entries(capsys):
    from gsalign_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip(8): pipeline ok" in capsys.readouterr().out


def test_pipeline_mesh_byte_identical(tmp_path):
    """compare_genomes over 8 CPU entries writes the single-entry run's MAF
    and VCF (the ##reference line, which names the prefix, stripped)."""
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.pipeline.align import compare_genomes
    from tests.make_testdata import make_pair
    ref, qry = make_pair(total_len=120_000, n_chr=2, seed=77)
    fm = build_fmindex(pack_genome(ref))
    p1, p8 = str(tmp_path / "one"), str(tmp_path / "eight")
    compare_genomes(fm, qry, AlignConfig(), output_prefix=p1, verbose=False,
                    device="cpu")
    stats, _, _ = compare_genomes(fm, qry, AlignConfig(), output_prefix=p8,
                                  verbose=False, mesh=cpu_mesh(8))
    assert stats.seed_scan_launches[0] == stripes_with_lanes(12, 8)
    for ext in (".maf", ".vcf"):
        with open(p1 + ext, "rb") as fh:
            one = strip_reference_line(fh.read())
        with open(p8 + ext, "rb") as fh:
            eight = strip_reference_line(fh.read())
        assert one == eight, f"{ext} differs between 1 and 8 entries"
    with pytest.raises(ValueError, match="first entry"):
        compare_genomes(fm, qry, AlignConfig(), verbose=False,
                        device="cuda:1", mesh=cpu_mesh(2))


def test_cli_meshes_every_card(tmp_path, monkeypatch):
    """The CLI's mesh choice (parallel/mesh.local_mesh): with two cards
    visible (the count stubbed) a 2-entry mesh over both is built and passed
    to compare_genomes, and to run_distributed under -resume; on the CPU,
    or with one card, none."""
    from gsalign_tpu_torch import cli
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.index.io import save_index
    from gsalign_tpu_torch.parallel import distributed
    from gsalign_tpu_torch.pipeline import align as align_mod
    from tests.make_testdata import make_pair, write_fasta
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_lib.local_mesh(card) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_lib.local_mesh(cpu) is None
    assert mesh_lib.local_mesh(card).devices == (card,
                                                 torch.device("cuda", 1))

    ref, qry = make_pair(total_len=20_000, n_chr=1, seed=3)
    save_index(build_fmindex(pack_genome(ref)), str(tmp_path / "idx"))
    write_fasta(str(tmp_path / "q.fa"), qry)
    seen = []
    monkeypatch.setattr(cli, "select_device", lambda: card)
    monkeypatch.setattr(align_mod, "compare_genomes",
                        lambda *a, **kw: seen.append(("compare", kw)))
    monkeypatch.setattr(distributed, "run_distributed",
                        lambda *a, **kw: seen.append(("distributed", kw)))
    for extra in ([], ["-resume"]):
        assert cli.main(["gsalign", "-i", str(tmp_path / "idx"), "-q",
                         str(tmp_path / "q.fa"), "-o", str(tmp_path / "o")]
                        + extra) == 0
    assert [w for w, _ in seen] == ["compare", "distributed"]
    for _, kw in seen:
        assert kw["device"] == card
        assert kw["mesh"].devices == (card, torch.device("cuda", 1))


def test_mesh_makes_its_streams_when_built(monkeypatch):
    """A stream a card entry, all made with the mesh, none for a CPU entry:
    threads that share the mesh then share its streams."""
    import threading
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    FakeStream.made.clear()
    card = torch.device("cuda", 0)
    mesh = mesh_lib.Mesh([card] * 4 + ["cpu"])
    assert FakeStream.made == [card] * 4
    assert mesh.streams[4] is None
    assert len({id(s) for s in mesh.streams[:4]}) == 4
    seen = []
    workers = [threading.Thread(target=lambda: seen.append(mesh.streams))
               for _ in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    assert len(FakeStream.made) == 4
    assert all(s is mesh.streams for s in seen)


@pytest.mark.parametrize("sa_mode", ["xla", "pallas"])
def test_threads_share_one_mesh(tmp_path, monkeypatch, sa_mode):
    """run_distributed with -t 2 over two chromosomes and one 3-entry mesh
    (both threads scan and align through it at once) writes the MAF and
    VCF of compare_genomes without a mesh."""
    import dataclasses
    from gsalign_tpu_torch.config import AlignConfig
    from gsalign_tpu_torch.genome.packing import pack_genome
    from gsalign_tpu_torch.parallel import distributed
    from gsalign_tpu_torch.pipeline.align import compare_genomes
    from tests.make_testdata import make_pair
    monkeypatch.setenv("GSALIGN_SA_MODE", sa_mode)
    ref, qry = make_pair(total_len=30_000, n_chr=2, seed=12)
    fm = build_fmindex(pack_genome(ref))
    cfg = dataclasses.replace(AlignConfig(), thread_num=2)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    compare_genomes(fm, qry, cfg, output_prefix=one, verbose=False,
                    device="cpu")
    stats, _, _ = distributed.run_distributed(
        fm, qry, cfg, two, verbose=False, device="cpu", mesh=cpu_mesh(3))
    assert stats.local_alignment_num > 0
    for ext in (".maf", ".vcf"):
        with open(one + ext, "rb") as fh:
            want = strip_reference_line(fh.read())
        with open(two + ext, "rb") as fh:
            assert strip_reference_line(fh.read()) == want
