"""Row-sharded tables in the PyTorch port (parallel/mesh.shard_index_rows)
on 8 CPU entries, mirroring tests/test_sharded_index.py: t3 and sa_samples
cut into 8 row blocks, the lanes whole, narrow and forced-wide. Seeds equal
the single-entry run's and the JAX package's; the row fetches equal a plain
gather at every block's first and last row; resolve_sa and the pipeline's
bytes (one process, and through run_distributed with -resume markers) equal
the single-entry run's. Exact throughout."""

import dataclasses

import numpy as np
import pytest
import torch

from gsalign_tpu.index.fmindex import build_fmindex as jbuild
from gsalign_tpu.ops.rank import DeviceFMIndex as JDeviceFMIndex
from gsalign_tpu.ops.seeding import find_seeds as jfind_seeds
from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.genome.packing import Genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import rank as trank
from gsalign_tpu_torch.ops.rank import DeviceFMIndex
from gsalign_tpu_torch.ops.seeding import find_seeds
from gsalign_tpu_torch.parallel import mesh as mesh_lib
from tests.helpers import random_genome
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)

N = 8
DNA = np.frombuffer(b"ACGTN", dtype=np.uint8)


@pytest.fixture(scope="module", params=[False, True], ids=["narrow", "wide"])
def setup(request):
    """(port FMIndex, its single-entry tables, the row-sharded ones, query
    codes, the JAX package's seeds) of tests/test_sharded_index.py's 4 kb
    genome, sa_intv 8."""
    rng = np.random.default_rng(11)
    ref = random_genome(rng, 4000)
    qry = ref.copy()
    subs = rng.random(len(qry)) < 0.02
    qry[subs] = (qry[subs] + 1) % 4
    qry = qry.astype(np.uint8)
    kw = dict(names=["c"], lengths=np.asarray([len(ref)]),
              offsets=np.asarray([0]), holes=[])
    jfm = jbuild(Genome(codes_fwd=ref, **kw), sa_intv=8, prefer_device=False,
                 force_wide=request.param)
    jseeds = jfind_seeds(JDeviceFMIndex.from_host(jfm), qry,
                         min_seed_length=12, chunk=500)
    fm = build_fmindex(Genome(codes_fwd=ref, **kw), sa_intv=8,
                       prefer_device=False, force_wide=request.param)
    dfm = DeviceFMIndex.from_host(fm, "cpu")
    assert dfm.wide == request.param
    cut = mesh_lib.shard_index_rows(dfm, mesh_lib.make_mesh(["cpu"] * N))
    return fm, dfm, cut, qry, [np.asarray(a) for a in jseeds]


def block_edges(rows: int, n_rows: int) -> torch.Tensor:
    """The first and last row of every block, within the real rows."""
    r = np.asarray([[s * rows, (s + 1) * rows - 1] for s in range(N)])
    return torch.from_numpy(np.clip(r.reshape(-1), 0, n_rows - 1)
                            .astype(np.int64))


def test_row_sharded_seeds_match_single_entry_and_jax(setup):
    _, dfm, cut, qry, jseeds = setup
    assert set(cut.row_shards) == {"t3", "sa_samples"}
    for f in mesh_lib.ROW_SHARD_FIELDS:
        sh = cut.row_shards[f]
        n = getattr(dfm, f).shape[0]
        # each block holds 1/8 of the rows (zero-padded to a multiple)
        assert sh.rows == mesh_lib.pad_to_multiple(n, N) // N
        assert [b.shape[0] for b in sh.blocks] == [sh.rows] * N
        assert getattr(cut, f).shape[0] == 0
    base = find_seeds(dfm, qry, min_seed_length=12, chunk=500)
    got = find_seeds(cut, qry, min_seed_length=12, chunk=500)
    for a, b, j in zip(base, got, jseeds):
        np.testing.assert_array_equal(a, j)
        np.testing.assert_array_equal(b, a)
    assert len(base[0]) > 20


def test_row_fetches_at_every_block_edge(setup):
    """t3_row_fetch and plane_fetch against a plain gather at the first and
    last row of each block; occ_t3 and lf_t3 read through them."""
    _, dfm, cut, _, _ = setup
    r3 = block_edges(cut.row_shards["t3"].rows, dfm.t3.shape[0])
    assert torch.equal(trank.t3_row_fetch(cut, r3), dfm.t3[r3])
    rs = block_edges(cut.row_shards["sa_samples"].rows,
                     dfm.sa_samples.shape[0])
    assert torch.equal(trank.plane_fetch(cut, "sa_samples", rs),
                       dfm.sa_samples[rs])
    k = torch.cat([r3 * 128, r3 * 128 + 127]).clamp(max=dfm.seq_len)
    cls = torch.arange(k.shape[0]) % 4
    tri = torch.zeros_like(k, dtype=torch.bool)
    assert torch.equal(trank.occ_t3(cut, k, tri, cls),
                       trank.occ_t3(dfm, k, tri, cls))
    assert torch.equal(trank.lf_t3(cut, k), trank.lf_t3(dfm, k))


def test_row_sharded_resolve_sa(setup):
    """resolve_sa over the blocks (the plain walk, which the kernel wrapper
    runs on CPU tensors) equals the single-entry one on every third rank
    and at the samples of every block's edges."""
    from gsalign_tpu_torch.ops import seed_cuda
    _, dfm, cut, _, _ = setup
    edges = block_edges(cut.row_shards["sa_samples"].rows,
                        dfm.sa_samples.shape[0]) * dfm.sa_intv
    k = torch.cat([torch.arange(0, dfm.seq_len + 1, 3), edges,
                   edges + 1]).clamp(max=dfm.seq_len)
    want = trank.resolve_sa(dfm, k)
    assert torch.equal(seed_cuda.resolve_sa(cut, k), want)
    assert want.unique().numel() == k.unique().numel()


def _outputs(prefix):
    with open(prefix + ".maf", "rb") as fh:
        maf = fh.read()
    with open(prefix + ".vcf", "rb") as fh:
        vcf = b"".join(ln for ln in fh.read().splitlines(keepends=True)
                       if not ln.startswith(b"##reference"))
    return maf, vcf


@pytest.mark.parametrize("runner", ["compare_genomes", "run_distributed"])
def test_row_sharded_pipeline_byte_identical(setup, tmp_path, monkeypatch,
                                             runner):
    """The pipeline over 8 row blocks writes the single-entry run's MAF and
    VCF: through compare_genomes, and through run_distributed given the
    mesh, with -resume (the chromosome's shard and marker committed, then
    merged)."""
    from gsalign_tpu_torch.parallel import distributed
    from gsalign_tpu_torch.pipeline import align as align_mod
    fm, _, _, qry, _ = setup
    records = [("q", DNA[qry])]
    cfg = dataclasses.replace(AlignConfig(), min_aln_block_score=50,
                              min_seed_length=12, thread_num=1)
    single = str(tmp_path / "single")
    align_mod.compare_genomes(fm, records, cfg, output_prefix=single,
                              verbose=False, device="cpu")
    mesh = mesh_lib.make_mesh(["cpu"] * N)
    cut = str(tmp_path / "rowshard")
    if runner == "compare_genomes":
        align_mod.compare_genomes(fm, records, cfg, output_prefix=cut,
                                  verbose=False, mesh=mesh,
                                  shard_index_rows=True)
    else:
        # run_distributed takes a mesh, and its shards run row-sharded
        seen = []
        real = align_mod.compare_genomes

        def rowsharded(*a, **kw):
            seen.append(kw["mesh"])
            return real(*a, shard_index_rows=True, **kw)
        monkeypatch.setattr(align_mod, "compare_genomes", rowsharded)
        distributed.run_distributed(fm, records, cfg, cut, verbose=False,
                                    resume=True, device="cpu", mesh=mesh)
        assert seen == [mesh]
    assert _outputs(cut) == _outputs(single)
    assert len(_outputs(single)[0]) > 1000


def test_row_sharded_pipeline_over_16_entries(setup, tmp_path):
    """compare_genomes over 16 CPU entries with shard_index_rows (twice the
    8 blocks the card's kernels once took) writes the single-entry run's
    MAF and VCF; t3 and sa_samples are cut into 16 blocks."""
    from gsalign_tpu_torch.pipeline import align as align_mod
    fm, dfm, _, qry, _ = setup
    records = [("q", DNA[qry])]
    cfg = dataclasses.replace(AlignConfig(), min_aln_block_score=50,
                              min_seed_length=12, thread_num=1)
    mesh = mesh_lib.make_mesh(["cpu"] * 16)
    cut = mesh_lib.shard_index_rows(dfm, mesh)
    assert [len(cut.row_shards[f].blocks) for f in mesh_lib.ROW_SHARD_FIELDS
            ] == [16, 16]
    single, rows = str(tmp_path / "single"), str(tmp_path / "rows16")
    align_mod.compare_genomes(fm, records, cfg, output_prefix=single,
                              verbose=False, device="cpu")
    align_mod.compare_genomes(fm, records, cfg, output_prefix=rows,
                              verbose=False, mesh=mesh,
                              shard_index_rows=True)
    assert _outputs(rows) == _outputs(single)
    assert len(_outputs(single)[0]) > 1000
