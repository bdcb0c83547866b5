"""Index parity of the PyTorch port: genome packing and coordinates, the
FM-index arrays, the shared on-disk artifact, and the device rank tables
and rank queries, each against the JAX package. All values are integers:
every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from gsalign_tpu.genome import coords as jcoords
from gsalign_tpu.genome import packing as jpacking
from gsalign_tpu.index import fmindex as jfmindex
from gsalign_tpu.index import io as jio
from gsalign_tpu.ops import rank as jrank
from gsalign_tpu_torch.genome import coords as tcoords
from gsalign_tpu_torch.genome import packing as tpacking
from gsalign_tpu_torch.index import fmindex as tfmindex
from gsalign_tpu_torch.index import io as tio
from gsalign_tpu_torch.ops import rank as trank
from tests.make_testdata import make_pair
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def records():
    ref, _ = make_pair(total_len=100_000)
    # an N run and scattered IUPAC codes exercise the lrand48(11) draws
    name, seq = ref[1]
    seq = seq.copy()
    seq[1000:1400] = ord("N")
    seq[5000:50000:997] = ord("R")
    return [ref[0], (name, seq)]


@pytest.fixture(scope="module")
def genomes(records):
    return jpacking.pack_genome(records), tpacking.pack_genome(records)


@pytest.fixture(scope="module")
def fms(genomes):
    jg, tg = genomes
    return (jfmindex.build_fmindex(jg, prefer_device=False),
            tfmindex.build_fmindex(tg))


def test_packing_matches_jax(genomes):
    jg, tg = genomes
    assert tg.names == jg.names and tg.seed == jg.seed
    assert [dataclasses.astuple(h) for h in tg.holes] == \
        [dataclasses.astuple(h) for h in jg.holes]
    assert len(tg.holes) > 0
    for f in ("lengths", "offsets", "codes_fwd"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
    np.testing.assert_array_equal(tg.codes_fwd_rc(), jg.codes_fwd_rc())
    np.testing.assert_array_equal(tg.chars_fwd_rc(), jg.chars_fwd_rc())


def test_coords_match_jax(genomes):
    jg, tg = genomes
    ji, ti = jcoords.ChrLocIndex(jg), tcoords.ChrLocIndex(tg)
    pos = np.random.default_rng(0).integers(0, 2 * jg.size, 200)
    np.testing.assert_array_equal(ti.chr_of(pos), ji.chr_of(pos))
    for p in pos[:50].tolist():
        assert dataclasses.astuple(tcoords.gen_coordinate_info(ti, p)) == \
            dataclasses.astuple(jcoords.gen_coordinate_info(ji, p))


def test_fmindex_arrays_match_jax(fms):
    jfm, tfm = fms
    for f in dataclasses.fields(jfm):
        if f.name == "genome":
            continue
        a, b = getattr(jfm, f.name), getattr(tfm, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_index_artifact_loads_in_other_package(fms, tmp_path, writer,
                                               reader):
    jfm, tfm = fms
    io_w, fm_w = (jio, jfm) if writer == "jax" else (tio, tfm)
    io_r = tio if reader == "torch" else jio
    prefix = str(tmp_path / "idx")
    io_w.save_index(fm_w, prefix)
    got = io_r.load_index(prefix)
    for f in dataclasses.fields(jfm):
        if f.name == "genome":
            np.testing.assert_array_equal(got.genome.codes_fwd,
                                          fm_w.genome.codes_fwd)
            assert got.genome.names == fm_w.genome.names
            continue
        a, b = getattr(fm_w, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name


def test_device_tables_match_jax(fms):
    jfm, tfm = fms
    jd = jrank.DeviceFMIndex.from_host(jfm)
    want = trank.tables_from_jax(jd)
    got = trank.DeviceFMIndex.host_tables(tfm)
    assert set(got) == set(want)
    for name, a in want.items():
        b = got[name]
        if isinstance(a, np.ndarray):
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64), err_msg=name)
        else:
            assert a == b, name
    dfm = trank.DeviceFMIndex.from_host(tfm, "cpu")
    for name in ("union", "t3", "comb_pairs", "text_rows", "sa_rows"):
        t = getattr(dfm, name).numpy()
        if name in trank.WORD_TABLES:      # int32 bit patterns of the words
            assert t.dtype == np.int32
            t = t.view(np.uint32)
        np.testing.assert_array_equal(t.astype(np.int64),
                                      want[name].astype(np.int64))
    assert dfm.init_order == jd.init_order == 10


def test_rank_queries_match_jax(fms):
    import jax.numpy as jnp
    jfm, tfm = fms
    jd = jrank.DeviceFMIndex.from_host(jfm)
    dfm = trank.DeviceFMIndex.from_host(tfm, "cpu")
    rng = np.random.default_rng(4)
    n = 512
    k = rng.integers(0, jfm.seq_len + 1, n)
    k[:4] = [0, 1, jfm.seq_len, jfm.primary]
    cls = rng.integers(0, 64, n)
    tri = rng.random(n) < 0.5
    cls = np.where(tri, cls, cls & 3)
    want = np.asarray(jrank.occ_t3(jd, jnp.asarray(k.astype(np.int32)),
                                   jnp.asarray(tri), jnp.asarray(cls)))
    got = trank.occ_t3(dfm, torch.from_numpy(k), torch.from_numpy(tri),
                       torch.from_numpy(cls)).numpy()
    np.testing.assert_array_equal(got, want)

    ik1 = rng.integers(1, jfm.seq_len - 100, n)
    ik2 = rng.integers(0, 50, n)
    nt = rng.integers(0, 4, n)
    w1, w2 = jrank.extend_rc(jd, *(jnp.asarray(a.astype(np.int32))
                                   for a in (ik1, ik2, nt)))
    g1, g2 = trank.extend_rc(dfm, *(torch.from_numpy(a)
                                    for a in (ik1, ik2, nt)))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(w2))

    p = np.arange(4)
    for a, b in zip(trank.init_interval(dfm, torch.from_numpy(p)),
                    jrank.init_interval(jd, jnp.asarray(p))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("sa_intv", [8, 32])
def test_sampled_device_tables_match_jax(genomes, sa_intv):
    """A sampled-SA index lays out the JAX package's non-direct tables:
    the SA samples on the device, dummy text windows and sa_rows."""
    jg, tg = genomes
    jd = jrank.DeviceFMIndex.from_host(
        jfmindex.build_fmindex(jg, sa_intv=sa_intv, prefer_device=False))
    tfm = tfmindex.build_fmindex(tg, sa_intv=sa_intv)
    want = trank.tables_from_jax(jd)
    got = trank.DeviceFMIndex.host_tables(tfm)
    assert set(got) == set(want)
    for name, a in want.items():
        b = got[name]
        if isinstance(a, np.ndarray):
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64), err_msg=name)
        else:
            assert a == b, name
    dfm = trank.DeviceFMIndex.from_host(tfm, "cpu")
    assert not dfm.direct_ok and dfm.host_sa is None
    assert dfm.sa_intv == sa_intv and dfm.sa_samples.dtype == torch.int32
    np.testing.assert_array_equal(dfm.sa_samples.numpy(), tfm.sa_samples)
    assert tuple(dfm.text_rows.shape) == (1, 1)
