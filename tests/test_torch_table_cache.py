"""The device tables are laid out once per index and device
(ops/rank.DeviceFMIndex.from_host keeps them on the FMIndex, as the JAX
package does), also when threads ask at once; and the kernel wrappers'
launch counts lose no update under threads (ops/cuda_build.count)."""

import dataclasses
import sys
import threading

import numpy as np
import pytest

from gsalign_tpu_torch.config import AlignConfig
from gsalign_tpu_torch.genome.packing import pack_genome
from gsalign_tpu_torch.index.fmindex import build_fmindex
from gsalign_tpu_torch.ops import cuda_build, rank
from gsalign_tpu_torch.pipeline.align import compare_genomes
from tests.make_testdata import make_pair
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def layouts(monkeypatch):
    """Every fm that DeviceFMIndex.host_tables lays out, in call order."""
    seen = []
    real = rank.DeviceFMIndex.host_tables

    def counting(fm, **kw):
        seen.append(fm)
        return real(fm, **kw)
    monkeypatch.setattr(rank.DeviceFMIndex, "host_tables",
                        staticmethod(counting))
    return seen


def small_fm():
    ref, qry = make_pair(total_len=60_000, seed=12, inversion=False)
    return build_fmindex(pack_genome(ref)), qry


def test_second_compare_genomes_skips_host_tables(layouts):
    fm, qry = small_fm()
    first = compare_genomes(fm, qry, AlignConfig(), verbose=False,
                            device="cpu")
    second = compare_genomes(fm, qry, AlignConfig(), verbose=False,
                             device="cpu")
    assert layouts == [fm]
    timings = {"stage_times": None, "span_times": None}
    assert dataclasses.asdict(first[0]) | timings == \
        dataclasses.asdict(second[0]) | timings


def test_cache_is_per_index(layouts):
    fm, _ = small_fm()
    a = rank.DeviceFMIndex.from_host(fm, "cpu")
    assert rank.DeviceFMIndex.from_host(fm, "cpu") is a
    other = dataclasses.replace(fm)             # another index object
    b = rank.DeviceFMIndex.from_host(other, "cpu")
    assert b is not a and layouts == [fm, other]
    np.testing.assert_array_equal(a.t3.numpy(), b.t3.numpy())


def test_threads_lay_out_the_tables_once(layouts):
    fm, _ = small_fm()
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: got.append(rank.DeviceFMIndex.from_host(fm, "cpu")))
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == 8 and all(d is got[0] for d in got)
    assert layouts == [fm]


def test_launch_counts_lose_no_update_under_threads():
    def wrapper():
        pass
    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [cuda_build.count(wrapper) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 2000
