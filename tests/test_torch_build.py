"""The kernel build (ops/cuda_build.py) and the wrappers' device rules, on
the CPU: what can be checked without nvcc or a card."""

import os

import pytest
import torch

from gsalign_tpu_torch.ops import cuda_build, gather, probe, seed_cuda, seeding
from tests.torch_cpu import one_torch_thread  # noqa: F401 (autouse)


def test_every_kernel_source_is_built():
    srcs = cuda_build.sources()
    assert set(srcs) == {"dp", "gather", "layout", "probe", "seed"}
    paths = {n: cuda_build._lib_path(p) for n, p in srcs.items()}
    assert len(set(paths.values())) == 5
    for name, path in paths.items():
        assert os.path.dirname(path) == cuda_build._BUILD_DIR
        assert os.path.basename(path).startswith(f"libgsalign_{name}_")


def test_library_name_follows_the_flags(monkeypatch):
    src = cuda_build.sources()["seed"]
    before = cuda_build._lib_path(src)
    monkeypatch.setattr(cuda_build, "_NVCC_FLAGS",
                        cuda_build._NVCC_FLAGS + ["-lineinfo"])
    assert cuda_build._lib_path(src) != before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler is an error, not a fallback."""
    import shutil
    from torch.utils import cpp_extension
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_all()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.library("seed")


def test_build_failure_raises_with_the_compiler_output(monkeypatch,
                                                       tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "_find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no card here"):
        cuda_build.build_all()
    assert os.listdir(tmp_path / "b") == []      # no partial library left


def test_wrappers_refuse_other_devices():
    t = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather.masked_gather(t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        seed_cuda.resolve_sa(None, torch.zeros(3, dtype=torch.int64,
                                               device="meta"))
    lanes = seeding.ScanLanes.start([0], [5], 2, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        seed_cuda.seed_step(None, None, lanes, None)
    with pytest.raises(TypeError):
        seed_cuda.resolve_sa(None, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        probe.seedcost(None, torch.zeros(4, 64, dtype=torch.int32,
                                         device="meta"), 0, 4, 2, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        probe.gather_sweep(t, None, t, 2, 8)


def test_bind_sets_each_entry_point_once(monkeypatch, tmp_path):
    """bind() declares argtypes and a CUDA-error restype on the library's
    entry points (a host library stands in for a built kernel source)."""
    import ctypes
    import subprocess
    src = tmp_path / "f.cpp"
    src.write_text('extern "C" int gsalign_f(void* p, int n) '
                   '{ return p ? n : -1; }\n')
    so = tmp_path / "libf.so"
    # g++ also builds the port's native library (native_lib.py)
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    monkeypatch.setattr(cuda_build, "_libs", {"f": ctypes.CDLL(str(so))})
    sig = {"gsalign_f": [ctypes.c_void_p, ctypes.c_int]}
    lib = cuda_build.bind("f", sig)
    assert list(lib.gsalign_f.argtypes) == sig["gsalign_f"]
    assert lib.gsalign_f.restype is ctypes.c_int
    assert cuda_build.bind("f", sig) is lib
    assert lib.gsalign_f(1 << 40, 7) == 7       # a 64-bit pointer survives
    monkeypatch.setattr(cuda_build, "sources", lambda: {})
    with pytest.raises(RuntimeError, match="no CUDA source"):
        cuda_build.library("missing")
