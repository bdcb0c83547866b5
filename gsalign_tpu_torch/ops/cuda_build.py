"""Build the hand-written CUDA kernels in csrc/ and load them with ctypes.

Every csrc/*.cu file has a plain C interface and becomes its own shared
library, compiled with nvcc for sm_90a at first use into this package's
_build/ directory (git-ignored) and named by a digest of its content, of
the csrc/*.cuh headers and of the flags. build_all() starts one nvcc per
missing library, all at once, and waits for them (counted as
kernel.builds in the run's recorder, utils/trace); library(name) returns
one loaded library. A failed build raises: the kernels have no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

from gsalign_tpu_torch.utils import trace

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict = {}
# per source name: seconds (wall of the parallel build), path, ptxas report
build_info: dict = {}


def _find_nvcc() -> str:
    """nvcc on PATH, else under the CUDA toolkit that torch locates."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin",
                                                     "nvcc")):
            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def sources() -> dict:
    """{name: path} of every csrc/*.cu, by file stem."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))}


def _lib_path(src: str) -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(p, "rb") as fh:
            h.update(fh.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD_DIR, f"libgsalign_{name}_{h.hexdigest()[:16]}"
                                    f".so")


def build_all() -> dict:
    """Compile every csrc/*.cu not yet built (one nvcc each, in parallel)
    and load them all. Returns {name: ctypes.CDLL}."""
    with _lock:
        srcs = sources()
        todo = {n: p for n, p in srcs.items() if n not in _libs}
        if not todo:
            return dict(_libs)
        t0 = time.time()
        os.makedirs(_BUILD_DIR, exist_ok=True)
        running = []
        try:
            nvcc = None
            for name, src in todo.items():
                path = _lib_path(src)
                build_info[name] = {"path": path, "ptxas": ""}
                if os.path.exists(path):
                    continue
                nvcc = nvcc or _find_nvcc()
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
                os.close(fd)
                proc = subprocess.Popen(
                    [nvcc] + _NVCC_FLAGS + ["-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                running.append((name, src, path, tmp, proc))
            failed = []
            for name, src, path, tmp, proc in running:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {src}:\n{err}")
                    continue
                os.replace(tmp, path)
                build_info[name]["ptxas"] = err
            if failed:
                raise RuntimeError("\n".join(failed))
            trace.count("kernel.builds", len(running))
        finally:
            for _, _, _, tmp, proc in running:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
        for name in todo:
            build_info[name]["seconds"] = time.time() - t0
            _libs[name] = ctypes.CDLL(build_info[name]["path"])
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (building every source that is
    not built yet)."""
    libs = _libs if name in _libs else build_all()
    if name not in libs:
        raise RuntimeError(f"no CUDA source csrc/{name}.cu")
    return libs[name]


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """library(name) with the argument types of its C entry points set
    ({function: argtypes}); every entry point returns a CUDA error code."""
    lib = library(name)
    with _lock:
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            if f.argtypes is None:
                f.argtypes = argtypes
                f.restype = ctypes.c_int
    return lib


def stream(dev) -> int:
    """The current CUDA stream of device `dev`, as an integer handle."""
    import torch
    return torch.cuda.current_stream(dev).cuda_stream


def count(wrapper, field: str = "launches", n: int = 1):
    """Add n to a kernel wrapper's counter (`wrapper.<field>`). Under a
    lock: threads that run compare_genomes at once (parallel/distributed)
    launch through the same wrappers, and `+=` is no atomic update."""
    with _count_lock:
        setattr(wrapper, field, getattr(wrapper, field) + n)


def raise_on(err: int, name: str):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
