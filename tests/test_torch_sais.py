"""The port's SA-IS (gsalign_tpu_torch/native/sais.cpp through
gsalign_tpu_torch.native_lib) against the JAX package's suffix arrays:
build_suffix_array_native (the JAX package's own copy of SA-IS) and the
numpy prefix doubling build_suffix_array_np. A suffix array is unique, so
every comparison is array equality, through the int32 and the int64 entry
points, on one thread and on several. The texts force the code's paths:
deep recursion (a Fibonacci word, long duplicated blocks, periodic runs),
a single symbol, and large reduced alphabets whose bucket arrays live in
the free middle of the suffix array, or are recounted from the text where
only one of them fits. Then the host memory of an int64 build of 32 M rows,
in a subprocess, against its bound, and the native build's sources."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gsalign_tpu import native_lib as jax_native
from gsalign_tpu.index import suffix_array as jsa
from gsalign_tpu_torch import native_lib

pytestmark = pytest.mark.skipif(
    native_lib.get_lib() is None or jax_native.get_lib() is None,
    reason="native library unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fibonacci_word(n: int) -> np.ndarray:
    a, b = [0], [0, 1]
    while len(b) < n:
        a, b = b, b + a
    return np.asarray(b[:n], dtype=np.uint8)


def dna_texts() -> dict:
    """name -> 0..3 codes (the index build's input)."""
    rng = np.random.default_rng(2024)
    unit = rng.integers(0, 4, 400_000, dtype=np.uint8)
    mutated = unit.copy()
    mutated[::9973] = (mutated[::9973] + 1) % 4
    return {
        "random1000": rng.integers(0, 4, 1000, dtype=np.uint8),
        "random100k": rng.integers(0, 4, 100_000, dtype=np.uint8),
        # past 2^20 rows at the top and the first level: threaded phases
        "random5m": rng.integers(0, 4, 5_000_000, dtype=np.uint8),
        "period7": np.tile(np.asarray([0, 1, 2, 3, 0, 1, 2], np.uint8),
                           200_000),
        "fibonacci": fibonacci_word(1_500_000),
        "duplicated": np.concatenate([unit, unit, mutated, unit[:123_457]]),
        "one_base": np.zeros(1_000_000, dtype=np.uint8),
        "runs": np.repeat(rng.integers(0, 4, 40_000, dtype=np.uint8),
                          rng.integers(1, 100, 40_000)),
    }


def symbol_texts() -> dict:
    """name -> symbols 1..127 (the sentinel is appended): large alphabets.
    `interleaved` puts an LMS suffix at every second position, so the
    first reduced string fills half the SA and leaves no free space for
    its buckets, which are then one allocated array recounted from the
    text; `random_k127` names almost every LMS substring apart, so its
    buckets fit the free space once but not twice."""
    rng = np.random.default_rng(7)
    n = 1_200_000
    inter = np.empty(n, dtype=np.uint8)
    inter[0::2] = rng.integers(64, 128, n // 2)
    inter[1::2] = rng.integers(1, 48, n // 2)
    k127 = rng.integers(1, 128, n, dtype=np.uint8)
    k127[600_000:700_000] = k127[100_000:200_000]      # some repeats
    return {"interleaved": inter, "random_k127": k127,
            "small_k3": rng.integers(1, 4, 50_000, dtype=np.uint8)}


DNA = dna_texts()
SYMBOLS = symbol_texts()


@pytest.mark.parametrize("name", sorted(DNA))
def test_codes_entry_matches_jax(name):
    codes = DNA[name]
    want = jsa.build_suffix_array_native(codes)
    if codes.shape[0] <= 100_000:
        np.testing.assert_array_equal(jsa.build_suffix_array_np(codes), want)
    for bits in (32, 64):
        for threads in (1, 4):
            got = native_lib.sais_codes(codes, threads=threads,
                                        wide=bits == 64)
            assert got.dtype == np.dtype(f"int{bits}")
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"i{bits} t{threads}")


@pytest.mark.parametrize("name", sorted(SYMBOLS))
def test_text_entry_matches_jax(name):
    """Symbols 1..127 enter as codes 0..126 (the entry adds the 1 and the
    sentinel), held against the JAX package's SA-IS of the whole text."""
    text = np.concatenate([SYMBOLS[name], np.zeros(1, np.uint8)])
    want = jax_native.sais(text)
    for bits in (32, 64):
        for threads in (1, 4):
            got = native_lib.sais_codes(SYMBOLS[name] - 1, threads=threads,
                                        wide=bits == 64)
            assert got.dtype == np.dtype(f"int{bits}")
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"i{bits} t{threads}")


def test_malformed_texts_are_refused():
    with pytest.raises(RuntimeError):
        native_lib.sais_codes(np.asarray([127], np.uint8))     # >= 127


def test_marks_follow_the_levels():
    codes = DNA["random5m"]
    native_lib.sais_codes(codes, threads=4, wide=True)
    marks = native_lib.sais_marks()
    assert marks[0]["phase"] == "enter" and marks[0]["depth"] == 0
    assert marks[0]["n"] == codes.shape[0] + 1
    assert marks[-1]["phase"] == "done" and marks[-1]["depth"] == 0
    depths = sorted({m["depth"] for m in marks})
    assert depths == list(range(len(depths))) and len(depths) >= 2
    assert all(m["peak_rss"] >= m["rss"] > 0 for m in marks)


# The bound: the codes (1 byte a row), the int64 SA (8) and the fused
# symbol and type byte (1), and half a byte a row for everything else.
SAIS_B_PER_ROW = 10.5
MEMORY_SCRIPT = r"""
import json, sys
import numpy as np
from gsalign_tpu_torch.utils.trace import rss_bytes
which, n = sys.argv[1], int(sys.argv[2])
if which == "port":
    from gsalign_tpu_torch import native_lib
else:
    from gsalign_tpu.index import suffix_array as jsa
    from gsalign_tpu import native_lib
native_lib.get_lib()
base = rss_bytes()[0]
codes = np.random.default_rng(0).integers(0, 4, n - 1, dtype=np.uint8)
if which == "port":
    sa = native_lib.sais_codes(codes, threads=2, wide=True)
else:
    # the JAX package's build: the codes + 1 with a sentinel, copied
    t = np.empty(n, dtype=np.uint8)
    t[:n - 1] = codes + 1
    t[n - 1] = 0
    sa = np.empty(n, dtype=np.int64)
    assert native_lib.get_lib().sais_u8_i64_mt(t, n, sa, 2) == 0
assert sa[0] == n - 1
print(json.dumps({"b_per_row": (rss_bytes()[0] - base) / n}))
"""


def sais_bytes_a_row(which: str, n: int) -> float:
    out = subprocess.run(
        [sys.executable, "-c", MEMORY_SCRIPT, which, str(n)], cwd=REPO,
        capture_output=True, text=True, check=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    return json.loads(out.stdout.strip().splitlines()[-1])["b_per_row"]


def test_int64_build_memory_stays_under_its_bound():
    """The peak resident memory an int64 SA-IS build of 32 M rows adds to
    its process, from before the codes are made, in bytes a row: the
    port's under SAIS_B_PER_ROW; the JAX package's code, whose recursion
    levels, compactions and step 4 allocate beside the SA, well over it."""
    n = 32_000_000
    port = sais_bytes_a_row("port", n)
    jax_code = sais_bytes_a_row("jax", n)
    assert port <= SAIS_B_PER_ROW, port
    assert jax_code > SAIS_B_PER_ROW + 2, jax_code


def test_library_builds_only_from_the_ports_sources(tmp_path, monkeypatch):
    """native_lib compiles gsalign_tpu_torch/native/*.cpp and nothing from
    the repository's native/ directory (the JAX package's)."""
    pkg = os.path.dirname(os.path.abspath(native_lib.__file__))
    assert native_lib._NATIVE_DIR == os.path.join(pkg, "native")
    for src in native_lib._SOURCES:
        assert os.path.isfile(os.path.join(native_lib._NATIVE_DIR, src))
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
    monkeypatch.setattr(native_lib, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_lib, "_LIB_PATH",
                        str(tmp_path / "libgsalign_native.so"))
    monkeypatch.setattr(native_lib.subprocess, "run", fake_run)
    assert native_lib._build()
    (cmd,) = cmds
    srcs = [a for a in cmd if a.endswith(".cpp")]
    assert srcs and all(os.path.dirname(os.path.abspath(a))
                        == native_lib._NATIVE_DIR for a in srcs)
    assert not any(os.path.join(REPO, "native") + os.sep in a
                   for a in cmd)
