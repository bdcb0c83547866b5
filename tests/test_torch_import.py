"""The PyTorch port must never load JAX: the machine with the GPU has none,
and the JAX package's import turns on global x64 and a JIT cache."""

import os
import pkgutil
import re
import subprocess
import sys

import gsalign_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        gsalign_tpu_torch.__path__, "gsalign_tpu_torch."))


def test_importing_every_port_module_leaves_jax_out():
    mods = port_modules()
    for kernels in ("dp_cuda", "gather", "seed_cuda", "probe", "cuda_build"):
        assert f"gsalign_tpu_torch.ops.{kernels}" in mods
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'jaxlib', 'gsalign_tpu.')) or "
              "m == 'gsalign_tpu')\n"
              "print(bad)\n"
              "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import gsalign_tpu\b|"
                     r"from gsalign_tpu[ .])", re.M)
    paths = [os.path.join(REPO, f) for f in (
        "chip_smoke.py", "tests/dp_cases.py", "tests/test_torch_cuda.py",
        "tests/torch_dist_worker.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "gsalign_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            if pat.search(fh.read()):
                offenders.append(path)
    assert offenders == []
