"""The control of `correct`: a cell run with one stated guarantee broken.

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s>

The program runs with its seed lanes cut every 8,192 query bases (a power
of two, the step a kernel change might be tempted to take) where the
configuration states GSAlign's 10,000 (src/GSAlign.cpp:5); everything else,
the checks included, is the cell's own run. Its `correct` must come out
false: the plain seed scan of the stated lanes finds other seeds. The
benchmark's own runs never run this.
"""

import argparse
import sys

import run

CONTROL = {"seed_exploration_chunk": 8192}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.cache_env()
    spec = run.Spec(args.workload)
    import torch
    if not torch.cuda.is_available():
        run.fail("needs a CUDA card")
    sys.path.insert(0, run.ROOT)
    run.run(spec, args.seed, args.seconds, False, program_overrides=CONTROL)
    return 0


if __name__ == "__main__":
    sys.exit(main())
