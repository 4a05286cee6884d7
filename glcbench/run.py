"""Run one cell of the benchmark of glc_tpu_torch once, on one CUDA card:

    python3 glcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checked``: each number compared with the plain
reference beside its limit, which also end standard error.  Without a card,
with fewer cards than the cell asks for, without the program beside this
directory, or with JAX or the JAX package loaded at the end, it prints no
result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, why: str) -> int:
    print(f"glcbench: {why}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    # the checkout's root, not this directory, heads the import path
    here = ROOT / "glcbench"
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != here]
    from glcbench import manifest

    spec = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail(2, "no CUDA card")
    if torch.cuda.device_count() < spec["chips"]:
        return fail(2, f"{torch.cuda.device_count()} CUDA cards, the cell "
                       f"asks for {spec['chips']}")
    try:
        import glc_tpu_torch  # noqa: F401
    except ImportError as err:
        return fail(3, f"the program glc_tpu_torch is not beside glcbench: "
                       f"{err}")
    from glcbench import harness

    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        return fail(4, f"modules loaded that the benchmark forbids: {bad}")
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
