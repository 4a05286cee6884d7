"""The readings that the limits of `correct` are set from, for one cell:

    python3 glcbench/calibrate.py --workload <cell> --seeds 11,12,... --control-seeds 21,22,23

For each seed it makes the tracks of the cell's first call, runs that call
through the program (after one warm call of the same tracks), draws the
answers a run would judge (`harness.Sampler`), and prints their numbers of
`compare`; for each control seed it puts the reference at TF32 in the
program's place.  The last line gives each number's lower reading (the
largest over the program's seeds) and upper reading (the smallest over the
control's).  One process reads every seed, so the set-up is paid once.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(spec: dict, seed: int, device, control: bool,
             details: list = None) -> dict:
    """The numbers of the first call of `seed`: the program's, or with
    `control` the TF32 reference's in its place.  `details`: see
    ``Album.numbers``."""
    import importlib

    from glcbench import harness

    traffic = spec["traffic"]
    kind = importlib.import_module(f"glcbench.kinds.{traffic['kind']}")
    cell = kind.make(spec["config"], traffic, seed, device)
    idxs = next(cell.calls())
    cell.make_pool(idxs)
    if control:
        outs = cell.reference_outputs(idxs, "tf32")
    else:
        cell.start_program()
        cell.call(idxs)
        outs = cell.call(idxs)
        cell.stop_program()
    longest = max(idxs, key=lambda i: cell.seconds[i])
    sampler = harness.Sampler(traffic["check"]["items"], seed, longest)
    for i, out in zip(idxs, outs):
        sampler.offer(i, out)
    del outs
    return cell.numbers(sampler.answers(), details)


def summary(program: list, control: list) -> dict:
    """Each number's lower reading (largest of the program's) and upper
    reading (smallest of the control's)."""
    names = program[0].keys() if program else control[0].keys()
    return {k: {"lower": max((r[k] for r in program), default=None),
                "upper": min((r[k] for r in control), default=None)}
            for k in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    here = ROOT / "glcbench"
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if Path(q or ".").resolve() != here]
    from glcbench import manifest

    spec = manifest.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    program, control = [], []
    for seed, is_control in ([(s, False) for s in seeds]
                             + [(s, True) for s in control_seeds]):
        t0 = time.perf_counter()
        details: list = []
        nums = readings(spec, seed, args.device, is_control, details)
        (control if is_control else program).append(nums)
        print(json.dumps({"seed": seed, "control": is_control, **nums,
                          "s": time.perf_counter() - t0,
                          "details": details}), flush=True)
    print(json.dumps({"workload": args.workload, "summary":
                      summary(program, control)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
