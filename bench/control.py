"""Read a cell's control (the reference in the next lower precision put in
the program's place) and its planted faults against the reference, on the
card at the cell's own size, one seed after another in one process:

    python3 bench/control.py --workload <cell> --seeds 11 12 13

Prints one JSON line a seed: {"seed": n, "<control or fault>": {"correct":
the harness's verdict under the runner's LIMITS, <compared number>:
reading}}; a control or fault that comes out correct is named on standard
error and the exit code is 1.  The benchmark's own runs never run this;
its readings, beside the program's, set the limits (PERF.md).
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("bench control: no CUDA card", file=sys.stderr)
        return 2
    passed = []
    for seed in args.seeds:
        env = harness.make_env(args.workload, seed, 0.0, False,
                               torch.device("cuda", 0), ROOT)
        runner = harness.load_runner(env.config["runner"], ROOT)
        judged = judge(runner, runner.control(env))
        passed += [f"{name} (seed {seed})" for name, r in judged.items() if r["correct"]]
        print(json.dumps({"seed": seed, **judged}), flush=True)
        torch.cuda.empty_cache()
    if passed:
        print(f"bench control: came out correct: {passed}", file=sys.stderr)
    return 1 if passed else 0


def judge(runner, readings):
    """Each control's or fault's readings with the harness's verdict under
    the runner's limits."""
    from bench import harness
    return {name: {"correct": harness.verdict(
        [harness.Check(k, v, runner.LIMITS[k]) for k, v in r.items()]), **r}
        for name, r in readings.items()}


if __name__ == "__main__":
    sys.exit(main())
