"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, then ``checks``: each
number compared with its limit); the last lines of standard error repeat
the checks.  With no CUDA card, or fewer than the cell asks for, it
exits with code 2 and prints no result; so it does if a module of the
JAX stack or the JAX package was loaded.  Build and kernel caches stay
at fixed paths inside the checkout.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "perfbench", ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a run must end inside 360 s: past 330 s, show where it is
    faulthandler.dump_traceback_later(330, exit=False)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)
    from perfbench import harness

    man = harness.manifest(ROOT)
    wl = harness.workload(man, args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(wl["chips"]):
        print(f"perfbench: {args.workload} needs {wl['chips']} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    try:
        res = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), root=ROOT, device="cuda",
                               t_process=T_PROCESS)
    except harness.ForbiddenModules as exc:
        print(f"perfbench: refused, {exc}", file=sys.stderr)
        return 2
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
