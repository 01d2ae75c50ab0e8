#!/usr/bin/env python3
"""The control of the check that decides ``correct``: the reference put
in the program's place with one guarantee of the configuration broken
(``reference.CONTROLS``), at the cell's own size and schedule, on
several seeds. Its digests go through the harness's own check
(``harness.check``) as the program's would, over the warm-up calls and
one round of window calls; prints per seed and control the checks and
``correct``, which has to read false.

    python3 decode_bench/control.py --workload h264-main-1080p.s8 \\
        --seeds 101 102 103

Only the host's cores work (no device); the benchmark's runs never run
this.
"""

import argparse
import json
import pathlib
import sys
import time
from concurrent.futures import ThreadPoolExecutor

if __name__ == "__main__":  # as a script: import as decode_bench.*
    sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from decode_bench import harness, reference, streams  # noqa: E402


def control_results(cell: harness.Cell, seed: int) -> list:
    """[(control, checks, correct)] of each control of the cell's codec
    on this seed."""
    sched = harness.Schedule(cell.traffic, len(cell.config["gop"]))
    datas = streams.make(cell.config, seed, sched.gops)
    ref = reference.make(cell.config, seed, datas)
    out = []
    for c in reference.CONTROLS[cell.config["codec"]]:
        ctl = reference.make(cell.config, seed, datas, control=c)
        got = [(k, [ctl[g][lo:hi, :3] for g, lo, hi in sched(k)])
               for k in range(2 * sched.warm)]
        checks, correct, _ = harness.check(got, ref, sched)
        out.append((c, checks, correct))
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    t0 = time.perf_counter()
    # the seeds side by side: each decodes its GOPs in processes of its own
    with ThreadPoolExecutor(len(args.seeds)) as ex:
        results = list(ex.map(lambda s: control_results(cell, s),
                              args.seeds))
    for seed, res in zip(args.seeds, results):
        for c, checks, correct in res:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": c, "correct": correct,
                              "checks": checks}))
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
