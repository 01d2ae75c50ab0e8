#!/usr/bin/env python3
"""The benchmark of m2dec_tpu_torch: one run of one cell.

    python3 decode_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for (``BENCHMARK.json``). Makes the cell's streams from the seed,
runs the program's Phase A on them and warms up (set-up), measures whole
batches for ``--seconds``, checks every picture against the plain
reference and prints one JSON line: the end-to-end metrics with
``--trace 0``, the per-layer metrics from a device trace with ``--trace
1``. Without the devices, or without the program beside it, it exits
non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this directory, heads the import path, so
# that the benchmark's modules import as decode_bench.*
sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from decode_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
