"""Run one cell of the benchmark once, on this host's CUDA card(s):

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the numbers the
check compared, each beside its limit, are the last lines of standard
error.  Without a CUDA card it prints no result and exits with 2."""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from rtbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
