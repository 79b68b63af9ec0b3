"""The benchmark of legkilo_torch: one run of one cell of BENCHMARK.json.

    python portbench/run.py --workload go1_imu.mc256 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout that holds legkilo_torch (see
portbench/harness.py for what it prints and its exit codes).
"""

import os
import sys
import time

T_START = time.perf_counter()
os.environ.setdefault("OMP_NUM_THREADS", "4")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # not portbench/: its modules are imported as portbench.*

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(ROOT, T_START))
