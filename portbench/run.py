"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (see ``harness.py`` and README.md).
"""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this folder, so that the program and the
# ``portbench`` package import by their own names
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
