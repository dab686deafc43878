"""The benchmark's command: one process, one cell.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

See `port_bench/harness.py` and `port_bench/README.md`.
"""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from port_bench import harness

    sys.exit(harness.main(t_start=T_START))
