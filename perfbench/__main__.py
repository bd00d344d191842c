"""python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""

import time

T0 = time.perf_counter()  # set-up runs from here to the window's start

if __name__ == "__main__":
    from perfbench.harness import main

    raise SystemExit(main(T0))
