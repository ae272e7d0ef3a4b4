"""``python3 -m perfbench``: see ``perfbench/run.py``."""

import time

T0 = time.time()  # the process's start, as near as Python sees it

if __name__ == "__main__":
    import sys

    from perfbench.run import main

    sys.exit(main(t0=T0))
