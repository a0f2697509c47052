"""Run one cell of ``BENCHMARK.json`` once::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object; the last lines of
standard error are the numbers compared, each beside its limit.
"""

import sys

from benchmark.harness import main

if __name__ == '__main__':
    sys.exit(main())
