"""The readings that set a cell's limits: the program's numbers compared
(a short window a seed, all seeds in one process) and the control's (the
reference in the precision below the configuration's, put in the
program's place), one JSON line a seed::

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...] \
        [--program-seconds 3] [--skip-program] [--skip-control]
"""

import argparse
import json
import pathlib
import sys
import tempfile

from benchmark import harness


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--program-seconds', type=float, default=3.0)
    parser.add_argument('--skip-program', action='store_true')
    parser.add_argument('--skip-control', action='store_true')
    args = parser.parse_args(argv)
    harness.use_checkout_caches()
    cell = harness.load_cell(args.workload)
    job = harness.load_module('jobs', cell.mix['job'])
    for seed in args.seeds:
        line = dict(seed=seed)
        if not args.skip_program:
            result, _ = harness.run_cell(args.workload, seed, args.program_seconds, False)
            line['program'] = {k: c['value'] for k, c in result['checks'].items()}
            line['correct'] = result['correct']
        if not args.skip_control:
            with tempfile.TemporaryDirectory(prefix='benchmark-control-') as tmp:
                spec = harness.Spec(harness.load_cell(args.workload), seed, 0.0, False, 'cuda',
                                    pathlib.Path(tmp))
                line['control'] = job.control(spec)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
