"""Calibration hyperparameter sweep:
``python -m oadp_torch.dp.calibrate_sweep <config> <dump_root> [--trials 100]
[--seed 0] [--sampler tpe|random] [--output work_dirs/calibration.json]
[--override .k:v ...]`` (port of ``tools/calibrate_sweep.py``; reference
``tools/nni_dp_test.py``).

The reference drives an NNI TPE experiment over the 9 ensemble-calibration
scalars; this driver runs the in-process TPE of ``utils/search.py`` (NNI's
tuner scheme), or pure random search, over the same space. The records are
loaded once (:class:`~.test_calibrate.CalibrationRunner`, on
``model.device``, default ``cuda``), and trial 0 is the reference defaults.
The output JSON holds the best value and params and every trial.
"""

__all__ = ['SEARCH_SPACE', 'sweep', 'main']

import argparse
import json
import pathlib

import numpy as np

from ..base import Globals
from ..utils import Config, DictAction, logger
from ..utils.search import TpeSampler
from .test_calibrate import DEFAULT_PARAMS, CalibrationRunner

# reference search space (tools/nni_dp_test.py:17-57)
SEARCH_SPACE = {
    'bbox_base_scaler': (0.2, 1.5),
    'bbox_novel_scaler': (0.2, 1.5),
    'bbox_base_gamma': (0.2, 0.8),
    'bbox_novel_gamma': (0.2, 0.8),
    'object_base_scaler': (0.2, 1.5),
    'object_novel_scaler': (0.2, 1.5),
    'object_base_gamma': (0.2, 0.8),
    'object_novel_gamma': (0.2, 0.8),
    'objectness_gamma': (0.0, 1.0),
}


def sweep(runner: CalibrationRunner, trials: int, seed: int = 0,
          sampler: str = 'tpe') -> dict:
    """``trials`` trials of ``runner``: trial 0 at the defaults, then TPE or
    random draws. Returns ``{best_value, best_params, metric, history}``."""
    key = f'COCO_{Globals.categories.num_bases}_bbox_mAP_50'
    rng = np.random.default_rng(seed)
    tpe = TpeSampler(SEARCH_SPACE, seed=seed) if sampler == 'tpe' else None
    best = (-1.0, dict(DEFAULT_PARAMS))
    history = []
    for i in range(trials):
        if i == 0:  # trial 0 = the reference defaults (lambda 2/3, 1/3)
            params = dict(DEFAULT_PARAMS)
        elif tpe is not None:
            params = tpe.ask()
        else:
            params = {k: float(rng.uniform(lo, hi)) for k, (lo, hi) in SEARCH_SPACE.items()}
        value = float(runner.run_trial(params).get(key, -1.0))
        if tpe is not None:
            tpe.tell(params, value)
        history.append({'params': params, key: value})
        if value > best[0]:
            best = (value, params)
        logger.info('trial %d/%d: %s=%.4f (best %.4f)', i + 1, trials, key, value, best[0])
    return {'best_value': best[0], 'best_params': best[1], 'metric': key,
            'history': history}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('config', type=Config.load)
    parser.add_argument('root')
    parser.add_argument('--trials', type=int, default=100)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--sampler', choices=('tpe', 'random'), default='tpe')
    parser.add_argument('--output', default='work_dirs/calibration.json')
    parser.add_argument('--override', action=DictAction, nargs='+')
    args = parser.parse_args(argv)
    config: Config = args.config
    if args.override:
        config.override(args.override)

    out = sweep(CalibrationRunner(config, args.root), args.trials, args.seed, args.sampler)
    path = pathlib.Path(args.output)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    print(json.dumps({'metric': out['metric'], 'value': out['best_value'],
                      'params': out['best_params']}))
    return out


if __name__ == '__main__':
    main()
