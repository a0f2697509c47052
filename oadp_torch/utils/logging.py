"""Process-wide logger (analogue of ``todd.logger`` in the reference)."""

__all__ = ['logger', 'add_file_handler']

import logging
import pathlib
import sys

logger = logging.getLogger('oadp_torch')
if not logger.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            '[%(asctime)s %(process)d %(levelname)s] %(message)s',
            datefmt='%Y-%m-%d %H:%M:%S',
        )
    )
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def add_file_handler(path: str | pathlib.Path) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(path)
    handler.setFormatter(logger.handlers[0].formatter)
    logger.addHandler(handler)

