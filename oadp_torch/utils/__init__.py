from .config import Config, DictAction, parse_override
from .dist import (Collective, end_rank, maybe_initialize_distributed, rank, spawn_ranks,
                   world_size)
from .logging import add_file_handler, logger
from .pth import PthAccessLayer, load_pth, save_pth
from .store import Store

__all__ = [
    'Config',
    'DictAction',
    'parse_override',
    'Collective',
    'maybe_initialize_distributed',
    'spawn_ranks',
    'end_rank',
    'rank',
    'world_size',
    'add_file_handler',
    'logger',
    'PthAccessLayer',
    'load_pth',
    'save_pth',
    'Store',
]
