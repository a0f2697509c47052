"""Tiny widths of each cell for the CPU tests: every width and count cut
so that a whole run takes seconds on the CPU."""

SIZES = [[107, 160], [120, 160], [160, 107], [160, 120]] * 2
CONFIG = dict(width=64, layers=2, heads=1, output_dim=32, objects_mini_batch_size=16,
              max_image_size=160)
TINY = {
    'oake-objects-constant': dict(
        config=CONFIG,
        mix=dict(ids=96, ids_each=4, proposals=12, warm_records=2, check_records=2, sizes=SIZES),
    ),
}


def cell(name: str):
    from benchmark import harness
    c = harness.load_cell(name)
    c.config.update(TINY[name]['config'])
    c.mix.update(TINY[name]['mix'])
    return c


def run(name: str, seed: int, seconds: float = 1.5) -> dict:
    from benchmark import harness
    t = TINY[name]
    return harness.run_cell(name, seed, seconds, False, 'cpu', dict(t['config']), dict(t['mix']))[0]
