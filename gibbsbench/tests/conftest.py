"""The benchmark's own tests run on the CPU at small sizes; a test that
needs the card carries `requires_cuda` and skips without one.

    python -m pytest gibbsbench/tests -q
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'requires_cuda: needs an NVIDIA GPU; skips without one')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


@pytest.fixture
def cpu_port():
    """The port on the CPU, one thread."""
    from distributions_tpu_torch import config
    torch.set_num_threads(1)
    config.set_default_device('cpu')
    yield
    config.set_default_device(None)


@pytest.fixture
def mixed_config():
    """A configuration of every plain model the benchmark holds (niw d=2,
    nich, bb) under Pitman-Yor {1, 0.1}, which no cell runs: the reference
    and the frozen counts of a later cell's niw or mixed rows."""
    return {
        'rows': 1048576, 'tile_rows': 65536, 'dtype': 'float32',
        'prior': {'model': 'pitman_yor', 'alpha': 1.0, 'd': 0.1},
        'blocks': [
            {'model': 'niw', 'cols': 1,
             'shared': {'mu': [0.0, 0.0], 'kappa': 1.0,
                        'psi': [[1.0, 0.0], [0.0, 1.0]], 'nu': 3.0},
             'data': {'kind': 'blobs', 'center_scale': 3.0, 'noise': 0.3}},
            {'model': 'nich', 'cols': 1,
             'shared': {'mu': 0.0, 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.0},
             'data': {'kind': 'normal', 'scale': 1.0}},
            {'model': 'bb', 'cols': 1,
             'shared': {'alpha': 0.5, 'beta': 0.5},
             'data': {'kind': 'bernoulli', 'p': 0.4}}],
        'check': {'sample_rows': 16384},
        'limits': {'counts_gap': 0, 'stats_gap': 1e-3, 'score_gap': 2e-3,
                   'draw_z': 12.0}}
