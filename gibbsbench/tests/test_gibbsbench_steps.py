"""The readers of the program's own instruments (gibbsbench/steps.py and
the metrics on it) on hand-made runs: the step rows' host_ms, device_ms
and tile_ms, and the graph table's span totals and node count."""

import types

import pytest

from gibbsbench import metrics

NEW = ('step_host_ms', 'call_setup_s', 'step_edge_device_ms',
       'tile_inputs_device_ms', 'tile_stats_device_ms',
       'tile_kernel_device_ms', 'sweep_graph_nodes')
DEVICE = ('step_edge_device_ms', 'tile_inputs_device_ms',
          'tile_stats_device_ms', 'tile_kernel_device_ms')


def _row(i, captured=False):
    """A step row as the runner writes it on the card, its numbers made
    from the step index."""
    row = {'sweep': 10 * i + 9, 'seconds': 0.5,
           'host_ms': {'runner.growth': 0.1, 'runner.sweeps': 400.0,
                       'graph.load': 0.2, 'graph.replays': 1.0,
                       'graph.score': 0.3, 'runner.counts_sync': 90.0,
                       'runner.validate': 0.2, 'runner.sweep_stats': 0.3,
                       'runner.step': 0.1 * (i + 1)},
           'device_ms': {'load': 0.05, 'sweeps': 7.0, 'score': 0.4,
                         'edge': 1.0 + i},
           'tile_ms': {'remove': 0.01, 'inputs': 0.1 + 0.01 * i,
                       'kernel': 0.6, 'sums': 0.02, 'add': 0.01,
                       'write': 0.03, 'state_copy': 0.005, 'sweep': 6.9}}
    if captured:
        row['captured'] = True
        row['host_ms']['runner.stat_cache'] = 50.0
        row['host_ms']['graph.capture'] = 400.0
        del row['device_ms']['edge']
    return row


def _run(rows, device_type='cuda', unprofiled=None, profiled_sweeps=10,
         graph=None):
    return types.SimpleNamespace(
        config={'rows': 1048576, 'tile_rows': 131072},
        device_type=device_type, step_rows=rows,
        unprofiled_steps=len(rows) - 1 if unprofiled is None else unprofiled,
        profiled_sweeps=profiled_sweeps,
        graph={'captures': 1, 'sweep_graph_nodes': 123,
               'spans': {'runner.setup': {'count': 1, 'seconds': 0.25,
                                          'self_seconds': 0.25}}}
        if graph is None else graph)


def read(name, run):
    return metrics.find(name).read(run)


def test_readers_average_the_steady_steps():
    # rows 1-3 are unprofiled and did not capture; row 4 was profiled
    run = _run([_row(0, captured=True)] + [_row(i) for i in (1, 2, 3, 4)])
    # host: rows 1 and 2 (row 3's logger call starts the profiler)
    outside = 0.1 + 0.2 + 0.3
    assert read('step_host_ms', run) == pytest.approx(
        outside + (0.2 + 0.3) / 2)
    assert read('call_setup_s', run) == 0.25
    # device: rows 1-3
    assert read('step_edge_device_ms', run) == pytest.approx(3.0)
    assert read('tile_inputs_device_ms', run) == pytest.approx(
        8 * (0.1 + 0.02))
    assert read('tile_stats_device_ms', run) == pytest.approx(
        8 * (0.01 + 0.02 + 0.01 + 0.03) + 0.005)
    assert read('tile_kernel_device_ms', run) == pytest.approx(8 * 0.6)
    assert read('sweep_graph_nodes', run) == 123.0


def test_an_untraced_run_keeps_its_last_step():
    run = _run([_row(1), _row(2)], unprofiled=2, profiled_sweeps=0)
    assert read('step_host_ms', run) == pytest.approx(0.6 + 0.25)


def test_device_readers_read_nothing_off_the_card():
    run = _run([_row(0, captured=True)] + [_row(i) for i in (1, 2, 3)],
               device_type='cpu', graph={'captures': 0,
                                         'sweep_graph_nodes': 0,
                                         'spans': {}})
    for name in DEVICE + ('sweep_graph_nodes', 'call_setup_s'):
        assert read(name, run) is None, name
    assert read('step_host_ms', run) is not None


def test_a_program_without_the_instruments_gives_none():
    # the rows and graph table of a program before the spans and events
    rows = [{'sweep': 9, 'seconds': 0.5, 'score_data': -1.0}
            for _ in range(4)]
    run = _run(rows, graph={'captures': 1, 'replays': 199,
                            'capture_seconds': 0.4})
    for name in NEW:
        assert read(name, run) is None, name


def test_steps_captured_or_profiled_are_left_out():
    # every unprofiled step captured: nothing steady to read
    run = _run([_row(0, captured=True), _row(1)], unprofiled=1)
    for name in DEVICE + ('step_host_ms',):
        assert read(name, run) is None, name
