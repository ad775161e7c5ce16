"""What decides `correct` in the niw16 cell: sound runs pass, the bfloat16
control fails, and so does a run that draws each row's most likely slot
(sampling 'argmax') where the cell draws from the law ('gumbel'): the
configuration's overlapping 16-D clusters leave each row's conditional
law spread over several slots, so draw_z sees the argmax.  At a small size
on the CPU (256 rows a generating cluster: fewer rows a cluster and the
chain merges the overlapping clusters, whose law is then nearly a point
mass), through the harness's own run with the look for a card skipped."""

import pytest

from gibbsbench import control, problem, run

CELL = 'niw16.c1024'
SMALL = dict(rows=16384, tile_rows=4096, slots=128, generating_clusters=64,
             sweeps_per_step=2, sample_rows=4096, steps=3)


def measure(seed, keep=None, **overrides):
    bench = problem.benchmark()
    result, _, _ = run.measure(bench, problem.workload(bench, CELL), seed,
                               0.1, 0, 'cpu', dict(SMALL, **overrides),
                               keep=keep)
    return result


def test_the_cell_runs_the_configuration():
    bench = problem.benchmark()
    cell = problem.workload(bench, CELL)
    cfg = problem.config(cell['config'])
    block, = cfg['blocks']
    assert block['model'] == 'niw' and block['cols'] == 1
    assert len(block['shared']['mu']) == 16
    assert cell['chips'] == 1 and cell['traffic'] == 'c1024'
    assert problem.traffic(cell['traffic'])['sampling'] == 'gumbel'


@pytest.mark.parametrize('seed', [3, 2 ** 31 + 11])
def test_sound_runs_are_correct(cpu_port, seed):
    result = measure(seed)
    assert result['correct'], result['checks']


def test_the_control_is_not_correct(cpu_port):
    keep = {}
    measure(17, keep)
    low = control.control_numbers(keep, 17)
    limits = keep['limits']
    assert not all(low[k] <= limits[k] for k in low), low


def test_an_argmax_draw_fails_the_draw_check(cpu_port):
    result = measure(23, sampling='argmax')
    checks = result['checks']
    assert checks['draw_z']['value'] > checks['draw_z']['limit'], checks
    assert not result['correct']
