"""What decides `correct`: sound runs pass, the bfloat16 control fails, and
so does a run whose timed path is broken underneath (a step that returns
its state unchanged; half of each tile's rows left out, the sums of the
rest doubled; every drawn slot altered where it is produced).  At a small
size on the CPU, through the harness's own run with the look for a card
skipped."""

import pytest
import torch

from gibbsbench import control, problem, run

SMALL = dict(rows=4096, tile_rows=1024, slots=64, generating_clusters=24,
             sweeps_per_step=2, sample_rows=1024, steps=3)
# a bb row is one bit, so the draw check needs a whole tile of the cell's
# size to see each row's slot moved by one
SIZES = {'nich2.c1024': SMALL,
         'bb1.c1024': dict(SMALL, rows=524288, tile_rows=131072,
                           sample_rows=131072)}
CELLS = tuple(SIZES)


def measure(cell, seed, keep=None):
    bench = problem.benchmark()
    result, _, _ = run.measure(bench, problem.workload(bench, cell), seed,
                               0.1, 0, 'cpu', SIZES[cell], keep=keep)
    return result


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('seed', [3, 2 ** 31 + 11])
def test_sound_runs_are_correct(cpu_port, cell, seed):
    result = measure(cell, seed)
    assert result['correct'], result['checks']


@pytest.mark.parametrize('cell', CELLS)
def test_the_control_is_not_correct(cpu_port, cell):
    keep = {}
    measure(cell, 17, keep)
    low = control.control_numbers(keep, 17)
    limits = keep['limits']
    assert not all(low[k] <= limits[k] for k in low), low


def _unchanged(real):
    def sweep(spec, cl, shareds, state, values, assignments, *args, **kw):
        from distributions_tpu_torch import mixture as mx
        cache = args[3]
        return state, assignments, cache, mx.score_data(spec, cl, shareds,
                                                        state)
    return sweep


def _half(real):
    def kernel(seed, values, table_idx, cl_scores, coeffs, tables,
               col_groups, **kw):
        rows = next(x.shape[0] for x in (values, table_idx, kw['qvalues'])
                    if x is not None)
        h = rows // 2

        def first(x):
            return None if x is None else x[:h]
        kw['qvalues'] = first(kw['qvalues'])
        idx, *sums = real(seed, first(values), first(table_idx), cl_scores,
                          coeffs, tables, col_groups, **kw)
        return (torch.cat([idx, idx]),) + tuple(2 * s for s in sums)
    return kernel


def _altered(real):
    def kernel(seed, values, table_idx, cl_scores, *args, **kw):
        idx, *sums = real(seed, values, table_idx, cl_scores, *args, **kw)
        C = cl_scores.shape[0]
        # each row's slot moved by one, with the sums moved alike
        return ((idx + 1) % C,) + tuple(torch.roll(s, 1, 0) for s in sums)
    return kernel


@pytest.mark.parametrize('cell', CELLS)
@pytest.mark.parametrize('fault', ['unchanged', 'half', 'altered'])
def test_a_broken_timed_path_is_not_correct(cpu_port, monkeypatch, cell,
                                            fault):
    from distributions_tpu_torch.ops import fused_kernels, gibbs
    if fault == 'unchanged':
        monkeypatch.setattr(gibbs, 'sweep_blocked_pallas_fused_mixed',
                            _unchanged(gibbs.sweep_blocked_pallas_fused_mixed))
    else:
        wrap = _half if fault == 'half' else _altered
        monkeypatch.setattr(
            fused_kernels, 'fused_mixed_score_sample_stats',
            wrap(fused_kernels.fused_mixed_score_sample_stats))
    result = measure(cell, 23)
    assert not result['correct'], result['checks']


def test_stats_gap_is_held_to_the_windows_rounding():
    cfg = problem.config('nich2')
    # 8 tiles, an unmerge and a merge each, over 100 sweeps
    assert run.window_limits(cfg, 100)['stats_gap'] == 1600 * 2.0 ** -24
    assert run.window_limits(cfg, 10 ** 6)['stats_gap'] == \
        cfg['limits']['stats_gap']
    assert 'stats_gap' not in run.window_limits(problem.config('bb1'), 100)
