"""The port's host spans (`diagnostics.span`) and the runner's step rows on
the CPU: nesting and self times, the bounded ring, the span totals in
`gibbs.reset_graph_stats()`'s table, the rows' `host_ms`, the spans under
a CPU profiler and nothing of the profiler without one."""

import pytest
import torch

from distributions_tpu_torch import clustering as cl, config, diagnostics
from distributions_tpu_torch import mixture as mx, testing
from distributions_tpu_torch.inference import runner
from distributions_tpu_torch.models import nich
from distributions_tpu_torch.ops import gibbs

torch.set_num_threads(1)
config.set_default_device('cpu')

OLD_GRAPH_KEYS = {'captures', 'replays', 'capture_seconds', 'pool_bytes',
                  'score_captures', 'score_replays', 'first_uses'}


@pytest.fixture
def cpu():
    gibbs.reset_graph_stats()
    return torch.device('cpu')


def _run(steps=3, sweeps_per_step=2, seed=0):
    """run_gibbs on 2 nich columns: 4 tiles of 64 rows, 16 slots, `steps`
    steps of `sweeps_per_step` fused sweeps."""
    values, labels = testing.nich_problem(256, seed=3, n_clusters=6)
    spec = mx.make_spec([(nich, 2)], capacity=16)
    sh = (nich.shared_from_dict(testing.NICH_SHARED, device='cpu'),)
    py = cl.PitmanYor.from_dict(testing.PY, device='cpu')
    return runner.run_gibbs(
        spec, py, sh, (torch.from_numpy(values),),
        torch.Generator().manual_seed(seed), steps * sweeps_per_step,
        block=64, use_pallas=True, sweeps_per_step=sweeps_per_step,
        initial_assignments=torch.from_numpy(labels), grow_headroom=0.0,
        sampling='gumbel')


def _ring(name):
    return [r for r in diagnostics.SPAN_RING if r[0] == name]


def test_spans_nest_and_self_time_is_duration_less_children(cpu):
    with diagnostics.span('runner.step', step=7) as step:
        with diagnostics.span('runner.sweeps'):
            with diagnostics.span('graph.replays') as inner:
                sum(range(1000))
            sum(range(1000))
        with diagnostics.span('runner.validate'):
            pass
    ring = {r[0]: r for r in diagnostics.SPAN_RING}
    assert ring['graph.replays'][3:] == ('runner.sweeps', 7)
    assert ring['runner.sweeps'][3:] == ('runner.step', 7)
    assert ring['runner.validate'][3:] == ('runner.step', 7)
    assert ring['runner.step'][3:] == (None, 7)

    def ns(name):
        return ring[name][2] - ring[name][1]
    totals = gibbs.GRAPH_STATS['spans']
    assert totals['runner.step']['seconds'] == pytest.approx(
        ns('runner.step') / 1e9)
    assert totals['runner.step']['self_seconds'] == pytest.approx(
        (ns('runner.step') - ns('runner.sweeps') - ns('runner.validate'))
        / 1e9)
    assert totals['runner.sweeps']['self_seconds'] == pytest.approx(
        (ns('runner.sweeps') - ns('graph.replays')) / 1e9)
    assert totals['graph.replays']['self_seconds'] == pytest.approx(
        inner.seconds)
    # the step's self times by name, its own included, sum to its duration
    assert set(step.self_ms) == {'runner.step', 'runner.sweeps',
                                 'graph.replays', 'runner.validate'}
    assert sum(step.self_ms.values()) == pytest.approx(step.seconds * 1e3)
    # a span outside any step belongs to none
    with diagnostics.span('runner.setup') as setup:
        pass
    assert setup.step is None and setup.self_ms is None
    assert _ring('runner.setup')[0][3:] == (None, None)


def test_span_names_are_frozen(cpu):
    with pytest.raises(ValueError):
        diagnostics.span('runner.somewhere_else')
    assert len(set(diagnostics.SPAN_NAMES)) == len(diagnostics.SPAN_NAMES)


def test_a_span_closes_when_its_block_raises(cpu):
    with pytest.raises(KeyError):
        with diagnostics.span('runner.call'):
            with diagnostics.span('runner.setup'):
                raise KeyError('x')
    with diagnostics.span('runner.step', step=1):
        pass
    assert _ring('runner.step')[0][3] is None
    assert gibbs.GRAPH_STATS['spans']['runner.setup']['count'] == 1


def test_the_ring_is_bounded(cpu):
    for i in range(diagnostics.RING_SIZE + 10):
        with diagnostics.span('runner.step', step=i):
            pass
    assert len(diagnostics.SPAN_RING) == diagnostics.RING_SIZE
    assert diagnostics.SPAN_RING[0][4] == 10
    assert diagnostics.SPAN_RING[-1][4] == diagnostics.RING_SIZE + 9
    assert gibbs.GRAPH_STATS['spans']['runner.step']['count'] \
        == diagnostics.RING_SIZE + 10


def test_reset_graph_stats_clears_the_spans_and_keeps_its_keys(cpu):
    with diagnostics.span('runner.call'):
        pass
    gibbs.GRAPH_STATS['replays'] = 3
    table = gibbs.reset_graph_stats()
    assert table is gibbs.GRAPH_STATS
    assert OLD_GRAPH_KEYS <= set(table)
    assert all(table[k] == 0 for k in OLD_GRAPH_KEYS)
    assert table['sweep_graph_nodes'] == 0
    assert table['spans'] == {} and len(diagnostics.SPAN_RING) == 0
    # the table's span totals are the ones the spans write
    with diagnostics.span('runner.call'):
        pass
    assert table['spans']['runner.call']['count'] == 1


def test_run_gibbs_rows_carry_host_ms_of_frozen_names(cpu):
    _, _, log = _run()
    assert len(log.rows) == 3
    for row in log.rows:
        assert set(row['host_ms']) <= set(diagnostics.SPAN_NAMES)
        assert {'runner.step', 'runner.sweeps', 'runner.counts_sync',
                'runner.validate', 'runner.sweep_stats',
                'runner.growth'} <= set(row['host_ms'])
        assert all(ms >= 0 for ms in row['host_ms'].values())
        # the card's events are not there on the CPU
        assert not {'device_ms', 'tile_ms', 'captured'} & set(row)
        # 'seconds' spans the stat cache, the sweeps and the counts sync
        # (rounded to 0.1 ms), which hold its spans
        inside = sum(row['host_ms'].get(k, 0.0) for k in (
            'runner.stat_cache', 'runner.sweeps', 'runner.counts_sync'))
        assert inside <= row['seconds'] * 1e3 + 0.05 + 1e-9
    assert 'runner.stat_cache' in log.rows[0]['host_ms']
    spans = gibbs.GRAPH_STATS['spans']
    assert spans['runner.step']['count'] == 3
    assert spans['runner.setup']['count'] == 1
    assert spans['runner.call']['count'] == 1
    steps = _ring('runner.step')
    assert [r[4] for r in steps] == [0, 2, 4]
    # a row's self times sum to its step's duration
    for row, r in zip(log.rows, steps):
        assert sum(row['host_ms'].values()) == pytest.approx(
            (r[2] - r[1]) / 1e6)


def test_runner_spans_under_a_cpu_profiler(cpu):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(steps=2)
    spans = [e for e in prof.events() if e.name in diagnostics.SPAN_NAMES]
    assert {'runner.call', 'runner.setup', 'runner.step', 'runner.growth',
            'runner.stat_cache', 'runner.sweeps', 'runner.counts_sync',
            'runner.validate', 'runner.sweep_stats'} <= {e.name
                                                         for e in spans}
    # host operators, not user annotations (which the profiler would also
    # lay over the device's timeline)
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               and not e.is_user_annotation for e in spans)


def test_no_record_function_without_a_profiler(cpu, monkeypatch):
    entered = []
    real = diagnostics._record_function

    def counted(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(diagnostics, '_record_function', counted)
    _run(steps=2)
    assert entered == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _run(steps=2)
    assert entered.count('runner.step') == 2


def test_the_chain_is_bitwise_the_same_under_a_profiler(cpu):
    from torch.profiler import ProfilerActivity, profile
    a = _run(seed=5)
    with profile(activities=[ProfilerActivity.CPU]):
        b = _run(seed=5)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0].counts, b[0].counts)
    assert all(torch.equal(x, y) for x, y in zip(a[0].groups[0],
                                                  b[0].groups[0]))

    def rows(log):
        return [{k: v for k, v in r.items()
                 if k not in diagnostics.CLOCK_KEYS} for r in log.rows]
    assert rows(a[2]) == rows(b[2])


def test_run_gibbs_keeps_its_signature():
    import inspect
    params = inspect.signature(runner.run_gibbs).parameters
    assert list(params)[:6] == ['spec', 'cl_model', 'shareds', 'values',
                                'generator', 'passes']
    assert runner.run_gibbs.__doc__.startswith('Run `passes` blocked')
