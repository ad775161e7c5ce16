"""The harness: BENCHMARK.json and the files it names, found by name; the
last line of a run; the check for JAX and the JAX package; the refusal
without a card."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from gibbsbench import metrics, problem, run

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
SMALL = dict(rows=4096, tile_rows=1024, slots=64, generating_clusters=24,
             sweeps_per_step=2, sample_rows=1024, steps=3)


def test_benchmark_names_files_that_exist():
    bench = problem.benchmark()
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    configs = {c['name']: c for c in bench['configs']}
    for c in bench['configs']:
        assert NAME.match(c['name'])
        assert os.path.exists(os.path.join(problem.ROOT, c['file']))
        assert c['file'] == 'gibbsbench/configs/%s.json' % c['name']
        assert problem.config(c['name'])['source'] == c['source']
    cells = [w['name'] for w in bench['workloads']]
    assert len(set(cells)) == len(cells)
    for w in bench['workloads']:
        assert NAME.match(w['name']) and w['config'] in configs
        assert w['chips'] == 1
        t = problem.traffic(w['traffic'])
        assert set(t) == {'slots', 'generating_clusters',
                          'sweeps_per_step', 'sampling'}
    names = [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    assert len(set(names)) == len(names)
    assert 'setup_s' in names
    for m in bench['end_to_end'] + bench['per_layer']:
        assert callable(metrics.find(m['name']).read)
        assert set(m.get('workloads', cells)) <= set(cells)
    for m in bench['per_layer']:
        assert m['moves'] in [e['name'] for e in bench['end_to_end']]


def test_every_cell_reports_what_it_must():
    bench = problem.benchmark()
    for w in bench['workloads']:
        e2e = [n for n, _ in run.cell_metrics(bench, w, 0)]
        layer = [n for n, _ in run.cell_metrics(bench, w, 1)]
        assert 'setup_s' in e2e and len(e2e) >= 2 and layer
        for m in bench['per_layer']:
            if m['name'] in layer:
                # a per-layer metric moves an end-to-end metric of its cell
                assert m['moves'] in e2e, (w['name'], m['name'])
        assert 'sweep_ms' in e2e


def test_metric_names_are_module_names():
    # a split quantity, `<quantity>.<part>`, is read by the quantity's
    assert metrics.find('sweep_ms.train') is metrics.find('sweep_ms')
    with pytest.raises(ValueError):
        metrics.find('../run')
    with pytest.raises(ImportError):
        metrics.find('no_such_metric')


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(['distributions_tpu_torch.ops',
                                  'numpy', 'jaxtyping']) == []
    assert run.forbidden_modules(['jax.numpy', 'distributions_tpu.mixture',
                                  'flax', 'jaxlib']) == [
        'distributions_tpu', 'flax', 'jax', 'jaxlib']


def _python(code):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    return subprocess.run([sys.executable, '-c', code], cwd=problem.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_reference_loads_nothing_of_the_program():
    out = _python(
        'import sys\n'
        'from gibbsbench import reference, roofline\n'
        'from gibbsbench.models import nich, niw, bb\n'
        'print(sorted({m.split(".")[0] for m in sys.modules} & '
        '{"jax", "distributions_tpu", "distributions_tpu_torch"}))')
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_a_run_loads_no_jax():
    out = _python(
        'import json, time, sys\n'
        'from distributions_tpu_torch import config\n'
        'config.set_default_device("cpu")\n'
        'from gibbsbench import run, problem\n'
        'b = problem.benchmark()\n'
        'r = run.measure(b, problem.workload(b, "bb1.c1024"), 1, 0.1, '
        '1, "cpu", %r, t_start=time.perf_counter())\n'
        'print(json.dumps(run.forbidden_modules()))' % (SMALL,))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip('a card is here')
    rc = run.main(['--workload', 'nich2.c1024', '--seed', '1',
                   '--seconds', '1'])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ''
    assert 'CUDA' in out.err


def test_fails_outside_a_checkout(tmp_path):
    """In a directory with only BENCHMARK.json and gibbsbench/ the run
    finds no program and prints no result."""
    import shutil
    shutil.copy(os.path.join(problem.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(problem.ROOT, 'gibbsbench'),
                    tmp_path / 'gibbsbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run(
        [sys.executable, '-m', 'gibbsbench.run', '--workload',
         'nich2.c1024', '--seed', '1', '--seconds', '1'], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=''))
    assert out.returncode != 0 and out.stdout == ''


@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('name', ['nich2.c1024', 'bb1.c1024'])
def test_last_line_keys(cpu_port, name, trace):
    bench = problem.benchmark()
    cell = problem.workload(bench, name)
    result, checks, lines = run.measure(bench, cell, 2 ** 33 + 1, 0.1,
                                        trace, 'cpu', SMALL)
    assert list(result)[:3] == ['correct', 'attempted', 'failed']
    assert list(result)[-1] == 'checks'
    assert {'metrics', 'device'} <= set(result)
    assert set(result['device']) >= {'platform', 'kind', 'count',
                                     'memory_peak_bytes'}
    assert result['attempted'] == 6 and result['failed'] == 0
    want = {n for n, _ in run.cell_metrics(bench, cell, trace)}
    assert set(result['metrics']) <= want
    if not trace:
        # the host-clock metrics exist on any device
        assert set(result['metrics']) == want
    assert [c[0] for c in checks] == list(result['checks'])
    # bb's statistics are whole numbers, which counts_gap holds
    floats = {'stats_gap'} if name.startswith('nich2') else set()
    assert set(result['checks']) == {'counts_gap', 'score_gap',
                                     'draw_z'} | floats
    json.dumps(result)


@pytest.mark.requires_cuda
def test_a_small_cell_on_the_card(cuda):
    bench = problem.benchmark()
    for name in ('nich2.c1024', 'bb1.c1024'):
        result, _, _ = run.measure(bench, problem.workload(bench, name), 7,
                                   0.1, 1, cuda, SMALL)
        assert result['correct'], result
        assert result['device']['busy_s'] > 0
