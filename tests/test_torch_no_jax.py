"""The port imports torch and never jax, directly or indirectly, and it
reads and writes its protobuf envelopes without `google.protobuf`."""

import os
import subprocess
import sys

import torch

from distributions_tpu_torch import config

torch.set_num_threads(1)
config.set_default_device('cpu')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r'''
import importlib, pkgutil, sys
import distributions_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.')
             or m == 'distributions_tpu' or m.startswith('distributions_tpu.')
             or m == 'google.protobuf' or m.startswith('google.protobuf.'))
print(len(names), bad)
assert not bad, bad
for name in ('models.bb', 'models.dd', 'models.dpd', 'models.gp',
             'models.bnb', 'models.niw', 'models.nich', 'ops.gibbs',
             'ops.fused_kernels', 'inference.runner', 'convert', 'testing',
             'io.stream', 'io.wire', 'io.checkpoint', 'parallel.sharding',
             'parallel.distributed', 'ops.bench_kernels', 'inference.hypers',
             'inference.slice', 'benchmarks.roofline', 'benchmarks.suite',
             'benchmarks.kernel_phases', 'benchmarks.bench',
             'benchmarks.bench_runner', 'benchmarks.timing',
             'benchmarks.tree_compare', 'benchmarks.split_variants',
             'benchmarks.sass_counts', 'ops.mh', 'ops.splitmerge',
             'compat', 'compat.rng', 'compat.models', 'compat.clustering',
             'compat.mixture', 'dbg', 'dbg.models', 'dbg.clustering', 'lp',
             'lp.models', 'lp.clustering', 'hp', 'hp.special', 'hp.random',
             'hp.clustering', 'hp.models', 'hp.models.bb', 'hp.models.bnb',
             'hp.models.dd', 'hp.models.dpd', 'hp.models.gp',
             'hp.models.nich', 'hp.models.niw', 'io.protobuf', 'util',
             'fileutil', '__main__'):
    assert 'distributions_tpu_torch.' + name in names, name
'''


def _assert_no_jax_imports(path):
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (['import'], ['from']):
            assert not words[1].startswith('jax'), line
            assert words[1].split('.')[0] != 'distributions_tpu', line


def test_chip_smoke_never_imports_jax():
    """chip_smoke.py imports nothing of JAX or of the JAX package, even
    lazily inside its functions."""
    _assert_no_jax_imports('chip_smoke.py')


def test_chip_profile_window_never_imports_jax():
    _assert_no_jax_imports('chip_profile_window.py')


def test_chip_reference_occupancy_never_imports_jax():
    _assert_no_jax_imports('chip_reference_occupancy.py')


def test_process_group_worker_never_imports_jax():
    _assert_no_jax_imports(os.path.join('tests',
                                        'torch_multiprocess_worker.py'))


def test_psum_worker_never_imports_jax():
    _assert_no_jax_imports(os.path.join('tests', 'torch_psum_worker.py'))


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(' ', 1)
    assert int(n_modules) >= 39 and bad.strip() == '[]'
