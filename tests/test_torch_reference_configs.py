"""The JAX package's documented runner configurations on the port, at a
small size: the bb runner (one bb feature under a CRP, K2 with a single
table column) and the one-column nich runner (K1's one-column shape)
through run_gibbs(use_pallas=True) against the JAX runner under
'argmax'; bench_runner's bb model against the JAX script's recipe; and
the native stream framing against the pure-Python path."""

import importlib.machinery
import importlib.util
import json
import os
import subprocess
import sys
import sysconfig

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.inference import runner as jr
from distributions_tpu.models import bb as jbb, nich as jnich
from distributions_tpu_torch import clustering as tcl, config
from distributions_tpu_torch import mixture as tmx
from distributions_tpu_torch.benchmarks import bench_runner
from distributions_tpu_torch.inference import runner as tr
from distributions_tpu_torch.io import stream
from distributions_tpu_torch.models import bb as tbb, nich as tnich
from distributions_tpu_torch.ops import fused_kernels as fk

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C, BLOCK, SPS = 2048, 128, 512, 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX bench_runner's priors
PY = {'alpha': 1.0, 'd': 0.1}
NICH_SHARED = {'mu': 0., 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.}
BB_SHARED = {'alpha': 0.5, 'beta': 0.5}


def _jax_recipe(model, R, C, n_true):
    """benchmarks/bench_runner.py's data, re-derived with numpy: the
    labels, then per cluster a heads probability (bb) or a center (nich),
    then the rows, all from RandomState(0)."""
    rng = np.random.RandomState(0)
    labels = rng.randint(0, n_true, R)
    if model == 'bb':
        ps = rng.rand(n_true)
        X = (rng.rand(R) < ps[labels])[:, None]
    else:
        centers = rng.randn(n_true, 1).astype(np.float32)
        X = (centers[labels] + 0.1 * rng.randn(R, 1).astype(np.float32)
             ).astype(np.float32)
    return X, labels.astype(np.int32)


def _problem(model):
    """(JAX spec, prior, shareds), (port spec, prior, shareds), rows and
    labels of the bb or the one-column nich runner at R x C."""
    n_true = C // 8 * 7
    X, labels = _jax_recipe(model, R, C, n_true)
    if model == 'bb':
        py, shared, models = {'alpha': 1.0, 'd': 0.0}, BB_SHARED, (jbb, tbb)
    else:
        py, shared, models = PY, NICH_SHARED, (jnich, tnich)
    sides = [(mx.make_spec([(m, 1)], capacity=C, empties=1),
              cl_mod.PitmanYor.from_dict(py), (m.shared_from_dict(shared),))
             for mx, cl_mod, m in zip((jmx, tmx), (jcl, tcl), models)]
    return sides[0], sides[1], X, labels


@pytest.mark.parametrize('model', ['bb', 'nich1'])
def test_reference_runner_argmax_matches_jax(model):
    """Both runners take their fused path (K2 on the bb spec, K1 on the
    one-column nich spec) and give the same chain under 'argmax': equal
    assignments and counts, score_data within 1e-4."""
    (jspec, jpy, jsh), (spec, py, sh), X, labels = _problem(model)
    if model == 'bb':
        assert fk.supports_mixed_pallas(spec) and not fk.supports_pallas(spec)
    else:
        assert fk.supports_pallas(spec)
    common = dict(block=BLOCK, use_pallas=True, sampling='argmax',
                  sweeps_per_step=SPS, grow_headroom=0.0)
    jst, jan, jlog = jr.run_gibbs(
        jspec, jpy, jsh, (jnp.asarray(X),), jax.random.PRNGKey(0), 2 * SPS,
        initial_assignments=jnp.asarray(labels), **common)
    st, an, log = tr.run_gibbs(spec, py, sh, (X,),
                               torch.Generator().manual_seed(0), 2 * SPS,
                               initial_assignments=labels, **common)
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    assert st.counts.shape[0] == jst.counts.shape[0] == C
    assert len(log.rows) == len(jlog.rows) == 2
    for got, want in zip(log.rows, jlog.rows):
        assert got['sweeps'] == want['sweeps'] == SPS
        assert got['nonempty_groups'] == want['nonempty_groups']
        assert abs(got['score_data'] - want['score_data']) \
            <= 1e-4 * abs(want['score_data'])


def test_state_drift_of_a_long_run_is_the_jax_runners():
    """bench_runner's nich2 setting, 3 steps of 50 sweeps: both runners
    update each slot's nich stats by an unmerge and a merge a tile and
    sweep, in f32, and drift alike from state_from_assignments of the
    final assignments (chip_smoke's check_state allows the drift of
    those updates on the card's 150-sweep runs)."""
    rows, block, steps, sps = 8192, 1024, 3, 50
    spec, py, sh, (X,), labels = bench_runner.problem('nich', rows, C,
                                                      C // 4 * 3, 2, 'cpu')
    jspec = jmx.make_spec([(jnich, 2)], capacity=C, empties=1)
    jpy = jcl.PitmanYor.from_dict(PY)
    jsh = (jnich.shared_from_dict(NICH_SHARED),)
    common = dict(block=block, use_pallas=True, sampling='argmax',
                  sweeps_per_step=sps, grow_headroom=0.0)
    jst, jan, _ = jr.run_gibbs(jspec, jpy, jsh, (jnp.asarray(X),),
                               jax.random.PRNGKey(0), steps * sps,
                               initial_assignments=jnp.asarray(labels),
                               **common)
    st, an, _ = tr.run_gibbs(spec, py, sh, (X,),
                             torch.Generator().manual_seed(0), steps * sps,
                             initial_assignments=labels, **common)
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    fresh = tmx.state_from_assignments(spec, py, sh, (torch.from_numpy(X),),
                                       an)
    jfresh = jmx.state_from_assignments(jspec, jpy, jsh, (jnp.asarray(X),),
                                        jan)
    updates = 2 * rows // block * steps * sps
    for leaf in ('mean', 'count_times_variance'):
        got = getattr(st.groups[0], leaf).numpy()
        want = getattr(fresh.groups[0], leaf).numpy()
        drift = np.abs(got - want).max()
        jax_drift = np.abs(np.asarray(getattr(jst.groups[0], leaf))
                           - np.asarray(getattr(jfresh.groups[0], leaf))).max()
        assert 0 < drift <= updates * 2.0 ** -24 * np.abs(want).max()
        assert drift <= 4 * jax_drift, (leaf, drift, jax_drift)


def test_bench_runner_bb_is_the_jax_recipe(monkeypatch, capsys):
    """RUNNER_MODEL=bb runs the JAX script's data (every run of the
    process on the same rows and labels) and reports the final
    capacity."""
    rows, comps, clusters = 512, 64, 56
    for name, value in (('ROWS', rows), ('COMPONENTS', comps),
                        ('CLUSTERS', clusters), ('BLOCK', 128), ('SPS', 2),
                        ('PASSES', 4), ('REPEATS', 1), ('MODEL', 'bb')):
        monkeypatch.setenv('RUNNER_' + name, str(value))
    seen = []
    run_gibbs = bench_runner.runner.run_gibbs

    def spy(spec, cl_model, shareds, values, *args, **kwargs):
        seen.append((spec, cl_model, shareds, values,
                     kwargs['initial_assignments']))
        return run_gibbs(spec, cl_model, shareds, values, *args, **kwargs)
    monkeypatch.setattr(bench_runner.runner, 'run_gibbs', spy)
    assert bench_runner.main(['--device', 'cpu']) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith('{')]
    assert len(lines) == 1
    line = lines[0]
    assert line['model'] == 'bb' and line['value'] > 0
    assert line['final_capacity'] == comps
    assert line['true_clusters'] == clusters and line['block'] == 128
    X, labels = _jax_recipe('bb', rows, comps, clusters)
    assert len(seen) == 2       # the warm-up run and one timed run
    for spec, cl_model, shareds, values, init in seen:
        assert [b.module for b in spec.blocks] == [tbb]
        assert spec.capacity == comps and spec.empties == 1
        assert cl_model.to_dict() == {'alpha': 1.0, 'd': 0.0}
        assert tbb.shared_to_dict(shareds[0]) == BB_SHARED
        (v,) = values
        assert v.dtype == torch.bool
        np.testing.assert_array_equal(v.numpy(), X)
        np.testing.assert_array_equal(np.asarray(init), labels)


def _build_framing(out_dir):
    """native/framing.cc built with g++ as the port's
    distributions_tpu_torch.io._framing, and loaded from `out_dir`."""
    name = 'distributions_tpu_torch.io._framing'
    path = os.path.join(out_dir, '_framing' +
                        sysconfig.get_config_var('EXT_SUFFIX'))
    subprocess.run(
        ['g++', '-O2', '-std=c++17', '-shared', '-fPIC',
         '-I' + sysconfig.get_paths()['include'],
         os.path.join(ROOT, 'native', 'framing.cc'), '-o', path],
        check=True, capture_output=True, timeout=120)
    loader = importlib.machinery.ExtensionFileLoader(name, path)
    spec = importlib.util.spec_from_file_location(name, path, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def test_native_framing_writes_the_python_bytes(tmp_path, monkeypatch):
    native = _build_framing(str(tmp_path))
    # stream.py takes the extension when it imports: a fresh copy of the
    # module, with the built extension standing as the port's
    monkeypatch.setitem(sys.modules, native.__name__, native)
    spec = importlib.util.spec_from_file_location('_stream_with_native',
                                                  stream.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert fresh._native is native
    assert stream._native is None      # nothing built in the package here

    rng = np.random.RandomState(0)
    items = [b'', b'\x00', b'abc' * 7] + [
        rng.randint(0, 256, n).astype(np.uint8).tobytes()
        for n in (1, 255, 256, 65537, 1 << 20)]
    files = {}
    for label, module in (('python', None), ('native', native)):
        monkeypatch.setattr(stream, '_native', module)
        path = str(tmp_path / ('%s.pbs' % label))
        stream.protobuf_stream_dump(iter(items), path)
        files[label] = open(path, 'rb').read()
        for reader in (None, native):
            monkeypatch.setattr(stream, '_native', reader)
            loaded = stream.protobuf_stream_load(path)
            assert list(loaded) == items
            loaded.close()
        # compressed names take the Python path with the extension there
        monkeypatch.setattr(stream, '_native', module)
        gz = str(tmp_path / ('%s.pbs.gz' % label))
        stream.protobuf_stream_dump(items, gz)
        assert list(stream.protobuf_stream_load(gz)) == items
    assert files['native'] == files['python']
    assert len(files['python']) == sum(4 + len(x) for x in items)


@pytest.mark.parametrize('wall', [0.01, 0.4, 2.14, 30.0])
def test_profile_window_outlasts_a_fast_device_clock(wall):
    """chip_smoke.py's profiler window stays open profile_pad(wall) seconds
    after `wall` seconds of profiled work.  torch.profiler keeps only the
    device events inside its window, and the card's timestamps may run fast
    against the host's (on an H100, a 2.14 s step read as 2.20 s of device
    time and its last 7 kernels fell after a fixed 0.1 s pad): the pad
    covers a device clock 20% fast, and never drops below the fixed pad."""
    spec = importlib.util.spec_from_file_location(
        '_chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    pad = smoke.profile_pad(wall)
    assert pad >= smoke.PROFILE_PAD_SECONDS
    assert wall * 1.2 <= wall + pad
    # the step that lost its last kernels is now inside the window
    assert 2.20 <= 2.14 + smoke.profile_pad(2.14)
