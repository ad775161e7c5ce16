"""The port's run_gibbs against distributions_tpu.inference.runner on the
fused path under 'argmax' sampling, where both runners must give the
same chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.inference import runner as jr
from distributions_tpu.models import nich as jnich
from distributions_tpu_torch import clustering as tcl, config
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.inference import runner as tr
from distributions_tpu_torch.models import nich as tnich

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C, BLOCK = 2048, 128, 512


def _port_problem(values):
    spec = tmx.make_spec([(tnich, 2)], capacity=C)
    py = tcl.PitmanYor.from_dict(testing.PY)
    sh = (tnich.shared_from_dict(testing.NICH_SHARED),)
    return spec, py, sh, (torch.from_numpy(values),)


@pytest.mark.parametrize('sweeps_per_step,headroom', [(1, 0.125), (3, 0.125),
                                                      (1, 0.95)])
def test_run_gibbs_fused_argmax_matches_jax(sweeps_per_step, headroom):
    values, labels = testing.nich_problem(R, seed=4)
    jspec = jmx.make_spec([(jnich, 2)], capacity=C)
    jpy = jcl.PitmanYor.from_dict(testing.PY)
    jsh = (jnich.shared_from_dict(testing.NICH_SHARED),)
    common = dict(block=BLOCK, use_pallas=True, sampling='argmax',
                  sweeps_per_step=sweeps_per_step, grow_headroom=headroom)
    jst, jan, jlog = jr.run_gibbs(
        jspec, jpy, jsh, (jnp.asarray(values),), jax.random.PRNGKey(0), 3,
        initial_assignments=jnp.asarray(labels), **common)
    spec, py, sh, tv = _port_problem(values)
    st, an, log = tr.run_gibbs(
        spec, py, sh, tv, torch.Generator().manual_seed(0), 3,
        initial_assignments=torch.from_numpy(labels), **common)

    assert an.dtype == torch.int32
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    # headroom 0.95 doubles the capacity on both sides
    assert st.counts.shape[0] == jst.counts.shape[0]
    assert len(log.rows) == len(jlog.rows)
    for got, want in zip(log.rows, jlog.rows):
        assert got['sweep'] == want['sweep']
        assert got['sample_size'] == want['sample_size']
        assert got['nonempty_groups'] == want['nonempty_groups']
        assert got.get('sweeps') == want.get('sweeps')
        # a sum of C*cols f32 terms in another order, over states built by
        # different f32 merge histories
        assert abs(got['score_data'] - want['score_data']) \
            <= 1e-4 * abs(want['score_data'])


def test_run_gibbs_random_init_and_plain_path():
    values, _ = testing.nich_problem(R, seed=5)
    spec, py, sh, tv = _port_problem(values)
    st, an, log = tr.run_gibbs(spec, py, sh, tv,
                               torch.Generator().manual_seed(1), 2,
                               block=BLOCK, init='random:16')
    np.testing.assert_array_equal(np.bincount(an.numpy(), minlength=C),
                                  st.counts.numpy())
    assert [r['sweep'] for r in log.rows] == [0, 1]
    assert np.isfinite(log.rows[-1]['score_data'])


@pytest.mark.parametrize('option', [
    {'checkpoint_path': 'ckpt', 'checkpoint_format': 'orbax'}])
def test_run_gibbs_options_not_ported(option):
    values, _ = testing.nich_problem(256, seed=6)
    spec, py, sh, tv = _port_problem(values)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tr.run_gibbs(spec, py, sh, tv, torch.Generator(), 1, block=256,
                     **option)


def test_run_gibbs_rejects_unknown_init_and_format():
    values, _ = testing.nich_problem(256, seed=6)
    spec, py, sh, tv = _port_problem(values)
    with pytest.raises(ValueError, match='init must be'):
        tr.run_gibbs(spec, py, sh, tv, torch.Generator(), 1, block=256,
                     init='greedy')
    with pytest.raises(ValueError, match='checkpoint_format'):
        tr.run_gibbs(spec, py, sh, tv, torch.Generator(), 1, block=256,
                     checkpoint_format='zip')


# -- init, checkpoint and resume ----------------------------------------------

def _small():
    values, _ = testing.nich_problem(64, seed=12, n_clusters=2)
    spec = tmx.make_spec([(tnich, 2)], capacity=16)
    py = tcl.PitmanYor.from_dict(testing.PY)
    sh = (tnich.shared_from_dict(testing.NICH_SHARED),)
    return spec, py, sh, (torch.from_numpy(values),)


@pytest.mark.parametrize('init', [None, 'prior', 'sequential'])
def test_run_gibbs_default_and_sequential_init(init):
    """The default init is 'prior'; both row-by-row inits give a
    consistent chain, and one generator seed gives one chain."""
    spec, py, sh, tv = _small()
    kwargs = {} if init is None else {'init': init}
    runs = [tr.run_gibbs(spec, py, sh, tv, torch.Generator().manual_seed(4),
                         3, block=16, **kwargs) for _ in range(2)]
    (st, an, log), (_, an2, _) = runs
    assert torch.equal(an, an2) and an.dtype == torch.int32
    np.testing.assert_array_equal(np.bincount(an.numpy(), minlength=16),
                                  st.counts.numpy())
    assert [r['sweep'] for r in log.rows] == [0, 1, 2]
    if init is None:
        _, an3, _ = tr.run_gibbs(spec, py, sh, tv,
                                 torch.Generator().manual_seed(4), 3,
                                 block=16, init='prior')
        assert torch.equal(an, an3)


@pytest.mark.parametrize('use_pallas', [False, True])
def test_resume_continues_exactly(tmp_path, use_pallas):
    """Kill and restart: 2 sweeps, a checkpoint, and a resume to 5 equal
    an uninterrupted 5-sweep run bitwise: the same stream of sweep seeds,
    the same sweep numbering, the same logger history
    (tests/test_runner.py's test of the same name).  On the fused path
    both runs checkpoint every 2 sweeps, since a checkpoint boundary is
    where the stat cache is rebuilt."""
    spec, py, sh, tv = _small()
    common = dict(block=16, use_pallas=use_pallas, sampling='gumbel')
    every = 2 if use_pallas else 100
    full = {'checkpoint_path': str(tmp_path / 'full.ckpt'),
            'checkpoint_every': every} if use_pallas else {}
    st_a, an_a, log_a = tr.run_gibbs(
        spec, py, sh, tv, torch.Generator().manual_seed(3), 5, resume=False,
        **common, **full)
    ckpt = str(tmp_path / 'crash.ckpt')
    tr.run_gibbs(spec, py, sh, tv, torch.Generator().manual_seed(3), 2,
                 checkpoint_path=ckpt, checkpoint_every=every, resume=False,
                 **common)
    st_b, an_b, log_b = tr.run_gibbs(
        spec, py, sh, tv, torch.Generator().manual_seed(999),   # replaced
        5, checkpoint_path=ckpt, checkpoint_every=every, resume=True,
        **common)
    assert torch.equal(an_a, an_b)
    assert torch.equal(st_a.counts, st_b.counts)
    assert torch.equal(st_a.groups[0].mean, st_b.groups[0].mean)
    assert [r['sweep'] for r in log_b.rows] == [0, 1, 2, 3, 4]
    assert [r['sweep'] for r in log_a.rows] == [0, 1, 2, 3, 4]
    assert log_b.rows[-1]['score_data'] == log_a.rows[-1]['score_data']


def test_resume_noop_when_done(tmp_path):
    """Resuming a finished run does zero additional sweeps."""
    spec, py, sh, tv = _small()
    ckpt = str(tmp_path / 'done.ckpt')
    _, an1, _ = tr.run_gibbs(spec, py, sh, tv,
                             torch.Generator().manual_seed(0), 3, block=16,
                             checkpoint_path=ckpt, resume=False)
    _, an2, log2 = tr.run_gibbs(spec, py, sh, tv,
                                torch.Generator().manual_seed(1), 3,
                                block=16, checkpoint_path=ckpt, resume=True)
    assert torch.equal(an1, an2)
    assert [r['sweep'] for r in log2.rows] == [0, 1, 2]
    # resume=False starts over and overwrites
    _, an3, log3 = tr.run_gibbs(spec, py, sh, tv,
                                torch.Generator().manual_seed(1), 2,
                                block=16, checkpoint_path=ckpt, resume=False)
    assert [r['sweep'] for r in log3.rows] == [0, 1]


@pytest.mark.parametrize('use_pallas', [False, True])
def test_runner_sweeps_per_step_resume_bitwise(tmp_path, use_pallas):
    """A run of multi-sweep steps interrupted at a checkpoint boundary and
    resumed equals the uninterrupted run bitwise: steps clamp to
    checkpoint_every boundaries, so the step grid re-aligns."""
    spec, py, sh, tv = _small()
    common = dict(block=16, checkpoint_every=3, sweeps_per_step=4,
                  use_pallas=use_pallas, sampling='gumbel')
    st_a, an_a, log_a = tr.run_gibbs(
        spec, py, sh, tv, torch.Generator().manual_seed(7), 6, resume=False,
        checkpoint_path=str(tmp_path / 'full.ckpt'), **common)
    # steps of 4 are clamped to the boundary at 3
    assert [r['sweep'] for r in log_a.rows] == [2, 5]
    assert [r['sweeps'] for r in log_a.rows] == [3, 3]
    ckpt = str(tmp_path / 'spstep.ckpt')
    tr.run_gibbs(spec, py, sh, tv, torch.Generator().manual_seed(7), 3,
                 checkpoint_path=ckpt, resume=False, **common)
    st_b, an_b, log_b = tr.run_gibbs(
        spec, py, sh, tv, torch.Generator().manual_seed(999), 6,
        checkpoint_path=ckpt, resume=True, **common)
    assert torch.equal(an_a, an_b)
    assert torch.equal(st_a.counts, st_b.counts)
    assert [r['sweep'] for r in log_b.rows] == [2, 5]
    assert log_b.rows[-1]['score_data'] == log_a.rows[-1]['score_data']


def test_checkpoint_every_zero_writes_only_the_final_checkpoint(
        tmp_path, monkeypatch):
    """checkpoint_every=0 means no intermediate checkpoint (the JAX runner
    treats 0 as off when it clamps its steps, then divides by it)."""
    from distributions_tpu_torch.io import checkpoint as tckpt
    spec, py, sh, tv = _small()
    saves = []
    real = tckpt.save
    monkeypatch.setattr(
        tckpt, 'save',
        lambda path, *a, **kw: (saves.append(kw['sweep']),
                                real(path, *a, **kw))[1])
    ckpt = str(tmp_path / 'zero.ckpt')
    _, an, _ = tr.run_gibbs(spec, py, sh, tv,
                            torch.Generator().manual_seed(0), 4, block=16,
                            checkpoint_path=ckpt, checkpoint_every=0,
                            sweeps_per_step=3)
    assert saves == [4]
    _, an_l, _, sweep, rows = tckpt.load_extended(ckpt, spec, sh)
    assert sweep == 4 and torch.equal(an, an_l)
    assert [r['sweep'] for r in rows] == [2, 3]
    del saves[:]
    tr.run_gibbs(spec, py, sh, tv, torch.Generator().manual_seed(0), 5,
                 block=16, checkpoint_path=str(tmp_path / 'two.ckpt'),
                 checkpoint_every=2, resume=False)
    assert saves == [2, 4, 5]


def test_resume_adopts_a_grown_capacity_and_saved_hypers(tmp_path):
    """A checkpoint written after capacity growth resumes at the grown
    capacity, and the shareds and clustering model it holds replace the
    caller's."""
    values, _ = testing.nich_problem(64, seed=2)
    spec = tmx.make_spec([(tnich, 2)], capacity=4)
    py = tcl.PitmanYor.from_dict({'alpha': 20.0, 'd': 0.1})
    sh = (tnich.shared_from_dict(dict(testing.NICH_SHARED, sigmasq=0.01)),)
    tv = (torch.from_numpy(5 * values),)
    ckpt = str(tmp_path / 'grown.ckpt')
    st, an, _ = tr.run_gibbs(spec, py, sh, tv,
                             torch.Generator().manual_seed(1), 3, block=16,
                             checkpoint_path=ckpt)
    assert st.counts.shape[0] >= 8
    other_py = tcl.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    st2, an2, log2 = tr.run_gibbs(spec, other_py, sh, tv,
                                  torch.Generator().manual_seed(1), 4,
                                  block=16, checkpoint_path=ckpt)
    assert st2.counts.shape[0] >= st.counts.shape[0]
    assert [r['sweep'] for r in log2.rows] == [0, 1, 2, 3]
    assert log2.final_cl_model.to_dict() == py.to_dict()
    assert int(st2.sample_size) == 64


# -- mixed specs (kernel K2's path) -----------------------------------------

@pytest.mark.parametrize('kind', ['nich_gp_bb', 'niw3_nich_bb'])
def test_run_gibbs_mixed_fused_argmax_matches_jax(kind):
    """A spec with table and niw blocks takes the fused path in both
    runners (the JAX gate needs capacity % 128 == 0 and block % 512 == 0)
    and gives the same chain under 'argmax'."""
    import importlib
    from distributions_tpu_torch.models import MODULES
    from distributions_tpu_torch.ops import fused_kernels as fk
    p = testing.mixed_problem(1024, C, seed=7, kind=kind)
    jmodels = {name: importlib.import_module('distributions_tpu.models.'
                                             + name) for name in MODULES}
    jspec, jpy, jsh = testing.build_problem(p, jmodels, jmx.make_spec,
                                            jcl.PitmanYor.from_dict)
    common = dict(block=BLOCK, use_pallas=True, sampling='argmax',
                  sweeps_per_step=3)
    jst, jan, jlog = jr.run_gibbs(
        jspec, jpy, jsh, tuple(jnp.asarray(v) for v in p['values']),
        jax.random.PRNGKey(0), 3, initial_assignments=jnp.asarray(p['labels']),
        **common)
    spec, py, sh = testing.build_problem(p, MODULES, tmx.make_spec,
                                         tcl.PitmanYor.from_dict)
    assert fk.supports_mixed_pallas(spec) and not fk.supports_pallas(spec)
    # numpy rows and labels, as the JAX runner accepts them
    st, an, log = tr.run_gibbs(spec, py, sh, p['values'],
                               torch.Generator().manual_seed(0), 3,
                               initial_assignments=p['labels'], **common)
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    assert len(log.rows) == len(jlog.rows) == 1
    assert log.rows[0]['sweeps'] == 3
    assert abs(log.rows[0]['score_data'] - jlog.rows[0]['score_data']) \
        <= 1e-4 * abs(jlog.rows[0]['score_data'])


@pytest.mark.parametrize('use_pallas', [False, True])
def test_run_gibbs_mixed_any_block_and_capacity(use_pallas):
    """The plain sweep and the fused sweep of a mixed spec at a block and
    a capacity that are no multiples of 128 (the port's gate drops the
    JAX runner's TPU-only conditions)."""
    from distributions_tpu_torch.models import MODULES
    p = testing.mixed_problem(1000, 100, seed=8, kind='dpd_nich')
    spec, py, sh = testing.build_problem(p, MODULES, tmx.make_spec,
                                         tcl.PitmanYor.from_dict)
    st, an, log = tr.run_gibbs(spec, py, sh, p['values'],
                               torch.Generator().manual_seed(1), 2, block=250,
                               use_pallas=use_pallas, sampling='gumbel',
                               initial_assignments=p['labels'])
    np.testing.assert_array_equal(np.bincount(an.numpy(), minlength=100),
                                  st.counts.numpy())
    fresh = float(tmx.score_data(spec, py, sh, tmx.state_from_assignments(
        spec, py, sh, tuple(torch.from_numpy(v) for v in p['values']), an)))
    assert abs(log.rows[-1]['score_data'] - fresh) <= 1e-4 * abs(fresh)


# -- where the chain runs ---------------------------------------------------

def test_default_device_is_the_card():
    """With no device named, the factories and run_gibbs resolve to the
    CUDA device and never silently to the CPU: on a machine without a card
    they raise PyTorch's own error."""
    config.set_default_device(None)
    try:
        assert config.default_device() == torch.device('cuda')
        assert config.resolve_device(None).type == 'cuda'
        assert config.resolve_device('cpu').type == 'cpu'
        if torch.cuda.is_available():
            assert tnich.shared_from_dict(
                testing.NICH_SHARED).mu.device.type == 'cuda'
        else:
            for factory in (
                    lambda: tnich.shared_from_dict(testing.NICH_SHARED),
                    lambda: tcl.PitmanYor.from_dict(testing.PY),
                    lambda: tmx.init(tmx.make_spec([], capacity=4), ()),
                    lambda: tr.run_gibbs(
                        tmx.make_spec([(tnich, 2)], capacity=C), testing.PY,
                        (testing.NICH_SHARED,),
                        (testing.nich_problem(256)[0],), torch.Generator(),
                        1, block=256, init='random:4')):
                with pytest.raises((RuntimeError, AssertionError)):
                    factory()
        # an explicit device still wins
        assert tnich.shared_from_dict(testing.NICH_SHARED,
                                      device='cpu').mu.device.type == 'cpu'
    finally:
        config.set_default_device('cpu')
    assert tnich.shared_from_dict(testing.NICH_SHARED).mu.device.type == 'cpu'


def test_run_gibbs_places_numpy_dicts_and_rejects_mixed_devices():
    values, labels = testing.nich_problem(512, seed=9)
    spec = tmx.make_spec([(tnich, 2)], capacity=C)
    common = dict(block=256, use_pallas=True, sampling='argmax')
    # numpy rows and labels, dict shareds and clustering model: all go to
    # the device asked for, and give the chain the tensors give
    st, an, _ = tr.run_gibbs(spec, testing.PY, (testing.NICH_SHARED,),
                             (values,), torch.Generator().manual_seed(0), 2,
                             initial_assignments=labels, device='cpu',
                             **common)
    _, py, sh, tv = _port_problem(values)
    st2, an2, _ = tr.run_gibbs(spec, py, sh, tv,
                               torch.Generator().manual_seed(0), 2,
                               initial_assignments=torch.from_numpy(labels),
                               **common)
    assert an.device.type == 'cpu' and torch.equal(an, an2)
    assert torch.equal(st.counts, st2.counts)
    with pytest.raises(ValueError, match='several devices'):
        tr.run_gibbs(spec, py, sh, (torch.empty((512, 2), device='meta'),),
                     torch.Generator(), 1, **common)
    with pytest.raises(ValueError, match='device=meta'):
        tr.run_gibbs(spec, py, sh, tv, torch.Generator(), 1, device='meta',
                     **common)
