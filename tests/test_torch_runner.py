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
    {'checkpoint_path': 'ckpt.npz'}, {'mesh': object()},
    {'hyper_grids': {0: None}}, {'cl_grid': object()},
    {'hyper_slice': {0: (('mu',), 1.0)}}, {'cl_slice': True},
    {'init': 'prior'}, {'init': 'sequential'}])
def test_run_gibbs_options_not_ported(option):
    values, _ = testing.nich_problem(256, seed=6)
    spec, py, sh, tv = _port_problem(values)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tr.run_gibbs(spec, py, sh, tv, torch.Generator(), 1, block=256,
                     **option)


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
