"""The port's hyperparameter moves against distributions_tpu: grid scores
(`mixture.score_data_grid`, `inference.hypers`) to f32 tolerance and the
argmax index exactly; `run_gibbs(hyper_grids=, cl_grid=)` against the JAX
runner's assignments and logged indices under 'argmax'; bitwise resume
with hyper moves on; and the repairs that came with them
(`add_repeated_value` of all seven models, the runner's sweep when the
fused gate fails, the step-edge saturation check)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu import models as jmodels_pkg  # noqa: F401
from distributions_tpu.inference import hypers as jhypers, runner as jr
from distributions_tpu_torch import clustering as tcl, config, convert
from distributions_tpu_torch import diagnostics
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.inference import hypers, runner as tr
from distributions_tpu_torch.models import MODULES
from distributions_tpu_torch.ops import gibbs

torch.set_num_threads(1)
config.set_default_device('cpu')

NAMES = ('bb', 'dd', 'dpd', 'gp', 'bnb', 'niw', 'nich')
JAX = {name: importlib.import_module('distributions_tpu.models.' + name)
       for name in NAMES}

# grid scores are sums of C * cols f32 group scores of magnitude up to
# ~1e4, summed in another order than the JAX package's vmap: rtol 1e-5 of
# the score plus atol 1e-3
RTOL, ATOL = 1e-5, 1e-3


# -- repair: add_repeated_value of all seven models ---------------------------

@pytest.mark.parametrize('name', NAMES)
def test_add_repeated_value_matches_jax(name):
    jm, tm = JAX[name], MODULES[name]
    ex = jm.EXAMPLES[0]
    kw = {'cap': 16} if name == 'dpd' else {}
    jsh = jm.shared_from_dict(ex['shared'], **kw)
    tsh = tm.shared_from_dict(ex['shared'], **kw)
    values = np.asarray(ex['values'])
    if values.dtype == np.float64:
        values = values.astype(np.float32)
    jg = jm.from_values_grouped(jsh, jnp.asarray(values[:-1]),
                                jnp.zeros(len(values) - 1, jnp.int32), 1)
    jg = jax.tree_util.tree_map(lambda a: a[0], jg)
    tg = tm.Group(*(convert.tensor(np.asarray(x)) for x in jg))
    for count in (1, 3):
        want = jm.add_repeated_value(jsh, jg, jnp.asarray(values[-1]), count)
        got = tm.add_repeated_value(tsh, tg, torch.as_tensor(values[-1]),
                                    count)
        for g, w in zip(got, want):
            assert g.dtype == convert.tensor(np.asarray(w)).dtype
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


# -- grid scores ---------------------------------------------------------------

def _both(kind, R=512, C=16, n_clusters=5, seed=0):
    """One mixed problem and its state in both packages."""
    p = testing.mixed_problem(R, C, seed=seed, kind=kind,
                              n_clusters=n_clusters)
    jmods = {n: JAX[n] for n in NAMES}
    jspec, jpy, jsh = testing.build_problem(p, jmods, jmx.make_spec,
                                            jcl.PitmanYor.from_dict)
    tspec, tpy, tsh = testing.build_problem(p, MODULES, tmx.make_spec,
                                            tcl.PitmanYor.from_dict)
    jst = jmx.state_from_assignments(
        jspec, jpy, jsh, tuple(jnp.asarray(v) for v in p['values']),
        jnp.asarray(p['labels']))
    tst = tmx.state_from_assignments(
        tspec, tpy, tsh, tuple(torch.from_numpy(v) for v in p['values']),
        torch.from_numpy(p['labels']))
    return p, (jspec, jpy, jsh, jst), (tspec, tpy, tsh, tst)


def _grid(name, G=6):
    """A grid of Shareds for one block as numpy leaves with a leading [G]
    axis, in the model's field order."""
    lin = np.logspace(-1, 1, G).astype(np.float32)
    one = np.ones(G, np.float32)
    if name == 'nich':
        return [0 * one, 0.1 * one, lin, one]
    if name == 'gp':
        return [lin, one]
    if name == 'bb':
        return [lin, lin[::-1].copy()]
    if name == 'bnb':
        return [lin, 4 * one, np.full(G, 2, np.int32)]
    if name == 'dd':
        return [np.stack([lin, one, 2 * one, lin[::-1]], 1)]
    if name == 'niw':
        d = 2
        return [np.zeros((G, d), np.float32), lin,
                np.tile(np.eye(d, dtype=np.float32), (G, 1, 1))
                * lin[:, None, None], (d + 1) * one]
    raise ValueError(name)


def _grids(name):
    leaves = _grid(name)
    return (JAX[name].Shared(*(jnp.asarray(x) for x in leaves)),
            MODULES[name].Shared(*(torch.from_numpy(x) for x in leaves)))


@pytest.mark.parametrize('kind,block_idx', [
    ('nich_gp_bb', 0), ('nich_gp_bb', 1), ('nich_gp_bb', 2), ('dd_bb', 0),
    ('bnb', 0), ('niw2', 0)])
def test_grid_step_feature_matches_jax(kind, block_idx):
    p, (jspec, _, jsh, jst), (tspec, _, tsh, tst) = _both(kind)
    name = p['blocks'][block_idx][0]
    jgrid, tgrid = _grids(name)
    _, jidx, jscores = jhypers.grid_step_feature(
        jax.random.PRNGKey(0), jspec, block_idx, jsh, jst, jgrid,
        sample=False)
    new, idx, scores = hypers.grid_step_feature(
        torch.Generator().manual_seed(0), tspec, block_idx, tsh, tst, tgrid,
        sample=False)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=RTOL, atol=ATOL)
    assert int(idx) == int(jidx)
    for got, leaf in zip(new[block_idx], tgrid):
        assert torch.equal(got, leaf[int(idx)])
    assert all(new[i] is tsh[i] for i in range(len(tsh)) if i != block_idx)
    # the broadcast over the grid axis and the loop over grid points agree
    loop = torch.stack([
        tspec.blocks[block_idx].module.score_data(
            type(tgrid)(*(leaf[g] for leaf in tgrid)),
            tst.groups[block_idx]).sum() for g in range(scores.shape[0])])
    np.testing.assert_allclose(scores.numpy(), loop.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_score_data_grid_and_log_predictive_match_jax():
    p, (jspec, jpy, jsh, jst), (tspec, tpy, tsh, tst) = _both('nich_gp_bb')
    grids = [_grids(name) for name, _, _, _ in p['blocks']]
    want = jmx.score_data_grid(jspec, jpy, tuple(g[0] for g in grids), jst)
    got = tmx.score_data_grid(tspec, tpy, tuple(g[1] for g in grids), tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    rows = slice(0, 64)
    want = jmx.log_predictive(jspec, jpy, jsh, jst,
                              tuple(jnp.asarray(v[rows]) for v in p['values']))
    got = tmx.log_predictive(
        tspec, tpy, tsh, tst,
        tuple(torch.from_numpy(v[rows]) for v in p['values']))
    # gp's score tables difference lgammas (atol 2e-3, ROADMAP Queue 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-3)


def test_grid_step_clustering_matches_jax():
    _, (_, _, _, jst), (_, _, _, tst) = _both('dd_bb')
    alphas, ds = [0.3, 1.0, 3.0, 10.0], [0.0, 0.1, 0.5]
    jgrid = jhypers.make_py_grid(alphas, ds)
    tgrid = hypers.make_py_grid(alphas, ds)
    np.testing.assert_array_equal(tgrid.alpha.numpy(), np.asarray(jgrid.alpha))
    np.testing.assert_array_equal(tgrid.d.numpy(), np.asarray(jgrid.d))
    _, jidx, jscores = jhypers.grid_step_clustering(
        jax.random.PRNGKey(0), jgrid, jst, sample=False)
    chosen, idx, scores = hypers.grid_step_clustering(
        torch.Generator().manual_seed(0), tgrid, tst, sample=False)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-5, atol=1e-4)
    assert int(idx) == int(jidx)
    assert float(chosen.alpha) == float(tgrid.alpha[idx])
    assert float(chosen.d) == float(tgrid.d[idx])
    # a grid of models scores as its points score one at a time
    one = torch.stack([tcl.score_counts(
        tcl.PitmanYor(alpha=a, d=d), tst.counts)
        for a, d in zip(tgrid.alpha, tgrid.d)])
    np.testing.assert_allclose(scores.numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-5)


def test_grid_step_samples_the_grid_posterior():
    """sample=True draws the index from softmax(scores): one generator
    state gives one draw, and the frequencies follow the posterior."""
    _, _, (_, _, _, tst) = _both('dd_bb')
    grid = hypers.make_py_grid([0.8, 1.0, 1.3, 1.7], [0.1])
    gen = torch.Generator().manual_seed(5)
    n = 600
    draws = []
    for _ in range(n):
        _, idx, scores = hypers.grid_step_clustering(gen, grid, tst)
        draws.append(int(idx))
    prob = torch.softmax(scores.double(), 0).numpy()
    freq = np.bincount(draws, minlength=4) / n
    z = (freq - prob) / np.sqrt(prob * (1 - prob) / n)
    assert np.abs(z).max() < 5.0, (freq, prob)
    a = hypers.grid_step_clustering(torch.Generator().manual_seed(9), grid,
                                    tst)[1]
    b = hypers.grid_step_clustering(torch.Generator().manual_seed(9), grid,
                                    tst)[1]
    assert int(a) == int(b)


# -- the runner ----------------------------------------------------------------

R, C, BLOCK = 2048, 128, 512
SIGMAS = np.asarray([0.01, 0.1, 1.0, 10.0], np.float32)


def _nich_run_problem():
    values, labels = testing.nich_problem(R, seed=4)
    spec = tmx.make_spec([(MODULES['nich'], 2)], capacity=C)
    py = tcl.PitmanYor.from_dict(testing.PY)
    sh = (MODULES['nich'].shared_from_dict(testing.NICH_SHARED),)
    grid = MODULES['nich'].Shared(
        mu=torch.zeros(4), kappa=torch.full((4,), 0.1),
        sigmasq=torch.from_numpy(SIGMAS), nu=torch.ones(4))
    return values, labels, spec, py, sh, grid


def test_run_gibbs_hyper_grids_argmax_matches_jax():
    values, labels, spec, py, sh, grid = _nich_run_problem()
    jnich = JAX['nich']
    jspec = jmx.make_spec([(jnich, 2)], capacity=C)
    jgrid = jnich.Shared(mu=jnp.zeros(4), kappa=jnp.full(4, 0.1),
                         sigmasq=jnp.asarray(SIGMAS), nu=jnp.ones(4))
    alphas, ds = [0.5, 1.0, 2.0], [0.0, 0.1]
    common = dict(block=BLOCK, use_pallas=True, sampling='argmax',
                  hyper_every=2, hyper_sample=False, sweeps_per_step=3)
    jst, jan, jlog = jr.run_gibbs(
        jspec, jcl.PitmanYor.from_dict(testing.PY),
        (jnich.shared_from_dict(testing.NICH_SHARED),),
        (jnp.asarray(values),), jax.random.PRNGKey(0), 5,
        initial_assignments=jnp.asarray(labels), hyper_grids={0: jgrid},
        cl_grid=jhypers.make_py_grid(alphas, ds), **common)
    st, an, log = tr.run_gibbs(
        spec, py, sh, (torch.from_numpy(values),),
        torch.Generator().manual_seed(0), 5,
        initial_assignments=torch.from_numpy(labels), hyper_grids={0: grid},
        cl_grid=hypers.make_py_grid(alphas, ds), **common)
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    # steps clamp to the hyper edges: 2, 2, 1 sweeps
    assert [r['sweep'] for r in log.rows] == [r['sweep'] for r in jlog.rows] \
        == [1, 3, 4]
    for got, want in zip(log.rows, jlog.rows):
        assert got.get('hyper_0') == want.get('hyper_0')
        assert got.get('hyper_cl') == want.get('hyper_cl')
    assert 'hyper_0' in log.rows[0] and 'hyper_0' not in log.rows[2]
    np.testing.assert_allclose(float(log.final_shareds[0].sigmasq),
                               float(jlog.final_shareds[0].sigmasq))
    np.testing.assert_allclose(float(log.final_cl_model.alpha),
                               float(jlog.final_cl_model.alpha))


@pytest.mark.parametrize('moves', ['grids', 'slices'])
@pytest.mark.parametrize('use_pallas', [False, True])
def test_resume_with_hyper_moves_is_bitwise(tmp_path, use_pallas, moves):
    values, _, spec, py, sh, grid = _nich_run_problem()
    tv = (torch.from_numpy(values[:512]),)
    if moves == 'grids':
        kw = dict(hyper_grids={0: grid},
                  cl_grid=hypers.make_py_grid([0.5, 1.0, 2.0], [0.0, 0.1]))
    else:
        kw = dict(hyper_slice={0: (('sigmasq',), 1.0)}, cl_slice=True)
    common = dict(block=128, use_pallas=use_pallas, sampling='gumbel',
                  init='random:8', hyper_every=2, checkpoint_every=2, **kw)

    def run(passes, path, seed, resume):
        return tr.run_gibbs(spec, py, sh, tv,
                            torch.Generator().manual_seed(seed), passes,
                            checkpoint_path=str(tmp_path / path),
                            resume=resume, **common)
    st_a, an_a, log_a = run(6, 'full.ckpt', 3, False)
    run(2, 'crash.ckpt', 3, False)
    st_b, an_b, log_b = run(6, 'crash.ckpt', 999, True)
    assert torch.equal(an_a, an_b) and torch.equal(st_a.counts, st_b.counts)
    assert all(torch.equal(x, y)
               for x, y in zip(st_a.groups[0], st_b.groups[0]))
    assert all(torch.equal(x, y) for x, y in zip(log_a.final_shareds[0],
                                                 log_b.final_shareds[0]))
    assert torch.equal(log_a.final_cl_model.alpha, log_b.final_cl_model.alpha)
    def chain_rows(log):
        return [{k: v for k, v in r.items()
                 if k not in diagnostics.CLOCK_KEYS} for r in log.rows]
    assert chain_rows(log_a) == chain_rows(log_b)
    key = 'hyper_0' if moves == 'grids' else 'hyper_slice_0'
    assert [r['sweep'] for r in log_b.rows if key in r] == [1, 3, 5]
    # the moves did move the hyperparameters
    assert float(log_a.final_shareds[0].sigmasq) != testing.NICH_SHARED[
        'sigmasq']


def test_run_gibbs_slice_moves_log_and_move():
    values, _, spec, py, sh, _ = _nich_run_problem()
    _, _, log = tr.run_gibbs(
        spec, py, sh, (torch.from_numpy(values[:256]),),
        torch.Generator().manual_seed(0), 4, block=64, init='random:4',
        hyper_every=2, cl_slice={'n_steps': 1},
        hyper_slice={0: {'params': ('sigmasq', 'kappa'), 'width': 1.0,
                         'bounds': {'kappa': (-5.0, 5.0)}}})
    assert 'hyper_cl_alpha' in log.rows[1] and 'hyper_cl_d' in log.rows[1]
    assert log.rows[1]['hyper_slice_0'] == 1 and 'hyper_slice_0' not in \
        log.rows[0]
    assert float(log.final_cl_model.alpha) != testing.PY['alpha']
    assert float(log.final_shareds[0].sigmasq) != 1.0
    assert np.exp(-5.0) - 1e-6 <= float(log.final_shareds[0].kappa) \
        <= np.exp(5.0) + 1e-3
    assert np.isfinite(log.rows[-1]['score_data'])


def test_hyper_every_zero_raises():
    """The JAX runner divides by zero here; the port refuses at once."""
    values, _, spec, py, sh, grid = _nich_run_problem()
    with pytest.raises(ValueError, match='hyper_every'):
        tr.run_gibbs(spec, py, sh, (torch.from_numpy(values),),
                     torch.Generator(), 2, block=BLOCK,
                     hyper_grids={0: grid}, hyper_every=0)
    # without hyper moves the value is not read
    tr.run_gibbs(spec, py, sh, (torch.from_numpy(values[:512]),),
                 torch.Generator(), 1, block=512, hyper_every=0,
                 init='random:4')


def test_step_edge_without_free_slot_raises():
    """Growth is checked between steps only: a step that ends with every
    slot taken raises, where the JAX runner would go on in silence."""
    values, _ = testing.nich_problem(512, seed=2, n_clusters=12)
    spec = tmx.make_spec([(MODULES['nich'], 2)], capacity=4)
    py = tcl.PitmanYor.from_dict({'alpha': 5.0, 'd': 0.1})
    sh = (MODULES['nich'].shared_from_dict(testing.NICH_SHARED),)
    with pytest.raises(RuntimeError, match='no free slot'):
        tr.run_gibbs(spec, py, sh, (torch.from_numpy(values),),
                     torch.Generator().manual_seed(0), 10, block=32,
                     initial_assignments=np.zeros(512, np.int32),
                     grow_headroom=0.0, sweeps_per_step=10)


@pytest.mark.parametrize('kind,sweep', [
    ('nich', 'sweep_blocked_pallas'),
    ('nich_gp_bb', 'sweep_blocked_pallas_mixed'),
    ('niw3_nich_bb', 'sweep_blocked'), ('plain', 'sweep_blocked')])
def test_use_pallas_failed_gate_takes_v1_sweeps(monkeypatch, kind, sweep):
    """use_pallas=True with a failed fused gate: K4's sweep for a nich-only
    spec (as the JAX runner), K5's for a spec without niw blocks, else the
    plain sweep; without use_pallas always the plain sweep.  The runner
    calls the sweeps' runs, which take a step's sweeps in one call
    (`gibbs._v1_run` with K4 or K5, `gibbs._plain_run`): one call a step
    of one sweep here."""
    use_pallas = kind != 'plain'
    if kind in ('nich', 'plain'):
        values, _, spec, py, sh, _ = _nich_run_problem()
        tv = (torch.from_numpy(values[:256]),)
    else:
        p = testing.mixed_problem(256, 16, seed=1, kind=kind)
        spec, py, sh = testing.build_problem(p, MODULES, tmx.make_spec,
                                             tcl.PitmanYor.from_dict)
        tv = tuple(torch.from_numpy(v) for v in p['values'])
    monkeypatch.setattr(tr.fk, 'supports_mixed_pallas', lambda spec: False)
    calls = []
    # the public sweep each run serves
    served = {'_plain_run': lambda a: 'sweep_blocked',
              '_v1_run': lambda a: {'K4': 'sweep_blocked_pallas',
                                    'K5': 'sweep_blocked_pallas_mixed'}[a[3]],
              'sweep_blocked_pallas_fused_mixed':
                  lambda a: 'sweep_blocked_pallas_fused_mixed'}
    for name, sweep_of in served.items():
        def counted(*a, _fn=getattr(gibbs, name), _of=sweep_of, **kw):
            calls.append(_of(a))
            return _fn(*a, **kw)
        monkeypatch.setattr(gibbs, name, counted)
    st, an, _ = tr.run_gibbs(spec, py, sh, tv,
                             torch.Generator().manual_seed(0), 2, block=64,
                             use_pallas=use_pallas, init='random:4')
    assert calls == [sweep, sweep]
    np.testing.assert_array_equal(
        np.bincount(an.numpy(), minlength=st.counts.shape[0]),
        st.counts.numpy())
