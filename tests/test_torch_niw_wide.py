"""Kernel K2 on niw columns past d = 4 (csrc/fused_split.cuh's niw16 shape
and the wide shape of d <= 16; the CUDA kernels themselves are held to
the twin on the card by tests/test_torch_cuda.py), on the CPU, where the
port runs K2's plain twin:

- the twin against the JAX package's fused kernel (`_fused_v3_kernel` in
  Pallas interpret mode) at d = 5 and 16, on the same operands;
- the port's `run_gibbs(use_pallas=True)` at d = 16 against the
  benchmark's plain reference (gibbsbench/reference.py and
  gibbsbench/models/niw.py, float64): counts, statistics, the logged joint
  score and the twin's per-slot scores, each tolerance with its reason,
  and the reference in bfloat16 beside it, which fails them;
- the caps that still raise: d = 17, more than 16 niw values."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.ops import gibbs as jg, pallas_kernels as pk
from distributions_tpu_torch import clustering as tcl, config, convert
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.inference import runner
from distributions_tpu_torch.models import MODULES
from distributions_tpu_torch.ops import fused_kernels as fk, gibbs as tg
from gibbsbench import reference
from gibbsbench.models import niw as ref_niw

torch.set_num_threads(1)
config.set_default_device('cpu')

R, C, BLOCK_ROWS = 256, 128, 128
# stat sums: f32 sums of the same rows in another order, as
# tests/test_torch_stat_sums.py holds them
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3
JAX_MODELS = {name: importlib.import_module('distributions_tpu.models.'
                                            + name) for name in MODULES}


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _operands(kind):
    """The JAX package's kernel operands of a seeded problem, and the
    port's layout of the same rows."""
    p = testing.mixed_problem(R, C, seed=1, kind=kind, n_clusters=5)
    jspec, jpy, jsh = testing.build_problem(
        p, JAX_MODELS, jmx.make_spec, jcl.PitmanYor.from_dict)
    jv = tuple(jnp.asarray(v) for v in p['values'])
    jst = jmx.state_from_assignments(jspec, jpy, jsh, jv,
                                     jnp.asarray(p['labels']))
    jlay = jg._mixed_static_layout(jspec, jv, None)
    _, jqco, _ = jg._build_fused_inputs(
        jspec, jlay.nich_blocks, jlay.quad_blocks, jlay.table_blocks,
        jlay.V, jsh, jlay.supports_dev, jst)
    jcls = jcl.score_value(jpy, jst.counts, jst.alive, jst.sample_size)
    spec = convert.spec(jspec)
    lay = tg._mixed_static_layout(spec, tuple(torch.from_numpy(v)
                                              for v in p['values']))
    st = convert.state(jspec, _np(jst))
    sh = convert.shareds(jspec, _np(jsh))
    return jlay, jqco, jcls, lay, spec, sh, st


@pytest.mark.parametrize('d', [5, 16])
@pytest.mark.parametrize('sampling', ['argmax', 'gumbel_host'])
def test_twin_matches_jax_kernel(d, sampling):
    """Draws bitwise (both compute the centred form in one order); the
    quad sums within the stat tolerance; the port's own coefficient rows
    within the f32 rounding of two 16 x 16 inverses and logdets."""
    jlay, jqco, jcls, lay, spec, sh, st = _operands('niw%d' % d)
    assert lay.quad_groups == ((1, d),)
    noise = None
    if sampling == 'gumbel_host':
        noise = np.random.RandomState(1).gumbel(size=(R, C)).astype(
            np.float32)
    ja, _, _, jqsums = pk.fused_mixed_score_sample_stats(
        0, jlay.nich_vals, jlay.table_idx, jcls, None, None, (),
        block_rows=BLOCK_ROWS, interpret=True, sampling=sampling,
        qvalues=jlay.quad_vals, qcoeffs=jqco, quad_groups=jlay.quad_groups,
        noise=None if noise is None else jnp.asarray(noise))
    ta, sums, tcounts, qsums = fk.fused_mixed_score_sample_stats(
        0, None, None, torch.from_numpy(np.asarray(jcls)), None, None, (),
        sampling=sampling, qvalues=lay.quad_vals,
        qcoeffs=torch.from_numpy(np.array(jqco)),
        quad_groups=lay.quad_groups,
        noise=None if noise is None else torch.from_numpy(noise))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert sums.shape == tcounts.shape == (C, 0)
    assert qsums.shape == (C, 1 + d + d * (d + 1) // 2)
    np.testing.assert_allclose(qsums.numpy(), np.asarray(jqsums),
                               rtol=SUM_RTOL, atol=SUM_ATOL)
    # the port's coefficient rows of the same state: f32 formulas over a
    # torch.linalg inverse and logdet where XLA runs its own; the entries
    # (|x| up to ~40) agree within 1.2e-5, a few dozen f32 ulps of the
    # largest (limit 2e-6 of it, ~8e-5)
    qco = tg._build_fused_inputs(spec, lay, sh, st)[1]
    np.testing.assert_allclose(qco.numpy(), np.asarray(jqco), rtol=1e-5,
                               atol=2e-6 * float(np.abs(jqco).max()))


# -- run_gibbs at d = 16 against the benchmark's plain reference -------------

D, ROWS, SLOTS, TILE, CLUSTERS, SWEEPS = 16, 2048, 64, 512, 12, 4


def _config():
    """The benchmark's configuration form of the run's model."""
    return {'prior': {'model': 'pitman_yor', 'alpha': 1.0, 'd': 0.1},
            'blocks': [{'model': 'niw', 'cols': 1,
                        'shared': {'mu': [0.0] * D, 'kappa': 0.1,
                                   'psi': (0.01 * np.eye(D)).tolist(),
                                   'nu': D + 2.0}}]}


@functools.lru_cache(maxsize=None)
def _chain():
    """run_gibbs(use_pallas=True) on seeded rows of 12 overlapping 16-D
    clusters: (the rows, the final state and assignments, its log)."""
    rng = np.random.RandomState(7)
    labels = rng.randint(0, CLUSTERS, ROWS)
    centers = 0.2 * rng.randn(CLUSTERS, D)
    v = (centers[labels] + 0.1 * rng.randn(ROWS, D))[:, None, :]
    values = torch.from_numpy(v.astype(np.float32))
    cfg = _config()
    spec = tmx.make_spec([(MODULES['niw'], 1)], capacity=SLOTS)
    py = tcl.PitmanYor.from_dict(cfg['prior'])
    sh = (MODULES['niw'].shared_from_dict(cfg['blocks'][0]['shared']),)
    state, assign, log = runner.run_gibbs(
        spec, py, sh, (values,), torch.Generator().manual_seed(3), SWEEPS,
        block=TILE, use_pallas=True, grow_headroom=0.0, sampling='gumbel',
        sweeps_per_step=2, initial_assignments=torch.from_numpy(
            labels.astype(np.int32)), device='cpu')
    return cfg, values, spec, py, sh, state, assign.long(), log


def test_run_gibbs_counts_and_stats_match_the_reference():
    """Counts exactly; the f32 sums [v] and [v v^T] within the rounding of
    the run's updates (an unmerge and a merge a tile and sweep, each
    within 2^-24 of the largest magnitude, as the benchmark's stats_gap);
    the same sums in bfloat16 (8 bits) miss that by far."""
    cfg, values, spec, py, sh, state, assign, _ = _chain()
    ref = reference.stats(cfg, (values,), assign, SLOTS)
    assert torch.equal(state.counts.long(), ref['counts'].long())
    g = state.groups[0]
    limit = 2 * (ROWS // TILE) * SWEEPS * 2.0 ** -24
    low = reference.stats(cfg, (values,), assign, SLOTS, torch.bfloat16)
    for name in ref_niw.FLOAT_LEAVES:
        want = ref['blocks'][0][name]
        scale = float(want.abs().max())
        gap = float((getattr(g, name).double() - want).abs().max()) / scale
        assert gap <= limit, (name, gap, limit)
        bf = low['blocks'][0][name].double()
        assert float((bf - want).abs().max()) / scale > 10 * limit


def test_run_gibbs_logged_score_matches_the_reference():
    """The joint score the runner logged for its last step against the
    reference's float64 joint score of the final assignments: relative
    3e-6 (measured ~1e-8), room for the f32 rounding of the slots' terms,
    sums of lgammas and logdets larger than the total, whose cancellation
    the f32 score carries; the reference in bfloat16 misses it by far
    (~1.5e-2)."""
    cfg, values, spec, py, sh, state, assign, log = _chain()
    want = float(reference.joint_score(
        cfg, reference.stats(cfg, (values,), assign, SLOTS)))
    got = float(log.rows[-1]['score_data'])
    assert abs(got - want) / abs(want) <= 3e-6, (got, want)
    low = float(reference.joint_score(
        cfg, reference.stats(cfg, (values,), assign, SLOTS, torch.bfloat16)))
    assert abs(low - want) / abs(want) > 100 * 3e-6


def test_twin_scores_match_the_reference_predictive():
    """The twin's per-slot scores of 256 rows against the final state
    (K2's order: the prior's score, the base, lc * log(1 + q)) give each
    row's law over the occupied slots: each log-probability above -30
    within 2e-5 (1 + |log p|) of the reference's float64 predictive (f32
    scores carry a relative rounding of a few 1e-6 of each score
    difference, through f32 inverses of the 16 x 16 scale matrices:
    measured 6.4e-6); the reference in bfloat16 misses that by far
    (~0.5)."""
    cfg, values, spec, py, sh, state, assign, _ = _chain()
    rows = values[:256]
    lay = tg._mixed_static_layout(spec, (rows,))
    cl_scores, _, qco, _ = tg._fused_tile_inputs(spec, lay, py, sh, state)
    scores = fk._score_mixed(256, None, None, cl_scores, None, None, (),
                             lay.quad_vals, qco, lay.quad_groups, (),
                             torch.log)
    occ = torch.nonzero(state.counts > 0).flatten()
    got = torch.log_softmax(scores[:, occ].double(), dim=1)

    def law(dtype):
        st = reference.stats(cfg, (values,), assign, SLOTS, dtype)
        block = cfg['blocks'][0]
        sel = {k: v[occ] for k, v in st['blocks'][0].items()}
        lp = (torch.log(st['counts'][occ] - 0.1)[None]
              + ref_niw.predictive(block, ref_niw.shared(
                  block, dtype, torch.device('cpu')), st['counts'][occ], sel,
                  rows))
        return torch.log_softmax(lp.double(), dim=1)
    want = law(torch.float64)
    # slots of probability below e^-30 hold no mass that a draw can see
    live = want > -30

    def gap(lp):
        return float(((lp - want).abs() / (1 + want.abs()))[live].max())
    assert gap(got) <= 2e-5
    assert gap(law(torch.bfloat16)) > 100 * 2e-5


# -- the caps -----------------------------------------------------------------

@pytest.mark.parametrize('quad_groups,ok', [
    (((1, 16),), True), (((2, 8),), True), (((1, 5), (1, 11)), True),
    (((1, 17),), False), (((2, 9),), False), (((1, 4), (1, 13)), False)])
def test_k2_caps(quad_groups, ok):
    """K2 and K3 check their operands (`_check_mixed`, before any launch)
    against the kernels' caps: a niw column of d <= MAX_D = 16 and at most
    MAX_QVALS = 16 niw values in all."""
    qvals = sum(nc * d for nc, d in quad_groups)
    rows = sum(2 + nc * (d + d * (d + 1) // 2) for nc, d in quad_groups)
    args = (None, None, torch.zeros(8), None, None, (),
            torch.zeros((4, qvals)), torch.zeros((rows, 8)), quad_groups, ())
    if ok:
        fk._check_mixed(*args)
    else:
        with pytest.raises(ValueError):
            fk._check_mixed(*args)
