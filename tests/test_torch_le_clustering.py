"""The port's clustering priors beyond Pitman-Yor's `score_value` /
`score_counts`: the LowEntropy scorers, the Pitman-Yor add / remove
scorers and the assignment samplers, against distributions_tpu.clustering
on the same numpy inputs, against the reference's golden fixtures
(tests/golden/, as tests/test_golden.py reads them), and by goodness of
fit in the manner of tests/test_clustering.py.  Then the LowEntropy prior
on the port's main path: the fused mixed sweep in 'argmax' against the JAX
function, `prior_init`, and a bitwise `run_gibbs` resume."""

import functools
import importlib
import json
import math
import os
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx, util
from distributions_tpu.ops import gibbs as jg
from distributions_tpu_torch import clustering as tcl, config, convert
from distributions_tpu_torch import mixture as tmx, testing
from distributions_tpu_torch.inference import hypers, runner as tr
from distributions_tpu_torch.models import MODULES, nich as tnich
from distributions_tpu_torch.ops import gibbs as tg

torch.set_num_threads(1)
config.set_default_device('cpu')

# the same f32 formulas; log, lgamma, pow and log1p differ by ulps between
# torch and XLA
RTOL, ATOL = 1e-5, 1e-5
MIN_GOODNESS_OF_FIT = 1e-3
HERE = os.path.dirname(os.path.abspath(__file__))
MODELS = ([('PitmanYor', ex) for ex in tcl.PitmanYor.EXAMPLES]
          + [('LowEntropy', ex) for ex in tcl.LowEntropy.EXAMPLES])
IDS = ['%s-%d' % (name, i) for i, (name, _) in enumerate(MODELS)]


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _models(name, raw):
    return (getattr(tcl, name).from_dict(raw),
            getattr(jcl, name).from_dict(raw))


# -- deterministic scorers against the JAX package ----------------------------

@pytest.mark.parametrize('N', [5, 48, 1000, 1048576])
def test_le_log_partition_function_matches_jax(N):
    tm, jm = _models('LowEntropy', {'dataset_size': N})
    n = np.concatenate([np.arange(0, 120), [1000, 65536, 1048576]]).astype(
        np.int32)
    _close(tcl.le_log_partition_function(tm, torch.from_numpy(n)),
           jcl.le_log_partition_function(jm, n))


@pytest.mark.parametrize('N', [5, 1000, 1048576])
def test_le_score_counts_and_score_value_match_jax(N):
    tm, jm = _models('LowEntropy', {'dataset_size': N})
    rng = np.random.RandomState(N % 97)
    counts = rng.poisson(4.0, (6, 32)).astype(np.int32)
    counts[rng.rand(6, 32) < 0.4] = 0
    counts[1] = 0
    counts[1, :3] = [2, 2, 1]   # a full dataset of 5 when N == 5
    counts[2, 0] = 20000        # past the 'very large' group size
    # score_counts is sum c log c - log Z(n), two terms of ~2e5 for the
    # 20000-row group that cancel to ~1e3: each side rounds to f32 at the
    # terms' magnitude, so the atol is 4 ulp of the larger term (0.06 for
    # that row, 1e-5 for the others)
    got = tcl.le_score_counts(tm, torch.from_numpy(counts)).numpy()
    want = np.asarray(jcl.le_score_counts(jm, counts))
    term = np.asarray(jcl.le_log_partition_function(jm, counts.sum(1)))
    atol = np.maximum(ATOL, 4 * np.finfo(np.float32).eps * np.abs(term))
    np.testing.assert_array_less(np.abs(got - want), atol + RTOL * np.abs(
        want))
    for row in counts:
        alive = row > 0
        alive[np.flatnonzero(row == 0)[:2]] = True
        n = int(row.sum())
        _close(tcl.le_score_value(tm, torch.from_numpy(row),
                                  torch.from_numpy(alive), n),
               jcl.le_score_value(jm, row, alive, n))
        _close(tcl.score_value(tm, torch.from_numpy(row),
                               torch.from_numpy(alive), n),
               jcl.score_value(jm, row, alive, n))


@pytest.mark.parametrize('name,raw', MODELS, ids=IDS)
def test_add_and_remove_scores_match_jax(name, raw):
    tm, jm = _models(name, raw)
    sizes = np.array([0, 1, 2, 3, 7, 40, 9999, 10000, 10001, 123456],
                     np.float32)
    for nonempty, n, e in ((1, 3, 1), (4, 40, 2), (9, 123500, 3)):
        for fn in ('score_add_value', 'score_remove_value'):
            prefix = 'py_' if name == 'PitmanYor' else 'le_'
            s = sizes if fn == 'score_add_value' else sizes[1:]
            want = getattr(jcl, prefix + fn)(jm, s, nonempty, n, e)
            _close(getattr(tcl, prefix + fn)(tm, torch.from_numpy(s),
                                              nonempty, n, e), want)
            _close(getattr(tcl, fn)(tm, torch.from_numpy(s), nonempty, n,
                                    e), want)


# -- the reference's golden fixtures (tests/test_golden.py) ------------------

@functools.lru_cache(maxsize=None)
def _golden(name):
    with open(os.path.join(HERE, 'golden', name)) as f:
        return json.load(f)


def test_pitman_yor_matches_reference_cpp():
    """The C++ golden uses the reference's fast_log / fast_lgamma tables:
    tests/test_golden.py's tolerances."""
    cpp = _golden('cpp_golden.json')
    for rec in cpp['score_counts']:
        model = tcl.PitmanYor.from_dict(rec)
        got = float(tcl.score_counts(model, torch.tensor(rec['counts'])))
        np.testing.assert_allclose(got, rec['score'], rtol=1e-3, atol=0.02)
    for rec in cpp['score_add_remove']:
        model = tcl.PitmanYor.from_dict(rec)
        args = (rec['group_size'], rec['nonempty'], rec['sample_size'])
        np.testing.assert_allclose(
            float(tcl.py_score_add_value(model, *args)), rec['add'],
            rtol=1e-3, atol=2e-3)
        if rec['group_size'] > 0:
            np.testing.assert_allclose(
                float(tcl.py_score_remove_value(model, *args)),
                rec['remove'], rtol=1e-3, atol=2e-3)


def test_low_entropy_matches_reference_dbg_and_cpp():
    """The debug golden is exact float64 math (tolerance 1e-4), the C++
    one uses fast_log tables (1e-3 relative plus 0.02), as in
    tests/test_golden.py."""
    for rec in _golden('dbg_golden.json')['low_entropy']:
        model = tcl.LowEntropy.from_dict(rec)
        for row in rec['score_counts']:
            np.testing.assert_allclose(
                float(tcl.le_score_counts(model, torch.tensor(row['counts']))),
                row['score'], rtol=1e-4, atol=1e-4)
        for row in rec['score_add']:
            np.testing.assert_allclose(
                float(tcl.le_score_add_value(model, row['group_size'], 3,
                                             row['sample_size'])),
                row['add'], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(
                float(tcl.le_score_remove_value(
                    model, row['group_size'] + 1, 3,
                    row['sample_size'] + 1)),
                row['remove'], rtol=1e-4, atol=1e-4)
    for rec in _golden('cpp_golden.json')['le_score_counts']:
        model = tcl.LowEntropy.from_dict(rec)
        np.testing.assert_allclose(
            float(tcl.le_score_counts(model, torch.tensor(rec['counts']))),
            rec['score'], rtol=1e-3, atol=0.02)


# -- samplers by goodness of fit (tests/test_clustering.py) -------------------

SAMPLE_COUNT = 2000


def _canonical(assignments):
    groups = defaultdict(list)
    for i, k in enumerate(assignments):
        groups[k].append(i)
    return tuple(sorted(tuple(g) for g in groups.values()))


def _sizes(raw, max_size=5, min_size=2):
    return [s for s in range(min_size, max_size + 1)
            if s <= raw.get('dataset_size', float('inf'))]


def _draws(name, raw, size, n, seed=0):
    model = getattr(tcl, name).from_dict(raw)
    gen = torch.Generator().manual_seed(seed)
    return [tuple(tcl.sample_assignments(gen, model, size,
                                         capacity=32).tolist())
            for _ in range(n)]


@pytest.mark.parametrize('name,raw', MODELS, ids=IDS)
def test_sample_matches_score_counts(name, raw):
    """The partitions drawn by `sample_assignments` follow exp(score_counts)
    (normalised over the partitions seen), and the seen partitions carry
    all the mass: within 0.01 for Pitman-Yor and a full LowEntropy
    dataset, 0.5 for a partial one (the reference's own tolerance,
    tests/test_clustering.py)."""
    model = getattr(tcl, name).from_dict(raw)
    for size in _sizes(raw):
        samples = [_canonical(a) for a in _draws(name, raw, size,
                                                 SAMPLE_COUNT)]
        probs = {}
        for s in set(samples):
            counts = torch.tensor([len(g) for g in s])
            probs[s] = math.exp(float(tcl.score_counts(model, counts)))
        total = sum(probs.values())
        partial = name == 'LowEntropy' and size < raw['dataset_size']
        assert abs(total - 1) < (0.5 if partial else 0.01), total
        gof = util.discrete_goodness_of_fit(
            samples, {k: v / total for k, v in probs.items()})
        assert gof > MIN_GOODNESS_OF_FIT, (name, size, gof)


@pytest.mark.parametrize('name,raw', MODELS, ids=IDS)
def test_score_add_value_matches_score_counts(name, raw):
    """Seating probabilities from `score_add_value` equal the ratios of
    `score_counts` (tests/test_clustering.py)."""
    model = getattr(tcl, name).from_dict(raw)
    for size in _sizes(raw):
        for sample in {_canonical(a)
                       for a in _draws(name, raw, size - 1, 100, seed=1)}:
            counts = [len(g) for g in sample]
            actual, expected = [], []
            for i, g in enumerate(sample + ((),)):
                bigger = list(counts) + ([1] if not g else [])
                if g:
                    bigger[i] += 1
                expected.append(float(tcl.score_counts(
                    model, torch.tensor(bigger))))
                actual.append(float(tcl.score_add_value(
                    model, len(g), len(sample), size - 1)))
            np.testing.assert_allclose(util.scores_to_probs(actual),
                                       util.scores_to_probs(expected),
                                       atol=0.05)


def test_stick_breaking_matches_sequential_partition():
    """`py_sample_assignments_stick` and the host-seated
    `py_sample_assignments` draw the same partition law: label-invariant
    statistics agree, and P(rows 0, 1 together) = (1 - d) / (1 + alpha)
    exactly (tests/test_clustering.py's bounds)."""
    model = tcl.PitmanYor.from_dict({'alpha': 2.0, 'd': 0.25})
    n, reps = 40, 2000
    gen = torch.Generator().manual_seed(0)
    stick = torch.stack([tcl.py_sample_assignments_stick(gen, model, n, 256)
                         for _ in range(reps)]).numpy()
    seq = torch.stack([tcl.py_sample_assignments(gen, model, n, 64)
                       for _ in range(reps)]).numpy()

    def stats(A, cap):
        c = np.stack([np.bincount(row, minlength=cap) for row in A])
        return (c > 0).sum(1), c.max(1)

    def tv(x, y, hi):
        return 0.5 * np.abs(np.bincount(x, minlength=hi) / x.size
                            - np.bincount(y, minlength=hi) / y.size).sum()
    k_a, l_a = stats(stick, 256)
    k_b, l_b = stats(seq, 64)
    assert abs(k_a.mean() - k_b.mean()) < 0.35, (k_a.mean(), k_b.mean())
    assert tv(k_a, k_b, 41) < 0.08 and tv(l_a, l_b, 41) < 0.08
    pairs = torch.stack([tcl.py_sample_assignments_stick(gen, model, 2, 256)
                         for _ in range(4000)]).numpy()
    p_exact = (1 - 0.25) / (1 + 2.0)
    p_emp = (pairs[:, 0] == pairs[:, 1]).mean()
    assert abs(p_emp - p_exact) < 4 * np.sqrt(p_exact * (1 - p_exact) / 4000)


def test_py_sample_assignments_capacity_cap():
    """Tables open in slot order and none opens once `capacity` are open;
    then a row joins table k with probability (n_k - d) / (n - K d)."""
    model = tcl.PitmanYor.from_dict({'alpha': 50.0, 'd': 0.5})
    gen = torch.Generator().manual_seed(2)
    a = tcl.py_sample_assignments(gen, model, 400, capacity=3)
    assert a.dtype == torch.int32 and set(a.tolist()) == {0, 1, 2}
    first = [a.tolist().index(k) for k in range(3)]
    assert first == sorted(first)
    default = tcl.py_sample_assignments(gen, model, 10)
    assert int(default.max()) < 64 + 16 * 51 * (np.log(11) + 1)


def test_le_sample_assignments_opens_in_slot_order():
    model = tcl.LowEntropy.from_dict({'dataset_size': 300})
    a = tcl.le_sample_assignments(torch.Generator().manual_seed(0), model,
                                  300, capacity=16).tolist()
    seen = []
    for k in a:
        if k not in seen:
            assert k == len(seen) or len(seen) == 16
            seen.append(k)


# -- the LowEntropy prior on the main path -----------------------------------

R, C, BLOCK_ROWS = 256, 128, 128
JAX_MODELS = {name: importlib.import_module('distributions_tpu.models.'
                                            + name) for name in MODULES}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _le_problem(kind):
    p = testing.mixed_problem(R, C, seed=5, kind=kind)
    jspec, _, jsh = testing.build_problem(
        p, JAX_MODELS, jmx.make_spec, jcl.PitmanYor.from_dict)
    jle = jcl.LowEntropy.from_dict({'dataset_size': R})
    jv = tuple(jnp.asarray(v) for v in p['values'])
    ja = jnp.asarray(p['labels'])
    jst = jax.jit(lambda v, a: jmx.state_from_assignments(
        jspec, jle, jsh, v, a))(jv, ja)
    return dict(jspec=jspec, jle=jle, jsh=jsh, jv=jv, ja=ja, jst=jst,
                spec=convert.spec(jspec),
                le=tcl.LowEntropy.from_dict({'dataset_size': R}),
                sh=convert.shareds(jspec, _np(jsh)),
                tv=tuple(torch.from_numpy(v) for v in p['values']),
                st=convert.state(jspec, _np(jst)),
                ta=torch.from_numpy(p['labels']))


@pytest.mark.parametrize('kind', ['nich_gp_bb', 'niw3_nich_bb'])
def test_fused_mixed_sweep_with_low_entropy_argmax_matches_jax(kind):
    """The fused mixed sweep (the kernels' plain twins here) with a
    LowEntropy prior in 'argmax' equals the JAX function, whose kernel
    runs in Pallas interpret mode: equal draws and counts, the stat
    sums within tests/test_torch_fused_mixed.py's tolerance."""
    q = _le_problem(kind)
    jcache = jg.build_stat_cache(q['jspec'], q['jsh'], q['jv'], R, q['ja'])
    jst, jan, _ = jg.sweep_blocked_pallas_fused_mixed(
        q['jspec'], q['jle'], q['jsh'], q['jst'], q['jv'], q['ja'], R,
        BLOCK_ROWS, jax.random.PRNGKey(0), jcache, sampling='argmax')
    cache = tg.build_stat_cache(q['spec'], q['sh'], q['tv'], R, q['ta'])
    st, an, _ = tg.sweep_blocked_pallas_fused_mixed(
        q['spec'], q['le'], q['sh'], q['st'], q['tv'], q['ta'], R,
        BLOCK_ROWS, torch.Generator().manual_seed(0), cache,
        sampling='argmax')
    np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(jst.counts))
    np.testing.assert_allclose(
        float(tmx.score_data(q['spec'], q['le'], q['sh'], st)),
        float(jmx.score_data(q['jspec'], q['jle'], q['jsh'], jst)),
        rtol=1e-5)


def test_prior_init_low_entropy_follows_the_sequential_law():
    """`prior_init` with a LowEntropy prior seats 4 rows with the law of
    the JAX package's row-by-row scan: the probability of each partition
    is the product of the normalised `le_score_value` seating scores,
    enumerated with the JAX function."""
    spec = tmx.make_spec([(tnich, 1)], capacity=6)
    sh = (tnich.shared_from_dict(testing.NICH_SHARED),)
    le = tcl.LowEntropy.from_dict({'dataset_size': 10})
    jle = jcl.LowEntropy.from_dict({'dataset_size': 10})
    values = (torch.zeros(4, 1),)
    exact = {}

    def walk(counts, alive, seq, p):
        if len(seq) == 4:
            key = _canonical(seq)
            exact[key] = exact.get(key, 0.0) + p
            return
        s = np.asarray(jcl.le_score_value(jle, counts, alive, len(seq)),
                       np.float64)
        probs = np.exp(s - s.max())
        probs /= probs.sum()
        for k in np.flatnonzero(probs > 0):
            c, a = counts.copy(), alive.copy()
            if c[k] == 0:
                a[np.argmin(a)] = True
            c[k] += 1
            walk(c, a, seq + [int(k)], p * probs[k])
    alive = np.zeros(6, bool)
    alive[0] = True
    walk(np.zeros(6, np.int32), alive, [], 1.0)
    gen = torch.Generator().manual_seed(0)
    samples = []
    for _ in range(1500):
        st, an = tg.prior_init(spec, le, sh, tmx.init(spec, sh), values, gen)
        samples.append(_canonical(an.tolist()))
    np.testing.assert_array_equal(st.counts.numpy(),
                                  np.bincount(an.numpy(), minlength=6))
    gof = util.discrete_goodness_of_fit(samples, exact)
    assert gof > MIN_GOODNESS_OF_FIT, gof


def test_run_gibbs_low_entropy_resume_is_bitwise(tmp_path):
    """A LowEntropy run on the fused path from its default 'prior' init,
    interrupted at a checkpoint and resumed, equals the uninterrupted run
    bitwise; the clustering moves refuse the prior."""
    values = (testing.nich_problem(64, seed=12, n_clusters=2)[0],)
    spec = tmx.make_spec([(tnich, 2)], capacity=16)
    sh = (tnich.shared_from_dict(testing.NICH_SHARED),)
    le = {'dataset_size': 64}
    common = dict(block=16, use_pallas=True, sampling='gumbel',
                  checkpoint_every=2)
    st_a, an_a, log_a = tr.run_gibbs(
        spec, le, sh, values, torch.Generator().manual_seed(3), 5,
        checkpoint_path=str(tmp_path / 'full.ckpt'), resume=False, **common)
    ckpt = str(tmp_path / 'crash.ckpt')
    tr.run_gibbs(spec, le, sh, values, torch.Generator().manual_seed(3), 2,
                 checkpoint_path=ckpt, resume=False, **common)
    st_b, an_b, log_b = tr.run_gibbs(
        spec, le, sh, values, torch.Generator().manual_seed(999), 5,
        checkpoint_path=ckpt, resume=True, **common)
    assert isinstance(log_b.final_cl_model, tcl.LowEntropy)
    assert torch.equal(an_a, an_b) and torch.equal(st_a.counts, st_b.counts)
    assert torch.equal(st_a.groups[0].mean, st_b.groups[0].mean)
    assert log_a.rows[-1]['score_data'] == log_b.rows[-1]['score_data']
    for kwargs in ({'cl_slice': True},
                   {'cl_grid': hypers.make_py_grid([1.0], [0.1])}):
        with pytest.raises(ValueError, match='Pitman-Yor'):
            tr.run_gibbs(spec, le, sh, values, torch.Generator(), 1,
                         block=16, **kwargs)
