"""The port's compat facade (`distributions_tpu_torch.compat`, and its
dbg / lp aliases) against the JAX package's (tests/test_compat.py's
cases), the same inputs through both.

Tolerances: `dump()` dicts equal, integers exactly and floats to rtol
1e-6 (gp's log_prod and nich's running moments are float32 sums that the
two libraries round differently in the last bit); scores within 1e-5
(rtol and atol), except gp and bnb at atol 2e-3 and 5e-4 (their lgamma
differences, ROADMAP "Deliberate divergences"); the per-row driver loop
to 1e-4.  The port's samplers draw from other streams than JAX's, so they
are held to their own scores by goodness of fit (p > 1e-3, the
reference's bound) with the port's `util`.
"""

import numpy as np
import pytest
import torch

from distributions_tpu.compat import models as jcm
from distributions_tpu.compat.clustering import PitmanYor as JPitmanYor
from distributions_tpu.compat.mixture import MixtureIdTracker as JTracker
from distributions_tpu_torch import config, util
from distributions_tpu_torch.compat import models as tcm
from distributions_tpu_torch.compat.clustering import (LowEntropy,
                                                       PitmanYor,
                                                       count_assignments)
from distributions_tpu_torch.compat.mixture import MixtureIdTracker
from distributions_tpu_torch.compat.rng import (get_generator, get_key,
                                                seed_all)

torch.set_num_threads(1)
config.set_default_device('cpu')

NAMES = sorted(tcm.MODULES)
ATOL = {'gp': 2e-3, 'bnb': 5e-4}
SAMPLE_COUNT = 1200
MIN_GOODNESS_OF_FIT = 1e-3


def _same(got, want, rtol=1e-6):
    """Equal dump dicts: the same keys and types, ints exactly, floats and
    arrays to `rtol`."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k], rtol)
    elif isinstance(want, (int, bool, np.integer)) and not isinstance(
            want, (float, np.floating)):
        assert type(got) is type(want) and got == want, (got, want)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=rtol, atol=0)


def _both(name, example):
    """(port Shared, port Group, JAX Shared, JAX Group) from an example."""
    tm, jm = tcm.MODULES[name], jcm.MODULES[name]
    ts = tm.Shared.from_dict(example['shared'])
    js = jm.Shared.from_dict(example['shared'])
    return (ts, tm.Group.from_values(ts, example['values']),
            js, jm.Group.from_values(js, example['values']))


@pytest.mark.parametrize('name', NAMES)
def test_dumps_and_scores_match_jax(name):
    tm = tcm.MODULES[name]
    assert tm.NAME == jcm.MODULES[name].NAME
    atol = ATOL.get(name, 1e-5)
    for i, example in enumerate(tm.EXAMPLES):
        ts, tg, js, jg = _both(name, example)
        _same(ts.dump(), js.dump())
        dumped = tg.dump(ts)
        _same(dumped, jg.dump(js))
        _same(tm.Group.from_dict(dumped, ts).dump(ts), dumped, rtol=0)
        assert tg._data[0].device.type == 'cpu'
        if i:
            continue    # each new shape costs the JAX side a compile
        for v in example['values'][:3]:
            np.testing.assert_allclose(tg.score_value(ts, v),
                                       jg.score_value(js, v),
                                       rtol=1e-5, atol=atol)
        np.testing.assert_allclose(tg.score_data(ts), jg.score_data(js),
                                   rtol=1e-5, atol=atol)


def test_mixture_id_tracker_sequences_match_jax():
    rng = np.random.RandomState(0)
    got, want = MixtureIdTracker(), JTracker()
    got.init(3)
    want.init(3)
    for _ in range(200):
        if len(want) > 1 and rng.rand() < 0.45:
            k = rng.randint(len(want))
            got.remove_group(k)
            want.remove_group(k)
        else:
            got.add_group()
            want.add_group()
        assert got._packed_to_global == want._packed_to_global
        assert got._global_to_packed == want._global_to_packed
    with pytest.raises(KeyError):
        got.global_to_packed(-1)


@pytest.mark.parametrize('name', ['nich', 'dd', 'niw', 'gp', 'bb'])
def test_feature_mixture_accumulates(name):
    """score_value adds into the caller's array (noise added, then taken
    off again) the per-group scores of JAX's facade; remove_group moves
    the last group into the hole."""
    example = tcm.MODULES[name].EXAMPLES[0]
    ts, _, js, _ = _both(name, example)
    values = example['values']
    mixtures = []
    for mod, shared in ((tcm.MODULES[name], ts), (jcm.MODULES[name], js)):
        mixture = mod.Mixture()
        for v in values:
            mixture.append(mod.Group.from_values(shared, [v]))
        mixture.init(shared)
        mixture.remove_group(shared, 1)
        mixtures.append(mixture)
    got, want = mixtures
    assert len(got) == len(want) == len(values) - 1
    rng = np.random.RandomState(0)
    atol = ATOL.get(name, 1e-5)
    for value in values[:4]:
        noise = rng.randn(len(got)).astype(np.float32)
        accum = noise.copy()
        assert got.score_value(ts, value, accum) is accum
        expected = want.score_value(js, value,
                                    np.zeros(len(want), np.float32))
        finite = np.isfinite(expected)
        np.testing.assert_array_equal(np.isfinite(accum), finite)
        np.testing.assert_allclose((accum - noise)[finite], expected[finite],
                                   rtol=1e-5, atol=max(atol, 1e-5))
        np.testing.assert_allclose(
            [got.score_value_group(ts, i, value) for i in range(len(got))],
            expected, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got.score_data(ts), want.score_data(js),
                               rtol=1e-5, atol=atol * len(got))


def test_driver_slave_lockstep_matches_jax():
    """tests/test_compat.py's driver/slave loop run through both facades
    in lockstep: the same group picked for each row from the JAX scores,
    and the port's scores, counts, groups and ids held to JAX's."""
    seed_all(1)
    raw_cl = {'alpha': 2.0, 'd': 0.1}
    raw_feature = {'mu': 0., 'kappa': 1., 'sigmasq': 1., 'nu': 1.}
    sides = []
    for cl_cls, mod in ((PitmanYor, tcm.nich), (JPitmanYor, jcm.nich)):
        cl = cl_cls.from_dict(raw_cl)
        feature = mod.Shared.from_dict(raw_feature)
        cmix, fmix = cl.Mixture(), mod.Mixture()
        tracker = MixtureIdTracker() if mod is tcm.nich else JTracker()
        cmix.init(cl, [0, 0])
        tracker.init(2)
        for _ in range(2):
            fmix.add_group(feature)
        sides.append((cl, feature, cmix, fmix, tracker))

    rng = np.random.RandomState(0)
    data = rng.randn(30).tolist()
    assignments = {}

    def step(i, x):
        scores = []
        for cl, feature, cmix, fmix, _ in sides:
            s = np.zeros(len(cmix), np.float32)
            cmix.score_value(cl, s)
            fmix.score_value(feature, x, s)
            scores.append(s)
        np.testing.assert_allclose(scores[0], scores[1], rtol=1e-4,
                                   atol=1e-4)
        gid = int(np.argmax(rng.multinomial(
            1, util.scores_to_probs(scores[1]))))
        for cl, feature, cmix, fmix, tracker in sides:
            if cmix.add_value(cl, gid):
                fmix.add_group(feature)
                tracker.add_group()
            fmix.add_value(feature, gid, x)
            assignments[i] = tracker.packed_to_global(gid)

    for i, x in enumerate(data):
        step(i, x)
    for i, x in enumerate(data):
        for cl, feature, cmix, fmix, tracker in sides:
            gid = tracker.global_to_packed(assignments[i])
            removed = cmix.remove_value(cl, gid)
            fmix.remove_value(feature, gid, x)
            if removed:
                fmix.remove_group(feature, gid)
                tracker.remove_group(gid)
        step(i, x)

    (_, tf, tc, tfm, tt), (_, jf, jc, jfm, jt) = sides
    assert tc.counts == jc.counts and sum(tc.counts) == len(data)
    assert len(tc) == len(tfm) == len(tt)
    assert tt._packed_to_global == jt._packed_to_global
    assert tc.counts == count_assignments(
        [tt.global_to_packed(g) for g in assignments.values()]) + [0]
    np.testing.assert_allclose(tfm.score_data(tf), jfm.score_data(jf),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('name', NAMES)
def test_sample_value_goodness_of_fit(name):
    """sample_value's draws against exp(score_value) (reference
    tests/test_models.py:373-419; niw by the Mahalanobis statistic of
    tests/test_hp_models.py)."""
    seed_all(5)
    mod = tcm.MODULES[name]
    example = mod.EXAMPLES[0]
    shared = mod.Shared.from_dict(example['shared'])
    for v in example['values']:
        shared.add_value(v)            # dpd observes its values
    group = mod.Group.from_values(shared, example['values'])
    samples = [group.sample_value(shared) for _ in range(SAMPLE_COUNT)]
    if mod.Value is bool:
        assert all(type(s) is bool for s in samples)
        probs = np.exp([group.score_value(shared, v) for v in (False, True)])
        counts = [samples.count(False), samples.count(True)]
        gof = util.multinomial_goodness_of_fit(probs, counts, SAMPLE_COUNT)
    elif mod.Value is int:
        assert all(type(s) is int for s in samples)
        gof = util.discrete_goodness_of_fit(
            samples, {v: np.exp(group.score_value(shared, v))
                      for v in sorted(set(samples))})
    elif mod.Value is float:
        assert all(type(s) is float for s in samples)
        probs = np.exp([group.score_value(shared, x) for x in samples])
        gof = util.density_goodness_of_fit(samples, probs)
    else:
        from scipy.stats import f as f_dist
        xs = np.asarray(samples, np.float64)
        post = {k: np.asarray(v, np.float64)
                for k, v in shared.plus_group(group).dump().items()}
        d = xs.shape[1]
        dof = post['nu'] - d + 1.0
        sigma = post['psi'] * (post['kappa'] + 1.0) / (post['kappa'] * dof)
        diff = xs - post['mu']
        maha = np.einsum('nd,de,ne->n', diff, np.linalg.inv(sigma), diff)
        gof = util.unif01_goodness_of_fit(f_dist.cdf(maha / d, d, dof))
    assert gof > MIN_GOODNESS_OF_FIT, (name, gof)
    sampler = mod.Sampler()
    sampler.init(shared, group)
    assert len([sampler.eval(shared) for _ in range(5)]) == 5
    assert len(mod.sample_group(shared, 10)) == 10


def test_seed_all_determinism():
    assert get_key is get_generator
    mod = tcm.nich
    shared = mod.Shared.from_dict(mod.EXAMPLES[0]['shared'])
    group = mod.Group.from_values(shared, [])
    seed_all(42)
    a = [group.sample_value(shared) for _ in range(5)]
    seed_all(42)
    b = [group.sample_value(shared) for _ in range(5)]
    assert a == b and len(set(a)) == 5


def test_clustering_scalar_api_matches_jax():
    from distributions_tpu.compat.clustering import LowEntropy as JLE
    py, jpy = (cls.from_dict({'alpha': 1.0, 'd': 0.2})
               for cls in (PitmanYor, JPitmanYor))
    for args in [(0, 3, 10), (5, 3, 10), (0, 1, 1, 2)]:
        assert py.score_add_value(*args) == jpy.score_add_value(*args)
    assert py.score_remove_value(6, 4, 11) == jpy.score_remove_value(6, 4,
                                                                      11)
    np.testing.assert_allclose(py.score_counts([3, 4, 5]),
                               jpy.score_counts([3, 4, 5]), rtol=1e-5)
    seed_all(0)
    a = py.sample_assignments(20)
    assert len(a) == 20 and all(type(x) is int for x in a)

    le, jle = LowEntropy.from_dict({'dataset_size': 50}), JLE(50)
    for f, args in [('score_counts', ([3, 4, 5],)),
                    ('log_partition_function', (10,)),
                    ('log_partition_function', (100,)),
                    ('score_add_value', (0, 3, 10)),
                    ('score_add_value', (4, 3, 10, 2)),
                    ('score_remove_value', (4, 3, 10))]:
        np.testing.assert_allclose(getattr(le, f)(*args),
                                   getattr(jle, f)(*args), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    counts = np.asarray([3., 0., 5., 0.])
    for got, want in [(py, jpy), (le, jle)]:
        np.testing.assert_allclose(got._score_slots(counts, 8),
                                   want._score_slots(counts, 8), rtol=1e-5)
    assert len(le.sample_assignments(10)) == 10
    assert count_assignments({0: 1, 1: 0, 2: 1}) == [1, 2]


def test_dbg_and_lp_resolve_to_the_compat_namespaces():
    import importlib
    from distributions_tpu_torch import dbg, lp
    from distributions_tpu_torch.compat import rng
    for flavor in (dbg, lp):
        assert flavor.models.nich is tcm.nich
        assert flavor.models.MODULES is tcm.MODULES
        assert flavor.random_module is rng
        sub = importlib.import_module(flavor.__name__ + '.clustering')
        assert sub.PitmanYor is PitmanYor and sub.LowEntropy is LowEntropy
        for name in NAMES:
            mod = importlib.import_module('%s.models.%s'
                                          % (flavor.__name__, name))
            assert mod is tcm.MODULES[name]


def test_dpd_feature_mixture_scores():
    """The JAX facade's FeatureMixture.score_value raises on dpd (its
    stacked numpy groups reach dpd's `.at` indexing); the port's scores a
    dpd mixture, held to each group's own score_value."""
    seed_all(0)
    mod = tcm.dpd
    example = mod.EXAMPLES[0]
    shared = mod.Shared.from_dict(example['shared'])
    groups = [mod.Group.from_values(shared, example['values'][i::3])
              for i in range(3)]
    mixture = mod.Mixture()
    for g in groups:
        mixture.append(g)
    for value in (0, 7, 8, 5):
        got = mixture.score_value(shared, value, np.zeros(3, np.float32))
        want = [g.score_value(shared, value) for g in groups]
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(AttributeError):
        jm = jcm.dpd
        js = jm.Shared.from_dict(example['shared'])
        jmix = jm.Mixture()
        jmix.append(jm.Group.from_values(js, example['values']))
        jmix.score_value(js, 0, np.zeros(1, np.float32))
