"""The port's flavors and loose names against the JAX package.

- `distributions_tpu_torch.hp`, a copy of the float64 flavor: its modules
  equal distributions_tpu.hp's but for the package name in imports and the
  docstrings, it gives bitwise the same results on the flavor tests'
  inputs, and it imports no torch, no jax and nothing of either core.
- The port's torch core against the port's hp on suff stats, score_value,
  score_data and the priors' score_counts, at tests/test_flavor_agreement.py's
  tolerance (1e-3; LowEntropy relative past |score| 100).
- `util` / `fileutil`, the CLI (`__main__`), and the names this slice adds
  (special's aliases, base.group_stack, dd.score_data_grid,
  debug.validate_dpd_shared, diagnostics.trace, config.DPD_CAPACITY)
  against the JAX package's: exactly where no float arithmetic differs,
  else at tests/test_torch_special.py's tolerances (rtol 1e-5, atol 6e-5:
  torch's and XLA's lgamma differ by an ulp, and log_beta differences
  three of them).
"""

import ast
import io
import os
import pathlib
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributions_tpu
import distributions_tpu_torch
from distributions_tpu import __main__ as jmain, debug as jdebug
from distributions_tpu import special as jspecial, util as jutil
from distributions_tpu.hp import clustering as jhp_cl, special as jhp_special
from distributions_tpu.hp.models import MODULES as JHP
from distributions_tpu.models import base as jbase, dd as jdd, niw as jniw
from distributions_tpu_torch import __main__ as tmain, config, debug
from distributions_tpu_torch import diagnostics, fileutil, special, util
from distributions_tpu_torch import clustering as tcl
from distributions_tpu_torch.hp import clustering as hp_cl
from distributions_tpu_torch.hp import special as hp_special
from distributions_tpu_torch.hp.models import MODULES as HP
from distributions_tpu_torch.models import MODULES as TM, base, dd
from tests.util import assert_close

torch.set_num_threads(1)
config.set_default_device('cpu')

TOL = 1e-3
CASES = [(name, i) for name in sorted(HP)
         for i in range(len(HP[name].EXAMPLES))]
cases = pytest.mark.parametrize('name,idx', CASES,
                                ids=['%s-%d' % c for c in CASES])
COUNT_VECTORS = [
    [1], [2], [1, 1], [5, 1, 1], [10, 3, 2, 1, 1],
    [2, 2, 2, 2], [100, 1], [17, 13, 7, 5, 3, 2, 1, 1, 1],
]
JAX_ROOT = pathlib.Path(distributions_tpu.__file__).parent
PORT_ROOT = pathlib.Path(distributions_tpu_torch.__file__).parent


# -- the hp copy --------------------------------------------------------------

def _code(path, package):
    """A module's AST dump without docstrings, the package name in its
    imports replaced by a placeholder."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, 'body', None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace(package, 'PKG')
    return ast.dump(tree)


def test_hp_modules_are_the_jax_packages_modules():
    jax_files = sorted(p.relative_to(JAX_ROOT / 'hp')
                       for p in (JAX_ROOT / 'hp').rglob('*.py'))
    port_files = sorted(p.relative_to(PORT_ROOT / 'hp')
                        for p in (PORT_ROOT / 'hp').rglob('*.py'))
    assert jax_files == port_files and len(jax_files) == 12
    for rel in jax_files:
        assert (_code(PORT_ROOT / 'hp' / rel, 'distributions_tpu_torch')
                == _code(JAX_ROOT / 'hp' / rel, 'distributions_tpu')), rel


def test_hp_package_imports_no_torch_jax_or_core():
    """The port's hp is an independent oracle: no torch, no jax, nothing of
    either package's core (the rule tests/test_flavor_agreement.py holds
    the JAX hp to)."""
    for path in (PORT_ROOT / 'hp').rglob('*.py'):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] not in (['import'], ['from']):
                continue
            module = words[1]
            assert module.split('.')[0] not in ('torch', 'jax'), line
            if module.startswith('distributions_tpu'):
                assert module.startswith('distributions_tpu_torch.hp'), line


def _hp_run(models, name, idx, seed):
    """Everything the flavor tests compute on one example, from one hp
    package, as a list of plain values."""
    mod = models[name]
    ex = mod.EXAMPLES[idx]
    rng = np.random.default_rng(seed)
    shared = mod.shared_from_dict(ex['shared'])
    if hasattr(mod, 'shared_add_value'):
        for v in ex['values']:
            shared = mod.shared_add_value(rng, shared, v)
    group = mod.group_init(shared)
    out = []
    for v in ex['values']:
        out.append(mod.score_value(shared, group, v))
        group = mod.add_value(shared, group, v)
    out.append(mod.score_data(shared, group))
    out.append(repr(mod.shared_to_dict(shared)))
    try:
        out.append(repr(mod.group_to_dict(group)))
    except TypeError:
        out.append(repr(mod.group_to_dict(group, shared)))
    if hasattr(mod, 'plus_group'):
        out.append(repr(mod.shared_to_dict(mod.plus_group(shared, group))))
    out.append(repr(mod.sample_value(rng, shared, group)))
    out.append(repr(mod.sample_group(rng, shared, 4)))
    return out


@cases
def test_hp_copy_is_bitwise_the_jax_hp(name, idx):
    assert _hp_run(HP, name, idx, idx) == _hp_run(JHP, name, idx, idx)


def test_hp_clustering_and_special_bitwise():
    for got_cl, want_cl in [(hp_cl.PitmanYor(1.5, 0.2),
                             jhp_cl.PitmanYor(1.5, 0.2)),
                            (hp_cl.LowEntropy(100), jhp_cl.LowEntropy(100))]:
        for counts in COUNT_VECTORS:
            assert got_cl.score_counts(counts) == want_cl.score_counts(counts)
        assert (got_cl.sample_assignments(np.random.default_rng(7), 30)
                == want_cl.sample_assignments(np.random.default_rng(7), 30))
    for n in (1, 5, 31, 48):
        np.testing.assert_array_equal(hp_special.log_stirling1_row(n),
                                      jhp_special.log_stirling1_row(n))
    for n in (1, 5, 20):
        assert (hp_cl.exact_log_partition_function(n)
                == jhp_cl.exact_log_partition_function(n))
    nus = np.linspace(0.1, 200.0, 50)
    np.testing.assert_array_equal(hp_special.lgamma_nu(nus),
                                  jhp_special.lgamma_nu(nus))


# -- the port's core against the port's hp -----------------------------------

def _core_objects(name, idx):
    """The port core's Shared (dpd observing the values), the hp Shared
    read from its dict, and both groups of the example's values."""
    tm, hm = TM[name], HP[name]
    ex = tm.EXAMPLES[idx]
    tshared = tm.shared_from_dict(ex['shared'])
    if name == 'dpd':
        gen = torch.Generator().manual_seed(idx)
        for v in ex['values']:
            tshared = tm.shared_add_value(gen, tshared, v)
    hshared = hm.shared_from_dict(tm.shared_to_dict(tshared))
    tgroup, hgroup = tm.group_init(tshared), hm.group_init(hshared)
    for v in ex['values']:
        tgroup = tm.add_value(tshared, tgroup, v)
        hgroup = hm.add_value(hshared, hgroup, v)
    return tshared, tgroup, hshared, hgroup


@cases
def test_core_agrees_with_hp(name, idx):
    tm, hm = TM[name], HP[name]
    tshared, tgroup, hshared, hgroup = _core_objects(name, idx)
    if name == 'dpd':
        got = tm.group_to_dict(tgroup, tshared)
        want = hm.group_to_dict(hgroup, hshared)
    else:
        got, want = tm.group_to_dict(tgroup), hm.group_to_dict(hgroup)
    assert_close(got, want, tol=TOL)
    for v in tm.EXAMPLES[idx]['values']:
        assert_close(float(tm.score_value(tshared, tgroup, v)),
                     hm.score_value(hshared, hgroup, v), tol=TOL,
                     err_msg='%s score_value(%s)' % (name, v))
    assert_close(float(tm.score_data(tshared, tgroup)),
                 hm.score_data(hshared, hgroup), tol=TOL)


def test_priors_agree_with_hp():
    for raw in tcl.PitmanYor.EXAMPLES:
        model, oracle = tcl.PitmanYor.from_dict(raw), hp_cl.PitmanYor(**raw)
        for counts in COUNT_VECTORS:
            assert_close(float(tcl.py_score_counts(
                model, torch.tensor(counts, dtype=torch.float32))),
                oracle.score_counts(counts), tol=TOL)
    for raw in tcl.LowEntropy.EXAMPLES:
        model, oracle = tcl.LowEntropy.from_dict(raw), hp_cl.LowEntropy(**raw)
        for counts in COUNT_VECTORS:
            want = oracle.score_counts(counts)
            assert_close(float(tcl.le_score_counts(
                model, torch.tensor(counts, dtype=torch.float32))), want,
                tol=TOL * max(1.0, abs(want) * 1e-2))


# -- util, fileutil, the CLI --------------------------------------------------

def test_util_matches_jax():
    rng = np.random.RandomState(0)
    scores = rng.randn(6)
    np.testing.assert_array_equal(util.scores_to_probs(scores),
                                  jutil.scores_to_probs(scores))
    assert (util.score_to_empirical_kl(-50.0, 10)
            == jutil.score_to_empirical_kl(-50.0, 10))
    probs = util.scores_to_probs(scores)
    counts = rng.multinomial(2000, probs)
    assert (util.multinomial_goodness_of_fit(probs, counts, 2000)
            == jutil.multinomial_goodness_of_fit(probs, counts, 2000))
    x = rng.randn(1000)
    dens = np.exp(-0.5 * x * x) / np.sqrt(2 * np.pi)
    assert (util.density_goodness_of_fit(x, dens)
            == jutil.density_goodness_of_fit(x, dens))
    u = rng.rand(1000)
    assert util.unif01_goodness_of_fit(u) == jutil.unif01_goodness_of_fit(u)
    ints = rng.poisson(3.0, 500)
    table = {k: float(np.exp(-3.0) * 3.0 ** k / np.prod(range(1, k + 1)))
             for k in range(20)}
    assert (util.discrete_goodness_of_fit(ints, table)
            == jutil.discrete_goodness_of_fit(ints, table))
    for a, b in zip(util.bin_samples(x, 7, (-9, 9)),
                    jutil.bin_samples(x, 7, (-9, 9))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(util.histogram(ints),
                                  jutil.histogram(ints))


def test_fileutil_contexts(tmp_path):
    start = os.getcwd()
    with fileutil.tempdir() as wd:
        assert os.path.realpath(os.getcwd()) == os.path.realpath(wd)
        open('x.txt', 'w').close()
    assert os.getcwd() == start and not os.path.exists(wd)
    with fileutil.chdir(str(tmp_path)):
        assert os.path.realpath(os.getcwd()) == os.path.realpath(tmp_path)
    assert os.getcwd() == start


def _cli(module, *argv, monkeypatch):
    """What `python -m <package> argv...` prints, run in this process."""
    monkeypatch.setattr(sys, 'argv', [module.__name__] + list(argv))
    out = io.StringIO()
    with redirect_stdout(out):
        module.main()
    return out.getvalue()


def test_cli_matches_jax(monkeypatch):
    """`examples` prints what the JAX CLI prints; `model_apis` prints the
    same names and fields, and every function the JAX module lists (the
    port's modules also list their imported helpers)."""
    def cli(module, *argv):
        return _cli(module, *argv, monkeypatch=monkeypatch)
    assert cli(tmain, 'examples') == cli(jmain, 'examples')
    got = cli(tmain, 'model_apis').split('\n')
    want = cli(jmain, 'model_apis').split('\n')
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.startswith('  functions:'):
            g_fns = set(g.split(':', 1)[1].strip().split(', '))
            w_fns = set(w.split(':', 1)[1].strip().split(', '))
            assert w_fns <= g_fns, w_fns - g_fns
        else:
            assert g == w
    lines = cli(tmain, 'modes_by_model').splitlines()
    assert len(lines) == 7 and all(
        line.endswith(' '.join(tmain.MODES + ['hp'])) for line in lines)
    assert 'jit' not in tmain.MODES
    assert 'distributions_tpu_torch.benchmarks.bench_runner' in cli(
        tmain, 'benchmarks')
    assert cli(tmain, 'model_api', 'nich').splitlines()[:3] == cli(
        jmain, 'model_api', 'nich').splitlines()[:3]


# -- the loose names ----------------------------------------------------------

def test_special_aliases_match_jax():
    assert special.__all__ == jspecial.__all__
    for name in special.__all__:
        assert hasattr(special, name), name
    assert special.fast_log is torch.log and special.fast_exp is torch.exp
    assert special.pi == jspecial.pi
    x = np.linspace(0.5, 80.0, 33).astype(np.float32)
    y = np.linspace(0.1, 5.0, 33).astype(np.float32)
    t = torch.from_numpy
    for name, args in [('log', (x,)), ('exp', (y,)), ('sqrt', (x,)),
                       ('lgamma', (x,)), ('fast_lgamma', (x,)),
                       ('fast_log_beta', (x, y)), ('fast_log_binom', (x, y)),
                       ('fast_log_factorial', (x,)),
                       ('fast_lgamma_nu', (x,)),
                       ('fast_log_sum_exp', (x, y))]:
        got = getattr(special, name)(*(t(a) for a in args)).numpy()
        want = np.asarray(getattr(jspecial, name)(*args))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=6e-5,
                                   err_msg=name)


def test_group_stack_matches_jax():
    shared = TM['niw'].shared_from_dict(TM['niw'].EXAMPLES[0]['shared'])
    groups = []
    for v in TM['niw'].EXAMPLES[0]['values'][:3]:
        groups.append(TM['niw'].add_value(
            shared, TM['niw'].group_init(shared), v))
    got = base.group_stack(groups)
    assert type(got) is TM['niw'].Group
    want = jbase.group_stack([jniw.Group(*(jnp.asarray(x.numpy())
                                           for x in g)) for g in groups])
    for a, b in zip(got, want):
        assert a.shape[0] == 3
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dd_score_data_grid_matches_jax():
    alphas = np.asarray([[0.5, 1.0, 2.0], [1.0, 1.0, 1.0], [1e3, 5.0, 0.1]],
                        np.float32)
    counts = np.asarray([3, 0, 7], np.int32)
    got = dd.score_data_grid(dd.Shared(alphas=torch.from_numpy(alphas)),
                             dd.Group(counts=torch.from_numpy(counts)))
    want = jdd.score_data_grid(jdd.Shared(alphas=jnp.asarray(alphas)),
                               jdd.Group(counts=jnp.asarray(counts)))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    for g in range(3):
        assert got[g] == dd.score_data(dd.Shared(torch.from_numpy(alphas[g])),
                                       dd.Group(torch.from_numpy(counts)))


def test_validate_dpd_shared_gated_on_debug_level(monkeypatch):
    raw = {'gamma': 0.5, 'alpha': 1.0, 'betas': {0: 0.25, 7: 0.5},
           'counts': {0: 1, 7: 2}}
    good = TM['dpd'].shared_from_dict(raw, cap=8)
    bad = good._replace(betas=good.betas.clone())
    bad.betas[1] = -0.5
    monkeypatch.setattr(config, 'DEBUG_LEVEL', 0)
    debug.validate_dpd_shared(bad)       # off: no check
    monkeypatch.setattr(config, 'DEBUG_LEVEL', 1)
    monkeypatch.setattr(jdebug.config, 'DEBUG_LEVEL', 1)
    debug.validate_dpd_shared(good)
    with pytest.raises(AssertionError, match='negative stick'):
        debug.validate_dpd_shared(bad)
    with pytest.raises(AssertionError, match='negative stick'):
        jdebug.validate_dpd_shared(bad._replace(
            **{k: x.numpy() for k, x in bad._asdict().items()}))


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    logdir = tmp_path / 'trace'
    with diagnostics.trace(str(logdir)):
        torch.ones(4).sum()
    path = logdir / 'trace.json'
    assert path.exists() and path.stat().st_size > 0
    assert 'traceEvents' in path.read_text()
    assert capsys.readouterr().out.startswith(
        'trace written to %s (' % logdir)


def test_config_dpd_capacity_and_package_imports():
    from distributions_tpu import config as jconfig
    assert config.DPD_CAPACITY == jconfig.DPD_CAPACITY
    assert config.DPD_CAPACITY == TM['dpd'].DEFAULT_CAPACITY
    assert distributions_tpu_torch.special is special
    assert distributions_tpu_torch.util is util
    import distributions_tpu_torch.random as trandom
    assert distributions_tpu_torch.random is trandom
    from distributions_tpu_torch.models import niw
    assert niw.score_student_t is trandom.score_student_t
