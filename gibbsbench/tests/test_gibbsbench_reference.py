"""The plain reference against brute force at tiny sizes: its statistics
against sums row by row, its joint score against the chain rule over the
rows one at a time (the prior's seating probability times each model's
predictive), and draw_z on draws from a known law."""

import math

import numpy as np
import pytest
import torch

from gibbsbench import problem, reference

F64 = torch.float64


@pytest.fixture(params=['nich2', 'bb1', 'mixed'])
def config(request, mixed_config):
    """Each configuration file, and every plain model in one."""
    if request.param == 'mixed':
        return mixed_config
    return problem.config(request.param)


def tiny(cfg, R=40, C=6, n_clusters=3, seed=5):
    cfg = dict(cfg, rows=R)
    labels, values = problem.make_rows(cfg, n_clusters, seed, 'cpu')
    return cfg, labels.to(torch.int64), values, C


def test_stats_are_row_sums(config):
    cfg, labels, values, C = tiny(config)
    st = reference.stats(cfg, values, labels, C)
    for k in range(C):
        rows = labels == k
        assert float(st['counts'][k]) == int(rows.sum())
        for b, v, leaves in zip(cfg['blocks'], values, st['blocks']):
            x = v[rows].to(F64)
            want = {'nich': {'sum': x.sum(0), 'sumsq': (x * x).sum(0)},
                    'niw': {'sum_x': x.sum(0),
                            'sum_xxT': (x[..., :, None]
                                        * x[..., None, :]).sum(0)},
                    'bb': {'heads': x.sum(0), 'tails': (1 - x).sum(0)}}
            for leaf, w in want[b['model']].items():
                assert torch.allclose(leaves[leaf][k], w, rtol=1e-12,
                                      atol=1e-12)


def chain_rule_score(cfg, values, labels, C):
    """log p(z, x) as the product over rows, one at a time, of the
    Pitman-Yor seating probability and each block's predictive against the
    rows before it."""
    alpha, d = cfg['prior']['alpha'], cfg['prior']['d']
    total = 0.0
    for i in range(labels.shape[0]):
        k = int(labels[i])
        before = reference.stats(cfg, tuple(v[:i] for v in values),
                                 labels[:i], C)
        n_k = float(before['counts'][k])
        occupied = int((before['counts'] > 0).sum())
        seat = (n_k - d) if n_k > 0 else (alpha + d * occupied)
        total += math.log(seat / (i + alpha))
        for b, v, leaves in zip(cfg['blocks'], values, before['blocks']):
            m = reference.model(b['model'])
            one = {name: x[k:k + 1] for name, x in leaves.items()}
            total += float(m.predictive(b, m.shared(b, F64, 'cpu'),
                                        before['counts'][k:k + 1], one,
                                        v[i:i + 1])[0, 0])
    return total


def test_joint_score_is_the_chain_rule(config):
    cfg, labels, values, C = tiny(config)
    st = reference.stats(cfg, values, labels, C)
    want = chain_rule_score(cfg, values, labels, C)
    assert float(reference.joint_score(cfg, st)) == pytest.approx(
        want, rel=1e-10)


def test_choice_scores_are_normalised_and_ordered(mixed_config):
    cfg, labels, values, C = tiny(mixed_config)
    st = reference.stats(cfg, values, labels, C)
    lp, occ = reference.choice_scores(cfg, st, tuple(v[:7] for v in values),
                                      chunk=3)
    assert occ.tolist() == sorted(set(labels.tolist()))
    assert lp.shape == (7, occ.shape[0] + 1)
    assert torch.allclose(torch.exp(lp).sum(1), torch.ones(7, dtype=F64))
    drawn = torch.tensor([int(occ[0]), C - 1, int(occ[-1])])
    assert reference.choice_of(occ, C, drawn).tolist() == [
        0, occ.shape[0], occ.shape[0] - 1]


@pytest.mark.parametrize('seed', range(4))
def test_draw_z_of_sound_and_wrong_draws(seed):
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(3 * torch.randn(4000, 9, generator=g,
                                           dtype=F64), 1)
    sound = torch.multinomial(torch.exp(lp), 1, generator=g)[:, 0]
    assert abs(reference.draw_z(lp, sound)) < 4
    # too sure, and too unlikely
    assert reference.draw_z(lp, torch.argmax(lp, 1)) > 20
    assert reference.draw_z(lp, torch.argmin(lp, 1)) < -20


def test_sample_is_in_the_last_tile():
    g = torch.Generator().manual_seed(1)
    rows = reference.last_tile_sample(100, 30, 10, g, 'cpu')
    assert rows.shape == (10,) and len(set(rows.tolist())) == 10
    assert int(rows.min()) >= 70 and int(rows.max()) < 100


def test_judge():
    ok, rows = reference.judge({'a': 0.0, 'b': 1e-5},
                               {'a': 0, 'b': 1e-4})
    assert ok and rows == [('a', 0.0, 0), ('b', 1e-5, 1e-4)]
    assert not reference.judge({'a': 1.0}, {'a': 0})[0]
    assert not reference.judge({'a': float('nan')}, {'a': 1})[0]


def test_rows_follow_the_seed():
    cfg = problem.config('nich2')
    cfg['rows'] = 1000
    a = problem.make_rows(cfg, 7, 2 ** 40 + 3, 'cpu')
    b = problem.make_rows(cfg, 7, 2 ** 40 + 3, 'cpu')
    c = problem.make_rows(cfg, 7, 2 ** 40 + 4, 'cpu')
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0])
    assert not torch.equal(a[1][0], c[1][0])
    assert int(a[0].max()) < 7 and a[1][0].shape == (1000, 2)
    assert problem.sub_seed(2 ** 40 + 3, 'data') < 2 ** 63
    assert len({problem.sub_seed(9, s) for s in problem.STREAMS}) == len(
        problem.STREAMS)
    assert np.isfinite(a[1][0].numpy()).all()
