"""The stat sums of K1 and K2 -- the stage that csrc/fused_stats.cuh runs on
the card after the draw, whose plain twins run here -- against the JAX
package.

Where the slots can come out of a draw, the JAX package's
fused_score_sample_stats / fused_mixed_score_sample_stats run in Pallas
interpret mode, as its own CPU tests run them (at 1024 slots: one
interpret-mode trace a layout), on the same operands as the port's twins,
with 'gumbel_host' noise that forces each row's draw: +1e4 on the row's
chosen slot and 0 elsewhere, with zero CRP scores so that every slot is
finite.  The slot patterns are those the card's kernel is held to in
chip_smoke.py's `kernel_stats` phase: every row in one slot, uniform
slots, Pitman-Yor-skewed slots, K2 with niw, nich and table columns
(niw2mix) and with table columns alone (bbddgp: no float sums).  Every
pattern at 1024 and 8192 slots, slots a draw cannot give (outside [0, C))
and ragged row counts go through the stage alone (`bench_kernels.
stat_sums` / `mixed_stat_sums`, the twins on the CPU) against the JAX
package's `segment_sum` of the same features.

Tolerances: float sums are f32 sums of the same rows in another order
(rtol 1e-5, atol 1e-3, as tests/test_fused_mixed.py holds the JAX kernel);
count tables are integers and equal exactly."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.models import base as jbase, nich as jnich
from distributions_tpu.ops import gibbs as jg, pallas_kernels as pk
from distributions_tpu_torch import config, convert, testing
from distributions_tpu_torch.models import MODULES
from distributions_tpu_torch.ops import bench_kernels as bk
from distributions_tpu_torch.ops import fused_kernels as fk, gibbs as tg

torch.set_num_threads(1)
config.set_default_device('cpu')

R, BLOCK_ROWS = 256, 128
SLOTS = (1024, 8192)
DRAWN = ('one', 'uniform', 'pitman_yor')
FORCE = 1e4
SUM_RTOL, SUM_ATOL = 1e-5, 1e-3
JAX_MODELS = {name: importlib.import_module('distributions_tpu.models.'
                                            + name) for name in MODULES}


def _slots(kind, B, C, seed=0):
    """int32 [B]: every row in slot C // 3, uniform over C, Pitman-Yor
    {alpha 1, d 0.1} stick-breaking weights cut to C, or a quarter of the
    rows outside [0, C) (some far out)."""
    rng = np.random.RandomState(seed + C)
    if kind == 'one':
        return np.full(B, C // 3, np.int32)
    if kind == 'uniform':
        return rng.randint(0, C, B).astype(np.int32)
    if kind == 'pitman_yor':
        k = np.arange(1, C + 1)
        v = rng.beta(0.9, 1.0 + 0.1 * k)
        w = v * np.concatenate([[1.0], np.cumprod(1.0 - v)[:-1]])
        return rng.choice(C, B, p=w / w.sum()).astype(np.int32)
    a = rng.randint(-C // 8, C + C // 8, B).astype(np.int32)
    a[::7] = -1000000
    a[1::11] = C + 100000
    return a


def _forcing_noise(slots, C):
    noise = np.zeros((len(slots), C), np.float32)
    noise[np.arange(len(slots)), slots] = FORCE
    return noise


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=SUM_RTOL, atol=SUM_ATOL)


def _nich_features(v):
    return np.concatenate([np.ones_like(v), v, v * v], 1)


@functools.lru_cache(maxsize=None)
def _nich(C):
    """K1's operands at C slots: R rows of 2 nich columns, the JAX
    package's coefficient rows of the state of their labels, and zero CRP
    scores."""
    values, labels = testing.nich_problem(R, n_clusters=40)
    jspec = jmx.make_spec([(jnich, 2)], capacity=C)
    jpy = jcl.PitmanYor.from_dict(testing.PY)
    jsh = (jnich.shared_from_dict(testing.NICH_SHARED),)
    jst = jmx.state_from_assignments(jspec, jpy, jsh, (jnp.asarray(values),),
                                     jnp.asarray(labels))
    jco = pk.nich_coeffs_v2(jsh[0], jst.groups[0])
    return values, jco, np.zeros(C, np.float32)


@pytest.mark.parametrize('kind', DRAWN)
def test_k1_stat_sums_match_jax(kind, C=SLOTS[0]):
    values, jco, cl = _nich(C)
    slots = _slots(kind, R, C)
    noise = _forcing_noise(slots, C)
    ja, jsums = pk.fused_score_sample_stats(
        0, jnp.asarray(values), jnp.asarray(cl), jco, (2,),
        block_rows=BLOCK_ROWS, interpret=True, sampling='gumbel_host',
        noise=jnp.asarray(noise))
    ta, tsums = fk.fused_score_sample_stats(
        0, torch.from_numpy(values), torch.from_numpy(cl),
        torch.from_numpy(np.array(jco)), (2,), sampling='gumbel_host',
        noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(np.asarray(ja), slots)
    np.testing.assert_array_equal(ta.numpy(), slots)
    assert tsums.shape == (C, 6)
    _close(tsums, jsums)
    # the stage alone on the same slots is the twin's own sum
    assert torch.equal(bk.stat_sums(torch.from_numpy(values), ta, C), tsums)


# the stage alone: every pattern at both slot counts, slots outside
# [0, C), ragged row counts
STAGE_CASES = [('outside', R), ('uniform', R - 3), ('pitman_yor', R),
               ('one', 33), ('pitman_yor', 1)]


@pytest.mark.parametrize('kind,B', STAGE_CASES)
@pytest.mark.parametrize('C', SLOTS)
def test_k1_stat_stage_slots_outside_and_ragged(C, kind, B):
    """Rows whose slot lies outside [0, C) add nothing; B need not be a
    multiple of anything."""
    values = np.random.RandomState(B).randn(B, 3).astype(np.float32)
    slots = _slots(kind, B, C)
    got = bk.stat_sums(torch.from_numpy(values), torch.from_numpy(slots), C)
    feats = _nich_features(values)
    _close(got, jbase.segment_sum(jnp.asarray(feats), jnp.asarray(slots), C))
    inside = (slots >= 0) & (slots < C)
    want = np.zeros((C, 9))
    np.add.at(want, slots[inside], feats[inside].astype(np.float64))
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _mixed(kind, C):
    """K2's operands at C slots: the JAX package's layout and kernel
    inputs for R rows of a mixed problem of layout `kind`, zero CRP
    scores, and the port's layout of the same rows."""
    p = testing.mixed_problem(R, C, seed=1, kind=kind, n_clusters=40)
    jspec, jpy, jsh = testing.build_problem(
        p, JAX_MODELS, jmx.make_spec, jcl.PitmanYor.from_dict)
    jv = tuple(jnp.asarray(v) for v in p['values'])
    jst = jmx.state_from_assignments(jspec, jpy, jsh, jv,
                                     jnp.asarray(p['labels']))
    jlay = jg._mixed_static_layout(jspec, jv, None)
    jin = jg._build_fused_inputs(
        jspec, jlay.nich_blocks, jlay.quad_blocks, jlay.table_blocks,
        jlay.V, jsh, jlay.supports_dev, jst)
    spec = convert.spec(jspec)
    lay = tg._mixed_static_layout(spec, tuple(torch.from_numpy(v)
                                              for v in p['values']))
    col_groups = tuple(jspec.blocks[i].cols for i in jlay.nich_blocks)
    return jlay, jin, col_groups, lay


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize('kind', DRAWN)
@pytest.mark.parametrize('layout', ['niw2mix', 'bbddgp'])
def test_k2_stat_sums_match_jax(layout, kind, C=SLOTS[0]):
    jlay, (jco, jqco, jtab), col_groups, lay = _mixed(layout, C)
    slots = _slots(kind, R, C)
    noise = _forcing_noise(slots, C)
    cl = np.zeros(C, np.float32)
    ja, jsums, jtcounts, jqsums = pk.fused_mixed_score_sample_stats(
        0, jlay.nich_vals, jlay.table_idx, jnp.asarray(cl), jco, jtab,
        col_groups, block_rows=BLOCK_ROWS, interpret=True,
        sampling='gumbel_host', qvalues=jlay.quad_vals, qcoeffs=jqco,
        quad_groups=jlay.quad_groups, noise=jnp.asarray(noise),
        table_vs=jlay.table_vs)
    vtot = sum(lay.table_vs)
    ta, sums, tcounts, qsums = fk.fused_mixed_score_sample_stats(
        0, lay.nich_vals, lay.table_idx, torch.from_numpy(cl), _t(jco),
        _t(np.asarray(jtab)[:vtot]), col_groups, sampling='gumbel_host',
        qvalues=lay.quad_vals, qcoeffs=_t(jqco),
        quad_groups=lay.quad_groups, noise=torch.from_numpy(noise),
        table_vs=lay.table_vs)
    np.testing.assert_array_equal(np.asarray(ja), slots)
    np.testing.assert_array_equal(ta.numpy(), slots)
    # counts exactly, at the packed offsets (the JAX table pads Vtot)
    np.testing.assert_array_equal(tcounts.numpy(),
                                  np.asarray(jtcounts)[:, :vtot])
    if col_groups:
        _close(sums, jsums)
    else:
        assert sums.shape == (C, 0)
    assert qsums.shape == (C, fk.quad_stat_dim(lay.quad_groups))
    if lay.quad_groups:
        _close(qsums, jqsums)
    # the stage alone on the same slots gives the twin's own outputs
    alone = bk.mixed_stat_sums(lay.nich_vals, lay.quad_vals, lay.table_idx,
                               ta, C, col_groups, lay.quad_groups,
                               lay.table_vs)
    for x, y in zip(alone, (sums, tcounts, qsums)):
        assert torch.equal(x, y)


@pytest.mark.parametrize('kind,B', STAGE_CASES)
@pytest.mark.parametrize('C', SLOTS)
@pytest.mark.parametrize('layout', ['niw2mix', 'bbddgp'])
def test_k2_stat_stage_slots_outside_and_ragged(layout, C, kind, B):
    """The stage alone against the JAX package's segment_sum of the same
    features and one-hot count tables; rows outside [0, C) add nothing.
    (The rows are those of the 1024-slot problem at either slot count.)"""
    _, _, col_groups, lay = _mixed(layout, SLOTS[0])

    def rows(t):
        return None if t is None else t[:B].contiguous()
    slots = _slots(kind, B, C)
    sums, tcounts, qsums = bk.mixed_stat_sums(
        rows(lay.nich_vals), rows(lay.quad_vals), rows(lay.table_idx),
        torch.from_numpy(slots), C, col_groups, lay.quad_groups,
        lay.table_vs)
    js = jnp.asarray(slots)
    if col_groups:
        _close(sums, jbase.segment_sum(
            jnp.asarray(_nich_features(lay.nich_vals[:B].numpy())), js, C))
    if lay.quad_groups:
        q = lay.quad_vals[:B].numpy()
        feats = np.concatenate(
            [np.ones((B, 1), np.float32), q,
             (q[:, [0, 0, 1]] * q[:, [0, 1, 1]])], 1)
        assert lay.quad_groups == ((1, 2),)
        _close(qsums, jbase.segment_sum(jnp.asarray(feats), js, C))
    vtot = sum(lay.table_vs)
    onehot = np.zeros((B, vtot), np.float32)
    off = np.concatenate([[0], np.cumsum(lay.table_vs)[:-1]]).astype(int)
    for j in range(len(lay.table_vs)):
        onehot[np.arange(B), lay.table_idx[:B, j].numpy() + off[j]] = 1.0
    np.testing.assert_array_equal(
        tcounts.numpy(),
        np.asarray(jbase.segment_sum(jnp.asarray(onehot), js, C)))


def test_stat_blocks_mirror_the_kernel_rule():
    """stat_blocks (which sizes the partials) follows csrc/fused_stats.cuh:
    one block per SM of the H100 while a block takes at most
    STAT_MAX_ROWS rows, in multiples of 32."""
    assert fk.STAT_GRID == 132 and fk.STAT_MAX_ROWS == 1024
    for B, want in ((1, 1), (32, 1), (33, 2), (4224, 132), (16384, 128),
                    (65536, 128), (131072, 128), (131073, 129),
                    (1048576, 1024)):
        assert fk.stat_blocks(B) == want, B
    partials, bmask = fk.stat_scratch(1000, 70, 6, torch.device('cpu'))
    assert partials.shape == (32, 6, 70) and bmask.shape == (32, 3)
    assert bmask.dtype == torch.int32
    assert 'fused_stats.cuh' in fk._HEADERS


def test_tree_compare_holds_stat_sums_within_tolerance():
    """benchmarks/tree_compare.py holds the stat sums of two trees to each
    other within the tolerance above (a redesigned stage may sum in
    another order), K2's count tables exactly."""
    from distributions_tpu_torch.benchmarks import tree_compare as tc
    assert (tc.SUM_RTOL, tc.SUM_ATOL) == (SUM_RTOL, SUM_ATOL)
    assert tc.STAT_KERNELS == ('stat_partials', 'stat_reduce')
    sums = torch.linspace(-5.0, 5.0, 60).reshape(10, 6)
    counts = torch.arange(20.0).reshape(10, 2)
    near = sums + 5e-4
    assert tc.sums_agree([sums], [near], 'K1 gumbel')
    assert not tc.sums_agree([sums], [sums + 1e-2], 'K1 gumbel')
    assert tc.sums_agree([sums, counts, sums], [near, counts, near],
                         'K2 gumbel')
    assert not tc.sums_agree([sums, counts, sums],
                             [sums, counts + 1e-6, sums], 'K2 gumbel')
    tile = tc.mixed_tile_inputs('niw2mix', rows=300)
    assert tile['values'].shape == (300, 1)
    assert tile['qvalues'].shape == (300, 2) and tile['table_vs'] == (2,)
