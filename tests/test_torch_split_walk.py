"""The slot-split walk of the kernels K1, K2, K3, B5, K4 and K5
(csrc/fused_split.cuh): its constants against the sources' #defines, the
build of its compile-time variants, and the K1, K4 and K5 tiles that
benchmarks/tree_compare.py times off the main path."""

import os
import re

import pytest
import torch

from distributions_tpu_torch import config
from distributions_tpu_torch.ops import fused_kernels as fk

torch.set_num_threads(1)
config.set_default_device('cpu')


def test_constants_match_the_source():
    with open(os.path.join(fk._CSRC, 'fused_split.cuh')) as f:
        defines = dict(re.findall(r'^#define (\w+) (\d+)\b', f.read(), re.M))
    assert int(defines['SPLIT_SLICES']) == fk.SPLIT_SLICES
    assert int(defines['SPLIT_ROWS']) == fk.SPLIT_ROWS
    assert int(defines['SPLIT_THREADS']) == fk.SPLIT_THREADS
    assert int(defines['SPLIT_PACK']) == fk.SPLIT_PACK
    # a warp walks one slice (the lane variant: a row's slices sit in one
    # warp); a record is whole 16-byte loads
    assert fk.SPLIT_THREADS == 32 * fk.SPLIT_SLICES
    assert 32 % fk.SPLIT_SLICES == 0
    assert fk.SPLIT_PACK * 4 == 16
    assert 'fused_split.cuh' in fk._HEADERS
    for name in ('fused_v2.cu', 'fused_v3.cu', 'score_sample_v1.cu'):
        with open(os.path.join(fk._CSRC, name)) as f:
            assert '#include "fused_split.cuh"' in f.read()


def test_split_shapes_match_the_source():
    """K2's and K3's shape names are fused_v3.cu's SHAPE_* codes in
    order, and each code is dispatched."""
    with open(os.path.join(fk._CSRC, 'fused_v3.cu')) as f:
        src = f.read()
    codes = {name.lower(): int(code) for name, code in
             re.findall(r'\bSHAPE_(\w+) = (\d+)', src)}
    assert codes == {name: i for i, name in enumerate(fk.SPLIT_SHAPES)}
    for name in fk.SPLIT_SHAPES[1:]:
        assert 'case SHAPE_%s:' % name.upper() in src


def test_k2_caps_match_the_source():
    """fused_kernels' caps of K2's and K3's layouts are fused_v3.cu's
    MAX_* defines, and the split walk's niw dimension fused_split.cuh's."""
    with open(os.path.join(fk._CSRC, 'fused_v3.cu')) as f:
        defines = dict(re.findall(r'^#define (MAX_\w+) (\d+)\b', f.read(),
                                  re.M))
    assert {name: int(v) for name, v in defines.items()} == {
        'MAX_GROUPS': fk.MAX_GROUPS, 'MAX_COLS': fk.MAX_COLS,
        'MAX_QVALS': fk.MAX_QVALS, 'MAX_D': fk.MAX_D,
        'MAX_TABLE_COLS': fk.MAX_TABLE_COLS}
    with open(os.path.join(fk._CSRC, 'fused_split.cuh')) as f:
        split = dict(re.findall(r'^#define (SPLIT_MAX_\w+) (\d+)\b',
                                f.read(), re.M))
    assert int(split['SPLIT_MAX_D']) == fk.MAX_D
    assert int(split['SPLIT_MAX_QUAD']) == fk.MAX_QVALS
    assert int(split['SPLIT_MAX_NICH']) == fk.MAX_COLS


def test_v1_caps_match_the_source():
    """K4 and K5 take the wrappers' caps of nich and table columns, and
    launch only the split walk."""
    with open(os.path.join(fk._CSRC, 'score_sample_v1.cu')) as f:
        src = f.read()
    defines = dict(re.findall(r'^#define (\w+) (\d+)\b', src, re.M))
    assert int(defines['MAX_COLS']) == fk.MAX_COLS
    assert int(defines['MAX_TABLE_COLS']) == fk.MAX_TABLE_COLS
    assert re.findall(r'(\w+)\s*<<<', src) == ['kern']
    assert '__global__' not in src


def test_build_keeps_compile_time_variants_apart(tmp_path, monkeypatch):
    """`build(name, defines)` gives nvcc the -D flags and a library of its
    own; the wrappers' default library is built without them."""
    started = []

    class Proc:
        def __init__(self, cmd, **kwargs):
            started.append(cmd)

    monkeypatch.setattr(fk, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(fk, '_nvcc', lambda: 'nvcc')
    monkeypatch.setattr(fk.subprocess, 'Popen', Proc)
    default = fk._start_build('fused_v3')
    variant = fk._start_build('fused_v3', ('SPLIT_ROWS=4',))
    assert default[1] != variant[1]
    assert '-DSPLIT_ROWS=4' in started[1]
    assert not any(a.startswith('-D') for a in started[0])


@pytest.mark.parametrize('groups', [(2,), (3,), (2, 3)])
def test_tree_compare_nich_tiles(groups):
    """The K1 tiles that benchmarks/tree_compare.py times off the main
    path: one nich block of coefficients per group, in the wrapper's
    layout."""
    from distributions_tpu_torch.benchmarks import tree_compare
    t = tree_compare.nich_tile_inputs(groups, rows=500, slots=32)
    assert t['col_groups'] == groups
    assert t['values'].shape == (500, sum(groups))
    assert t['coeffs'].shape == (sum(2 + 2 * c for c in groups), 32)
    a, s = fk.fused_score_sample_stats(5, t['values'], t['cl_scores'],
                                       t['coeffs'], groups,
                                       sampling='argmax')
    assert a.shape == (500,) and int(a.min()) >= 0 and int(a.max()) < 32


@pytest.mark.parametrize('cols,n_tab', [(2, 0), (0, 3), (3, 5)])
def test_v1_random_inputs(cols, n_tab):
    """The random K4 / K5 inputs of the card tests and tree_compare: the
    wrapper's layout, supports within V, and the twin draws live slots."""
    from distributions_tpu_torch import testing
    B, C, V = 300, 40, 6
    values, idx, cls, coeffs, tables = testing.v1_random_inputs(
        B, C, cols, n_tab, V, seed=1)
    if cols:
        assert values.shape == (B, cols) and coeffs.shape == (4 * cols, C)
        assert bool((coeffs[1::4] < 0).all() and (coeffs[2::4] > 0).all())
    else:
        assert values is None and coeffs is None
    if n_tab:
        assert idx.dtype == torch.int32 and tables.shape == (n_tab, V, C)
        assert int(idx.min()) >= 0 and int(idx.max()) < V
    assert bool(torch.isinf(cls[::10]).all())
    a = fk.mixed_score_sample(3, values, idx, cls, coeffs, tables,
                              sampling='argmax')
    assert a.shape == (B,) and bool((a % 10 != 0).all())
