"""The frozen operation and byte counts of each configuration."""

import pytest

from gibbsbench import problem, roofline


def test_nich2_counts():
    cfg = problem.config('nich2')
    # prior 1 + draw 7 + 2 nich columns x 6
    assert roofline.cell_ops(cfg) == 20
    assert roofline.row_ops(cfg) == 8
    # a row: 2 values + its drawn slot; a slot: 1 + 2 x 4 inputs, 1 + 2 x 2
    # stats
    assert roofline.launch_bytes(cfg, 131072, 1024) == 4 * (
        131072 * 3 + 1024 * (9 + 5))
    ops = 131072.0 * 1024 * 20 + 131072 * 8
    assert roofline.launch_ops(cfg, 131072, 1024) == ops
    assert roofline.launch_bound_s(cfg, 131072, 1024) == (
        ops / 67e12, 'operations')
    assert roofline.sweep_ops(cfg, 8192) == 1048576.0 * 8192 * 20 \
        + 1048576 * 8


def test_bb1_counts():
    cfg = problem.config('bb1')
    # prior 1 + draw 7 + one table column 1
    assert roofline.cell_ops(cfg) == 9
    assert roofline.row_ops(cfg) == 2
    # a row: 1 table index + its slot; a slot: 1 + 2 inputs, 1 + 2 stats
    assert roofline.launch_bytes(cfg, 131072, 1024) == 4 * (
        131072 * 2 + 1024 * (3 + 3))
    assert roofline.launch_bound_s(cfg, 131072, 8192) == (
        (131072.0 * 8192 * 9 + 131072 * 2) / 67e12, 'operations')


def test_mixed_counts(mixed_config):
    cfg = mixed_config
    # niw d=2: 2 + 3 x 3 + 2 = 13; nich 6; bb 1; prior 1; draw 7
    assert roofline.cell_ops(cfg) == 28
    # niw 3 + 1 + 2 + 3, nich 4, bb 2
    assert roofline.row_ops(cfg) == 15
    # a row: 2 niw + 1 nich + 1 table index + its slot; a slot's inputs:
    # 1 + (2 + 3 + 2) + 4 + 2, its stats: 1 + (2 + 3) + 2 + 2
    assert roofline.launch_bytes(cfg, 65536, 8192) == 4 * (
        65536 * 5 + 8192 * (14 + 10))
    bound, by = roofline.launch_bound_s(cfg, 65536, 8192)
    assert by == 'operations'
    assert bound == pytest.approx((65536.0 * 8192 * 28 + 65536 * 15)
                                  / roofline.PEAK_F32_PER_S)


def test_peaks_are_the_data_sheet():
    assert roofline.PEAK_F32_PER_S == 67e12
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
