"""The port's nich model against distributions_tpu.models.nich, on the
model's EXAMPLES, and the JAX <-> port state converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributions_tpu import clustering as jcl, mixture as jmx
from distributions_tpu.models import nich as jnich
from distributions_tpu_torch import config
from distributions_tpu_torch import convert
from distributions_tpu_torch import testing
from distributions_tpu_torch.models import nich as tnich

torch.set_num_threads(1)
config.set_default_device('cpu')

# rtol 1e-5 / atol 1e-5: the same f32 formulas, with lgamma, log and
# log1p differing by ulps between torch and XLA
RTOL, ATOL = 1e-5, 1e-5

EXAMPLE = jnich.EXAMPLES[0]


def _groups():
    """A [K=4] batch of groups over the example values (one empty)."""
    values = np.asarray(EXAMPLE['values'], np.float32)
    ids = np.arange(values.size, dtype=np.int32) % 3
    jshared = jnich.shared_from_dict(EXAMPLE['shared'])
    jgroup = jnich.from_values_grouped(jshared, values, ids, 4)
    tshared = tnich.shared_from_dict(EXAMPLE['shared'])
    tgroup = tnich.Group(*(convert.tensor(np.asarray(x)) for x in jgroup))
    return values, jshared, jgroup, tshared, tgroup


def _close(got, want):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_plus_group():
    _, jsh, jg, tsh, tg = _groups()
    for got, want in zip(tnich.plus_group(tsh, tg), jnich.plus_group(jsh, jg)):
        _close(got, want)


def test_score_value_batch():
    values, jsh, jg, tsh, tg = _groups()
    _close(tnich.score_value_batch(tsh, tg, torch.from_numpy(values)),
           jnich.score_value_batch(jsh, jg, values))


@pytest.mark.parametrize('value', EXAMPLE['values'])
def test_score_value(value):
    _, jsh, jg, tsh, tg = _groups()
    _close(tnich.score_value(tsh, tg, value),
           jnich.score_value(jsh, jg, value))


def test_score_data():
    _, jsh, jg, tsh, tg = _groups()
    _close(tnich.score_data(tsh, tg), jnich.score_data(jsh, jg))


def test_merge_unmerge_round_trip():
    values, jsh, jg, tsh, tg = _groups()
    ids = np.array([3, 0, 0, 1, 2, 3, 1, 0, 2], np.int32)
    tsrc = tnich.from_values_grouped(tsh, torch.from_numpy(values),
                                     torch.from_numpy(ids), 4)
    jsrc = jnich.from_values_grouped(jsh, values, ids, 4)
    merged = tnich.merge(tsh, tg, tsrc)
    for got, want in zip(merged, jnich.merge(jsh, jg, jsrc)):
        _close(got, want)
    back = tnich.unmerge(tsh, merged, tsrc)
    assert torch.equal(back.count, tg.count)
    # mean and M2 come back to f32 rounding of the merged magnitudes
    np.testing.assert_allclose(back.mean.numpy(), tg.mean.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back.count_times_variance.numpy(),
                               tg.count_times_variance.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_row_stat_columns_and_tile():
    values, jsh, _, tsh, _ = _groups()
    got = tnich.row_stat_columns(tsh, torch.from_numpy(values))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnich.row_stat_columns(jsh,
                                                                    values)))
    tile = tnich.row_stats_to_tile(tsh, got.sum(0, keepdim=True))
    assert tile.count.dtype == torch.int32 and int(tile.count[0]) == 9


def test_convert_round_trip():
    values, labels = testing.nich_problem(256, n_clusters=5)
    spec = jmx.make_spec([(jnich, 2)], capacity=16)
    py = jcl.PitmanYor.from_dict(testing.PY)
    shareds = (jnich.shared_from_dict(testing.NICH_SHARED),)
    state = jmx.state_from_assignments(spec, py, shareds,
                                       (jnp.asarray(values),),
                                       jnp.asarray(labels))
    ref = jax.tree_util.tree_map(np.asarray, state)
    port_state = convert.state(spec, ref)
    assert port_state.counts.dtype == torch.int32
    assert port_state.alive.dtype == torch.bool
    assert port_state.groups[0].mean.dtype == torch.float32
    assert isinstance(port_state.groups[0], tnich.Group)
    back = convert.to_numpy(port_state)
    for got, want in zip(jax.tree_util.tree_leaves(tuple(back)),
                         jax.tree_util.tree_leaves(tuple(ref))):
        np.testing.assert_array_equal(got, want)
    port_spec = convert.spec(spec)
    assert port_spec.blocks[0].module is tnich
    assert port_spec.capacity == 16
    port_py = convert.cl_model(jax.tree_util.tree_map(np.asarray, py))
    assert port_py.to_dict() == py.to_dict()
    port_sh = convert.shareds(spec, jax.tree_util.tree_map(np.asarray,
                                                           shareds))
    assert tnich.shared_to_dict(port_sh[0]) == jnich.shared_to_dict(
        shareds[0])
