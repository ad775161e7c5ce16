"""hp-flavor models: an INDEPENDENT double-precision numpy/scipy
implementation of the seven conjugate feature models.

This package fills the role of the reference's Cython `hp` flavor
(distributions/hp/models/ — an implementation genuinely distinct from both
the pure-python dbg and the C++ lp flavors, kept honest by flavor-agreement
tests, reference tests/test_model_flavors.py:40-136).  Here the torch core
(`distributions_tpu_torch.models`) is the production flavor and this
package is the independent cross-check: scalar, float64, scipy.stats-backed
where possible, importing nothing from the core.

Each module exports the same functional contract as the core
(models/base.py): NAME, EXAMPLES, Value, shared_from_dict/to_dict,
group_from_dict/to_dict, group_init, add_value, add_repeated_value,
remove_value, merge, score_value, score_data, sampler_init, sampler_eval,
sample_value, sample_group (+ plus_group where conjugate) — with numpy
`Generator` objects in place of torch generators.

The reference's hp flavor covered only dd, gp, nich (distributions/hp/
models/); this one covers all seven.
"""

from distributions_tpu_torch.hp.models import (  # noqa: F401
    bb, bnb, dd, dpd, gp, nich, niw)

MODULES = {
    'bb': bb, 'bnb': bnb, 'dd': dd, 'dpd': dpd,
    'gp': gp, 'nich': nich, 'niw': niw,
}
