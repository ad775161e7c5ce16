"""hp flavor: an INDEPENDENT double-precision numpy/scipy implementation
of the model API, a copy of distributions_tpu.hp.

The reference ships three implementations of one API (dbg: pure python,
hp: Cython, lp: Cython-wrapped C++) and tests them against each other
(reference tests/test_model_flavors.py:40-136).  In the port the torch core
(`distributions_tpu_torch.models`, `distributions_tpu_torch.clustering`) is
the production implementation; this package is the independent
cross-check: scalar float64, scipy.stats-backed, sharing no code with the
core and importing no torch (enforced by tests/test_torch_flavors.py).
Its modules are those of distributions_tpu.hp with the imports rewritten,
so the two give bitwise the same results.

Surface:
- `hp.models.{bb,bnb,dd,dpd,gp,nich,niw}` — functional model modules with
  the core contract (numpy Generators in place of generators or keys)
- `hp.clustering.{PitmanYor,LowEntropy}` — sequential-seating scorers and
  an exact partition-function DP
- `hp.random`, `hp.special` — float64 substrate

Class-based migration facades (Shared/Group/Sampler objects) live in
`distributions_tpu_torch.compat`; the `dbg`/`lp` alias namespaces re-export
them.  This package is the numerical oracle, not a facade.
"""

from distributions_tpu_torch.hp import special  # noqa: F401
from distributions_tpu_torch.hp import random  # noqa: F401
from distributions_tpu_torch.hp import clustering  # noqa: F401
from distributions_tpu_torch.hp import models  # noqa: F401
from distributions_tpu_torch.hp.models import MODULES  # noqa: F401
from distributions_tpu_torch.hp.clustering import (  # noqa: F401
    PitmanYor, LowEntropy, count_assignments)
