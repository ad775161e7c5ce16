"""Object-oriented compatibility facade mirroring the reference's class API
(reference doc/overview.rst:37-211) on top of the port's functional core
(distributions_tpu.compat).

A user of `distributions.lp` can switch imports to
`distributions_tpu_torch.compat` and keep their code shape:

    from distributions_tpu_torch.compat.models import nich
    from distributions_tpu_torch.compat.clustering import PitmanYor
    from distributions_tpu_torch.compat.mixture import MixtureIdTracker

    shared = nich.Shared.from_dict({...})
    group = nich.Group.from_values(shared, values)
    group.add_value(shared, value)
    group.score_value(shared, value)

Shareds and groups live on `config.default_device()`.  Entropy: the
reference hides a single `global_rng` (reference
distributions/rng.py:36-47); here `compat.rng.global_rng` holds a
`torch.Generator` that every drawing call consumes.  `seed_all(n)`
re-seeds it deterministically.
"""

from distributions_tpu_torch.compat import rng  # noqa: F401
from distributions_tpu_torch.compat import models  # noqa: F401
from distributions_tpu_torch.compat import clustering  # noqa: F401
from distributions_tpu_torch.compat import mixture  # noqa: F401
