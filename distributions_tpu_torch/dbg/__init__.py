"""Reference-style 'dbg' flavor import path (drop-in migration alias).

The reference exposes three flavors (dbg/hp/lp) of one API; in the port
dbg and lp map to the same compat facade over the one torch core (its
execution modes, `__main__.MODES`), and hp is the separate float64 copy
(`distributions_tpu_torch.hp`).
`from distributions_tpu_torch.dbg.models import nich` works like the
reference's `from distributions.dbg.models import nich`.
"""

from distributions_tpu_torch.dbg import models  # noqa: F401
from distributions_tpu_torch.compat import clustering  # noqa: F401
from distributions_tpu_torch.compat import rng as random_module
