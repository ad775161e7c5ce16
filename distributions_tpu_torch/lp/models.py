from distributions_tpu_torch.compat.models import (  # noqa: F401
    bb, bnb, dd, dpd, gp, nich, niw, MODULES)

# register the synthetic namespaces as real dotted submodules so
# `import distributions_tpu_torch.<flavor>.models.<name>` / importlib works
# the way the reference's auto-discovery imports flavors
# (distributions/tests/util.py:60-79)
import sys as _sys
for _name, _mod in MODULES.items():
    _sys.modules[__name__ + '.' + _name] = _mod
