"""Runtime configuration, read once at import from the same environment
variables as distributions_tpu.config:

  DISTRIBUTIONS_TPU_DEBUG      0 (off, default) .. 3 (paranoid)
                               — gates debug.validate_* checks
  DISTRIBUTIONS_TPU_BLOCK      default Gibbs tile size

and the device the port's factories and entry points use when the caller
names none (`default_device`, `set_default_device`).
"""

import os

import torch


def _int_env(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


DEBUG_LEVEL = _int_env('DISTRIBUTIONS_TPU_DEBUG', 0)
# dpd's dense value capacity when a caller names none; the same number as
# models/dpd.DEFAULT_CAPACITY, which the loaders use.  The JAX package reads
# it from DISTRIBUTIONS_TPU_DPD_CAP, but nothing there reads the result, so
# here it is a plain constant.
DPD_CAPACITY = 64
DEFAULT_BLOCK = _int_env('DISTRIBUTIONS_TPU_BLOCK', 8192)


_DEFAULT_DEVICE = None


def set_default_device(device):
    """Make `device` (a `torch.device` or a string such as 'cpu' or
    'cuda:1') the device used wherever the caller names none.  `None`
    restores the package default, the current CUDA device."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = None if device is None else torch.device(device)


def default_device():
    """The device used where the caller names none: the current CUDA
    device unless `set_default_device` chose another.  The port never
    probes for a card and never falls back to the CPU: on a machine
    without one, creating a tensor on the default device raises PyTorch's
    own error."""
    if _DEFAULT_DEVICE is None:
        return torch.device('cuda')
    return _DEFAULT_DEVICE


def resolve_device(device):
    """`device` as a `torch.device`, or the default when it is None."""
    if device is None:
        return default_device()
    return torch.device(device)


def same_device(a, b):
    """True when two `torch.device`s name one device ('cuda' and the
    current 'cuda:N' count as the same)."""
    if a.type != b.type:
        return False
    if a.type != 'cuda':
        return True

    def index(d):
        return torch.cuda.current_device() if d.index is None else d.index
    return index(a) == index(b)
