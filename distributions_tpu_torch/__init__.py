"""distributions_tpu_torch: the PyTorch/CUDA port of distributions_tpu.

The port mirrors the JAX package's public layout module for module: the
same module names, function names, argument order and NamedTuple
containers, with tensor leaves of the same dtypes (int32 counts and
assignments, float32 statistics).  Where the JAX package takes a
`jax.random` key, the port takes a `torch.Generator`; every function
works on the device of the tensors it is given, and a factory or entry
point that is given none works on `config.default_device()`, the CUDA
device unless `config.set_default_device` chose another.

The collapsed-Gibbs main path (`inference.runner.run_gibbs` with
`use_pallas=True`, through `ops.gibbs.sweep_blocked_pallas_fused_mixed`)
runs on hand-written CUDA kernels for NVIDIA Hopper, built with nvcc at
first use: `csrc/fused_v2.cu` for nich-only specs and `csrc/fused_v3.cu`
for any mix of nich, niw and the discrete models.  On CPU tensors it runs
the kernels' plain-PyTorch twins (`ops.fused_kernels`).

The package imports torch and never jax.
"""

__version__ = '0.1.0'

from distributions_tpu_torch import special  # noqa: F401
from distributions_tpu_torch import random  # noqa: F401
from distributions_tpu_torch import util  # noqa: F401
