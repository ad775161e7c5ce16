"""Build for distributions_tpu.

Pure-python + JAX by default; `python setup.py build_ext --inplace` (or a
normal pip build) additionally compiles the native C++ helpers:

- distributions_tpu.io._framing — length-prefixed stream framing
  (native/framing.cc), the host-side checkpoint-stream fast path.
- distributions_tpu_torch.io._framing — the same source built for the
  PyTorch/CUDA port's io/stream.py.

The reference gates its native builds similarly (reference setup.py:104-167:
pip-only installs get the pure-python dbg flavor; cython builds add hp/lp).
"""

from setuptools import setup, Extension, find_packages

ext_modules = [
    Extension(
        'distributions_tpu.io._framing',
        sources=['native/framing.cc'],
        extra_compile_args=['-O3', '-std=c++17'],
        optional=True,
    ),
    Extension(
        'distributions_tpu_torch.io._framing',
        sources=['native/framing.cc'],
        extra_compile_args=['-O3', '-std=c++17'],
        optional=True,
    ),
]

setup(
    name='distributions_tpu',
    version='0.1.0',
    description=('TPU-native probabilistic-inference engine: conjugate '
                 'models, clustering priors, collapsed Gibbs / SMC / HMC '
                 'on JAX'),
    packages=find_packages(include=['distributions_tpu*']),
    # the PyTorch/CUDA port builds its kernels from these sources with nvcc
    # at first use
    package_data={'distributions_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh',
                                             'io/schema.proto']},
    ext_modules=ext_modules,
    python_requires='>=3.10',
    install_requires=['jax', 'numpy', 'scipy'],
    extras_require={'torch': ['torch', 'numpy']},
)
