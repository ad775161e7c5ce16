"""Global entropy source for the compat facade.

The reference pairs a numpy RNG with a wrapped C++ rng_t in a singleton
(reference distributions/rng.py:36-47, distributions/global_rng.pyx:28-33).
Here the singleton holds one CPU `torch.Generator`, consumed in order by
every call that draws; a sampler whose parameters live on the card seeds a
generator there from it (the port's rule, see `random`).  The functional
core never touches it (explicit generators only)."""

import torch


class GlobalRng(object):
    def __init__(self, seed=0):
        self._generator = torch.Generator()
        self._generator.manual_seed(seed)

    def seed(self, seed):
        self._generator.manual_seed(seed)

    def next_generator(self):
        return self._generator


global_rng = GlobalRng()


def seed_all(seed):
    """Deterministic re-seed (analog of reference tests/util.py:50-57)."""
    global_rng.seed(seed)


def get_generator():
    """The generator the facade's draws consume."""
    return global_rng.next_generator()


# the JAX facade's name: code written against it keeps running, and gets
# the generator where it got a key
get_key = get_generator
