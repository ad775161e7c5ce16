from distributions_tpu_torch.compat.clustering import (  # noqa: F401
    PitmanYor, LowEntropy, count_assignments)
