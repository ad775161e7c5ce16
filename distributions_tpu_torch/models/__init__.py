"""Conjugate component models, one module per model of
distributions_tpu.models.  Each holds the collapsed-Gibbs API; samplers,
`param_*` and `group_from_dict`/`group_to_dict` are still to port."""

from distributions_tpu_torch.models import bb, bnb, dd, dpd, gp, nich, niw

MODULES = {
    'bb': bb,
    'dd': dd,
    'dpd': dpd,
    'gp': gp,
    'bnb': bnb,
    'nich': nich,
    'niw': niw,
}

__all__ = ['bb', 'dd', 'dpd', 'gp', 'bnb', 'nich', 'niw', 'MODULES']
