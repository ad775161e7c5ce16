"""Conjugate component models, one module per model of
distributions_tpu.models.  Each holds the collapsed-Gibbs API, the
samplers and `group_from_dict`/`group_to_dict`; the `param_*` functions of
the gradient backends are still to port (ROADMAP Queue 1 item 15)."""

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
