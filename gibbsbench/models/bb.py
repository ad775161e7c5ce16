"""Beta-Bernoulli feature columns, in plain PyTorch.  Stats: per slot and
column the heads and the tails, whole numbers compared exactly."""

import torch

FLOAT_LEAVES = ()
INT_LEAVES = ('heads', 'tails')


def shared(block, dtype, device):
    s = block['shared']
    return {k: torch.tensor(float(s[k]), dtype=dtype, device=device)
            for k in ('alpha', 'beta')}


def stats(block, values, assign, C, dtype):
    """{'heads', 'tails'} [C, cols], summed in `dtype`."""
    h = values.to(dtype)
    cols = h.shape[1]
    out = {}
    for name, x in (('heads', h), ('tails', 1 - h)):
        out[name] = torch.zeros((C, cols), dtype=dtype,
                                device=h.device).index_add_(0, assign, x)
    return out


def program_stats(group):
    return ({'heads': group.heads.to(torch.float64),
             'tails': group.tails.to(torch.float64)}, {})


def score_data(block, sh, counts, st):
    a, b = sh['alpha'], sh['beta']
    h, t = st['heads'], st['tails']
    per_col = (torch.lgamma(a + h) - torch.lgamma(a)
               + torch.lgamma(b + t) - torch.lgamma(b)
               - torch.lgamma(a + b + h + t) + torch.lgamma(a + b))
    return per_col.sum(1)


def predictive(block, sh, counts, st, values):
    """Log posterior predictive [m, K] of m rows' `values` [m, cols]."""
    heads = sh['alpha'] + st['heads']                          # [K, cols]
    tails = sh['beta'] + st['tails']
    total = heads + tails
    x = values.to(torch.bool)[:, None, :]                      # [m, 1, cols]
    return torch.where(x, torch.log(heads / total)[None],
                       torch.log(tails / total)[None]).sum(-1)
