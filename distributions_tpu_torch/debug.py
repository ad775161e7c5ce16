"""Invariant validation (distributions_tpu.debug): host-side checks run
between sweeps when config.DEBUG_LEVEL > 0.  Each check raises
AssertionError with a description on violation."""

import numpy as np

from distributions_tpu_torch import config


def _np(t):
    return t.detach().cpu().numpy()


def validate_state(spec, state):
    """Mixture-state invariants of the masked layout."""
    if config.DEBUG_LEVEL < 1:
        return
    counts = _np(state.counts)
    alive = _np(state.alive)
    assert counts.shape == (spec.capacity,)
    assert (counts >= 0).all(), 'negative group count'
    assert int(counts.sum()) == int(state.sample_size), \
        'sample_size != sum(counts)'
    assert alive[counts > 0].all(), 'nonempty slot not alive'
    assert int((alive & (counts == 0)).sum()) >= 1, 'missing empty groups'
    if config.DEBUG_LEVEL >= 2:
        # dead slots must be bitwise-empty (reuse hygiene)
        for g in state.groups:
            for leaf in g:
                assert (_np(leaf)[~alive] == 0).all(), 'dead slot has residue'


def validate_assignments(spec, state, assignments):
    if config.DEBUG_LEVEL < 1:
        return
    a = _np(assignments)
    counts = _np(state.counts)
    assert (a >= 0).all() and (a < spec.capacity).all(), 'slot out of range'
    bc = np.bincount(a, minlength=spec.capacity)
    assert bc.tolist() == counts.tolist(), \
        'assignments inconsistent with counts'


def validate_dpd_shared(shared):
    """dpd stick invariants: beta0 and every stick non-negative, the
    sticks and beta0 summing to 1."""
    if config.DEBUG_LEVEL < 1:
        return
    betas = _np(shared.betas)
    beta0 = float(shared.beta0)
    assert beta0 >= -1e-5, 'negative beta0'
    assert betas.min() >= 0, 'negative stick'
    total = betas.sum() + beta0
    assert abs(total - 1.0) < 1e-3, 'sticks do not sum to 1: %f' % total
