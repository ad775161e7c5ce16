"""One model, six inference backends, on the PyTorch/CUDA port: the twin
of gmm_backends.py.

Fits the same Pitman-Yor Gaussian mixture to synthetic data with collapsed
Gibbs, an MH sweep, HMC, NUTS, ADVI and SMC — all driven from the same
Shared hyperparameters and (for the gradient backends) the same log-prob
graph — and reports seconds and cluster purity for each.  It runs on the
card, or on the CPU with --cpu.

    PYTHONPATH=. python examples/gmm_backends_torch.py [--rows 512] [--cpu]
"""

import argparse
import time

import numpy as np
import torch

from distributions_tpu_torch import clustering, config, mixture as mx
from distributions_tpu_torch.inference import hmc, logprob, smc, vi
from distributions_tpu_torch.models import nich
from distributions_tpu_torch.ops import gibbs, mh

# the reference run's lengths (gmm_backends.py)
LENGTHS = {
    'gibbs_sweeps': 15,
    'mh_sweeps': 40,
    'hmc': {'num_samples': 300, 'num_warmup': 500, 'num_leapfrog': 24},
    'nuts': {'num_samples': 200, 'num_warmup': 300, 'max_depth': 6},
    'advi': {'num_steps': 1000},
}


def _last(samples):
    """The last draw of a logprob params tree with a leading sample axis."""
    return {'sticks': samples['sticks'][-1],
            'blocks': tuple({k: v[-1] for k, v in b.items()}
                            for b in samples['blocks'])}


def run(rows=512, lengths=LENGTHS):
    """Fit every backend on `rows` rows of three blobs on
    `config.default_device()`, with the chain lengths `lengths`; print and
    return {backend: (seconds, purity)}."""
    rng = np.random.RandomState(0)
    centers = np.array([[-2.5, -2.5], [2.5, 2.5], [-2.5, 2.5]])
    labels = rng.randint(0, 3, rows)
    X = (centers[labels] + 0.3 * rng.randn(rows, 2)).astype(np.float32)

    dev = config.default_device()
    spec = mx.make_spec([(nich, 2)], capacity=16, empties=1)
    cl = clustering.PitmanYor.from_dict({'alpha': 1.0, 'd': 0.0})
    shareds = (nich.shared_from_dict(
        {'mu': 0., 'kappa': 0.1, 'sigmasq': 1.0, 'nu': 1.}),)
    values = (torch.from_numpy(X).to(dev),)
    generator = torch.Generator().manual_seed(0)
    results = {}

    def report(name, t0, assign):
        if isinstance(assign, torch.Tensor):
            assign = assign.cpu().numpy()
        purity = sum(np.bincount(labels[assign == k]).max()
                     for k in np.unique(assign)) / rows
        results[name] = (time.time() - t0, float(purity))
        print('{:<18} {:6.2f}s  purity {:.3f}'.format(
            name, *results[name]))

    t0 = time.time()
    state, assign = gibbs.prior_init(
        spec, cl, shareds, mx.init(spec, shareds), values, generator)
    for _ in range(lengths['gibbs_sweeps']):
        state, assign = gibbs.sweep_blocked(
            spec, cl, shareds, state, values, assign, rows // 4, generator)
    report('collapsed gibbs', t0, assign)

    t0 = time.time()
    assign_mh = torch.from_numpy(
        rng.randint(0, 8, rows).astype(np.int32)).to(dev)
    state_mh = mx.state_from_assignments(spec, cl, shareds, values,
                                         assign_mh)
    for _ in range(lengths['mh_sweeps']):
        state_mh, assign_mh = mh.sweep_mh(
            spec, cl, shareds, state_mh, values, assign_mh, rows // 4,
            mh_steps=8, generator=generator, proposal_beta=4.0)
    report('mh sweep', t0, assign_mh)

    # the shared log-prob graph
    lp, init_fn = logprob.make_mixture_logprob(spec, cl, shareds, values,
                                               K=6)
    params0 = init_fn(torch.Generator().manual_seed(5))

    def argmax_resp(params):
        return logprob.responsibilities(
            spec, cl, shareds, params, values).argmax(1)

    t0 = time.time()
    samples, _ = hmc.hmc(generator, lp, params0, **lengths['hmc'])
    report('hmc', t0, argmax_resp(_last(samples)))

    t0 = time.time()
    samples, _ = hmc.nuts(generator, lp, params0, **lengths['nuts'])
    report('nuts', t0, argmax_resp(_last(samples)))

    t0 = time.time()
    var_params, _ = vi.advi(generator, lp, params0, **lengths['advi'])
    report('advi', t0, argmax_resp(var_params['mu']))

    t0 = time.time()
    states, assigns, logw, log_ev = smc.smc_init(
        spec, cl, shareds, values, 8, 32, generator)
    _, assign_smc = smc.best_particle(states, assigns, logw)
    report('smc', t0, assign_smc)
    print('smc log evidence: {:.1f}'.format(float(log_ev)))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--rows', type=int, default=512)
    parser.add_argument('--cpu', action='store_true')
    args = parser.parse_args(argv)
    if args.cpu:
        config.set_default_device('cpu')
    run(args.rows)


if __name__ == '__main__':
    main()
