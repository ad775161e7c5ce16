"""What the benchmark takes from the program under test, the PyTorch and
CUDA package: its public runner, `run_gibbs(use_pallas=True)`, the
mixture and model modules that build its inputs, its step logger and its
graph counters.  Nothing else of the benchmark imports the program."""

import time

import torch

from distributions_tpu_torch import clustering, diagnostics
from distributions_tpu_torch import mixture as mx
from distributions_tpu_torch.inference import runner
from distributions_tpu_torch.models import MODULES
from distributions_tpu_torch.ops import gibbs

from gibbsbench import reference


def build(cfg, slots, device):
    """(spec, prior, shareds) of a configuration at `slots` slots."""
    spec = mx.make_spec([(MODULES[b['model']], b['cols'])
                         for b in cfg['blocks']], capacity=slots)
    prior = cfg['prior']
    if prior['model'] != 'pitman_yor':
        raise ValueError('unknown prior %r' % (prior['model'],))
    cl = clustering.PitmanYor.from_dict(prior, device=device)
    shareds = tuple(MODULES[b['model']].shared_from_dict(b['shared'],
                                                         device=device)
                    for b in cfg['blocks'])
    return spec, cl, shareds


class StepClock(diagnostics.SweepLogger):
    """The runner's step logger, which also stamps each step's end on the
    host clock (`ends`, time.perf_counter) and, once `profile_after`
    steps are logged, calls `at_profile()` (the traced run starts its
    profiler there, after the stamp)."""

    def __init__(self, profile_after=None, at_profile=None):
        super().__init__()
        self.ends = []
        self.profile_after = profile_after
        self.at_profile = at_profile

    def log(self, sweep, **fields):
        row = super().log(sweep, **fields)
        self.ends.append(time.perf_counter())
        if self.profile_after is not None \
                and len(self.rows) == self.profile_after:
            self.at_profile()
        return row


def run(problem, generator, passes, sweeps_per_step, start, log):
    """One run_gibbs call of the fused path: `passes` sweeps in steps of
    `sweeps_per_step`, warm from the assignments `start`, no growth, no
    checkpoint, no hyper moves.  Returns (state, assignments)."""
    spec, cl, shareds, values, cfg, traffic, device = problem
    state, assignments, _ = runner.run_gibbs(
        spec, cl, shareds, values, generator, passes,
        block=cfg['tile_rows'], use_pallas=True, grow_headroom=0.0,
        log=log, sampling=traffic['sampling'],
        sweeps_per_step=sweeps_per_step, initial_assignments=start,
        device=device)
    return state, assignments


def reset_graph_stats():
    return gibbs.reset_graph_stats()


def outputs(cfg, state, assignments, log):
    """The program's outputs as reference.compare takes them."""
    blocks = [reference.model(b['model']).program_stats(g)
              for b, g in zip(cfg['blocks'], state.groups)]
    return {'assignments': assignments, 'counts': state.counts,
            'sample_size': int(state.sample_size), 'blocks': blocks,
            'score': log.rows[-1]['score_data']}


def nonempty_groups(log):
    return [r['nonempty_groups'] for r in log.rows]


def empty_cache(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
