"""CLI introspection commands (reference distributions/__main__.py:33-100;
distributions_tpu.__main__).

Usage:
  python -m distributions_tpu_torch modes_by_model
  python -m distributions_tpu_torch model_apis
  python -m distributions_tpu_torch model_api nich
  python -m distributions_tpu_torch examples
  python -m distributions_tpu_torch benchmarks
"""

import argparse
import json

from distributions_tpu_torch.models import MODULES

# The port's execution modes, and the reference flavor role each fills:
#   eager    one torch call at a time on any device: the functional models,
#            the compat facade and its per-row mixture ops        ~ dbg
#   batched  torch ops over [rows, C] tiles on any device: mixture.score_batch,
#            ops.gibbs.sweep_blocked and the other moves             ~ lp
#   fused    the hand-written CUDA kernels (csrc/) behind run_gibbs's
#            use_pallas path, one launch scoring, drawing and summing a
#            tile; every model rides K2 (csrc/fused_v3.cu)           ~ lp
# hp is the separate float64 copy (distributions_tpu_torch.hp).
MODES = ['eager', 'batched', 'fused']


def modes_by_model():
    """Print which execution modes / flavors support each model (the analog
    of the reference's flavors_by_model)."""
    from distributions_tpu_torch.hp.models import MODULES as HP
    for name in sorted(MODULES):
        module = MODULES[name]
        flavors = list(MODES) + (['hp'] if name in HP else [])
        print('{} ({}): {}'.format(module.NAME, name, ' '.join(flavors)))


def model_api(name):
    module = MODULES[name]
    fns = sorted(
        attr for attr in dir(module)
        if not attr.startswith('_') and callable(getattr(module, attr))
        and attr not in ('Shared', 'Group'))
    print('{} ({})'.format(module.NAME, name))
    print('  Shared fields: {}'.format(
        ', '.join(module.Shared._fields)))
    print('  Group fields:  {}'.format(
        ', '.join(module.Group._fields)))
    print('  functions:     {}'.format(', '.join(fns)))


def model_apis():
    for name in sorted(MODULES):
        model_api(name)
        print()


def examples():
    out = {name: MODULES[name].EXAMPLES for name in sorted(MODULES)}
    print(json.dumps(
        out, default=lambda o: getattr(o, 'tolist', lambda: str(o))(),
        indent=2))


def benchmarks():
    print('run: python -m distributions_tpu_torch.benchmarks.bench'
          '         # headline Gibbs benchmark')
    print('     python -m distributions_tpu_torch.benchmarks.bench_runner'
          '  # run_gibbs wall clock')
    print('     python -m distributions_tpu_torch.benchmarks.suite'
          '         # full benchmark suite')


COMMANDS = {
    'modes_by_model': modes_by_model,
    'model_apis': model_apis,
    'examples': examples,
    'benchmarks': benchmarks,
}


def main(argv=None):
    parser = argparse.ArgumentParser(prog='distributions_tpu_torch')
    parser.add_argument('command',
                        choices=sorted(COMMANDS) + ['model_api'])
    parser.add_argument('args', nargs='*')
    ns = parser.parse_args(argv)
    if ns.command == 'model_api':
        for name in ns.args or sorted(MODULES):
            model_api(name)
    else:
        COMMANDS[ns.command]()


if __name__ == '__main__':
    main()
