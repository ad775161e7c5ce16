"""Name parity: every module of the JAX package has its counterpart in the
port at the same relative path, holding every top-level public name the
JAX module has (functions, classes, assignments and the names its imports
bind), but for the allowlist below, one reason each.  Both sides are read
with `ast`; nothing is imported."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / 'distributions_tpu'
PORT = ROOT / 'distributions_tpu_torch'

# JAX modules with no counterpart
NO_COUNTERPART = {
    'ops/pallas_kernels.py': 'its kernels are ops/fused_kernels.py + csrc/',
    'io/schema_pb2.py': 'replaced by io/protobuf.py\'s hand-written '
                        'messages',
}

# names a JAX module binds that the port's need not have, in any module
ANY_MODULE = {
    'jax': 'third-party import', 'jnp': 'third-party import',
    'lax': 'third-party import', 'optax': 'third-party import',
    'shard_map': 'third-party import', 'P': 'third-party import',
    'map_': 'third-party import', 'np': 'numpy import, where the port has '
                                        'no use for numpy',
    'partial': 'functools import', 'os': 'standard-library import',
    'sys': 'standard-library import', 'math': 'standard-library import',
    'logsumexp': 'imported from special, where the port has it',
    'schema_pb2': 'the generated module, which io/protobuf.py\'s messages '
                  'and io/wire.py replace',
}

# names of one JAX module that its port does not have
ONE_MODULE = {
    ('config.py', 'KERNEL_ROWS'): 'the Pallas row-block size: the port\'s '
                                  'kernels take their block from their '
                                  'launch shapes',
    ('mixture.py', 'ONEHOT_CHUNK_LIMIT'): 'the TPU one-hot mechanism the '
                                          'port drops (models/base.py has '
                                          'its own)',
    ('mixture.py', 'apply_tile_deltas'): 'the port\'s apply_stat_tiles',
    ('compat/clustering.py', 'get_key'): 'imported to draw; the port\'s '
                                         'modules draw with get_generator',
    ('compat/mixture.py', 'get_key'): 'imported to draw; the port\'s '
                                      'FeatureMixture draws nothing',
    ('compat/models.py', 'get_key'): 'imported to draw; the port\'s '
                                     'modules draw with get_generator',
}


def public_names(path):
    """Top-level public names a module binds, read with `ast`."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                names.update(n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split('.')[0]
                         for a in node.names)
    return {n for n in names if not n.startswith('_')}


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob('*.py'))


@pytest.mark.parametrize('rel', MODULES)
def test_port_has_the_module_and_its_names(rel):
    if rel in NO_COUNTERPART:
        assert not (PORT / rel).exists()
        return
    assert (PORT / rel).exists(), rel
    missing = {n for n in public_names(JAX / rel) - public_names(PORT / rel)
               if n not in ANY_MODULE and (rel, n) not in ONE_MODULE}
    assert not missing, (rel, sorted(missing))


def test_allowlist_is_current():
    """Every allowlisted name is one some JAX module binds and its port
    lacks, so that the list shrinks when the port gains a name."""
    gaps = set()
    for rel in MODULES:
        if rel not in NO_COUNTERPART:
            gaps.update((rel, n) for n in public_names(JAX / rel)
                        - public_names(PORT / rel))
    assert set(ONE_MODULE) <= gaps, set(ONE_MODULE) - gaps
    assert set(ANY_MODULE) <= {n for _, n in gaps}, (
        set(ANY_MODULE) - {n for _, n in gaps})
    assert set(NO_COUNTERPART) <= set(MODULES)
