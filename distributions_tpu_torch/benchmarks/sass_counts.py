"""Static SASS instruction counts of the main path's split kernels: the
instantiations of `split_score_sample` (csrc/fused_split.cuh) that K1 (one
block of two nich columns) and K2 / K3 (niw2mix) launch in 'gumbel' and
'argmax', B5's 'score_max' and 'bits' phases, K4 (two nich columns) and
K5 (nichbbddgp, bbddgp) in 'gumbel' and 'argmax' (the v1 form), and the
wide shapes that every other layout takes in 'gumbel', disassembled with
the toolkit's `cuobjdump -sass` from the libraries this checkout builds.

    python -m distributions_tpu_torch.benchmarks.sass_counts

Prints one JSON line per kernel: its instructions in all and by opcode
(the mnemonic before the first '.'), with the classes that bound the walk
summed: MUFU (the SFU: ex2, lg2, rcp), FP32 (FADD, FMUL, FFMA, FMNMX,
FSETP, FSEL), integer (IMAD, IADD3, LOP3, SHF, ISETP, ...), LDS (shared
memory), LDG (device memory), BAR / shuffles.  The counts are of the code,
not of its execution: a loop body counts once.  Needs the CUDA toolkit
(`cuobjdump` beside `nvcc`); the card itself is not used.
"""

import collections
import json
import os
import re
import shutil
import subprocess
import sys

# Itanium-mangled template arguments of split_score_sample<MODE, FAST,
# PHASE, Shape<NC, NQC, D, NT>> (an exact shape), <..., ShapeV1<NC, NT>>
# (an exact shape of the v1 form) or <..., WideShape> / <...,
# WideShapeV1>
KERNELS = {
    'K1 gumbel': ('fused_v2', 'ILi1ELb0ELi0E5ShapeILi2ELi0ELi1ELi0EEE'),
    'K1 argmax': ('fused_v2', 'ILi0ELb0ELi0E5ShapeILi2ELi0ELi1ELi0EEE'),
    'B5 score_max': ('fused_v2',
                     'ILi0ELb0ELi2E5ShapeILi2ELi0ELi1ELi0EEE'),
    'B5 score_bits': ('fused_v2',
                      'ILi5ELb0ELi0E5ShapeILi2ELi0ELi1ELi0EEE'),
    'K2/K3 niw2mix gumbel': ('fused_v3',
                             'ILi1ELb0ELi0E5ShapeILi1ELi1ELi2ELi1EEE'),
    'K2/K3 niw2mix argmax': ('fused_v3',
                             'ILi0ELb0ELi0E5ShapeILi1ELi1ELi2ELi1EEE'),
    'K1 wide gumbel': ('fused_v2', 'ILi1ELb0ELi0E9WideShapeE'),
    'K2/K3 wide gumbel': ('fused_v3', 'ILi1ELb0ELi0E9WideShapeE'),
    'K4 gumbel': ('score_sample_v1', 'ILi1ELb0ELi0E7ShapeV1ILi2ELi0EEE'),
    'K4 argmax': ('score_sample_v1', 'ILi0ELb0ELi0E7ShapeV1ILi2ELi0EEE'),
    'K5 nichbbddgp gumbel': ('score_sample_v1',
                             'ILi1ELb0ELi0E7ShapeV1ILi1ELi3EEE'),
    'K5 nichbbddgp argmax': ('score_sample_v1',
                             'ILi0ELb0ELi0E7ShapeV1ILi1ELi3EEE'),
    'K5 bbddgp gumbel': ('score_sample_v1',
                         'ILi1ELb0ELi0E7ShapeV1ILi0ELi3EEE'),
    'K4/K5 wide gumbel': ('score_sample_v1', 'ILi1ELb0ELi0E11WideShapeV1E'),
}
CLASSES = {
    'MUFU': ('MUFU',),
    'FP32': ('FADD', 'FMUL', 'FFMA', 'FMNMX', 'FSETP', 'FSEL', 'FCHK'),
    'integer': ('IMAD', 'IADD3', 'LOP3', 'SHF', 'ISETP', 'LEA', 'IABS',
                'SEL', 'PRMT', 'I2F', 'F2I', 'IMNMX', 'POPC', 'FLO'),
    'LDS': ('LDS',),
    'LDG': ('LDG',),
    'sync': ('BAR', 'SHFL', 'WARPSYNC', 'BSSY', 'BSYNC'),
}
_INSN = re.compile(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)')


def cuobjdump():
    path = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not os.path.exists(path):
        raise RuntimeError('cuobjdump not found: needs the CUDA toolkit')
    return path


def functions(so):
    """{mangled name: Counter of opcodes} of a library's device code."""
    out = subprocess.run([cuobjdump(), '-sass', so], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            name = m.group(1)
            funcs[name] = collections.Counter()
            continue
        m = _INSN.search(line)
        if name and m:
            funcs[name][m.group(1)] += 1
    return funcs


def main():
    from distributions_tpu_torch.ops import fused_kernels as fk
    libs = {name: functions(fk.build(name)['path'])
            for name in ('fused_v2', 'fused_v3', 'score_sample_v1')}
    for label, (lib, tag) in KERNELS.items():
        names = [n for n in libs[lib]
                 if 'split_score_sample' in n and tag in n]
        if len(names) != 1:
            raise AssertionError('%s: %d functions match %s'
                                 % (label, len(names), tag))
        ops = libs[lib][names[0]]
        classes = {c: sum(ops[o] for o in ops if o in members)
                   for c, members in CLASSES.items()}
        print(json.dumps({'kernel': label, 'function': names[0],
                          'instructions': sum(ops.values()),
                          'classes': classes,
                          'opcodes': dict(ops.most_common())}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
