"""What nvcc made of a kernel source: ptxas's registers, spills and shared
memory per kernel, and the static count of each SASS opcode per kernel.

Run on a machine with the CUDA toolkit, from the root of a checkout:

    python -m manga_image_translator_tpu_torch.ops.sass_count bilateral

It compiles ``csrc/<source>`` to a cubin for ``sm_90a`` with the flags the
port builds with (into a temporary directory) and prints one JSON object a
kernel: ``{"kernel", "ptxas", "opcodes": {opcode: count}, "total"}``.
Counts are static (each instruction of the binary once), not executed.
"""
from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from . import cuda_build

_FUNC = re.compile(r'^\s*Function : (\S+)')
_INSN = re.compile(r'^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)')


def opcode_counts(sass: str) -> dict:
    """{kernel: Counter of opcodes (with modifiers)} from cuobjdump -sass."""
    counts: dict = {}
    current = None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            current = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSN.match(line)
        if m and current is not None:
            current[m.group(1)] += 1
    return counts


def ptxas_info(stderr: str) -> dict:
    """{kernel: ptxas -v's lines about it (registers, spills, memory)}."""
    info: dict = collections.defaultdict(list)
    func = None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            func = m.group(1)
        elif func and ('registers' in line or 'spill' in line):
            info[func].append(line.split('info    :')[-1].strip())
    return dict(info)


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(
        cuda_build.SOURCES)
    nvcc = cuda_build._nvcc()
    cuobjdump = str(Path(nvcc).with_name('cuobjdump'))
    flags = [f for f in cuda_build.NVCC_FLAGS
             if f not in ('-shared', '-Xcompiler', '-fPIC')]
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            cubin = Path(tmp) / f'{name}.cubin'
            res = subprocess.run(
                [nvcc, *flags, '-cubin', '-Xptxas', '-v', '-o', str(cubin),
                 str(cuda_build.CSRC / cuda_build.SOURCES[name])],
                capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stderr, file=sys.stderr)
                return res.returncode
            ptxas = ptxas_info(res.stderr)
            sass = subprocess.run([cuobjdump, '-sass', str(cubin)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            for kernel, ops in opcode_counts(sass).items():
                print(json.dumps({'source': cuda_build.SOURCES[name],
                                  'kernel': kernel,
                                  'ptxas': ptxas.get(kernel, []),
                                  'total': sum(ops.values()),
                                  'opcodes': dict(ops.most_common())}),
                      flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
