"""Minimal safetensors reader and writer (no ``safetensors`` package).

A ``.safetensors`` file is an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``
(plus an optional ``__metadata__`` entry of strings) and the raw
little-endian tensor bytes, offsets relative to the end of the header.

The JAX package loads the SD checkpoint with ``safetensors.torch.load_file``
and, without that package, falls back to ``torch.load``, which cannot parse
the format. The port reads the file itself: ``load`` returns CPU tensors in
their stored dtype (``F32``, ``F16`` or ``BF16``); the caller casts them.
``save`` writes the same format, for tests and synthetic checkpoints.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import torch

_DTYPES = {'F32': torch.float32, 'F16': torch.float16,
           'BF16': torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load(path) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, as contiguous CPU tensors; the
    ``__metadata__`` entry is ignored."""
    with open(path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        if info['dtype'] not in _DTYPES:
            raise ValueError(f'{path}: tensor {name!r} has dtype '
                             f'{info["dtype"]}; only F32, F16 and BF16 are '
                             f'read')
        begin, end = info['data_offsets']
        dtype = _DTYPES[info['dtype']]
        shape = [int(d) for d in info['shape']]
        count = 1
        for d in shape:
            count *= d
        if end - begin != count * dtype.itemsize:
            raise ValueError(f'{path}: tensor {name!r} spans {end - begin} '
                             f'bytes for shape {shape}')
        flat = torch.frombuffer(data, dtype=dtype, count=count,
                                offset=begin) if count else \
            torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(shape).clone()
    return out


def save(tensors: Dict[str, torch.Tensor], path,
         metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (F32, F16 or BF16; any device) in name order."""
    header: Dict[str, object] = {}
    if metadata:
        header['__metadata__'] = dict(metadata)
    offset = 0
    order = sorted(tensors)
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f'tensor {name!r}: dtype {t.dtype} is not '
                             f'F32, F16 or BF16')
        nbytes = t.numel() * t.element_size()
        header[name] = {'dtype': _NAMES[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(',', ':')).encode()
    blob += b' ' * (-len(blob) % 8)            # the format's 8-byte alignment
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
