"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``. All sources are
compiled in parallel at first use; a library is cached under
``build/torch_kernels/`` by a hash of its source and flags, so a second
process (e.g. the CLI started by a script that already built) reuses it.
Nothing is compiled or loaded when a module is imported. A library's C
entry point gets its argument and result types once, when the library is
loaded (``entry``), not at every launch.

Every kernel wrapper keeps a plain-integer launch counter here:
``LAUNCHES[name]`` grows by one each time the wrapper launches its kernel
(whichever of the library's entry points it calls), through
``count_launch``. A wrapper called while its thread captures a CUDA graph
(inside ``capture_tally``) counts into that capture's own tally instead,
which ``ops.device_loop`` adds to ``LAUNCHES`` at every replay of the
graph, so the counters stay the number of launches that ran, also while
other threads launch kernels during the capture.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Callable, Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-lineinfo']

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

# kernel name -> source file under csrc/
SOURCES = {
    'bilateral': 'bilateral.cu',
    'decode_step': 'decode_step.cu',
    'charhead': 'charhead.cu',
    'fourier_unit': 'fourier_unit.cu',
    'conv_stream': 'conv_stream.cu',
}
# entry name -> (kernel whose library holds it, C entry point, its argument
# types); every entry point returns an int: a cudaError_t, except
# conv_stream_tc_packed_elems, a count
ENTRY_POINTS = {
    'bilateral': ('bilateral', 'mit_bilateral_u8',
                  [_P, _P, _I, _I, _I, _I, _F, _F, _P]),
    'decode_step': ('decode_step', 'mit_decode_step', [_I] * 3 + [_P] * 33),
    'charhead': ('charhead', 'mit_char_topk', [_P] * 5 + [_I] * 3 + [_P] * 9),
    'fourier_unit': ('fourier_unit', 'mit_fourier_unit',
                     [_P] * 10 + [_I] * 5 + [_P]),
    'conv_stream': ('conv_stream', 'mit_conv_stream',
                    [_P] * 4 + [_I] * 8 + [_P]),
    'conv_stream_tc': ('conv_stream', 'mit_conv_stream_tc',
                       [_P] * 4 + [_I] * 9 + [_P]),
    'conv_stream_tc_pack': ('conv_stream', 'mit_conv_stream_tc_pack',
                            [_P] * 2 + [_I] * 4 + [_P]),
    'conv_stream_tc_packed_elems': ('conv_stream',
                                    'mit_conv_stream_tc_packed_elems',
                                    [_I] * 4),
}

# the cudaError_t (cudaErrorInvalidValue) an entry point returns when it
# refuses a shape, before it launches anything
REFUSED = 1

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Callable[..., int]] = {}
_lock = threading.Lock()


_capture = threading.local()


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: into ``LAUNCHES``, or into the tally
    of the capture this thread runs (``capture_tally``)."""
    tally = getattr(_capture, 'tally', None)
    if tally is None:
        LAUNCHES[name] += 1
    else:
        tally[name] += 1


@contextlib.contextmanager
def capture_tally():
    """Inside the block, this thread's launches are counted in the yielded
    ``Counter``, not in ``LAUNCHES`` (a CUDA graph capture: its kernels run
    when the graph is replayed)."""
    prev = getattr(_capture, 'tally', None)
    _capture.tally = tally = collections.Counter()
    try:
        yield tally
    finally:
        _capture.tally = prev


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda')) / 'bin' / 'nvcc'
    if cand.is_file():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                       'csrc/ at first use and need the CUDA toolkit')


def _lib_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob('*.cuh')):
        h.update(hdr.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build_all() -> Dict[str, Path]:
    """Compile every source that has no cached library, one nvcc process
    per source, all started together. Raises with nvcc's stderr on
    failure. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = {}
    for name, path in paths.items():
        if path.is_file():
            continue
        tmp = path.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f'nvcc failed for {SOURCES[name]} '
                          f'(exit {proc.returncode}):\n{err}{out}')
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError('\n'.join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.is_file():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def entry(name: str) -> Callable[..., int]:
    """The C entry point ``name`` (a key of ``ENTRY_POINTS``), typed once
    when first asked."""
    fn = _entries.get(name)
    if fn is None:
        kernel, symbol, argtypes = ENTRY_POINTS[name]
        fn = getattr(library(kernel), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entries[name] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f'{what}: CUDA error {status} at launch')


_sync_buffers: Dict[tuple, object] = {}


def persistent_zeros(store: dict, key, words: int, device):
    """``store[key]``: an int32 buffer of ``words`` words on ``device``,
    zeroed when it is first asked for and kept for the process. A CUDA
    graph records the buffer's address, so it must exist before a capture
    that uses it: asked for the first time during a capture, it raises
    (a beam loop runs its first step eagerly before it captures)."""
    import torch
    buf = store.get(key)
    if buf is None:
        if (torch.device(device).type == 'cuda'
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f'buffer {key} of a kernel is first asked for '
                               'during a CUDA graph capture: run the step '
                               'once eagerly before capturing it')
        buf = torch.zeros(words, dtype=torch.int32, device=device)
        store[key] = buf
    return buf


def sync_buffer(name: str, device):
    """An int32 buffer of 64 words, zeroed once, for the grid barrier
    (and counters) of kernel ``name``'s persistent launches on ``device``,
    allocated once per (kernel, device). It needs no reset: a launch
    leaves its counters zero and the barrier word's low 31 bits as it found
    them (``grid_sync`` waits for a flip of the top bit, which an odd
    number of barriers in a launch leaves flipped). Launches that share it
    run on one stream, or in turn."""
    return persistent_zeros(_sync_buffers, (name, str(device)), 64, device)


def current_stream(device) -> ctypes.c_void_p:
    """The stream PyTorch's current stream context names on ``device``: a
    graph capture's stream while one runs, so launches made there are
    recorded into the graph."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class CheckedWeights:
    """A wrapper's memory of the last weight set it checked, by weak
    reference to its tensors: a beam loop checks its weights and reads
    their pointers once, not at every step. A different tensor in any slot
    is checked anew."""

    def __init__(self, keys: Sequence[str], check: Callable) -> None:
        self.keys = tuple(keys)
        self.check = check            # check(w, device) raises on a misfit
        self._device = None
        self._refs: List[weakref.ref] = []
        self._ptrs: List[ctypes.c_void_p] = []

    def pointers(self, w, device) -> List[ctypes.c_void_p]:
        tensors = [w.get(k) for k in self.keys]
        if (device == self._device and len(self._refs) == len(tensors)
                and all(t is not None and r() is t
                        for r, t in zip(self._refs, tensors))):
            return self._ptrs
        self.check(w, device)
        self._device = device
        self._refs = [weakref.ref(t) for t in tensors]
        self._ptrs = [ptr(t) for t in tensors]
        return self._ptrs
