"""Device resolution for the port.

Entry points run on CUDA. The CPU is used only when a Python caller asks for
it explicitly (``use_gpu=False``, as the tests do); a missing card is an
error, never a silent fallback.
"""
from __future__ import annotations

import torch

from .utils.profiling import HOST_SYNCS, count

# Matmuls stay full f32, so the plain versions of the kernels are exact
# references on the card. cuDNN convolutions (DBNet, the f32 OCR backbone)
# run in TF32 on the card: the JAX package runs the same f32 convolutions on
# the TPU at its default precision (bf16 passes), coarser than TF32. CPU runs
# (the parity tests) use neither switch. The bf16 OCR decode kernels choose
# their own precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = True


class CudaUnavailableError(RuntimeError):
    pass


def resolve_device(use_gpu=None) -> torch.device:
    """``use_gpu is False`` → CPU; anything else → the first CUDA card, or
    raise when there is none."""
    if use_gpu is False:
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise CudaUnavailableError(
            'CUDA is not available. The port runs on an NVIDIA GPU; pass '
            'use_gpu=False from Python to run on the CPU.')
    return torch.device('cuda', 0)


def device_named(name=None) -> torch.device:
    """The device a stage is handed by name: the CPU for ``'cpu'``; the card
    for anything else, ``None`` included (raises when there is none)."""
    return resolve_device(name is None or torch.device(name).type != 'cpu')


def synchronize(device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if torch.device(device).type == 'cuda':
        count(HOST_SYNCS)
        torch.cuda.synchronize(device)
