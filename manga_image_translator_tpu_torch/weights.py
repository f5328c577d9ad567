"""Weights: torch state dicts, and the bridge from the JAX params layout.

The port's modules load released torch checkpoints natively (their
parameter names are the checkpoint keys). ``torch_state_dict_from_jax``
inverts the JAX package's ``convert_state_dict`` so that the same seeded
``init_params`` weights can be fed to both implementations in tests:

* conv weights HWIO → OIHW;
* transposed-conv weights (stored spatially flipped as HWIO) → un-flipped
  torch ``(in, out, kh, kw)``;
* linear weights (I, O) → (O, I), ``in_proj_weight`` included;
* embeddings, biases and norm statistics pass through.

It takes numpy arrays (or anything ``np.asarray`` accepts) and never
imports JAX.

The ct2 translators need no bridge: both packages read the same CTranslate2
``model.bin``, and the port's ``translators.ct2_model.Ct2Transformer`` takes
the very ``{ct2 variable name: np.ndarray}`` dict (``TransformerSpec``
naming, dequantised to f32) that ``read_ct2_model`` returns in either
package.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence

import numpy as np
import torch

_NORM_HINTS = ('running_mean', 'running_var', 'num_batches_tracked')


def _is_norm_stat(key: str) -> bool:
    return any(h in key for h in _NORM_HINTS)


def torch_state_dict_from_jax(params: Dict[str, object],
                              transposed_conv_patterns: Sequence[str] = (),
                              embedding_patterns: Sequence[str] = ()
                              ) -> Dict[str, torch.Tensor]:
    """Flat JAX params (numpy arrays) → torch state dict (CPU tensors)."""
    t_res = [re.compile(p) for p in transposed_conv_patterns]
    e_res = [re.compile(p) for p in embedding_patterns]
    out: Dict[str, torch.Tensor] = {}
    for key, val in params.items():
        arr = np.asarray(val)
        leaf = key.split('.')[-1]
        if arr.ndim == 4 and leaf == 'weight':
            if any(r.search(key) for r in t_res):
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                arr = arr.transpose(3, 2, 0, 1)            # HWIO → OIHW
        elif (arr.ndim == 2 and leaf in ('weight', 'in_proj_weight')
                and not _is_norm_stat(key)
                and not any(r.search(key) for r in e_res)):
            arr = arr.T                                     # (I,O) → (O,I)
        # ascontiguousarray makes a 0-d scalar (MPE's alphas) 1-d
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)
                                    .reshape(arr.shape))
    return out


def load_state_dict_into(module: torch.nn.Module,
                         sd: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """Strict load: every checkpoint key must name a parameter or buffer of
    ``module`` and vice versa; dtypes follow the module's tensors."""
    own = module.state_dict()
    # BatchNorm's step counter is training-only state that JAX params lack
    missing = sorted(k for k in set(own) - set(sd)
                     if not k.endswith('num_batches_tracked'))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f'state dict mismatch for {type(module).__name__}: '
                       f'missing {missing[:8]}, unexpected {unexpected[:8]}')
    fixed = {k: v for k, v in own.items() if k not in sd}
    for key, val in sd.items():
        ref = own[key]
        val = torch.as_tensor(val)
        if val.shape != ref.shape:
            raise ValueError(f'{key}: checkpoint shape {tuple(val.shape)} '
                             f'!= module shape {tuple(ref.shape)}')
        fixed[key] = val.to(ref.dtype)
    module.load_state_dict(fixed, strict=True)
    return module
