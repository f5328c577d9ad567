"""LaMa-large inpainter — PyTorch port.

Counterpart of the JAX package's ``inpainting/inpainting_lama.py``
(reference ``inpainting/inpainting_lama_mpe.py:26-138``): resize to
inpainting_size keeping the aspect, stretch to a multiple of 8, [0, 1]
normalisation, ``img *= (1 - mask)``, the generator in the compute dtype
(bf16 by default, f32 on request) with f32 FourierUnits, the composite
``pred * mask + original * (1 - mask)``.

The checkpoint loads natively (``gen_state_dict``, the generator's own
keys); BN is folded into the convs once at load. A batch splits over the
serving mesh's devices when there are several (``parallel.mesh``), and
runs whole on the one card otherwise. ``LamaMPEInpainter`` (lama_mpe) is
the 9-block generator with the masked positional encoding: the host BFS
encodes each page's or crop's mask, ``models.lama.MPE`` embeds it on the
device, and the generator adds both embeddings to its stem's output; K4
and K5 run through the same wrappers as for lama_large.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np
import torch

from ..config import InpainterConfig, InpaintPrecision
from ..models import lama
from ..parallel.mesh import sharded_batch
from ..utils.profiling import span, to_host
from .common import OfflineInpainter

PAD_SIZE = 8


def _lama_body(model: lama.LamaGenerator, img: torch.Tensor,
               mask: torch.Tensor, dtype: torch.dtype,
               embeddings=(None, None)) -> torch.Tensor:
    """img (N, H, W, 3) f32 in [0, 1], mask (N, H, W, 1) binary f32 →
    the composited f32 result."""
    img = img.to(dtype) * (1.0 - mask.to(dtype))
    out = model(img, mask.to(dtype), *embeddings).float()
    return out * mask + (1.0 - mask) * img.float()


def _to_u8(out: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)


def _pick_gen(sd):
    if isinstance(sd, dict) and 'gen_state_dict' in sd:
        return sd['gen_state_dict']
    return sd


class LamaLargeInpainter(OfflineInpainter):
    """lama_large_512px checkpoint, 18 FFC blocks (recommended)."""

    _MODEL_MAPPING = {
        'model': {
            'url': 'https://huggingface.co/dreMaz/AnimeMangaInpainting/'
                   'resolve/main/lama_large_512px.ckpt',
            'hash': '11d30fbb3000fb2eceae318b75d9ced9229d99ae990a7f8b3ac35c8d31f2c935',
            'file': '.',
        },
    }
    _N_BLOCKS = 18

    def __init__(self):
        super().__init__()
        self.model: Optional[lama.LamaGenerator] = None
        self.device: Optional[torch.device] = None
        self._by_dtype: Dict[torch.dtype, lama.LamaGenerator] = {}
        # (N, H, W) of every generator forward, in order (crop buckets and
        # full pages); callers may clear it
        self.forwards: List[Tuple[int, int, int]] = []

    async def _load(self, device: str):
        n_blocks = self._N_BLOCKS
        sd = _pick_gen(self.load_state_dict(
            'model', init_fn=lambda: lama.init_state_dict(n_blocks)))
        self.device = torch.device(device)
        self.set_model(lama.fold_bn(lama.build_lama(n_blocks, sd)))

    def set_model(self, model: lama.LamaGenerator) -> None:
        """Use ``model`` (f32, BN folded or not) on this inpainter's
        device."""
        self.model = model.to(device=self.device,
                              memory_format=lama.CHANNELS_LAST).eval()
        self._by_dtype = {torch.float32: self.model}

    async def _unload(self):
        self.model = None
        self._by_dtype = {}

    def _compute_dtype(self, config: InpainterConfig) -> torch.dtype:
        if config.inpainting_precision == InpaintPrecision.fp32:
            return torch.float32
        if config.inpainting_precision == InpaintPrecision.fp16:
            self.logger.warning(
                'Switch to bf16 due to Lama only compatible with bf16 and fp32.')
        return torch.bfloat16

    def _model_for(self, dtype: torch.dtype) -> lama.LamaGenerator:
        model = self._by_dtype.get(dtype)
        if model is None:
            # ordinary tensors (with version counters), also when asked
            # from inside inference mode
            with torch.inference_mode(False):
                model = lama.cast_for_compute(self.model, dtype)
            self._by_dtype[dtype] = model
        return model

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == 'cuda':
            # pinned, so the copy is queued behind the device work instead
            # of waiting for it
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.inference_mode()
    def _forward_u8(self, image: np.ndarray, mask: np.ndarray,
                    config: InpainterConfig) -> torch.Tensor:
        """(N, H, W, 3) uint8 + (N, H, W) uint8 → (N, H, W, 3) uint8 on the
        device, not yet copied to the host."""
        dtype = self._compute_dtype(config)
        self.forwards.append(tuple(image.shape[:3]))

        def body(model, img, msk, *emb):
            return _lama_body(model, img, msk, dtype,
                              emb if emb else (None, None))
        with span('inpaint.forward'):
            embeddings = self._embeddings(mask)
            img = self._upload(image).float() / 255.0
            msk = (self._upload(mask).float()[..., None] / 255.0
                   >= 0.5).float()
            # the batch splits over the serving mesh when there is one
            # (parallel.mesh), the embeddings with it
            extra = tuple(e for e in embeddings if e is not None)
            return _to_u8(sharded_batch(
                body, ('lama.batch', type(self).__name__, dtype, len(extra)),
                self._model_for(dtype), img, msk, *extra))

    def _embeddings(self, mask: np.ndarray):
        """The generator's extra stem inputs for (N, H, W) uint8 masks:
        none for lama_large."""
        return None, None

    async def _infer(self, image: np.ndarray, mask: np.ndarray,
                     config: InpainterConfig, inpainting_size: int = 1024,
                     verbose: bool = False) -> np.ndarray:
        img_original = np.copy(image)
        mask_original = (np.copy(mask) >= 127).astype(np.uint8)[:, :, None]

        height, width = image.shape[:2]
        if max(image.shape[:2]) > inpainting_size:
            ratio = inpainting_size / max(height, width)
            new_size = (round(width * ratio), round(height * ratio))
            image = cv2.resize(image, new_size, interpolation=cv2.INTER_LINEAR)
            mask = cv2.resize(mask, new_size, interpolation=cv2.INTER_LINEAR)
        h, w = image.shape[:2]
        new_h = h + ((-h) % PAD_SIZE)
        new_w = w + ((-w) % PAD_SIZE)
        if (new_h, new_w) != (h, w):
            image = cv2.resize(image, (new_w, new_h),
                               interpolation=cv2.INTER_LINEAR)
            mask = cv2.resize(mask, (new_w, new_h),
                              interpolation=cv2.INTER_LINEAR)
        self.logger.info(f'Inpainting resolution: {new_w}x{new_h}')

        img_inpainted = to_host(self._forward_u8(image[None], mask[None],
                                                 config)[0]).numpy()
        if (new_h, new_w) != (height, width):
            img_inpainted = cv2.resize(img_inpainted, (width, height),
                                       interpolation=cv2.INTER_LINEAR)
        return (img_inpainted * mask_original
                + img_original * (1 - mask_original)).astype(np.uint8)

    def _batch_forward_dispatch(self, imgs: np.ndarray, masks: np.ndarray,
                                config: InpainterConfig):
        return self._forward_u8(imgs, masks, config)

    def _batch_forward(self, imgs: np.ndarray, masks: np.ndarray,
                       config: InpainterConfig) -> np.ndarray:
        return self._batch_forward_collect(
            self._batch_forward_dispatch(imgs, masks, config))


class LamaMPEInpainter(LamaLargeInpainter):
    """lama_mpe checkpoint: 9 FFC blocks + masked positional encoding.

    The checkpoint holds the generator (``gen_state_dict``) and the MPE
    tables (``str_state_dict``), both in torch layout, loaded as they are
    (the JAX package's loader transposes the two tables, ROADMAP §C).
    Without a checkpoint the MPE weights are the JAX package's own init,
    whose zero scales switch the embeddings off."""

    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/inpainting_lama_mpe.ckpt',
            'hash': 'd625aa1b3e0d0408acfd6928aa84f005867aa8dbb9162480346a4e20660786cc',
            'file': '.',
        },
    }
    _N_BLOCKS = 9

    def __init__(self):
        super().__init__()
        self.mpe: Optional[lama.MPE] = None

    async def _load(self, device: str):
        n_blocks = self._N_BLOCKS
        sd = self.load_state_dict('model', init_fn=lambda: {
            'gen_state_dict': lama.init_state_dict(n_blocks)})
        self.device = torch.device(device)
        self.set_model(lama.fold_bn(lama.build_lama(n_blocks, _pick_gen(sd))))
        str_sd = sd.get('str_state_dict') if isinstance(sd, dict) else None
        self.set_mpe(lama.build_mpe(str_sd if str_sd is not None
                                    else lama.mpe_init_state_dict()))

    def set_mpe(self, mpe: lama.MPE) -> None:
        """Use ``mpe`` (f32) on this inpainter's device."""
        self.mpe = mpe.to(self.device).eval()

    async def _unload(self):
        await super()._unload()
        self.mpe = None

    def _embeddings(self, mask: np.ndarray):
        """The BFS encoding of each (H, W) uint8 mask (binarised at 0.5, as
        the generator's mask) on the host, embedded on the device."""
        with span('inpaint.mpe_encode'):
            mask_bin = ((mask.astype(np.float32) / 255.0) >= 0.5).astype(
                np.float32)
            encs = [lama.masked_position_encoding(m) for m in mask_bin]
        rel_pos = self._upload(np.stack([e[0] for e in encs]))
        direct = self._upload(np.stack([e[1] for e in encs]))
        return self.mpe(rel_pos, direct)
