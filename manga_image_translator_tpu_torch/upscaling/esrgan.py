"""ESRGAN and waifu2x upscalers — PyTorch port.

Counterpart of the JAX package's ``upscaling/esrgan.py``. The 4x-UltraSharp
checkpoint path mirrors reference ``upscaling/esrgan_pytorch.py:512-545``
(BGR input, /255, the 4x forward in 256-px tiles with an 8-px edge-padded
context, clip, ``uint8`` truncation, then PIL's bilinear resize to the
requested ratio). The tiling is part of the output: the network's
receptive field is far wider than the context, so the port cuts the JAX
package's tiles; it runs them through the network in batches of
``TILE_BATCH``. The 'esrgan' key is Real-ESRGAN x4plus-anime-6B (new-style
key names, ``convert_realesrgan_state_dict``); 'waifu2x' runs the
networks of the reference's waifu2x-ncnn-vulkan executable (upconv_7 by
``models/waifu2x``, cunet and any other graph by ``utils/ncnn_lite``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from ..models import esrgan
from .common import OfflineUpscaler

TILE = 256
TILE_PAD = 8
# tiles per network forward (a 272² tile's activations at nb 23 take
# about 1.3 GB in f32)
TILE_BATCH = 8


def tile_plan(h: int, w: int) -> List[Tuple[int, ...]]:
    """The JAX package's tiles of an (h, w) image: (y0, x0, y1, x1) of the
    output block and (py0, px0, py1, px1) of the context-padded input."""
    plan = []
    for y0 in range(0, h, TILE):
        for x0 in range(0, w, TILE):
            y1, x1 = min(y0 + TILE, h), min(x0 + TILE, w)
            plan.append((y0, x0, y1, x1, max(y0 - TILE_PAD, 0),
                         max(x0 - TILE_PAD, 0), min(y1 + TILE_PAD, h),
                         min(x1 + TILE_PAD, w)))
    return plan


class ESRGANUpscalerPytorch(OfflineUpscaler):
    """4x-UltraSharp RRDBNet (registry key '4xultrasharp')."""

    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/4xESRGAN.pth',
            'hash': '545805ce2d861ee90972b5fa50b851f19ee4bb35dedd2eb090be1f7c935b6b00',
        },
    }
    _VALID_UPSCALE_RATIOS = [2, 3, 4]

    def __init__(self):
        super().__init__()
        self.model = None
        self.device = None
        # (N, H, W) of every network forward, in order; callers may clear it
        self.forwards: List[Tuple[int, int, int]] = []

    @staticmethod
    def _from_checkpoint(sd: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
        return dict(sd)

    async def _load(self, device: str):
        # random weights: the JAX package's 6-block init
        ckpt = self.load_state_dict('model', init_fn=dict)
        sd = self._from_checkpoint(ckpt) if ckpt else \
            esrgan.init_state_dict(nb=6)
        self.device = torch.device(device)
        self.model = esrgan.build_esrgan(sd, self.device)

    async def _unload(self):
        self.model = None

    @torch.inference_mode()
    def _run_4x(self, arr: np.ndarray) -> torch.Tensor:
        """(H, W, 3) float [0, 1] → (4H, 4W, 3) on the device, tiled."""
        h, w = arr.shape[:2]
        size = TILE + 2 * TILE_PAD
        plan = tile_plan(h, w)
        tiles = []
        for y0, x0, y1, x1, py0, px0, py1, px1 in plan:
            tile = arr[py0:py1, px0:px1]
            th, tw = tile.shape[:2]
            tiles.append(np.pad(tile, ((0, size - th), (0, size - tw),
                                       (0, 0)), mode='edge'))
        out = torch.empty((h * 4, w * 4, 3), dtype=torch.float32,
                          device=self.device)
        for i in range(0, len(tiles), TILE_BATCH):
            batch = torch.from_numpy(np.stack(tiles[i:i + TILE_BATCH])).to(
                self.device)
            self.forwards.append(tuple(batch.shape[:3]))
            res = esrgan.esrgan_forward(self.model, batch)
            for r, (y0, x0, y1, x1, py0, px0, _, _) in zip(
                    res, plan[i:i + TILE_BATCH]):
                oy, ox = (y0 - py0) * 4, (x0 - px0) * 4
                out[y0 * 4:y1 * 4, x0 * 4:x1 * 4] = \
                    r[oy:oy + (y1 - y0) * 4, ox:ox + (x1 - x0) * 4]
        return out

    @staticmethod
    def _to_u8(out: torch.Tensor) -> np.ndarray:
        """Clip, BGR → RGB, ``* 255`` and truncate to ``uint8``."""
        out = (torch.clamp(out, 0, 1).flip(-1) * 255.0).to(torch.uint8)
        return out.cpu().numpy()

    async def _infer(self, image_batch: List[Image.Image],
                     upscale_ratio: float) -> List[Image.Image]:
        assert upscale_ratio <= 4
        ratio = upscale_ratio / 4
        results = []
        for img in image_batch:
            # BGR, matching the checkpoint training
            arr = np.array(img.convert('RGB'))[:, :, ::-1].astype(
                np.float32) / 255.0
            res = Image.fromarray(self._to_u8(self._run_4x(
                np.ascontiguousarray(arr))))
            if ratio != 1:
                res = res.resize(
                    (int(round(res.size[0] * ratio)),
                     int(round(res.size[1] * ratio))),
                    resample=Image.Resampling.BILINEAR)
            results.append(res)
        return results


def convert_realesrgan_state_dict(sd: Mapping[str, torch.Tensor]
                                  ) -> Dict[str, torch.Tensor]:
    """Real-ESRGAN's new-style RRDBNet names (e.g.
    RealESRGAN_x4plus_anime_6B.pth: ``conv_first``, ``body.{i}.rdb{j}.
    conv{k}``, ``conv_body``, ``conv_up1/2``, ``conv_hr``, ``conv_last``,
    optionally under ``params_ema`` / ``params``) → the old flat keys of
    ``models/esrgan.RRDBNet``. The graphs are identical; only the names
    differ (ref arch: realesrgan's rrdbnet_arch.RRDBNet)."""
    if 'params_ema' in sd:
        sd = sd['params_ema']
    elif 'params' in sd:
        sd = sd['params']
    nb = 0
    while f'body.{nb}.rdb1.conv1.weight' in sd:
        nb += 1
    remap = {'conv_first': 'model.0', 'conv_body': f'model.1.sub.{nb}',
             'conv_up1': 'model.3', 'conv_up2': 'model.6',
             'conv_hr': 'model.8', 'conv_last': 'model.10'}
    out = {}
    for key, val in sd.items():
        parts = key.split('.')
        if parts[0] == 'body':
            i, rdb, conv = parts[1], parts[2], parts[3]
            new = (f'model.1.sub.{i}.RDB{rdb[3:]}.{conv}.0.'
                   + '.'.join(parts[4:]))
        elif parts[0] in remap:
            new = remap[parts[0]] + '.' + '.'.join(parts[1:])
        else:
            continue
        out[new] = val
    return out


class ESRGANUpscaler(ESRGANUpscalerPytorch):
    """Default 'esrgan' key: Real-ESRGAN x4plus-anime-6B (the model the
    reference's realesrgan-ncnn-vulkan executable ships for manga),
    RRDBNet nb=6 with new-style checkpoint naming."""

    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/xinntao/Real-ESRGAN/releases'
                   '/download/v0.2.2.4/RealESRGAN_x4plus_anime_6B.pth',
            # upstream publishes no sha256 next to the artifact
        },
    }

    _from_checkpoint = staticmethod(convert_realesrgan_state_dict)


_W2X_ARCHIVE_ROOT = 'waifu2x-ncnn-vulkan-20220728-ubuntu'


def _w2x_archive_members():
    """All waifu2x model files worth extracting from the release archive:
    cunet + both upconv_7 families, scale-only and noise0-3 variants
    (the reference executable selects among these via -m/-n/-s,
    upscaling/waifu2x.py:95-105)."""
    from ..utils.ncnn_lite import model_relpath
    members = {}
    for family in ('cunet', 'upconv_7_anime', 'upconv_7_photo'):
        for noise in (-1, 0, 1, 2, 3):
            for ext in ('param', 'bin'):
                rel = f'{model_relpath(family, noise, 2)}.{ext}'
                members[f'{_W2X_ARCHIVE_ROOT}/{rel}'] = rel
        if family == 'cunet':       # cunet also ships 1x denoise models
            for noise in (0, 1, 2, 3):
                for ext in ('param', 'bin'):
                    rel = f'{model_relpath(family, noise, 1)}.{ext}'
                    members[f'{_W2X_ARCHIVE_ROOT}/{rel}'] = rel
    return members


class Waifu2xUpscaler(OfflineUpscaler):
    """'waifu2x' key: the networks inside the reference's
    waifu2x-ncnn-vulkan executable (upscaling/waifu2x.py:52-105). The
    reference invokes the executable with ``-m models-cunet -n 0``; model
    family and denoise level select via MIT_TPU_WAIFU2X_MODEL (cunet |
    upconv_7_anime | upconv_7_photo) and MIT_TPU_WAIFU2X_NOISE (-1..3).
    upconv_7 runs ``models/waifu2x.UpConv7``; cunet (and any other graph)
    runs through ``utils/ncnn_lite``. Random weights are upconv_7's."""

    _MODEL_MAPPING = {
        'model': {
            'url': 'https://github.com/nihui/waifu2x-ncnn-vulkan/releases'
                   '/download/20220728/waifu2x-ncnn-vulkan-20220728-ubuntu'
                   '.zip',
            'archive': _w2x_archive_members(),
        },
    }
    _VALID_UPSCALE_RATIOS = [1, 2, 4]

    def __init__(self):
        super().__init__()
        self.model = None
        self.graph = None
        self.device = None
        self.context = 7

    @staticmethod
    def _selected_model():
        family = os.environ.get('MIT_TPU_WAIFU2X_MODEL', 'cunet')
        noise = int(os.environ.get('MIT_TPU_WAIFU2X_NOISE', '0'))
        return family, noise

    async def _load(self, device: str):
        from ..models import waifu2x as w2x_model
        from ..utils.ncnn_lite import load_ncnn, model_relpath
        self.device = torch.device(device)
        family, noise = self._selected_model()
        rel = model_relpath(family, noise, 2)
        param_path = self.model_dir / f'{rel}.param'
        bin_path = self.model_dir / f'{rel}.bin'
        if not param_path.is_file():
            # archives extracted with the release root dir kept
            param_path = self.model_dir / _W2X_ARCHIVE_ROOT / f'{rel}.param'
            bin_path = self.model_dir / _W2X_ARCHIVE_ROOT / f'{rel}.bin'
        self.model = self.graph = None
        if param_path.is_file() and bin_path.is_file():
            if family.startswith('upconv_7'):
                self.model = w2x_model.build_upconv7(
                    w2x_model.load_ncnn_upconv7(param_path, bin_path),
                    self.device)
                self.context = w2x_model.CONTEXT
            else:
                self.graph = load_ncnn(param_path, bin_path)
                # cunet consumes an 18px context border at scale 2
                self.context = 18
        else:
            from ..utils.inference import (MissingWeightsError,
                                           random_weights_allowed)
            if not random_weights_allowed(self):
                raise MissingWeightsError(
                    f'waifu2x ncnn weights unavailable ({rel}.param/bin) '
                    'and random weights not allowed')
            self.logger.warning('waifu2x weights unavailable — random init '
                                '(upconv_7 fallback)')
            self.using_random_weights = True
            self.model = w2x_model.build_upconv7(w2x_model.init_state_dict(),
                                                 self.device)
            self.context = w2x_model.CONTEXT

    async def _unload(self):
        self.model = self.graph = None

    def _run_2x(self, x: torch.Tensor) -> torch.Tensor:
        """(1, 3, H, W) → (1, 3, 2H, 2W) on the device."""
        from ..utils.ncnn_lite import run_graph
        c = self.context
        padded = F.pad(x, (c, c, c, c), mode='replicate')
        if self.graph is None:
            return self.model(padded)
        out = run_graph(self.graph, padded)
        # crop any residual context the graph's VALID convs left
        eh = out.shape[2] - 2 * x.shape[2]
        ew = out.shape[3] - 2 * x.shape[3]
        return out[:, :, eh // 2:eh // 2 + 2 * x.shape[2],
                   ew // 2:ew // 2 + 2 * x.shape[3]]

    @torch.inference_mode()
    def _upscale_u8(self, img: Image.Image, passes: int) -> np.ndarray:
        x = torch.from_numpy(np.array(img.convert('RGB'))).to(
            self.device).float().permute(2, 0, 1)[None] / 255.0
        for _ in range(passes):
            x = self._run_2x(x)
        out = (torch.clamp(x[0], 0, 1) * 255.0).to(torch.uint8)
        return np.ascontiguousarray(out.permute(1, 2, 0).cpu().numpy())

    async def _infer(self, image_batch: List[Image.Image],
                     upscale_ratio: float) -> List[Image.Image]:
        results = []
        for img in image_batch:
            passes = 1 if upscale_ratio <= 2 else 2
            res = Image.fromarray(self._upscale_u8(img, passes))
            native = 2 ** passes
            if upscale_ratio != native:
                res = res.resize(
                    (int(round(img.size[0] * upscale_ratio)),
                     int(round(img.size[1] * upscale_ratio))),
                    resample=Image.Resampling.BILINEAR)
            results.append(res)
        return results
