"""manga-colorization-v2 (``mc2``) colorizer — PyTorch port.

Counterpart of the JAX package's ``colorization/manga_colorization_v2.py``
(reference ``colorization/manga_colorization_v2.py:14-74``): FFDNet
denoising at ``denoise_sigma`` over the whole page (edge-padded to even
sides), ``resize_pad`` to a multiple of 32 (≤ 576 works best), the gray
channel plus a zero 4-channel colour hint → generator → [-1, 1] output
rescaled to an RGB image. Both networks run on the device; the resize and
padding stay on the host, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Tuple

import cv2
import numpy as np
import torch
from PIL import Image

from ..models import mc2
from .common import OfflineColorizer


def resize_pad(img: np.ndarray, size: int = 256):
    """reference utils.resize_pad: fit the short side, pad to multiple of 32
    with 'maximum' padding, return the grayscale first channel."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, 2)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    if img.shape[0] < img.shape[1]:
        height = img.shape[0]
        ratio = height / (size * 1.5)
        width = int(np.ceil(img.shape[1] / ratio))
        img = cv2.resize(img, (width, int(size * 1.5)),
                         interpolation=cv2.INTER_AREA)
        pad = (0, 32 - width % 32)
        img = np.pad(img, ((0, 0), (0, pad[1]), (0, 0)), 'maximum')
    else:
        width = img.shape[1]
        ratio = width / size
        height = int(np.ceil(img.shape[0] / ratio))
        img = cv2.resize(img, (size, height), interpolation=cv2.INTER_AREA)
        pad = (32 - height % 32, 0)
        img = np.pad(img, ((0, pad[0]), (0, 0), (0, 0)), 'maximum')
    if img.dtype == np.float32:
        np.clip(img, 0, 1, out=img)
    return img[:, :, :1], pad


class MangaColorizationV2(OfflineColorizer):
    _MODEL_SUB_DIR = 'colorization/manga-colorization-v2'
    _MODEL_MAPPING = {
        'generator': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/manga-colorization-v2-generator.zip',
            'file': 'generator.zip',
            'hash': '087e6a0bc02770e732a52f33878b71a272a6123c9ac649e9b5bfb75e39e5c1d5',
        },
        'denoiser': {
            'url': 'https://github.com/zyddnys/manga-image-translator/releases'
                   '/download/beta-0.3/manga-colorization-v2-net_rgb.pth',
            'file': 'net_rgb.pth',
            'hash': '0fe98bfd2ac870b15f360661b1c4789eecefc6dc2e4462842a0dd15e149a0433',
        },
    }

    def __init__(self):
        super().__init__()
        self.generator = None
        self.denoiser = None
        self.device = None
        # (kind, (H, W)) of every network forward, in order; callers may
        # clear it
        self.forwards: List[Tuple[str, Tuple[int, int]]] = []

    async def _load(self, device: str):
        self.device = torch.device(device)
        gen = self.load_state_dict('generator',
                                   init_fn=mc2.init_generator_state_dict)
        gen = {k.removeprefix('generator.'): v for k, v in gen.items()
               if not k.startswith('discriminator')}
        self.generator = mc2.build_generator(gen, self.device)
        den = self.load_state_dict('denoiser',
                                   init_fn=mc2.init_ffdnet_state_dict)
        den = {k.removeprefix('module.'): v for k, v in den.items()}
        self.denoiser = mc2.build_ffdnet(den, self.device)

    async def _unload(self):
        self.generator = None
        self.denoiser = None

    @torch.inference_mode()
    def _denoise(self, padded: np.ndarray, sigma: float) -> np.ndarray:
        self.forwards.append(('ffdnet', padded.shape[:2]))
        x = torch.from_numpy(padded).to(self.device)[None]
        noise = mc2.ffdnet_rgb_forward(
            self.denoiser, x, torch.tensor([sigma], device=self.device))
        return torch.clamp(x[0] - noise[0], 0, 1).cpu().numpy()

    @torch.inference_mode()
    def _colorize_sketch(self, sketch: np.ndarray) -> np.ndarray:
        self.forwards.append(('generator', sketch.shape[:2]))
        fake, _ = mc2.generator_forward(
            self.generator, torch.from_numpy(sketch).to(self.device)[None])
        return fake[0].cpu().numpy()

    async def _infer(self, image: Image.Image, colorization_size: int,
                     denoise_sigma: int = 25, **kwargs) -> Image.Image:
        img = np.array(image.convert('RGBA'))
        max_size = min(*img.shape[:2])
        max_size -= max_size % 32
        if colorization_size > 0:
            size = min(max_size, colorization_size
                       - (colorization_size % 32))
        else:
            size = min(max_size, 576)  # ≤576 gives best results

        rgb = img[:, :, :3].astype(np.float32) / 255.0
        if 0 <= denoise_sigma <= 255:
            h, w = rgb.shape[:2]
            eh, ew = h + (h % 2), w + (w % 2)
            padded = np.pad(rgb, ((0, eh - h), (0, ew - w), (0, 0)),
                            mode='edge')
            rgb = self._denoise(padded, denoise_sigma / 255.0)[:h, :w]

        gray, pad = resize_pad(rgb.astype(np.float32), size)
        h, w = gray.shape[:2]
        hint = np.zeros((h, w, 4), np.float32)
        sketch = np.ascontiguousarray(np.concatenate([gray, hint], axis=-1))

        result = self._colorize_sketch(sketch) * 0.5 + 0.5
        if pad[0] != 0:
            result = result[:-pad[0]]
        if pad[1] != 0:
            result = result[:, :-pad[1]]
        return Image.fromarray(
            np.clip(result * 255, 0, 255).astype(np.uint8))
