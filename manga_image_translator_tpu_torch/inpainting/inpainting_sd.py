"""Stable-Diffusion guided inpainting — PyTorch port.

Counterpart of the JAX package's ``inpainting/inpainting_sd.py``
(reference ``inpainting/inpainting_sd.py`` + ``guided_ldm_inpainting.py``
img2img_inpaint :157-254): blur-fill the masked region, Gaussian-blur the
mask (16 px), VAE-encode, replace the masked latents with noise, sample
with classifier-free guidance 7 while re-noising the unmasked region from
the init latent at every step, blend the latents by the mask, VAE-decode,
composite with the original at full resolution. Prompts come from the
booru tagger when its ONNX file and tag list are present ('masterpiece,
best quality' + tags); the negative prompt is fixed.

The samplers (DPM-Solver++(2M), 15 steps, by default; DDIM, 50) are Python
loops over the steps: the schedule tensors live on the device and are
indexed by Python ints, so the loop never waits for the device. Every
Gaussian draw (the two VAE samples, the latent init, the sampler's first
noise and each step's re-noising) goes through one ``draw(shape)``
callable, in the JAX package's order of key splits; by default it is
``torch.randn`` on the inpainter's device from a ``torch.Generator``
seeded by ``MIT_TPU_SD_SEED`` (else ``os.urandom``). The JAX package's
``MIT_TPU_SD_SAMPLER``, ``MIT_TPU_SD_STEPS`` and ``MIT_TPU_SD_SEED`` are
read as there.

The checkpoint is read with ``utils/safetensors_lite`` (the card's machine
has no ``safetensors`` package). Without it, random weights at
``SDConfig.tiny()`` (``MIT_TPU_ALLOW_RANDOM_WEIGHTS=1`` only).
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import cv2
import numpy as np
import torch

from ..config import InpainterConfig
from ..models import sd
from ..utils.inference import MissingWeightsError, random_weights_allowed
from .common import OfflineInpainter

NEG_PROMPT = ('worst quality, low quality, normal quality,'
              'text,text,text,text')
CHECKPOINT = 'abyssorangemix2_Hard-inpainting.safetensors'
GUIDANCE = 7.0

Draw = Callable[[Tuple[int, ...]], torch.Tensor]


def torch_draw(seed: int, device) -> Draw:
    """Standard normal f32 tensors of the asked shapes on ``device``, from
    one ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)
    return draw


def _schedule(steps: int, device):
    """The schedule's tensors on ``device`` and its timesteps on the host
    (to index ``alphas_cumprod`` without reading the device)."""
    sch = sd.make_ddim_schedule(steps)
    return ({k: torch.as_tensor(v, device=device) for k, v in sch.items()},
            [int(t) for t in sch['timesteps']])


def _guided_eps(model: sd.SDModel, x, image_cdt, step, cond, uncond,
                guidance: float):
    """Classifier-free guided eps: two batch-1 UNet forwards (uncond, then
    cond) on the hybrid input."""
    x_in = torch.cat([x, image_cdt], dim=1)
    eps_u = model.unet(x_in, step, uncond)
    eps_c = model.unet(x_in, step, cond)
    return eps_u + guidance * (eps_c - eps_u)


def _renoise(x, init_latent, nmask, a_full, draw: Draw):
    """Re-noise the unmasked region from the init latent (q_sample)."""
    qn = draw(tuple(x.shape))
    noised = torch.sqrt(a_full) * init_latent + torch.sqrt(1 - a_full) * qn
    return (1 - nmask) * noised + nmask * x


def _finish(model: sd.SDModel, x, init_latent, nmask):
    x = init_latent * (1 - nmask) + x * nmask
    return torch.clamp(model.vae.decode(x), -1.0, 1.0)


@torch.inference_mode()
def _ddim_inpaint(model: sd.SDModel, init_latent, nmask, cond, uncond,
                  image_cdt, draw: Draw, steps: int,
                  guidance: float = GUIDANCE) -> torch.Tensor:
    """Guided DDIM decode (eta 0) -> (1, 3, H, W) in [-1, 1].

    init_latent (1, z, h, w) scaled init latent; nmask (1, 1, h, w) in
    {0, 1}; cond / uncond (1, L, ctx); image_cdt (1, 5, h, w) hybrid
    conditioning (mask + masked-image latent)."""
    sch, host_steps = _schedule(steps, init_latent.device)
    t_enc = min(int(0.999 * steps), steps)
    noise = draw(tuple(init_latent.shape))
    a_enc = sch['alphas'][t_enc - 1]
    x = torch.sqrt(a_enc) * init_latent + torch.sqrt(1 - a_enc) * noise
    for i in range(t_enc):
        idx = t_enc - 1 - i
        step = sch['timesteps'][idx:idx + 1]
        x = _renoise(x, init_latent, nmask,
                     sch['alphas_cumprod'][host_steps[idx]], draw)
        eps = _guided_eps(model, x, image_cdt, step, cond, uncond, guidance)
        a_t, a_prev = sch['alphas'][idx], sch['alphas_prev'][idx]
        pred_x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        x = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1 - a_prev) * eps
    return _finish(model, x, init_latent, nmask)


def _lam(a):
    """log-SNR: log(alpha / sigma), alpha = sqrt(a), sigma = sqrt(1 - a)."""
    return 0.5 * (torch.log(a) - torch.log1p(-a))


@torch.inference_mode()
def _dpmpp_inpaint(model: sd.SDModel, init_latent, nmask, cond, uncond,
                   image_cdt, draw: Draw, steps: int,
                   guidance: float = GUIDANCE) -> torch.Tensor:
    """Guided DPM-Solver++(2M) decode (multistep data prediction, eta 0),
    carrying the previous data prediction for the second-order correction;
    arguments as ``_ddim_inpaint``."""
    sch, host_steps = _schedule(steps, init_latent.device)
    t_enc = min(int(0.999 * steps), steps)
    noise = draw(tuple(init_latent.shape))
    a_enc = sch['alphas'][t_enc - 1]
    x = torch.sqrt(a_enc) * init_latent + torch.sqrt(1 - a_enc) * noise
    x0_prev = h_prev = None
    for i in range(t_enc):
        idx = t_enc - 1 - i
        step = sch['timesteps'][idx:idx + 1]
        x = _renoise(x, init_latent, nmask,
                     sch['alphas_cumprod'][host_steps[idx]], draw)
        eps = _guided_eps(model, x, image_cdt, step, cond, uncond, guidance)
        a_t, a_next = sch['alphas'][idx], sch['alphas_prev'][idx]
        sig_t, sig_next = torch.sqrt(1 - a_t), torch.sqrt(1 - a_next)
        x0 = (x - sig_t * eps) / torch.sqrt(a_t)
        h = _lam(a_next) - _lam(a_t)
        if i == 0:
            d = x0
        else:
            r = h_prev / h
            d = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * x0_prev
        x = (sig_next / sig_t) * x - torch.sqrt(a_next) * torch.expm1(-h) * d
        x0_prev, h_prev = x0, h
    return _finish(model, x, init_latent, nmask)


SAMPLERS = {'ddim': _ddim_inpaint, 'dpmpp_2m': _dpmpp_inpaint}


def _fill_mask_input(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Blur-fill masked regions from the surrounding colours (reference
    fill_mask_input :135-151, PIL alpha-composite pyramid); the JAX
    package's cv2 variant."""
    out = image.astype(np.float32)
    m = (mask > 127).astype(np.float32)[:, :, None]
    filled = out * (1 - m)
    weight = 1 - m
    for radius in (256, 64, 16, 4, 2):
        k = max(1, int(radius) | 1)
        b_img = cv2.GaussianBlur(filled, (0, 0), k / 3.0 + 1e-3)
        b_w = cv2.GaussianBlur(weight[:, :, 0], (0, 0), k / 3.0 + 1e-3)
        safe = np.where(b_w > 1e-4, b_w, 1.0)[:, :, None]
        cand = b_img / safe
        fill_now = (weight[:, :, 0] < 0.5) & (b_w > 1e-4)
        filled[fill_now] = (filled[fill_now] * weight[fill_now]
                            + cand[fill_now] * (1 - weight[fill_now]))
        weight[:, :, 0][fill_now] = 1.0
    return np.clip(filled, 0, 255).astype(np.uint8)


class SimpleCLIPTokenizer:
    """CLIP tokenizer: ``transformers``' CLIPTokenizer from its local cache
    when it is importable, cached and of the text tower's vocabulary size
    (the port never downloads), else a
    hash tokenizer over the comma-separated words, allowed only with random
    weights (``require_real=False``): with real SD weights a missing
    vocabulary raises instead of giving garbage conditioning. The hash
    depends on the process's ``PYTHONHASHSEED``."""

    def __init__(self, vocab_size: int, max_tokens: int,
                 require_real: bool = False):
        self.vocab_size = vocab_size
        self.max_tokens = max_tokens
        self._hf = None
        err = None
        try:
            from transformers import CLIPTokenizer
            hf = CLIPTokenizer.from_pretrained(
                'openai/clip-vit-large-patch14', local_files_only=True)
            if len(hf) != vocab_size:
                raise ValueError(f'the cached tokenizer has {len(hf)} ids, '
                                 f'the text tower {vocab_size}')
            self._hf = hf
        except Exception as e:
            err = e
        if self._hf is None and require_real:
            raise MissingWeightsError(
                'StableDiffusionInpainter: CLIP tokenizer vocab unavailable '
                f'({err}); refusing hash-tokenizer conditioning with real '
                'SD weights. Provide the openai/clip-vit-large-patch14 '
                'tokenizer files in the HF cache.')

    def __call__(self, text: str) -> np.ndarray:
        if self._hf is not None:
            ids = self._hf(text, padding='max_length', truncation=True,
                           max_length=self.max_tokens)['input_ids']
            return np.asarray(ids, np.int32)[None]
        ids = [(hash(w) % (self.vocab_size - 3)) + 3
               for w in text.split(',') if w.strip()]
        ids = [1] + ids[:self.max_tokens - 2] + [2]
        ids += [0] * (self.max_tokens - len(ids))
        return np.asarray(ids, np.int32)[None]


class StableDiffusionInpainter(OfflineInpainter):
    """SD-1.5-inpaint (9-channel hybrid UNet) guided img2img inpainting.

    Checkpoint: the reference's abyssorangemix2 inpainting safetensors
    (inpainting_sd.py:48-52). The booru tagger (wd-swinv2 ONNX) is
    optional: without it the prompt is the quality prefix only. Every
    network runs on the device the inpainter is loaded on."""

    _MODEL_MAPPING = {
        'model': {
            'url': 'https://civitai.com/api/download/models/8364',
            'hash': 'dd680bd77d553e095faf58ff8c12584efe2a9b844e18bcc6ba2a366b'
                    '85caceb8',
            'file': CHECKPOINT,
        },
        'model_wd_swinv2': {
            'url': 'https://huggingface.co/SmilingWolf/'
                   'wd-v1-4-swinv2-tagger-v2/resolve/main/model.onnx',
            'hash': '04ec04fdf7db74b4fed7f4b52f52e04dec4dbad9e4d88d2d178f'
                    '334079a29fde',
            'file': 'wd_swinv2.onnx',
        },
        'model_wd_swinv2_csv': {
            'url': 'https://huggingface.co/SmilingWolf/'
                   'wd-v1-4-swinv2-tagger-v2/raw/main/selected_tags.csv',
            'hash': '8c8750600db36233a1b274ac88bd46289e588b338218c2e4c62bb'
                    'c9f2b516368',
            'file': 'selected_tags.csv',
        },
    }

    def __init__(self):
        super().__init__()
        self.model: Optional[sd.SDModel] = None
        self.cfg: Optional[sd.SDConfig] = None
        self.device: Optional[torch.device] = None
        self.tokenizer = None
        self.tagger = None
        # draw(seed, device) -> the sampler's noise source; tests replay
        # the JAX package's keys through it
        self.make_draw = torch_draw
        # (1, H, W) of every sampling run, in order; callers may clear it
        self.forwards: List[Tuple[int, int, int]] = []

    async def load(self, device: str = 'cuda'):
        # only the checkpoint decides random weights: the tagger files are
        # optional
        if self._loaded:
            return
        await self._load(device)
        self._loaded = True

    async def _load(self, device: str):
        self.device = torch.device(device)
        ckpt = self._get_file_path(CHECKPOINT)
        if ckpt.is_file():
            from ..utils import safetensors_lite
            self.cfg = sd.SDConfig()
            state = safetensors_lite.load(ckpt)
        else:
            if not random_weights_allowed(self):
                raise MissingWeightsError(
                    'StableDiffusionInpainter: checkpoint unavailable. '
                    'Set MIT_TPU_ALLOW_RANDOM_WEIGHTS=1 for smoke tests.')
            self.logger.warning('SD checkpoint unavailable — tiny random '
                                'config (smoke-test mode)')
            self.using_random_weights = True
            self.cfg = sd.SDConfig.tiny()
            state = sd.init_state_dict(self.cfg, device=self.device)
        self.model = sd.build_sd(self.cfg, self.device, state)
        del state
        self.tokenizer = SimpleCLIPTokenizer(
            self.cfg.vocab_size, self.cfg.max_tokens,
            require_real=not self.using_random_weights)
        tagger_path = self._get_file_path('wd_swinv2.onnx')
        tags_path = self._get_file_path('selected_tags.csv')
        if tagger_path.is_file() and tags_path.is_file():
            from .booru_tagger import Tagger
            self.tagger = Tagger(tagger_path, tags_path, device=self.device)
        else:
            self.logger.warning(
                'wd-swinv2 tagger artifacts unavailable — SD prompts use '
                'the quality prefix only (reference behavior needs '
                'wd_swinv2.onnx + selected_tags.csv)')

    async def _unload(self):
        self.model = None
        self.tagger = None

    def _tags(self, image: np.ndarray) -> str:
        """Booru tags for the prompt (reference inpainting_sd.py:108-111:
        label_cv2_bgr on the BGR page, '_' -> ' ', comma-joined)."""
        if self.tagger is None:
            return ''
        tags = self.tagger.label_cv2_bgr(
            cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
        self.logger.info(f'tags={list(tags)}')
        return ','.join(t.replace('_', ' ') for t in tags)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """(H, W[, C]) host array -> (1, C, H, W) f32 on the device."""
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if t.ndim == 2:
            t = t[..., None]
        return t.permute(2, 0, 1)[None].to(self.device)

    async def _infer(self, image: np.ndarray, mask: np.ndarray,
                     config: InpainterConfig, inpainting_size: int = 1024,
                     verbose: bool = False) -> np.ndarray:
        return self._inpaint_page(image, mask, inpainting_size)

    @torch.inference_mode()
    def _inpaint_page(self, image: np.ndarray, mask: np.ndarray,
                      inpainting_size: int) -> np.ndarray:
        """The page's inpainted composite."""
        img_original = np.copy(image)
        mask_original = (np.copy(mask) >= 127).astype(np.uint8)[:, :, None]
        height, width = image.shape[:2]

        if max(image.shape[:2]) > inpainting_size:
            ratio = inpainting_size / max(height, width)
            new_size = (round(width * ratio), round(height * ratio))
            image = cv2.resize(image, new_size,
                               interpolation=cv2.INTER_LINEAR)
            mask = cv2.resize(mask, new_size,
                              interpolation=cv2.INTER_LINEAR)
        pad = 64
        h, w = image.shape[:2]
        new_h = h + ((-h) % pad)
        new_w = w + ((-w) % pad)
        if (new_h, new_w) != (h, w):
            image = cv2.resize(image, (new_w, new_h),
                               interpolation=cv2.INTER_LINEAR)
            mask = cv2.resize(mask, (new_w, new_h),
                              interpolation=cv2.INTER_LINEAR)
        self.logger.info(f'Inpainting resolution: {new_w}x{new_h}')
        self.forwards.append((1, new_h, new_w))
        tags = self._tags(image)
        pos = 'masterpiece,best quality' + (',' + tags if tags else '')
        sampler = os.environ.get('MIT_TPU_SD_SAMPLER', 'dpmpp_2m')
        sample_fn = SAMPLERS[sampler]
        steps = int(os.environ.get(
            'MIT_TPU_SD_STEPS', '15' if sampler == 'dpmpp_2m' else '50'))

        # mask blur + blur fill (reference img2img_inpaint :216-222)
        mask_blur = cv2.GaussianBlur(mask, (0, 0), 16 / 3.0)
        image_filled = _fill_mask_input(image, mask_blur)

        seed = (int.from_bytes(os.urandom(4), 'little')
                if os.environ.get('MIT_TPU_SD_SEED') is None
                else int(os.environ['MIT_TPU_SD_SEED']))
        draw = self.make_draw(seed, self.device)
        model, scale = self.model, self.cfg.scale_factor

        img_t = self._to_device(image_filled) / 127.5 - 1.0
        moments = model.vae.encode_moments(img_t)
        mean_shape = (moments.shape[0], moments.shape[1] // 2,
                      *moments.shape[2:])
        init_latent = sd.vae_sample(moments, draw(mean_shape), scale)

        lh, lw = init_latent.shape[2:]
        latmask = cv2.resize(mask_blur, (lw, lh),
                             interpolation=cv2.INTER_LINEAR)
        latmask = np.around(latmask.astype(np.float32) / 255.0)
        nmask = self._to_device(latmask)
        init_latent = ((1 - nmask) * init_latent
                       + nmask * draw(tuple(init_latent.shape)))

        # hybrid image conditioning: rounded mask + masked-image latent
        cond_mask_px = np.round(mask_blur.astype(np.float32) / 255.0)
        cond_img = img_t * (1.0 - self._to_device(cond_mask_px))
        cmoments = model.vae.encode_moments(cond_img)
        cond_latent = sd.vae_sample(cmoments, draw(mean_shape), scale)
        cond_mask_lat = self._to_device(cv2.resize(
            cond_mask_px, (lw, lh), interpolation=cv2.INTER_NEAREST))
        image_cdt = torch.cat([cond_mask_lat, cond_latent], dim=1)

        def embed(text):
            tokens = torch.from_numpy(self.tokenizer(text).astype(
                np.int64)).to(self.device)
            return model.clip(tokens)
        cond, uncond = embed(pos), embed(NEG_PROMPT)
        out = sample_fn(model, init_latent, nmask, cond, uncond, image_cdt,
                        draw, steps)
        img_inpainted = torch.clamp(torch.round((out[0] + 1.0) * 127.5), 0,
                                    255).to(torch.uint8)
        img_inpainted = img_inpainted.permute(1, 2, 0).cpu().numpy()
        if img_inpainted.shape[:2] != (height, width):
            img_inpainted = cv2.resize(img_inpainted, (width, height),
                                       interpolation=cv2.INTER_LINEAR)
        return (img_inpainted * mask_original
                + img_original * (1 - mask_original)).astype(np.uint8)
