"""Stable Diffusion inpainting stack (UNet + VAE + CLIP text) — PyTorch port.

Counterpart of the JAX package's ``models/sd.py`` (reference ldm tree as
configured by ``inpainting/guided_ldm_inpaint9_v15.yaml``): the SD-1.x
9-channel hybrid-conditioned UNet (``openaimodel.py`` UNetModel), the
AutoencoderKL (``ldm/models/autoencoder.py``) and the CLIP ViT-L/14 text
tower (``FrozenCLIPEmbedder``, last hidden state).

Parameter names are the checkpoint's own: ``SDModel``'s state dict keys are
``model.diffusion_model.*``, ``first_stage_model.*`` and
``cond_stage_model.transformer.text_model.*``, so a released checkpoint
loads with ``load_state_dict`` as it is (``checkpoint_state_dict`` drops the
other keys of an ldm checkpoint and the text tower's ``position_ids``
buffer). NCHW, f32 compute; the timestep embedding and the text context
are cast to the latent's dtype, as in the JAX package.

Details kept from the JAX package: group norms use ``min(32, C)`` groups,
eps 1e-6 in the VAE and the spatial transformer's ``norm``, 1e-5 in the
UNet's res blocks and ``out.0``; GEGLU with the erf GELU; CLIP's
``quick_gelu`` and causal mask; the VAE encoder pads (0, 1, 0, 1) before
each stride-2 conv; ``vae_sample`` clips the log-variance to [-30, 20];
nearest x2 upsampling; the UNet's skip-concat order.

Attention is plain matmul -> softmax -> matmul in query chunks of at most
``ATTN_QCHUNK`` rows, the last chunk short. The JAX package chunks only
when the query length is a multiple of the chunk; here every length over
the chunk is chunked: a 1448x2048 page at inpainting_size 2048 has a
184x256 latent (47,104 tokens), whose unchunked scores would take 71 GB in
the UNet's top level (8 heads) and 8.9 GB in the VAE's mid attention.
No Pallas kernel stands behind any of this in the JAX package: plain
PyTorch (cuBLAS, cuDNN) is the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..weights import load_state_dict_into

# Above this query length, attention runs in query chunks; the live scores
# are then at most (heads, ATTN_QCHUNK, Lk) per batch row.
ATTN_QCHUNK = 4096

EMBEDDING_PATTERNS = (
    r'cond_stage_model\.transformer\.text_model\.embeddings\..*\.weight',
)
PREFIXES = ('model.diffusion_model.', 'first_stage_model.',
            'cond_stage_model.transformer.text_model.')


@dataclass(frozen=True)
class SDConfig:
    """Shapes of the SD stack (the JAX package's); ``tiny()`` exercises the
    same code paths in tests."""
    in_channels: int = 9
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (1, 2, 4)   # downsample factors
    num_heads: int = 8
    context_dim: int = 768
    transformer_depth: int = 1
    # VAE
    vae_channels: int = 128
    vae_ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    vae_num_res: int = 2
    z_channels: int = 4
    scale_factor: float = 0.18215
    # CLIP text
    vocab_size: int = 49408
    max_tokens: int = 77
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12

    @staticmethod
    def tiny() -> 'SDConfig':
        return SDConfig(model_channels=32, channel_mult=(1, 2),
                        num_res_blocks=1, attention_resolutions=(1, 2),
                        num_heads=2, context_dim=64, vae_channels=32,
                        vae_ch_mult=(1, 2), vae_num_res=1, vocab_size=97,
                        max_tokens=16, text_width=64, text_layers=2,
                        text_heads=2)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """(B,) int timesteps -> (B, dim) sinusoidal embedding (ldm util)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """(B, Lq, C), (B, Lk, C), (B, Lk, C) -> (B, Lq, C): softmax(q k^T /
    sqrt(d)) v per head, in query chunks of at most ``ATTN_QCHUNK``."""
    b, lq, c = q.shape
    lk = k.shape[1]
    hd = c // heads
    q = q.reshape(b, lq, heads, hd).transpose(1, 2)
    kt = k.reshape(b, lk, heads, hd).permute(0, 2, 3, 1)
    v = v.reshape(b, lk, heads, hd).transpose(1, 2)
    scale = hd ** -0.5
    outs = []
    for s in range(0, lq, ATTN_QCHUNK):
        scores = torch.matmul(q[:, :, s:s + ATTN_QCHUNK], kt) * scale
        outs.append(torch.matmul(scores.softmax(-1), v))
        del scores
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 2)
    return out.transpose(1, 2).reshape(b, lq, c)


def _gn(c: int, eps: float) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, c), c, eps=eps)


# --------------------------------------------------------------------------
# UNet
# --------------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, ci: int, co: int, emb: int):
        super().__init__()
        self.in_layers = nn.Sequential(_gn(ci, 1e-5), nn.SiLU(),
                                       nn.Conv2d(ci, co, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb, co))
        self.out_layers = nn.Sequential(_gn(co, 1e-5), nn.SiLU(),
                                        nn.Identity(),
                                        nn.Conv2d(co, co, 3, padding=1))
        self.skip_connection = (nn.Conv2d(ci, co, 1) if ci != co
                                else nn.Identity())

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        h = self.out_layers(h)
        return self.skip_connection(x) + h


class CrossAttention(nn.Module):
    def __init__(self, c: int, kv: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(kv, c, bias=False)
        self.to_v = nn.Linear(kv, c, bias=False)
        self.to_out = nn.Sequential(nn.Linear(c, c), nn.Identity())

    def forward(self, x, context):
        return self.to_out(attention(self.to_q(x), self.to_k(context),
                                     self.to_v(context), self.heads))


class GEGLU(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.proj = nn.Linear(c, c * 8)

    def forward(self, x):
        a, b = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(b)


class BasicTransformerBlock(nn.Module):
    def __init__(self, c: int, context_dim: int, heads: int):
        super().__init__()
        self.attn1 = CrossAttention(c, c, heads)
        self.ff = nn.Module()
        self.ff.net = nn.Sequential(GEGLU(c), nn.Identity(),
                                    nn.Linear(c * 4, c))
        self.attn2 = CrossAttention(c, context_dim, heads)
        self.norm1 = nn.LayerNorm(c)
        self.norm2 = nn.LayerNorm(c)
        self.norm3 = nn.LayerNorm(c)

    def forward(self, t, context):
        n1 = self.norm1(t)
        t = t + self.attn1(n1, n1)
        t = t + self.attn2(self.norm2(t), context)
        return t + self.ff.net(self.norm3(t))


class SpatialTransformer(nn.Module):
    def __init__(self, c: int, context_dim: int, heads: int):
        super().__init__()
        self.norm = _gn(c, 1e-6)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(c, context_dim, heads)])
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x, context):
        n, c, h, w = x.shape
        t = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        t = self.transformer_blocks[0](t, context)
        t = t.transpose(1, 2).reshape(n, c, h, w)
        return self.proj_out(t) + x


class Downsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.op = nn.Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode='nearest'))


class UNet(nn.Module):
    """x (B, in_channels, H, W) latent input, t (B,) timesteps, context
    (B, L, context_dim) -> (B, 4, H, W) eps."""

    def __init__(self, cfg: SDConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        emb = mc * 4
        self.time_embed = nn.Sequential(nn.Linear(mc, emb), nn.SiLU(),
                                        nn.Linear(emb, emb))
        ctx, heads = cfg.context_dim, cfg.num_heads
        blocks = [nn.ModuleList([nn.Conv2d(cfg.in_channels, mc, 3,
                                           padding=1)])]
        ch, ds, in_chs = mc, 1, [mc]
        for level, mult in enumerate(cfg.channel_mult):
            co = mc * mult
            for _ in range(cfg.num_res_blocks):
                layers = [ResBlock(ch, co, emb)]
                if ds in cfg.attention_resolutions:
                    layers.append(SpatialTransformer(co, ctx, heads))
                blocks.append(nn.ModuleList(layers))
                ch = co
                in_chs.append(ch)
            if level != len(cfg.channel_mult) - 1:
                blocks.append(nn.ModuleList([Downsample(ch)]))
                in_chs.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([
            ResBlock(ch, ch, emb), SpatialTransformer(ch, ctx, heads),
            ResBlock(ch, ch, emb)])
        blocks = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            co = mc * mult
            for i in range(cfg.num_res_blocks + 1):
                layers = [ResBlock(ch + in_chs.pop(), co, emb)]
                if ds in cfg.attention_resolutions:
                    layers.append(SpatialTransformer(co, ctx, heads))
                if level != 0 and i == cfg.num_res_blocks:
                    layers.append(Upsample(co))
                    ds //= 2
                blocks.append(nn.ModuleList(layers))
                ch = co
        self.output_blocks = nn.ModuleList(blocks)
        self.out = nn.Sequential(_gn(mc, 1e-5), nn.SiLU(),
                                 nn.Conv2d(mc, cfg.out_channels, 3,
                                           padding=1))

    @staticmethod
    def _run(layers, h, emb, context):
        for layer in layers:
            if isinstance(layer, ResBlock):
                h = layer(h, emb)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, context)
            else:
                h = layer(h)
        return h

    def forward(self, x, t, context):
        emb = self.time_embed(timestep_embedding(
            t, self.cfg.model_channels)).to(x.dtype)
        context = context.to(x.dtype)
        hs: List[torch.Tensor] = []
        h = x
        for layers in self.input_blocks:
            h = self._run(layers, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb,
                          context)
        return self.out(h)


# --------------------------------------------------------------------------
# VAE (AutoencoderKL)
# --------------------------------------------------------------------------

class VaeResnet(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.norm1 = _gn(ci, 1e-6)
        self.conv1 = nn.Conv2d(ci, co, 3, padding=1)
        self.norm2 = _gn(co, 1e-6)
        self.conv2 = nn.Conv2d(co, co, 3, padding=1)
        if ci != co:
            self.nin_shortcut = nn.Conv2d(ci, co, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, 'nin_shortcut'):
            x = self.nin_shortcut(x)
        return x + h


class VaeAttn(nn.Module):
    """Single-head attention over the h*w tokens (query-chunked)."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _gn(c, 1e-6)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        n, c, h, w = x.shape
        xn = self.norm(x)

        def tokens(conv):
            return conv(xn).flatten(2).transpose(1, 2)
        out = attention(tokens(self.q), tokens(self.k), tokens(self.v), 1)
        return x + self.proj_out(out.transpose(1, 2).reshape(n, c, h, w))


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = VaeResnet(c, c)
        self.attn_1 = VaeAttn(c)
        self.block_2 = VaeResnet(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class _Level(nn.Module):
    """One encoder / decoder level: its ``block`` resnets; the caller sets
    ``downsample`` or ``upsample`` (a holder of ``conv``) where the level
    resamples."""

    def __init__(self, blocks):
        super().__init__()
        self.block = nn.ModuleList(blocks)


def _conv_holder(conv: nn.Conv2d) -> nn.Module:
    holder = nn.Module()
    holder.conv = conv
    return holder


class Encoder(nn.Module):
    def __init__(self, cfg: SDConfig):
        super().__init__()
        vc = cfg.vae_channels
        self.conv_in = nn.Conv2d(3, vc, 3, padding=1)
        ch, levels = vc, []
        for level, mult in enumerate(cfg.vae_ch_mult):
            co = vc * mult
            blocks = []
            for _ in range(cfg.vae_num_res):
                blocks.append(VaeResnet(ch, co))
                ch = co
            lv = _Level(blocks)
            if level != len(cfg.vae_ch_mult) - 1:
                lv.downsample = _conv_holder(nn.Conv2d(ch, ch, 3, stride=2))
            levels.append(lv)
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(ch)
        self.norm_out = _gn(ch, 1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for lv in self.down:
            for blk in lv.block:
                h = blk(h)
            if hasattr(lv, 'downsample'):
                # ldm pads asymmetrically (0, 1, 0, 1) before the s2 conv
                h = lv.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: SDConfig):
        super().__init__()
        vc = cfg.vae_channels
        ch = vc * cfg.vae_ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, ch, 3, padding=1)
        self.mid = _Mid(ch)
        levels: Dict[int, _Level] = {}
        for level in reversed(range(len(cfg.vae_ch_mult))):
            co = vc * cfg.vae_ch_mult[level]
            blocks = []
            for _ in range(cfg.vae_num_res + 1):
                blocks.append(VaeResnet(ch, co))
                ch = co
            levels[level] = _Level(blocks)
            if level:
                levels[level].upsample = _conv_holder(
                    nn.Conv2d(ch, ch, 3, padding=1))
        self.up = nn.ModuleList([levels[i] for i in range(len(levels))])
        self.norm_out = _gn(ch, 1e-6)
        self.conv_out = nn.Conv2d(ch, 3, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for lv in reversed(self.up):
            for blk in lv.block:
                h = blk(h)
            if hasattr(lv, 'upsample'):
                h = lv.upsample.conv(F.interpolate(h, scale_factor=2,
                                                   mode='nearest'))
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: SDConfig):
        super().__init__()
        self.cfg = cfg
        z = cfg.z_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * z, 2 * z, 1)
        self.post_quant_conv = nn.Conv2d(z, z, 1)

    def encode_moments(self, x):
        """(B, 3, H, W) in [-1, 1] -> (B, 2z, H/8, W/8) moments (mean |
        logvar)."""
        return self.quant_conv(self.encoder(x))

    def decode(self, z):
        """(B, z, h, w) scaled latent -> (B, 3, 8h, 8w) in about [-1, 1]."""
        return self.decoder(self.post_quant_conv(z / self.cfg.scale_factor))


def vae_sample(moments: torch.Tensor, noise: torch.Tensor,
               scale_factor: float) -> torch.Tensor:
    """The scaled latent of the moments' Gaussian at ``noise`` (the mean's
    shape)."""
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return scale_factor * (mean + std * noise)


# --------------------------------------------------------------------------
# CLIP text encoder (ViT-L/14 text tower)
# --------------------------------------------------------------------------

class _ClipAttention(nn.Module):
    def __init__(self, w: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w)
        self.v_proj = nn.Linear(w, w)
        self.out_proj = nn.Linear(w, w)

    def forward(self, x, causal):
        b, l, c = x.shape
        hd = c // self.heads

        def heads(t):
            return t.reshape(b, l, self.heads, hd).transpose(1, 2)
        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), \
            heads(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
        w = (scores + causal).softmax(-1)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, l, c)
        return self.out_proj(out)


class _ClipMlp(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.fc1 = nn.Linear(w, w * 4)
        self.fc2 = nn.Linear(w * 4, w)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class _ClipLayer(nn.Module):
    def __init__(self, w: int, heads: int):
        super().__init__()
        self.self_attn = _ClipAttention(w, heads)
        self.layer_norm1 = nn.LayerNorm(w)
        self.mlp = _ClipMlp(w)
        self.layer_norm2 = nn.LayerNorm(w)

    def forward(self, x, causal):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class _ClipTextTransformer(nn.Module):
    def __init__(self, cfg: SDConfig):
        super().__init__()
        w = cfg.text_width
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.embeddings.position_embedding = nn.Embedding(cfg.max_tokens, w)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [_ClipLayer(w, cfg.text_heads) for _ in range(cfg.text_layers)])
        self.final_layer_norm = nn.LayerNorm(w)

    def forward(self, tokens):
        L = tokens.shape[1]
        pos = torch.arange(L, device=tokens.device)
        x = (self.embeddings.token_embedding(tokens)
             + self.embeddings.position_embedding(pos)[None])
        causal = torch.full((L, L), float('-inf'), dtype=x.dtype,
                            device=x.device).triu(1)
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)


class CLIPTextModel(nn.Module):
    """(B, L) int tokens -> (B, L, width) final hidden states."""

    def __init__(self, cfg: SDConfig):
        super().__init__()
        self.text_model = _ClipTextTransformer(cfg)

    def forward(self, tokens):
        return self.text_model(tokens)


# --------------------------------------------------------------------------
# the checkpoint's module tree
# --------------------------------------------------------------------------

class SDModel(nn.Module):
    """The three networks under the checkpoint's key names: ``unet``,
    ``vae`` and ``clip`` name them."""

    def __init__(self, cfg: SDConfig):
        super().__init__()
        self.cfg = cfg
        self.model = nn.Module()
        self.model.diffusion_model = UNet(cfg)
        self.first_stage_model = AutoencoderKL(cfg)
        self.cond_stage_model = nn.Module()
        self.cond_stage_model.transformer = CLIPTextModel(cfg)

    @property
    def unet(self) -> UNet:
        return self.model.diffusion_model

    @property
    def vae(self) -> AutoencoderKL:
        return self.first_stage_model

    @property
    def clip(self) -> CLIPTextModel:
        return self.cond_stage_model.transformer


def checkpoint_state_dict(sd: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """The keys of the three networks out of an ldm checkpoint (its EMA
    copy, schedule buffers and the text tower's ``position_ids`` go)."""
    return {k: v for k, v in sd.items()
            if k.startswith(PREFIXES) and not k.endswith('position_ids')}


def build_sd(cfg: SDConfig, device, state_dict: Dict[str, torch.Tensor]
             ) -> SDModel:
    """An eval-mode ``SDModel`` on ``device`` holding ``state_dict``
    (checkpoint keys, any float dtype; cast to f32). The module is laid
    out on the meta device first, so no random init runs."""
    with torch.device('meta'):
        model = SDModel(cfg)
    model = model.to_empty(device=torch.device(device)).eval()
    load_state_dict_into(model, checkpoint_state_dict(state_dict))
    return model


def init_state_dict(cfg: SDConfig = SDConfig.tiny(), seed: int = 11,
                    device='cpu', dtype=torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """Random weights at the JAX ``init_params``'s scales (He-normal convs,
    1/sqrt(fan_in) dense layers, unit norms, zero biases, token / position
    embeddings at 0.02 / 0.01), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    with torch.device('meta'):
        shapes = {k: (tuple(v.shape), k.split('.')[-1])
                  for k, v in SDModel(cfg).state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for key, (shape, leaf) in shapes.items():
        if leaf == 'bias':
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        if len(shape) == 1:                       # group / layer norm scale
            out[key] = torch.ones(shape, dtype=dtype, device=device)
            continue
        if key.endswith('token_embedding.weight'):
            std = 0.02
        elif key.endswith('position_embedding.weight'):
            std = 0.01
        elif len(shape) == 4:
            std = math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
        else:
            std = 1.0 / math.sqrt(shape[1])
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std
        out[key] = w.to(dtype)
    return out


# --------------------------------------------------------------------------
# DDIM schedule (uniform discretize, eta 0) — reference ddim.py semantics
# --------------------------------------------------------------------------

def make_ddim_schedule(num_steps: int, num_train_steps: int = 1000,
                       linear_start: float = 0.00085,
                       linear_end: float = 0.0120) -> Dict[str, np.ndarray]:
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                        num_train_steps, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    c = num_train_steps // num_steps
    ddim_timesteps = np.arange(0, num_steps) * c + 1
    ddim_alphas = alphas_cumprod[ddim_timesteps]
    ddim_alphas_prev = np.concatenate(
        [[alphas_cumprod[0]], alphas_cumprod[ddim_timesteps[:-1]]])
    return {
        'alphas_cumprod': alphas_cumprod.astype(np.float32),
        'timesteps': ddim_timesteps.astype(np.int32),
        'alphas': ddim_alphas.astype(np.float32),
        'alphas_prev': ddim_alphas_prev.astype(np.float32),
        'sqrt_one_minus_alphas': np.sqrt(1 - ddim_alphas).astype(np.float32),
    }
