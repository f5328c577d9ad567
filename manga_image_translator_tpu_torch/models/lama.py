"""LaMa FFC inpainting generator (lama_large, lama_mpe) — PyTorch port.

Counterpart of the JAX package's ``models/lama.py`` (reference
``inpainting/inpainting_lama_mpe.py``: FourierUnit :187-253,
SpectralTransform :260-305, FFC :310-367, FFCResnetBlock :402-435,
FFCResNetGenerator :545-633). Configuration of the released
``lama_large_512px`` checkpoint: NGF 64, a 7×7 stem, three stride-2
downsamples (the last splits local/global at ratio 0.75: 128 local and 384
global channels), 18 FFC resnet blocks, three transposed-conv upsamples, a
7×7 conv to RGB and a sigmoid; every padding is reflect.

Module names follow the checkpoint keys (``model.{i}.…``), so the released
``gen_state_dict`` loads with a strict ``load_state_dict``. ``fold_bn``
folds every inference BatchNorm into the conv before it (in place; the BN
modules become ``nn.Identity``), as the JAX package's ``fold_bn`` does.

Routes: every FourierUnit runs kernel K4 (``ops.fourier_unit``), the stem
and the final conv run kernel K5 (``ops.conv_stream``); the other convs and
the transposed convs are cuDNN, as the JAX package leaves them to XLA.
Internally NCHW tensors in ``channels_last`` memory, so that K4 and K5 get
their NHWC views without copies; ``LamaGenerator.forward`` keeps the JAX
package's NHWC interface. The FourierUnit runs in f32 inside whatever the
compute dtype (the reference's fp32 island); ``cast_for_compute`` leaves
its weights in f32.

lama_mpe is the same generator at 9 blocks with the masked positional
encoding (the end of this file): ``masked_position_encoding`` (host BFS,
copied as the JAX package has it) and ``MPE`` (the checkpoint's
``str_state_dict``) give two embeddings that ``LamaGenerator.forward``
adds to the stem's output.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_stream import conv2d_stream, pack_weights
from ..ops.fourier_unit import fourier_unit
from ..weights import load_state_dict_into, torch_state_dict_from_jax

NGF = 64
N_DOWN = 3
RESNET_RATIO = 0.75          # global channel ratio inside resnet blocks
N_BLOCKS = 18                # lama_large
CG = int(NGF * 8 * RESNET_RATIO)   # 384 global trunk channels
CL = NGF * 8 - CG                  # 128 local trunk channels
CHANNELS_LAST = torch.channels_last


def transposed_conv_patterns(n_blocks: int) -> Tuple[str, ...]:
    """Keys of the transposed-conv weights for the JAX → torch bridge."""
    up0 = 5 + n_blocks + 1
    ids = '|'.join(str(up0 + 3 * i) for i in range(N_DOWN))
    return (rf'model\.({ids})\.weight',)


TRANSPOSED_CONV_PATTERNS_FOR_BLOCKS = {
    n: transposed_conv_patterns(n) for n in (18, 9)}


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


def _bn_affine(bn: nn.Module, c: int, device, dtype=torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, shift) of an inference BN, or (1, 0) for a folded one."""
    if isinstance(bn, nn.BatchNorm2d):
        scale = bn.weight.float() / torch.sqrt(bn.running_var.float()
                                               + bn.eps)
        return scale, bn.bias.float() - bn.running_mean.float() * scale
    return (torch.ones(c, device=device, dtype=dtype),
            torch.zeros(c, device=device, dtype=dtype))


def _folded_conv(conv: nn.Conv2d, bn: nn.Module
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(HWIO f32 weight, f32 bias, the weight packed for K5's tensor-core
    route, or None off the card) of conv followed by bn."""
    cout = conv.weight.shape[0]
    scale, shift = _bn_affine(bn, cout, conv.weight.device)
    w = conv.weight.float() * scale[:, None, None, None]
    b = shift if conv.bias is None else conv.bias.float() * scale + shift
    w = w.detach().permute(2, 3, 1, 0).contiguous()
    return w, b.detach().contiguous(), pack_weights(w)


class _VersionCache:
    """A value derived from some tensors, rebuilt when any of them changes
    (storage or in-place version)."""

    def __init__(self):
        self._key = None
        self._val = None

    def get(self, tensors, build):
        key = tuple((t.data_ptr(), t._version, t.dtype) for t in tensors
                    if t is not None)
        if key != self._key:
            self._val = build()
            self._key = key
        return self._val


class FourierUnit(nn.Module):
    """rfft2 → interleaved (2C → 2C) 1×1 conv + BN + ReLU → irfft2, run
    by kernel K4 on the NHWC view."""

    def __init__(self, c: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(2 * c, 2 * c, 1, bias=False)
        self.bn = _bn(2 * c)
        self._spec = _VersionCache()

    def spectral_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The folded (2C, 2C) (out, in) f32 matrix and (2C,) f32 bias."""
        conv = self.conv_layer
        tensors = [conv.weight, conv.bias]
        if isinstance(self.bn, nn.BatchNorm2d):
            tensors += [self.bn.weight, self.bn.bias, self.bn.running_mean,
                        self.bn.running_var]

        def build():
            c2 = conv.weight.shape[0]
            scale, shift = _bn_affine(self.bn, c2, conv.weight.device)
            w = conv.weight[:, :, 0, 0].float() * scale[:, None]
            b = (shift if conv.bias is None
                 else conv.bias.float() * scale + shift)
            return w.detach().contiguous(), b.detach().contiguous()
        return self._spec.get(tensors, build)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.spectral_weights()
        y = fourier_unit(x.permute(0, 2, 3, 1), w, b)
        return y.permute(0, 3, 1, 2)


class SpectralTransform(nn.Module):
    """Stride 1, no LFU (the released configuration)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(cin, cout // 2, 1, bias=False),
                                   _bn(cout // 2), nn.ReLU(inplace=True))
        self.fu = FourierUnit(cout // 2)
        self.conv2 = nn.Conv2d(cout // 2, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2(x + self.fu(x))


def _reflect(x: Optional[torch.Tensor], p: int) -> Optional[torch.Tensor]:
    """Reflect padding (``F.pad(mode='reflect')``, ``jnp.pad(mode=
    'reflect')``) of an NCHW tensor into a channels_last result. CUDA's
    reflection_pad2d takes and returns NCHW-contiguous tensors, so on a
    channels_last input it costs a copy in and, before the next cuDNN conv,
    a copy out. Here: one copy of the interior, then for each k = 1..p one
    copy for the two rows at distance k (a view with two rows whose stride
    spans the image) and one for the two columns, 2p + 1 launches."""
    if x is None or p == 0:
        return x
    n, c, h, w = x.shape
    hp, wp = h + 2 * p, w + 2 * p
    out = torch.empty((n, c, hp, wp), dtype=x.dtype, device=x.device,
                      memory_format=CHANNELS_LAST)
    out[:, :, p:p + h, p:p + w] = x

    def pair(t, size, lead, step, first):
        """View of t's rows (lead == 2) or columns (lead == 3) ``first``
        and ``first + step``: a dimension of 2 with stride step."""
        st = list(t.stride())
        st[lead] *= step
        shape = list(size)
        shape[lead] = 2
        return t.as_strided(shape, st, t.storage_offset()
                            + first * t.stride()[lead])

    for k in range(1, p + 1):
        # rows p - k and p + h - 1 + k mirror x's rows k and h - 1 - k
        dst = pair(out[:, :, :, p:p + w], (n, c, h, w), 2, h - 1 + 2 * k,
                   p - k)
        if h - 1 - 2 * k >= 0:
            dst.copy_(pair(x, (n, c, h, w), 2, h - 1 - 2 * k, k))
        else:
            dst[:, :, 0] = x[:, :, k]
            dst[:, :, 1] = x[:, :, h - 1 - k]
    for k in range(1, p + 1):
        # columns p - k and p + w - 1 + k mirror p + k and p + w - 1 - k,
        # over the full padded height (corners included)
        dst = pair(out, (n, c, hp, wp), 3, w - 1 + 2 * k, p - k)
        if w - 1 - 2 * k >= 0:
            dst.copy_(pair(out, (n, c, hp, wp), 3, w - 1 - 2 * k, p + k))
        else:
            dst[..., 0] = out[..., p + k]
            dst[..., 1] = out[..., p + w - 1 - k]
    return out


class FFC(nn.Module):
    """Four-path local/global conv mixing (reference FFC.forward); each
    input is reflect-padded once for both of its convs."""

    def __init__(self, cin: int, cout: int, k: int, ratio_gin: float,
                 ratio_gout: float, stride: int = 1, padding: int = 0):
        super().__init__()
        in_cg = int(cin * ratio_gin)
        in_cl = cin - in_cg
        out_cg = int(cout * ratio_gout)
        out_cl = cout - out_cg
        self.padding = padding

        def conv(ci, co):
            return nn.Conv2d(ci, co, k, stride, 0, bias=False)
        self.convl2l = conv(in_cl, out_cl) if in_cl and out_cl else None
        self.convl2g = conv(in_cl, out_cg) if in_cl and out_cg else None
        self.convg2l = conv(in_cg, out_cl) if in_cg and out_cl else None
        self.convg2g = (SpectralTransform(in_cg, out_cg)
                        if in_cg and out_cg else None)

    def forward(self, x_l: torch.Tensor, x_g: Optional[torch.Tensor]):
        xl_p = _reflect(x_l, self.padding)
        xg_p = _reflect(x_g, self.padding)
        out_l = out_g = None
        if self.convl2l is not None:
            out_l = self.convl2l(xl_p)
            if x_g is not None and self.convg2l is not None:
                out_l = out_l + self.convg2l(xg_p)
        if self.convl2g is not None:
            out_g = self.convl2g(xl_p)
            if x_g is not None and self.convg2g is not None:
                out_g = out_g + self.convg2g(x_g)
        return out_l, out_g


class FFC_BN_ACT(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, ratio_gin: float,
                 ratio_gout: float, stride: int = 1, padding: int = 0):
        super().__init__()
        self.ffc = FFC(cin, cout, k, ratio_gin, ratio_gout, stride, padding)
        out_cg = int(cout * ratio_gout)
        out_cl = cout - out_cg
        self.bn_l = _bn(out_cl) if out_cl else None
        self.bn_g = _bn(out_cg) if out_cg else None

    def forward(self, x_l, x_g=None):
        x_l, x_g = self.ffc(x_l, x_g)
        if x_l is not None:
            x_l = F.relu(self.bn_l(x_l))
        if x_g is not None:
            x_g = F.relu(self.bn_g(x_g))
        return x_l, x_g


class FFCResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = FFC_BN_ACT(dim, dim, 3, RESNET_RATIO, RESNET_RATIO,
                                padding=1)
        self.conv2 = FFC_BN_ACT(dim, dim, 3, RESNET_RATIO, RESNET_RATIO,
                                padding=1)

    def forward(self, x_l, x_g):
        y_l, y_g = self.conv2(*self.conv1(x_l, x_g))
        return x_l + y_l, x_g + y_g


class LamaGenerator(nn.Module):
    """FFCResNetGenerator; ``model`` holds the checkpoint's numbered
    layers (parameter-free slots included, so the indices match)."""

    def __init__(self, n_blocks: int = N_BLOCKS):
        super().__init__()
        self.n_blocks = n_blocks
        layers = [nn.ReflectionPad2d(3),
                  FFC_BN_ACT(4, NGF, 7, 0, 0),
                  FFC_BN_ACT(NGF, NGF * 2, 3, 0, 0, 2, 1),
                  FFC_BN_ACT(NGF * 2, NGF * 4, 3, 0, 0, 2, 1),
                  FFC_BN_ACT(NGF * 4, NGF * 8, 3, 0, RESNET_RATIO, 2, 1)]
        layers += [FFCResnetBlock(NGF * 8) for _ in range(n_blocks)]
        layers.append(nn.Identity())           # ConcatTupleLayer
        ch = NGF * 8
        for _ in range(N_DOWN):
            layers += [nn.ConvTranspose2d(ch, ch // 2, 3, 2, 1,
                                          output_padding=1),
                       _bn(ch // 2), nn.ReLU(inplace=True)]
            ch //= 2
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(NGF, 3, 7),
                   nn.Sigmoid()]
        self.model = nn.ModuleList(layers)
        self._stem_w = _VersionCache()
        self._final_w = _VersionCache()

    @property
    def up0(self) -> int:
        return 5 + self.n_blocks + 1

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """model.0-1: reflect pad 3, 7×7 4 → 64 conv, BN, ReLU through K5.
        x: NHWC → NCHW (channels_last)."""
        stem = self.model[1]
        conv = stem.ffc.convl2l
        w, b, packed = self._stem_w.get(
            [conv.weight] + list(stem.bn_l.state_dict(keep_vars=True)
                                 .values()),
            lambda: _folded_conv(conv, stem.bn_l))
        xp = _reflect(x.permute(0, 3, 1, 2), 3)
        y = conv2d_stream(xp.permute(0, 2, 3, 1), w, b, relu=True,
                          packed=packed)
        return y.permute(0, 3, 1, 2)

    def _final(self, x: torch.Tensor) -> torch.Tensor:
        """model.{up0+9..10}: reflect pad 3, 7×7 64 → 3 conv through K5,
        f32 out. x: NCHW (channels_last) → NHWC."""
        conv = self.model[self.up0 + 3 * N_DOWN + 1]
        w, b, packed = self._final_w.get(
            [conv.weight, conv.bias],
            lambda: _folded_conv(conv, nn.Identity()))
        xp = _reflect(x, 3)
        return conv2d_stream(xp.permute(0, 2, 3, 1), w, b,
                             out_dtype=torch.float32, packed=packed)

    def forward(self, img: torch.Tensor, mask: torch.Tensor,
                rel_pos_emb: Optional[torch.Tensor] = None,
                direct_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """img (N, H, W, 3) in [0, 1], already masked by the caller
        (``img * (1 - mask)``); mask (N, H, W, 1) binary; both in the
        compute dtype. ``rel_pos_emb`` and ``direct_emb`` (lama_mpe, each
        (N, 64, H, W) from ``MPE``) are added to the stem's output in its
        dtype, in that order (JAX ``lama_generator_forward``). Returns (N,
        H, W, 3) f32 in [0, 1]."""
        x = torch.cat([img, mask], dim=-1)
        x_l = self._stem(x)
        if rel_pos_emb is not None:
            x_l = x_l + rel_pos_emb.to(x_l.dtype)
        if direct_emb is not None:
            x_l = x_l + direct_emb.to(x_l.dtype)
        x_g = None
        for i in (2, 3, 4):
            x_l, x_g = self.model[i](x_l, x_g)
        for i in range(self.n_blocks):
            x_l, x_g = self.model[5 + i](x_l, x_g)
        x = torch.cat([x_l, x_g], dim=1)
        for i in range(N_DOWN):
            base = self.up0 + 3 * i
            x = F.relu(self.model[base + 1](self.model[base](x)))
        return torch.sigmoid(self._final(x))


def fold_bn(model: LamaGenerator) -> LamaGenerator:
    """Fold every inference BatchNorm into the conv before it, in place
    (JAX package ``fold_bn``). Where a BN follows the sum of two convs
    (the FFC paths), its scale multiplies both and its shift becomes the
    bias of the first (l2l for the local path, l2g for the global one)."""

    @torch.no_grad()
    def scale_conv(conv, s, t=None, out_dim=0):
        shape = [1] * conv.weight.dim()
        shape[out_dim] = -1
        conv.weight.mul_(s.view(shape).to(conv.weight.dtype))
        if t is not None:
            old = (conv.bias.float() if conv.bias is not None
                   else torch.zeros_like(t))
            conv.bias = nn.Parameter((old * s + t).to(conv.weight.dtype))

    def sb(bn):
        s, t = _bn_affine(bn, bn.num_features, bn.weight.device)
        return s.detach(), t.detach()

    m = model.model
    for i in (1, 2, 3, 4):
        blk = m[i]
        s, t = sb(blk.bn_l)
        scale_conv(blk.ffc.convl2l, s, t)
        blk.bn_l = nn.Identity()
    s, t = sb(m[4].bn_g)
    scale_conv(m[4].ffc.convl2g, s, t)
    m[4].bn_g = nn.Identity()

    for b in range(model.n_blocks):
        for cv in (m[5 + b].conv1, m[5 + b].conv2):
            ffc = cv.ffc
            s, t = sb(cv.bn_l)
            scale_conv(ffc.convl2l, s, t)
            scale_conv(ffc.convg2l, s)
            cv.bn_l = nn.Identity()
            s, t = sb(cv.bn_g)
            scale_conv(ffc.convl2g, s, t)
            st = ffc.convg2g
            scale_conv(st.conv2, s)
            cv.bn_g = nn.Identity()
            s1, t1 = sb(st.conv1[1])
            scale_conv(st.conv1[0], s1, t1)
            st.conv1[1] = nn.Identity()
            s2, t2 = sb(st.fu.bn)
            scale_conv(st.fu.conv_layer, s2, t2)
            st.fu.bn = nn.Identity()

    for i in range(N_DOWN):
        base = model.up0 + 3 * i
        s, t = sb(m[base + 1])
        scale_conv(m[base], s, t, out_dim=1)    # (in, out, kh, kw)
        m[base + 1] = nn.Identity()
    return model


def cast_for_compute(model: LamaGenerator, dtype: torch.dtype
                     ) -> LamaGenerator:
    """A copy of ``model`` whose parameters and buffers are in ``dtype``,
    except the FourierUnits' (they stay f32: K4 runs in f32 inside)."""
    out = copy.deepcopy(model)
    keep = {id(t) for mod in out.modules() if isinstance(mod, FourierUnit)
            for t in list(mod.parameters()) + list(mod.buffers())}
    for t in list(out.parameters()) + list(out.buffers()):
        if id(t) not in keep and t.is_floating_point():
            t.data = t.data.to(dtype)
    return out


def build_lama(n_blocks: int, sd: Dict[str, torch.Tensor],
               device='cpu') -> LamaGenerator:
    """Strict load of a generator state dict (checkpoint keys) on the CPU
    in f32, then moved to ``device`` in channels_last memory."""
    model = LamaGenerator(n_blocks)
    load_state_dict_into(model, sd)
    return model.to(device=device, memory_format=CHANNELS_LAST).eval()


def init_state_dict(n_blocks: int = N_BLOCKS) -> Dict[str, torch.Tensor]:
    """Seeded random weights with the checkpoint's keys and shapes: the
    JAX package's ``init_params`` draws (same seed, order and scale, in
    its HWIO layout), bridged to torch layouts."""
    rs = np.random.RandomState(7)
    params: Dict[str, np.ndarray] = {}

    def conv(key, kh, kw, ci, co, bias=True):
        params[key + '.weight'] = (rs.randn(kh, kw, ci, co).astype(np.float32)
                                   * np.sqrt(2.0 / (kh * kw * ci))
                                   ).astype(np.float32)
        if bias:
            params[key + '.bias'] = np.zeros((co,), np.float32)

    def bn(key, c):
        params[key + '.weight'] = np.ones((c,), np.float32)
        params[key + '.bias'] = np.zeros((c,), np.float32)
        params[key + '.running_mean'] = np.zeros((c,), np.float32)
        params[key + '.running_var'] = np.ones((c,), np.float32)

    conv('model.1.ffc.convl2l', 7, 7, 4, NGF, bias=False)
    bn('model.1.bn_l', NGF)
    for i, (ci, co) in enumerate([(NGF, NGF * 2), (NGF * 2, NGF * 4)]):
        conv(f'model.{2 + i}.ffc.convl2l', 3, 3, ci, co, bias=False)
        bn(f'model.{2 + i}.bn_l', co)
    conv('model.4.ffc.convl2l', 3, 3, NGF * 4, CL, bias=False)
    conv('model.4.ffc.convl2g', 3, 3, NGF * 4, CG, bias=False)
    bn('model.4.bn_l', CL)
    bn('model.4.bn_g', CG)
    for b in range(n_blocks):
        for cv in ('conv1', 'conv2'):
            pre = f'model.{5 + b}.{cv}'
            conv(f'{pre}.ffc.convl2l', 3, 3, CL, CL, bias=False)
            conv(f'{pre}.ffc.convl2g', 3, 3, CL, CG, bias=False)
            conv(f'{pre}.ffc.convg2l', 3, 3, CG, CL, bias=False)
            st = f'{pre}.ffc.convg2g'
            conv(f'{st}.conv1.0', 1, 1, CG, CG // 2, bias=False)
            bn(f'{st}.conv1.1', CG // 2)
            conv(f'{st}.fu.conv_layer', 1, 1, CG, CG, bias=False)
            bn(f'{st}.fu.bn', CG)
            conv(f'{st}.conv2', 1, 1, CG // 2, CG, bias=False)
            bn(f'{pre}.bn_l', CL)
            bn(f'{pre}.bn_g', CG)
    up0 = 5 + n_blocks + 1
    ch = NGF * 8
    for i in range(N_DOWN):
        conv(f'model.{up0 + i * 3}', 3, 3, ch, ch // 2)
        bn(f'model.{up0 + i * 3 + 1}', ch // 2)
        ch //= 2
    conv(f'model.{up0 + 3 * N_DOWN + 1}', 7, 7, NGF, 3)
    return torch_state_dict_from_jax(params,
                                     transposed_conv_patterns(n_blocks))


# ---------------------------------------------------------------------------
# MPE (masked positional encoding): the lama_mpe variant
# ---------------------------------------------------------------------------

MPE_POSITIONS = 128
MPE_DIM = 64
# 2-D embedding tables, which the JAX → torch bridge must not transpose
EMBEDDING_PATTERNS = (r'rel_pos_emb\.weight', r'direct_emb\.weight')


def masked_position_encoding(mask: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Host BFS giving (rel_pos ids (H, W), direction one-hots (H, W, 4))
    for a binary (H, W) mask in {0, 1}: reference
    ``load_masked_position_encoding``, copied as the JAX package has it."""
    import cv2
    str_size, pos_num = 256, MPE_POSITIONS
    ori_mask = mask.astype(np.float32)
    ori_h, ori_w = ori_mask.shape
    m255 = (mask * 255).astype(np.uint8)
    small = cv2.resize(m255, (str_size, str_size),
                       interpolation=cv2.INTER_AREA)
    small[small > 0] = 255
    h, w = small.shape
    mask3 = 1.0 - small / 255.0
    pos = np.zeros((h, w), np.int32)
    direct = np.zeros((h, w, 4), np.int32)
    filters = [
        np.ones((3, 3), np.float32),
        np.array([[1, 1, 0], [1, 1, 0], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [1, 1, 0], [1, 1, 0]], np.float32),
        np.array([[0, 1, 1], [0, 1, 1], [0, 0, 0]], np.float32),
        np.array([[0, 0, 0], [0, 1, 1], [0, 1, 1]], np.float32),
    ]
    i = 0
    if mask3.max() > 0:
        while np.sum(1 - mask3) > 0:
            i += 1
            grown = cv2.filter2D(mask3, -1, filters[0])
            grown[grown > 0] = 1
            pos[(grown - mask3) == 1] = i
            for d in range(4):
                m = cv2.filter2D(mask3, -1, filters[1 + d])
                m[m > 0] = 1
                direct[(m - mask3) == 1, d] = 1
            mask3 = grown
    rel_pos = np.clip((pos / (str_size / 2) * pos_num).astype(np.int32),
                      0, pos_num - 1)
    if (ori_w, ori_h) != (w, h):
        rel_pos = cv2.resize(rel_pos, (ori_w, ori_h),
                             interpolation=cv2.INTER_NEAREST)
        rel_pos[ori_mask == 0] = 0
        direct = cv2.resize(direct, (ori_w, ori_h),
                            interpolation=cv2.INTER_NEAREST)
        direct[ori_mask == 0, :] = 0
    return rel_pos, direct


def sinusoidal_embedding_table(num: int = MPE_POSITIONS,
                               dim: int = MPE_DIM) -> np.ndarray:
    """MaskedSinusoidalPositionalEmbedding init (reference :439-460): sin
    features in the first half, cos in the second (not interleaved)."""
    pe = np.array([[pos / np.power(10000, 2 * (j // 2) / dim)
                    for j in range(dim)] for pos in range(num)])
    out = np.zeros((num, dim), np.float32)
    sentinel = dim // 2 if dim % 2 == 0 else dim // 2 + 1
    out[:, :sentinel] = np.sin(pe[:, 0::2])
    out[:, sentinel:] = np.cos(pe[:, 1::2])
    return out


class MPE(nn.Module):
    """The checkpoint's ``str_state_dict``: a 128 × 64 positional table, a
    4 × 64 direction table and their scales ``alpha5`` / ``alpha6``
    (reference ``MPE``). Runs in f32."""

    def __init__(self):
        super().__init__()
        self.rel_pos_emb = nn.Embedding(MPE_POSITIONS, MPE_DIM)
        self.direct_emb = nn.Embedding(4, MPE_DIM)
        self.alpha5 = nn.Parameter(torch.zeros(()))
        self.alpha6 = nn.Parameter(torch.zeros(()))

    def forward(self, rel_pos: torch.Tensor, direct: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, H, W) ids + (N, H, W, 4) one-hots → two (N, 64, H, W) f32
        embeddings (channels_last memory), scaled by alpha5 / alpha6."""
        rel = self.rel_pos_emb.weight[rel_pos.long()] * self.alpha5
        dr = torch.einsum('bhwf,fe->bhwe', direct.float(),
                          self.direct_emb.weight) * self.alpha6
        return rel.permute(0, 3, 1, 2), dr.permute(0, 3, 1, 2)


def mpe_init_state_dict() -> Dict[str, torch.Tensor]:
    """The MPE weights without a checkpoint, exactly as the JAX package
    makes them: the sinusoidal table, ``RandomState(3)`` directions, both
    scales 0 (so the embeddings vanish)."""
    return {'rel_pos_emb.weight': torch.from_numpy(
                sinusoidal_embedding_table()),
            'direct_emb.weight': torch.from_numpy(
                np.random.RandomState(3).randn(4, MPE_DIM)
                .astype(np.float32)),
            'alpha5': torch.zeros(()), 'alpha6': torch.zeros(())}


def build_mpe(sd: Dict[str, torch.Tensor], device='cpu') -> MPE:
    """Strict load of a ``str_state_dict`` in torch layout."""
    return load_state_dict_into(MPE(), sd).to(device).eval()
