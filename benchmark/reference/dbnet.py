"""Plain reference of the default detector's network, DBNet-ResNet34
(reference ``detection/default_utils/DBNet_resnet34.py:76-125``), and of
its input: the 17-tap bilateral prefilter (cv2 semantics: circular
window, L1 colour distance, replicate border) and the zero pad to a
multiple of 256.

A frozen copy of the program's module layout, so that the same checkpoint
loads into both; plain PyTorch, float32. Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# ResNet-34 stage definition: (num_blocks, channels)
_RESNET34_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = _bn(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = _bn(cout)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), _bn(cout))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class ResNet34(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for li, (blocks, ch) in enumerate(_RESNET34_STAGES, start=1):
            layer = nn.Sequential(*[
                BasicBlock(cin if bi == 0 else ch, ch,
                           2 if (li > 1 and bi == 0) else 1)
                for bi in range(blocks)])
            setattr(self, f'layer{li}', layer)
            cin = ch

    def forward(self, x):
        """Returns (h4, h8, h16, h32) pyramid features."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = []
        for li in range(1, 5):
            x = getattr(self, f'layer{li}')(x)
            feats.append(x)
        return tuple(feats)



class DoubleConv(nn.Module):
    """reference double_conv: optional stride-2 avg-pool then 3× (conv3x3 +
    BN + ReLU); ``conv`` indices match the checkpoint."""

    def __init__(self, cin: int, mid: int, cout: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Sequential(
            nn.Conv2d(cin, mid, 3, 1, 1, bias=False), _bn(mid), nn.ReLU(),
            nn.Conv2d(mid, mid, 3, 1, 1, bias=False), _bn(mid), nn.ReLU(),
            nn.Conv2d(mid, cout, 3, 1, 1, bias=False), _bn(cout), nn.ReLU())

    def forward(self, x):
        if self.down:
            x = F.avg_pool2d(x, 2, 2)
        return self.conv(x)


class DoubleConvUp(nn.Module):
    """reference double_conv_up: 2× (conv3x3+BN+ReLU) then 4×4 stride-2
    transposed conv + BN + ReLU."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, mid, 3, 1, 1, bias=False), _bn(mid), nn.ReLU(),
            nn.Conv2d(mid, mid, 3, 1, 1, bias=False), _bn(mid), nn.ReLU(),
            nn.ConvTranspose2d(mid, cout, 4, 2, 1, bias=False), _bn(cout),
            nn.ReLU())

    def forward(self, x):
        return self.conv(x)




def _head_stack(first_bias: bool) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(64, 16, 3, 1, 1, bias=first_bias), _bn(16), nn.ReLU(),
        nn.ConvTranspose2d(16, 16, 4, 2, 1), _bn(16), nn.ReLU(),
        nn.ConvTranspose2d(16, 1, 4, 2, 1))


class DBHead(nn.Module):
    """DBHead inference path: concat(shrink, sigmoid(thresh)). The
    threshold stack's first conv is bias-free (reference DBHead.py:48)."""

    def __init__(self):
        super().__init__()
        self.binarize = _head_stack(True)
        self.thresh = _head_stack(False)

    def forward(self, x):
        return torch.cat([self.binarize(x),
                          torch.sigmoid(self.thresh(x))], dim=1)



def _mask_head_module() -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(64, 64, 3, 1, 1), nn.ReLU(),
        nn.Conv2d(64, 64, 3, 1, 1), nn.ReLU(),
        nn.Conv2d(64, 32, 3, 1, 1), nn.ReLU(),
        nn.Conv2d(32, 1, 1), nn.Sigmoid())



class DBNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = ResNet34()
        self.down_conv1 = DoubleConv(512, 512, 512, True)
        self.down_conv2 = DoubleConv(512, 512, 512, True)
        self.down_conv3 = DoubleConv(512, 512, 512, True)
        self.upconv1 = DoubleConvUp(512, 512, 256)
        self.upconv2 = DoubleConvUp(256 + 512, 512, 256)
        self.upconv3 = DoubleConvUp(256 + 512, 512, 256)
        self.upconv4 = DoubleConvUp(256 + 512, 512, 256)
        self.upconv5 = DoubleConvUp(256 + 256, 256, 128)
        self.upconv6 = DoubleConvUp(128 + 128, 128, 64)
        self.upconv7 = DoubleConvUp(64 + 64, 64, 64)
        self.conv_db = DBHead()
        self.conv_mask = _mask_head_module()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, 3, H, W) in [-1, 1] → (db (N, 2, H, W), mask (N, 1, H/2,
        W/2))."""
        h4, h8, h16, h32 = self.backbone(x)
        h64 = self.down_conv1(h32)
        h128 = self.down_conv2(h64)
        h256 = self.down_conv3(h128)
        up256 = self.upconv1(h256)
        up128 = self.upconv2(torch.cat([up256, h128], 1))
        up64 = self.upconv3(torch.cat([up128, h64], 1))
        up32 = self.upconv4(torch.cat([up64, h32], 1))
        up16 = self.upconv5(torch.cat([up32, h16], 1))
        up8 = self.upconv6(torch.cat([up16, h8], 1))
        up4 = self.upconv7(torch.cat([up8, h4], 1))
        return self.conv_db(up8), self.conv_mask(up4)


def dbnet_forward(model: DBNet, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC interface of the JAX package: x (N, H, W, 3) in [-1, 1] →
    (db (N, H, W, 2), mask (N, H/2, W/2, 1))."""
    db, mask = model(x.permute(0, 3, 1, 2).contiguous())
    return db.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)


def build(state_dict, device) -> DBNet:
    model = DBNet().eval()
    model.load_state_dict(state_dict, strict=True)
    return model.to(device)


@torch.no_grad()
def logits(model: DBNet, x: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, 3) in [-1, 1] -> the DB head's two maps before the
    sigmoid, (N, H, W, 2), and the text mask (N, H/2, W/2, 1)."""
    db, mask = model(x.permute(0, 3, 1, 2).contiguous())
    return db.permute(0, 2, 3, 1), mask.permute(0, 2, 3, 1)


def window_offsets(radius: int):
    return [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dy * dy + dx * dx <= radius * radius]


@torch.no_grad()
def bilateral(img: torch.Tensor, d: int = 17, sigma_color: float = 80.0,
              sigma_space: float = 80.0,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 3) uint8 -> (H, W, 3) float, rounded to whole grey levels;
    the arithmetic in ``dtype``."""
    radius = d // 2
    h, w, _ = img.shape
    xf = img.to(dtype)
    pad = F.pad(xf.permute(2, 0, 1)[None], (radius,) * 4,
                mode='replicate')[0].permute(1, 2, 0)
    gauss_color = -1.0 / (2.0 * sigma_color ** 2)
    acc = torch.zeros_like(xf)
    norm = torch.zeros((h, w, 1), dtype=dtype, device=img.device)
    for dy, dx in window_offsets(radius):
        sw = math.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space ** 2))
        shifted = pad[radius + dy:radius + dy + h, radius + dx:radius + dx + w]
        cdiff = (shifted - xf).abs().sum(dim=-1, keepdim=True)
        wt = sw * torch.exp(gauss_color * cdiff * cdiff)
        acc += wt * shifted
        norm += wt
    return (acc.float() / norm.float().clamp_min(1e-8)).round().clamp(0, 255)


def canvas(img: torch.Tensor, detect_size: int, pad_mult: int = 256,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The network input of one page whose long side is ``detect_size``:
    prefiltered, zero-padded to multiples of ``pad_mult``, in [-1, 1]."""
    h, w = img.shape[:2]
    if max(h, w) != detect_size:
        raise ValueError('the reference canvas takes pages whose long side '
                         'is the detection size (no resize)')
    smoothed = bilateral(img, dtype=dtype)
    x = F.pad(smoothed, (0, 0, 0, (-w) % pad_mult, 0, (-h) % pad_mult))
    return x / 127.5 - 1.0
