"""What the benchmark attaches to the program: the recorder that the
networks' hooks (``nets/*.install``) write to, the detection seam, the
host spans of the pipeline's stages, and the shapes of the kernel
launches.

The detection seam: ``detection.default._forward_batch`` is the DBNet
module's output (the probability map and the text mask, after the
sigmoid). The real forward runs in full (its logits are recorded for the
correctness comparison on the sampled pages); its two maps are then
replaced by maps the benchmark drew from the page's known lines and
glyph strokes (``pages.detection_maps``), at the same shape, device and
dtype. Every line of ``detection/`` after it runs on those maps.
"""
from __future__ import annotations

import collections
import functools
import time
from typing import Dict, List, Optional

import torch


class Recorder:
    """``sampling``: the current page is one the check will compare;
    ``counting``: the window is open (work counts and kernel shapes are
    recorded)."""

    def __init__(self):
        self.page = None
        self.sampling = False
        self.counting = False
        self.samples: Dict[str, List[dict]] = collections.defaultdict(list)
        self.calls: Dict[str, List[tuple]] = collections.defaultdict(list)
        self.steps: Dict[str, List[int]] = collections.defaultdict(list)
        self.spans: List[tuple] = []          # (stage, t0 ns, t1 ns)
        self.maps: Dict[int, tuple] = {}      # page index -> (prob, mask)
        self.last: Dict[str, object] = {}     # handed from hook to hook
        self.pages: list = []
        self.compared: Dict[str, int] = {}    # what the check compared


def wrap(owner, name: str, make):
    """Replaces ``owner.name`` by ``make(original)``."""
    original = getattr(owner, name)
    setattr(owner, name, functools.wraps(original)(make(original)))


def install_stage_spans(rec: Recorder) -> None:
    """Host spans of each pipeline stage, from the program's own stage
    timer (which synchronises the device at both edges)."""
    import contextlib
    from manga_image_translator_tpu_torch.utils import profiling

    def make(original):
        @contextlib.contextmanager
        def stage(self, name):
            with original(self, name):
                t0 = time.perf_counter_ns()
                try:
                    yield
                finally:
                    if rec.counting:
                        rec.spans.append((name, t0, time.perf_counter_ns()))
        return stage
    wrap(profiling.StageTimer, 'stage', make)


def install_detection_seam(rec: Recorder) -> None:
    from manga_image_translator_tpu_torch.detection import default as det

    def make_forward(original):
        def dbnet_forward(model, x):
            db, mask = original(model, x)
            if rec.counting:
                rec.calls['dbnet'].append(tuple(x.shape))
            if rec.sampling:
                rec.samples['dbnet'].append({
                    'image': rec.last.pop('dbnet.image'),
                    'x': host(x), 'db': host(db[..., 0])})
            return db, mask
        return dbnet_forward

    # the page as the detector gets it (after the upscaler, where there
    # is one), for the reference's own prefilter
    def make_infer(original):
        async def _infer(self, image, *args, **kwargs):
            if rec.sampling:
                rec.last['dbnet.image'] = image.copy()
            return await original(self, image, *args, **kwargs)
        return _infer

    def make_maps(original):
        def _forward_batch(model, batch):
            prob, mask = original(model, batch)
            pmap, mmap = rec.maps[rec.page.index]
            if (prob.shape[-2:] != pmap.shape
                    or mask.shape[-2:] != mmap.shape):
                raise RuntimeError(
                    f'detection seam: maps {pmap.shape} / {mmap.shape} '
                    f'against the network\'s {tuple(prob.shape)} / '
                    f'{tuple(mask.shape)}')
            new_p = torch.from_numpy(pmap).to(prob.device).to(prob.dtype)
            new_m = torch.from_numpy(mmap).to(mask.device).to(mask.dtype)
            return ((new_p / 255).expand_as(prob).contiguous(),
                    (new_m / 255).expand_as(mask).contiguous())
        return _forward_batch

    wrap(det.DefaultDetector, '_infer', make_infer)
    wrap(det, 'dbnet_forward', make_forward)
    wrap(det, '_forward_batch', make_maps)


def install_kernel_shapes(rec: Recorder) -> None:
    """The shape of every launch of K1, K4 and K5 in the window (K2 and
    K3 launch inside the beam loops' graphs: ``nets/ocr48`` counts their
    steps)."""
    from manga_image_translator_tpu_torch.models import lama
    from manga_image_translator_tpu_torch.ops import bilateral

    def make_k1(original):
        def _launch(x, out, radius, sigma_color, sigma_space):
            if rec.counting:
                rec.calls['k.bilateral'].append((tuple(x.shape), radius))
            return original(x, out, radius, sigma_color, sigma_space)
        return _launch

    def make_k4(original):
        def fourier_unit(x, w_spec, b_spec, *args, **kwargs):
            if rec.counting and x.is_cuda:
                rec.calls['k.fourier_unit'].append(
                    (tuple(x.shape), x.element_size()))
            return original(x, w_spec, b_spec, *args, **kwargs)
        return fourier_unit

    def make_k5(original):
        def conv2d_stream(x, w, bias=None, *args, **kwargs):
            if rec.counting and x.is_cuda:
                out_dt = kwargs.get('out_dtype') or x.dtype
                rec.calls['k.conv_stream'].append(
                    (tuple(x.shape), tuple(w.shape), x.element_size(),
                     torch.empty((), dtype=out_dt).element_size()))
            return original(x, w, bias, *args, **kwargs)
        return conv2d_stream

    wrap(bilateral, '_launch', make_k1)
    wrap(lama, 'fourier_unit', make_k4)
    wrap(lama, 'conv2d_stream', make_k5)


RECORD_S = [0.0]   # host seconds spent in ``keep``: the recording's cost


def keep(t: Optional[torch.Tensor]):
    """``t`` on the host, for the check after the window. From the card the
    copy is queued without waiting (into pinned memory, in stream order,
    so a later write to ``t`` does not reach it): the window is not
    synchronised for it. ``harness`` synchronises once the window has
    closed, before anything reads a kept tensor."""
    if t is None:
        return None
    t0 = time.perf_counter()
    t = t.detach()
    out = t.to('cpu', non_blocking=True) if t.is_cuda else t.clone()
    RECORD_S[0] += time.perf_counter() - t0
    return out


def host(t: Optional[torch.Tensor]):
    """``keep`` in float32."""
    return None if t is None else keep(t.float())
