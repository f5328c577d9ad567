"""Layered xcf/psd/pdf export through GIMP script-fu.

Contract: reference ``rendering/gimp_render.py:1-193`` — emit a script-fu
program creating the original image, inpainted layer + text mask, and one
text layer per region, then run ``gimp -ib``. A copy of the JAX package's
``rendering/gimp_render.py`` (host only); it raises when ``gimp`` is not on
``PATH``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import cv2

from ..utils.generic import Context
from ..utils.log import get_logger

logger = get_logger('gimp_render')


def _scheme_escape(s: str) -> str:
    return s.replace('\\', '\\\\').replace('"', '\\"')


def gimp_render(dest: str, ctx: Context):
    gimp = shutil.which('gimp')
    if gimp is None:
        raise RuntimeError(
            'GIMP is required for xcf/psd/pdf export but was not found in '
            'PATH.')

    ext = os.path.splitext(dest)[1][1:].lower()
    tmpdir = tempfile.mkdtemp(prefix='mit-gimp-')
    inpainted_path = os.path.join(tmpdir, 'inpainted.png')
    mask_path = os.path.join(tmpdir, 'mask.png')
    cv2.imwrite(inpainted_path,
                cv2.cvtColor(ctx.img_inpainted, cv2.COLOR_RGB2BGR))
    cv2.imwrite(mask_path, ctx.mask)

    gimp_font = ctx.get('gimp_font', 'Sans-serif')
    lines = [
        f'(let* ((image (car (gimp-file-load RUN-NONINTERACTIVE '
        f'"{_scheme_escape(inpainted_path)}" "inpainted")))',
        f'  (mask-layer (car (gimp-file-load-layer RUN-NONINTERACTIVE image '
        f'"{_scheme_escape(mask_path)}"))))',
        '  (gimp-image-insert-layer image mask-layer 0 -1)',
        '  (gimp-item-set-name mask-layer "text mask")',
    ]
    for i, region in enumerate(ctx.get('text_regions') or []):
        translation = getattr(region, 'translation', '')
        if not translation:
            continue
        x1, y1, _, _ = [int(v) for v in region.xyxy]
        font_size = max(int(region.font_size), 8)
        lines.append(
            f'  (let ((text-layer (car (gimp-text-fontname image -1 {x1} '
            f'{y1} "{_scheme_escape(translation)}" 0 TRUE {font_size} '
            f'UNIT-PIXEL "{_scheme_escape(gimp_font)}"))))'
            f' (gimp-item-set-name text-layer "text {i}"))')
    if ext == 'xcf':
        lines.append(f'  (gimp-xcf-save RUN-NONINTERACTIVE image '
                     f'(car (gimp-image-get-active-drawable image)) '
                     f'"{_scheme_escape(dest)}" "{os.path.basename(dest)}")')
    else:
        lines.append('  (gimp-image-flatten image)')
        lines.append(f'  (gimp-file-save RUN-NONINTERACTIVE image '
                     f'(car (gimp-image-get-active-drawable image)) '
                     f'"{_scheme_escape(dest)}" "{os.path.basename(dest)}")')
    lines.append('  (gimp-image-delete image))')
    script = '\n'.join(lines) + '\n(gimp-quit 0)'

    try:
        subprocess.run([gimp, '-ib', script], check=True, timeout=300,
                       capture_output=True)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    if not os.path.exists(dest):
        raise RuntimeError(f'GIMP did not produce {dest}')
