"""PyTorch port, the GIMP-backed export (xcf/psd/pdf): the port's
``rendering/gimp_render.py`` writes the JAX package's script-fu program
byte for byte and raises its error when ``gimp`` is not on PATH;
``save.save_result`` reaches it for the three formats. ``gimp`` itself is
not run: ``shutil.which``, ``subprocess.run`` and ``tempfile.mkdtemp`` are
patched in both packages' modules."""
import os

import numpy as np
import pytest
from PIL import Image

from manga_image_translator_tpu.rendering import gimp_render as jax_gimp
from manga_image_translator_tpu.utils.generic import Context as JContext
from manga_image_translator_tpu_torch import save
from manga_image_translator_tpu_torch.rendering import gimp_render
from manga_image_translator_tpu_torch.utils.generic import Context


class Region:
    def __init__(self, xyxy, translation, font_size):
        self.xyxy = xyxy
        self.translation = translation
        self.font_size = font_size


REGIONS = [
    ((10, 12, 90, 40), 'He said "hi"', 20),
    ((30, 60, 150, 95), 'C:\\path\\to "it"', 5),       # font size floor 8
    ((5, 100, 60, 130), 'back\\slash and "quotes" \\"', 14),
    ((0, 0, 10, 10), '', 12),                          # untranslated: skipped
]


def _ctx(cls, font=None):
    ctx = cls()
    rs = np.random.RandomState(0)
    ctx.img_inpainted = rs.randint(0, 256, (140, 160, 3)).astype(np.uint8)
    ctx.mask = (rs.rand(140, 160) < 0.2).astype(np.uint8) * 255
    ctx.text_regions = [Region(*r) for r in REGIONS]
    if font is not None:
        ctx.gimp_font = font
    return ctx


OUTPUTS = []          # the files the fake gimp writes


def _patch(monkeypatch, mod, tmp_path, calls, gimp='/usr/bin/gimp'):
    """``gimp`` found at ``gimp``; ``subprocess.run`` records its call in
    ``calls`` and writes every path of ``OUTPUTS`` as gimp would; one fixed
    temporary directory, so that both packages' scripts name the same
    files."""
    work = tmp_path / 'gimp-work'

    def mkdtemp(prefix=''):
        os.makedirs(work, exist_ok=True)
        return str(work)

    def run(cmd, **kw):
        calls.append((cmd, kw))
        for out in OUTPUTS:
            open(out, 'wb').close()

    monkeypatch.setattr(mod.shutil, 'which',
                        lambda name: gimp if name == 'gimp' else None)
    monkeypatch.setattr(mod.subprocess, 'run', run)
    monkeypatch.setattr(mod.tempfile, 'mkdtemp', mkdtemp)


@pytest.mark.parametrize('ext,font', [('xcf', None), ('psd', 'Noto Sans'),
                                      ('pdf', None)])
def test_script_matches_jax_byte_for_byte(tmp_path, monkeypatch, ext, font):
    calls = {'port': [], 'jax': []}
    dest = str(tmp_path / f'out "page" \\1.{ext}')
    OUTPUTS[:] = [dest]
    for key, mod, cls in (('port', gimp_render, Context),
                          ('jax', jax_gimp, JContext)):
        _patch(monkeypatch, mod, tmp_path, calls[key])
        mod.gimp_render(dest, _ctx(cls, font))
        assert os.path.exists(dest)
        os.remove(dest)
        # the temporary directory is removed after the run
        assert not (tmp_path / 'gimp-work').exists()
    (cmd, kw), = calls['port']
    (jcmd, jkw), = calls['jax']
    assert cmd[:2] == ['/usr/bin/gimp', '-ib']
    assert cmd[2].encode() == jcmd[2].encode()
    assert kw == jkw
    script = cmd[2]
    assert script.count('gimp-text-fontname') == 3
    assert 'C:\\\\path\\\\to \\"it\\"' in script
    assert ' 8 UNIT-PIXEL' in script                  # font size floor
    assert ('gimp-xcf-save' in script) == (ext == 'xcf')


def test_save_result_reaches_gimp(tmp_path, monkeypatch):
    calls = []
    _patch(monkeypatch, gimp_render, tmp_path, calls)
    img = Image.new('RGB', (160, 140))
    for ext in ('xcf', 'psd', 'pdf'):
        dest = str(tmp_path / f'page.{ext}')
        OUTPUTS[:] = [dest]
        save.save_result(img, dest, _ctx(Context))
        assert os.path.exists(dest)
    assert len(calls) == 3


def test_no_gimp_raises_as_jax(tmp_path, monkeypatch):
    OUTPUTS[:] = []
    errors = []
    for mod, cls in ((gimp_render, Context), (jax_gimp, JContext)):
        _patch(monkeypatch, mod, tmp_path, [], gimp=None)
        with pytest.raises(RuntimeError) as exc:
            mod.gimp_render(str(tmp_path / 'page.xcf'), _ctx(cls))
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and 'GIMP' in errors[0]
    with pytest.raises(RuntimeError, match='GIMP'):
        save.save_result(Image.new('RGB', (8, 8)),
                         str(tmp_path / 'page.pdf'), _ctx(Context))
