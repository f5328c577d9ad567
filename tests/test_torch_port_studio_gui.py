"""PyTorch port: the desktop studio's headless ``StudioViewModel`` against
the JAX package's, driven through the same sequence of queue, profile,
theme, job-key and run actions (tests/test_studio_gui.py's), with their
rows, overrides and event kinds equal; the settings schema line for line;
the Tk layer where a display exists."""
import os
import time
from unittest import mock

import pytest

from manga_image_translator_tpu import studio as jax_studio
from manga_image_translator_tpu import studio_gui as jax_gui
from manga_image_translator_tpu_torch import studio, studio_gui


@pytest.fixture()
def vms(tmp_path, monkeypatch):
    """(port, JAX) view-models, each with its own profile directory; the
    port's pipeline on the CPU."""
    for mod, sub in ((studio, 'port'), (jax_studio, 'jax')):
        d = tmp_path / sub
        d.mkdir()
        monkeypatch.setattr(mod, 'PROFILE_DIR', str(d))
    return (studio_gui.StudioViewModel({'use_gpu': False}),
            jax_gui.StudioViewModel())


def _img(tmp_path, name):
    f = tmp_path / name
    f.write_bytes(b'\x89PNG\r\n\x1a\n')
    return str(f)


def _both(vms, action):
    """``action(vm)`` on both; their results must be equal."""
    got, want = (action(vm) for vm in vms)
    assert got == want
    return got


def _state(vm):
    return (vm.job_rows(), vm.history_rows(), vm.profile_overrides(),
            vm.profile_names(), vm.active_profile, vm.theme)


def test_flatten_schema_matches_jax():
    assert studio_gui.flatten_schema() == jax_gui.flatten_schema()


def test_queue_profiles_theme_and_job_keys_match_jax(vms, tmp_path):
    a, b, c = (_img(tmp_path, n) for n in ('a.png', 'b.png', 'c.png'))
    chapter = tmp_path / 'chapter'
    chapter.mkdir()
    for name in ('2.png', '1.jpg', 'skip.txt'):
        (chapter / name).write_bytes(b'x')
    steps = [
        lambda vm: vm.add_paths([a, b]),
        lambda vm: vm.add_paths(['/no/such/file.png']),
        lambda vm: vm.add_folder(str(chapter)),
        lambda vm: vm.add_folder(str(tmp_path / 'nope')),
        lambda vm: vm.duplicate([0]),
        lambda vm: vm.move(4, -2),
        lambda vm: vm.move(0, -1),
        lambda vm: vm.remove([1]),
        lambda vm: vm.studio.queue[0].update(
            status='done', took=1.25,
            stage_ms={'detection': 21.0, 'ocr': 50.0}),
        lambda vm: vm.studio.queue[1].update(status='failed',
                                             error='boom'),
        lambda vm: vm.history_rows(),
        lambda vm: vm.requeue([0]),
        lambda vm: vm.retry(),
        lambda vm: vm.studio.queue[2].update(status='running'),
        lambda vm: vm.remove([2]),
        lambda vm: vm.set_profile_key('translator.translator', 'none'),
        lambda vm: vm.set_profile_key('detector.detection_size',
                                      'notanumber'),
        lambda vm: vm.save_profile_as('fast'),
        lambda vm: vm.save_profile_as(' '),
        lambda vm: vm.set_profile_key('ocr.ocr', '32px'),
        lambda vm: vm.switch_profile('default'),
        lambda vm: vm.switch_profile('ghost'),
        lambda vm: vm.delete_profile('default'),
        lambda vm: vm.delete_profile('fast'),
        lambda vm: vm.unset_profile_key('translator.translator'),
        lambda vm: vm.unset_profile_key('translator.translator'),
        lambda vm: vm.set_job_key(0, 'translator.translator', 'none'),
        lambda vm: vm.set_job_key(0, 'translator.translator',
                                  'not_a_translator'),
        lambda vm: vm.job_config_json(0),
        lambda vm: vm.toggle_theme(),
        lambda vm: vm.clear_finished(),
    ]
    for step in steps:
        _both(vms, step)
        assert _state(vms[0]) == _state(vms[1])
    assert vms[0].theme == 'dark'
    # the theme and queue persist, each package in its own directory
    fresh = studio_gui.StudioViewModel({'use_gpu': False})
    assert fresh.theme == 'dark'
    assert fresh.job_rows() == vms[0].job_rows()


def _fake_translator(seen, vm):
    class FakeTranslator:
        def __init__(self, *a, **k):
            pass

        def add_progress_hook(self, h):
            self.hook = h

        async def translate_path(self, path, dest, args):
            seen.append(os.path.basename(path))
            await self.hook('detection', False)
            if len(seen) == 1:
                vm.stop()  # requested mid-run: later jobs must not start
    return FakeTranslator


def _run(vm, module, seen):
    with mock.patch.object(module, 'MangaTranslatorLocal',
                           _fake_translator(seen, vm)):
        assert vm.start() is None
        for _ in range(500):
            if not vm.is_running:
                break
            time.sleep(0.01)
    assert not vm.is_running
    return [e[0] for e in vm.poll_events()]


def test_run_stop_and_events_match_jax(vms, tmp_path):
    """tests/test_studio_gui.py:127-165 on both: the stubbed
    MangaTranslatorLocal runs the first job, stop() keeps the rest
    pending; the same event kinds and rows."""
    for vm in vms:
        for name in ('a.png', 'b.png', 'c.png'):
            vm.add_paths([_img(tmp_path, name)])
    seen_p, seen_j = [], []
    kinds_p = _run(vms[0], studio, seen_p)
    kinds_j = _run(vms[1], jax_studio, seen_j)
    assert seen_p == seen_j == ['a.png']
    assert kinds_p == kinds_j
    assert 'progress' in kinds_p and kinds_p[-1] == 'finished'
    rows_p = [{k: v for k, v in r.items() if k != 'took'}
              for r in vms[0].job_rows()]
    rows_j = [{k: v for k, v in r.items() if k != 'took'}
              for r in vms[1].job_rows()]
    assert rows_p == rows_j
    assert [r['status'] for r in rows_p] == ['done', 'pending', 'pending']
    assert _both(vms, lambda vm: len(vm.history_rows())) == 1


def test_start_empty_queue_and_card_refusal(vms, monkeypatch):
    assert _both(vms, lambda vm: vm.start()) == 'queue empty'
    from manga_image_translator_tpu_torch.device import CudaUnavailableError
    monkeypatch.setattr('torch.cuda.is_available', lambda: False)
    with pytest.raises(CudaUnavailableError):
        studio_gui.StudioViewModel()


def test_tk_layer_builds_headless(vms):
    """Build the Tk widget tree when a display is available; otherwise
    skip (as tests/test_studio_gui.py:171-185)."""
    import tkinter
    try:
        root = tkinter.Tk()
        root.destroy()
    except tkinter.TclError:
        pytest.skip('no display')
    gui = studio_gui.StudioGUI(vms[0])
    gui._refresh_all()
    gui.root.destroy()
