"""PyTorch port, the tracer (``utils/profiling``): spans and counters of the
pipeline's stages on the CPU path that ``test_torch_port_pipeline.py``
drives (detector ``default`` at 256, OCR ``48px``, mask refinement), with
its seeded weights (the JAX package's init_params, bridged), translator
``original`` and the default renderer, so that every stage runs. The
tracer off: nothing recorded, one shared null context. On: every sub-span
inside its stage, with its parent and its page; two concurrent
``translate`` calls on pages of their own; ``stage_durations`` as before;
the OCR counters; the exporter's Chrome trace."""
import asyncio
import json

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax

from manga_image_translator_tpu.models import dbnet as jax_dbnet
from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu.ocr.model_48px import _placeholder_dictionary
from manga_image_translator_tpu_torch import detection, ocr
from manga_image_translator_tpu_torch import manga_translator as port_mt
from manga_image_translator_tpu_torch.config import Config, Detector, Ocr
from manga_image_translator_tpu_torch.models import dbnet, ocr48
from manga_image_translator_tpu_torch.utils import profiling
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

CONFIG = {
    'detector': {'detector': 'default', 'detection_size': 256},
    'ocr': {'ocr': '48px', 'prob': 0.0},
    'translator': {'translator': 'original', 'target_lang': 'ENG',
                   'enable_post_translation_check': False,
                   'no_text_lang_skip': True},
    'inpainter': {'inpainter': 'none'},
    'render': {'renderer': 'default'},
}
STAGES = {'detect', 'ocr', 'textline_merge', 'translate', 'mask_refine',
          'inpaint', 'render'}
SUB_SPANS = {'detect.postprocess', 'ocr.plan', 'ocr.crop', 'ocr.encode',
             'ocr.beam', 'ocr.text', 'merge.graph', 'merge.sort',
             'mask.assign', 'mask.bilateral', 'mask.crf', 'mask.dilate',
             'render.region'}


def make_page():
    img = np.full((400, 300, 3), 255, np.uint8)
    cv2.putText(img, 'HELLO', (40, 100), cv2.FONT_HERSHEY_SIMPLEX, 1.5,
                (0, 0, 0), 3)
    cv2.putText(img, 'WORLD', (40, 200), cv2.FONT_HERSHEY_SIMPLEX, 1.5,
                (0, 0, 0), 3)
    return Image.fromarray(img)


def translate(translator, n=1):
    """``n`` concurrent ``translate`` calls of the page."""
    async def run():
        return await asyncio.gather(*(
            translator.translate(make_page(), Config(**CONFIG))
            for _ in range(n)))
    return asyncio.run(run())


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for key, val in (('MIT_TPU_MESH', '0'), ('MIT_TPU_DEVICE_CROPS', '0'),
                     ('MIT_TPU_OCR_BF16_BACKBONE', '0'),
                     ('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')):
        mp.setenv(key, val)
    try:
        dictionary = _placeholder_dictionary()
        det = detection.get_detector(Detector.default)
        det.device = torch.device('cpu')
        det.model = dbnet.build_dbnet('cpu', torch_state_dict_from_jax(
            {k: np.array(v) for k, v in
             jax_dbnet.init_params(jax.random.PRNGKey(0)).items()},
            dbnet.TRANSPOSED_CONV_PATTERNS))
        det._loaded = True
        rec = ocr.get_ocr(Ocr.ocr48px)
        rec.dictionary = dictionary
        rec.device = torch.device('cpu')
        rec.model = ocr48.build_ocr48(len(dictionary), 'cpu',
                                      torch_state_dict_from_jax(
            {k: np.array(v) for k, v in
             jax_ocr48.init_params(len(dictionary)).items()},
            embedding_patterns=ocr48.EMBEDDING_PATTERNS))
        rec._loaded = True

        translator = port_mt.MangaTranslator({'use_gpu': False})

        async def interleave(state, finished):
            await asyncio.sleep(0)       # the other call runs meanwhile
        translator.add_progress_hook(interleave)

        assert not profiling.tracing()
        kept = list(profiling.PAGES)
        off = translate(translator)[0]
        recorded_off = list(profiling.PAGES) != kept
        with profiling.forced():
            on = translate(translator)[0]
            on_page = profiling.PAGES[-1]
            pair = translate(translator, 2)
            pair_pages = list(profiling.PAGES)[-2:]
        export_dir = tmp_path_factory.mktemp('profile')
        mp.setattr(profiling, 'PROFILE_DIR', str(export_dir))
        translate(translator)
        mp.setattr(profiling, 'PROFILE_DIR', None)
        exported = sorted(export_dir.iterdir())
        export_page = profiling.PAGES[-1]
    finally:
        mp.undo()
    return {'off': off, 'recorded_off': recorded_off, 'on': on,
            'page': on_page, 'pair': pair, 'pair_pages': pair_pages,
            'exported': exported, 'export_page': export_page}


def test_off_records_nothing(runs):
    assert not runs['recorded_off']
    assert not profiling.tracing()
    assert profiling.span('ocr.plan') is profiling.span('ocr.beam')
    with profiling.span('ocr.plan') as sp:
        assert sp is None
    with profiling.page() as page:
        assert page is None


def test_off_is_one_flag_check(monkeypatch):
    """Off, ``span``, ``add_span`` and ``count`` read neither a clock nor
    the page, make no span, and ``span`` hands out one shared object."""
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f'read {name} with the tracer off')

        def __call__(self, *args, **kwargs):
            raise AssertionError('made a span with the tracer off')
    for name in ('time', '_page', '_current', 'Span'):
        monkeypatch.setattr(profiling, name, Untouchable())
    shared = {id(profiling.span(f'span {i}')) for i in range(100)}
    assert len(shared) == 1
    for _ in range(100):
        with profiling.span('ocr.beam'):
            assert profiling.count('ocr.tokens', 3) is None
        assert profiling.add_span('graph.capture', 0, 1) is None


def test_tracer_never_touches_the_device(monkeypatch):
    """On, the tracer's own calls neither wait for the device, nor read
    it, nor reset the allocator's peak."""
    def forbidden(*args, **kwargs):
        raise AssertionError('the tracer touched the device')
    for name in ('synchronize', 'reset_peak_memory_stats',
                 'max_memory_allocated'):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    for name in ('item', 'tolist', 'cpu', 'numpy'):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    with profiling.forced(), profiling.page() as page:
        with profiling.span('detect'):
            with profiling.span('detect.postprocess'):
                profiling.count('host_syncs', 2)
            profiling.add_span('graph.capture', 1, 2)
    assert [sp.name for sp in page.spans] == ['detect', 'detect.postprocess',
                                              'graph.capture']
    assert page.counters == {'host_syncs': 2}
    profiling.chrome_events(page, 0)


def stage_of(sp):
    while sp.parent is not None:
        sp = sp.parent
    return sp


def test_sub_spans_nest_in_their_stages(runs):
    page = runs['page']
    names = {sp.name for sp in page.spans}
    assert STAGES <= names and SUB_SPANS <= names, names
    for sp in page.spans:
        assert sp.page is page and sp.t0 <= sp.t1
        assert profiling.self_ns(sp) >= 0
        if sp.name in STAGES:
            assert sp.parent is None
            continue
        assert sp.parent is not None, sp.name
        assert sp.parent.t0 <= sp.t0 <= sp.t1 <= sp.parent.t1
        assert stage_of(sp).name in STAGES
        assert page.t0 <= stage_of(sp).t0 <= stage_of(sp).t1 <= page.t1
    # the self time of a stage is what its sub-spans leave
    ocr_stage = next(sp for sp in page.spans if sp.name == 'ocr')
    kids = [sp for sp in page.spans if sp.parent is ocr_stage]
    assert profiling.self_ns(ocr_stage) == ocr_stage.ns - sum(
        sp.ns for sp in kids)
    assert len([sp for sp in page.spans if sp.name == 'render.region']) == \
        len([r for r in runs['on'].text_regions if r.translation])


def test_concurrent_calls_keep_their_pages(runs):
    a, b = runs['pair_pages']
    assert a.id != b.id
    assert a.t0 < b.t1 and b.t0 < a.t1, 'the two calls did not overlap'
    for page in (a, b):
        stages = [sp.name for sp in page.spans if sp.parent is None]
        assert sorted(stages) == sorted(STAGES)
        assert all(sp.page is page for sp in page.spans)
        assert all(stage_of(sp).page is page for sp in page.spans)
    assert all(ctx.result is not None for ctx in runs['pair'])


def test_stage_durations_are_the_stages(runs):
    off, on = runs['off'].stage_durations, runs['on'].stage_durations
    assert set(off) == set(on) == STAGES
    stages = {sp.name: sp.ns / 1e9 for sp in runs['page'].spans
              if sp.parent is None}
    assert stages == pytest.approx(on, abs=1e-3)


def test_ocr_counters(runs):
    counters = runs['page'].counters
    assert 0 < counters['ocr.tokens'] <= counters['ocr.line_steps']
    assert 'host_syncs' not in counters          # the CPU never waits


def test_export_is_chrome_trace_json(runs):
    files = runs['exported']
    assert len(files) == 1 and files[0].name.startswith('translate-')
    trace = json.loads(files[0].read_text())
    events = trace['traceEvents']
    page = runs['export_page']
    spans = [e for e in events if e.get('ph') == 'X' and e['cat'] == 'span']
    assert [e['name'] for e in spans] == [sp.name for sp in page.spans]
    for e, sp in zip(spans, page.spans):
        assert e['dur'] == pytest.approx(sp.ns / 1000)
        assert e['args']['page'] == page.id
        assert (e['args']['parent'] is None) == (sp.parent is None)
    counters = {e['name']: e['args'][e['name']] for e in events
                if e.get('ph') == 'C'}
    assert counters == page.counters
    assert all(isinstance(e['ts'], float) and isinstance(e['pid'], int)
               for e in spans)


def test_counters_from_threads_lose_nothing():
    """Threads that run in copies of a page's context (as the mesh's
    per-card threads do) add to its counters without losing updates."""
    import contextvars
    import sys
    import threading
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.forced(), profiling.page() as page:
            threads = [threading.Thread(
                target=contextvars.copy_context().run,
                args=(lambda: [profiling.count('host_syncs')
                               for _ in range(2000)],))
                for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert page.counters == {'host_syncs': 16 * 2000}


def test_merge_graphs_count_their_pairs():
    """One OCR direction pass and one merge over N lines decide every pair
    once each: ``geom.pairs`` reads N(N-1)."""
    from manga_image_translator_tpu_torch import textline_merge
    from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
    lines = [Quadrilateral(np.array([[x, y], [x + 30, y], [x + 30, y + 200],
                                     [x, y + 200]]))
             for x in range(100, 400, 36) for y in (100, 400)]
    n = len(lines)
    with profiling.forced(), profiling.page() as page:
        directions = list(ocr.get_ocr(Ocr.ocr48px)._generate_text_direction(
            lines))
        regions = asyncio.run(textline_merge.dispatch(lines, 600, 800))
    assert len(directions) == n and len(regions) > 1
    assert page.counters == {'geom.pairs': n * (n - 1)}


def test_mask_assignment_counts_the_pairs_whose_boxes_meet():
    """``mask.pairs`` counts the component x line pairs whose boxes meet:
    of 4 components over 9 px and 5 lines (20 pairs), a stroke inside line
    0, one inside line 1, one inside the overlap of lines 3 and 4, and a
    bar that meets no box: 4 pairs."""
    from manga_image_translator_tpu_torch import mask_refinement
    from manga_image_translator_tpu_torch.utils.geometry import Quadrilateral
    boxes = [(20, 20, 60, 40), (100, 20, 140, 40), (20, 80, 140, 100),
             (20, 120, 80, 140), (60, 120, 140, 140)]
    lines = [Quadrilateral(np.array([[a, b], [c, b], [c, d], [a, d]]))
             for a, b, c, d in boxes]
    mask = np.zeros((160, 160), np.uint8)
    mask[25:35, 25:35] = 255                # inside line 0
    mask[25:35, 105:115] = 255              # inside line 1
    mask[45:75, 75:80] = 255                # between the boxes
    mask[122:138, 62:78] = 255              # inside lines 3 and 4
    mask[90:92, 50:52] = 255                # 4 px: no component
    with profiling.forced(), profiling.page() as page:
        assigned = mask_refinement.assign_components(mask, lines, 1e-2)
    assert assigned is not None
    assert page.counters == {'mask.pairs': 4}
