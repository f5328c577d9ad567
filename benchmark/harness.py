"""One run of one cell of ``BENCHMARK.json``.

The window drives ``MangaTranslatorLocal.translate(image, config)``, the
per-page call of the ``local`` mode, as a closed loop with one client:
the next page is sent when the previous page's rendered image is back in
host memory, as a scanlator running the CLI over a chapter does. The
pages are a chapter drawn from ``--seed`` (``pages.py``, with the cell's
traffic file), cycled; the weights are drawn from the configuration's own
weight seed and written once into ``build/benchmark/models/`` in the
layout the program's loaders read (on the card by ``prepare.py``, before
the timed process starts).

Set-up (``setup_s``: from the timed process's start to the first timed
page) builds the translator, draws the chapter and its detection maps,
and translates the traffic's first ``warmup_pages`` pages. The window
then runs whole pages until ``--seconds`` have passed; it closes when the
page in flight is back. On the sampled pages the hooks queue copies of
what each network got and gave without waiting for them
(``seams.keep``); they are waited for once the window has closed.

After the window: the device's peak memory is read, the program is
freed, and the plain references recompute what the timed path produced
on the sampled pages (``nets/*.check``), and the page away from its text
is held to what the pipeline received (``outside.py``); each number is
held against its limit in the configuration file. With ``--control 1``
the references' readings one precision below (``precision.py``) take the
program's place, so the same comparison judges them. With ``--trace 1``
the window runs under ``torch.profiler`` and the result carries the
cell's per-layer metrics (``metrics/<name>.py``) instead of the
end-to-end ones.
"""
from __future__ import annotations

import argparse
import asyncio
import gc
import importlib
import json
import logging
import os
import sys
import time
import zlib

import numpy as np

from . import cell as cells, nets, outside, pages as pagegen, seams
from .cell import HERE, ROOT, load_cell, load_json  # noqa: F401

THREADS = 4                  # host threads of each pool (see run.py)
WORK = cells.WORK
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'manga_image_translator_tpu')


def environment() -> None:
    """Caches at fixed paths inside the checkout, the program's weights
    from the benchmark's directory only (no random fallback), no JAX
    through ``transformers``."""
    cache = os.path.join(WORK, 'cache')
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('TORCHINDUCTOR_CACHE_DIR', 'inductor'),
                     ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = os.path.join(cache, sub)
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    os.environ['MIT_TPU_ALLOW_RANDOM_WEIGHTS'] = '0'


def model_dir(config: dict) -> str:
    return cells.model_dir(config, WORK)


def weight_seed(config: dict, name: str) -> int:
    """The seed of network ``name``'s weights: the configuration's weight
    seed and the network's name, so that configurations which share a
    network and a weight seed share its weights."""
    return config['weight_seed'] + zlib.crc32(name.encode()) % 1_000_003


def ensure_weights(config: dict, mdir: str, device) -> list:
    written = []
    os.makedirs(mdir, exist_ok=True)
    for name, spec in sorted(config['networks'].items()):
        net = nets.load(name)
        if not all(os.path.exists(os.path.join(mdir, f))
                   for f in net.files(spec)):
            net.write(mdir, spec, weight_seed(config, name), device)
            written.append(name)
    with open(os.path.join(mdir, cells.READY), 'w') as f:
        f.write('\n'.join(sorted(config['networks'])) + '\n')
    return written


def percentile(values, q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: those
    loaded), each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.')[0] for m in names
                   if m.split('.')[0] in FORBIDDEN})


class Run:
    """What the metric readers read: the window's pages (latency and
    stage seconds each), the trace's reduction, the recorder's work
    counts, the configuration."""

    def __init__(self, config, traffic, rec):
        self.config, self.traffic, self.rec = config, traffic, rec
        self.latencies, self.stages = [], []
        self.window_s = 0.0
        self.trace = None


def page_detail(index: int, ctx) -> dict:
    """What the pipeline made of a page: lines read, regions translated,
    characters of translation, pixels inpainted."""
    mask = ctx.get('mask')
    return {'page': index, 'lines': len(ctx.get('textlines') or []),
            'regions': len(ctx.get('text_regions') or []),
            'translated_chars': sum(len(getattr(r, 'translation', '') or '')
                                    for r in ctx.get('text_regions') or []),
            'mask_px': 0 if mask is None else int((mask > 0).sum())}


def sample_pages(chapter, count: int, seed: int) -> set:
    """The pages the check compares: the one with the most lines and
    ``count - 1`` others drawn from the seed."""
    longest = max(chapter, key=lambda p: p.n_lines).index
    rng = np.random.default_rng([seed, 7])
    others = [p.index for p in chapter if p.index != longest]
    pick = rng.choice(others, size=min(count - 1, len(others)),
                      replace=False) if count > 1 else []
    return {longest, *map(int, pick)}


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, control: bool = False,
             per_layer=(), log=print, end_to_end=None) -> dict:
    import cv2
    import torch
    torch.set_num_threads(THREADS)
    cv2.setNumThreads(THREADS)
    environment()
    os.environ.update(config.get('environment', {}))
    mdir = model_dir(config)
    os.environ['MIT_TPU_MODEL_DIR'] = mdir
    from PIL import Image
    from manga_image_translator_tpu_torch.config import Config
    from manga_image_translator_tpu_torch.mode.local import \
        MangaTranslatorLocal
    from manga_image_translator_tpu_torch.ops import cuda_build
    from manga_image_translator_tpu_torch.utils import inference
    inference.MODULE_DIR = type(inference.MODULE_DIR)(mdir)
    logging.getLogger('manga-translator').setLevel(logging.WARNING)
    written = ensure_weights(config, mdir, device)

    rec = seams.Recorder()
    seams.install_stage_spans(rec)
    if device == 'cuda':
        seams.install_kernel_shapes(rec)
    for name, spec in config['networks'].items():
        nets.load(name).install(rec, spec)
    outside.install(rec)

    pipeline = Config(**config['pipeline'])
    det = pipeline.detector
    chapter = pagegen.make_chapter(traffic, seed, config.get('page_scale',
                                                             1.0))
    rec.pages = chapter
    seam = config['seam']
    density = []
    for p in chapter:
        rec.maps[p.index] = pagegen.detection_maps(
            p, det.detection_size, 256, det.unclip_ratio, seam['prob'],
            seam['mask'])
        density.append(pagegen.map_density(rec.maps[p.index][0],
                                           det.text_threshold))
    images = [Image.fromarray(p.image) for p in chapter]
    sampled = sample_pages(chapter, int(traffic['sample_pages']), seed)

    translator = MangaTranslatorLocal({'use_gpu': device == 'cuda'})
    loop = asyncio.new_event_loop()

    def serve(i):
        page = chapter[i % len(chapter)]
        rec.page = page
        ctx = loop.run_until_complete(translator.translate(images[page.index],
                                                           pipeline))
        if ctx.result is None or not ctx.get('text_regions'):
            raise RuntimeError(
                f'page {page.index}: no rendered result ('
                f'{len(ctx.get("textlines") or [])} lines detected of '
                f'{page.n_lines}, {len(ctx.get("text_regions") or [])} '
                f'regions)')
        return ctx

    for i in range(int(traffic['warmup_pages'])):
        serve(i)
    rec.steps.clear()
    run = Run(config, traffic, rec)
    launches0 = dict(cuda_build.LAUNCHES)
    attempted = failed = 0
    detail = []
    tracer = None
    if trace:
        from .trace import Trace
        tracer = Trace().__enter__()
    setup_s = time.time() - t_start
    rec.counting = True
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        index = i % len(chapter)
        rec.sampling = i < len(chapter) and index in sampled
        attempted += 1
        a = time.perf_counter()
        try:
            ctx = serve(i)
        except Exception as e:            # counted, and the window goes on
            failed += 1
            log(json.dumps({'page_failed': index, 'error': repr(e)[:300]}))
            ctx = None
        b = time.perf_counter()
        if ctx is not None:
            run.latencies.append(b - a)
            run.stages.append(dict(ctx.stage_durations))
            if i < len(chapter):
                detail.append(page_detail(index, ctx))
        i += 1
    run.window_s = time.perf_counter() - t0
    rec.counting = rec.sampling = False
    if tracer is not None:
        tracer.__exit__(None, None, None)
    if device == 'cuda':             # the recorded copies have landed
        torch.cuda.synchronize()
    launches = {k: v - launches0.get(k, 0)
                for k, v in cuda_build.LAUNCHES.items()}
    peak = (torch.cuda.max_memory_allocated() if device == 'cuda'
            else 0)
    if tracer is not None:
        from .trace import reduce
        run.trace = reduce(tracer, rec.spans)
        del tracer

    served = {p for p in sampled if p < i}
    log(json.dumps({
        'pages': len(run.latencies), 'attempted': attempted,
        'window_s': round(run.window_s, 4),
        'chapter_pages': len(chapter), 'warmup_pages':
            int(traffic['warmup_pages']),
        'lines_per_page': [p.n_lines for p in chapter],
        'map_density': [round(d, 5) for d in density],
        'steps': {k: v for k, v in rec.steps.items()},
        'launches': launches, 'weights_written': written,
        'record_host_s': round(seams.RECORD_S[0], 4),
        'first_cycle': detail,
        'latencies_s': [round(x, 4) for x in run.latencies],
        'stage_ms': {k: round(1000 * sum(st.get(k, 0) for st in run.stages)
                              / max(len(run.stages), 1), 2)
                     for k in (run.stages[0] if run.stages else {})},
        'sampled_pages': sorted(sampled)}))

    # the program is freed before the references run on the card
    del translator
    loop.close()
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()

    numbers, controls = {}, {}
    limits = config['limits']
    for name, spec in config['networks'].items():
        net = nets.load(name)
        numbers.update(net.check(rec, spec, mdir, device))
        if control:
            controls.update(net.check(rec, spec, mdir, device,
                                      config['control'][name]))
    numbers.update(outside.check(rec, traffic))
    numbers['sampled_pages_served'] = len(served)
    program = dict(numbers)
    if control:
        # the control in the program's place: the same comparison judges it
        numbers.update(controls)
    limits = dict(limits, sampled_pages_served=len(sampled))
    # a number the check could not read (None) fails its limit
    checked = {k: {'value': numbers.get(k), 'limit': limits[k]}
               for k in {**numbers, **limits}}
    ok = all(v['value'] is not None and v['value'] <= v['limit']
             for k, v in checked.items() if k != 'sampled_pages_served')
    ok = ok and len(served) == len(sampled) and failed == 0
    metrics = {}
    if not trace:
        lat = run.latencies
        metrics = {
            'pages_per_s': {'value': len(lat) / run.window_s,
                            'unit': 'pages/s'},
            'page_p90_s': {'value': percentile(lat, 0.9), 'unit': 's'},
            'peak_mem_gib': {'value': peak / 2 ** 30, 'unit': 'GiB'},
            'setup_s': {'value': setup_s, 'unit': 's'}}
        if end_to_end is not None:
            metrics = {k: v for k, v in metrics.items() if k in end_to_end}
    else:
        for m in per_layer:
            value = importlib.import_module(
                f'benchmark.metrics.{m["name"]}').read(run)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    out = {'correct': bool(ok), 'attempted': attempted,
           'failed': failed + (0 if ok else len(sampled)),
           'metrics': metrics, 'peak': peak, 'run': run,
           'checked': checked, 'compared': dict(rec.compared)}
    if control:
        out['program'] = program
    return out


def device_info(torch, peak: int, trace) -> dict:
    info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': 1, 'memory_peak_bytes': int(peak)}
    if trace is not None:
        info['busy_s'] = trace['busy_s']
        info['window_s'] = trace['window_s']
    return info


def breakdown(trace) -> dict:
    ops = sorted(trace['kernels'].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace['idle_by_stage'].items(), key=lambda kv: -kv[1])
    return {'device_ops': [[n[:120], s] for n, s in ops],
            'idle_gaps': [[n, s] for n, s in gaps[:10]]}


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', type=int, choices=(0, 1), default=0,
                    help='judge the lower-precision control in the '
                         "program's place (benchmark/tests only)")
    args = ap.parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell['chips']):
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f'benchmark: needs {cell["chips"]} CUDA device(s), found '
              f'{found}', file=sys.stderr)
        return 2
    def in_cell(m):
        return cell['name'] in m.get('workloads', [cell['name']])

    per_layer = [m for m in bench['per_layer'] if in_cell(m)]
    end_to_end = {m['name'] for m in bench['end_to_end'] if in_cell(m)}
    res = run_cell(config, traffic, args.seed, args.seconds,
                   bool(args.trace), 'cuda', t_start, bool(args.control),
                   per_layer, end_to_end=end_to_end)
    bad = forbidden_modules()
    if bad:
        print(f'benchmark: forbidden modules loaded: {bad}', file=sys.stderr)
        return 3
    result = {'correct': res['correct'], 'attempted': res['attempted'],
              'failed': res['failed'], 'metrics': res['metrics'],
              'device': device_info(torch, res['peak'],
                                    res['run'].trace)}
    if args.trace:
        result['breakdown'] = breakdown(res['run'].trace)
    if args.control:
        result['program'] = res['program']
    result['checked'] = res['checked']
    for k, v in res['checked'].items():
        print(f'check {k}: {v["value"]!r} limit {v["limit"]!r}',
              file=sys.stderr)
    print(json.dumps({'compared': res['compared']}))
    print(json.dumps(result))
    return 0
