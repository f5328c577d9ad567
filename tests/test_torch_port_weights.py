"""PyTorch port: the JAX→torch weight bridge, the no-JAX import guard and
the kernel wrappers' device dispatch on machines without a card (the
card-only cases are in test_torch_port_cuda.py)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from manga_image_translator_tpu.models import dbnet as jax_dbnet
from manga_image_translator_tpu.models import ocr48 as jax_ocr48
from manga_image_translator_tpu.models.torch_loader import convert_state_dict
from manga_image_translator_tpu_torch.models import dbnet, ocr48
from manga_image_translator_tpu_torch.ops import (bilateral, charhead,
                                                  conv_stream, cuda_build,
                                                  fourier_unit)
from manga_image_translator_tpu_torch.weights import (load_state_dict_into,
                                                      torch_state_dict_from_jax)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'manga_image_translator_tpu_torch'


def _np(params):
    return {k: np.array(v) for k, v in params.items()}


@pytest.fixture(scope='module')
def dbnet_params():
    return _np(jax_dbnet.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope='module')
def ocr_params():
    return _np(jax_ocr48.init_params(dict_size=64))


def _assert_round_trip(params, sd, **kw):
    back = convert_state_dict(sd, **kw)
    assert set(back) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)


def test_dbnet_round_trip(dbnet_params):
    sd = torch_state_dict_from_jax(dbnet_params,
                                   dbnet.TRANSPOSED_CONV_PATTERNS)
    _assert_round_trip(dbnet_params, sd, transposed_conv_patterns=(
        jax_dbnet.TRANSPOSED_CONV_PATTERNS))
    # and the port's module takes every key with its shape
    load_state_dict_into(dbnet.DBNet(), sd)


def test_ocr48_round_trip(ocr_params):
    sd = torch_state_dict_from_jax(
        ocr_params, embedding_patterns=ocr48.EMBEDDING_PATTERNS)
    _assert_round_trip(ocr_params, sd,
                       embedding_patterns=jax_ocr48.EMBEDDING_PATTERNS)
    load_state_dict_into(ocr48.OCR48(64), sd)


def _new_models():
    """(JAX init_params, the port's ``init_state_dict``, its module, the
    bridge's and the JAX converter's keyword arguments) of each model of
    the other detectors and inpainters, made on demand (the dbconvnext
    has ~150 M parameters)."""
    from manga_image_translator_tpu.models import aot as jax_aot
    from manga_image_translator_tpu.models import craft as jax_craft
    from manga_image_translator_tpu.models import ctd as jax_ctd
    from manga_image_translator_tpu.models import \
        dbnet_convnext as jax_cnx
    from manga_image_translator_tpu.models import lama as jax_lama
    from manga_image_translator_tpu.models import paddle_det as jax_paddle
    from manga_image_translator_tpu_torch.models import (aot, craft, ctd,
                                                         dbnet_convnext,
                                                         lama, paddle_det)
    return {
        'aot': (jax_aot.init_params, aot.init_state_dict, aot.AOTGenerator,
                dict(transposed_conv_patterns=aot.TRANSPOSED_CONV_PATTERNS),
                dict(transposed_conv_patterns=(
                    jax_aot.TRANSPOSED_CONV_PATTERNS))),
        'ctd': (jax_ctd.init_params, ctd.init_state_dict,
                ctd.ComicTextDetectorNet,
                dict(transposed_conv_patterns=ctd.TRANSPOSED_CONV_PATTERNS),
                dict(transposed_conv_patterns=(
                    jax_ctd.TRANSPOSED_CONV_PATTERNS))),
        'craft': (jax_craft.init_params, craft.init_state_dict, craft.CRAFT,
                  {}, {}),
        'craft_refiner': (jax_craft.init_refiner_params,
                          craft.init_refiner_state_dict, craft.RefineNet,
                          {}, {}),
        'dbconvnext': (
            jax_cnx.init_params, dbnet_convnext.init_state_dict,
            dbnet_convnext.DBNetConvNext,
            dict(transposed_conv_patterns=(
                dbnet_convnext.TRANSPOSED_CONV_PATTERNS)),
            dict(transposed_conv_patterns=jax_cnx.TRANSPOSED_CONV_PATTERNS)),
        'paddle': (jax_paddle.init_params, paddle_det.init_state_dict,
                   paddle_det.PaddleDet,
                   dict(transposed_conv_patterns=(
                       paddle_det.TRANSPOSED_CONV_PATTERNS)),
                   # the JAX conv_t reads the converted HWIO layout too
                   dict(transposed_conv_patterns=(
                       paddle_det.TRANSPOSED_CONV_PATTERNS))),
        'lama_mpe_9': (
            lambda: jax_lama.init_params(9),
            lambda: lama.init_state_dict(9), lambda: lama.LamaGenerator(9),
            dict(transposed_conv_patterns=lama.transposed_conv_patterns(9)),
            dict(transposed_conv_patterns=(
                jax_lama.TRANSPOSED_CONV_PATTERNS_FOR_BLOCKS[9]))),
        **_slice_models(),
    }


def _slice_models():
    """The same for the other OCRs, the upscalers and the colorizer."""
    from manga_image_translator_tpu.models import esrgan as jax_esrgan
    from manga_image_translator_tpu.models import mc2 as jax_mc2
    from manga_image_translator_tpu.models import ocr32 as jax_ocr32
    from manga_image_translator_tpu.models import ocr48_ctc as jax_ctc
    from manga_image_translator_tpu.models import waifu2x as jax_w2x
    from manga_image_translator_tpu_torch.models import (esrgan, mc2, ocr32,
                                                         ocr48_ctc, waifu2x)
    emb = dict(embedding_patterns=ocr32.EMBEDDING_PATTERNS)
    gen_t = dict(transposed_conv_patterns=mc2.GENERATOR_TRANSPOSED_PATTERNS)
    return {
        'ocr48_ctc': (lambda: jax_ctc.init_params(64),
                      lambda: ocr48_ctc.init_state_dict(64),
                      lambda: ocr48_ctc.OCR48CTC(64), {}, {}),
        'ocr32': (lambda: jax_ocr32.init_params(64),
                  lambda: ocr32.init_state_dict(64),
                  lambda: ocr32.OCR32(64), emb,
                  dict(embedding_patterns=jax_ocr32.EMBEDDING_PATTERNS)),
        'esrgan_6': (lambda: jax_esrgan.init_params(nb=6),
                     lambda: esrgan.init_state_dict(nb=6),
                     lambda: esrgan.RRDBNet(6), {}, {}),
        'mc2_generator': (
            jax_mc2.init_generator_params, mc2.init_generator_state_dict,
            mc2.Generator, gen_t,
            dict(transposed_conv_patterns=(
                jax_mc2.GENERATOR_TRANSPOSED_PATTERNS))),
        'mc2_ffdnet': (jax_mc2.init_ffdnet_params,
                       mc2.init_ffdnet_state_dict, mc2.FFDNet, {}, {}),
        # the JAX deconvolution kernel is (kh, kw, out, in): the plain
        # HWIO transpose gives torch's (in, out, kh, kw) and back
        'upconv7': (jax_w2x.init_params, waifu2x.init_state_dict,
                    waifu2x.UpConv7, {}, {}),
    }


@pytest.mark.parametrize('name', ['aot', 'ctd', 'craft', 'craft_refiner',
                                  'dbconvnext', 'paddle', 'lama_mpe_9',
                                  'ocr48_ctc', 'ocr32', 'esrgan_6',
                                  'mc2_generator', 'mc2_ffdnet', 'upconv7'])
def test_new_model_round_trip(name):
    """JAX init_params → torch state dict → JAX params is exact; the port's
    module takes every key strictly; its own ``init_state_dict`` is the
    same draws (so its random weights are the JAX package's)."""
    jax_init, port_init, module, kw, jax_kw = _new_models()[name]
    params = _np(jax_init())
    sd = torch_state_dict_from_jax(params, **kw)
    _assert_round_trip(params, sd, **jax_kw)
    load_state_dict_into(module(), sd)
    own = port_init()
    assert set(own) == set(sd)
    for k, v in sd.items():
        assert torch.equal(own[k], v), k


def test_sd_round_trip():
    """The SD key space: JAX init_params(tiny) -> torch state dict (convs
    HWIO -> OIHW, the VAE's 1x1 q/k/v/proj_out included; dense (in, out)
    -> (out, in); the text embeddings as they are) -> JAX params is
    exact, and the port's ``SDModel`` takes every key strictly."""
    from manga_image_translator_tpu.models import sd as jax_sd
    from manga_image_translator_tpu_torch.models import sd
    params = _np(jax_sd.init_params(jax_sd.SDConfig.tiny()))
    state = torch_state_dict_from_jax(
        params, embedding_patterns=sd.EMBEDDING_PATTERNS)
    _assert_round_trip(params, state,
                       embedding_patterns=jax_sd.EMBEDDING_PATTERNS)
    key = 'first_stage_model.encoder.mid.attn_1.q.weight'
    assert state[key].shape == (64, 64, 1, 1)
    assert np.array_equal(state[key][:, :, 0, 0].numpy(),
                          params[key][0, 0].T)
    tok = 'cond_stage_model.transformer.text_model.embeddings.' \
        'token_embedding.weight'
    assert state[tok].shape == (97, 64)
    model = sd.build_sd(sd.SDConfig.tiny(), 'cpu', state)
    own = sd.init_state_dict(sd.SDConfig.tiny())
    assert set(own) == set(state) == set(model.state_dict())
    for k, v in own.items():
        assert v.shape == state[k].shape, k


def test_mpe_tables_round_trip():
    """The MPE tables are embeddings (not transposed), the scales 0-d."""
    from manga_image_translator_tpu.models import lama as jax_lama
    from manga_image_translator_tpu_torch.models import lama
    params = {'rel_pos_emb.weight': jax_lama.sinusoidal_embedding_table(),
              'direct_emb.weight': np.random.RandomState(3).randn(4, 64)
              .astype(np.float32),
              'alpha5': np.float32(0.5), 'alpha6': np.zeros((), np.float32)}
    sd = torch_state_dict_from_jax(
        params, embedding_patterns=lama.EMBEDDING_PATTERNS)
    assert sd['alpha5'].shape == () and sd['rel_pos_emb.weight'].shape == (
        128, 64)
    _assert_round_trip({k: np.asarray(v) for k, v in params.items()}, sd,
                       embedding_patterns=lama.EMBEDDING_PATTERNS)
    mpe = lama.build_mpe(sd)
    init = lama.mpe_init_state_dict()
    for k in ('rel_pos_emb.weight', 'direct_emb.weight'):
        assert torch.equal(mpe.state_dict()[k], init[k])


def test_load_rejects_missing_and_misshaped(ocr_params):
    sd = torch_state_dict_from_jax(
        ocr_params, embedding_patterns=ocr48.EMBEDDING_PATTERNS)
    bad = dict(sd)
    bad.pop('pred.bias')
    with pytest.raises(KeyError):
        load_state_dict_into(ocr48.OCR48(64), bad)
    bad = dict(sd)
    bad['pred1.0.weight'] = bad['pred1.0.weight'].t()[:10]
    with pytest.raises(ValueError):
        load_state_dict_into(ocr48.OCR48(64), bad)


def test_port_never_imports_jax():
    """The port's main path, CLI, ct2 translators, the other detectors and
    inpainters, the GIMP export, the device crops, the ops and the mesh
    import neither jax nor the JAX package,
    nor the packages only other translators need; the
    serving entry points (gateway, executor, ws worker, studio and its
    GUI) import
    neither jax nor the JAX package (a fresh interpreter: this test process
    already has jax)."""
    code = (
        'import sys\n'
        'import manga_image_translator_tpu_torch.manga_translator\n'
        'import manga_image_translator_tpu_torch.__main__\n'
        'import manga_image_translator_tpu_torch.mode.local\n'
        'import manga_image_translator_tpu_torch.detection.default\n'
        'import manga_image_translator_tpu_torch.ocr.model_48px\n'
        'import manga_image_translator_tpu_torch.mask_refinement\n'
        'import manga_image_translator_tpu_torch.inpainting\n'
        'import manga_image_translator_tpu_torch.inpainting.inpainting_lama\n'
        'import manga_image_translator_tpu_torch.models.lama\n'
        'import manga_image_translator_tpu_torch.ops.fourier_unit\n'
        'import manga_image_translator_tpu_torch.ops.conv_stream\n'
        'import manga_image_translator_tpu_torch.rendering\n'
        'import manga_image_translator_tpu_torch.rendering.text_render_eng\n'
        'import manga_image_translator_tpu_torch.rendering.hyphenation\n'
        'import manga_image_translator_tpu_torch.translators\n'
        'import manga_image_translator_tpu_torch.translators.ct2_model\n'
        'import manga_image_translator_tpu_torch.translators.ct2_offline\n'
        'import manga_image_translator_tpu_torch.translators.selective\n'
        'import manga_image_translator_tpu_torch.translators.hf_offline\n'
        'import manga_image_translator_tpu_torch.utils.spm_lite\n'
        '# the other detectors, inpainters and the GIMP export\n'
        'import manga_image_translator_tpu_torch.detection.ctd\n'
        'import manga_image_translator_tpu_torch.detection.ctd_textmask\n'
        'import manga_image_translator_tpu_torch.detection.craft\n'
        'import manga_image_translator_tpu_torch.detection.dbnet_convnext\n'
        'import manga_image_translator_tpu_torch.detection.paddle\n'
        'import manga_image_translator_tpu_torch.detection.paddle_onnx\n'
        'import manga_image_translator_tpu_torch.models.ctd\n'
        'import manga_image_translator_tpu_torch.models.craft\n'
        'import manga_image_translator_tpu_torch.models.dbnet_convnext\n'
        'import manga_image_translator_tpu_torch.models.paddle_det\n'
        'import manga_image_translator_tpu_torch.models.aot\n'
        'import manga_image_translator_tpu_torch.inpainting.inpainting_aot\n'
        'import manga_image_translator_tpu_torch.rendering.gimp_render\n'
        'import manga_image_translator_tpu_torch.save\n'
        '# the other OCRs, the upscalers and the colorizer\n'
        'import manga_image_translator_tpu_torch.ocr.model_32px\n'
        'import manga_image_translator_tpu_torch.ocr.model_48px_ctc\n'
        'import manga_image_translator_tpu_torch.ocr.model_manga_ocr\n'
        'import manga_image_translator_tpu_torch.models.ocr32\n'
        'import manga_image_translator_tpu_torch.models.ocr48_ctc\n'
        'import manga_image_translator_tpu_torch.upscaling\n'
        'import manga_image_translator_tpu_torch.upscaling.common\n'
        'import manga_image_translator_tpu_torch.upscaling.esrgan\n'
        'import manga_image_translator_tpu_torch.models.esrgan\n'
        'import manga_image_translator_tpu_torch.models.waifu2x\n'
        'import manga_image_translator_tpu_torch.utils.ncnn_lite\n'
        'import manga_image_translator_tpu_torch.colorization\n'
        'import manga_image_translator_tpu_torch.colorization.common\n'
        'import manga_image_translator_tpu_torch.colorization'
        '.manga_colorization_v2\n'
        'import manga_image_translator_tpu_torch.models.mc2\n'
        '# Stable Diffusion, its tagger and ONNX evaluator, the CTC loss\n'
        'import manga_image_translator_tpu_torch.inpainting.inpainting_sd\n'
        'import manga_image_translator_tpu_torch.inpainting.booru_tagger\n'
        'import manga_image_translator_tpu_torch.models.sd\n'
        'import manga_image_translator_tpu_torch.utils.onnx_eval\n'
        'import manga_image_translator_tpu_torch.utils.safetensors_lite\n'
        'import manga_image_translator_tpu_torch.training\n'
        'import manga_image_translator_tpu_torch.training.ctc\n'
        '# device crops, morphology and image ops, the mesh\n'
        'import manga_image_translator_tpu_torch.ops\n'
        'import manga_image_translator_tpu_torch.ops.warp\n'
        'import manga_image_translator_tpu_torch.ops.morphology\n'
        'import manga_image_translator_tpu_torch.ops.image\n'
        'import manga_image_translator_tpu_torch.parallel\n'
        'import manga_image_translator_tpu_torch.parallel.mesh\n'
        '# the decode loops on the device (CUDA graphs on the card)\n'
        'import manga_image_translator_tpu_torch.ops.device_loop\n'
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")\n'
        '       or m == "manga_image_translator_tpu"\n'
        '       or m.startswith("manga_image_translator_tpu.")]\n'
        'assert not bad, bad\n'
        '# the card machine may lack these: only a chosen translator imports\n'
        'late = [m for m in ("aiohttp", "openai", "transformers")\n'
        '        if m in sys.modules]\n'
        'assert not late, late\n'
        '# the serving entry points, which import aiohttp themselves\n'
        'import manga_image_translator_tpu_torch.server.main\n'
        'import manga_image_translator_tpu_torch.server.instance\n'
        'import manga_image_translator_tpu_torch.server.myqueue\n'
        'import manga_image_translator_tpu_torch.server.to_json\n'
        'import manga_image_translator_tpu_torch.mode.share\n'
        'import manga_image_translator_tpu_torch.mode.ws\n'
        'import manga_image_translator_tpu_torch.studio\n'
        'import manga_image_translator_tpu_torch.studio_gui\n'
        'import manga_image_translator_tpu_torch.utils.threading\n'
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")\n'
        '       or m == "manga_image_translator_tpu"\n'
        '       or m.startswith("manga_image_translator_tpu.")]\n'
        'assert not bad, bad\n')
    env = dict(os.environ)
    env['PYTHONPATH'] = str(ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_import_no_jax_package():
    pat = re.compile(r'^\s*(from|import)\s+(jax\b|manga_image_translator_tpu'
                     r'(?!_torch)\b)', re.M)
    files = list(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pat.search(f.read_text(encoding='utf-8'))]
    assert not offenders, offenders


def test_wrappers_use_plain_version_on_cpu():
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.randint(0, 256, (12, 10, 3)).astype(np.uint8))
    assert torch.equal(bilateral.bilateral_filter(img, 5, 30.0, 30.0),
                       bilateral.bilateral_filter_ref(img, 5, 30.0, 30.0))


def test_wrappers_reject_unknown_device():
    meta = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device='meta')
    with pytest.raises(ValueError):
        bilateral.bilateral_filter_batch(meta)
    with pytest.raises(ValueError):
        charhead.char_topk(torch.zeros((4, 320), device='meta'), {}, 5)
    x = torch.zeros((1, 8, 8, 4), device='meta')
    with pytest.raises(ValueError):
        fourier_unit.fourier_unit(x, torch.zeros((8, 8), device='meta'),
                                  torch.zeros(8, device='meta'))
    with pytest.raises(ValueError):
        conv_stream.conv2d_stream(x, torch.zeros((3, 3, 4, 2),
                                                 device='meta'))


def test_new_wrappers_use_plain_version_on_cpu():
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(1, 6, 7, 2).astype(np.float32))
    w = torch.from_numpy(rs.randn(4, 4).astype(np.float32))
    b = torch.from_numpy(rs.randn(4).astype(np.float32))
    before = dict(cuda_build.LAUNCHES)
    assert torch.equal(fourier_unit.fourier_unit(x, w, b),
                       fourier_unit.fourier_unit_ref(x, w, b))
    wc = torch.from_numpy(rs.randn(3, 3, 2, 5).astype(np.float32))
    assert torch.equal(conv_stream.conv2d_stream(x, wc, relu=True),
                       conv_stream.conv2d_stream_ref(x, wc, relu=True))
    assert cuda_build.LAUNCHES == before      # plain versions count nothing
