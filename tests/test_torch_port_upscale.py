"""PyTorch port, the upscalers: ESRGAN (its network, its 256-px tiling,
both checkpoint key layouts), waifu2x's upconv_7 and the ncnn graph
evaluator against the JAX package's on the CPU, on the same weights:
seeded draws, or checkpoint and ncnn files that the module writes itself
into a model directory both packages read. Every JAX reference is computed
once, in the module's fixture."""
import asyncio

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import test_upscaling as jax_upscaling_tests
from manga_image_translator_tpu import upscaling as jax_upscaling
from manga_image_translator_tpu.config import Upscaler as JUpscaler
from manga_image_translator_tpu.models import esrgan as jax_esrgan
from manga_image_translator_tpu.models import waifu2x as jax_w2x
from manga_image_translator_tpu.upscaling import esrgan as jax_up_esrgan
from manga_image_translator_tpu.utils import inference as jax_inference
from manga_image_translator_tpu.utils import ncnn_lite as jax_ncnn
from manga_image_translator_tpu_torch import upscaling
from manga_image_translator_tpu_torch.config import Upscaler
from manga_image_translator_tpu_torch.models import esrgan, waifu2x
from manga_image_translator_tpu_torch.upscaling import esrgan as up_esrgan
from manga_image_translator_tpu_torch.utils import inference, ncnn_lite
from manga_image_translator_tpu_torch.utils.ncnn_lite import model_relpath
from manga_image_translator_tpu_torch.weights import torch_state_dict_from_jax

torch.set_num_threads(2)

# the checkpoints the module writes: narrow RRDBNets (nf 8, gc 4, 2 blocks)
NF, GC, NB = 8, 4, 2
W2X_FAMILY = 'upconv_7_anime'
# (registry key, ratio) of each dispatch
DISPATCHES = (('esrgan', 2), ('4xultrasharp', 3), ('waifu2x', 2),
              ('waifu2x', 4))


def _np(params):
    return {k: np.array(v) for k, v in params.items()}


def _realesrgan_state_dict(rs):
    """A new-style (Real-ESRGAN) state dict, as tests/test_upscaling.py
    writes one."""
    def t(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * 0.05)
    sd = {'conv_first.weight': t(NF, 3, 3, 3), 'conv_first.bias': t(NF)}
    for i in range(NB):
        for j in (1, 2, 3):
            for k in (1, 2, 3, 4, 5):
                cin = NF + (k - 1) * GC
                cout = GC if k < 5 else NF
                sd[f'body.{i}.rdb{j}.conv{k}.weight'] = t(cout, cin, 3, 3)
                sd[f'body.{i}.rdb{j}.conv{k}.bias'] = t(cout)
    for name in ('conv_body', 'conv_up1', 'conv_up2', 'conv_hr'):
        sd[f'{name}.weight'] = t(NF, NF, 3, 3)
        sd[f'{name}.bias'] = t(NF)
    sd['conv_last.weight'] = t(3, NF, 3, 3)
    sd['conv_last.bias'] = t(3)
    return sd


def _cunet_style_graph(path, rs):
    """tests/test_upscaling.py's cunet-shaped graph (Split → conv branch →
    Crop-to-ref, an SE block: global Pooling → InnerProduct → Sigmoid →
    broadcast multiply), plus a residual BinaryOp add and a channel
    Concat."""
    ci, cm = 3, 4
    w1 = rs.randn(cm * ci * 9).astype(np.float32) * 0.1
    b1 = rs.randn(cm).astype(np.float32) * 0.01
    wfc1 = rs.randn(2 * cm).astype(np.float32) * 0.1
    bfc1 = rs.randn(2).astype(np.float32) * 0.01
    wfc2 = rs.randn(cm * 2).astype(np.float32) * 0.1
    bfc2 = rs.randn(cm).astype(np.float32) * 0.01
    lines = [
        '7767517', '12 14',
        'Input input 0 1 input',
        'Split split0 1 2 input in_a in_b',
        f'Convolution conv1 1 1 in_a f1 0={cm} 1=3 5=1 6={w1.size}',
        'ReLU relu1 1 1 f1 f1r 0=0.100000',
        'Pooling gap 1 1 f1r pooled 0=1 4=1',
        f'InnerProduct fc1 1 1 pooled fc1o 0=2 1=1 2={wfc1.size} 9=1',
        f'InnerProduct fc2 1 1 fc1o fc2o 0={cm} 1=1 2={wfc2.size}',
        'Sigmoid sig 1 1 fc2o gate',
        'BinaryOp scale 2 1 f1r gate scaled 0=2',
        'Crop crop0 2 1 in_b scaled in_c',
        'BinaryOp add 2 1 in_c in_c doubled 0=0',
        'Concat cat 2 1 doubled scaled out 0=0',
    ]
    blobs = []
    for w, b in ((w1, b1), (wfc1, bfc1), (wfc2, bfc2)):
        blobs += [np.zeros(1, np.uint32).tobytes(), w.tobytes(),
                  b.tobytes()]
    (path / 'c.param').write_text('\n'.join(lines) + '\n')
    (path / 'c.bin').write_bytes(b''.join(blobs))
    return path / 'c.param', path / 'c.bin'


def _ops_graph(path, rs):
    """The evaluator's other layers: a depthwise convolution with a
    sigmoid activation, max and average pooling, BinaryOp sub and max,
    a nearest Interp."""
    w = rs.randn(27).astype(np.float32) * 0.3
    b = rs.randn(3).astype(np.float32) * 0.01
    lines = [
        '7767517', '8 10',
        'Input input 0 1 input',
        'Split split0 1 3 input in_a in_b in_c',
        'ConvolutionDepthWise dw 1 1 in_a d 0=3 1=3 4=1 5=1 6=27 7=3 9=4',
        'Pooling mp 1 1 in_b m 0=0 1=2 2=2',
        'Pooling ap 1 1 in_c a 0=1 1=2 2=2',
        'BinaryOp sub 2 1 m a q 0=1',
        'Interp up 1 1 q u 0=1 1=2.0 2=2.0',
        'BinaryOp mx 2 1 d u out 0=4',
    ]
    (path / 'o.param').write_text('\n'.join(lines) + '\n')
    (path / 'o.bin').write_bytes(np.zeros(1, np.uint32).tobytes()
                                 + w.tobytes() + b.tobytes())
    return path / 'o.param', path / 'o.bin'


def _page(h, w, seed):
    rs = np.random.RandomState(seed)
    img = np.full((h, w, 3), 230, np.uint8)
    for _ in range(12):
        y, x = rs.randint(0, h - 8), rs.randint(0, w - 8)
        img[y:y + rs.randint(3, 8), x:x + rs.randint(3, 8)] = \
            rs.randint(0, 256, 3)
    return img


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    root = tmp_path_factory.mktemp('models')
    up_dir = root / 'upscaling'
    rel = model_relpath(W2X_FAMILY, 0, 2)
    (up_dir / rel).parent.mkdir(parents=True)
    rs = np.random.RandomState(0)
    torch.save({'params_ema': _realesrgan_state_dict(rs)},
               up_dir / 'RealESRGAN_x4plus_anime_6B.pth')
    torch.save(torch_state_dict_from_jax(_np(jax_esrgan.init_params(
        nb=NB, nf=NF, gc=GC))), up_dir / '4xESRGAN.pth')
    w2x_files = jax_upscaling_tests.TestWaifu2xNcnn()._write_model(
        up_dir / rel.split('/')[0], rs)
    w2x_files = (w2x_files[0].rename(up_dir / f'{rel}.param'),
                 w2x_files[1].rename(up_dir / f'{rel}.bin'))
    graph_dir = tmp_path_factory.mktemp('graphs')
    relu_files = jax_upscaling_tests.TestNcnnLite()._write_upconv7_with_relu(
        graph_dir, rs)
    cunet_files = _cunet_style_graph(graph_dir, rs)
    ops_files = _ops_graph(graph_dir, rs)

    mp = pytest.MonkeyPatch()
    mp.setenv('MIT_TPU_MESH', '0')
    mp.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')
    mp.setenv('MIT_TPU_WAIFU2X_MODEL', W2X_FAMILY)
    mp.setenv('MIT_TPU_WAIFU2X_NOISE', '0')

    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    mp.setattr(jax_inference.ModelWrapper, '_download_file', offline)
    mp.setattr(jax_inference, 'MODULE_DIR', root)
    mp.setattr(inference, 'MODULE_DIR', root)
    mp.setattr(jax_upscaling, '_upscaler_cache', {})
    mp.setattr(upscaling, '_upscaler_cache', {})
    try:
        out = {'files': {'upconv7': w2x_files, 'relu': relu_files,
                         'cunet': cunet_files, 'ops': ops_files}}
        # the network on one tile, the JAX package's seeded 2-block draws
        x = np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32)
        out['net'] = (x, np.asarray(jax_esrgan.esrgan_forward(
            jax_esrgan.init_params(nb=NB), jnp.asarray(x), nb=NB)))
        # the tiling: a 300x200 image, two tiles across
        arr = _page(200, 300, 2).astype(np.float32) / 255.0
        jup = jax_up_esrgan.ESRGANUpscalerPytorch()
        jup.params = jax_esrgan.init_params(nb=NB, nf=NF, gc=GC)
        jup.nb = NB
        out['tiles'] = (arr, jup._run_4x(arr))
        # the graphs
        y = np.random.RandomState(3).rand(1, 30, 26, 3).astype(np.float32)
        for name in ('relu', 'cunet', 'ops'):
            layers = jax_ncnn.load_ncnn(*out['files'][name])
            out['graph', name] = (y, np.asarray(jax_ncnn.run_graph(layers,
                                                                   y)))
        y = np.random.RandomState(4).rand(1, 24 + 14, 20 + 14, 3).astype(
            np.float32)
        out['upconv7'] = (y, np.asarray(jax_w2x.upconv7_forward(
            jax_w2x.load_ncnn_upconv7(*w2x_files), jnp.asarray(y))))
        # each registry key through dispatch, from the files written above
        img = Image.fromarray(_page(50, 60, 5))
        for key, ratio in DISPATCHES:
            got = asyncio.run(upscaling.dispatch(Upscaler(key), [img], ratio,
                                                 device='cpu'))[0]
            want = asyncio.run(jax_upscaling.dispatch(
                JUpscaler(key), [img], ratio, device='cpu'))[0]
            up = upscaling.get_upscaler(Upscaler(key))
            out['dispatch', key, ratio] = (img, got, want, up)
    finally:
        mp.undo()
    return out


def test_esrgan_network_matches_jax(refs):
    """The 2-block RRDBNet on one 32² tile within the JAX suite's oracle
    bound (tests/test_model_oracle.py:167)."""
    x, want = refs['net']
    model = esrgan.build_esrgan(esrgan.init_state_dict(nb=NB))
    got = esrgan.esrgan_forward(model, torch.from_numpy(x)).numpy()
    assert got.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)


def test_run_4x_tiles_match_jax(refs):
    """The 256-px tiles with their 8-px context: a 300x200 image is two
    tiles across, so a seam lies inside; both tiles go through one
    forward."""
    arr, want = refs['tiles']
    up = up_esrgan.ESRGANUpscalerPytorch()
    up.device = torch.device('cpu')
    up.model = esrgan.build_esrgan(torch_state_dict_from_jax(_np(
        jax_esrgan.init_params(nb=NB, nf=NF, gc=GC))))
    got = up._run_4x(arr).numpy()
    assert got.shape == (800, 1200, 3)
    assert up.forwards == [(2, 272, 272)]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize('key,ratio', DISPATCHES)
def test_dispatch_matches_jax(refs, key, ratio):
    """Each key through ``upscaling.dispatch`` from the same files: esrgan
    from a new-style Real-ESRGAN checkpoint, 4xultrasharp from an old-style
    one at ratio 3 (PIL's bilinear resize), waifu2x's upconv_7 from ncnn
    files at 2 and at 4 (two passes); the images at most one level
    apart."""
    img, got, want, up = refs['dispatch', key, ratio]
    assert got.size == want.size == (round(60 * ratio), round(50 * ratio))
    diff = np.abs(np.asarray(got, int) - np.asarray(want, int))
    assert diff.max() <= 1, diff.max()
    assert not up.using_random_weights or key == 'waifu2x'
    if key != 'waifu2x':
        assert up.model.nb == NB and up.model.model['0'].out_channels == NF


def test_upconv7_from_ncnn_matches_jax(refs):
    """upconv_7 read from synthetic ncnn files (the deconvolution kernel
    taken as torch's (in, out, kh, kw) without a flip), within
    tests/test_upscaling.py:122's bound."""
    y, want = refs['upconv7']
    model = waifu2x.build_upconv7(waifu2x.load_ncnn_upconv7(
        *refs['files']['upconv7']))
    with torch.no_grad():
        got = model(torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-4)


@pytest.mark.parametrize('name', ['relu', 'cunet', 'ops'])
def test_ncnn_graph_matches_jax(refs, name):
    """The evaluator on an upconv_7 graph with explicit ReLU layers, on a
    cunet-style graph and on the other layers it supports, within
    tests/test_upscaling.py:235's bound."""
    y, want = refs['graph', name]
    layers = ncnn_lite.load_ncnn(*refs['files'][name])
    with torch.no_grad():
        got = ncnn_lite.run_graph(layers,
                                  torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4)


@pytest.mark.parametrize('mode,scale', [(1, 2.0), (2, 2.0), (2, 0.5),
                                        (2, 1.5)])
def test_ncnn_interp_matches_jax(mode, scale):
    """Interp (1 nearest, 2 bilinear) at half-pixel centres as
    jax.image.resize, antialiased when it shrinks."""
    text = (f'7767517\n2 2\nInput input 0 1 input\n'
            f'Interp up 1 1 input out 0={mode} 1={scale} 2={scale}\n')
    x = np.random.RandomState(6).rand(1, 12, 10, 3).astype(np.float32)
    want = np.asarray(jax_ncnn.run_graph(jax_ncnn.parse_param(text), x))
    got = ncnn_lite.run_graph(ncnn_lite.parse_param(text),
                              torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4)


def test_waifu2x_cunet_graph_dispatch_matches_jax(tmp_path, monkeypatch):
    """The waifu2x key on a cunet-family graph: the 18-px context, the
    graph through the ncnn evaluator and the crop of what its convs
    leave, against the JAX package (one level)."""
    rel = model_relpath('cunet', 0, 2)
    (tmp_path / 'upscaling' / rel).parent.mkdir(parents=True)
    files = _cunet_style_graph(tmp_path, np.random.RandomState(7))
    for f, ext in zip(files, ('param', 'bin')):
        f.rename(tmp_path / 'upscaling' / f'{rel}.{ext}')
    # the graph's output has to be twice its input: a stride-2
    # deconvolution after the SE block's concat (7 channels in)
    text = (tmp_path / 'upscaling' / f'{rel}.param').read_text()
    text = text.replace('Concat cat 2 1 doubled scaled out 0=0',
                        'Concat cat 2 1 doubled scaled cat_o 0=0\n'
                        'Deconvolution up 1 1 cat_o out 0=3 1=4 3=2 4=1 '
                        '5=1 6=336')
    (tmp_path / 'upscaling' / f'{rel}.param').write_text(text)
    rs = np.random.RandomState(8)
    with open(tmp_path / 'upscaling' / f'{rel}.bin', 'ab') as f:
        f.write(np.zeros(1, np.uint32).tobytes()
                + (rs.randn(336) * 0.1).astype(np.float32).tobytes()
                + (rs.randn(3) * 0.01).astype(np.float32).tobytes())

    def offline(self, url, path):
        raise RuntimeError('offline test: no downloads')
    monkeypatch.setattr(jax_inference.ModelWrapper, '_download_file',
                        offline)
    for mod in (jax_inference, inference):
        monkeypatch.setattr(mod, 'MODULE_DIR', tmp_path)
    monkeypatch.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')
    monkeypatch.setenv('MIT_TPU_WAIFU2X_MODEL', 'cunet')
    monkeypatch.setenv('MIT_TPU_WAIFU2X_NOISE', '0')
    monkeypatch.setattr(jax_upscaling, '_upscaler_cache', {})
    monkeypatch.setattr(upscaling, '_upscaler_cache', {})
    img = Image.fromarray(_page(30, 26, 9))
    got = asyncio.run(upscaling.dispatch(Upscaler.waifu2x, [img], 2,
                                         device='cpu'))[0]
    want = asyncio.run(jax_upscaling.dispatch(JUpscaler.waifu2x, [img], 2,
                                              device='cpu'))[0]
    up = upscaling.get_upscaler(Upscaler.waifu2x)
    assert up.graph is not None and up.context == 18
    assert got.size == want.size == (52, 60)
    diff = np.abs(np.asarray(got, int) - np.asarray(want, int))
    assert diff.max() <= 1, diff.max()


def test_waifu2x_random_fallback_is_upconv7(tmp_path, monkeypatch):
    """Without ncnn files the waifu2x key serves upconv_7 on the JAX
    package's seeded draws."""
    monkeypatch.setattr(inference, 'MODULE_DIR', tmp_path)
    monkeypatch.setenv('MIT_TPU_ALLOW_RANDOM_WEIGHTS', '1')
    up = up_esrgan.Waifu2xUpscaler()
    asyncio.run(up.load('cpu'))
    assert up.graph is None and up.using_random_weights
    assert up.context == waifu2x.CONTEXT
    init = waifu2x.init_state_dict()
    for k, v in up.model.state_dict().items():
        assert torch.equal(v, init[k]), k
