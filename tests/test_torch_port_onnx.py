"""PyTorch port, the ONNX evaluator and the booru tagger: every graph of
``tests/test_onnx_eval.py`` and graphs covering the rest of the op table,
written with ``tests/onnx_build.py``, through the JAX package's
``utils/onnx_eval`` and the port's on the CPU, within rtol 1e-4 / atol
1e-5 (the JAX suite's bounds); an unsupported op raises; the tagger on a
synthetic graph and tag list gives the same tags and confidences within
1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import onnx_build as ob
from manga_image_translator_tpu.utils import onnx_eval as jax_onnx_eval
from manga_image_translator_tpu.utils import onnx_lite as jax_onnx_lite
from manga_image_translator_tpu_torch.utils import onnx_eval, onnx_lite

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _conv_bn_relu_pool(rs):
    nodes = [
        ob.node('Conv', ['x', 'w', 'b'], ['c'], strides=[2, 2],
                pads=[1, 1, 1, 1]),
        ob.node('BatchNormalization',
                ['c', 'scale', 'bias', 'mean', 'var'], ['n']),
        ob.node('Relu', ['n'], ['r']),
        ob.node('MaxPool', ['r'], ['p'], kernel_shape=[2, 2],
                strides=[2, 2]),
        ob.node('GlobalAveragePool', ['p'], ['g']),
        ob.node('Flatten', ['g'], ['y']),
    ]
    inits = {'w': rs.randn(8, 3, 3, 3).astype(np.float32) * 0.2,
             'b': rs.randn(8).astype(np.float32),
             'scale': rs.rand(8).astype(np.float32) + 0.5,
             'bias': rs.randn(8).astype(np.float32),
             'mean': rs.randn(8).astype(np.float32),
             'var': rs.rand(8).astype(np.float32) + 0.5}
    return nodes, inits, rs.randn(1, 3, 16, 16).astype(np.float32)


def _grouped_conv_avgpool(rs):
    nodes = [
        ob.node('Conv', ['x', 'w'], ['c'], pads=[1, 1, 1, 1], group=2),
        ob.node('AveragePool', ['c'], ['y'], kernel_shape=[2, 2],
                strides=[2, 2]),
    ]
    return (nodes, {'w': rs.randn(4, 2, 3, 3).astype(np.float32)},
            rs.randn(1, 4, 8, 8).astype(np.float32))


def _shape_flow(rs):
    nodes = [
        ob.node('Shape', ['x'], ['s']),
        ob.node('Gather', ['s', 'i0'], ['d0'], axis=0),
        ob.node('Unsqueeze', ['d0'], ['d0u'], axes=[0]),
        ob.node('Concat', ['d0u', 'negone'], ['tgt'], axis=0),
        ob.node('Reshape', ['x', 'tgt'], ['y']),
    ]
    return (nodes, {'i0': np.array(0, np.int64),
                    'negone': np.array([-1], np.int64)},
            rs.randn(2, 3, 4).astype(np.float32))


def _attention_block(rs):
    nodes = [
        ob.node('LayerNormalization', ['x', 'ln_s', 'ln_b'], ['n'],
                axis=-1, epsilon=1e-5),
        ob.node('MatMul', ['n', 'wq'], ['q']),
        ob.node('MatMul', ['n', 'wv'], ['v']),
        ob.node('Transpose', ['q'], ['qt'], perm=[0, 2, 1]),
        ob.node('MatMul', ['n', 'qt'], ['scores']),
        ob.node('Softmax', ['scores'], ['attn'], axis=-1),
        ob.node('MatMul', ['attn', 'v'], ['y']),
    ]
    inits = {'wq': rs.randn(8, 8).astype(np.float32),
             'wv': rs.randn(8, 8).astype(np.float32),
             'ln_s': rs.rand(8).astype(np.float32) + 0.5,
             'ln_b': rs.randn(8).astype(np.float32)}
    return nodes, inits, rs.randn(2, 5, 8).astype(np.float32)


def _slice_pad_resize_concat_split(rs):
    nodes = [
        ob.node('Slice', ['x', 'st', 'en', 'ax', 'sp'], ['sl']),
        ob.node('Pad', ['sl', 'pads'], ['pd'], mode='constant'),
        ob.node('Resize', ['pd', '', 'scales'], ['rs'], mode='nearest'),
        ob.node('Split', ['rs'], ['a', 'b'], axis=1),
        ob.node('Concat', ['b', 'a'], ['y'], axis=1),
    ]
    inits = {'st': np.array([1], np.int64), 'en': np.array([5], np.int64),
             'ax': np.array([2], np.int64), 'sp': np.array([1], np.int64),
             'pads': np.array([0, 0, 1, 0, 0, 0, 1, 0], np.int64),
             'scales': np.array([1, 1, 2, 2], np.float32)}
    return nodes, inits, rs.randn(1, 2, 6, 6).astype(np.float32)


def _gemm_gelu_sigmoid(rs):
    nodes = [
        ob.node('Gemm', ['x', 'w', 'b'], ['h'], transB=1),
        ob.node('Gelu', ['h'], ['g']),
        ob.node('Sigmoid', ['g'], ['y']),
    ]
    return (nodes, {'w': rs.randn(4, 16).astype(np.float32),
                    'b': rs.randn(4).astype(np.float32)},
            rs.randn(2, 16).astype(np.float32))


def _elementwise(rs):
    """The unary / binary / logic ops, Cast and Clip."""
    nodes = [
        ob.node('Abs', ['x'], ['ax']),
        ob.node('Add', ['ax', 'one'], ['ax1']),
        ob.node('Sqrt', ['ax1'], ['sq']),
        ob.node('Log', ['ax1'], ['lg']),
        ob.node('Pow', ['sq', 'two'], ['pw']),
        ob.node('Div', ['lg', 'pw'], ['dv']),
        ob.node('Sub', ['dv', 'x'], ['sb']),
        ob.node('Erf', ['sb'], ['ef']),
        ob.node('Tanh', ['x'], ['th']),
        ob.node('Exp', ['th'], ['ex']),
        ob.node('Neg', ['ex'], ['ng']),
        ob.node('LeakyRelu', ['x'], ['lr'], alpha=0.1),
        ob.node('HardSigmoid', ['x'], ['hs']),
        ob.node('HardSwish', ['x'], ['hw']),
        ob.node('Gelu', ['x'], ['gt'], approximate='tanh'),
        ob.node('Floor', ['x'], ['fl']),
        ob.node('Ceil', ['x'], ['ce']),
        ob.node('Greater', ['x', 'zero'], ['gz']),
        ob.node('Less', ['x', 'one'], ['l1']),
        ob.node('And', ['gz', 'l1'], ['band']),
        ob.node('Not', ['band'], ['nb']),
        ob.node('Equal', ['fl', 'zero'], ['eq']),
        ob.node('Where', ['nb', 'ef', 'ng'], ['w1']),
        ob.node('Cast', ['eq'], ['eqf'], to=1),
        ob.node('Mul', ['w1', 'eqf'], ['m1']),
        ob.node('Clip', ['hw', 'lo', 'hi'], ['cl']),
        ob.node('Identity', ['cl'], ['id']),
        ob.node('Concat', ['m1', 'lr', 'hs', 'id', 'gt', 'ce', 'w1'],
                ['y'], axis=1),
    ]
    inits = {'one': np.array(1.0, np.float32),
             'two': np.array(2.0, np.float32),
             'zero': np.array(0.0, np.float32),
             'lo': np.array(-0.2, np.float32),
             'hi': np.array(0.7, np.float32)}
    return nodes, inits, (rs.randn(3, 5) * 2).astype(np.float32)


def _reductions(rs):
    nodes = [
        ob.node('ReduceMean', ['x'], ['rm'], axes=[1], keepdims=1),
        ob.node('ReduceSum', ['x', 'axes2'], ['rs_']),
        ob.node('ReduceMax', ['x'], ['rx0'], axes=[2], keepdims=0),
        ob.node('ReduceMax', ['x'], ['all'], keepdims=0),
        ob.node('Add', ['rx0', 'all'], ['rx']),
        ob.node('ReduceMin', ['x'], ['rn'], axes=[-1], keepdims=0),
        ob.node('ReduceL2', ['x'], ['r2'], axes=[1], keepdims=0),
        ob.node('Flatten', ['rm'], ['f1']),
        ob.node('Flatten', ['rs_'], ['f2']),
        ob.node('Concat', ['f1', 'f2', 'rx', 'rn', 'r2'], ['y'], axis=1),
    ]
    return (nodes, {'axes2': np.array([2], np.int64)},
            rs.randn(2, 3, 4).astype(np.float32))


def _shape_plumbing(rs):
    """Constants, Range, ConstantOfShape, Squeeze/Unsqueeze, Expand, Tile,
    Gather (tensor, negative index), GatherElements, Transpose, Einsum,
    a negative-step Slice and Split by sizes."""
    nodes = [
        ob.node('Constant', [], ['c3'], value=np.array([3], np.int64)),
        ob.node('Range', ['r0', 'r4', 'r1'], ['rg']),
        ob.node('Cast', ['rg'], ['rgf'], to=1),
        ob.node('Unsqueeze', ['rgf', 'ax1'], ['rg_f']),
        ob.node('ConstantOfShape', ['c3'], ['cs'],
                value=np.array([0.5], np.float32)),
        ob.node('Unsqueeze', ['x', 'ax0'], ['xu']),
        ob.node('Squeeze', ['xu', 'ax0'], ['xs']),
        ob.node('Expand', ['cs', 'eshape'], ['ce']),
        ob.node('Add', ['xs', 'ce'], ['xa']),
        ob.node('Tile', ['xa', 'reps'], ['tl']),
        ob.node('Gather', ['tl', 'gidx'], ['g'], axis=1),
        ob.node('GatherElements', ['x', 'eidx'], ['ge'], axis=1),
        ob.node('Transpose', ['ge'], ['gt']),
        ob.node('Einsum', ['g', 'gt'], ['es'], equation='ij,kj->ik'),
        ob.node('Slice', ['x', 'sst', 'sen', 'sax', 'ssp'], ['rev']),
        ob.node('Split', ['rev', 'sizes'], ['s1', 's2'], axis=1),
        ob.node('Mul', ['s2', 'rg_f'], ['s2r']),
        ob.node('Concat', ['es', 's1', 's2r'], ['y'], axis=1),
    ]
    inits = {'r0': np.array(0, np.int64), 'r4': np.array(4, np.int64),
             'r1': np.array(1, np.int64),
             'ax0': np.array([0], np.int64),
             'ax1': np.array([1], np.int64),
             'eshape': np.array([4, 3], np.int64),
             'reps': np.array([1, 2], np.int64),
             'gidx': np.array([5, -1, 0, 2], np.int64),
             'eidx': np.array([[2, 0, 1], [1, 1, 0], [0, 2, 2],
                               [1, 0, 2]], np.int64),
             'sst': np.array([-1], np.int64),
             'sen': np.array([-(1 << 63)], np.int64),
             'sax': np.array([1], np.int64),
             'ssp': np.array([-1], np.int64),
             'sizes': np.array([1, 2], np.int64)}
    return nodes, inits, rs.randn(4, 3).astype(np.float32)


def _nn_ops(rs):
    """SAME-padded dilated conv, a 1-D conv, padded pools (both count
    modes), reflect / edge pads, instance norm."""
    nodes = [
        ob.node('Conv', ['x', 'w'], ['c'], auto_pad='SAME_UPPER',
                strides=[2, 2], dilations=[2, 2]),
        ob.node('InstanceNormalization', ['c', 'is', 'ib'], ['n']),
        ob.node('Pad', ['n', 'rpads'], ['pr'], mode='reflect'),
        ob.node('Pad', ['pr', 'epads'], ['pe'], mode='edge'),
        ob.node('MaxPool', ['pe'], ['mp'], kernel_shape=[3, 3],
                strides=[2, 2], pads=[1, 1, 1, 1]),
        ob.node('AveragePool', ['pe'], ['ap0'], kernel_shape=[3, 3],
                strides=[2, 2], pads=[1, 0, 1, 0]),
        ob.node('AveragePool', ['pe'], ['ap1'], kernel_shape=[3, 3],
                strides=[2, 2], pads=[1, 0, 1, 0], count_include_pad=1),
        ob.node('Flatten', ['mp'], ['f0']),
        ob.node('Flatten', ['ap0'], ['f1']),
        ob.node('Flatten', ['ap1'], ['f2']),
        ob.node('Reshape', ['x', 'shape1d'], ['x1']),
        ob.node('Conv', ['x1', 'w1'], ['c1'], pads=[2, 1]),
        ob.node('Flatten', ['c1'], ['f3']),
        ob.node('Concat', ['f0', 'f1', 'f2', 'f3'], ['y'], axis=1),
    ]
    inits = {'w': rs.randn(4, 3, 3, 3).astype(np.float32) * 0.3,
             'is': rs.rand(4).astype(np.float32) + 0.5,
             'ib': rs.randn(4).astype(np.float32),
             'rpads': np.array([0, 0, 2, 1, 0, 0, 1, 3], np.int64),
             'epads': np.array([0, 0, 1, 0, 0, 0, 2, 1], np.int64),
             'shape1d': np.array([1, 3, -1], np.int64),
             'w1': rs.randn(2, 3, 4).astype(np.float32)}
    return nodes, inits, rs.randn(1, 3, 11, 13).astype(np.float32)


def _resize_modes(rs):
    """Resize by sizes: linear down (antialiased) and up, cubic both ways."""
    nodes = [
        ob.node('Resize', ['x', '', '', 'down'], ['ld'], mode='linear'),
        ob.node('Resize', ['x', '', '', 'up'], ['lu'], mode='linear'),
        ob.node('Resize', ['x', '', '', 'down'], ['cd'], mode='cubic'),
        ob.node('Resize', ['x', '', '', 'up'], ['cu'], mode='cubic'),
        ob.node('Flatten', ['ld'], ['f0']),
        ob.node('Flatten', ['lu'], ['f1']),
        ob.node('Flatten', ['cd'], ['f2']),
        ob.node('Flatten', ['cu'], ['f3']),
        ob.node('Concat', ['f0', 'f1', 'f2', 'f3'], ['y'], axis=1),
    ]
    return (nodes, {'down': np.array([1, 2, 5, 7], np.int64),
                    'up': np.array([1, 2, 19, 23], np.int64)},
            rs.randn(1, 2, 12, 10).astype(np.float32))


GRAPHS = {
    'conv_bn_relu_pool': _conv_bn_relu_pool,
    'grouped_conv_avgpool': _grouped_conv_avgpool,
    'shape_flow': _shape_flow,
    'attention_block': _attention_block,
    'slice_pad_resize_concat_split': _slice_pad_resize_concat_split,
    'gemm_gelu_sigmoid': _gemm_gelu_sigmoid,
    'elementwise': _elementwise,
    'reductions': _reductions,
    'shape_plumbing': _shape_plumbing,
    'nn_ops': _nn_ops,
    'resize_modes': _resize_modes,
}


@pytest.mark.parametrize('name', list(GRAPHS))
def test_graph_matches_jax(name):
    nodes, inits, x = GRAPHS[name](np.random.RandomState(0))
    data = ob.model(nodes, inits, ['x'], ['y'])
    ref = np.asarray(jax_onnx_eval.make_runner(
        jax_onnx_lite.parse_model(data))(jnp.asarray(x)))
    got = onnx_eval.make_runner(onnx_lite.parse_model(data))(
        torch.from_numpy(x))
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_runner_keeps_initializers_on_the_device():
    """The runner uploads each initializer once and reuses it."""
    nodes, inits, x = _gemm_gelu_sigmoid(np.random.RandomState(1))
    g = onnx_lite.parse_model(ob.model(nodes, inits, ['x'], ['y']))
    run = onnx_eval.make_runner(g)
    a = run(torch.from_numpy(x))
    b = run(torch.from_numpy(x))
    assert torch.equal(a, b)
    ev = onnx_eval._Evaluator(g, 'cpu')
    ev.run({'x': torch.from_numpy(x)})
    first = dict(ev._uploaded)
    ev.run({'x': torch.from_numpy(x)})
    assert set(first) == {id(v) for v in g.initializers.values()}
    assert all(ev._uploaded[k] is v for k, v in first.items())


def test_unsupported_op_raises():
    g = onnx_lite.parse_model(ob.model(
        [ob.node('NonMaxSuppression', ['x'], ['y'])], {}, ['x'], ['y']))
    with pytest.raises(NotImplementedError, match='NonMaxSuppression'):
        onnx_eval.evaluate(g, {'x': torch.zeros(1)})


def write_tagger(tmp_path, rs, size=32, n_tags=9):
    """A tiny classifier in the tagger's layout: NHWC input, conv, pool,
    dense head, sigmoid; the csv's first 4 rows are ratings."""
    w = rs.randn(4, 3, 3, 3).astype(np.float32) * 0.1
    wf = rs.randn(n_tags, 4).astype(np.float32)
    bf = rs.randn(n_tags).astype(np.float32)
    nodes = [
        ob.node('Transpose', ['x'], ['xc'], perm=[0, 3, 1, 2]),
        ob.node('Conv', ['xc', 'w'], ['c'], pads=[1, 1, 1, 1]),
        ob.node('GlobalAveragePool', ['c'], ['g']),
        ob.node('Flatten', ['g'], ['f']),
        ob.node('Gemm', ['f', 'wf', 'bf'], ['h'], transB=1),
        ob.node('Sigmoid', ['h'], ['y']),
    ]
    (tmp_path / 'model.onnx').write_bytes(
        ob.model(nodes, {'w': w, 'wf': wf, 'bf': bf}, ['x'], ['y']))
    names = ['general', 'sensitive', 'questionable', 'explicit',
             'sky', 'smile', '1girl', 'long_hair', 'catgirl']
    (tmp_path / 'selected_tags.csv').write_text(
        'tag_id,name,category,count\n'
        + '\n'.join(f'{i},{n},0,10' for i, n in enumerate(names)))
    return tmp_path / 'model.onnx', tmp_path / 'selected_tags.csv'


@pytest.mark.parametrize('shape', [(40, 24), (20, 28)])
def test_booru_tagger_matches_jax(tmp_path, shape):
    """The tagger end to end on a page larger (INTER_AREA) and smaller
    (INTER_CUBIC) than its input: equal tags, confidences within 1e-5."""
    from manga_image_translator_tpu.inpainting import booru_tagger as jbt
    from manga_image_translator_tpu_torch.inpainting import booru_tagger
    rs = np.random.RandomState(6)
    onnx_path, csv_path = write_tagger(tmp_path, rs)
    img = rs.randint(0, 255, shape + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(
        booru_tagger.smart_resize(booru_tagger.make_square(img, 32), 32),
        jbt.smart_resize(jbt.make_square(img, 32), 32))
    ref = jbt.Tagger(onnx_path, csv_path, input_size=32).label_cv2_bgr(
        img, threshold=0.3)
    tagger = booru_tagger.Tagger(onnx_path, csv_path, input_size=32)
    got = tagger.label_cv2_bgr(img, threshold=0.3)
    assert ref and set(got) == set(ref)
    for k in got:
        assert abs(got[k] - ref[k]) < 1e-5
    assert not set(got) & {'general', 'sensitive', 'questionable',
                           'explicit'}


def test_sd_prompt_tags_from_the_tagger(tmp_path):
    """The SD inpainter's prompt tags: the tagger's names, '_' -> ' '."""
    from manga_image_translator_tpu_torch.inpainting import (booru_tagger,
                                                             inpainting_sd)
    onnx_path, csv_path = write_tagger(tmp_path, np.random.RandomState(6))
    inp = inpainting_sd.StableDiffusionInpainter()
    assert inp._tags(np.zeros((8, 8, 3), np.uint8)) == ''
    inp.tagger = booru_tagger.Tagger(onnx_path, csv_path, input_size=32)
    img = np.random.RandomState(7).randint(0, 255, (40, 24, 3)) \
        .astype(np.uint8)
    want = inp.tagger.label_cv2_bgr(img[:, :, ::-1].copy())
    tags = inp._tags(img)
    assert tags == ','.join(t.replace('_', ' ') for t in want)
