"""The work counts against hand counts at small shapes."""
import math

import pytest
import torch

from benchmark import work
from benchmark.work import kernels, ocr48 as ocr48_work, sugoi as sugoi_work


def test_counted_flops_of_a_conv():
    def build():
        conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        return lambda x: conv(x)
    assert work.counted_flops(build, (2, 3, 10, 12)) == \
        2 * 2 * 10 * 12 * 8 * 3 * 9


def test_least_seconds_takes_the_longer_bound():
    assert work.least_seconds(3.35e12, 1.0, 'bf16') == pytest.approx(1.0)
    assert work.least_seconds(1.0, 989e12, 'bf16') == pytest.approx(1.0)


def test_bilateral_counts():
    # radius 1: the centre and 4 taps (4 off-centre), 2 symmetric pairs
    nbytes, ops, peak = kernels.bilateral(((2, 5, 7, 3), 1))
    assert nbytes == 2 * 2 * 5 * 7 * 3
    assert ops == 2 * 5 * 7 * (4 * 7 + 2 * 6 + 12)
    assert peak == 'f32'
    # radius 8 is the 1,972 operations a pixel of the kernel table
    assert kernels.bilateral(((1, 1, 1, 3), 8))[1] == 1972


def test_conv_stream_counts():
    nbytes, ops, peak = kernels.conv_stream(((1, 10, 12, 4), (7, 7, 4, 64),
                                             2, 2))
    assert ops == 2 * 4 * 6 * 49 * 4 * 64
    assert nbytes == 10 * 12 * 4 * 2 + 4 * 6 * 64 * 2 + 49 * 4 * 64 * 4 \
        + 64 * 4
    assert peak == 'bf16'


def test_fourier_unit_counts():
    nbytes, ops, peak = kernels.fourier_unit(((1, 4, 8, 2), 4))
    k = 8 // 2 + 1
    assert ops == 2 * 16 * 4 * k + 2 * 2.5 * 32 * math.log2(32) * 2
    assert peak == 'f32x3'


def test_trace_names():
    assert kernels.in_trace('conv_stream', 'void conv_stream_tc<2>(...)')
    assert not kernels.in_trace('conv_stream', 'void pack_weights<64, 1>()')
    assert kernels.in_trace('decode_step', 'decode_step_persistent(Params)')


def test_ocr48_decoder_step_flops_match_the_reference():
    """One step for one row, counted by hand, against the flop counter on
    the reference's teacher-forced decoder at one position."""
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.reference import ocr48
    vocab, m = 50, 6
    with torch.device('meta'):
        model = ocr48.OCR48(vocab).eval()
        mem = torch.empty((1, m, 320))
        mask = torch.zeros((1, m), dtype=torch.bool)
        tok = torch.zeros((1, 1), dtype=torch.long)
        with FlopCounterMode(display=False) as fc:
            ocr48.sequence_logprobs(model, mem, mask, tok)
    # the one-key self-attention's query-key product is an elementwise
    # product to einsum, which the counter does not see: 2 x 320 a layer
    assert ocr48_work.decoder_flops(1, 1, m, 1, m, vocab) == \
        fc.get_total_flops() + 5 * 2 * 320


def test_sugoi_flops_match_the_reference(tmp_path):
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.nets import sugoi as net
    from benchmark.reference import ct2
    spec = {'d_model': 32, 'heads': 2, 'ffn': 64, 'layers': 2, 'vocab': 200,
            'source_alphabet': 60, 'eos_bias': 0.0}
    net.write(str(tmp_path), spec, 1, 'cpu')
    model = ct2.Model(ct2.read_model(str(tmp_path / net.MODEL)), 2, 'cpu')
    tokens = torch.ones((3, 7), dtype=torch.long)
    with FlopCounterMode(display=False) as fc:
        states, pad = model.encode(tokens, torch.full((3,), 7))
    assert sugoi_work.encoder_flops(3, 7, 32, 64, 2) == fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        model.served_logprobs(states[:1], pad[:1], [5], 1, 0, 3.0)
    # one step for one row: its products, the attention over one position
    # and the source, the projection, and the source's keys and values
    assert sugoi_work.decoder_flops(1, 1, 7, 1, 32, 64, 2, 200) == \
        fc.get_total_flops()


def test_esrgan_flops_match_the_smokes_hand_count():
    """chip_smoke.esrgan_tile_macs: per input pixel the first conv, nb
    RRDBs of three dense blocks and the trunk conv; the upsampling convs
    at 4x and 16x the pixels, the HR and last convs at 16x."""
    from benchmark.work import esrgan
    rdb = 9 * (64 + 96 + 128 + 160) * 32 + 9 * 192 * 64
    per_px = (9 * 3 * 64 + 6 * 3 * rdb + 9 * 64 * 64 * (1 + 4 + 16 + 16)
              + 16 * 9 * 64 * 3)
    got = esrgan.flops({'esrgan': [(2, 40, 24, 3)]}, {'blocks': 6})
    assert got == [(2 * 2 * per_px * 40 * 24, 'tf32')]
