"""The plain references against manga_image_translator_tpu_torch on the
CPU at small sizes, on the weights the benchmark draws: the same
checkpoints load into both, and both compute the same numbers (the
program's CPU routes are its kernels' plain versions, in float32)."""
import torch

from benchmark import nets
from benchmark.nets import lama as lama_net, ocr48 as ocr48_net
from benchmark.nets import sugoi as sugoi_net
from benchmark.reference import ct2, dbnet, esrgan, lama, ocr32, ocr48


def drawn(template, gains=None, transposed=(), seed=3):
    return nets.draw_state_dict(template, nets.conv_rule(
        template, gains or {}, transposed), seed, 'cpu')


def rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


def test_dbnet_network_and_prefilter():
    from manga_image_translator_tpu_torch.models import dbnet as prog
    from manga_image_translator_tpu_torch.ops import bilateral
    from benchmark.nets import dbnet as net
    sd = drawn(net.template(), transposed=net.TRANSPOSED)
    x = torch.rand((1, 256, 256, 3)) * 2 - 1
    db_p, mask_p = prog.dbnet_forward(prog.build_dbnet('cpu', sd), x)
    db_r, mask_r = dbnet.logits(dbnet.build(sd, 'cpu'), x)
    assert rel(db_p, db_r) < 1e-5 and rel(mask_p, mask_r) < 1e-5
    img = torch.randint(0, 256, (40, 56, 3), dtype=torch.uint8)
    gap = (bilateral.bilateral_filter_ref(img).float()
           - dbnet.bilateral(img)).abs()
    assert gap.max() <= 1 and gap.mean() < 0.01


def test_ocr48_memory_and_served_logprob():
    from manga_image_translator_tpu_torch.models import ocr48 as prog
    vocab = 120
    sd = drawn(ocr48_net.template(vocab))
    model = prog.build_ocr48(vocab, 'cpu', sd)
    images = torch.rand((3, 48, 64, 3)) * 2 - 1
    widths = torch.tensor([64, 40, 24])
    mem_p, mask_p = prog.compute_memory(model, images, widths, False)
    ref = ocr48.build(sd, vocab, 'cpu')
    mem_r, mask_r = ocr48.memory(ref, images, widths)
    assert torch.equal(mask_p, mask_r)
    assert rel(mem_p * ~mask_p[..., None], mem_r * ~mask_r[..., None]) < 1e-5
    state = prog.run_beam(model, mem_p, mask_p, 5, 7, 2)
    for i in range(3):
        toks = ocr48_net.served(state['best_seq'][i, 1:].numpy())
        lp = ocr48.sequence_logprobs(ref, mem_r[i:i + 1], mask_r[i:i + 1],
                                     torch.tensor([[1] + toks[:-1]]))
        total = lp[0, torch.arange(len(toks)), torch.tensor(toks)].sum()
        assert abs(float(total) - float(state['best_logprob'][i])) < 1e-3


def test_ocr32_memory_and_served_logprob():
    from manga_image_translator_tpu_torch.models import ocr32 as prog
    vocab = 90
    with torch.device('meta'):
        tpl = ocr32.OCR32(vocab).state_dict()
    sd = drawn(tpl)
    model = prog.build_ocr32(vocab, 'cpu', sd)
    images = torch.rand((2, 32, 64, 3)) * 2 - 1
    widths = torch.tensor([64, 33])
    mem_p, mask_p = prog.compute_memory(model, images, widths)
    ref = ocr32.build(sd, vocab, 'cpu')
    mem_r, mask_r = ocr32.memory(ref, images, widths)
    assert rel(mem_p, mem_r) < 1e-5
    state = prog.run_beam(model, mem_p, mask_p, 5, 6, 2)
    for i in range(2):
        toks = ocr48_net.served(state['best_seq'][i, 1:].numpy())
        lp = ocr32.sequence_logprobs(ref, mem_r[i:i + 1], mask_r[i:i + 1],
                                     torch.tensor([[1] + toks[:-1]]))
        total = lp[0, torch.arange(len(toks)), torch.tensor(toks)].sum()
        assert abs(float(total) - float(state['best_logprob'][i])) < 1e-3


def test_lama_composite():
    from manga_image_translator_tpu_torch.inpainting import inpainting_lama
    from manga_image_translator_tpu_torch.models import lama as prog
    n_blocks = 18
    sd = drawn(lama_net.template(n_blocks), {'conv2\\.ffc': 0.2},
               lama_net.transposed(n_blocks))
    model = prog.fold_bn(prog.build_lama(n_blocks, sd))
    img = torch.rand((1, 32, 48, 3))
    mask = torch.zeros((1, 32, 48, 1))
    mask[:, 8:24, 10:30] = 1
    with torch.no_grad():
        out_p = inpainting_lama._lama_body(model, img, mask, torch.float32)
    out_r = lama.composite(lama.build(sd, n_blocks, 'cpu'), img, mask)
    assert float((out_p - out_r).abs().max()) < 1e-4


def test_esrgan():
    from manga_image_translator_tpu_torch.models import esrgan as prog
    from manga_image_translator_tpu_torch.upscaling.esrgan import \
        convert_realesrgan_state_dict
    with torch.device('meta'):
        tpl = esrgan.RRDBNet(2).state_dict()
    sd = drawn(tpl, {'.': 0.3})
    new = {esrgan.new_style_key(k, 2): v for k, v in sd.items()}
    model = prog.build_esrgan(convert_realesrgan_state_dict(
        {'params_ema': new}))
    x = torch.rand((1, 12, 16, 3))
    assert rel(prog.esrgan_forward(model, x),
               esrgan.forward(esrgan.build(sd, 2, 'cpu'), x)) < 1e-5


def test_sugoi_encoder_and_served_score(tmp_path):
    from manga_image_translator_tpu_torch.translators import ct2_model
    spec = {'d_model': 32, 'heads': 2, 'ffn': 64, 'layers': 2,
            'vocab': 200, 'source_alphabet': 60, 'eos_bias': 0.5}
    sugoi_net.write(str(tmp_path), spec, 5, 'cpu')
    path = str(tmp_path / sugoi_net.MODEL)
    variables = ct2_model.read_ct2_model(path)
    src, tgt = sugoi_net.vocabularies(spec)
    prog = ct2_model.Ct2Transformer(variables, {'num_heads': 2}, src, tgt,
                                    device='cpu')
    ref = ct2.Model(ct2.read_model(path), 2, 'cpu')
    tokens, lengths, prefix, plen = prog.prepare(
        [src[4:11], src[20:24]])
    tk, ln = torch.from_numpy(tokens), torch.from_numpy(lengths)
    st_p, pad_p = prog.encode(tk, ln)
    st_r, pad_r = ref.encode(tk, ln)
    valid = (~pad_r)[..., None]
    assert rel(st_p * valid, st_r * valid) < 1e-5
    search = ct2_model.BeamSearch(prog, tokens, lengths, prefix, plen,
                                  max_len=12)
    out = search.run()
    norm = search.scores / search.out_len.clamp(min=1).float()
    best = norm.argmax(dim=1)
    for b in range(2):
        row = out[b].tolist()
        served = row[:row.index(prog.eos_id) + 1] if prog.eos_id in row \
            else row
        lp = ref.served_logprobs(st_r[b:b + 1], pad_r[b:b + 1], served,
                                 prog.start_id, prog.unk_id, 3.0)
        assert abs(float(lp.sum()) - float(search.scores[b, best[b]])) < 1e-3
