"""A cell small enough for the CPU: the default configuration with the
detection size and Sugoi's widths cut and the dialogue mix on 448x640
pages, for the tests that drive a whole run without the card."""
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cell():
    with open(os.path.join(HERE, 'configs', 'default.json')) as f:
        config = json.load(f)
    config['name'] = 'tiny'
    config['pipeline']['detector']['detection_size'] = 640
    config['networks']['dbnet']['detection_size'] = 640
    config['networks']['sugoi'].update(d_model=64, heads=2, ffn=128,
                                       layers=2, vocab=16000, eos_bias=0.0)
    with open(os.path.join(HERE, 'traffic', 'text_heavy.json')) as f:
        traffic = json.load(f)
    traffic.update(page=[448, 640], chapter_pages=2, warmup_pages=1,
                   sample_pages=1, bubbles=[1, 2], bubble_grid=[2, 2],
                   lines_per_page=[3, 5], chars_per_line=[2, 6],
                   margin_px=10)
    return config, traffic
