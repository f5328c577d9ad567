"""What names a run's work, read without the card or torch: the cell of
``BENCHMARK.json``, its configuration and traffic files, and the directory
of its weights, so that ``run.py`` can tell before the timed process
starts whether the weights still have to be written."""
from __future__ import annotations

import hashlib
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'benchmark')
READY = '.complete'          # written once every network's files are there


def load_json(path):
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def load_cell(name: str):
    bench = load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    cell = next((w for w in bench['workloads'] if w['name'] == name), None)
    if cell is None:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
    cfg = next(c for c in bench['configs'] if c['name'] == cell['config'])
    config = load_json(os.path.join(ROOT, cfg['file']))
    traffic = load_json(os.path.join(HERE, 'traffic',
                                     f"{cell['traffic']}.json"))
    return bench, cell, config, traffic


def model_dir(config: dict, work: str = WORK) -> str:
    key = json.dumps({'networks': config['networks'],
                      'seed': config['weight_seed']}, sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:12]
    return os.path.join(work, 'models', f"{config['name']}-{digest}")


def weights_ready(config: dict, work: str = WORK) -> bool:
    return os.path.exists(os.path.join(model_dir(config, work), READY))
