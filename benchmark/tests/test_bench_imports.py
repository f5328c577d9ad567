"""Nothing under benchmark/ imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's),
and the plain references import nothing of the program."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'manga_image_translator_tpu'}
PROGRAM = 'manga_image_translator_tpu_torch'


def sources(sub=''):
    root = os.path.join(HERE, sub)
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith('.py'):
                yield os.path.join(d, n)


def top_level_imports(path):
    tree = ast.parse(open(path, encoding='utf-8').read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize('path', sorted(sources('reference')),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(top_level_imports(path))


def test_top_level_names_compared_whole():
    from benchmark import harness
    loaded = ['manga_image_translator_tpu_torch.ocr', 'jax_like', 'flaxen',
              'jaxlib.xla_client', 'manga_image_translator_tpu.ops']
    assert harness.forbidden_modules(loaded) == [
        'jaxlib', 'manga_image_translator_tpu']
