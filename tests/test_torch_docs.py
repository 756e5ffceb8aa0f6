"""The port's documentation (``docs/torch/``) against the package.

* ``api.md`` lists, per module, every name of that module's ``__all__``
  and nothing else, and has a section for every module of
  ``ultranest_torch`` that has an ``__all__`` (the evaluation scripts
  under ``ultranest_torch.evaluate`` are entry points, documented in
  ``usage.md``).
* Every ``python`` block of ``usage.md`` runs on the CPU (the blocks
  pick the card when there is one and the CPU otherwise).
* Every page of ``docs/`` that shows ``ultranest_tpu`` code has a port
  counterpart, and the port's pages show no ``ultranest_tpu`` code and
  no TPU measurement.
"""
import importlib
import os
import pkgutil
import re

import pytest
from torch_port_helpers import one_thread  # noqa: F401

import ultranest_torch

_DOCS = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..',
                     'docs')
PAGES = ('usage', 'migration', 'api', 'performance', 'debugging', 'faq',
         'priors')


def _read(*parts):
    with open(os.path.join(_DOCS, *parts)) as f:
        return f.read()


def _api_sections():
    """{module name: [names listed]} from api.md's tables."""
    out, module = {}, None
    for line in _read('torch', 'api.md').splitlines():
        m = re.match(r'^## `(ultranest_torch[\w.]*)`$', line)
        if m:
            module = m.group(1)
            out[module] = []
            continue
        m = re.match(r'^\| `(\w+)` \|', line)
        if m and module is not None:
            out[module].append(m.group(1))
    return out


def _public_modules():
    mods = {'ultranest_torch': ultranest_torch}
    for info in pkgutil.walk_packages(ultranest_torch.__path__,
                                      'ultranest_torch.'):
        if '.evaluate' not in info.name:
            mods[info.name] = importlib.import_module(info.name)
    return {name: mod for name, mod in mods.items()
            if getattr(mod, '__all__', None)}


def test_api_lists_every_public_name_and_only_those():
    sections = _api_sections()
    modules = _public_modules()
    assert sorted(sections) == sorted(modules)
    for name, listed in sections.items():
        module = modules[name]
        assert len(listed) == len(set(listed)), name
        for attr in listed:
            assert hasattr(module, attr), (name, attr)
        assert sorted(listed) == sorted(module.__all__), name


def _python_blocks(page):
    return re.findall(r'```python\n(.*?)```', _read('torch', page),
                      flags=re.S)


@pytest.mark.parametrize('index', range(3))
def test_usage_blocks_run_on_the_cpu(index, tmp_path, monkeypatch):
    blocks = _python_blocks('usage.md')
    assert len(blocks) == 3
    monkeypatch.chdir(tmp_path)
    namespace = {}
    exec(compile(blocks[index], 'usage.md block %d' % index, 'exec'),
         namespace)
    assert namespace['device'] in ('cuda', 'cpu')


def test_every_page_with_reference_code_has_a_port_page():
    for page in os.listdir(_DOCS):
        if not page.endswith('.md'):
            continue
        text = _read(page)
        shows_code = re.search(r'```python\n[^`]*ultranest_tpu', text) or \
            'jax_transform=' in text
        if shows_code:
            assert os.path.exists(os.path.join(_DOCS, 'torch', page)), page
    for page in PAGES:
        text = _read('torch', page + '.md')
        for block in re.findall(r'```\w*\n(.*?)```', text, flags=re.S):
            assert 'ultranest_tpu' not in block, page
            assert 'import jax' not in block, page


def test_performance_page_states_card_numbers_only():
    text = _read('torch', 'performance.md')
    assert 'NVIDIA H100 80GB HBM3' in text and '700' in text
    for word in ('v5e', 'TPU v', 'tunnel'):
        assert word not in text, word
