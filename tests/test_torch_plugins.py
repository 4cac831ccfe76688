"""``plugin_modules``: the port's registry imports the user's plugin
modules that the config lists (``NNS_TPU_PLUGINS``, the JAX package's
variable, or ``[common] plugin_modules`` in the ini file), as the JAX
package's registry does (``nnstreamer_tpu/core/registry.py:130``): an
absent module is skipped, one that exists and fails to import raises.
Each test writes its module under ``tmp_path``, puts that on
``sys.path`` and makes the registry load afresh."""

import sys

import numpy as np
import pytest

import nnstreamer_tpu_torch as ntt
from nnstreamer_tpu.core import config as jconfig
from nnstreamer_tpu_torch.core import config, registry

PLUGIN = '''
from nnstreamer_tpu_torch.core.registry import register_element
from nnstreamer_tpu_torch.elements.base import Element, SRC


@register_element("{name}")
class Doubler(Element):
    kind = "{name}"

    def process(self, pad, buf):
        return [(SRC, buf.with_tensors([t * 2 for t in buf.tensors]))]
'''


@pytest.fixture
def fresh_registry(monkeypatch, tmp_path):
    """The registry loads afresh, with ``tmp_path`` on ``sys.path``; the
    config and the registry's state come back after the test."""
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(registry, "_builtins_loaded", False)
    saved = dict(registry._registry)
    yield tmp_path
    config.reset_config()
    registry._registry.clear()
    registry._registry.update(saved)


def _use(modules):
    config.set_config(config.Config(plugin_modules=list(modules)))


def test_plugin_module_registers_an_element(fresh_registry):
    name = f"plugin_doubler_{id(fresh_registry) & 0xffff:x}"
    (fresh_registry / "nns_plugin_ok.py").write_text(PLUGIN.format(name=name))
    _use(["nns_plugin_ok"])
    cls = registry.lookup(registry.KIND_ELEMENT, name)
    assert cls is not None and cls.kind == name
    assert registry.lookup(registry.KIND_ELEMENT, "tensor_sink") is not None
    p = ntt.Pipeline(f"appsrc name=src ! {name} ! tensor_sink name=out")
    with p:
        p.push("src", np.arange(4, dtype=np.float32))
        out = np.asarray(p.pull("out", timeout=30).tensors[0])
        p.eos("src")
        p.wait(timeout=30)
    np.testing.assert_array_equal(out, [0, 2, 4, 6])


def test_absent_plugin_module_is_skipped(fresh_registry):
    _use(["nns_plugin_not_installed_anywhere"])
    assert registry.lookup(registry.KIND_ELEMENT, "tensor_sink") is not None


def test_broken_plugin_module_raises(fresh_registry):
    (fresh_registry / "nns_plugin_broken.py").write_text(
        "import nns_dependency_that_is_missing\n")
    _use(["nns_plugin_broken"])
    with pytest.raises(ImportError, match="nns_dependency_that_is_missing"):
        registry.lookup(registry.KIND_ELEMENT, "tensor_sink")
    sys.modules.pop("nns_plugin_broken", None)


def test_plugin_module_that_fails_raises(fresh_registry):
    (fresh_registry / "nns_plugin_fails.py").write_text("raise RuntimeError('bad plugin')\n")
    _use(["nns_plugin_fails"])
    with pytest.raises(RuntimeError, match="bad plugin"):
        registry.names(registry.KIND_ELEMENT)
    sys.modules.pop("nns_plugin_fails", None)


@pytest.mark.parametrize("value,want", [
    ("pkg.a:pkg.b", ["pkg.a", "pkg.b"]),
    ("pkg.a, pkg.b ,", ["pkg.a", "pkg.b"]),
    ("single", ["single"]),
])
def test_env_and_ini_read_as_the_jax_package(monkeypatch, tmp_path, value, want):
    monkeypatch.setenv("NNS_TPU_PLUGINS", value)
    monkeypatch.delenv("NNS_TPU_CONF", raising=False)
    assert config.Config.load().plugin_modules == jconfig.Config.load().plugin_modules == want
    monkeypatch.delenv("NNS_TPU_PLUGINS")
    ini = tmp_path / "nns.ini"
    ini.write_text(f"[common]\nplugin_modules = {value}\n")
    monkeypatch.setenv("NNS_TPU_CONF", str(ini))
    assert config.Config.load().plugin_modules == jconfig.Config.load().plugin_modules == want
