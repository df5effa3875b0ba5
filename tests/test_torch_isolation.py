"""The port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points run on the card unless told otherwise.

* an AST walk over `solvingpapers_tpu_torch/` and `chip_smoke.py` finds
  no `jax`, `flax`, `optax` or `solvingpapers_tpu` import;
* a fresh interpreter that imports the port's engine has no `jax` in
  `sys.modules`;
* with no device named and no CUDA available, `Llama`, `generate` and
  `ServeEngine` raise instead of running quietly on the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from solvingpapers_tpu_torch import resolve_device
from solvingpapers_tpu_torch.infer import generate
from solvingpapers_tpu_torch.models import Llama, LlamaConfig
from solvingpapers_tpu_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "solvingpapers_tpu"}
TINY = LlamaConfig(vocab_size=64, max_seq_len=32, dim=32, n_layers=1,
                   n_heads=2, n_kv_heads=1)


def _port_files():
    files = sorted((ROOT / "solvingpapers_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_sources_exist():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_engine_import_loads_no_jax():
    code = ("import sys; import solvingpapers_tpu_torch.serve.engine, "
            "solvingpapers_tpu_torch.convert, solvingpapers_tpu_torch.configs; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'solvingpapers_tpu')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Llama(TINY)
    model = Llama(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, torch.zeros(1, 4, dtype=torch.long), max_new_tokens=2)


def test_entry_points_refuse_a_model_on_another_device():
    model = Llama(TINY, device="cpu")
    with pytest.raises(ValueError, match="model lives on"):
        ServeEngine(model, device="meta")
    with pytest.raises(ValueError, match="model lives on"):
        generate(model, torch.zeros(1, 4, dtype=torch.long), device="meta")


def test_explicit_cpu_is_honoured():
    assert resolve_device("cpu") == torch.device("cpu")
    assert Llama(TINY, device="cpu").device == torch.device("cpu")
