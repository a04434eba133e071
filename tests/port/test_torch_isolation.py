"""The port stands alone: no module of apex_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package — neither at import time
(checked in a fresh interpreter) nor anywhere in the source (an AST
scan) — and its entry points refuse to fall back to the CPU when CUDA is
absent. The module-name check matches ``apex_tpu`` and ``apex_tpu.*``,
never the bare prefix, which ``apex_tpu_torch`` itself shares."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT = os.path.join(REPO, "apex_tpu_torch")


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "apex_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_forbidden_name_rule():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("apex_tpu") and _forbidden("apex_tpu.serving.model")
    assert not _forbidden("apex_tpu_torch")
    assert not _forbidden("apex_tpu_torch.serving")


def test_importing_the_port_loads_no_jax_and_no_apex_tpu():
    """Import every port module and chip_smoke (not run) in a fresh
    interpreter, then list any jax*/apex_tpu(.*) module it loaded."""
    mods = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'apex_tpu'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "apex_tpu_torch.serving.engine" in mods and "chip_smoke" in mods


def test_no_source_imports_jax_or_apex_tpu():
    hits = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            hits += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                     for n in names if _forbidden(n)]
    assert not hits, hits


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from apex_tpu_torch import default_device
    from apex_tpu_torch.serving import ServingEngine, init_gpt_params
    from apex_tpu_torch.transformer.testing import TransformerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(hidden_size=64, num_layers=1,
                            num_attention_heads=1, vocab_size=16,
                            max_position_embeddings=16, hidden_dropout=0.0,
                            attention_dropout=0.0,
                            apply_query_key_layer_scaling=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_gpt_params(cfg)
    assert default_device("cpu") == torch.device("cpu")
    ServingEngine(cfg, device="cpu")   # the CPU only when asked


def test_chip_smoke_refuses_to_run_without_cuda(monkeypatch):
    """chip_smoke exits non-zero, before any result line, without a card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        mod.main()
    assert exc.value.code not in (0, None)
