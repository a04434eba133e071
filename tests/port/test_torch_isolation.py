"""The port stands alone: no module of apex_tpu_torch (``contrib/`` and
``fp16_utils/`` included), not chip_smoke.py and not the tests' rank
workers (tests/port/tp_workers.py, ddp_workers.py and zero_workers.py,
which spawned ranks import by name), imports JAX or the JAX package —
neither at import time
(checked in a fresh interpreter) nor anywhere in the source (an AST
scan) — and its entry points refuse to fall back to the CPU when CUDA is
absent. The module-name check matches ``apex_tpu`` and ``apex_tpu.*``,
never the bare prefix, which ``apex_tpu_torch`` itself shares."""

import ast
import dataclasses
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
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tests", "port", "tp_workers.py"),
           os.path.join(REPO, "tests", "port", "ddp_workers.py"),
           os.path.join(REPO, "tests", "port", "zero_workers.py")]
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
    assert "apex_tpu_torch.train_step" in mods
    assert "apex_tpu_torch.utils" in mods
    for mod in ("apex_tpu_torch.serving.kv_tier", "apex_tpu_torch.ops.softmax",
                "apex_tpu_torch.ops.softmax_cuda",
                "apex_tpu_torch.transformer.enums",
                "apex_tpu_torch.transformer.functional.fused_softmax",
                "apex_tpu_torch.transformer.parallel_state",
                "apex_tpu_torch.transformer.utils",
                "apex_tpu_torch.transformer.tensor_parallel.mappings",
                "apex_tpu_torch.transformer.amp",
                "apex_tpu_torch.transformer.amp.grad_scaler",
                "apex_tpu_torch.transformer.testing.arguments",
                "apex_tpu_torch.transformer.testing.standalone_transformer_lm",
                "apex_tpu_torch.transformer.testing",
                "apex_tpu_torch.serving.weights",
                "apex_tpu_torch.multi_tensor_apply.multi_tensor_apply",
                "apex_tpu_torch.ops.multi_tensor_cuda",
                "apex_tpu_torch.optimizers.fused_mixed_precision_lamb",
                "apex_tpu_torch.amp.frontend", "apex_tpu_torch.amp.policy",
                "apex_tpu_torch.amp.amp_optimizer",
                "apex_tpu_torch.amp.handle", "apex_tpu_torch.amp._amp_state",
                "apex_tpu_torch.parallel.sync_batchnorm",
                "apex_tpu_torch.parallel.distributed",
                "apex_tpu_torch.parallel.multiproc",
                "apex_tpu_torch.models.resnet",
                "apex_tpu_torch.examples.imagenet",
                "apex_tpu_torch.ops.batch_norm",
                "apex_tpu_torch.ops.batch_norm_cuda",
                "apex_tpu_torch.parallel.collectives",
                "apex_tpu_torch.parallel.LARC",
                "apex_tpu_torch.ops.collectives",
                "apex_tpu_torch.ops.collectives_cuda",
                "apex_tpu_torch.ops.zero",
                "apex_tpu_torch.contrib",
                "apex_tpu_torch.contrib.optimizers",
                "apex_tpu_torch.contrib.optimizers.distributed_fused_adam",
                "apex_tpu_torch.contrib.optimizers.distributed_fused_lamb",
                "apex_tpu_torch.fp16_utils",
                "apex_tpu_torch.fp16_utils.fp16util",
                "apex_tpu_torch.fp16_utils.loss_scaler",
                "apex_tpu_torch.fp16_utils.fp16_optimizer",
                "apex_tpu_torch.serving.quant",
                "apex_tpu_torch.ops.qmatmul",
                "apex_tpu_torch.ops.qmatmul_cuda",
                "apex_tpu_torch.models.dcgan",
                "apex_tpu_torch.examples.dcgan",
                "apex_tpu_torch.data",
                "apex_tpu_torch.data.imagefolder",
                "tests.port.tp_workers", "tests.port.ddp_workers",
                "tests.port.zero_workers"):
        assert mod in mods, mod


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
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.normalization import FusedLayerNorm
    from apex_tpu_torch.serving import ServingEngine, init_gpt_params
    from apex_tpu_torch.transformer.testing import (GPTModel,
                                                    TransformerConfig)

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
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTModel(dataclasses.replace(cfg, fused_lm_head=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedLayerNorm(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        LossScaler().init()
    assert default_device("cpu") == torch.device("cpu")
    ServingEngine(cfg, device="cpu")   # the CPU only when asked
    model = GPTModel(cfg, device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    assert model(ids, torch.arange(4)[None], None, ids).shape == (1, 4)
    assert FusedLayerNorm(64, device="cpu")(torch.ones(2, 64)).shape == (2, 64)


def test_dropout_training_defaults_to_cuda_and_runs_on_the_cpu_if_asked(
        monkeypatch):
    """A model that trains with dropout and recompute is built on ``cuda``
    unless ``device="cpu"`` is asked for; its dropout generator lives on
    the model's device, and the step with it runs there."""
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.train_step import make_one_step
    from apex_tpu_torch.transformer.testing import (GPTModel,
                                                    TransformerConfig)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(hidden_size=64, num_layers=1,
                            num_attention_heads=2, vocab_size=16,
                            max_position_embeddings=16,
                            recompute_granularity="full")
    assert cfg.hidden_dropout == cfg.attention_dropout == 0.1
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LossScaler().init()
    model = GPTModel(cfg, device="cpu")
    opt = fused_adam(1e-3)
    step = make_one_step(model, LossScaler(), opt,
                         dropout_generator=torch.Generator().manual_seed(0))
    ids = torch.zeros(2, 8, dtype=torch.long)
    pos = torch.arange(8)[None].expand(2, 8)
    state, ss, loss = step(opt.init(dict(model.named_parameters())),
                           LossScaler().init("cpu"), ids, pos, ids)
    assert loss.device.type == "cpu" and torch.isfinite(loss).item()


def test_int8_serving_and_scores_path_default_to_cuda(monkeypatch):
    """``ServingEngine(kv_quant=True)`` and the scores-path model are built
    on ``cuda`` unless ``device="cpu"`` is asked for, and run there."""
    from apex_tpu_torch.serving import Request, ServingEngine
    from apex_tpu_torch.transformer.testing import (GPTModel,
                                                    TransformerConfig)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(hidden_size=64, num_layers=1,
                            num_attention_heads=2, vocab_size=16,
                            max_position_embeddings=32,
                            fused_attention_dropout=False)
    serve = dataclasses.replace(cfg, hidden_dropout=0.0,
                                attention_dropout=0.0,
                                apply_query_key_layer_scaling=False)
    kw = dict(num_slots=2, page_size=8, num_pages=8, prefill_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(serve, kv_quant=True, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTModel(cfg)
    engine = ServingEngine(serve, device="cpu", kv_quant=True, **kw)
    assert engine.cache["k"].device.type == "cpu"
    done = engine.run_trace([Request(rid=0, prompt=[1, 2, 3],
                                     max_new_tokens=3)])
    assert len(done[0].out_tokens) == 3
    model = GPTModel(cfg, device="cpu")
    ids = torch.zeros(2, 8, dtype=torch.long)
    loss = model(ids, torch.arange(8)[None].expand(2, 8), None, ids,
                 deterministic=False,
                 dropout_generator=torch.Generator().manual_seed(0))
    assert loss.device.type == "cpu" and torch.isfinite(loss).all()


def test_bert_and_the_language_model_default_to_cuda(monkeypatch):
    """``BertModel``, ``bert_model_provider`` and ``get_language_model``
    are built on ``cuda`` unless ``device="cpu"`` is asked for, and a BERT
    step runs there."""
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.train_step import make_one_step
    from apex_tpu_torch.transformer.testing import (BertModel,
                                                    TransformerConfig,
                                                    bert_model_provider,
                                                    get_language_model)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(hidden_size=64, num_layers=1,
                            num_attention_heads=2, vocab_size=16,
                            max_position_embeddings=16)
    for build in (lambda: BertModel(cfg), lambda: bert_model_provider(cfg),
                  lambda: get_language_model(cfg, add_pooler=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    model = BertModel(cfg, device="cpu")
    opt = fused_lamb(1e-3)
    step = make_one_step(model, LossScaler(), opt,
                         dropout_generator=torch.Generator().manual_seed(0))
    ids = torch.zeros(2, 8, dtype=torch.long)
    mask = torch.ones(2, 8, dtype=torch.long)
    state, ss, loss = step(opt.init(dict(model.named_parameters())),
                           LossScaler().init("cpu"), ids, mask, ids)
    assert loss.device.type == "cpu" and torch.isfinite(loss).item()
    lm, key = get_language_model(cfg, device="cpu")
    assert key == "language_model"
    out, table = lm(ids, torch.arange(8)[None].expand(2, 8), None)
    assert out.shape == (8, 2, 64) and table is lm.word_embeddings


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


def test_optimizer_entry_points_default_to_cuda(monkeypatch):
    """The optimizers' states load on ``cuda`` unless ``device="cpu"`` is
    asked for, and the multi-tensor ops given no tensor take ``cuda``
    too; a transform's state and its fused step live on its parameters'
    device."""
    import numpy as np

    from apex_tpu_torch import optimizers
    from apex_tpu_torch.multi_tensor_apply import multi_tensor_l2norm
    from apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
        MixedPrecisionLambState)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = {"w": np.ones((2, 3), np.float32)}
    loads = [(optimizers.FusedAdamState, (1, m, m)),
             (optimizers.FusedLAMBState, (1, m, m)),
             (optimizers.FusedSGDState, (1, m)),
             (optimizers.FusedNovoGradState, (1, m, np.ones(1, np.float32))),
             (optimizers.FusedAdagradState, (1, m)),
             (MixedPrecisionLambState, (np.ones(6, np.float32), (1, m, m)))]
    for cls, args in loads:
        with pytest.raises(RuntimeError, match="CUDA"):
            cls.from_numpy(*args)
        assert cls.from_numpy(*args, device="cpu") is not None
    with pytest.raises(RuntimeError, match="CUDA"):
        multi_tensor_l2norm([])
    with pytest.raises(RuntimeError, match="CUDA"):
        optimizers.grad_norm_stats([])
    params = {"w": torch.ones(2, 3)}
    tx = optimizers.fused_lamb(1e-2)
    state = tx.init(params)
    assert state.count.device.type == "cpu"
    tx.step({"w": torch.ones(2, 3)}, state, params)
    assert state.count.item() == 1


def test_resnet_slice_entry_points_default_to_cuda(monkeypatch):
    """``resnet50``, ``SyncBatchNorm`` and the ImageNet example's ``main``
    are built on ``cuda`` unless ``device="cpu"`` is asked for; on the
    CPU ``amp.initialize`` and the amp state follow the model's device,
    and an O2 ImageNet step runs there."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples import imagenet
    from apex_tpu_torch.models import resnet18, resnet50
    from apex_tpu_torch.optimizers import fused_sgd
    from apex_tpu_torch.parallel import SyncBatchNorm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: resnet50(), lambda: SyncBatchNorm(64),
                  lambda: amp.initialize(resnet18(num_filters=8),
                                         fused_sgd(0.1), opt_level="O2",
                                         verbosity=0),
                  lambda: imagenet.main(["--synthetic", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert SyncBatchNorm(8, device="cpu").weight.device.type == "cpu"
    model = resnet18(num_classes=10, num_filters=8, device="cpu",
                     dtype=torch.bfloat16)
    model, opt = amp.initialize(model, fused_sgd(0.1), opt_level="O2",
                                verbosity=0)
    state = opt.init(dict(model.named_parameters()))
    assert state.scalers[0].loss_scale.device.type == "cpu"
    step = imagenet.build_train_step(model, opt, None, torch.bfloat16)
    state, metrics, overflow = step(state, torch.rand(2, 3, 32, 32),
                                    torch.tensor([1, 2]))
    assert torch.isfinite(metrics).all() and not overflow.item()


def test_quant_dcgan_data_slice_entry_points_default_to_cuda(monkeypatch):
    """The DCGAN models and example, and a weight-quant engine, are built
    on ``cuda`` unless ``device="cpu"`` is asked for; on the CPU K23's
    wrapper refuses CPU tensors (its plain version runs there through
    ``ops/qmatmul``), and a DCGAN step runs."""
    from apex_tpu_torch.examples import dcgan
    from apex_tpu_torch.models import Discriminator, Generator
    from apex_tpu_torch.ops import qmatmul, qmatmul_cuda
    from apex_tpu_torch.serving import ServingEngine
    from apex_tpu_torch.transformer.testing import TransformerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(hidden_size=64, num_layers=1,
                            num_attention_heads=4, vocab_size=64,
                            max_position_embeddings=32, hidden_dropout=0.0,
                            attention_dropout=0.0,
                            apply_query_key_layer_scaling=False)
    for build in (lambda: Generator(ngf=8), lambda: Discriminator(ndf=8),
                  lambda: ServingEngine(cfg, weight_quant=True),
                  lambda: dcgan.main(["--steps", "1", "-b", "2"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    x = torch.ones(2, 32)
    wq = torch.ones(4, 32, dtype=torch.int8)
    scale = torch.ones(4)
    with pytest.raises(ValueError, match="contiguous"):
        qmatmul_cuda.qmatmul(x, wq, scale)
    assert qmatmul_cuda.qmatmul.launches == 0
    assert torch.equal(qmatmul.qmatmul(x, wq, scale, torch.float32),
                       torch.full((2, 4), 32.0))
    assert dcgan.main(["--steps", "1", "-b", "2", "--ngf", "4", "--ndf",
                       "4", "--device", "cpu"]) is not None
