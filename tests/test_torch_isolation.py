"""The port stands alone: it imports with JAX blocked (its top-level
names too), no module of it (or chip_smoke.py, chip_flash_ab.py or an
example under examples_torch/) imports jax, flax or tf_yarn_tpu, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "tf_yarn_tpu_torch"
EXAMPLES = REPO / "examples_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tf_yarn_tpu")


def _modules():
    import tf_yarn_tpu_torch

    return sorted(
        info.name for info in pkgutil.walk_packages(
            tf_yarn_tpu_torch.__path__, "tf_yarn_tpu_torch."))


def test_package_imports_with_jax_blocked():
    modules = _modules()
    assert "tf_yarn_tpu_torch.serving.server" in modules
    assert "tf_yarn_tpu_torch.ranking.server" in modules
    for launcher in ("client", "tasks.worker", "tasks.distributed",
                     "coordination.kv", "backends", "resilience.taxonomy",
                     "fleet.router", "fleet.registry", "fleet.monitor",
                     "fleet.autoscaler", "fleet.policy", "tasks.router",
                     "evaluation", "tasks.evaluator", "tasks.tensorboard",
                     "utils.evaluator_metrics", "utils.tensorboard_utils",
                     "parallel.ring_attention", "parallel.ulysses",
                     "parallel.pipeline", "serving.tp_replica",
                     "resilience.chaos", "resilience.elastic", "tasks._spin",
                     "data.csv", "data.text", "data.parquet",
                     "data.torch_adapter", "bin.check_gpu_env"):
        assert f"tf_yarn_tpu_torch.{launcher}" in modules
    script = (
        "import sys, importlib\n"
        "for name in %r:\n"
        "    sys.modules[name] = None\n"
        "import tf_yarn_tpu_torch as package\n"
        "for name in package.__all__:\n"
        "    getattr(package, name)\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "print('ok', len(%r))\n"
    ) % (FORBIDDEN[:5], modules, modules)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py"))
                         + [REPO / "chip_smoke.py", REPO / "chip_flash_ab.py"]
                         + sorted(EXAMPLES.glob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imported_roots(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_need_cuda_unless_cpu_requested(monkeypatch):
    from tf_yarn_tpu_torch import resolve_device
    from tf_yarn_tpu_torch.models import transformer as tt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.Transformer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.make_model(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert tt.Transformer(cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("family", ["bert", "vit", "resnet"])
def test_zoo_entry_points_need_cuda_unless_cpu_requested(monkeypatch, family):
    from tf_yarn_tpu_torch import experiment, training
    from tf_yarn_tpu_torch.models import bert, resnet, vit

    module, config, cls = {
        "bert": (bert, bert.BertConfig.tiny(), bert.BertClassifier),
        "vit": (vit, vit.ViTConfig.tiny(), vit.ViT),
        "resnet": (resnet, resnet.ResNetConfig.tiny(), resnet.ResNet),
    }[family]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.make_model(config, seed=0)
    exp = module.make_experiment(config, train_steps=1, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.train_and_evaluate(experiment.as_core_experiment(exp))
    assert module.make_model(config, device="cpu").device == torch.device("cpu")


def test_ranker_entry_points_need_cuda_unless_cpu_requested(monkeypatch):
    from tf_yarn_tpu_torch import experiment, training
    from tf_yarn_tpu_torch.models import dlrm
    from tf_yarn_tpu_torch.models.rank_engine import RankEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dlrm.DLRMConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dlrm.DLRM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dlrm.make_model(cfg, seed=0)
    exp = dlrm.make_experiment(cfg, train_steps=1, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.train_and_evaluate(experiment.as_core_experiment(exp))

    class OnTheCard:  # a model that reports the card as its device
        config = cfg
        device = torch.device("cuda")

    with pytest.raises(RuntimeError, match="device='cpu'"):
        RankEngine(OnTheCard())
    model = dlrm.make_model(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    assert RankEngine(model).device == torch.device("cpu")
