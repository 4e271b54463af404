"""The port stands alone: no JAX and no ``repro`` import anywhere in
``src/repro_torch/``, ``chip_smoke.py`` or the port's tools
(``tools/sharded_topk_cards.py``, ``tools/sharded_train_cards.py``,
``tools/sharded_serve_cards.py``), and
its entry points run on the GPU by default, raising rather than falling
back to the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
# the port's package, its chip script and its tools (not tools/flocklint.py,
# which is the JAX package's)
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "sharded_topk_cards.py",
    REPO / "tools" / "sharded_train_cards.py",
    REPO / "tools" / "sharded_serve_cards.py"]


def _foreign_imports(path: Path):
    """(line, what) for every import of jax or of the JAX package, and
    every ``jax.`` attribute use."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((node.lineno, f"import {name}"))
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in ("jax", "jnp")):
            bad.append((node.lineno, f"{node.value.id}.{node.attr}"))
    return bad


def test_port_imports_no_jax_and_no_repro():
    assert len(PORT_FILES) > 15
    found = {str(p.relative_to(REPO)): _foreign_imports(p)
             for p in PORT_FILES}
    assert {k: v for k, v in found.items() if v} == {}


def test_scan_catches_foreign_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                 "from repro_torch import y\nimport repro_torch.models\n"
                 "z = jax.jit\n")
    assert [w for _, w in _foreign_imports(f)] == [
        "import jax.numpy", "import repro.core", "jax.jit"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import LocalTorchProvider
    from repro_torch.retrieval import VectorIndex
    from repro_torch.serving.engine import ServingEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalTorchProvider()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(get_smoke_config("olmo-1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorIndex(np.ones((4, 8), np.float32))
    # asked for the CPU, they run there
    assert LocalTorchProvider(device="cpu").engine.device.type == "cpu"


def test_not_yet_ported_names_four_archs():
    """Four architectures until the MoE configs were ported, two until the
    encoder-decoder was, one until the vision prefix was; none now.  The
    last of them, phi-3-vision-4.2b, is looked up like any other; an
    unknown name still raises, and the port still refuses a frontend it
    does not know."""
    from repro_torch.configs import (NOT_YET_PORTED, get_config,
                                     get_smoke_config)
    from repro_torch.models.config import check_supported
    assert NOT_YET_PORTED == ()
    for lookup in (get_config, get_smoke_config):
        cfg = lookup("phi-3-vision-4.2b")
        assert cfg.frontend == "vision" and cfg.num_prefix_tokens > 0
        check_supported(cfg)
        with pytest.raises(KeyError, match="unknown arch"):
            lookup("phi-4-vision")
    with pytest.raises(NotImplementedError, match="hologram frontend"):
        check_supported(cfg.replace(frontend="hologram"))


@pytest.mark.parametrize("arch", ["granite-8b", "gemma3-12b", "qwen1.5-32b"])
def test_dense_configs_default_to_cuda(no_cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import ServingEngine
    cfg = get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg.replace(kv_quant="int8"))
    assert ServingEngine(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_moe_configs_default_to_cuda(no_cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import LocalTorchProvider
    from repro_torch.serving.engine import ServingEngine
    cfg = get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalTorchProvider(arch)
    assert ServingEngine(cfg, device="cpu").device.type == "cpu"


def test_encdec_config_defaults_to_cuda(no_cuda):
    """whisper-base's engine and provider, like every other config's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import LocalTorchProvider
    from repro_torch.serving.engine import ServingEngine
    cfg = get_smoke_config("whisper-base")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalTorchProvider("whisper-base")
    assert ServingEngine(cfg, device="cpu").device.type == "cpu"


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """Without a GPU, and in a directory holding only the script, the
    smoke exits non-zero and prints no result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_trainer_modules_are_scanned_and_default_to_cuda(no_cuda):
    """The training layer (``training/``, ``launch/train.py``) is in the
    scan above, and its entry point runs on the GPU by default like the
    others: without a card it raises, asked for the CPU it trains."""
    from repro_torch.launch.train import run
    scanned = {str(p.relative_to(REPO / "src" / "repro_torch"))
               for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"training/optimizer.py", "training/train_step.py",
            "training/data.py", "training/checkpoint.py",
            "launch/train.py"} <= scanned
    args = ["--smoke", "--steps", "1", "--global-batch", "2",
            "--seq-len", "8"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(args)
    losses = run(args + ["--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0])
