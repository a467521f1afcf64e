"""The port stands alone: paddlebox_tpu_torch (and chip_smoke.py) import
neither jax nor the JAX package, and its entry points do not fall back to
the CPU when the card is missing."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "paddlebox_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = sorted((ROOT / "paddlebox_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_native_library_stands_alone():
    """The native host library is the port's own: its loader is among the
    checked files, and its C++ source includes only standard headers (no
    file of the JAX package's ``native/``)."""
    native = ROOT / "paddlebox_tpu_torch" / "native"
    assert native / "__init__.py" in _port_files()
    for src in native.glob("*.cpp"):
        includes = [line for line in src.read_text().splitlines()
                    if line.startswith("#include")]
        assert includes and all("<" in line for line in includes), src


def test_import_pulls_in_no_jax():
    code = ("import sys, paddlebox_tpu_torch, paddlebox_tpu_torch.convert\n"
            "import paddlebox_tpu_torch.obs, paddlebox_tpu_torch.tools\n"
            "import paddlebox_tpu_torch.tools.obs_check\n"
            "import paddlebox_tpu_torch.tools.telemetry_report\n"
            "import paddlebox_tpu_torch.utils.profiler\n"
            "import paddlebox_tpu_torch.utils.timer\n"
            "import paddlebox_tpu_torch.utils.logging\n"
            "import paddlebox_tpu_torch.train.a2a_probe\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_observability_layer_is_checked():
    """The always-on layer's modules are among the checked files."""
    pkg = ROOT / "paddlebox_tpu_torch"
    files = set(_port_files())
    for rel in ("obs/__init__.py", "obs/hub.py", "obs/instruments.py",
                "obs/sinks.py", "obs/trace.py", "obs/flightrec.py",
                "obs/alerts.py", "obs/quality.py", "obs/watchdog.py",
                "utils/profiler.py", "utils/timer.py", "utils/logging.py",
                "tools/__init__.py", "tools/telemetry_report.py",
                "tools/obs_check.py"):
        assert pkg / rel in files, rel


MULTIPROCESS_MODULES = ("distributed/launch.py", "train/multihost.py",
                        "ps/tiered_multihost.py", "tools/elastic_check.py",
                        "tools/scaling_check.py",
                        "examples/train_multihost.py",
                        "parallel/__init__.py",
                        "parallel/collectives.py", "parallel/mesh.py",
                        "parallel/layers.py", "parallel/moe.py",
                        "parallel/ring_attention.py", "graph.py")


def test_multiprocess_layer_is_checked():
    """The multi-process modules are among the checked files, and they
    import without pulling in JAX."""
    pkg = ROOT / "paddlebox_tpu_torch"
    files = set(_port_files())
    for rel in MULTIPROCESS_MODULES:
        assert pkg / rel in files, rel
    mods = ["paddlebox_tpu_torch." + rel[:-3].replace("/", ".")
            for rel in MULTIPROCESS_MODULES]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_no_gpu_raises_instead_of_falling_back(monkeypatch):
    from paddlebox_tpu_torch import (DeepFM, EmbeddingTable, ServingModel,
                                     Trainer)
    from paddlebox_tpu_torch.data import DataFeedDesc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = DeepFM(num_slots=2, slot_width=7, dense_dim=1, hidden=(4,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingModel(model, DataFeedDesc.criteo(), mf_dim=4, capacity=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingTable(mf_dim=4, capacity=16)
    # the CPU is used only when asked for
    srv = ServingModel(model, DataFeedDesc.criteo(), mf_dim=4, capacity=16,
                       device="cpu")
    assert srv.table.state.data.device.type == "cpu"
    # training: the trainer defaults to the card as well
    table = EmbeddingTable(mf_dim=4, capacity=16, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, table, DataFeedDesc.criteo())
    tr = Trainer(model, table, DataFeedDesc.criteo(), device="cpu")
    assert tr.state.auc.buckets.device.type == "cpu"
    assert table.next_generator().device.type == "cpu"


def test_state_helpers_default_to_the_card(monkeypatch):
    """The AUC tables and the data_norm / cross_norm summaries are made on
    the card unless the caller asks for the CPU: without one they raise."""
    from paddlebox_tpu_torch.metrics import init_auc_state
    from paddlebox_tpu_torch.ops.cross_norm import init_cross_norm_summary
    from paddlebox_tpu_torch.ops.data_norm import init_data_norm_summary
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: init_auc_state(16, **kw),
                 lambda **kw: init_data_norm_summary(4, **kw),
                 lambda **kw: init_cross_norm_summary(1, 4, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        state = make(device="cpu")
        assert all(t.device.type == "cpu" for t in state)
