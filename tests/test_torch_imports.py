"""What the port imports, and where it runs by default.

The port imports torch and numpy, never JAX and nothing of ``repro``;
Triton and the CUDA libraries load only inside the functions that
launch kernels.  The import check runs in a subprocess because this test
session has already imported JAX (tests/conftest.py).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m == 'triton')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_repro_or_top_level_triton_import(path):
    tree = ast.parse(path.read_text())
    top_level = set(map(id, tree.body))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"
            if root == "triton":
                assert id(node) not in top_level, \
                    f"{path.name}:{node.lineno} imports triton at top level"


def test_resolve_device_defaults_to_the_card():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


@pytest.mark.parametrize("entry", ["EmbeddingIndex", "ServingEngine",
                                   "topk_cosine", "launch.serve"])
def test_entry_points_need_the_card_unless_asked_for_cpu(entry, tmp_path):
    """Without a card every entry point raises unless given
    ``device="cpu"``; none falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    from repro_torch.core.registry import EmbeddingRegistry
    from repro_torch.core.serving import EmbeddingIndex, ServingEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    emb = np.eye(4, dtype=np.float32)
    reg = EmbeddingRegistry(tmp_path)
    reg.publish("go", "v1", "transe", list("abcd"), list("abcd"), emb,
                ontology_checksum="ck", hyperparameters={})
    calls = {
        "EmbeddingIndex": lambda dev: EmbeddingIndex(
            list("abcd"), list("abcd"), emb, device=dev),
        "ServingEngine": lambda dev: ServingEngine(reg, device=dev),
        "topk_cosine": lambda dev: ops.topk_cosine(emb[:1], emb, 2,
                                                   device=dev),
        "launch.serve": lambda dev: serve.main(
            ["--registry", str(tmp_path), "--requests", "4", "--threads",
             "2", "--batch", "2"] + ([] if dev is None
                                     else ["--device", dev])),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry](None)
    calls[entry]("cpu")


@pytest.mark.parametrize("module", ["repro_torch.launch.mesh",
                                    "repro_torch.models.sharding",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.models.runtime"])
def test_mesh_sharding_and_dry_run_modules_import_alone(module):
    """The meshes (serving and process), the sharding rules, the dry run
    and the runtime collectives import in a fresh interpreter with
    neither JAX nor ``repro`` and without touching the card: the dry run
    needs no device, and a process world is joined only when asked."""
    code = (
        "import importlib, json, sys, torch\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps([sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro')), torch.cuda.is_initialized()]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert module in _modules()
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False]
