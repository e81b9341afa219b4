"""The port stands alone: no JAX and nothing of ``repro`` reaches
``repro_torch`` or ``chip_smoke.py``, and no entry point quietly runs on
the CPU when no card is present."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_imports_in_the_source():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "mesh_serve_cards.py"]
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 20
    for mod in ("configs.xlstm_13b", "launch.steps", "models.ssm",
                "models.scan_utils", "kernels.mlstm_scan.ops",
                "optim.adamw", "core.training", "core.qtable",
                "core.baselines", "core.pareto", "core.experiment",
                "core.e2e", "serving.kvstore", "serving.semcache",
                "launch.serve", "launch.specs", "configs.tinyllama_11b",
                "configs.qwen15_05b", "configs.starcoder2_15b",
                "configs.gemma3_4b", "configs.hubert_xlarge",
                "configs.qwen2_vl_72b", "kernels.sanitize",
                "kernels.tiles", "checkpoint", "checkpoint.store",
                "launch.roofline", "launch.op_costs", "launch.dryrun",
                "launch.autotune", "launch.mesh", "serving.placement",
                "launch.gates"):
        assert f"repro_torch.{mod}" in names, mod


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch import bridge
    from repro_torch.core.library import ModelLibrary, _enc, ExpertSpec
    from repro_torch.core.router import RouterConfig, init_router
    from repro_torch.models.model import init_model
    from repro_torch.serving import TryageEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _enc("t", 1, 32, 2, 64, 64)
    rc = RouterConfig(n_models=1, vocab_size=64, num_layers=1, d_model=32,
                      num_heads=2, d_ff=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_router(rc)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.router_from_jax({}, rc)
    lib = ModelLibrary([ExpertSpec("t", cfg, {}, 0.5,
                                   params=init_model(cfg, device="cpu"))])
    with pytest.raises(RuntimeError, match="CUDA"):
        TryageEngine(lib, init_router(rc, device="cpu"), rc)
    from repro_torch.launch import gates
    with pytest.raises(RuntimeError, match="CUDA"):
        gates.small_library()
    with pytest.raises(RuntimeError, match="CUDA"):
        gates.small_router(3)


def test_xlstm_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models.model import init_decode_state, init_model
    cfg = get_config("xlstm-1.3b").reduced(d_model=32)
    model = init_model(cfg, device="cpu")
    state = init_decode_state(cfg, 1, device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.long)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_state(cfg, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        prefill_step(model, {"tokens": tokens})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_step(model, state, tokens[:, :1], 4)
    # asked for the CPU, they run there
    last, state = prefill_step(model, {"tokens": tokens}, device="cpu")
    tok, _ = serve_step(model, state, last.argmax(-1)[:, None], 4,
                        device="cpu")
    assert tok.shape == (1, 1)


def test_zoo_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import prefill_step, serve_step
    from repro_torch.models.model import init_decode_state, init_model
    cfg = get_config("qwen2-vl-72b").reduced(d_model=32)
    model = init_model(cfg, device="cpu")
    embeds = torch.zeros(1, 4, cfg.d_model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        prefill_step(model, {"embeds": embeds}, cache_capacity=8)
    # asked for the CPU, they run there: a KV cache per layer
    last, state = prefill_step(model, {"embeds": embeds}, cache_capacity=8,
                               device="cpu")
    assert [s["k"].shape[1] for s in state] == [8] * cfg.num_layers
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_step(model, state, last.argmax(-1)[:, None], 4)
    tok, _ = serve_step(model, state, last.argmax(-1)[:, None], 4,
                        device="cpu")
    assert tok.shape == (1, 1)
