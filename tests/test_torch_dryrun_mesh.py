"""The dry run over the pod meshes
(``python -m repro_torch.launch.dryrun --mesh pod|multipod``), in a
subprocess as a user runs it, on qwen1.5-0.5b ``decode_32k``: the
record is ``OK`` on 256 (512) devices, its per-device parameter and
cache bytes are the sums of each array's shard worked out from the
logical specs by hand (the pair's rule overrides applied), and the
step's collectives are counted."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import production_shape
from repro_torch.models import model as tm
from repro_torch.models.common import INPUT_SHAPES
from repro_torch.sharding import logical_to_spec, tree_logical_to_spec
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCH, SHAPE = "qwen1.5-0.5b", "decode_32k"


class Sizes:
    """The axis sizes the rules read, without a process group."""

    def __init__(self, multi_pod):
        dims, names = production_shape(multi_pod)
        self.shape = dict(zip(names, dims))
        self.axis_names = names


def _shard_bytes(t, spec, sizes) -> int:
    ways = math.prod(
        math.prod(sizes.shape[a] for a in ((e,) if isinstance(e, str) else e))
        for e in spec if e is not None)
    assert t.numel() % ways == 0
    return t.numel() // ways * t.element_size()


def _hand_bytes(mesh: str):
    cfg = get_config(ARCH)
    sizes = Sizes(dryrun.MESHES[mesh])
    knobs, _ = dryrun.knobs_for(ARCH, SHAPE, mesh)
    rules = steps.rules_for(sizes, knobs)
    abstract, logical = tm.init_model_logical(cfg)
    params = sum(_shard_bytes(t, logical_to_spec(sizes, logical[n], t.shape,
                                                 rules), sizes)
                 for n, t in abstract.items())
    shape = INPUT_SHAPES[SHAPE]
    state = tm.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")
    specs = tree_logical_to_spec(sizes, tm.decode_state_logical(cfg), state,
                                 rules)
    cache = sum(_shard_bytes(t, specs[i][k], sizes)
                for i, st in enumerate(state) for k, t in st.items())
    return params, cache


def _run(mesh: str, out: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", mesh,
         "--arch", ARCH, "--shape", SHAPE, "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert f"[OK  ] {ARCH}" in proc.stdout
    return json.loads((out / f"{ARCH}_{SHAPE}_{mesh}.json").read_text())


@pytest.mark.parametrize("mesh,n_chips", [("pod", 256), ("multipod", 512)])
def test_dryrun_mesh_record(mesh, n_chips, tmp_path):
    rec = _run(mesh, tmp_path)
    assert rec["status"] == "OK" and rec["mesh"] == mesh
    assert rec["n_chips"] == n_chips
    params, cache = _hand_bytes(mesh)
    mem = rec["memory"]
    assert mem["parameter_bytes"] == params
    assert mem["cache_bytes"] == cache
    assert rec["knobs"]["rule_overrides"] == {"cache": None, "embed": None}
    assert rec["dropped_knobs"] == {}
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0 and coll["total_count"] > 0
    assert rec["roofline"]["collective_bytes"] == coll["total_bytes"]
    assert rec["roofline"]["t_collective_s"] > 0
    assert rec["model_flops_per_chip"] == rec["model_flops_global"] / n_chips
    # the two kernels' work is one device's
    assert rec["cost"]["kernels"] == {}      # decode attends with XLA's math


def test_meshless_record_keeps_its_fields(tmp_path):
    rec = dryrun.run_one(ARCH, SHAPE, out_dir=tmp_path)
    assert rec["mesh"] is None and rec["n_chips"] == 1
    assert "rule_overrides" in rec["dropped_knobs"]
    assert "collectives" not in rec and "model_flops" in rec
    assert rec["cost"]["collective_bytes"] == 0.0
    assert (tmp_path / f"{ARCH}_{SHAPE}.json").exists()


def test_run_one_refuses_an_unknown_mesh(tmp_path):
    with pytest.raises(ValueError, match="mesh"):
        dryrun.run_one(ARCH, SHAPE, mesh="ring", out_dir=tmp_path)
    assert not torch.distributed.is_initialized()
