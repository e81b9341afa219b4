"""The port's logical sharding rules (``repro_torch.sharding``) against
the JAX package's (``repro.sharding.rules``).

* ``logical_to_spec`` equals the reference's on the pod and multipod
  axis sizes, under the default, multipod and override rules, over
  hypothesis-drawn logical tuples and dim sizes (the reference reads
  only the mesh's ``.shape``, so both get a stand-in mesh);
* for each of the ten configs at published width, every parameter's
  spec from ``init_model_logical`` equals the reference's leaf's spec
  with its leading (stacked ``"layers"``) entry dropped; so does every
  decode-state leaf (``decode_state_logical``) and every batch leaf
  (``batch_logical``, ``decode_token_logical``);
* ``placements`` gives one DTensor placement per mesh dimension.
"""

import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from hyputil import given, settings, st
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import specs as tspecs
from repro_torch.models import model as tm
from repro_torch.models.common import INPUT_SHAPES
from repro_torch.sharding import rules as trules
from repro_torch.sharding.context import batch_sharding, replicated_sharding
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.dryrun import KNOB_OVERRIDES  # noqa: E402
from repro.launch.steps import rules_for as jrules_for  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402


class StandInMesh:
    """What the rules read of a mesh: its axis names and sizes."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


POD = StandInMesh(data=16, model=16)
MULTIPOD = StandInMesh(pod=2, data=16, model=16)


def _port_rules(ref: jrules.LogicalRules) -> trules.LogicalRules:
    return trules.LogicalRules(rules=dict(ref.rules))


# (name, mesh, reference rules) for every rule set the reference runs
RULE_SETS = [("default", POD, jrules.DEFAULT_RULES),
             ("multipod", MULTIPOD, jrules.MULTIPOD_RULES)] + [
    (f"{arch}/{shape}", POD, jrules_for(POD, knobs))
    for (arch, shape), knobs in sorted(KNOB_OVERRIDES.items())]


def test_rule_tables_are_copied_entry_for_entry():
    assert dict(trules.DEFAULT_RULES.rules) == dict(jrules.DEFAULT_RULES.rules)
    assert (dict(trules.MULTIPOD_RULES.rules)
            == dict(jrules.MULTIPOD_RULES.rules))


NAMES = sorted(jrules.DEFAULT_RULES.rules) + ["layers", "unknown"]


@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_logical_to_spec_matches_reference(data):
    name, mesh, ref_rules = data.draw(st.sampled_from(RULE_SETS))
    n = data.draw(st.integers(0, 5))
    axes = tuple(data.draw(st.one_of(st.none(), st.sampled_from(NAMES)))
                 for _ in range(n))
    sizes = tuple(data.draw(st.sampled_from(
        [1, 2, 3, 4, 8, 12, 16, 24, 32, 48, 64, 256, 504, 512, 1000, 4096]))
        for _ in range(n))
    for dims in (sizes, None):
        want = jrules.logical_to_spec(mesh, axes, dims, ref_rules)
        got = trules.logical_to_spec(mesh, axes, dims, _port_rules(ref_rules))
        assert tuple(got) == tuple(want), (name, axes, dims)


def _ref_leaf(tree, name: str, cfg):
    """The reference leaf (and whether it is stacked) of port name
    ``layers.{i}.rest`` / ``embed.table`` / ...."""
    parts = name.split(".")
    if parts[0] != "layers":
        node = tree
        for p in parts:
            node = node[p]
        return node, False
    i, rest = int(parts[1]), parts[2:]
    unit = len(cfg.layer_pattern)
    U = cfg.num_layers // unit
    node, stacked = ((tree["units"][f"l{i % unit}"], True) if i < U * unit
                     else (tree["rem"][f"l{i - U * unit}"], False))
    for p in rest:
        node = node[p]
    return node, stacked


@pytest.fixture(scope="module")
def ref_models():
    out = {}
    for arch in list_archs():
        cfg = jget_config(arch)
        out[arch] = jm.init_model_logical(cfg)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_parameter_specs_match_reference(arch, ref_models):
    cfg = get_config(arch)
    abstract, logical = tm.init_model_logical(cfg)
    ref_abs, ref_log = ref_models[arch]
    jcfg = jget_config(arch)
    for _, mesh, ref_rules in RULE_SETS:
        rules = _port_rules(ref_rules)
        for name, t in abstract.items():
            leaf_log, stacked = _ref_leaf(ref_log, name, jcfg)
            leaf_abs, _ = _ref_leaf(ref_abs, name, jcfg)
            want = tuple(jrules.logical_to_spec(mesh, leaf_log,
                                                leaf_abs.shape, ref_rules))
            if stacked:
                assert leaf_log[0] == "layers" and want[0] is None
                want = want[1:]
            assert tuple(t.shape) == tuple(leaf_abs.shape)[int(stacked):]
            got = trules.logical_to_spec(mesh, logical[name], t.shape, rules)
            assert tuple(got) == want, (name, logical[name])


@pytest.mark.parametrize("arch", list_archs())
def test_state_and_batch_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape = INPUT_SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    state = tm.init_decode_state(cfg, B, S, device="meta")
    state_log = tm.decode_state_logical(cfg)
    ref_state = jax.eval_shape(lambda: jm.init_decode_state(jcfg, B, S))
    ref_log = jm.decode_state_logical(jcfg)
    unit = len(cfg.layer_pattern)
    U = cfg.num_layers // unit
    for _, mesh, ref_rules in RULE_SETS:
        rules = _port_rules(ref_rules)
        specs = trules.tree_logical_to_spec(mesh, state_log, state, rules)
        for i, layer in enumerate(specs):
            stacked = i < U * unit
            key = ("units", f"l{i % unit}") if stacked else (
                "rem", f"l{i - U * unit}")
            for k, got in layer.items():
                lg = ref_log[key[0]][key[1]][k]
                ab = ref_state[key[0]][key[1]][k]
                want = tuple(jrules.logical_to_spec(mesh, lg, ab.shape,
                                                    ref_rules))
                if stacked:
                    lg, want = lg[1:], want[1:]
                assert state_log[i][k] == tuple(lg)
                assert tuple(got) == want, (i, k)
        for sname, ishape in INPUT_SHAPES.items():
            got = trules.tree_logical_to_spec(
                mesh, tspecs.batch_logical(cfg, ishape),
                {k: s for k, (s, _) in tspecs.batch_specs(cfg, ishape).items()},
                rules)
            jabs = jspecs.batch_specs(jcfg, ishape)
            jlog = jspecs.batch_logical(jcfg, ishape)
            assert set(got) == set(jabs)
            for k in got:
                assert tuple(got[k]) == tuple(jrules.logical_to_spec(
                    mesh, jlog[k], jabs[k].shape, ref_rules)), (sname, k)
            tok = tspecs.decode_token_specs(cfg, ishape)["tokens"][0]
            want = jrules.logical_to_spec(
                mesh, jspecs.decode_token_logical(jcfg)["tokens"], tok,
                ref_rules)
            assert tuple(trules.logical_to_spec(
                mesh, tspecs.decode_token_logical(cfg)["tokens"], tok,
                rules)) == tuple(want)


class FakeDeviceMesh:
    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 16, 16)


def test_placements_one_per_mesh_dim():
    m = FakeDeviceMesh()
    assert trules.axis_sizes(m) == {"pod": 2, "data": 16, "model": 16}
    spec = trules.PartitionSpec(("pod", "data"), None, "model")
    assert trules.placements(m, spec) == (Shard(0), Shard(0), Shard(2))
    assert trules.placements(m, trules.PartitionSpec()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="lacks"):
        trules.placements(m, trules.PartitionSpec("other"))


def test_batch_and_replicated_specs():
    assert tuple(batch_sharding(POD, 3, (32, 7, 5))) == ("data", None, None)
    assert tuple(batch_sharding(POD, 2, (6, 7))) == (None, None)
    assert tuple(batch_sharding(MULTIPOD, 2, (64, 7),
                                trules.MULTIPOD_RULES)) == (("pod", "data"),
                                                            None)
    assert tuple(replicated_sharding(POD)) == ()
    assert repr(trules.PartitionSpec("data", None)) == (
        "PartitionSpec('data', None)")
    assert np.array_equal(tuple(trules.PartitionSpec()), ())
