"""The port's training CLI (``repro_torch.launch.train``) against the
JAX package's (``repro.launch.train``).

* ``arch_batches`` draws the reference CLI's numpy batches: the
  reference's ``train_arch`` runs with its ``build_train_step``,
  weights and optimiser replaced by stand-ins that record each batch it
  would feed
  (a decoder's tokens and mask, an encoder's embeds, MLM targets, mask
  and tokens, a vlm's embeds without tokens), and the port's batches
  equal them array for array.
* ``main(["--arch", ..., "--device", "cpu"])`` trains two reduced
  configs for 3 steps with finite losses.
* Without a card and without ``--device`` it raises.
* ``--tryage`` (and ``--fast``) hands the reference's
  ``ExperimentConfig`` to the port's ``run_experiment`` (stood in for).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from torch_threads import one_torch_thread  # noqa: F401

pytest.importorskip("jax")

import repro.launch.steps as jsteps  # noqa: E402
import repro.models.model as jmodel  # noqa: E402
import repro.optim as joptim  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402

STEPS, B, S = 2, 2, 16


def _reference_batches(monkeypatch, arch):
    """The batches the reference CLI feeds its train step."""
    seen = []

    class Built:
        @staticmethod
        def fn(params, opt, batch):
            seen.append({k: np.asarray(v) for k, v in batch.items()})
            return params, opt, 0.0

    monkeypatch.setattr(jsteps, "build_train_step",
                        lambda *a, **k: Built())
    monkeypatch.setattr(jmodel, "init_model", lambda key, cfg: ({}, {}))
    monkeypatch.setattr(joptim, "adamw_init",
                        lambda params: type("O", (), {"step": 0, "mu": {},
                                                      "nu": {}})())
    jtrain.train_arch(arch, STEPS, B, S, verbose=False)
    return seen


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hubert-xlarge",
                                  "qwen2-vl-72b"])
def test_cli_draws_the_reference_batches(monkeypatch, arch):
    want = _reference_batches(monkeypatch, arch)
    got = list(ttrain.arch_batches(get_config(arch).reduced(), STEPS, B, S))
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k].astype(g[k].dtype))
            assert np.dtype(g[k].dtype).kind == np.dtype(w[k].dtype).kind


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hubert-xlarge"])
def test_cli_trains_on_the_cpu(arch, capsys):
    losses = ttrain.main(["--arch", arch, "--steps", "3", "--batch", "2",
                          "--seq", "16", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert f"{arch}: loss" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_without_a_card_or_device_raises():
    with pytest.raises(RuntimeError):
        ttrain.main(["--arch", "tinyllama-1.1b", "--steps", "1"])


@pytest.mark.parametrize("fast", [False, True])
def test_tryage_dispatches_to_run_experiment(monkeypatch, fast):
    from repro_torch.core import experiment as tex
    calls = []
    monkeypatch.setattr(tex, "run_experiment",
                        lambda xc, device=None: calls.append((xc, device)))
    ttrain.main(["--tryage", "--device", "cpu"] + (["--fast"] if fast
                                                   else []))
    (xc, device), = calls
    assert device == "cpu"
    want = tex.ExperimentConfig()
    if fast:
        want = tex.ExperimentConfig(expert_steps=60, n_train_prompts=512,
                                    n_val_prompts=128, n_test_per_domain=24,
                                    router_epochs=3)
    assert xc == want
