"""The expert model library M = (M_1 ... M_n).

The paper's library is 11 BERT-family checkpoints; the reproduction's
analogue is 11 encoder LMs of varying size, each meant to be trained on
a domain-biased mixture of the synthetic corpus.  ``ExpertSpec`` carries
the static metadata the routing constraints consume (param count,
recency) and, once built, the expert's ``models.model.Model``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from torch import nn

from repro_torch.data.corpus import DOMAINS
from repro_torch.models.common import AttnConfig, ModelConfig


def _enc(name, layers, d, heads, dff, vocab) -> ModelConfig:
    return ModelConfig(
        name=name, num_layers=layers, d_model=d,
        num_heads=heads, num_kv_heads=heads, d_ff=dff, vocab_size=vocab,
        attn=AttnConfig(rope_theta=10000.0, causal=False),
        is_encoder=True, tie_embeddings=True, norm_kind="layernorm",
        act="gelu", dtype="float32")


@dataclasses.dataclass
class ExpertSpec:
    name: str
    cfg: ModelConfig
    train_mixture: dict            # domain -> weight used for training
    recency: float = 0.5           # 0 = ancient, 1 = brand new
    source: str = "in-repo"
    params: Optional[nn.Module] = None  # the expert's Model, once built
    n_params: int = 0

    def describe(self) -> str:
        """Model-card text used by the keyword-router baseline."""
        doms = sorted(self.train_mixture, key=self.train_mixture.get,
                      reverse=True)[:3]
        return (f"{self.name}: masked language model, {self.n_params} "
                f"parameters, specialized for {', '.join(doms)}.")


def _mix(*focus, w=0.8):
    """Mixture concentrated on focus domains, smoothed over all."""
    base = {d: (1.0 - w) / len(DOMAINS) for d in DOMAINS}
    for f in focus:
        base[f] += w / len(focus)
    return base


def paper_library_specs(vocab=512) -> list[ExpertSpec]:
    """11 experts mirroring the paper's library composition."""
    uniform = {d: 1.0 / len(DOMAINS) for d in DOMAINS}
    E = _enc
    return [
        # generalists at four sizes (bert-tiny .. roberta analogues)
        ExpertSpec("roberta-analog",    E("roberta-analog", 6, 256, 8, 1024, vocab), uniform, 0.8),
        ExpertSpec("bert-base-analog",  E("bert-base-analog", 4, 192, 6, 768, vocab), uniform, 0.5),
        ExpertSpec("bert-small-analog", E("bert-small-analog", 4, 128, 4, 512, vocab), uniform, 0.5),
        ExpertSpec("bert-tiny-analog",  E("bert-tiny-analog", 2, 64, 2, 256, vocab), uniform, 0.5),
        # specialists
        ExpertSpec("codebert-analog",   E("codebert-analog", 4, 160, 4, 640, vocab), _mix("github", "stackexchange"), 0.7),
        ExpertSpec("cppmodel-analog",   E("cppmodel-analog", 4, 160, 4, 640, vocab), _mix("github", "dm_math"), 0.6),
        ExpertSpec("patentbert-analog", E("patentbert-analog", 4, 160, 4, 640, vocab), _mix("uspto"), 0.4),
        ExpertSpec("clinbert-analog",   E("clinbert-analog", 4, 160, 4, 640, vocab), _mix("pubmed"), 0.4),
        ExpertSpec("lawbert-analog",    E("lawbert-analog", 4, 160, 4, 640, vocab), _mix("freelaw", "uspto"), 0.3),
        ExpertSpec("mathbert-analog",   E("mathbert-analog", 3, 128, 4, 512, vocab), _mix("dm_math"), 0.6),
        ExpertSpec("bookbert-analog",   E("bookbert-analog", 4, 160, 4, 640, vocab), _mix("books", "commoncrawl"), 0.5),
    ]


@dataclasses.dataclass
class ModelLibrary:
    experts: list[ExpertSpec]

    def __len__(self):
        return len(self.experts)

    def __getitem__(self, i) -> ExpertSpec:
        return self.experts[i]

    @property
    def names(self):
        return [e.name for e in self.experts]

    def sizes(self) -> np.ndarray:
        return np.array([e.n_params for e in self.experts], float)

    def recencies(self) -> np.ndarray:
        return np.array([e.recency for e in self.experts], float)

    def set_params(self, name: str, params, n_params: int):
        for e in self.experts:
            if e.name == name:
                e.params = params
                e.n_params = n_params
                return
        raise KeyError(name)
