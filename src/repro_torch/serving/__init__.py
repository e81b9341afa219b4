"""Serving: requests and flags, the decision cache, the staged pipeline
and the engine's ``run()`` path."""

from repro_torch.serving.cache import DecisionCache
from repro_torch.serving.engine import EngineStats, TryageEngine, bucket_size
from repro_torch.serving.feedback import ReplayBuffer
from repro_torch.serving.requests import (Request, Result, lambda_matrix,
                                          parse_flags)
from repro_torch.serving.scheduler import LaneEntry
