"""Serving: requests and flags, the decision cache, the staged pipeline,
the engine's ``run()`` and ``serve()``, the lane scheduler, expert
health, the session front end and the metrics export."""

from repro_torch.serving.cache import DecisionCache
from repro_torch.serving.engine import EngineStats, TryageEngine, bucket_size
from repro_torch.serving.feedback import ReplayBuffer
from repro_torch.serving.frontend import (AdmissionQueue, ServingFrontend,
                                          Session)
from repro_torch.serving.health import ExpertHealth, ExpertState
from repro_torch.serving.metrics import (MetricSpec, MetricsServer,
                                         metric_names, render,
                                         start_metrics_server)
from repro_torch.serving.requests import (Request, Result, lambda_matrix,
                                          parse_flags)
from repro_torch.serving.scheduler import ExpertScheduler, Lane, LaneEntry
