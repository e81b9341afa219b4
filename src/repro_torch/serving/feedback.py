"""Execution feedback: the replay buffer that online router adaptation
draws on.

Expert execution measures, for every request that carries MLM targets,
the observed masked NLL of the expert that served it: a (prompt,
expert, loss) sample of the Q function the router learns.  The
pipeline's Feedback stage publishes each sample here, and the engine's
adaptation loop (``TryageEngine._maybe_adapt``) replays uniform batches
of them through ``core.training.make_router_update_step``.

* **Bounded ring.**  The buffer keeps the most recent ``capacity``
  samples and drops the oldest, so its composition tracks the traffic.
* **Homogeneous sequence length.**  Replayed samples are stacked into
  dense arrays, so all tokens in one buffer share a sequence length.
  The first sample fixes the shape; later samples with a different
  shape are *dropped and counted* (``ReplayBuffer.dropped``) rather
  than raised — mixed-length traffic is legal for serving.
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    """Bounded FIFO ring of feedback samples; ``add`` is O(1)."""

    def __init__(self, capacity: int = 4096):
        assert capacity >= 1
        self.capacity = capacity
        self.seen = 0                      # accepted samples, ever
        self.dropped = 0                   # shape-mismatched, ever
        self._tokens: list[np.ndarray] = []
        self._experts: list[int] = []
        self._losses: list[float] = []
        self._head = 0                     # ring cursor once full

    def __len__(self) -> int:
        return len(self._tokens)

    def add(self, tokens: np.ndarray, expert_idx: int,
            observed_loss: float) -> bool:
        """Publish one sample; returns False (counted in ``dropped``)
        when its shape does not match the buffer's first sample."""
        if self._tokens and tokens.shape != self._tokens[0].shape:
            self.dropped += 1
            return False
        tokens = np.array(tokens, copy=True)   # detach from the request
        self.seen += 1
        if len(self._tokens) < self.capacity:
            self._tokens.append(tokens)
            self._experts.append(int(expert_idx))
            self._losses.append(float(observed_loss))
        else:
            self._tokens[self._head] = tokens
            self._experts[self._head] = int(expert_idx)
            self._losses[self._head] = float(observed_loss)
            self._head = (self._head + 1) % self.capacity
        return True

    def sample(self, batch: int, rng: np.random.Generator,
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Uniform batch with replacement: ``(tokens (B, S) int,
        expert_idx (B,) int32, observed_loss (B,) float32)``."""
        if not self._tokens:
            raise ValueError("cannot sample an empty replay buffer")
        idx = rng.integers(0, len(self), size=batch)
        return (np.stack([self._tokens[i] for i in idx]),
                np.array([self._experts[i] for i in idx], np.int32),
                np.array([self._losses[i] for i in idx], np.float32))
