"""One torch intra-op thread for a test module:
``from torch_threads import one_torch_thread`` makes this module-scoped
autouse fixture apply to the importing module.

The port's CPU tests run many small torch ops.  In a parallel test run
(about one worker per core, each with torch's default of one thread per
core) every op's threads wait on each other across the busy cores:
cases ran up to 100x slower than alone.  One thread a worker runs them
about as fast alone and far faster beside the other workers."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
