"""The port's ``train_step`` against the reference's ``build_train_step``
for the two recurrent configs, xlstm-1.3b and jamba-v0.1-52b (reduced;
the reference marks their train steps ``slow``, and so does this file):
the same check as ``tests/test_torch_train_step.py``, in a file of its
own so that a test run spreads the heaviest cases over its workers.
"""

import pytest

from test_torch_train_step import RECURRENT, check_train_step, runs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.slow
@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", RECURRENT)
def test_train_step_matches_reference(arch, micro, runs):  # noqa: F811
    check_train_step(arch, micro, runs)
