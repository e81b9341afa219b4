"""The sharded steps of the reduced xLSTM (mLSTM and sLSTM layers)
against the meshless steps from the same weights, as
``tests/test_torch_sharded_step.py`` holds the attention, MoE and
Mamba models: 4 gloo ranks spawned on a (1, 4) mesh, where the mLSTM
scan runs on each device's shards through ``local_map`` and its 2
heads stay replicated on the 4-way model axis.  Held at
``torch_sharded_util.RTOL_XLSTM`` (5e-4 of the largest value): sums in
another order through the 8 recurrent layers move the states and
gradients by up to about 1.1e-4 of theirs.
"""

import os

import torch.multiprocessing as mp

import torch_sharded_util as util
from torch_threads import one_torch_thread  # noqa: F401


def test_sharded_xlstm_steps_match_meshless(tmp_path):
    shape = (1, 4)
    world = util.world_of(shape)
    mp.spawn(util.run_rank,
             args=(world, os.fspath(tmp_path / "store"), shape, "xlstm"),
             nprocs=world, join=True)
