"""Execute stage time per request executed (EngineStats
``expert_time_s`` / requests served in the window), ms: the padded
expert forward and its copy to the host."""

from harness.readers import engine, ratio


def read(run):
    return ratio(engine(run, "expert_time_s"), engine(run, "served"), 1e3)
