"""Route stage time per request the router scored (EngineStats
``router_time_s`` / cache misses in the window), ms: the encoder, the
decision kernel and their host work, each batch ending in its copy to
the host."""

from harness.readers import engine, ratio


def read(run):
    return ratio(engine(run, "router_time_s"), engine(run, "cache_misses"),
                 1e3)
