"""Padded rows over the rows the expert flushes launched in the window
(EngineStats ``padded_rows`` / the bucket sizes launched), %: device
work no request asked for."""

from harness.readers import engine, ratio


def read(run):
    return ratio(engine(run, "padded_rows"), engine(run, "rows_launched"),
                 100.0)
