"""Requests executed per expert flush in the window (EngineStats
``served`` / flushes): how full the Execute stage's launches are."""

from harness.readers import engine, ratio


def read(run):
    return ratio(engine(run, "served"), engine(run, "flushes"))
