"""Share of the traced stretch of the window in which no operation ran
on the card (profiler trace), %."""

from harness.readers import idle_share


def read(run):
    return idle_share(run)
