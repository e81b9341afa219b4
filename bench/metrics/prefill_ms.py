"""Mean time of a ``prefill_step`` call in the window, each call timed
on the host clock up to a device sync, ms."""


def read(run):
    s = run.get("prefill_s")
    return None if s is None else 1e3 * s
