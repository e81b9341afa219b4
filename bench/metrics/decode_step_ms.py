"""The decode window over the ``serve_step`` calls it ran, ms a step."""


def read(run):
    s = run.get("decode_step_s")
    return None if s is None else 1e3 * s
