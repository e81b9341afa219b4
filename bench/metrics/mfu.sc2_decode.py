"""Model FLOPs of the requests the window served over the window at
the card's peak for the served type, % (``costs.flops``: the products
the answers need, not padding or unread logits)."""

from harness.readers import mfu


def read(run):
    return mfu(run)
