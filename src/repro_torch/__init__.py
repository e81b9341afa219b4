"""Tryage in PyTorch and CUDA: the port of the JAX package ``repro``.

The subpackages mirror ``repro``'s (``models``, ``core``, ``kernels``,
``serving``, ``data``, ``configs``, ``launch``) so each module's
counterpart is easy to find.
The port imports ``torch`` and numpy, never JAX and nothing of
``repro``.  Entry points run on the card unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""
