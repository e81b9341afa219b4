"""Matrix products for the plain references, at a stated precision.

``"f32"`` is the reference itself: float32 products with TF32 off.  The
other modes are the controls that ``correct`` must fail: the same
products with both operands first rounded to a narrower type, as the
hardware paths that would tempt a later change compute them.

- ``"tf32"``: operands rounded to TF32 (a 10-bit mantissa, round to
  nearest), accumulated in float32: what a TF32 tensor core computes.
- ``"fp8"``: operands scaled per tensor to float8 e4m3's range (largest
  magnitude to 448), rounded to e4m3 and scaled back, accumulated in
  float32: an fp8 product with per-tensor scales.

The rounding is done on the values themselves, so a control reads the
same on the CPU as on the card.
"""

from __future__ import annotations

import torch

MODES = ("f32", "tf32", "fp8")
FP8_MAX = 448.0


def no_tf32() -> None:
    """Turn TF32 off for every float32 product of this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest on a 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) through float8 e4m3 with one scale for the tensor."""
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUND = {"f32": lambda x: x, "tf32": round_tf32, "fp8": round_fp8}


class Products:
    """``mm(a, b)`` = ``a @ b`` in float32 after rounding both operands by
    ``mode``; ``einsum`` likewise."""

    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} not in {MODES}")
        self.mode = mode
        self._round = ROUND[mode]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._round(a.float()) @ self._round(b.float())

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(spec, self._round(a.float()),
                            self._round(b.float()))
