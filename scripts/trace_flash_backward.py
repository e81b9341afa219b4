#!/usr/bin/env python3
"""Where the attention backward kernel's time goes, on one card.

    python3 scripts/trace_flash_backward.py

The card's profilers (ncu, nsys) may be unavailable, so this script
builds three copies of this checkout's
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` (hd 32 and 40
instances only, to build fast) with the flags of ``kernels/build.py``:

* ``as_is``: the source unchanged;
* ``one_block``: no cluster, one block per (batch, kv head, key block);
* ``traced``: thread 0 of each block writes ``clock64()`` at the
  one-launch path's phase boundaries into a buffer passed in place of
  the row-sum workspace: after the prologue's loads (``loaded``), after
  S, dP and P (``scores``), after the row sums (``sums``), after dV and
  dK (``dkv``), after the barrier before dQ (``barrier``), after dQ
  (``dq``), then once more at the end (``end``).

It times ``as_is`` and ``one_block`` by the profiler's device time at
the training shapes (B, H, S = T, hd) = (16, 8, 128, 32),
(16, 4, 128, 40) and (32, 4, 128, 32), non-causal, and reports the mean
cycles of each phase of ``traced`` over the blocks of one call (the
last of five).  Prints
one JSON object with the card's name, power limit and SM clock.  The
patch points are exact lines of the source: the script stops if one is
missing.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
SHAPES = ((16, 8, 128, 32), (16, 4, 128, 40), (32, 4, 128, 32))
STAMP = "if (threadIdx.x == 0) stamps[n_stamps++] = clock64();"
# (anchor line of the source, text put after it)
TRACE = [
    ("struct Args {", ""),
    ("  const bool whole = a.rows == nullptr;  // every key of the head is "
     "here",
     "\n  long long* stamps = trace + 32 * ((blockIdx.z * gridDim.y + "
     "blockIdx.y) * gridDim.x + blockIdx.x);\n  int n_stamps = 0;\n  "
     + STAMP),
    ("    __syncthreads();  // this tile is in; the last one is done with",
     "\n    " + STAMP + "  // loaded"),
    ("               a.softcap > 0.0f ? ds_s : nullptr);",
     "\n    " + STAMP + "  // scores"),
    ("      row_totals(sm + G::kPart, lse_s, row_s, R, nullptr, q0, a.S);\n"
     "      __syncthreads();\n    }",
     "\n    " + STAMP + "  // sums"),
    ("        tryage::mma_3xtf32(dk[n], as, bq);\n      }\n    }",
     "\n    " + STAMP + "  // dkv"),
    ("      __syncthreads();  // dS^T is in",
     "\n      " + STAMP + "  // barrier"),
    ("                   q_stride, a.scale);\n    }",
     "\n    " + STAMP + "  // dq"),
    ("      store(f, make_float4(x[0], x[1], x[2], x[3]));\n    }",
     "\n    __syncthreads();\n    " + STAMP + "  // end"),
    ("  cluster.sync();  // no block leaves while another reads its shares",
     "\n  " + STAMP + "  // end"),
    # the stamp buffer comes in through the row-sum workspace argument
    ("  cudaStream_t st = (cudaStream_t)stream;",
     "\n  cudaMemcpyToSymbol(trace, &rows, sizeof(rows));"),
]
PHASES = ("loaded", "scores", "sums", "dkv", "barrier", "dq")


def source(variant: str) -> str:
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    src, n = re.subn(r"TRYAGE_HD\(1\) TRYAGE_HD\(2\).*?TRYAGE_HD\(16\)",
                     "TRYAGE_HD(4) TRYAGE_HD(5)", src, flags=re.S)
    edits = []
    if variant == "one_block":
        edits = [("  while (split < kMaxCluster",
                  "  while (false && split < kMaxCluster")]
    if variant == "traced":
        edits = [(a, a + b) for a, b in TRACE]
        edits[0] = ("struct Args {", "__device__ long long* trace;\n"
                    "struct Args {")
    for old, new in edits:
        if n != 1 or old not in src:
            raise SystemExit(f"trace_flash_backward: patch point not found:"
                             f"\n{old}")
        src = src.replace(old, new, 1)
    return src


def build(variant: str, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    for h in ("common.cuh", "mma_tf32.cuh"):
        (out.parent / h).write_text((CSRC / h).read_text())
    cu = out.with_suffix(".cu")
    cu.write_text(source(variant))
    subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-shared", "-o",
                    str(out), str(cu)], check=True, capture_output=True,
                   text=True, timeout=900)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tryage_flash_attention_bwd.argtypes = ([P] * 9 + [I] * 8 + [F] * 2
                                               + [P])
    lib.tryage_flash_attention_bwd.restype = ctypes.c_int
    return lib


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("trace_flash_backward: no CUDA device", file=sys.stderr)
        return 1
    stream = torch.cuda.current_stream().cuda_stream
    out = {"shapes": []}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {v: build(v, Path(tmp) / f"{v}.so")
                for v in ("as_is", "one_block", "traced")}
        for B, H, S, hd in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(hd)
            q, k, v, do = (torch.randn(B, S, H, hd, device="cuda",
                                       generator=g) for _ in range(4))
            scale = 1.0 / math.sqrt(hd)
            lse = torch.logsumexp(torch.einsum("bshd,bthd->bhst", q * scale,
                                               k), dim=-1).contiguous()
            grads = [torch.empty_like(x) for x in (q, k, v)]
            stamps = torch.zeros(B * H * 8 * 32, dtype=torch.int64,
                                 device="cuda")

            def call(lib, work=None):
                err = lib.tryage_flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), work, *(x.data_ptr() for x in grads), B,
                    S, S, H, H, hd, 0, 0, 0.0, scale, stream)
                if err:
                    raise RuntimeError(f"launch error {err}")

            def device_ms(lib, iters=50):
                call(lib)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(iters):
                        call(lib)
                    torch.cuda.synchronize()
                t = sum(e.self_device_time_total for e in prof.key_averages()
                        if "flash_attention_bwd" in e.key)
                return t / iters / 1e3 or None

            row = {"shape": {"B": B, "H": H, "S": S, "T": S, "hd": hd}}
            for name in ("as_is", "one_block"):
                row[f"{name}_device_ms"] = [device_ms(libs[name])
                                            for _ in range(2)]
            for _ in range(5):  # the last of a few calls: a warm one
                stamps.zero_()
                call(libs["traced"], stamps.data_ptr())
            torch.cuda.synchronize()
            st = stamps.view(-1, 32).cpu()
            st = st[st[:, 0] != 0].double()
            n = int((st != 0).sum(1).max())
            names = ["start"] + [f"{p}{i}" for i in range((n - 2) // 6)
                                 for p in PHASES] + ["end"]
            row["blocks"] = st.shape[0]
            row["mean_cycles"] = {
                f"{names[i]}->{names[i + 1]}":
                    float((st[:, i + 1] - st[:, i]).mean())
                for i in range(n - 1)}
            row["total_cycles"] = float((st[:, n - 1] - st[:, 0]).mean())
            out["shapes"].append(row)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
