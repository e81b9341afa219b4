"""Build and load the port's CUDA kernels.

Every kernel is CUDA C++ for ``sm_90a`` under ``kernels/csrc/`` with a
plain C interface.  At first use the sources are compiled with ``nvcc``
(one process per source, or per part of a source in ``PARTS``, all
started together), linked into one shared
library under ``build/torch_kernels/`` at the repository root, and
loaded with ``ctypes``.  The library's file name carries a digest of
the sources and flags, so an edited kernel is rebuilt and a stale
library is never loaded.  Nothing is built or loaded at import time:
the CPU test suite imports every module without a compiler present.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("router_score.cu", "router_cascade.cu", "flash_attention.cu",
           "flash_attention_bf16.cu", "flash_attention_bwd.cu",
           "flash_attention_bwd_part.cu", "mlstm_scan.cu",
           "mlstm_scan_bwd.cu", "launch_floor.cu")
# sources compiled once per part, each with its own defines: the
# attention backward's instances (f32: hd / 8 from 1 to 32, two kernels
# each; bf16: hd / 16 from 1 to 16, two kernels each) in eight parts, so
# that nvcc's time spreads over the cores
PARTS = {"flash_attention_bwd_part.cu": [
    (f"-DTRYAGE_BWD_BF16={bf16}", f"-DTRYAGE_BWD_LO={lo}")
    for bf16 in (0, 1) for lo in (1, 9, 17, 25)]}
HEADERS = ("common.cuh", "mma_tf32.cuh", "mma_bf16.cuh", "router_head.cuh",
           "flash_attention.cuh", "flash_attention_bwd.cuh",
           "flash_attention_bwd_bf16.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: pointers and the stream as void*, sizes as int;
# each returns the cudaError_t of its launch
SIGNATURES = {
    # emb w1 b1 w2 b2 cvals lam | pred choice
    # | B d hh M n_c threads k_groups | stream
    "tryage_router_score": [_P] * 7 + [_P] * 2 + [_I] * 7 + [_P],
    # emb w1 b1 w2 b2 uw1 ub1 uw2 ub2 cvals lam ladder_pos
    # | pred sigma choice esc | B d hh M n_c threads k_groups | stream
    "tryage_router_cascade": [_P] * 12 + [_P] * 4 + [_I] * 7 + [_P],
    # q k v | o lse (null: not written) | B S T H KV hd causal window
    # | softcap scale | bf16 (0: f32 inputs) warps (0: the default)
    # | stream
    "tryage_flash_attention": [_P] * 3 + [_P] * 2 + [_I] * 8 + [_F] * 2
    + [_I] * 2 + [_P],
    # q k v dO lse | rows (workspace, null on one launch) dq dk dv
    # | B S T H KV hd causal window | softcap scale | bf16 | stream
    "tryage_flash_attention_bwd": [_P] * 5 + [_P] * 4 + [_I] * 8
    + [_F] * 2 + [_I] + [_P],
    # q k v i f C0 n0 m0 | h C1 n1 m1 work Cst nst mst (null: not
    # written) | B S H dh chunk | scale | stream
    "tryage_mlstm_scan": [_P] * 8 + [_P] * 8 + [_I] * 5 + [_F] + [_P],
    # q k v i f m0 Cst nst mst h dh | dq dk dv di df work | B S H dh
    # chunk zero_state | scale | stream
    "tryage_mlstm_scan_bwd": [_P] * 11 + [_P] * 6 + [_I] * 6 + [_F] + [_P],
    # grid threads | stream: an empty kernel, the launch floor
    "tryage_launch_floor": [_I] * 2 + [_P],
}
# C functions that return a size, not a cudaError_t
SIZES = {
    # B S H chunk -> floats of workspace tryage_mlstm_scan needs
    "tryage_mlstm_scan_workspace": [_I] * 4,
    # B S H dh chunk -> floats of workspace tryage_mlstm_scan_bwd needs
    "tryage_mlstm_scan_bwd_workspace": [_I] * 5,
}


@dataclasses.dataclass
class KernelLibrary:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float | None     # None: loaded an existing build
    ptxas_log: str

    def call(self, fn: str, *args) -> None:
        """Launch through C entry point ``fn``; raise on a launch error."""
        err = getattr(self.cdll, fn)(*args)
        if err:
            raise RuntimeError(f"{fn}: CUDA error {err} at launch")

    def size(self, fn: str, *args) -> int:
        """The size C function ``fn`` returns (see ``SIZES``)."""
        return int(getattr(self.cdll, fn)(*args))


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The loaded kernel library, built on first call."""
    global _loaded
    with _lock:
        if _loaded is None:
            _loaded = _load()
        return _loaded


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a gradient through kernel ``name``.

    The kernels write their outputs through ctypes into fresh buffers
    that carry no ``grad_fn``; attention and the mLSTM scan have
    backward kernels (their wrappers' ``autograd.Function``), and only
    the router heads use this.  A loss behind one would get no gradient
    and nothing would say so.  The plain versions (CPU tensors) stay
    differentiable."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            f"torch.no_grad() or torch.inference_mode(), or detach its "
            f"inputs")


def launch(fn: str, device, *args) -> None:
    """Launch through C entry point ``fn`` on CUDA ``device``: ``args``
    and then PyTorch's current stream there, with ``device`` current.
    The common case (``device`` already current) skips the device
    switch and reads the raw stream pointer without building a
    ``torch.cuda.Stream``; each costs microseconds of host time, which
    a small kernel's call cannot spare."""
    import torch
    lib = library()
    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        lib.call(fn, *args, torch._C._cuda_getCurrentRawStream(current))
        return
    with torch.cuda.device(index):
        lib.call(fn, *args, torch._C._cuda_getCurrentRawStream(index))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(PARTS.items())).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def objects_dir(so: Path) -> Path:
    """Where the build keeps the library's object files."""
    return so.with_name(so.stem + "_objects")


def _load() -> KernelLibrary:
    so = BUILD_DIR / f"libtryage_kernels_{_digest()}.so"
    log = so.with_suffix(".ptxas.txt")
    seconds = None
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # serialise concurrent builders (test workers on one card)
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not so.exists():
                seconds = _build(so, log)
    cdll = ctypes.CDLL(str(so))
    for fn, argtypes in SIGNATURES.items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    for fn, argtypes in SIZES.items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_longlong
    return KernelLibrary(cdll, so, seconds,
                         log.read_text() if log.exists() else "")


def _build(so: Path, log: Path) -> float:
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in SOURCES:
            for i, defines in enumerate(PARTS.get(src, [()])):
                obj = tmp / f"{src}.{i}.o"
                procs.append((" ".join((src, *defines)), obj, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, *defines, "-c", str(CSRC / src),
                     "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        outputs = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{text}")
            outputs.append(f"== {src} (done at "
                           f"{time.perf_counter() - t0:.1f} s)\n{text}")
        tmp_so = tmp / so.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_so),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log.write_text("".join(outputs))
        # the objects stay beside the library (one per source or part),
        # so that a disassembly can take them in parallel
        objs = objects_dir(so)
        shutil.rmtree(objs, ignore_errors=True)
        objs.mkdir()
        for _, obj, _ in procs:
            os.replace(obj, objs / obj.name)
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t0


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_summary(text: str) -> dict:
    """Per kernel entry function: registers, static shared memory and
    spill bytes, from ``nvcc -Xptxas -v`` output."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            cur = out.setdefault(m.group(1), {})
        elif cur is not None and (m := _SPILL.search(line)):
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        elif cur is not None and (m := _USED.search(line)):
            cur["registers"] = int(m.group(1))
            smem = _SMEM.search(line)
            cur["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out
