"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/kernels/lib<name>-<hash>.so`` under the repository root
(the hash covers the source and the flags, so an edited source rebuilds).
The build happens at first use and never at import; ``build_all`` starts one
nvcc per source at once and waits for all of them. ``function``,
``dtype_code``, ``device_stream`` and ``check`` are the ctypes plumbing the
wrappers share.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]
# per-source flags: the CG solve rounds every multiply and add on its own,
# as the plain PyTorch version's separate tensor ops do
SOURCES: Dict[str, list] = {
    "cronet_fused": [],
    "cg_fused": ["--fmad=false"],
    "conv": [],
    "gemm": [],
    "pool": [],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's report (ptxas registers / shared memory / spills) per source
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    flags = ARCH + COMMON_FLAGS + SOURCES[name]
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library in ``names`` (default: all) with one
    nvcc process each, all started together. Returns the wall seconds."""
    names = list(SOURCES if names is None else names)
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *ARCH, *COMMON_FLAGS, *SOURCES[name], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def function(source: str, name: str, restype, argtypes):
    """``(lib, fn)``: the C entry point ``name`` of ``csrc/<source>.cu``,
    built and loaded first if needed, with its ctypes signature set."""
    lib = load(source)
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = argtypes
    return lib, fn


def dtype_code(t) -> int:
    """The C entry points' dtype code of a tensor: 0 float32, 1 bfloat16."""
    import torch
    code = {torch.float32: 0, torch.bfloat16: 1}.get(t.dtype)
    if code is None:
        raise TypeError(f"dtype {t.dtype}: the kernels take float32 or "
                        "bfloat16")
    return code


def device_stream(device) -> Tuple[int, int]:
    """(device index, handle of its current stream) for a CUDA device."""
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, name: str, err: int):
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{fn(err).decode(errors='replace')}")
