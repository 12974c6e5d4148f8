"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled at first use into its own shared
library with a plain C interface and loaded with `ctypes` -- no PyTorch
headers, so a build takes seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a digest of the sources and flags, so an edited
kernel is rebuilt and a stale library is never loaded.  `build_all`
starts one `nvcc` per source, all at once.  Every C entry point returns
`cudaGetLastError()` after its launches; `check` raises on a nonzero
code.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("spmv_dia", "spmv_ell", "spmv_csr", "spmv_csr_seg", "spmv_bell",
           "spmm_ell", "spmm_csr_seg", "flash_attention", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, object] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.blake2b(digest_size=8)
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def build_all(names=SOURCES) -> float:
    """Compile every library that is not built yet, one `nvcc` each, all
    started together.  Returns the seconds spent (0.0 when nothing was
    missing); raises with the compiler's output on failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, library_path(name))   # atomic: no torn loads
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return time.perf_counter() - t0


def function(lib_name: str, fn_name: str, argtypes):
    """The C entry point `fn_name` of library `lib_name`, with its
    argument types declared (building the libraries on first use)."""
    key = f"{lib_name}.{fn_name}"
    fn = _FUNCS.get(key)
    if fn is not None:
        return fn
    with _LOCK:
        if lib_name not in _LIBS:
            build_all()
            _LIBS[lib_name] = ctypes.CDLL(str(library_path(lib_name)))
        lib = _LIBS[lib_name]
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _FUNCS[key] = fn
        _FUNCS[f"{lib_name}.error"] = err
    return fn


def check(rc: int, lib_name: str, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = _FUNCS[f"{lib_name}.error"](rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


PTR, INT, INT64, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)


def on_cuda(*tensors) -> bool:
    """True when the tensors (None skipped) all lie on one CUDA device,
    False when they all lie on the CPU; raises on anything else.  A
    wrapper takes its plain version only on False."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def refuse_autograd(name: str, *tensors) -> None:
    """The attention kernels have no backward: refuse a call whose
    result autograd would differentiate, on every device (the plain
    version would give a gradient on the CPU that the card cannot)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward pass, so autograd cannot "
            "differentiate through it; train with use_kernels=False (the "
            "plain attention), or call it under torch.no_grad()")


def require(t, dtype, name: str, ndim: int) -> None:
    """Validate what a kernel is given before its pointer is passed."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}")


def stream_of(t) -> int:
    """PyTorch's current stream on `t`'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
