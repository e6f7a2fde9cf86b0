"""Builds and loads the CUDA kernels of ``csrc/`` as one shared library.

The sources are plain CUDA C++ with a C interface (no PyTorch headers), so
``nvcc`` needs seconds.  Each source is compiled by its own ``nvcc``
process, all started together, then linked into one library under
``_build/<hash of sources and flags>/``; a stale build is never loaded
because the hash names the directory.  Nothing here runs at import time:
``library()`` is called by a wrapper the first time it is handed a CUDA
tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("quantize.cu", "fused_add.cu", "flash_attn.cu", "flash_attn_sm90.cu", "topk_mask.cu",
           "wkv.cu", "wkv_sm90.cu", "ssm_scan.cu", "ssm_scan_sm90.cu", "probe_copy.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "repro_quantize_int8": [_P, _P, _P, _L, _P],
    "repro_ternarize": [_P, _P, _P, _L, _P],
    "repro_dequantize_int8": [_P, _P, _P, _L, _P],
    "repro_probe_copy": [_P, _P, _L, _P],
    "repro_empty": [_P],
    "repro_fused_add_f32": [_P, _P, _I, _L, _P],
    "repro_fused_add_bf16": [_P, _P, _I, _L, _P],
    "repro_flash_attn_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "repro_flash_attn_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "repro_flash_attn_bf16_nv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "repro_topk_mask_f32": [_P, _P, _P, _L, _P],
    "repro_topk_mask_bf16": [_P, _P, _P, _L, _P],
    "repro_wkv_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _P],
    "repro_wkv_chunked_f32": [_P] * 8 + [_I] * 5 + [_L] * 3 + [_P],
    "repro_ssm_scan": [_P] * 6 + [_I] * 5 + [_L] * 10 + [_P],
    "repro_ssm_scan_fused": [_P] * 8 + [_I] * 5 + [_L] * 3 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    candidates: List[str] = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked at $CUDA_HOME, $PATH and "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources (in parallel) and link them; returns the library
    path.  Re-uses a finished build of the same sources."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "librepro_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for name in SOURCES:
        obj = out_dir / (name + f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failures = [], []
    for name, obj, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name} (exit {proc.returncode}):\n{log}")
        elif verbose and log.strip():
            print(f"[build] {name}:\n{log.strip()}")
        objs.append(obj)
    try:
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = out_dir / f"librepro_kernels.{os.getpid()}.tmp.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp, lib_path)          # atomic: a reader never sees half a file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib_path


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose=verbose)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def current_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
