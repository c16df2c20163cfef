#!/usr/bin/env python
"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one file aps_tpu_torch/csrc/<name>.cu with a plain C entry
point. On first use the file is compiled by nvcc for sm_90a into
build/aps_tpu_torch/lib<name>-<hash>.so under the repository root (the hash
is taken over the source, the headers csrc/*.cuh that a source may include
and the flags, so an edited source or header rebuilds) and loaded with
ctypes. A plain C interface compiles in seconds, where a source
that includes PyTorch's headers takes minutes.

Every kernel wrapper adds one to its entry of LAUNCHES where it launches
its kernel and nowhere else, so a run can show that it went through the
kernels."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aps_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC"
]

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "fused_logmel": 0,
    "flash_attention": 0,
    "flash_attention_dq": 0,
    "flash_attention_dkv": 0,
    "flash_attention_dbias": 0,
    "flash_attention_rel": 0,
    "flash_attention_rel_dq": 0,
    "flash_attention_rel_dkv": 0,
    "flash_attention_rel_dpose": 0,
    "ctc_score_step": 0,
    "tcn_block_fused": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def sources() -> List[str]:
    """Names of all kernel sources (csrc/<name>.cu)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, float]:
    """Compile every kernel source, all nvcc processes started together;
    returns the seconds each took."""
    from concurrent.futures import ThreadPoolExecutor
    import time

    def timed(name: str) -> float:
        beg = time.perf_counter()
        build(name)
        return time.perf_counter() - beg

    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def source_digest(name: str) -> str:
    """Hash of csrc/<name>.cu, of every header csrc/*.cuh (a source finds
    them beside itself) and of the compiler flags."""
    sha = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        sha.update(header.name.encode() + header.read_bytes())
    sha.update(" ".join(NVCC_FLAGS).encode())
    return sha.hexdigest()[:12]


def compile_source(cmd: List[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into a shared library (cached by content)."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = compile_source(cmd)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, entry: str, argtypes: List) -> ctypes.CDLL:
    """Build (once) and load csrc/<name>.cu; declare the C entry point
    `entry` (a source may have several, each declared at its first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.aps_cuda_error_string.argtypes = [ctypes.c_int]
            lib.aps_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.aps_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """The handle of PyTorch's current stream on a CUDA device, without a
    torch.cuda.Stream object around it (a wrapper asks for it at every
    launch)."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def require_cuda(name: str, tensors: Dict[str, torch.Tensor],
                 dtype=torch.float32) -> None:
    """Device / dtype / contiguity checks shared by the wrappers (devices
    compared by index: a wrapper runs them at every launch)."""
    dev = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.get_device()
        elif t.get_device() != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"cuda:{dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
