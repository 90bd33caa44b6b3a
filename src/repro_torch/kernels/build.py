"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` file has a plain C interface.  At first use it is
compiled for ``sm_90a`` into ``build/torch_kernels/`` at the root of the
checkout, cached under a hash of its source, and loaded with `ctypes`.
Nothing is built when the package is imported, and nothing here falls back:
a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "find_nvcc", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# argtypes of every C entry point, by source file
SIGNATURES = {
    "weighted_update": {
        "weighted_update_leaves": (_P, _INT, _P, _INT, ctypes.c_float, _INT, _P),
        "weighted_update_max_leaves": (),
        "weighted_update_leaves_kernel_info": (_INT, _P),
        "block_prefix_update": (_INT, _INT, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
        "block_prefix_update_vec": (_INT, _P, _P, _P, _I64),
        "block_prefix_update_kernel_info": (_INT, _INT, _INT, _I64, _P),
        "block_scatter_rows": (_INT, _INT, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
        "block_scatter_rows_vec": (_INT, _P, _P, _I64),
        "block_scatter_rows_kernel_info": (_INT, _INT, _INT, _I64, _P),
    },
    "flash_attention": {
        "flash_attention_fwd": (_INT, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                                _INT, _I64, _I64, ctypes.c_float, _P),
        "flash_attention_kernel_info": (_INT, _I64, _P),
        "flash_attention_route": (_INT, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64),
    },
    "ssd_scan": {
        "ssd_scan_fwd": (_INT, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _P),
        "ssd_scan_route": (_INT, _P, _P, _P, _I64, _I64, _I64),
        "ssd_scan_kernel_info": (_INT, _I64, _I64, _I64, _P),
    },
    "moe_gmm": {
        "moe_gmm_fwd": (_INT, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
        "moe_gmm_kernel_info": (_INT, _INT, _P),
        "moe_gmm_route": (_INT, _P, _P, _I64, _I64),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); the CUDA kernels "
        "are built from source at first use and need the CUDA toolkit"
    )


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` to a shared library (cached by source hash)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first call."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib
