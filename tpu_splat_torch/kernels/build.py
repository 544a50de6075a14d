"""Build the CUDA sources under `tpu_splat_torch/csrc/` and load them.

Each `.cu` file is compiled by `nvcc` into a shared library with a plain C
interface, bound with `ctypes` (no PyTorch headers, so a build takes
seconds). Builds go to `tpu_splat_torch/_build/` (listed in `.gitignore`),
named by a hash of the source and the flags, so an edited source is never
served a stale library. Nothing here runs at import time: the wrappers build on first
use, and `build_all()` builds every source in parallel, one `nvcc` each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# sm_90a keeps wgmma/setmaxnreg available; no --use_fast_math: the tile
# blend's termination knife edge needs accurate expf/log1pf
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}  # name -> {"seconds", "ptxas", "path"}


def nvcc_path() -> str:
    cand = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cand:
        p = Path(root) / "bin" / "nvcc"
        if root and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return found


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, proc, tmp: Path, out: Path, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": [ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln],
        "path": str(out),
    }


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all() -> dict[str, dict]:
    """Compile every source whose library is missing, all at once."""
    started = [(n, *_start(n)) for n in sources() if not _target(n).exists()]
    for n, proc, tmp, out, t0 in started:
        _finish(n, proc, tmp, out, t0)
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def launch(name: str, fn: str, argtypes: list, *args) -> None:
    """Call the C launcher `fn` of `csrc/<name>.cu` (its C signature
    declared once from `argtypes`) and raise if it reports a CUDA error.
    Each source exports `<name>_error_string` for the message."""
    lib = load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        es = getattr(lib, f"{name}_error_string")
        es.argtypes = [ctypes.c_int]
        es.restype = ctypes.c_char_p
    err = f(*args)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn} launch failed: {msg}")
