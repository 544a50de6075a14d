"""ctypes bindings and on-demand build for the native IO library
(`tpu_splat_torch/native/io_loader.cc`, a copy of the JAX package's):
threaded, ordered image prefetch and PNG decode (port of
tpu_splat/data/native_loader.py).

The reference decodes images synchronously with PIL on the train thread
(utils/camera_utils.py loadCam); here a C++ thread pool decodes ahead. The
library is built with g++ at first use into the git-ignored
`tpu_splat_torch/_build/`, named by a hash of the source and the flags.
Where it cannot be built, or a file is not a PNG it decodes, Pillow decodes
instead; `decoder()` says which decoder runs and why, and raises when
neither is available.

`write_png` is a plain numpy + zlib PNG writer (8-bit gray, gray+alpha, RGB
or RGBA; any of the five row filters), for scenes built without Pillow.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / "native" / "io_loader.cc"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib = None
_tried = False
_build_error: str | None = None


def _target() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"libtpusplat_io-{h.hexdigest()[:16]}.so"


def build_native() -> str:
    """Compile the library if it is missing; returns its path. Raises
    RuntimeError with the compiler's message when the build fails."""
    out = _target()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), *GXX_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stderr.strip()}")
    os.replace(tmp, out)
    return str(out)


def get_lib():
    """The loaded native library (built on first use), or None; a failed
    build's message is kept for `decoder()`."""
    global _lib, _tried, _build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build_native())
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.tsio_decode_png.argtypes = [ctypes.c_char_p, ctypes.c_int, ip, ip, ip,
                                        ctypes.POINTER(u8p)]
        lib.tsio_decode_png.restype = ctypes.c_int
        lib.tsio_free.argtypes = [u8p]
        lib.tsio_free.restype = None
        lib.tsio_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
        lib.tsio_open.restype = ctypes.c_void_p
        lib.tsio_next.argtypes = [ctypes.c_void_p, ip, ip, ip, ip, ctypes.POINTER(u8p)]
        lib.tsio_next.restype = ctypes.c_int
        lib.tsio_close.argtypes = [ctypes.c_void_p]
        lib.tsio_close.restype = None
        _lib = lib
        return _lib


def _have_pil() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def decoder() -> str:
    """One line naming the decoder that loads PNGs here: the native library,
    or Pillow with the reason the native one is missing. Raises RuntimeError
    when neither is available."""
    if get_lib() is not None:
        return f"native ({_target().name})"
    if not _have_pil():
        raise RuntimeError(f"no image decoder: the native build failed ({_build_error}) "
                           "and Pillow is not installed")
    return f"PIL (the native build failed: {_build_error})"


def _take(lib, data_ptr, w, h, c) -> np.ndarray:
    buf = np.ctypeslib.as_array(data_ptr, shape=(h * w * c,))
    arr = buf.reshape(h, w, c).copy()
    lib.tsio_free(data_ptr)
    return arr


def decode_png(path: str, divisor: int = 1) -> np.ndarray | None:
    """One-shot native decode -> [H,W,C] uint8, or None (no library, or a
    file it does not decode)."""
    lib = get_lib()
    if lib is None:
        return None
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    data = ctypes.POINTER(ctypes.c_uint8)()
    rc = lib.tsio_decode_png(path.encode(), divisor, ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(c), ctypes.byref(data))
    if rc != 0:
        return None
    return _take(lib, data, w.value, h.value, c.value)


class PrefetchingImageLoader:
    """Iterate (index, [H,W,C] uint8) over `paths` in order; decodes run
    ahead on a C++ thread pool. Files the library does not decode go to
    Pillow, in order all the same."""

    def __init__(self, paths: list[str], divisor: int = 1, threads: int = 4):
        self.paths = list(paths)
        self.divisor = divisor
        self.lib = get_lib()
        self.handle = None
        if self.paths:
            decoder()  # raises when there is no decoder at all
        if self.lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self.handle = self.lib.tsio_open(arr, len(self.paths), divisor, threads)

    def _pil_load(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path)
        if self.divisor > 1:
            img = img.resize((img.width // self.divisor, img.height // self.divisor),
                             Image.LANCZOS)
        return np.asarray(img)

    def __iter__(self):
        if self.handle is None:
            for i, p in enumerate(self.paths):
                yield i, self._pil_load(p)
            return
        lib = self.lib
        try:
            while True:
                idx, w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
                data = ctypes.POINTER(ctypes.c_uint8)()
                rc = lib.tsio_next(self.handle, ctypes.byref(idx), ctypes.byref(w),
                                   ctypes.byref(h), ctypes.byref(c), ctypes.byref(data))
                if rc == 1:
                    return
                if rc != 0:  # a file the library does not decode: Pillow, order kept
                    yield idx.value, self._pil_load(self.paths[idx.value])
                    continue
                yield idx.value, _take(lib, data, w.value, h.value, c.value)
        finally:
            self.close()

    def close(self):
        if self.handle is not None:
            self.lib.tsio_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()


_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def _filter_rows(img: np.ndarray, ftype: int) -> np.ndarray:
    """[H, W*C] int16 rows filtered with one PNG filter (spec section 9.2),
    each against the raw previous row and the raw byte bpp to the left."""
    h, _, c = img.shape
    x = img.reshape(h, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]  # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # up
    cc = np.zeros_like(x)
    cc[1:, c:] = x[:-1, :-c]  # up-left
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) // 2
    else:
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    return (x - pred) & 0xFF


def write_png(path: str, img: np.ndarray, filters: tuple = (0,)):
    """Write an [H, W] or [H, W, C] uint8 array (C = 1-4) as an 8-bit,
    non-interlaced PNG; row i uses filter filters[i % len(filters)]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"uint8 image expected, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    per_filter = {f: _filter_rows(img, f) for f in set(filters)}
    ftypes = np.array([filters[i % len(filters)] for i in range(h)], np.uint8)
    rows = np.stack([per_filter[int(f)][i] for i, f in enumerate(ftypes)]).astype(np.uint8)
    raw = np.concatenate([ftypes[:, None], rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
