"""ctypes binding of the native C++ data loader (``native/loader.cc``).

Counterpart of ``tpu_diinn/native/loader.py``, with its own build: at first
use the source is compiled with

    g++ -O3 -march=native -shared -fPIC -std=c++17 native/loader.cc
        -lpng -ljpeg -lz -pthread

into ``build/tpu_diinn_torch/loader-<sha1 of the source and flags>/
libtpudiinn_torch_loader.so`` under the checkout root (written under a
temporary name and renamed, so concurrent first uses do not clash), and
loaded with ``ctypes`` (a library that does not load, as one built on
another machine, is built again). It needs ``g++`` with the libpng,
libjpeg and zlib headers and libraries. Where the build fails, ``available()`` is false and
``build_error()`` holds the compiler's message; callers then take the
Python path (``data/datasets.py``), which makes the same samples.

The functions are the JAX binding's: ``image_size``, ``decode_image``
(PNG or JPEG to RGB uint8), ``resize_bicubic`` (antialiased, torch/PIL
convention), ``sample_patch`` (crop, downsample, shared flips, scaled to
[0, 1]) and ``sample_batch`` (``sample_patch`` over files on
``n_threads`` std::threads). ctypes releases the GIL around every call.
Nothing here runs at import time. A JPEG that libjpeg cannot decode ends
the process: ``loader.cc`` keeps libjpeg's default error handler, whose
``error_exit`` calls ``exit()`` (a malformed PNG returns an error).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "loader.cc"
BUILD_ROOT = _ROOT / "build" / "tpu_diinn_torch"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lz", "-pthread")

_lib = None
_lock = threading.Lock()
_build_error: Optional[str] = None
# seconds the g++ build and the load took in this process (the load alone
# when a build was cached)
build_seconds: Optional[float] = None

_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_FP = ctypes.POINTER(ctypes.c_float)
_BP = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(FLAGS + LIBS).encode())
    return BUILD_ROOT / f"loader-{h.hexdigest()[:16]}" / \
        "libtpudiinn_torch_loader.so"


def _build(out: Path) -> Optional[str]:
    """Compile the library to ``out``; the compiler's message on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)}:\n{(r.stdout + r.stderr)[-2000:]}"
    os.replace(tmp, out)
    return None


def _load():
    global _lib, _build_error, build_seconds
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        out = library_path()
        t0 = time.perf_counter()
        lib = None
        if out.exists():
            try:
                lib = ctypes.CDLL(str(out))
            except OSError:     # built on another machine: build it here
                lib = None
        if lib is None:
            _build_error = _build(out)
            if _build_error is None:
                try:
                    lib = ctypes.CDLL(str(out))
                except OSError as e:
                    _build_error = f"{out}: {e}"
            if _build_error is not None:
                return None
        build_seconds = time.perf_counter() - t0
        lib.image_size.argtypes = [ctypes.c_char_p, _IP, _IP]
        lib.image_size.restype = _I
        lib.decode_image.argtypes = [ctypes.c_char_p, _BP, _I, _I]
        lib.decode_image.restype = _I
        lib.resize_bicubic_f32.argtypes = [_FP, _I, _I, _I, _FP, _I, _I, _I]
        lib.resize_bicubic_f32.restype = None
        lib.sample_patch.argtypes = [_BP] + [_I] * 9 + [_FP, _FP]
        lib.sample_patch.restype = _I
        lib.sample_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _I, _IP, _IP, _I, _I,
            _IP, _IP, _IP, _FP, _FP, _I]
        lib.sample_batch.restype = _I
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library built (or was built before) and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """The build's error message, or None when the library is available."""
    _load()
    return _build_error


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def _iptr(v) -> Tuple[np.ndarray, object]:
    a = np.ascontiguousarray(v, np.int32)
    return a, a.ctypes.data_as(_IP)


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG or JPEG file."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if _library().image_size(str(path).encode(), ctypes.byref(h),
                             ctypes.byref(w)):
        raise IOError(f"cannot decode {path}")
    return h.value, w.value


def decode_image(path: str) -> np.ndarray:
    """A PNG or JPEG file as (H, W, 3) RGB uint8 (grey expanded, alpha
    dropped)."""
    h, w = image_size(path)
    out = np.empty((h, w, 3), np.uint8)
    if _library().decode_image(str(path).encode(), out.ctypes.data_as(_BP),
                               h, w):
        raise IOError(f"cannot decode {path}")
    return out


def resize_bicubic(img: np.ndarray, size: Tuple[int, int],
                   antialias: bool = True) -> np.ndarray:
    """Antialiased bicubic resize of a float (H, W, C) image to ``size``."""
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    out = np.empty((size[0], size[1], c), np.float32)
    _library().resize_bicubic_f32(_fptr(img), h, w, c, _fptr(out), size[0],
                                  size[1], 1 if antialias else 0)
    return out


def sample_patch(img: np.ndarray, top: int, left: int, hps: int, ps: int,
                 hflip: bool, vflip: bool, dflip: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One training pair from a uint8 (H, W, 3) image: the ``hps``-square
    HR crop at (top, left) and its ``ps``-square downsample, both flipped
    alike and scaled to [0, 1] float32."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"sample_patch takes an (H, W, 3) image, got "
                         f"{img.shape}")
    h, w, _ = img.shape
    lr = np.empty((ps, ps, 3), np.float32)
    hr = np.empty((hps, hps, 3), np.float32)
    if _library().sample_patch(img.ctypes.data_as(_BP), h, w, top, left,
                               hps, ps, int(hflip), int(vflip), int(dflip),
                               _fptr(lr), _fptr(hr)):
        raise ValueError(f"sample_patch: crop {hps} at ({top}, {left}) "
                         f"out of a {h}x{w} image")
    return lr, hr


def sample_batch(paths: Sequence[str], tops, lefts, hps: int, ps: int,
                 hflips, vflips, dflips, n_threads: int = 8
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``sample_patch`` of each file in ``paths`` (decoded there), item i
    with its own crop and flips, on ``n_threads`` threads:
    (lr (N, ps, ps, 3), hr (N, hps, hps, 3))."""
    lib = _library()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    keep = [_iptr(v) for v in (tops, lefts, hflips, vflips, dflips)]
    for a, _ in keep:
        if a.shape != (n,):
            raise ValueError(f"per-item arrays must have {n} entries")
    (_, tp), (_, lp), (_, hp), (_, vp), (_, dp) = keep
    lr = np.empty((n, ps, ps, 3), np.float32)
    hr = np.empty((n, hps, hps, 3), np.float32)
    failed = lib.sample_batch(c_paths, n, tp, lp, hps, ps, hp, vp, dp,
                              _fptr(lr), _fptr(hr), n_threads)
    if failed:
        raise IOError(f"{failed}/{n} samples failed to load")
    return lr, hr
