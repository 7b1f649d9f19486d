"""Build and load the port's CUDA kernels: plain ``nvcc`` + ``ctypes``.

At first use, ``load(name)`` compiles ``csrc/<name>.cu`` into
``build/tpu_diinn_torch/<sha1 of the sources>/lib<name>.so`` under the
checkout root, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

and loads it with ``ctypes``. The sources include no PyTorch header, so a
build takes seconds; ``load_all`` starts one nvcc per library, all at once.
A build error raises with nvcc's output; there is no fallback. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "tpu_diinn_torch"

# library name -> (compiled source, headers it includes); the headers are
# part of the build's content hash
SOURCES = {
    "decoder_fused": ("decoder_fused.cu", ("decoder_fused.cuh",
                                           "decoder_fwd_bf16.cuh",
                                           "hopper_chain.cuh")),
    "decoder_bwd": ("decoder_bwd.cu", ("decoder_bwd.cuh",
                                       "hopper_chain.cuh")),
    "encoder_conv": ("encoder_conv.cu", ("encoder_conv.cuh",
                                         "hopper_chain.cuh")),
    "liif_decoder": ("liif_decoder.cu", ("liif_decoder.cuh",
                                         "hopper_chain.cuh")),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# library name -> {"seconds": build time (0.0 if cached), "log": nvcc output,
# kept beside the library as lib<name>.log}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built on a machine with the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    src, headers = SOURCES[name]
    h = hashlib.sha1()
    for f in (src,) + tuple(headers):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest() / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless its content-addressed build exists."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        build_info.setdefault(name, {
            "seconds": 0.0,
            "log": log.read_text() if log.exists() else "(cached)"})
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / SOURCES[name][0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:"
                           f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    build_info[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
    return out


def load_all() -> Dict[str, ctypes.CDLL]:
    """Every library of ``SOURCES``, built in parallel where needed."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        for f in [pool.submit(build, name) for name in SOURCES]:
            f.result()
    return {name: load(name) for name in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
