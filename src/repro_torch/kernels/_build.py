"""Build the CUDA kernels at first use and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface. The library lands in ``build/repro_torch_kernels/``
of the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. Importing this module
builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"] + ARCH_FLAGS        # -v: registers, spills

_c_ptr, _c_int, _c_i64, _c_float = (ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int64, ctypes.c_float)
# C signatures of the exported functions (each returns a cudaError_t).
SIGNATURES = {
    "repro_flash_attention_wgmma": [_c_ptr] * 4 + [_c_int] * 6 + [_c_i64] * 9
    + [_c_int, _c_float, _c_ptr],
    "repro_flash_attention_fp32": [_c_ptr] * 4 + [_c_int] * 6 + [_c_i64] * 9
    + [_c_int, _c_float, _c_ptr],
    "repro_decode_attention": [_c_ptr] * 5 + [_c_int] * 8 + [_c_i64] * 8
    + [_c_float, _c_ptr],
    "repro_ssd_chunk": [_c_ptr] * 8 + [_c_int] * 6 + [_c_ptr],
    "repro_ssd_wgmma": [_c_ptr] * 8 + [_c_int] * 5 + [_c_ptr],
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built on a machine with the CUDA toolkit")
    return found


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"


def build() -> tuple:
    """Compile and link the kernels if the library for these sources is not
    built yet. Returns (path, seconds spent, compiler log); the log is kept
    beside the library, so a library built earlier returns its log too."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    # simlint: disable=SIM001 -- the nvcc build's own duration, host-side
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [exe, *ARCH_FLAGS, "-shared", "-o", str(staged),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        text = "\n".join(log)
        staged_log = Path(tmp) / log_path.name
        staged_log.write_text(text)
        os.replace(staged_log, log_path)
        os.replace(staged, out)        # atomic: a reader never sees half a file
    # simlint: disable=SIM001 -- the nvcc build's own duration, host-side
    return out, time.perf_counter() - t0, text


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not say so)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
