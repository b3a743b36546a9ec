"""Build the CUDA kernels at first use and load them with ``ctypes``.

``nvcc`` compiles ``csrc/fused_mttkrp.cu`` (a plain C interface, no PyTorch
headers, so a build takes seconds) for ``sm_90a`` into a shared library
under ``build/kernels/`` at the root of the checkout.  The file name carries
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Concurrent builds each write their own
temporary file and rename it into place.

Nothing here runs at import time: the first call of ``load_library()``
builds, and this module imports on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "fused_mttkrp.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded library and how it was obtained."""
    lib: ctypes.CDLL
    path: Path
    built: bool           # False when an up-to-date library was found
    seconds: float        # build (or load) wall time
    log: str              # nvcc's output, with the -Xptxas -v report


def nvcc_path() -> str:
    """``nvcc`` from PATH, ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.fused_mttkrp_launch.argtypes = [
        _I, _I, _VP, _VP, _VP, _VP, ctypes.POINTER(_VP), _I, _I,
        ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.c_longlong, _I, _I,
        _VP, _VP]
    lib.fused_mttkrp_launch.restype = _I
    lib.fused_mttkrp_error_string.argtypes = [_I]
    lib.fused_mttkrp_error_string.restype = ctypes.c_char_p
    lib.fused_mttkrp_max_order.argtypes = []
    lib.fused_mttkrp_max_order.restype = _I
    lib.fused_mttkrp_stash_max_bytes.argtypes = []
    lib.fused_mttkrp_stash_max_bytes.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; once per process."""
    t0 = time.perf_counter()
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libfused_mttkrp-{digest}.so"
    log_path = path.with_suffix(".log")
    built = not path.is_file()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, path)
    log = log_path.read_text() if log_path.is_file() else ""
    lib = _bind(ctypes.CDLL(str(path)))
    return KernelLibrary(lib=lib, path=path, built=built,
                         seconds=time.perf_counter() - t0, log=log)
