"""Build the CUDA kernels at first use and load them with ``ctypes``.

Every source in ``csrc/`` (a plain C interface, no PyTorch headers, so a
build takes seconds) is compiled by its own ``nvcc`` for ``sm_90a`` into a
shared library under ``build/kernels/`` at the root of the checkout; the
``nvcc`` processes run side by side.  Each library's file name carries one
hash of every source, every header (``*.cuh``) and the flags, so an edit to
any of them — the shared ``fields.cuh`` included — rebuilds every library,
and an unchanged tree loads them as they are.  Concurrent builds each write
their own temporary file and rename it into place.

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
# library name -> its source; both include csrc/fields.cuh
SOURCES = {"fused_mttkrp": CSRC / "fused_mttkrp.cu",
           "phases": CSRC / "phases.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """A loaded library and how it was obtained."""
    lib: ctypes.CDLL
    path: Path
    built: bool           # False when an up-to-date library was found
    seconds: float        # build (or load) wall time, all libraries together
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


def _bind_fused(lib: ctypes.CDLL) -> None:
    lib.fused_mttkrp_launch.argtypes = [
        _I, _I, _VP, _VP, _VP, _VP, ctypes.POINTER(_VP), _I, _I,
        ctypes.POINTER(_I), ctypes.POINTER(_I), _LL, _I, _I, _I, _LL, _VP,
        _VP, _VP]
    lib.fused_mttkrp_launch.restype = _I
    lib.fused_mttkrp_occupancy.argtypes = [
        _I, _I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I),
        ctypes.POINTER(_I)]
    lib.fused_mttkrp_occupancy.restype = _I
    lib.fused_mttkrp_error_string.argtypes = [_I]
    lib.fused_mttkrp_error_string.restype = ctypes.c_char_p
    for name in ("fused_mttkrp_max_order", "fused_mttkrp_stash_max_bytes",
                 "fused_mttkrp_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I


def _bind_phases(lib: ctypes.CDLL) -> None:
    lib.phases_delinearize_launch.argtypes = [
        _VP, _VP, _VP, _I, ctypes.POINTER(_I), ctypes.POINTER(_I), _LL, _VP,
        _VP]
    lib.phases_delinearize_launch.restype = _I
    lib.phases_segments_launch.argtypes = [
        _I, _VP, _VP, ctypes.POINTER(_VP), _I, _LL, _I, _I, _VP, _VP, _VP]
    lib.phases_segments_launch.restype = _I
    lib.phases_stash_launch.argtypes = [
        _I, _VP, _VP, ctypes.POINTER(_VP), _I, _LL, _I, _I, _VP, _VP]
    lib.phases_stash_launch.restype = _I
    lib.phases_error_string.argtypes = [_I]
    lib.phases_error_string.restype = ctypes.c_char_p
    for name in ("phases_max_order", "phases_max_tile",
                 "phases_stash_max_bytes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I


_BINDERS = {"fused_mttkrp": _bind_fused, "phases": _bind_phases}


def source_digest() -> str:
    """One hash of every source and header in ``csrc/`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_libraries() -> dict[str, KernelLibrary]:
    """Build what is missing (one ``nvcc`` per source, all at once) and
    load every kernel library; once per process."""
    t0 = time.perf_counter()
    digest = source_digest()
    paths = {name: BUILD_DIR / f"lib{name}-{digest}.so" for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.is_file()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{SOURCES[name].name} ({proc.returncode}):"
                              f"\n{log}")
                continue
            todo[name].with_suffix(".log").write_text(log)
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    seconds = time.perf_counter() - t0
    out = {}
    for name, path in paths.items():
        log_path = path.with_suffix(".log")
        lib = ctypes.CDLL(str(path))
        _BINDERS[name](lib)
        out[name] = KernelLibrary(
            lib=lib, path=path, built=name in todo, seconds=seconds,
            log=log_path.read_text() if log_path.is_file() else "")
    return out


def load_library(name: str) -> KernelLibrary:
    """One kernel library (``"fused_mttkrp"`` or ``"phases"``)."""
    return load_libraries()[name]
