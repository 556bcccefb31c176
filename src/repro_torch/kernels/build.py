"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``. The
build runs at first use, into ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``); a library's file name carries a hash of its
sources and flags, so an edited source rebuilds and an unchanged one loads
from disk. `build` compiles every missing library at once, one ``nvcc``
process per source, all started together.

Nothing here runs at import time: the CPU tests import every module of the
port, and the machines they run on have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
HEADERS = ("common.cuh", "hopper.cuh")
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "decode_attention": "decode_attention.cu",
    "dequant_matmul": "dequant_matmul.cu",
    "moe_gemm": "moe_gemm.cu",
    "ssd_scan": "ssd_scan.cu",
}
# -lcuda: the flash and MoE kernels encode their TMA tensor maps with the
# driver's cuTensorMapEncodeTiled (the card's libcuda.so.1 is loaded at run
# time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or the ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of repro_torch build only where the CUDA toolkit "
                           "is installed")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of each kernel) of the library's last build."""
    return library_path(name).with_suffix(".log")


def build(names: Optional[Iterable[str]] = None,
          force: bool = False) -> Dict[str, float]:
    """Compile every library in ``names`` (default: all) that is not on disk
    yet (every one with ``force``), in parallel. Returns the seconds each
    compile took (0 for a library already built). Raises with the compiler's
    output if one fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if force or not library_path(n).is_file()]
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        # compile into a private file, then rename: a concurrent build of the
        # same library never sees a half-written .so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, library_path(n))
        log_path(n).write_text(out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing. The caller
    declares ``argtypes`` / ``restype`` of the functions it calls."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


# largest dynamic shared memory one block may use on an H100 (sm_90)
MAX_SMEM_PER_BLOCK = 232_448
