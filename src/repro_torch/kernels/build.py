"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface. All sources build in
parallel (one ``nvcc`` each, started together) at first use, into
``build/repro_torch/`` at the root of the checkout, which ``.gitignore``
lists. A library's file name carries a hash of its source, so an edited
source rebuilds and an unchanged one is loaded as it is.

Nothing here runs at import time: the CPU tests import every module of
the package, and ``nvcc`` is only called when a wrapper is first handed
a CUDA tensor (or ``build_all`` is called). A failed build raises;
nothing falls back to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# C entry points of each source: name -> argtypes (restype is int, the
# cudaGetLastError() of the launch).
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "tpf_match": {
        "brtpf_tpf_match": (_P, _P, _P, _LL, _P),
    },
    "bindjoin": {
        "brtpf_bindjoin": (_P,) * 9 + (_LL, _I, _P),
        "brtpf_bindjoin_grouped": (_P,) * 10 + (_LL,) + (_I,) * 6 + (_P,),
        "brtpf_bindjoin_fused": (_P,) * 10 + (_LL,) + (_I,) * 7 + (_P,),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build from source on a machine with the CUDA "
                       "toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_all() -> Dict[str, str]:
    """Compile every source that has no current library, in parallel,
    and load all of them. Returns ``{name: ptxas report}`` for the
    sources compiled by this call (empty for those already built).
    Raises ``RuntimeError`` with the compiler's output on failure."""
    with _lock:
        todo = {name: _lib_path(name) for name in SIGNATURES
                if name not in _libs}
        pending = {name: path for name, path in todo.items()
                   if not path.is_file()}
        reports: Dict[str, str] = {}
        if pending:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name, path in pending.items():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC_DIR / f"{name}.cu")]
                procs[name] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                reports[name] = out
                if proc.returncode != 0:
                    failed.append(f"{name}.cu (exit {proc.returncode}):\n"
                                  f"{out}")
                else:
                    os.replace(tmp, pending[name])
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name, path in todo.items():
            _libs[name] = _load(name, path)
        return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

