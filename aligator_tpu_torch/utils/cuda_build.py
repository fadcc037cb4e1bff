"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (``build/kernels/<name>-<hash>.so``
at the root of the checkout) and loaded with ``ctypes``. The build runs
at first use: :func:`build_all` starts one ``nvcc`` per source, all at
once, and waits for them. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
_P, _I = ctypes.c_void_p, ctypes.c_int
# The C functions of each source: name -> (argtypes, restype), set once at
# load. Pointers and the stream are void*, dims and counts int.
SIGNATURES = {
    "riccati_backward": {
        "riccati_backward_smem_bytes": ([_I] * 3, ctypes.c_longlong),
        "riccati_backward_variant": ([_I] * 3, _I),
        "riccati_backward_cluster": ([_I] * 5, _I),
        "riccati_backward_blocks_per_sm": ([_I] * 3, _I),
        "riccati_backward_max_clusters": ([_I] * 4, _I),
        "riccati_backward_f32": ([_P] * 20 + [_I] * 7 + [_P], _I),
    },
    "riccati_forward": {
        "riccati_forward_plan": ([_I] * 2, _I),
        "riccati_forward_small_stages": ([_I] * 5, _I),
        "riccati_forward_smem_bytes": ([_I] * 5, ctypes.c_longlong),
        "riccati_forward_blocks_per_sm": ([_I] * 5, _I),
        "riccati_forward_small_f32": ([_P] * 14 + [_I] * 8 + [_P], _I),
        "riccati_forward_chain_f32": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "riccati_forward_rows_f32": ([_P] * 11 + [_I] * 6 + [_P], _I),
    },
    "layout_probe": {
        "probe_batched_mm_f32": ([_P] * 3 + [_I] * 5 + [_P], _I),
        "probe_shared_mm_f32": ([_P] * 3 + [_I] * 4 + [_P], _I),
        "probe_transpose_f32": ([_P] * 2 + [_I] * 4 + [_P], _I),
        "probe_bcast_fma_f32": ([_P] * 3 + [_I] * 4 + [_P], _I),
        "probe_slab_reduce_f32": ([_P] * 2 + [_I] * 4 + [_P], _I),
        "probe_lanes_apply_f32": ([_P] * 3 + [_I] * 3 + [_P], _I),
    },
}
SOURCES = tuple(SIGNATURES)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> Dict[str, str]:
    """Compile every missing library in parallel; returns each source's
    compiler log (ptxas register/shared-memory report included)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in SOURCES if not _target(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed,
    with its functions' argument and result types set."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib
