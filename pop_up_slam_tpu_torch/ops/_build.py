"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into ``pop_up_slam_tpu_torch/_build/<hash>/libpopup_kernels.so``,
where ``<hash>`` covers every source and the flags, and loaded with
``ctypes`` (plain C interface, no PyTorch headers: the build takes
seconds).  Each ``.cu`` compiles in its own ``nvcc`` process, all started
together, then one link.  A failed build raises; nothing falls back.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("chol_solve.cu", "depth_render.cu", "fused_gn.cu", "lm_step.cu",
           "marginal.cu", "plane_terms.cu", "schur_reduce.cu")
HEADERS = ("chol.cuh", "factor_graph.cuh", "lie.cuh", "marginal.cuh",
           "plane_factor.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "popup_chol_solve": [_P, _P, _P, _P, _I, _P],
    "popup_depth_render": [_P] * 11 + [_I, _P, _P, _I, _I, _F, _F, _F, _P],
    "popup_fused_gn_smem_bytes": [_I, _I, _I, _I, _I],
    "popup_fused_gn": [_P] * 4,
    "popup_plane_terms": [_P] * 9 + [_I] * 4 + [_P, _P],
    "popup_schur_reduce_small": [_P] * 8 + [_I, _I, _P, _P],
    "popup_schur_gemm": [_P] * 4 + [_I, _I, _P],
    "popup_lm_smem_bytes": [_I] * 6,
    "popup_lm_assemble": [_P] * 4,
    "popup_lm_trial": [_P] * 4,
    "popup_marginal": [_P] * 3,
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for name, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        lib_tmp = Path(tmp) / "libpopup_kernels.so"
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *[str(o) for _, o, _ in procs], "-o", str(lib_tmp)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(lib_tmp, out)
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _lib
    if _lib is not None:
        return _lib
    key = _source_hash()
    out_dir = BUILD_ROOT / key
    so = out_dir / "libpopup_kernels.so"
    t0 = time.perf_counter()
    built = False
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        log = _compile(so)
        (out_dir / "build.log").write_text(log)
        built = True
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(path=str(so), built=built,
                      seconds=time.perf_counter() - t0)
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def check_inputs(name: str, dev, *specs) -> None:
    """Raise unless every ``(tensor, shape[, dtype])`` spec lies on
    ``dev``, has that shape and dtype (float32 where none is given) and is
    contiguous: one test per tensor on the launch path (host time), the
    reason only on failure."""
    for spec in specs:
        x, shape = spec[0], spec[1]
        dtype = spec[2] if len(spec) > 2 else torch.float32
        if (x.dtype == dtype and x.shape == shape and x.is_contiguous()
                and x.device == dev):
            continue
        if x.device != dev:
            raise ValueError(f"{name}: all inputs must lie on {dev}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, want "
                             f"{tuple(shape)}")
        if x.dtype != dtype:
            raise ValueError(f"{name}: {x.dtype}, want {dtype}")
        raise ValueError(f"{name}: inputs must be contiguous")


def check_stamps(name: str, stamps, dev, slots: int) -> None:
    """Raise unless the optional phase-stamp buffer is None or an int64
    tensor of ``slots`` on ``dev``."""
    if stamps is not None and (stamps.device != dev
                               or stamps.dtype != torch.int64
                               or stamps.shape != (slots,)):
        raise ValueError(f"{name}: stamps must be int64 ({slots},) on {dev}")
