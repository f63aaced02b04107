"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Every ``csrc/*.cu`` compiles to an object for ``sm_90a`` (one ``nvcc`` per
source, all started together), and the objects link into one shared
library with a plain C interface.  The library is built at first use into
``build/repro_torch/`` at the repository root (listed in ``.gitignore``),
named by a digest of the sources and flags, so an edited source rebuilds
and an unchanged one loads at once.  ``--use_fast_math`` is deliberately
absent: it flushes subnormals and contracts the multiplies and adds the
Goldschmidt peel keeps apart.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

from repro_torch.core.goldschmidt import VARIANTS

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # x, gain, rom, out, inv_out, rows, d, inv_d, eps, p, iters, pipelined,
    # rsqrt_scale, is_bf16, stream
    "gs_rmsnorm_launch": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _I, _F, _I, _P],
    # q, k, v, rom, out, m_out, l_out, B, H, KH, S, D, sm_scale, causal, p,
    # iters, pipelined, is_bf16, stream
    "flash_attention_fwd": [_P] * 7 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
    # q, k, v, dout, m, l, delta, rom, dq, B, H, KH, S, D, sm_scale, causal,
    # p, iters, pipelined, is_bf16, stream
    "flash_attention_bwd_dq": [_P] * 9 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
    # as above with dk, dv in place of dq
    "flash_attention_bwd_dkv": [_P] * 10 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
    # param, grad, m, v, bc, rom_recip, rom_rsqrt, p_out, m_out, v_out, n,
    # beta1, 1-beta1, beta2, 1-beta2, eps, weight_decay, p, iters, pipelined,
    # rsqrt_scale, stream
    "gs_adam_launch": [_P] * 10 + [_L] + [_F] * 6 + [_I] * 3 + [_F, _P],
    # x, inv_scale, words, out, n, frac_bits, p, iters, pipelined,
    # mitchell_iters, stream
    "gs_fixed_recip_launch": [_P] * 4 + [_L] + [_I] * 5 + [_P],
    # x, scale, words, out, rows, d, frac_bits, p, iters, pipelined,
    # mitchell_iters, stream
    "gs_fixed_softmax_launch": [_P] * 4 + [_I] * 7 + [_P],
    # x, scale, gain, words, out, rows, d, inv_d, eps, frac_bits, p, iters,
    # stream
    "gs_fixed_rmsnorm_launch": [_P] * 5 + [_I] * 2 + [_F] * 2 + [_I] * 3 + [_P],
}

_lib: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libgs_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless it is already built; returns it.

    The compiler's register and spill report goes to ``build.log`` beside
    the library.
    """
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen([nvcc, *FLAGS, "-I", str(CSRC), "-c", str(src),
                                   "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(sources(), procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, *FLAGS[:2], "-shared", *map(str, objs),
                               "-o", str(tmp_lib)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        (BUILD_DIR / "build.log").write_text("".join(logs))
        os.replace(tmp_lib, lib)
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


MAX_PIPELINED_ITERS = 4  # gs::kMaxPipelinedIters in csrc/gs_common.cuh


def check_datapath(p: int, iters: int, variant: str) -> None:
    """The Goldschmidt settings the CUDA helpers take: a ROM of 2^5..2^12
    entries, and at most four unrolled passes for ``pipelined``."""
    if not 5 <= p <= 12:
        raise ValueError(f"ROM width p={p} outside the kernels' range 5..12")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if iters < 0 or (variant == "pipelined" and iters > MAX_PIPELINED_ITERS):
        raise ValueError(f"iters={iters} unsupported for variant {variant}")


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")
