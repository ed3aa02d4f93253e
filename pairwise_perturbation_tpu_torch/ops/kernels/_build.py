"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into an object file,
one process per source, all started together, and links the objects into
one shared library with a plain C interface, which is loaded with ctypes:
no PyTorch headers, so a build takes seconds. The library lands in
``build/kernels/`` at the root of the checkout (listed in .gitignore),
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused. A missing ``nvcc`` or a failed build
raises: there is no fallback.
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
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lib: Optional[ctypes.CDLL] = None
build_log = ""        # nvcc's output (ptxas register/shared-memory report)
build_seconds = 0.0   # time of the last compile, 0 when reused


def find_nvcc() -> Optional[str]:
    """``nvcc`` on PATH, else the toolkit's default location."""
    path = shutil.which("nvcc")
    if path:
        return path
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.access(default, os.X_OK) else None


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):  # sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libppkernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of these sources exists."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from ops/kernels/csrc at first use and need "
            "the CUDA toolkit")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(dir=_BUILD_DIR)
    try:
        t0 = time.perf_counter()
        objs = [os.path.join(work, src.stem + ".o") for src in _sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_sources(), objs)]
        logs = [(p.args, p.communicate()[0], p.returncode) for p in procs]
        tmp = os.path.join(work, out.name)
        if all(rc == 0 for _, _, rc in logs):
            link = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, proc.stdout + proc.stderr, proc.returncode))
        build_seconds = time.perf_counter() - t0
        build_log = "".join(log for _, log, _ in logs)
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}"
                                   f"\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """The kernels' library with every entry's argtypes set (built on
    first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.pp_mttkrp3_rows.argtypes = [p, p, p, p, p, i64, i64, i64, i32, i64,
                                    i64, i32, i32, i32, i32, i32, i32, i64,
                                    i32, p]
    lib.pp_mttkrp3_rows.restype = i32
    lib.pp_mttkrp3_mode2.argtypes = [p, p, p, p, p, i64, i64, i64, i32, i32,
                                     i32, i32, i32, i32, i64, i64, i32, i32,
                                     p]
    lib.pp_mttkrp3_mode2.restype = i32
    lib.pp_mttkrp3_prepare.argtypes = [i32, i32, i32]
    lib.pp_mttkrp3_prepare.restype = i32
    lib.pp_mid_contract.argtypes = [p, i32, p, p, i64, i64, i64, i32, i32,
                                    i32, p]
    lib.pp_mid_contract.restype = i32
    lib.pp_mid_contract_mma.argtypes = [p, p, i64, p, i64, i64, i64, i32,
                                        i32, i32, p]
    lib.pp_mid_contract_mma.restype = i32
    lib.pp_mid_contract_f32v.argtypes = [p, p, p, i64, i64, i64, i32, i32,
                                         i32, p]
    lib.pp_mid_contract_f32v.restype = i32
    lib.pp_last_contract.argtypes = [p, i32, p, p, p, i64, i64, i32, i64,
                                     i32, i32, i32, i64, p]
    lib.pp_last_contract.restype = i32
    lib.pp_last_contract_mma.argtypes = [p, p, i64, p, p, i64, i64, i32, i64,
                                         i32, i32, i64, p]
    lib.pp_last_contract_mma.restype = i32
    lib.pp_column_sum.argtypes = [p, p, i64, i64, i64, p]
    lib.pp_column_sum.restype = i32
    lib.pp_chain_step.argtypes = [p, p, p, p, i64, i64, i64, i64, i32, i32,
                                  i32, i32, i32, p]
    lib.pp_chain_step.restype = i32
    lib.pp_coo_mttkrp.argtypes = [ctypes.POINTER(i64), ctypes.POINTER(p), p,
                                  p]
    lib.pp_coo_mttkrp.restype = i32
    lib.pp_coo_blocks.argtypes = [ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.pp_coo_blocks.restype = i32
    lib.pp_cuda_error_string.argtypes = [i32]
    lib.pp_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (the kernels' launch plans
    size their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, without making
    a ``torch.cuda.Stream`` object (the cheapest query on the launch
    path)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a nonzero cudaError_t."""
    if code != 0:
        msg = lib.pp_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
