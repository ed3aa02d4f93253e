"""Dataset IO and solver checkpointing — copy of
``pairwise_perturbation_tpu/utils/io.py`` (numpy only; tests/test_torch_io.py
pins it to the original: the same bytes written, the same arrays read, and
checkpoints that either package loads).

Replaces the reference's MPI-IO path (``MPI_File_open`` +
``read_dense_from_file``, test_ALS.cxx:291-321) with host reads: the
port's threaded native loader (native/loader.cpp, ``native.load_f64_as_f32``
/ ``load_f64``) where it is built, else a memmap read converted chunk by
chunk, so the 2.8 GB f64 coil-100 file converts to f32 without a second
full-size temporary. Adds factor checkpointing, which the reference lacks.

Dataset layouts. The binaries are ROW-major float64 written by the
reference's script/imageloader.py ((7200, 128, 128, 3)) and
script/matloader.py ((9, 1024, 1344, 33)). CTF reads them into tensors
declared (3, 128, 128, 7200) / (33, 1344, 1024, 9) (test_ALS.cxx:293-316),
and CTF's global element order is COLUMN-major (first index fastest), so
the declared CTF shape is the file shape reversed over one byte stream.
The loaders read the file in its row-major shape and reverse the axes:
coil-100 (channel, col, row, image), time-lapse (band, col, row, time).
The port keeps that natural mode order everywhere (it has no TPU tiling to
permute for), and so do both packages' checkpoints.

``read_dense_sharded`` is the per-rank read of the parallel layer
(parallel/mesh.py): each rank reads only its block's span of the file and
returns it as a tensor; ``-mesh`` with ``-tensor o1/o2`` reads V through
it (cli._load_tensor_sharded, as JAX cli.py:80-110 loads it).
``build_coil100_binary`` / ``build_time_lapse_binary`` convert the
downloaded PNG and MAT files of the datasets into those binaries (PIL and
scipy imported when called, as in the JAX package).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np

COIL100_SHAPE = (3, 128, 128, 7200)          # CTF-declared mode order
COIL100_FILE_SHAPE = (7200, 128, 128, 3)     # row-major on disk
TIME_LAPSE_SHAPE = (33, 1344, 1024, 9)
TIME_LAPSE_FILE_SHAPE = (9, 1024, 1344, 33)


def read_dense_binary(path: str, shape: Sequence[int], file_dtype="<f8",
                      out_dtype=np.float32, chunk_elems: int = 1 << 24
                      ) -> np.ndarray:
    """Read a row-major dense binary into ``out_dtype`` without a full-size
    intermediate copy."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    # fast path: threaded native loader (native/loader.cpp)
    if np.dtype(file_dtype) == np.dtype("<f8"):
        from pairwise_perturbation_tpu_torch import native
        if np.dtype(out_dtype) == np.float32:
            out = native.load_f64_as_f32(path, shape)
            if out is not None:
                return out
        elif np.dtype(out_dtype) == np.float64:
            out = native.load_f64(path, shape)
            if out is not None:
                return out
    mm = np.memmap(path, dtype=file_dtype, mode="r", shape=(n,))
    out = np.empty(n, dtype=out_dtype)
    for lo in range(0, n, chunk_elems):
        hi = min(lo + chunk_elems, n)
        out[lo:hi] = mm[lo:hi]
    del mm
    return out.reshape(shape)


def write_dense_binary(path: str, V: np.ndarray, file_dtype="<f8") -> None:
    np.asarray(V, dtype=file_dtype).tofile(path)


def read_dense_sharded(path: str, layout, file_dtype="<f8",
                       out_dtype=np.float32, file_shape=None,
                       axes_perm=None, device="cuda"):
    """This rank's block of a row-major dense binary (JAX io.py:67-119).

    The replacement for the reference's MPI-IO collective read
    (``MPI_File_open`` + ``V.read_dense_from_file``, test_ALS.cxx:291-304):
    each rank memory-maps the file and reads ONLY its block's span (memmap
    slicing touches just those pages), so no rank holds the full tensor.
    ``layout`` is a ``parallel.mesh.ShardedLayout`` (from ``plan_layout``,
    whose mesh gives this rank's coordinate). ``file_shape``/``axes_perm``
    view the on-disk array through a transpose before the block is cut
    (``layout.orig_shape[i] == file_shape[axes_perm[i]]``). Returns the
    block zero-padded to the layout's padded block shape, in
    ``out_dtype``, as a tensor on ``device``."""
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    orig = tuple(layout.orig_shape)
    mm = np.memmap(path, dtype=file_dtype, mode="r",
                   shape=tuple(file_shape) if file_shape else orig)
    if axes_perm is not None:
        mm = mm.transpose(tuple(axes_perm))
        if mm.shape != orig:
            raise ValueError(f"axes_perm {tuple(axes_perm)} views the file "
                             f"as {mm.shape}, the layout has {orig}")
    try:
        return pmesh._padded_block(
            mm, [layout.span(m) for m in range(len(orig))], device,
            out_dtype)
    finally:
        del mm


def _load_ctf_ordered(path: str, file_shape, out_dtype):
    """Read a row-major binary and reverse axes to the CTF-declared mode
    order (column-major global order == reversed row-major shape)."""
    arr = read_dense_binary(path, file_shape, out_dtype=out_dtype)
    return np.ascontiguousarray(arr.transpose(range(arr.ndim - 1, -1, -1)))


def load_coil100(path: str = "coil-100.bin", out_dtype=np.float32):
    """-> (3, 128, 128, 7200): (channel, col, row, image)."""
    return _load_ctf_ordered(path, COIL100_FILE_SHAPE, out_dtype)


def load_time_lapse(path: str = "time-lapse.bin", out_dtype=np.float32):
    """-> (33, 1344, 1024, 9): (band, col, row, time)."""
    return _load_ctf_ordered(path, TIME_LAPSE_FILE_SHAPE, out_dtype)


# ---------------------------------------------------------------------------
# Dataset builders (replacements for script/imageloader.py, script/matloader.py)
# ---------------------------------------------------------------------------


def build_coil100_binary(png_dir: str, out_path: str = "coil-100.bin"):
    """PNG directory -> float64 binary of shape (7200, 128, 128, 3)
    (imageloader.py:26-31). Requires PIL."""
    from PIL import Image  # gated: PIL is optional
    files = sorted(f for f in os.listdir(png_dir) if f.endswith(".png"))
    arr = np.zeros((len(files), 128, 128, 3), dtype=np.float64)
    for i, f in enumerate(files):
        img = Image.open(os.path.join(png_dir, f)).convert("RGB")
        arr[i] = np.asarray(img.resize((128, 128)), dtype=np.float64)
    arr.tofile(out_path)
    return out_path


def build_time_lapse_binary(mat_dir: str, out_path: str = "time-lapse.bin"):
    """9 .mat HSI files -> float64 binary (9, 1024, 1344, 33)
    (matloader.py:1-45). Requires scipy."""
    from scipy.io import loadmat  # gated: scipy is optional
    files = sorted(f for f in os.listdir(mat_dir) if f.endswith(".mat"))
    out = None
    for i, f in enumerate(files):
        m = loadmat(os.path.join(mat_dir, f))
        key = [k for k in m if not k.startswith("__")][0]
        data = np.asarray(m[key], dtype=np.float64)
        if out is None:
            out = np.zeros((len(files),) + data.shape, dtype=np.float64)
        out[i] = data
    out.tofile(out_path)
    return out_path


# ---------------------------------------------------------------------------
# Checkpointing (new capability; reference persists nothing)
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, factors: Sequence, iteration: int,
                    core=None, meta: Optional[dict] = None) -> None:
    arrays = {f"W{i}": np.asarray(W) for i, W in enumerate(factors)}
    if core is not None:
        arrays["core"] = np.asarray(core)
    arrays["_iteration"] = np.asarray(iteration)
    arrays["_meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str):
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    factors: List[np.ndarray] = []
    i = 0
    while f"W{i}" in data:
        factors.append(data[f"W{i}"])
        i += 1
    core = data["core"] if "core" in data else None
    iteration = int(data["_iteration"])
    meta = json.loads(bytes(data["_meta"]).decode()) if "_meta" in data else {}
    return dict(factors=factors, core=core, iteration=iteration, meta=meta)
