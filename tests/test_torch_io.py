"""The port's dataset loaders, checkpoints, device traces and dashboard
(utils/io.py, utils/tracing.py, utils/dashboard.py, and the CLI flags
-tensor o1/o2, -tensorfile, -checkpoint, -resume, -profile 1 -trace_dir)
against the JAX package, on the CPU.

The io and dashboard copies are held to their originals: the same bytes
written, the same arrays read (native loader and memmap paths), the same
CSV parse. CLI runs in float64 from one file or one checkpoint must give
CSVs that agree but for [dtime] to rel 1e-8; checkpoints of the two
packages' runs from the same start agree to rel 1e-8.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu import native as jnative
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu.ops import sparse as jsp
from pairwise_perturbation_tpu.utils import dashboard as jdash
from pairwise_perturbation_tpu.utils import io as jio
from pairwise_perturbation_tpu.utils import layout as jlayout
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch import native as tnative
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.ops import sparse as tsp
from pairwise_perturbation_tpu_torch.utils import dashboard as tdash
from pairwise_perturbation_tpu_torch.utils import io as tio
from pairwise_perturbation_tpu_torch.utils import tracing

from test_torch_partupdate import _csv, _jax_factors, assert_same_csv
from test_torch_sparse_tucker import jax_rows

torch.set_num_threads(1)

# Small stand-ins for the datasets' file shapes: coil-100's minor mode
# stays 128 wide, so the JAX package's tiling permutation is the identity
# as at the real shape; time-lapse's (5, 12, 8, 3) is permuted by it.
COIL_FILE = (128, 8, 8, 3)
LAPSE_FILE = (3, 8, 12, 5)


@pytest.fixture
def small_datasets(monkeypatch):
    """Both packages' dataset file shapes patched to the small ones."""
    for mod in (jio, tio):
        monkeypatch.setattr(mod, "COIL100_FILE_SHAPE", COIL_FILE)
        monkeypatch.setattr(mod, "TIME_LAPSE_FILE_SHAPE", LAPSE_FILE)


def _dataset(tmp_path, file_shape, seed=0):
    """A seeded non-negative float64 array in a file's row-major shape,
    written by the port, and the file's path."""
    arr = np.random.default_rng(seed).random(file_shape) * 255
    path = str(tmp_path / f"data{seed}.bin")
    tio.write_dense_binary(path, arr)
    return arr, path


def test_io_constants_match_original():
    for name in ("COIL100_SHAPE", "COIL100_FILE_SHAPE", "TIME_LAPSE_SHAPE",
                 "TIME_LAPSE_FILE_SHAPE"):
        assert getattr(tio, name) == getattr(jio, name)
    for port, orig in ((tio.COIL100_SHAPE, tio.COIL100_FILE_SHAPE),
                       (tio.TIME_LAPSE_SHAPE, tio.TIME_LAPSE_FILE_SHAPE)):
        assert port == orig[::-1]


@pytest.mark.parametrize("src,file_dtype", [
    (np.float64, "<f8"), (np.float32, "<f8"), (np.float64, "<f4")])
def test_write_dense_binary_same_bytes(tmp_path, src, file_dtype):
    V = np.random.default_rng(1).standard_normal((3, 4, 5)).astype(src)
    tio.write_dense_binary(str(tmp_path / "t.bin"), V, file_dtype)
    jio.write_dense_binary(str(tmp_path / "j.bin"), V, file_dtype)
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()


@pytest.mark.parametrize("out_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("route", ["native", "memmap"])
def test_read_dense_binary_matches_original(tmp_path, monkeypatch, route,
                                            out_dtype):
    """Both copies read the same array, through the native loader (the
    port's own bindings) or, with it unavailable, the chunked memmap."""
    arr, path = _dataset(tmp_path, (6, 5, 7))
    names = ("load_f64_as_f32", "load_f64")
    if route == "memmap":
        for mod in (tnative, jnative):
            for n in names:
                monkeypatch.setattr(mod, n, lambda *a, **k: None)
    else:
        assert tnative.available()
        used = []
        for n in names:
            real = getattr(tnative, n)
            monkeypatch.setattr(tnative, n, lambda *a, _r=real, _n=n, **k:
                                used.append(_n) or _r(*a, **k))
    got = tio.read_dense_binary(path, arr.shape, out_dtype=out_dtype,
                                chunk_elems=37)
    want = jio.read_dense_binary(path, arr.shape, out_dtype=out_dtype,
                                 chunk_elems=37)
    assert got.dtype == want.dtype == out_dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr.astype(out_dtype))
    if route == "native":
        assert used == [names[out_dtype == np.float64]]


@pytest.mark.parametrize("loader,file_shape", [
    ("load_coil100", COIL_FILE), ("load_time_lapse", LAPSE_FILE)])
def test_dataset_loaders_match_original(tmp_path, small_datasets, loader,
                                        file_shape):
    """The file's array with its axes reversed (the CTF-declared order),
    in both copies and both dtypes."""
    arr, path = _dataset(tmp_path, file_shape)
    for dt in (np.float32, np.float64):
        got = getattr(tio, loader)(path, out_dtype=dt)
        np.testing.assert_array_equal(got, getattr(jio, loader)(
            path, out_dtype=dt))
        np.testing.assert_array_equal(got, arr.transpose(3, 2, 1, 0)
                                      .astype(dt))
        assert got.flags.c_contiguous


@pytest.mark.parametrize("kind", ["coil100", "time_lapse"])
def test_dataset_builders_write_the_same_bytes(tmp_path, kind):
    """build_coil100_binary (PNGs of other sizes and modes, resized to
    128 x 128 RGB) and build_time_lapse_binary (.mat files, one array
    each) write the JAX package's bytes from the same small files."""
    rng = np.random.default_rng(5)
    src = tmp_path / "src"
    src.mkdir()
    if kind == "coil100":
        from PIL import Image
        for i, (size, mode) in enumerate([((20, 16), "RGB"),
                                          ((128, 128), "RGB"),
                                          ((33, 40), "L")]):
            shape = size[::-1] + ((3,) if mode == "RGB" else ())
            Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8),
                            mode).save(src / f"obj{i}__0.png")
        (src / "notes.txt").write_text("not an image")
    else:
        from scipy.io import savemat
        for i in range(3):
            savemat(src / f"scene_{i}.mat", {"hsi": rng.random((4, 5, 6))})
    build = f"build_{kind}_binary"
    outs = [str(tmp_path / f"{who}.bin") for who in ("jax", "port")]
    assert getattr(jio, build)(str(src), outs[0]) == outs[0]
    assert getattr(tio, build)(str(src), outs[1]) == outs[1]
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        want, got = a.read(), b.read()
    assert got == want
    assert len(got) == 8 * (3 * 128 * 128 * 3 if kind == "coil100"
                            else 3 * 4 * 5 * 6)


def test_checkpoint_files_load_in_either_package(tmp_path):
    rng = np.random.default_rng(2)
    factors = [rng.random((s, 3)) for s in (4, 5, 6)]
    core = rng.random((3, 3, 3))
    meta = dict(model="Tucker", tensor="o2", sparse=True)
    for save, load, name in ((tio.save_checkpoint, jio.load_checkpoint, "t"),
                             (jio.save_checkpoint, tio.load_checkpoint, "j")):
        save(str(tmp_path / name), factors, 7, core=core, meta=meta)
        ck = load(str(tmp_path / name))
        assert ck["iteration"] == 7 and ck["meta"] == meta
        for a, b in zip(ck["factors"], factors):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ck["core"], core)
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert t.files == j.files
    for k in t.files:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])
    tio.save_checkpoint(str(tmp_path / "cp.npz"), factors, 3)
    ck = jio.load_checkpoint(str(tmp_path / "cp.npz"))
    assert ck["core"] is None and ck["meta"] == {}


O1_ARGV = ["test_als", "-model", "CP", "-tensor", "o1", "-rank", "3",
           "-maxiter", "8", "-resprint", "2", "-pp_res_tol", "0.1",
           "-dtype", "float64"]


@pytest.mark.parametrize("pp", ["0", "1"])
def test_cli_tensor_o1_csv_matches_jax(tmp_path, monkeypatch, small_datasets,
                                       pp):
    """-tensor o1 from one small coil-100-shaped file, through both CLIs
    in float64 from the JAX package's initial factors."""
    monkeypatch.setattr(tcp, "init_factors", _jax_factors)
    _, path = _dataset(tmp_path, COIL_FILE)
    argv = O1_ARGV + ["-pp", pp, "-tensorfile", path]
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    assert_same_csv(got, want)
    assert got[1][0] == "3"                 # [dim]: the channel mode


@pytest.mark.parametrize("bad", ["missing", "short"])
def test_cli_dataset_file_is_checked(tmp_path, small_datasets, bad):
    path = str(tmp_path / "coil.bin")
    if bad == "short":
        tio.write_dense_binary(path, np.zeros(100))
    with pytest.raises(SystemExit, match="not a float64 binary"):
        cli.main(O1_ARGV + ["-tensorfile", path, "-device", "cpu",
                            "-filename", str(tmp_path / "x.csv")])


def _ckpt(path):
    ck = jio.load_checkpoint(str(path))
    return ck["factors"], ck["core"], ck["iteration"], ck["meta"]


def _assert_same_ckpt(got, want, tol=1e-8):
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(b))
    assert len(got[0]) == len(want[0]) and got[2:] == want[2:]


CKPT_RUNS = {
    "cp": ["-model", "CP", "-tensor", "r", "-dim", "4", "-size", "6",
           "-rank", "3", "-pp", "1"],
    "cp_sparse": ["-model", "CP", "-tensor", "p", "-dim", "8", "-size", "3",
                  "-rank", "3", "-pp", "1", "-issparse", "1"],
    "tucker": ["-model", "Tucker", "-tensor", "r2", "-dim", "4", "-size",
               "8", "-rank", "3", "-pp", "1"],
    "tucker_sparse": ["-model", "Tucker", "-tensor", "p", "-dim", "6",
                      "-size", "6", "-rank", "1", "-pp", "1", "-issparse",
                      "1"],
}


@pytest.mark.parametrize("kind", list(CKPT_RUNS))
def test_cli_checkpoint_matches_jax(tmp_path, monkeypatch, kind):
    """-checkpoint of test_als through both CLIs in float64 (CP from the
    JAX package's factors, sparse Tucker from its sketch rows): the same
    npz keys, factors and Tucker core to rel 1e-8, iteration and meta."""
    monkeypatch.setattr(tcp, "init_factors", _jax_factors)

    def rows_of_jax(st, mode, k, seed):
        st_j = jsp.SparseTensor(jnp.asarray(st.indices.numpy()),
                                jnp.asarray(st.values.numpy()), st.shape)
        key = jax.random.split(jax.random.PRNGKey(0), st.ndim)[seed]
        return jax_rows(st_j, mode, k, key)

    monkeypatch.setattr(tsp, "sketch_rows", rows_of_jax)
    argv = ["test_als", *CKPT_RUNS[kind], "-maxiter", "10", "-resprint",
            "2", "-pp_res_tol", "0.1", "-dtype", "float64"]
    _csv(cli.main, tmp_path / "port.csv",
         argv + ["-device", "cpu", "-checkpoint", str(tmp_path / "port")])
    _csv(jcli.main, tmp_path / "jax.csv",
         argv + ["-checkpoint", str(tmp_path / "jax")])
    got, want = _ckpt(tmp_path / "port.npz"), _ckpt(tmp_path / "jax.npz")
    _assert_same_ckpt(got, want)
    assert got[3]["model"] == CKPT_RUNS[kind][1]
    assert ("core" in np.load(tmp_path / "port.npz")) == \
        kind.startswith("tucker")


RESUME_ARGV = ["test_als", "-model", "CP", "-tensor", "r", "-dim", "4",
               "-size", "6", "-rank", "3", "-pp", "1", "-maxiter", "6",
               "-resprint", "1", "-pp_res_tol", "0.1", "-dtype", "float64"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cli_resume_matches_jax(tmp_path, capsys, writer):
    """-checkpoint from one package's own run (its own initial draws),
    then -resume from that file through both CLIs in float64: the CSVs
    agree but for [dtime], and the first row is the diagnostics of the
    checkpoint's factors."""
    ck = str(tmp_path / "ck")
    main, extra = ((cli.main, ["-device", "cpu"]) if writer == "port"
                   else (jcli.main, []))
    _csv(main, tmp_path / "first.csv", RESUME_ARGV + extra
         + ["-checkpoint", ck])
    argv = RESUME_ARGV + ["-resume", ck + ".npz"]
    capsys.readouterr()
    assert cli.main(argv + ["-device", "cpu", "-filename",
                            str(tmp_path / "port.csv")]) == 0
    factors, _, iteration, _ = _ckpt(ck)
    assert f"resumed 4 factors from {ck}.npz (iteration {iteration})" in \
        capsys.readouterr().out
    with open(tmp_path / "port.csv") as fh:
        got = list(csv.reader(fh))
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    assert_same_csv(got, want)
    from pairwise_perturbation_tpu_torch.ops import contract
    from pairwise_perturbation_tpu_torch.utils import synth
    V = torch.from_numpy(synth.make_tensor("r", 4, 6, 3, dtype=np.float64))
    gn, _ = tcp.cp_diagnostics(contract.norm_sq(V), V,
                               [torch.from_numpy(f) for f in factors], 0.0)
    assert float(got[1][2]) == pytest.approx(float(gn), rel=1e-12)


def test_cli_resume_checks_mode_sizes(tmp_path):
    tio.save_checkpoint(str(tmp_path / "ck"), [np.ones((5, 3))] * 4, 1)
    with pytest.raises(SystemExit, match="mode sizes"):
        cli.main(RESUME_ARGV + ["-resume", str(tmp_path / "ck"), "-device",
                                "cpu", "-filename", str(tmp_path / "x.csv")])


def test_o2_checkpoint_of_permuted_jax_run_resumes_in_natural_order(
        tmp_path, monkeypatch, small_datasets):
    """C10: the JAX CLI permutes a time-lapse-shaped tensor's modes (here
    by (0, 3, 1, 2), as at the real shape) and writes its checkpoint back
    in the natural order; the port, which never permutes, resumes from it
    as it is, and its first row is the gradnorm of those factors, which
    the JAX package computes on its permuted tensor too."""
    perm = (0, 3, 1, 2)
    monkeypatch.setattr(jlayout, "canonical_perm_or_identity",
                        lambda shape, threshold=1.10: perm)
    _, path = _dataset(tmp_path, LAPSE_FILE)
    argv = ["test_als", "-model", "CP", "-tensor", "o2", "-tensorfile", path,
            "-rank", "3", "-pp", "1", "-maxiter", "4", "-resprint", "1",
            "-pp_res_tol", "0.1", "-dtype", "float64"]
    ck = str(tmp_path / "ck")
    _csv(jcli.main, tmp_path / "jax.csv", argv + ["-checkpoint", ck])
    factors = _ckpt(ck)[0]
    assert [f.shape[0] for f in factors] == list(LAPSE_FILE[::-1])
    got = _csv(cli.main, tmp_path / "port.csv",
               argv + ["-resume", ck, "-device", "cpu"])
    V = jio.load_time_lapse(path, out_dtype=np.float64)
    Vp = jnp.asarray(np.transpose(V, perm))
    gn, _ = jcp.cp_diagnostics(jnp.sum(Vp * Vp), Vp,
                               [jnp.asarray(factors[m]) for m in perm],
                               jnp.asarray(0.0))
    assert float(got[1][2]) == pytest.approx(float(gn), rel=1e-10)
    assert got[1][0] == str(LAPSE_FILE[-1])      # [dim]: the natural mode 0


@pytest.mark.parametrize("profile", ["0", "1"])
def test_cli_trace_dir_writes_only_under_profile(tmp_path, capsys, profile):
    """-trace_dir writes a Chrome-trace JSON of the command, with its
    ``cli.test_als`` range, only with -profile 1 (JAX cli.py:611-625)."""
    tdir = tmp_path / "traces"
    try:
        assert cli.main(["test_als", "-tensor", "r", "-dim", "3", "-size",
                         "8", "-rank", "2", "-maxiter", "2", "-profile",
                         profile, "-trace_dir", str(tdir), "-device", "cpu",
                         "-filename", str(tmp_path / "x.csv")]) == 0
    finally:
        tracing.enable(False)
    out = capsys.readouterr().out
    if profile == "0":
        assert not tdir.exists() and "device trace" not in out
        return
    files = list(tdir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert f"device trace written to {files[0]}" in out
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "cli.test_als" for e in events)


def test_annotate_is_a_named_range(tmp_path):
    with tracing.device_trace(str(tmp_path)) as path:
        with tracing.annotate("pp.region"):
            torch.ones(4).sum()
    names = {e.get("name") for e in json.loads(
        open(path).read())["traceEvents"]}
    assert "pp.region" in names


def test_dashboard_copy_matches_original(tmp_path):
    """_read_csv and render of the copy on a port CSV, against the
    original's."""
    root = tmp_path / "results"
    root.mkdir()
    _csv(cli.main, root / "run.csv",
         ["run", "-tensor", "r", "-dim", "3", "-size", "6", "-rank", "2",
          "-pp", "4", "-maxiter", "4", "-resprint", "1", "-device", "cpu"])
    (root / "junk.csv").write_text("a,b\n1,2\n")
    got = tdash._read_csv(str(root / "run.csv"))
    assert got == jdash._read_csv(str(root / "run.csv"))
    assert got["name"] == "run" and len(got["iter"]) == 5
    assert tdash._read_csv(str(root / "junk.csv")) is None
    outs = [str(tmp_path / "t.png"), str(tmp_path / "j.png")]
    assert tdash.render(str(root), outs[0]) == \
        jdash.render(str(root), outs[1]) == 1
    assert all(os.path.getsize(p) > 0 for p in outs)
