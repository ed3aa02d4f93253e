"""What the benchmark scripts share: their arguments, the clock, the rows
they print and the kernel launches each row made.

The clock is the device's on a card (CUDA events around each call, median
of ``--n`` calls after ``WARMUP`` untimed ones) and the host's on the CPU
(``time.perf_counter`` around each call, same median). A row records the
launches of every kernel module made while it ran, read from the modules'
own counters, so a caller can tell which kernel each row went through.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.ops.kernels import (
    chain_step, column_sum, coo_mttkrp, last_contract, mid_contract, mttkrp3,
    triple_roots)

COIL_SHAPE = (3, 128, 128, 7200)
WARMUP = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
_MODULES = {"mttkrp3": mttkrp3, "mid_contract": mid_contract,
            "last_contract": last_contract, "column_sum": column_sum,
            "triple_roots": triple_roots, "coo_mttkrp": coo_mttkrp,
            "chain_step": chain_step}


class DeviceError(RuntimeError):
    """The device asked for cannot be used."""


def launch_counts() -> Dict[str, int]:
    """Every kernel module's launch counters, as "module.counter"."""
    return {f"{name}.{k}": n for name, mod in _MODULES.items()
            for k, n in mod.LAUNCHES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.reset_launch_counts()


@contextlib.contextmanager
def warm_launches():
    """Inside: every engine warm-up (models/cp.warm_run) adds the kernel
    launches it made to the yielded dict ("module.counter" -> launches),
    so that a launch count can be held to its scopes with the warm-ups'
    launches apart."""
    from pairwise_perturbation_tpu_torch.models import cp
    out: Dict[str, int] = {}
    real = cp.warm_run

    def counted(fn, *args, **kwargs):
        before = launch_counts()
        try:
            return real(fn, *args, **kwargs)
        finally:
            for k, n in launch_counts().items():
                if n != before.get(k, 0):
                    out[k] = out.get(k, 0) + n - before.get(k, 0)

    cp.warm_run = counted
    try:
        yield out
    finally:
        cp.warm_run = real


def _shape(text: str):
    return tuple(int(s) for s in text.split(","))


def parse(description: str, argv: Optional[Sequence[str]],
          extra: Callable[[argparse.ArgumentParser], None] = None):
    p = argparse.ArgumentParser(description=description.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu runs the kernels' plain "
                        "versions and times with the host clock")
    p.add_argument("--shape", type=_shape, default=COIL_SHAPE,
                   help="order-4 tensor shape, comma-separated "
                        "(default: the coil-100 shape 3,128,128,7200)")
    p.add_argument("--rank", type=int, default=10)
    p.add_argument("--n", type=int, default=20, help="timed calls per row")
    p.add_argument("--seed", type=int, default=0)
    if extra is not None:
        extra(p)
    args = p.parse_args(argv)
    if len(args.shape) != 4:
        p.error(f"--shape needs 4 sizes, got {args.shape}")
    return args


class Bench:
    """Rows of one script run, printed as they are made."""

    def __init__(self, device: str, n: int):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise DeviceError("torch.cuda.is_available() is False: "
                                  "pass --device cpu to run on the CPU")
            config.apply_fp32_pins()
            self.device_name = torch.cuda.get_device_name(self.device)
        elif self.device.type == "cpu":
            self.device_name = "cpu"
        else:
            raise DeviceError(f"--device {device}: cuda or cpu")
        self.n = n
        self.rows: List[dict] = []
        self.ok = True
        print(f"device: {self.device_name}")

    def _clock(self, fn) -> float:
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)

    def _row(self, name: str, kernel: Optional[str], before, **fields):
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        row = dict(name=name, kernel=kernel, launches=launches, **fields)
        self.rows.append(row)
        return row

    def time(self, name: str, fn, kernel: str = None, n: int = None,
             nbytes: float = None) -> float:
        """Median ms of ``fn`` over ``n`` calls after the warm-up; with
        ``nbytes``, also the rate those bytes make."""
        before = launch_counts()
        for _ in range(WARMUP):
            fn()
        ms = statistics.median(self._clock(fn) for _ in range(n or self.n))
        print(f"{name:46s} {ms:9.3f} ms")
        fields = dict(ms=ms)
        if nbytes is not None:
            fields["gb_per_s"] = nbytes / ms / 1e6
            line = f"   -> {fields['gb_per_s']:.0f} GB/s"
            if self.device.type == "cuda":
                line += (f" ({100 * nbytes / ms / 1e-3 / HBM_BYTES_PER_S:.1f}%"
                         " of 3.35 TB/s)")
            print(line)
        self._row(name, kernel, before, **fields)
        return ms

    def check(self, name: str, got_fn, want_fn, tol: float,
              kernel: str = None) -> bool:
        """Max abs and relative (to want's max) error of ``got_fn()``
        against ``want_fn()``, tensors or lists or dicts of them; fails
        the run above ``tol`` or on a non-finite value."""
        before = launch_counts()
        got, want = got_fn(), want_fn()
        if isinstance(want, dict):
            pairs = [(got[k], want[k]) for k in want]
        elif isinstance(want, (list, tuple)):
            pairs = list(zip(got, want, strict=True))
        else:
            pairs = [(got, want)]
        abs_err = rel = 0.0
        finite = True
        for g, w in pairs:
            g, w = g.float(), w.float()
            finite &= bool(torch.isfinite(g).all())
            a = float((g - w).abs().max())
            abs_err = max(abs_err, a)
            rel = max(rel, a / max(float(w.abs().max()), 1e-30))
        ok = finite and rel <= tol
        self.ok &= ok
        print(f"   {name}: {abs_err:.3e} (rel {rel:.3e}, tol {tol:g})"
              + ("" if ok else "  EXCEEDS TOLERANCE" if finite
                 else "  NON-FINITE"))
        self._row(name, kernel, before, max_abs_err=abs_err, rel_err=rel,
                  tol=tol, ok=ok)
        return ok

    def finish(self) -> int:
        print(json.dumps({"device": self.device_name, "ok": self.ok,
                          "rows": self.rows}))
        return 0 if self.ok else 1


def main_of(run) -> Callable[[Optional[Sequence[str]]], int]:
    """The script's ``main``: ``run(argv)`` -> (code, rows), with a refused
    device reported on stderr as code 2."""
    def main(argv: Optional[Sequence[str]] = None) -> int:
        try:
            return run(argv)[0]
        except DeviceError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
    return main
