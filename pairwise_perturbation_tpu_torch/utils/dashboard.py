"""Live convergence dashboard — copy of
``pairwise_perturbation_tpu/utils/dashboard.py`` (standard library and
matplotlib only, so it runs without JAX; tests/test_torch_io.py holds it
to the original). The replacement for the reference's visdom
pull server (visdom/visdom_pull_server.py): polls ``results/*.csv`` on an
interval and renders the same four log-scale panels

    gradnorm  vs iterations | residual vs iterations
    gradnorm  vs time       | residual vs time

to a PNG (and optionally serves the directory over HTTP). Works on any CSV
emitted by this framework or the reference (identical schema).

Usage:
    python -m pairwise_perturbation_tpu_torch.utils.dashboard --root results/ \\
        --out results/dashboard.png --interval 10 [--once] [--serve 8097]
"""

from __future__ import annotations

import argparse
import glob
import os
import time


def _read_csv(path):
    import csv
    rows = []
    with open(path) as fh:
        reader = csv.reader(fh)
        header = next(reader, None)
        if not header or len(header) < 7:
            return None
        for r in reader:
            if len(r) == 7:
                try:
                    rows.append([float(x) for x in r])
                except ValueError:
                    continue
    if not rows:
        return None
    cols = list(zip(*rows))
    return dict(iter=cols[1], metric=cols[2], diffV=cols[5], dtime=cols[6],
                name=os.path.splitext(os.path.basename(path))[0])


def render(root: str, out: str) -> int:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    traces = []
    for f in sorted(glob.glob(os.path.join(root, "*.csv"))):
        try:
            t = _read_csv(f)
        except Exception:
            t = None
        if t:
            traces.append(t)
    if not traces:
        return 0
    fig, axes = plt.subplots(2, 2, figsize=(13, 9))
    panels = [("iter", "metric", "gradnorm vs iterations"),
              ("iter", "diffV", "residual vs iterations"),
              ("dtime", "metric", "gradnorm vs time (s)"),
              ("dtime", "diffV", "residual vs time (s)")]
    for ax, (xk, yk, title) in zip(axes.ravel(), panels):
        for t in traces:
            ax.plot(t[xk], t[yk], label=t["name"], linewidth=1.2)
        ax.set_yscale("log")
        ax.set_title(title)
        ax.grid(True, alpha=0.3)
    axes[0, 0].legend(fontsize=7, loc="best")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return len(traces)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="results/")
    p.add_argument("--out", default="results/dashboard.png")
    p.add_argument("--interval", type=int, default=10)
    p.add_argument("--once", action="store_true")
    p.add_argument("--serve", type=int, default=0,
                   help="port to serve the results dir over HTTP")
    a = p.parse_args(argv)

    if a.serve:
        import threading
        from http.server import HTTPServer, SimpleHTTPRequestHandler

        class H(SimpleHTTPRequestHandler):
            def __init__(self, *args, **kw):
                super().__init__(*args, directory=a.root, **kw)

        srv = HTTPServer(("0.0.0.0", a.serve), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        print(f"serving {a.root} on :{a.serve}")

    while True:
        n = render(a.root, a.out)
        print(f"rendered {n} traces -> {a.out}")
        if a.once:
            return 0
        time.sleep(a.interval)


if __name__ == "__main__":
    raise SystemExit(main())
