"""Runtime diagnostics: resource monitoring + phase timing.

Rebuild of the reference's psutil-based monitor
(/root/reference/scripts/prisim_resource_monitor.py:11-56, launched by
run_prisim.py:319-322) and its ad-hoc wall-clock tallies
(run_prisim.py:1967-1991). Single-process here: a background thread
samples CPU%/RSS (and jax device memory stats where the backend exposes
them) to a JSONL file; ``phase_timer`` wraps pipeline stages."""

from __future__ import annotations

import contextlib
import json
import threading
import time

__all__ = ["ResourceMonitor", "phase_timer", "dot_precisions",
           "all_highest"]


class ResourceMonitor:
    """Background sampler writing JSONL rows
    {t, cpu_percent, rss_bytes, device_bytes_in_use}."""

    def __init__(self, path, interval=1.0):
        self.path = path
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thread = None

    def _device_bytes(self):
        try:
            import jax
            stats = jax.devices()[0].memory_stats()
            if stats:
                return int(stats.get("bytes_in_use", 0))
        except Exception:
            pass
        return None

    def _run(self):
        import psutil
        proc = psutil.Process()
        with open(self.path, "a") as f:
            while not self._stop.is_set():
                row = {
                    "t": time.time(),
                    "cpu_percent": proc.cpu_percent(interval=None),
                    "rss_bytes": proc.memory_info().rss,
                }
                dev = self._device_bytes()
                if dev is not None:
                    row["device_bytes_in_use"] = dev
                f.write(json.dumps(row) + "\n")
                f.flush()
                self._stop.wait(self.interval)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


@contextlib.contextmanager
def phase_timer(name, sink=None, verbose=True):
    """Wall-clock timer for one pipeline phase; appends (name, seconds)
    to `sink` (list or dict) and/or prints."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if isinstance(sink, dict):
            sink[name] = sink.get(name, 0.0) + dt
        elif isinstance(sink, list):
            sink.append((name, dt))
        if verbose:
            print("[prisim_tpu] %-24s %8.3f s" % (name, dt))


def dot_precisions(fn, *args, **kwargs):
    """Precision of every dot_general in fn's jaxpr, sub-jaxprs (scan,
    while, cond, jit, custom-rule and kernel bodies) included.

    Returns a list of (lhs dtype, precision config) pairs. An f32
    contraction that does not carry Precision.HIGHEST may run in TF32
    on an NVIDIA GPU (about three decimal digits)."""
    import jax
    from jax.extend import core

    found = []

    def sub_jaxprs(v):
        if isinstance(v, core.ClosedJaxpr):
            yield v.jaxpr
        elif isinstance(v, core.Jaxpr):
            yield v
        elif isinstance(v, (list, tuple)):
            for x in v:
                yield from sub_jaxprs(x)

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append((str(eqn.invars[0].aval.dtype),
                              eqn.params.get("precision")))
            for val in eqn.params.values():
                for sj in sub_jaxprs(val):
                    walk(sj)

    walk(jax.make_jaxpr(fn)(*args, **kwargs).jaxpr)
    return found


def all_highest(precisions):
    """True when every f32/complex64 contraction in a dot_precisions
    list runs at Precision.HIGHEST on both operands."""
    import jax
    hi = jax.lax.Precision.HIGHEST
    for dtype, prec in precisions:
        if dtype not in ("float32", "complex64"):
            continue
        if prec is None:
            return False
        pair = prec if isinstance(prec, tuple) else (prec, prec)
        if any(p != hi for p in pair):
            return False
    return True
