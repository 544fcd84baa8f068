"""Memory and build observability: per-program device-memory attribution,
the build-time records, and the OOM black box.

Counterpart of ``mxnet_tpu/observability/memprof.py``, and the module
of this slice that differs most from it.  The JAX package attributes
memory to the unit XLA allocates for, the compiled program: it routes
cached programs through an AOT twin of ``jax.jit`` (``ProfiledJit``,
``aot_compile``, ``wrap_jit``), reads the executable's
``memory_analysis()`` and fills each record's trace/lower/compile times
from a ``jax.monitoring`` listener.  torch has none of these: nothing is
lowered or compiled, and there is no allocation plan to read.  The port
records what it really builds instead:

- **Program records** (``program_records()``): one row per real build, in
  build order, with the JAX package's keys (``kind``, ``label``,
  ``trace_ms``, ``lower_ms``, ``compile_ms``, ``memory``), so
  ``tools/traceview.py --memory`` renders them unchanged.
  - A plan build (an ``executor_cache.get_program`` miss): ``trace_ms``
    is the time to lower the graph to its plan.
  - A CUDA-graph capture (the fused train step, each bucket's step, the
    paged decoder): ``compile_ms`` is the capture's wall time.
  - ``lower_ms`` is always 0: nothing is lowered.
- **Memory** (``MXNET_TPU_MEMPROF=1``, read per build): ``argument_bytes``
  (the bound tensors a run reads) and ``output_bytes`` everywhere; on the
  card also ``temp_bytes``, from ``torch.cuda.memory_stats``: for a
  capture, the graph pool's reserved bytes (``graph_pool_bytes``) and the
  eager warm-up step's peak above its arguments (``warmup_peak_bytes``);
  for a plan, the peak of its first run above the bytes live before it.
  Measuring a peak resets the card's peak counter
  (``torch.cuda.reset_peak_memory_stats``), so the flag is opt-in.
- **Live-tensor census** (``live_array_census()``): every live CUDA
  ``torch.Tensor`` grouped by (shape, dtype), each storage counted once
  so that views add nothing.
- **Device memory** (``device_memory()``): one row per card, from the
  caching allocator; all three numbers None on the host, as the JAX
  package reports on the CPU.
- **OOM black box** (``maybe_record_oom``): the executor, fused-step,
  fit-loop and serving paths call it on any failure; a device OOM
  (``torch.cuda.OutOfMemoryError``, "CUDA out of memory", or the JAX
  package's ``RESOURCE_EXHAUSTED`` token) writes ONE flight dump per
  process augmented with ``report()``, and the error propagates
  unchanged.

Nothing here launches anything on the card, and with the flag off no
dispatch path changes.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import warnings

import numpy as np

from .. import threads as _threads
from ..log import module_logger as _module_logger
from . import telemetry as _telemetry
from . import tracing as _tracing

_ENV = "MXNET_TPU_MEMPROF"

# program-record ring bound: one row per real build; the plan cache
# keeps 128 entries by default
MAX_RECORDS = 512

_lock = _threads.package_lock("memprof._lock")
_records = []          # program records, build order, bounded
# monotonic totals: records opened for real builds and for disk restores
# (the persistent program cache, a later slice), and builds that reached
# the compile phase (a capture)
_totals = {"built": 0, "restored": 0, "backend_compiles": 0}


def enabled():
    """Per-program memory capture is opt-in (``MXNET_TPU_MEMPROF=1``,
    read per build).  The build records, the retrace explainer and the
    OOM black box are always on."""
    return os.environ.get(_ENV, "0") == "1"


def _nbytes(tensors):
    """Bytes of a sequence of tensors (None entries skipped)."""
    return int(sum(t.numel() * t.element_size() for t in tensors
                   if t is not None))


def _cuda_stats(device):
    import torch
    return torch.cuda.memory_stats(device)


def note_build(kind, label=None, trace_ms=0.0):
    """Open a program record for one real build and return it."""
    rec = {"kind": str(kind), "label": label or "?", "t": time.time(),
           "trace_ms": float(trace_ms), "lower_ms": 0.0,
           "compile_ms": 0.0, "memory": None}
    with _lock:
        _records.append(rec)
        while len(_records) > MAX_RECORDS:
            _records.pop(0)
        _totals["built"] += 1
    return rec


def set_memory(rec, argument_bytes, output_bytes, temp_bytes=0, **extra):
    """Fill a record's ``memory`` (the JAX package's keys plus
    ``extra``)."""
    mem = {"argument_bytes": int(argument_bytes),
           "output_bytes": int(output_bytes),
           "temp_bytes": int(temp_bytes)}
    mem["total_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                          + mem["temp_bytes"])
    mem.update(extra)
    rec["memory"] = mem
    return mem


def note_compile(rec, compile_ms):
    """A build reached its compile phase (a CUDA-graph capture) that
    took ``compile_ms``: the ``exec_cache.compile_ms`` histogram, the
    totals and, while the profiler records, a ``compile:capture`` span."""
    rec["compile_ms"] = float(compile_ms)
    with _lock:
        _totals["backend_compiles"] += 1
    _telemetry.histogram(
        "exec_cache.compile_ms",
        help="CUDA-graph capture wall time per program").observe(
        rec["compile_ms"])
    if _tracing.is_recording():
        dur_us = rec["compile_ms"] * 1e3
        _tracing.emit_complete(
            "compile:capture", _tracing.now_us() - dur_us, dur_us,
            category="compile",
            args={"label": rec.get("label"), "kind": rec.get("kind")})


@contextlib.contextmanager
def first_run(rec, device, arguments):
    """Around a plan's first run: fill ``rec``'s memory under the flag
    (``arguments()`` gives the tensors the run reads).  Yields a list the
    caller appends the run's outputs to.  On the card the run's peak above
    the bytes live before it is its temp bytes."""
    outs = []
    if rec is None or not enabled():
        yield outs
        return
    on_card = device is not None and device.type == "cuda"
    if on_card:
        import torch
        torch.cuda.synchronize(device)
        before = _cuda_stats(device)["allocated_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats(device)
    yield outs
    temp = 0
    if on_card:
        torch.cuda.synchronize(device)
        peak = _cuda_stats(device)["allocated_bytes.all.peak"]
        temp = max(0, int(peak) - int(before))
    set_memory(rec, _nbytes(arguments()), _nbytes(outs), temp)


class CaptureProbe:
    """The record of one CUDA-graph build on the card: the eager warm-up
    step before the capture (``warmup``) and the capture (``capture``).
    The capture's wall time always lands on the record; under the flag
    so do the warm-up step's peak above the bytes live before it and the
    graph pool's bytes (the reserved bytes the capture added: a capture
    allocates from a new private pool, after releasing the cached blocks
    as ``torch.cuda.graph`` does)."""

    def __init__(self, rec, device):
        self.rec = rec
        self.device = device
        self.measure = enabled()
        self.warmup_peak = None

    @contextlib.contextmanager
    def warmup(self):
        if not self.measure:
            yield
            return
        import torch
        torch.cuda.synchronize(self.device)
        base = _cuda_stats(self.device)["allocated_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats(self.device)
        yield
        torch.cuda.synchronize(self.device)
        peak = _cuda_stats(self.device)["allocated_bytes.all.peak"]
        self.warmup_peak = max(0, int(peak) - int(base))

    @contextlib.contextmanager
    def capture(self, arguments, outputs):
        """Around the capture; ``arguments()`` and ``outputs()`` give the
        tensors the graph reads and writes (read after it, under the
        flag)."""
        reserved0 = None
        if self.measure:
            import gc
            import torch
            # what torch.cuda.graph does as it enters, done first here so
            # that the cached blocks it releases do not offset the pool
            torch.cuda.synchronize(self.device)
            gc.collect()
            torch.cuda.empty_cache()
            reserved0 = _cuda_stats(self.device)[
                "reserved_bytes.all.current"]
        t0 = time.perf_counter()
        yield
        note_compile(self.rec, (time.perf_counter() - t0) * 1e3)
        if self.measure:
            torch.cuda.synchronize(self.device)
            pool = int(_cuda_stats(self.device)[
                "reserved_bytes.all.current"]) - int(reserved0)
            set_memory(self.rec, _nbytes(arguments()), _nbytes(outputs()),
                       pool, graph_pool_bytes=pool,
                       warmup_peak_bytes=self.warmup_peak)


def note_restore(label, nbytes=0):
    """Open a record for a program restored from the persistent disk tier
    (kind ``disk``; the program cache arrives in a later slice)."""
    rec = {"kind": "disk", "label": label or "?", "t": time.time(),
           "trace_ms": 0.0, "lower_ms": 0.0, "compile_ms": 0.0,
           "memory": None, "restored_bytes": int(nbytes)}
    with _lock:
        _records.append(rec)
        while len(_records) > MAX_RECORDS:
            _records.pop(0)
        _totals["restored"] += 1
    return rec


def build_totals():
    """Monotonic {built, restored, backend_compiles} counters."""
    with _lock:
        return dict(_totals)


def program_records():
    """Snapshot of the program records (build order)."""
    with _lock:
        return [dict(r) for r in _records]


def record_count():
    with _lock:
        return len(_records)


def compile_summary():
    """{count, total_ms, max_ms, mean_ms} over the records that reached a
    compile phase (the captures)."""
    with _lock:
        times = [r["compile_ms"] for r in _records if r["compile_ms"] > 0]
    if not times:
        return {"count": 0, "total_ms": 0.0, "max_ms": 0.0, "mean_ms": 0.0}
    total = sum(times)
    return {"count": len(times), "total_ms": round(total, 3),
            "max_ms": round(max(times), 3),
            "mean_ms": round(total / len(times), 3)}


def reset():
    """Drop the program records (tests, between measurement passes)."""
    with _lock:
        del _records[:]


# -- live state ---------------------------------------------------------------

def _dtype_str(dtype):
    """numpy's dtype string (``<f4``) where numpy has the type, else the
    torch name (``bfloat16``)."""
    name = str(dtype).replace("torch.", "")
    try:
        np_dtype = np.dtype(name)
    except TypeError:
        return name
    return np_dtype.str if np_dtype.kind in "biufc" else name


def live_array_census(limit=30, device_type=None):
    """Every live ``torch.Tensor`` of one device type grouped by (shape,
    dtype): the resident-buffer view that complements the program
    records.  ``device_type`` defaults to ``cuda`` once the process uses
    a card, else ``cpu``.  A walk of the garbage collector's objects;
    each storage is counted once (a view of a counted storage adds
    nothing), no device sync."""
    import gc
    import torch
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() \
            and torch.cuda.is_initialized() else "cpu"
    groups = {}
    seen = set()
    count = 0
    total = 0
    with warnings.catch_warnings():
        # isinstance on some module objects trips a deprecation warning
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        try:
            if obj.device.type != device_type:
                continue
            storage = obj.untyped_storage()
            key_s = (storage.data_ptr(), obj.device.index)
            if key_s in seen:
                continue
            seen.add(key_s)
            nbytes = int(storage.nbytes())
            key = (tuple(int(d) for d in obj.shape), _dtype_str(obj.dtype))
        except Exception:
            continue
        g = groups.get(key)
        if g is None:
            g = groups[key] = {"shape": list(key[0]), "dtype": key[1],
                               "count": 0, "total_bytes": 0}
        g["count"] += 1
        g["total_bytes"] += nbytes
        count += 1
        total += nbytes
    rows = sorted(groups.values(), key=lambda g: -g["total_bytes"])
    return {"groups": rows[:int(limit)], "group_count": len(rows),
            "array_count": count, "total_bytes": total}


# -- device-resident block pools ----------------------------------------------
# One buffer, many logical owners: the paged KV pool allocates one device
# tensor and hands out pages of it, so the census sees one opaque tensor.
# Pools register here with a page-granular usage callback; the report
# carries one row per pool.

_pools = {}


def register_pool(name, page_bytes, total_pages, used_fn):
    """Account a device-resident block pool page by page.  ``used_fn``
    () -> pages held now; it must not raise.  Re-registering a name
    replaces the entry."""
    with _lock:
        _pools[str(name)] = {"page_bytes": int(page_bytes),
                             "total_pages": int(total_pages),
                             "used_fn": used_fn}


def unregister_pool(name):
    with _lock:
        _pools.pop(str(name), None)


def pool_records():
    """One row per registered pool: the page-granular footprint."""
    with _lock:
        items = list(_pools.items())
    out = []
    for name, p in items:
        try:
            used = int(p["used_fn"]())
        except Exception:
            used = None
        out.append({"name": name, "page_bytes": p["page_bytes"],
                    "total_pages": p["total_pages"],
                    "bytes_reserved": p["page_bytes"] * p["total_pages"],
                    "pages_used": used,
                    "bytes_used": None if used is None
                    else used * p["page_bytes"]})
    return out


def device_memory():
    """One row per CUDA device from the caching allocator
    (``allocated_bytes.all.current``/``.peak`` and the card's total from
    ``torch.cuda.mem_get_info``); one row of None fields on the host."""
    out = []
    try:
        import torch
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                out.append({
                    "device": "cuda:%d" % i,
                    "bytes_in_use": int(stats.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(stats.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(torch.cuda.mem_get_info(i)[1])})
            return out
    except Exception:
        pass
    return [{"device": "cpu:0", "bytes_in_use": None,
             "peak_bytes_in_use": None, "bytes_limit": None}]


def _disk_stats():
    from .. import executor_cache
    return executor_cache.stats()["disk"]


def report():
    """The full memory report: program table, live-tensor census, pools
    and per-device allocator stats.  ``tools/traceview.py --memory``
    renders it and the OOM dump embeds it."""
    try:
        disk = _disk_stats()
    except Exception:
        disk = None
    return {"kind": "mxnet_tpu_memory", "version": 1,
            "created": time.time(), "memprof_enabled": enabled(),
            "programs": program_records(),
            "compile": compile_summary(),
            "disk": disk,
            "census": live_array_census(),
            "pools": pool_records(),
            "device_memory": device_memory()}


def write_report(path):
    """Write ``report()`` as one strict-JSON file and return the path."""
    from .flight_recorder import _json_safe
    with open(path, "w") as f:
        json.dump(_json_safe(report()), f, allow_nan=False)
    return path


# -- the OOM black box --------------------------------------------------------

def is_oom(exc):
    """Is this a device out-of-memory?  torch raises
    ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory"); the JAX
    package's ``RESOURCE_EXHAUSTED`` status token is matched too."""
    if not isinstance(exc, Exception):
        return False
    try:
        import torch
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    text = str(exc)
    return "CUDA out of memory" in text or "RESOURCE_EXHAUSTED" in text


# oom anomalies recorded per process before the noting stops (the
# counter keeps the full tally)
MAX_OOM_ANOMALIES = 64


def record_oom(context, exc):
    """Write the OOM post-mortem: an ``oom`` anomaly on the flight
    recorder plus ONE dump per process augmented with the memory report.
    Returns the dump path (None when a dump already exists)."""
    from . import flight_recorder as _flight
    recorder = _flight.get_recorder()
    step = recorder.last_step()
    if recorder.anomaly_count("oom") < MAX_OOM_ANOMALIES:
        recorder.note_anomaly({
            "rule": "oom", "step": step if step is not None else -1,
            "context": str(context),
            "message": str(exc)[:2000]})
    _telemetry.counter(
        "memprof.oom_total",
        help="device out-of-memory failures observed").inc()
    if recorder.has_dumped("oom"):
        return None
    path = recorder.dump_once(reason="oom",
                              sections={"memory": report()})
    if path:
        _module_logger(__name__).error(
            "device OOM in %s: flight dump with memory report written "
            "to %s", context, path)
    return path


def maybe_record_oom(context, exc):
    """Failure hook: records the black box when ``exc`` is a device OOM,
    and never raises.  Idempotent per exception object: an OOM that
    passes the dispatch guard and then the fit loop counts once."""
    try:
        if is_oom(exc) and not getattr(exc, "_mxtpu_oom_recorded", False):
            try:
                exc._mxtpu_oom_recorded = True
            except Exception:
                pass
            return record_oom(context, exc)
    except Exception:
        _module_logger(__name__).exception(
            "OOM black-box capture failed (original error propagates)")
    return None


@contextlib.contextmanager
def oom_guard(what):
    """OOM black box over one dispatch: a device OOM writes the
    augmented flight dump before the error propagates unchanged."""
    try:
        yield
    except Exception as exc:
        maybe_record_oom(what, exc)
        raise
