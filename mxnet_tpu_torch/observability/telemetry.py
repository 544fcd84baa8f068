"""Process-wide metrics registry: Counter / Gauge / Histogram.

Counterpart of ``mxnet_tpu/observability/telemetry.py``: the same names,
bucket edges and exporter text (the Prometheus names keep the
``mxnet_tpu_`` prefix, so a scrape config serves both packages).

The runtime analog of the reference's ad-hoc logging counters, unified
the way a production stack expects: every subsystem registers named
instruments here (``exec_cache.hits``, ``module.step.data_wait_ms``,
``kvstore.push_bytes``, ``device.live_bytes``, ...), and one snapshot
answers "what has this process been doing" in either Prometheus text or
JSON-lines form.

Design constraints, enforced here rather than hoped for:

- **No numpy in the hot path.**  Histogram bucketing is pure-python
  ``math.frexp`` arithmetic over fixed log2 bucket bounds — observing a
  value is two float ops and a list increment.
- **Zero-cost when disabled.**  With ``MXNET_TPU_TELEMETRY=0`` the
  factories hand back one shared no-op instrument whose methods do
  nothing, so instrumented code keeps a single unconditional call.
- **Thread-safe.**  One registry lock guards creation; instrument
  updates touch only their own fields (CPython-atomic appends/adds
  guarded by the instrument's own lock where a read-modify-write needs
  it).
"""
from __future__ import annotations

import json
import math
import os

from .. import threads as _threads

_ENV = "MXNET_TPU_TELEMETRY"

# log2 bucket bounds for histograms: 2**k for k in [_K_MIN, _K_MAX],
# plus a +Inf overflow bucket.  In milliseconds that spans ~1µs to ~17min
# — every latency this framework measures fits with fixed, comparable
# bounds (the reference's OprExecStat kept raw pairs; fixed buckets keep
# the registry O(1) per observation and mergeable across processes).
_K_MIN = -10
_K_MAX = 20
BUCKET_BOUNDS = tuple(2.0 ** k for k in range(_K_MIN, _K_MAX + 1))

_lock = _threads.package_lock("telemetry._lock")
_metrics = {}  # name -> instrument
_epoch = 0     # bumped by reset(); invalidates cached instrument handles


def enabled():
    """Telemetry is on unless MXNET_TPU_TELEMETRY=0 (read per factory
    call so tests and tools can flip it without a process restart)."""
    return os.environ.get(_ENV, "1") != "0"


class Counter:
    """Monotonically increasing named value (float-valued: byte and
    millisecond totals accumulate here too)."""

    kind = "counter"
    __slots__ = ("name", "help", "gen", "_lock", "_value")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self.gen = _epoch
        self._lock = _threads.package_lock("Counter._lock")
        self._value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value

    def _snapshot(self):
        return {"type": self.kind, "value": self._value, "gen": self.gen}


class Gauge:
    """Last-written value, or a live callback (``set_function``) sampled
    at snapshot time — the device-memory gauge uses the latter."""

    kind = "gauge"
    __slots__ = ("name", "help", "gen", "_value", "_fn")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self.gen = _epoch
        self._value = 0.0
        self._fn = None

    def set(self, value):
        self._value = float(value)

    def set_function(self, fn):
        """Snapshot calls ``fn()`` for the live value (errors fall back
        to the last set() value rather than poisoning the snapshot)."""
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            try:
                self._value = float(self._fn())
            except Exception:
                pass
        return self._value

    def _snapshot(self):
        return {"type": self.kind, "value": self.value, "gen": self.gen}


class Histogram:
    """Fixed log2-bucket histogram: counts per power-of-two upper bound
    plus sum/count/min/max.  ``observe`` is numpy-free and O(1)."""

    kind = "histogram"
    __slots__ = ("name", "help", "gen", "_lock", "buckets", "sum", "count",
                 "min", "max")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self.gen = _epoch
        self._lock = _threads.package_lock("Histogram._lock")
        self.buckets = [0] * (len(BUCKET_BOUNDS) + 1)  # +1 overflow
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    @staticmethod
    def _bucket_index(value):
        if value <= BUCKET_BOUNDS[0]:
            return 0
        # frexp gives value = m * 2**e with 0.5 <= m < 1, so
        # ceil(log2(value)) is e unless value is an exact power of two
        # (m == 0.5), where it is e-1 — no libm log in the hot path.
        m, e = math.frexp(value)
        k = e - 1 if m == 0.5 else e
        if k > _K_MAX:
            return len(BUCKET_BOUNDS)  # overflow bucket
        return k - _K_MIN

    def observe(self, value):
        value = float(value)
        idx = self._bucket_index(value) if value > 0 else 0
        with self._lock:
            self.buckets[idx] += 1
            self.sum += value
            self.count += 1
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q):
        """Quantile estimate over the live histogram — the shared
        estimator the serving metrics' readers use (one definition, not
        ad-hoc percentile snippets).  See
        :func:`quantile_from_snapshot` for the interpolation contract."""
        return quantile_from_snapshot(self._snapshot(), q)

    def _snapshot(self):
        with self._lock:
            return {"type": self.kind, "count": self.count,
                    "sum": self.sum,
                    "min": self.min if self.count else None,
                    "max": self.max if self.count else None,
                    "buckets": list(self.buckets),
                    "gen": self.gen}


class _Noop:
    """The shared disabled instrument: every method is a no-op, every
    factory returns this same object, so disabled telemetry costs one
    attribute call per site and allocates nothing."""

    kind = "noop"
    name = "<disabled>"
    gen = 0
    value = 0.0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, amount=1):
        pass

    def set(self, value):
        pass

    def set_function(self, fn):
        pass

    def observe(self, value):
        pass


NOOP = _Noop()


def _snap_bound(snap, key):
    """The recorded min/max of a snapshot as a finite float, or None
    (empty histograms and JSON-lines string tokens both end up None)."""
    v = snap.get(key)
    return float(v) if isinstance(v, (int, float)) \
        and math.isfinite(v) else None


def iter_bucket_ranges(snap):
    """Yield ``(lo, hi, count)`` for every non-empty bucket of a
    histogram snapshot — the ONE place the fixed log2 geometry is
    decoded (bucket ``i`` covers ``(BUCKET_BOUNDS[i-1],
    BUCKET_BOUNDS[i]]``, bucket 0 everything below the first bound, the
    overflow bucket ``(BUCKET_BOUNDS[-1], recorded max]``).  Both the
    quantile estimator below and ``fraction_over`` build
    on this instead of re-deriving the bounds."""
    buckets = snap.get("buckets") or []
    mx = _snap_bound(snap, "max")
    for i, n in enumerate(buckets):
        if not n:
            continue
        if i < len(BUCKET_BOUNDS):
            lo = 0.0 if i == 0 else BUCKET_BOUNDS[i - 1]
            hi = BUCKET_BOUNDS[i]
        else:  # overflow: the recorded max is the only upper bound
            lo = BUCKET_BOUNDS[-1]
            hi = mx if mx is not None else BUCKET_BOUNDS[-1] * 2
        yield lo, hi, n


def quantile_from_snapshot(snap, q):
    """Quantile estimate from a log2-bucket histogram snapshot (the
    ``_snapshot()``/``snapshot()``/``parse_json_lines`` dict shape).

    The fixed buckets only bound each observation by a power of two, so
    the estimator interpolates LINEARLY inside the bucket holding the
    q-th observation — ``(lo, hi]`` with ``lo = hi/2`` — and clamps the
    result to the recorded ``min``/``max``.  The clamp makes the edges
    exact: a histogram holding one distinct value returns that value
    for every q, and ``q=0``/``q=1`` return min/max.  The +Inf overflow
    bucket interpolates toward the recorded max (the only upper bound
    it has).  Returns 0.0 for an empty histogram.
    """
    count = snap.get("count", 0) or 0
    if count <= 0:
        return 0.0
    mn = _snap_bound(snap, "min")
    mx = _snap_bound(snap, "max")
    q = min(1.0, max(0.0, float(q)))
    # rank of the target observation, 1-based; q=0 -> the first
    target = max(1.0, q * count)
    cumulative = 0
    est = 0.0
    for lo, hi, n in iter_bucket_ranges(snap):
        cumulative += n
        if cumulative >= target:
            frac = (target - (cumulative - n)) / n
            est = lo + frac * (hi - lo)
            break
    if mn is not None:
        est = max(est, mn)
    if mx is not None:
        est = min(est, mx)
    return est


# -- delta derivation --------------------------------------------------------
#
# Consumers that diff two snapshots of the same instrument (a
# time-series window, a controller, a report) share these helpers so a
# ``reset()`` between the snapshots — detectable via the ``gen`` token
# every snapshot carries — surfaces as an explicit reset marker instead
# of negative rates/counts.

def generation_changed(snap_a, snap_b):
    """True when ``reset()`` ran between the two snapshots: the
    instrument behind ``snap_b`` is a re-registered object whose totals
    restarted from zero, so subtracting ``snap_a`` would go negative."""
    return snap_a.get("gen") != snap_b.get("gen")


def counter_delta(snap_a, snap_b):
    """Increase of a counter/gauge value between two snapshots (older
    first).  Returns ``(delta, reset)``: on a generation change — or a
    bare value decrease, the same event seen through a generation-less
    legacy snapshot — the total restarted, so the delta is ``snap_b``'s
    whole value and ``reset`` is True.  ``snap_a`` may be falsy (no
    baseline: the instrument registered mid-window), which is a plain
    from-zero delta, not a reset."""
    vb = float(snap_b.get("value", 0.0) or 0.0)
    if not snap_a:
        return vb, False
    va = float(snap_a.get("value", 0.0) or 0.0)
    if generation_changed(snap_a, snap_b) or vb < va:
        return vb, True
    return vb - va, False


def delta_snapshot(snap_a, snap_b):
    """Histogram snapshot of only the observations made between two
    snapshots of the same instrument (older first): per-bucket count
    differences, sum/count differences, bounds clamped to ``snap_b``'s
    recorded min/max (loose but valid bounds for the delta
    observations).  A generation change — or any negative difference,
    its generation-less shadow — means the histogram restarted between
    the snapshots: the delta is ``snap_b`` alone and the result carries
    ``"reset": True``.  A falsy ``snap_a`` (no baseline) is a plain
    from-zero delta."""
    if not snap_a:
        out = dict(snap_b)
        out["reset"] = False
        return out
    ba = snap_a.get("buckets") or []
    bb = snap_b.get("buckets") or []
    ca = snap_a.get("count", 0) or 0
    cb = snap_b.get("count", 0) or 0
    reset = generation_changed(snap_a, snap_b)
    diff = []
    if not reset:
        if cb < ca or len(ba) != len(bb):
            reset = True
        else:
            diff = [y - x for x, y in zip(ba, bb)]
            if any(d < 0 for d in diff):
                reset = True
    if reset:
        out = dict(snap_b)
        out["reset"] = True
        return out
    count = cb - ca
    out = {"type": "histogram", "count": count,
           "sum": ((snap_b.get("sum", 0.0) or 0.0)
                   - (snap_a.get("sum", 0.0) or 0.0)),
           "min": snap_b.get("min") if count else None,
           "max": snap_b.get("max") if count else None,
           "buckets": diff, "reset": False}
    if "gen" in snap_b:
        out["gen"] = snap_b["gen"]
    return out


def quantile_between(snap_a, snap_b, q):
    """The documented delta form of :func:`quantile_from_snapshot`:
    quantile estimate over only the observations made between two
    snapshots of the same histogram, via :func:`delta_snapshot` bucket
    differences.  Same interpolation contract as the cumulative form —
    empty delta returns 0.0, a single-distinct-value delta returns that
    value for every q, the overflow bucket interpolates toward the
    recorded max.  A reset between the snapshots degrades gracefully to
    the quantile of ``snap_b`` alone (flagged by ``delta_snapshot``)."""
    return quantile_from_snapshot(delta_snapshot(snap_a, snap_b), q)


def fraction_over(snap, threshold):
    """Estimated fraction of a histogram snapshot's observations that
    exceed ``threshold`` — the latency-breach side of an SLO error
    budget, usually fed a :func:`delta_snapshot`.  Counts whole buckets
    above the threshold and interpolates linearly inside the straddling
    bucket (tightened to the recorded min/max), consistent with the
    quantile estimator.  Empty histogram returns 0.0."""
    count = snap.get("count", 0) or 0
    if count <= 0:
        return 0.0
    threshold = float(threshold)
    mn = _snap_bound(snap, "min")
    mx = _snap_bound(snap, "max")
    if mx is not None and mx <= threshold:
        return 0.0
    if mn is not None and mn > threshold:
        return 1.0
    over = 0.0
    for lo, hi, n in iter_bucket_ranges(snap):
        if mx is not None:
            hi = min(hi, mx)
        if mn is not None:
            lo = max(lo, mn)
        if threshold <= lo:
            over += n
        elif threshold < hi:
            over += n * (hi - threshold) / (hi - lo)
    return max(0.0, min(1.0, over / count))


def _get(name, cls, help):
    if not enabled():
        return NOOP
    with _lock:
        metric = _metrics.get(name)
        if metric is None:
            metric = cls(name, help=help)
            _metrics[name] = metric
        elif not isinstance(metric, cls):
            raise TypeError("metric %r already registered as %s, not %s"
                            % (name, metric.kind, cls.kind))
        return metric


def counter(name, help=""):
    """Get-or-create the named Counter (no-op handle when disabled)."""
    return _get(name, Counter, help)


def gauge(name, help=""):
    """Get-or-create the named Gauge (no-op handle when disabled)."""
    return _get(name, Gauge, help)


def histogram(name, help=""):
    """Get-or-create the named Histogram (no-op handle when disabled)."""
    return _get(name, Histogram, help)


def reset():
    """Drop every registered metric (tests / between measured passes).
    Bumps the registry epoch so cached handles re-resolve; instruments
    registered after the reset carry the new epoch as their ``gen``
    snapshot token, which is how snapshot-diffing consumers
    (:func:`counter_delta` / :func:`delta_snapshot`) tell a restart
    from a decrease."""
    global _epoch
    with _lock:
        _metrics.clear()
        _epoch += 1


def registry_epoch():
    """Cache-invalidation key for callers that memoize handles: changes
    whenever reset() drops the registry."""
    return _epoch


def snapshot():
    """{name: {type, ...}} over every registered instrument, values
    read at call time (function gauges sample their callback)."""
    with _lock:
        items = list(_metrics.items())
    return {name: m._snapshot() for name, m in sorted(items)}


# -- exporters ---------------------------------------------------------------

def _prom_name(name):
    """Prometheus metric names allow [a-zA-Z0-9_:]; dots become
    underscores (mxnet_tpu namespace prefixed once)."""
    safe = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return "mxnet_tpu_" + safe


def to_prometheus():
    """Prometheus text exposition of the current snapshot."""
    lines = []
    for name, snap in snapshot().items():
        pname = _prom_name(name)
        if snap["type"] in ("counter", "gauge"):
            lines.append("# TYPE %s %s" % (pname, snap["type"]))
            lines.append("%s %s" % (pname, _fmt(snap["value"])))
            continue
        lines.append("# TYPE %s histogram" % pname)
        cumulative = 0
        for bound, n in zip(BUCKET_BOUNDS, snap["buckets"]):
            cumulative += n
            lines.append('%s_bucket{le="%s"} %d'
                         % (pname, _fmt(bound), cumulative))
        cumulative += snap["buckets"][-1]
        lines.append('%s_bucket{le="+Inf"} %d' % (pname, cumulative))
        lines.append("%s_sum %s" % (pname, _fmt(snap["sum"])))
        lines.append("%s_count %d" % (pname, snap["count"]))
    return "\n".join(lines) + ("\n" if lines else "")


def _fmt(x):
    """Shortest faithful number text (counters are often whole).
    Non-finite values use the Prometheus exposition literals — one
    ``observe(nan)`` (a diverged loss, say) must not take the whole
    scrape down."""
    f = float(x)
    if not math.isfinite(f):
        return "NaN" if math.isnan(f) else ("+Inf" if f > 0 else "-Inf")
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# strict JSON has no literals for non-finite floats; the exporters use
# these string tokens in the numeric snapshot fields instead (and
# parse_json_lines restores the floats)
_JSON_NUMERIC_KEYS = ("value", "sum", "min", "max")
_NONFINITE_TOKENS = {"NaN": float("nan"), "Infinity": float("inf"),
                     "-Infinity": float("-inf")}


def _json_safe(snap):
    out = dict(snap)
    for k in _JSON_NUMERIC_KEYS:
        v = out.get(k)
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = ("NaN" if math.isnan(v)
                      else "Infinity" if v > 0 else "-Infinity")
    return out


def to_json_lines():
    """One JSON object per metric per line: {"name", "type", ...} —
    the structured-log form of the same snapshot.  Strict JSON output:
    non-finite floats become string tokens (see ``_NONFINITE_TOKENS``)."""
    return "\n".join(
        json.dumps(dict(_json_safe(snap), name=name), sort_keys=True,
                   allow_nan=False)
        for name, snap in snapshot().items()) + "\n"


def parse_json_lines(text):
    """Inverse of ``to_json_lines``: {name: {type, ...}} — exists so the
    export round-trips losslessly (asserted in tests)."""
    out = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        obj = json.loads(line)
        for k in _JSON_NUMERIC_KEYS:
            v = obj.get(k)
            if isinstance(v, str) and v in _NONFINITE_TOKENS:
                obj[k] = _NONFINITE_TOKENS[v]
        out[obj.pop("name")] = obj
    return out
