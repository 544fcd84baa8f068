#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which raises on failure:

1. Card: the card's name and power limit, torch and CUDA versions, and
   the build of every kernel source (one ``nvcc`` each, in parallel).
2. Kernels against their plain PyTorch versions on the card: the
   flash-attention forward at the serving shape (B 4, S 1024, H 12, D 64,
   causal, f32) and at S 1000 non-causal, ragged ``kv_lens`` with a 0,
   D 128, and bf16; with the kernel's, the plain version's and
   ``torch.nn.functional.scaled_dot_product_attention``'s times (the last
   as a yardstick only: the port never calls it) beside the bound.
3. The slice: a GPT-2-small-width TransformerLM (vocab 50257, context
   1024, width 768, 12 heads, 12 layers, FFN 3072; random weights from
   ``--seed``) served by ``Server(max_batch_size=4)``: warmup with its
   zero-rebuild verify, 8 concurrent requests of 1-3 rows, output shapes
   and finiteness, the flash launch count (12 per forward), and 2 served
   rows against the same model run through the port on the host.
4. The ``kernels`` JSON line, then the result line.

Exits non-zero, printing no result, when there is no CUDA device or the
package is not beside this script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# serving configuration: GPT-2 small's published widths (Radford et al.
# 2019; openai/gpt-2 models/124M/hparams.json)
GPT2S = dict(vocab_size=50257, embed_dim=768, num_heads=12, num_layers=12,
             seq_len=1024, ffn_dim=3072)
MAX_BATCH = 4
REQUEST_ROWS = (1, 2, 3, 1, 2, 3, 1, 2)

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=0.0)
SERVE_TOL = dict(atol=2e-3, rtol=2e-3)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps=30, warmup=3):
    """Median over ``reps`` single calls, each between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def flash_bound(q, sk, causal, kv_lens):
    """Least time (ms) the card needs for this attention call, and what
    bounds it: 4*D*H operations per valid (row, key) pair of these
    inputs, at the peak of the input type, against q, k, v read once and
    o written once."""
    import torch
    b, sq, h, d = q.shape
    lens = [sk] * b if kv_lens is None else \
        [min(max(int(x), 0), sk) for x in kv_lens.tolist()]
    pairs = 0
    for n in lens:
        if not causal:
            pairs += sq * n
        elif n >= sq:
            pairs += sq * (sq + 1) // 2
        else:
            pairs += n * (n + 1) // 2 + (sq - n) * n
    ops = 4 * d * h * pairs
    nbytes = q.element_size() * (2 * q.numel() + 2 * b * sk * h * d)
    if kv_lens is not None:
        nbytes += 4 * b
    peak = PEAK_F32_FLOPS if q.dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(seed):
    """Phase 2: every kernel against its plain version on the card.
    Returns the slice-shape record for the kernels line."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = [  # name, B, Sq, Sk, H, D, causal, dtype, kv_lens
        ("serving", 4, 1024, 1024, 12, 64, True, torch.float32, None),
        ("s1000-full", 2, 1000, 1000, 12, 64, False, torch.float32, None),
        ("ragged-lens", 4, 256, 256, 12, 64, True, torch.float32,
         [256, 0, 77, 130]),
        ("d128", 2, 512, 512, 8, 128, True, torch.float32, [512, 300]),
        ("bf16", 4, 1024, 1024, 12, 64, True, torch.bfloat16, None),
    ]
    record = None
    for name, b, sq, sk, h, d, causal, dtype, lens in cases:
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, sk, h, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, sk, h, d, generator=gen, device=dev).to(dtype)
        kl = None if lens is None else \
            torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = 1.0 / d ** 0.5
        out = K.flash_attention(q, k, v, causal=causal, scale=scale,
                                kv_lens=kl)
        ref = K._reference_attention(q, k, v, causal, scale, kl)
        torch.cuda.synchronize()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = (out.float() - ref.float()).abs()
        max_err = float(err.max())
        ok = bool((err <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
        print("kernel flash_attn_fwd %-12s B%d Sq%d Sk%d H%d D%d %s %s: "
              "max_abs_err %.3g (atol %g rtol %g) %s"
              % (name, b, sq, sk, h, d, "causal" if causal else "full",
                 str(dtype).replace("torch.", ""), max_err, tol["atol"],
                 tol["rtol"], "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("flash_attn_fwd disagrees with its plain "
                                 "version on case %s" % name)
        if name != "serving":
            continue
        ms = time_ms(lambda: K.flash_attention(q, k, v, causal=True,
                                               scale=scale))
        plain_ms = time_ms(lambda: K._reference_attention(q, k, v, True,
                                                          scale))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale))
        bound_ms, bound_by = flash_bound(q, sk, True, None)
        print("kernel flash_attn_fwd serving: %.4f ms, plain %.4f ms, "
              "sdpa %.4f ms, bound %.4f ms (%s), roofline share %.1f%%"
              % (ms, plain_ms, library_ms, bound_ms, bound_by,
                 100.0 * bound_ms / ms))
        record = {"name": "flash_attn_fwd", "route": "cuda",
                  "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
                  "replaces": "mxnet_tpu/ops/pallas_kernels.py:338",
                  "launches": 0, "max_abs_err": max_err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": library_ms}
    return [record]


def gpt2s_params(symbol, seed):
    """Seeded random weights (numpy): N(0, 0.02) matrices and embeddings,
    N(0, 0.01) positions, zero biases, unit LayerNorm gains."""
    arg_shapes, _, _ = symbol.infer_shape(data=(1, GPT2S["seq_len"]))
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name.endswith("_gamma"):
            arrays[name] = np.ones(shape, np.float32)
        elif name.endswith(("_bias", "_beta")):
            arrays[name] = np.zeros(shape, np.float32)
        else:
            std = 0.01 if name.endswith("_pos") else 0.02
            arrays[name] = rng.standard_normal(shape, np.float32) * std
    return arrays


def dispatch_breakdown(predictor, rows, reps=5):
    """Median host-clock ms of a predictor's forward (synchronized) and
    of copying its output to the host — the two halves of a dispatch
    (these launches come after the main path's counts were read)."""
    import torch
    fwd, copy = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.forward(data=rows)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        predictor.get_output(0).asnumpy()
        t2 = time.perf_counter()
        fwd.append((t1 - t0) * 1e3)
        copy.append((t2 - t1) * 1e3)
    return float(np.median(fwd)), float(np.median(copy))


def serve(mx, seed):
    """Phase 3: serve the GPT-2-small-width LM on the card.  Returns the
    flash launches of the main path."""
    import torch
    from mxnet_tpu_torch import executor_cache, threads
    from mxnet_tpu_torch.models import transformer_lm_symbol
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.serving import metrics

    symbol = transformer_lm_symbol(**GPT2S)
    t0 = time.perf_counter()
    arrays = gpt2s_params(symbol, seed)
    arg_params, _ = mx.convert.params_from_numpy(arrays, mx.cpu())
    print("slice: %d parameters made from seed %d in %.1f s"
          % (sum(a.size for a in arrays.values()), seed,
             time.perf_counter() - t0))
    seq = GPT2S["seq_len"]
    rng = np.random.default_rng(seed + 1)
    requests = [rng.integers(0, GPT2S["vocab_size"], (r, seq)).astype(
        np.float32) for r in REQUEST_ROWS]

    metrics.reset()
    K.reset_launch_counts()
    server = mx.serving.Server(max_batch_size=MAX_BATCH)
    try:
        t0 = time.perf_counter()
        server.add_model("gpt2s", symbol, arg_params,
                         input_shapes={"data": (seq,)})
        report = server.warmup(verify=True)["gpt2s"]
        torch.cuda.synchronize()
        print("slice: add_model + warmup %.2f s, buckets %s, plan builds "
              "%d first pass, %d verify pass"
              % (time.perf_counter() - t0, report["buckets"],
                 report["traces_first_pass"],
                 report["traces_verify_pass"]))
        if report["traces_verify_pass"] != 0:
            raise AssertionError("warmup verify pass built plans")
        warm_launches = K.launch_counts()["flash_attn_fwd"]
        warm_forwards = 2 * len(report["buckets"])
        batches0 = metrics.snapshot()["counters"].get("serving.batches", 0)
        done_at = {}

        def stamp(i):
            return lambda _f: done_at.__setitem__(i, time.perf_counter())

        with executor_cache.watch_traces() as w:
            t_start = time.perf_counter()
            futs, sent_at = [], []
            for i, x in enumerate(requests):
                sent_at.append(time.perf_counter())
                fut = server.submit_async("gpt2s", {"data": x})
                fut.add_done_callback(stamp(i))
                futs.append(fut)
            outs = [f.result(timeout=600)[0] for f in futs]
            t_end = time.perf_counter()
        launches = K.launch_counts()["flash_attn_fwd"]
        batches = metrics.snapshot()["counters"]["serving.batches"] - batches0
        forward_ms, copy_ms = dispatch_breakdown(
            server.registry.get("gpt2s").predictor_for(MAX_BATCH),
            np.concatenate(requests[:3])[:MAX_BATCH])
    finally:
        server.close()
    if threads.live_package_threads():
        raise AssertionError("server threads survived close()")
    if w.total() != 0:
        raise AssertionError("serving built %s plans after warmup"
                             % w.delta())
    for x, o in zip(requests, outs):
        if o.shape != (x.shape[0], seq, GPT2S["vocab_size"]):
            raise AssertionError("response shape %s" % (o.shape,))
        if not np.isfinite(o).all():
            raise AssertionError("non-finite logits in a response")
    layers = GPT2S["num_layers"]
    if warm_launches != layers * warm_forwards \
            or launches - warm_launches != layers * batches:
        raise AssertionError(
            "flash launches %d (warmup %d over %d forwards, serving %d over "
            "%d batches): expected %d per forward"
            % (launches, warm_launches, warm_forwards,
               launches - warm_launches, batches, layers))
    lat = sorted((done_at[i] - sent_at[i]) * 1e3 for i in range(len(futs)))
    print("slice: served %d requests (%d rows) in %d batches, %.3f "
          "requests/s, %.1f rows/s, latency p50 %.1f ms p99 %.1f ms; "
          "flash launches %d (%d per forward); card %s"
          % (len(requests), sum(REQUEST_ROWS), batches,
             len(requests) / (t_end - t_start),
             sum(REQUEST_ROWS) / (t_end - t_start),
             float(np.percentile(lat, 50)), float(np.percentile(lat, 99)),
             launches, layers, card_line()))
    dispatch = metrics.snapshot()["samples"]["serving.dispatch_ms"][-batches:]
    print("slice: dispatch ms per batch (forward + device-to-host copy): %s"
          % ", ".join("%.1f" % d for d in dispatch))
    print("slice: one bucket-%d batch: forward (input upload to last "
          "kernel) %.1f ms, logits to host %.1f ms"
          % (MAX_BATCH, forward_ms, copy_ms))

    # 2 served rows against the same model run through the port on the host
    rows = np.concatenate([requests[0], requests[1][:1]])
    served = np.concatenate([outs[0], outs[1][:1]])
    t0 = time.perf_counter()
    host = mx.Predictor(symbol.tojson(), arg_params, {"data": rows.shape},
                        ctx=mx.cpu())
    host.forward(data=rows)
    want = host.get_output(0).asnumpy()
    err = np.abs(served - want)
    agree = float(np.mean(served.argmax(-1) == want.argmax(-1)))
    ok = bool((err <= SERVE_TOL["atol"]
               + SERVE_TOL["rtol"] * np.abs(want)).all())
    print("slice: 2 served rows vs the host path (%.1f s): max_abs_err %.3g "
          "(atol %g rtol %g), argmax agreement %.5f %s"
          % (time.perf_counter() - t0, float(err.max()), SERVE_TOL["atol"],
             SERVE_TOL["rtol"], agree, "ok" if ok else "FAIL"))
    if not ok or agree < 0.999:
        raise AssertionError("served logits disagree with the host path")
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(HERE, "mxnet_tpu_torch")):
        print("chip_smoke: mxnet_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 3
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card: %s" % card_line())
    print("torch %s, CUDA %s, %d device(s)"
          % (torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    t0 = time.perf_counter()
    _build.build_all(["flash_attn_fwd"])
    print("kernels built in %.1f s" % (time.perf_counter() - t0))
    for name, info in sorted(_build.BUILD_INFO.items()):
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln]
        print("  %s: %.1f s; %s" % (name, info["seconds"], "; ".join(regs)))

    records = check_kernels(args.seed)
    launches = serve(mx, args.seed)
    records[0]["launches"] = launches
    print(card_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
