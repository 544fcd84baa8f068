#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which raises on failure:

1. Card: the card's name and power limit, torch and CUDA versions, and
   the build of every kernel source (one ``nvcc`` each, in parallel),
   with each compiled kernel's registers and spills from ``ptxas``.
2. Kernels against their plain PyTorch versions on the card:
   - the flash-attention forward at the serving shape (B 4, S 1024, H 12,
     D 64, causal, f32) and at S 1000 non-causal, ragged ``kv_lens`` with
     a 0, D 128, and bf16;
   - ``bn_channel_sums``, single and paired, at ResNet-50's BatchNorm
     inputs (32, 3, 224, 224), (32, 64, 112, 112), (32, 2048, 7, 7), an
     odd (3, 5, 7, 9), and in bf16; at bn0 timed one call, back to back,
     on the device alone (torch.profiler) and on the host per wrapper
     call, beside ``batch_norm_stats`` (stats) and
     ``batch_norm_backward_reduce`` with mean 0 and invstd 1 (the pair);
     then all 13 BatchNorm input shapes of ResNet-50 v2 at batch 32,
     single and paired, back to back against the library calls, summed
     over the 51 BatchNorms into ms per training step beside the step's
     aggregate bound;
   - ``max_pool_backward`` at the stem (3x3/s2/p1 over (32, 64, 112, 112)
     post-ReLU, many tied zeros), a ``full``-convention case and bf16;
   - ``avg_pool_backward`` at the global 7x7 pool (f32 and bf16),
     3x3/s2/p1 with ``count_include_pad=False`` and ``full``, and
     ``sum``; the global pool's backward through autograd launches its
     kernel and nothing else;
   each with the kernel's and the plain version's times beside the bound
   (the pooling backwards and bn0 also back to back, on the device alone
   and as host time per wrapper call)
   (for f32 attention: f32-accurate work on the tensor cores, three TF32
   passes, printed beside the CUDA cores' f32 figure), and one PyTorch
   call computing the same function as a yardstick
   (``scaled_dot_product_attention``, whose device kernel
   ``torch.profiler`` names, ``batch_norm_stats``, the aten pooling
   backwards: timed only, the port never calls them); then the repairs'
   instances: flash attention at head_dim 32 (B 8, S 1024, H 4, causal,
   f32 and bf16, both variants and the gradients), ``bn_channel_sums`` in
   f16 and f64 at (32, 64, 112, 112) and (32, 2048, 7, 7), and both pool
   backwards in f16 and f64 at the stem and the global pool (bit for
   bit), each timed beside its bound and the library call in its dtype;
   and the bf16 instances phase 8's main path launches (``bn_channel_
   sums`` at bn0, the max pool at the stem, the global avg pool), timed
   the same way; and ``max_pool_backward`` at LeNet's two 2x2/s2 pools,
   (64, 20, 24, 24) and (64, 50, 8, 8) (phase 11's path), bit for bit,
   timed the same way; and ``bn_channel_sums`` at DCGAN's seven
   BatchNorm inputs (phase 12's path), single and paired, timed the same
   way beside ``batch_norm_stats`` / ``batch_norm_backward_reduce``.
3. Serving: a GPT-2-small-width TransformerLM (vocab 50257, context
   1024, width 768, 12 heads, 12 layers, FFN 3072; random weights from
   ``--seed``) served by ``Server(max_batch_size=4)``: warmup with its
   zero-rebuild verify, 8 concurrent requests of 1-3 rows, output shapes
   and finiteness, the flash launch count (12 per forward), and 2 served
   rows against the same model run through the port on the host.
4. Training: ResNet-50 v2 at full depth and width (f32, TF32 off) through
   ``Module.fit`` for one epoch of 4 batches of 32 (random images and
   labels from ``--seed``), SGD with momentum, on the fused train step
   (one eager step, then one CUDA graph replayed): finite per-batch
   cross-entropy, every parameter and BatchNorm moving statistic moved,
   per step exactly the kernel launches the graph implies (2 channel-sums
   per BatchNorm, 1 max- and 1 avg-pool backward), 0 launches in a
   following ``score``; ms per step of the fused graph; then, on the
   general path (the fused step left explicitly), ms per step with its
   forward/backward/update split and a profiled step (each hand-written
   kernel one device kernel, its device time and launches), and one
   batch-2 forward and backward on the card against the host (gradients
   within 1e-3 relative L2, or within 4 times the host's own largest
   change when its input moves by one ulp).
5. Gluon training: the zoo TransformerLM at GPT-2 small's widths,
   hybridized, f32 with TF32 off, batch 8 of 1024 random tokens from
   ``--seed``, ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``backward`` -> ``Trainer(..., "adam", lr 6e-4).step``: 2 warm-up and
   5 timed steps and 1 profiled step on one batch, finite falling losses,
   every parameter moved (the q/k/v projections included), exactly 12
   LSE flash launches per step and 12 LSE-less ones (no LSE) in a
   ``predict_mode`` forward, ms per step, tokens/s, the forward/backward/
   update split, the device-busy share and peak memory, and a 2-layer
   full-width copy's batch-1 gradients on the card against the host's
   (1e-3 relative L2 each).
6. Gluon vision training: ``gluon.model_zoo.vision.resnet50_v2(classes=
   1000)``, Xavier (gaussian, in, 2) from ``--seed``, hybridized, f32 with
   TF32 off, batch 32 of random 3x224x224 images and labels,
   ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` -> ``backward`` ->
   ``Trainer(..., "sgd", lr 0.01, momentum 0.9, wd 1e-4).step``: 2
   warm-up, 5 timed and 1 profiled step; finite losses, every trainable
   parameter and moving statistic moved, per step exactly the launches
   the net implies (counted from its blocks: 101 channel sums, 1 max- and
   1 avg-pool backward), 0 in a ``predict_mode`` forward; the trained net
   exported and loaded back as a ``SymbolBlock`` (the same predict
   forward, the same launches in a Trainer step); and a batch-2 card-vs-
   host gradient check by phase 4's rule.
7. Gluon recurrent training: Zaremba, Sutskever and Vinyals' medium LSTM
   language model (the Gluon word-language-model example's ``RNNModel``:
   vocabulary 10,000, embedding 650, 2 LSTM layers of 650, dropout 0.5,
   untied decoder; 19,780,400 parameters, uniform +-0.05 from ``--seed``),
   f32 with TF32 off, random token ids read through ``gluon.data.
   DataLoader(ArrayDataset(...), batch_size=20, last_batch="discard",
   num_workers=2)`` in the example's batchify order, bptt 35, the state
   carried and detached between batches, ``autograd.record()`` ->
   ``SoftmaxCrossEntropyLoss`` -> ``backward`` -> ``clip_global_norm``
   (5 * 35 * 20) -> ``Trainer(..., "sgd", lr 1.0).step(20)``: 2 warm-up,
   5 timed and 1 profiled step; finite losses, every parameter moved,
   peak memory flat from the 3rd to the 7th step, no hand-written kernel
   launched, ms per step, tokens/s, the forward/backward/clip/update
   split, the device-busy share and device time by kernel and by host
   op; one LSTM-layer forward beside ``torch.nn.LSTM`` on a packed
   weight buffer (the cost of the flat weight layout); a batch-2 card-vs-
   host check with dropout off (the LSTM output atol=rtol=1e-4, every
   gradient 1e-3 relative L2); a 2-layer GRU and a bidirectional
   ``rnn_tanh`` layer at width 256, T 35, card against host, and
   ``LSTMCell.unroll`` against the fused LSTM on the card; ``CTCLoss`` at
   N 32, T 200, 29 classes, labels up to 50, card against host (loss and
   gradient atol=rtol=1e-4), timed beside ``torch.nn.functional.ctc_loss``.
8. bf16 fused Module training: ResNet-50 v2 built with ``dtype=
   "bfloat16"`` (bf16 conv/FC weights, f32 BatchNorm parameters and
   statistics), Xavier (gaussian, in, 2) from ``--seed``, batch 32 of
   random images through ``NDArrayIter``, ``Module.fit`` for 2 epochs of 6
   batches with SGD lr 0.1, momentum 0.9, wd 1e-4, ``multi_precision``
   (f32 masters), ``MultiFactorScheduler(step=[4], factor=0.1)``,
   ``Speedometer(32, 2)`` and ``module_checkpoint(..., save_optimizer_
   states=True)``, cuDNN deterministic: the fused step ran, one capture
   replayed for every batch after the first, ``num_update`` a batch, the
   lr down at update 5, finite losses, every master and moving statistic
   moved, bf16 storage and f32 masters, the Speedometer lines in the JAX
   package's format; per step and per profiled replay exactly the bf16
   kernel launches the graph implies; 1 eager + 3 graph steps against 4
   steps of the eager general path from one state (``mp_sgd_mom_update``)
   and ``Module.load(prefix, 1, load_optimizer_states=True)`` + ``fit(
   begin_epoch=1)`` against the uninterrupted run (masters and momenta
   within 1e-6 relative L2, the bit-for-bit count printed); a batch-2
   bf16 step on the card against the host by phase 4's rule; ms per step
   and images/s of the bf16 graph and the bf16 general path, capture
   time, device-busy shares, device time by kernel group and peak memory.
9. Bucketed training: BASELINE config 4's LSTM language model
   (``examples/rnn/lstm_bucketing.py`` at ``bench.py``'s ``_bench_lstm``
   widths: vocabulary 10,000, embedding 200, 2 LSTM layers of 200 in a
   ``FusedRNNCell``, batch 32; 4,653,200 parameters) on 4,000 sentences
   of lengths 5-39 drawn from ``--seed`` by the example's generator,
   split 4:1, through ``mx.rnn.BucketSentenceIter`` (buckets 10, 20, 30,
   40) and ``BucketingModule.fit`` for 2 epochs with the example's SGD
   (lr 0.01, wd 1e-5), Xavier (in, 2.34), ``Perplexity(0)`` on the eval
   split and the Speedometer, cuDNN deterministic: every bucket trained
   through a fused step of its own, captured once and replayed for every
   later batch of it, over one set of parameter tensors and one optimizer
   state; ``num_update`` a batch; finite losses and eval perplexities;
   the eval split's perplexity over every label (the objective, padding
   included) below its value before the fit after each epoch (which
   learning the padding label alone achieves); no hand-written kernel
   launched; the same fit from the same state on the same batches with
   every bucket on the eager general path, its per-batch cross-entropy
   and eval perplexities within 1e-5 relative.  Then 3 rounds over the
   buckets from one state with SGD momentum 0.9 through the graphs
   against the eager general path (one Updater), and the same with a
   ``Monitor(1)`` installed before the last round (every bucket's step
   retired, every op output reported), masters and momenta within 1e-6
   relative L2 under deterministic cuDNN; a bucket-10 step at batch 32 on
   the card against the host (outputs within 1e-5 and gradients within
   1e-3 relative L2); ms per step and tokens/s per bucket of the graph replay
   and of the eager general path, capture time and graph-pool memory per
   bucket, the fit's time, the busy share and device time by group of a
   profiled replay and eager step, and peak memory.
10. The rest of serving, f32 with TF32 off:
   a. paged-KV decode of the zoo TransformerLM at GPT-2 small's widths
      (weights as phase 3's, through ``decode_param_arrays()``): slot
      count 8, pages of 16 tokens, a 512-page pool; one stream of 900 +
      100 tokens, 16 streams of 16-512 prompt and 32-128 new tokens
      submitted two steps apart, a 256-token head with 4 different
      16-token tails (the first fills the prefix cache), then the head
      whole (a copy-on-write).  Checks: 0 plan builds and 0 captures
      after ``warmup()``; the tail and whole resubmissions hit 16 prefix
      pages, the whole one clones one page; 3 streams bit for bit (tokens
      and logits) their decode alone on a fresh decoder of the same slot
      count and pool; their logits within 2e-3 of the zoo net's full-
      sequence forward over the same tokens on the card and on the host;
      the same traffic through a graph decoder and an eager one bit for
      bit.  Prints tokens/s, ms per 8-slot step (replay, eager), capture
      ms, the logits copy to the host apart, the busy share of a profiled
      replay, pages high water, prefix hits and clones.
   b. BASELINE config 4's LSTM LM (vocabulary 10,000, embedding 200, two
      ``LSTMCell``s of 200, FC 10,000) as one step symbol with four
      states through ``ContinuousBatcher`` (8 slots, 32 streams of 10-40
      tokens joining and leaving): 0 plan builds after warmup, 3 streams
      bit for bit their solo decodes, card vs host atol=rtol=1e-4;
      steps/s.
   c. int8 ResNet-50 v2 (1000 classes, 3x224x224, He-normal weights from
      ``--seed``, trained-like BatchNorm statistics: each layer's batch
      statistics over a calibration batch; its logits, the graph below
      ``SoftmaxOutput``) through
      ``Server(max_batch_size=32).add_model(quantize="int8")``, dynamic
      and calibrated over 4 batches of 32, beside the f32 model: 0 plan
      builds after warmup across buckets 1-32; the
      ``torch._int_mm`` route's int32 accumulators bit for bit the plain
      version's at every distinct convolution shape and the FC; 2 served
      rows of each model against the port's int8 on the host (relative
      L2 within 1e-2); per quantized layer, the op run on the card over
      the host's own input: int8 activations equal but at exact .5 ties,
      outputs within 1e-5, and whether the card's own input equals the
      host's; prints int8 vs f32 (max deviation, relative L2, top-1
      agreement), ms per bucket of both and images/s.
   d. ``FleetServer(ctxs=[gpu(0), gpu(0)], max_batch_size=8)`` over that
      int8 model: bucket costs measured at warmup, 16 concurrent
      requests of 1-8 rows, every response bit for bit a serverless
      replay of its dispatch bucket, both replicas dispatched.
   e. ``save_checkpoint`` -> ``Server.load_model(..., quantize="int8")``
      with the HTTP front end: one image POSTed under both route
      spellings equals ``submit`` bit for bit; ``/healthz``, ``/metrics``.
11. BASELINE config 1, f32 with TF32 off:
   a. MNIST-format idx files written from ``--seed`` (60,000 training and
      10,000 test 28x28 images, each a class's stroke template shifted,
      scaled and noised);
   b. LeNet (``models/lenet.py``) through ``MNISTIter`` ->
      ``Module(context=gpu(0)).fit`` for one epoch at the example's
      settings (batch 64, SGD lr 0.05, momentum 0.9, wd 1e-4, Xavier):
      the fused step (one CUDA graph) carries every batch, 2
      ``max_pool_backward`` launches a step, equal to a profiled replay's
      device launches (in a process of its own); ms per step, images/s,
      train accuracy (at least 0.9, chance 0.1) and the test file's score;
   c. the MLP (``models/mlp.py``) the same way over ``MNISTIter(flat=
      True)``;
   d. LeNet's first 3 steps from the same weights and batches on the card
      and on the host: outputs within 1e-4 and gradients within 1e-3
      relative L2;
   e. ``mx.test_utils.check_consistency`` over [cpu(0), gpu(0)] on LeNet,
      the MLP and one graph per operator (``==``, ``!=``, ``**``, ``%``)
      and per op of the 29 fluent methods, within 1e-4;
   f. each of the 12 symbol zoo builders: one inference forward of its
      logits at batch 2, at its input size (299 for the inception v3/v4/
      resnet-v2 builders, 28 for LeNet and the MLP, 224 for the rest),
      1000 classes, weights and BatchNorm statistics from ``--seed``,
      timed, against the host within 2e-3 relative L2.
12. MXNet 1.0's ``example/gan/dcgan.py`` (Radford et al. 2016) at its
   widths, f32 with TF32 off:
   a. phase 11's training images resized to 64x64 (bilinear), tiled to 3
      channels and scaled to [-1, 1], read through ``NDArrayIter(shuffle=
      True)`` after ``mx.random.seed``; the generator (5 ``Deconvolution``s,
      ngf 64, train-mode ``BatchNorm``) and the discriminator (4x4
      stride-2 convolutions, ndf 64, ``LeakyReLU`` 0.2, BatchNorm,
      ``LogisticRegressionOutput``) as two Modules, Normal(0.02), Adam lr
      2e-4 beta1 0.5; 200 iterations of batch 64 of dcgan.py's loop (noise
      from ``mx.random.normal`` on the card; D on fake, its gradients
      copied; D on real, the copies added into ``modD._exec_group.
      grad_arrays``; ``modD.update()``; D on fake as real,
      ``get_input_grads()`` into ``modG.backward``; ``modG.update()``):
      finite losses, D's accuracy off chance, 26 ``bn_channel_sums``
      launches every iteration (equal to a profiled iteration's device
      launches, in a process of its own); ms per iteration, images/s, its
      split into G forward, the three D passes, G backward and the two
      updates, the busy share and peak memory;
   b. its first 2 iterations from the same host-made weights, noise and
      images on the card and on the host: outputs within 1e-4, gradients
      and updated parameters within 1e-3 relative L2 or 4 times the host's
      one-ulp floor (phase 4's rule);
   c. every random op on the card: 10^6 draws at two parameter settings
      (uniform and normal also in f16 and f64), support, mean and variance
      within 6 standard errors, the same seed the same bits, another seed
      others, ``torch.manual_seed`` nothing; multinomial by chi-square at p
      1e-4 (and its p-values over 20 seeds uniform) with ``get_prob``
      exact; ``_shuffle`` a permutation;
      ``sgld_update``'s noise by its moments;
   d. ``Module.fit`` of a graph that adds ``mx.sym.random.normal`` noise to
      its input, on the fused step as one CUDA graph, against the eager
      general path from the same generator state (1e-6), replays drawing
      fresh noise;
   e. ``check_consistency`` over [cpu(0), gpu(0)] and the training
      backward on the 8 new ``nn`` ops at real shapes (the sequence ops at
      T 35, N 20, C 650 with ragged lengths, ``UpSampling`` at (64, 128,
      16, 16), the regression heads at (64, 1) and (64, 10)) and the 4
      deterministic update ops at (2600, 650), within 1e-4.
13. The ``kernels`` JSON line (each kernel's record with its launches on
   every path, phase 10's five and the MLP's with 0 of each, LeNet's with
   2 max-pool backwards a step, DCGAN's with 26 channel sums an
   iteration, and its bf16/f16/f64, head_dim 32, LeNet and DCGAN
   instances), then the result line.

Exits non-zero, printing no result, when there is no CUDA device or the
package is not beside this script.
"""
from __future__ import annotations

import argparse
import json
import os
import random
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
PEAK_F32_FLOPS = 67e12      # CUDA cores
PEAK_TF32_FLOPS = 494.7e12  # tensor cores
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# f32-accurate products on the tensor cores: three TF32 passes (3xTF32)
PEAK_TF32X3_FLOPS = PEAK_TF32_FLOPS / 3

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=0.0)
# sums of bf16 inputs are f32 outputs summed in f32 from the same inputs,
# so they keep the f32 relative tolerance beside the bf16 absolute one
BF16_SUM_TOL = dict(atol=2e-2, rtol=1e-4)
SERVE_TOL = dict(atol=2e-3, rtol=2e-3)

# training configuration: ResNet-50 v2 (He et al. 2016, "Identity Mappings
# in Deep Residual Networks"; depths and widths of MXNet's
# example/image-classification/symbols/resnet.py), batch 32 as bench.py
RESNET = dict(num_classes=1000, num_layers=50, image_shape="3,224,224")
TRAIN_BATCH = 32
TRAIN_BATCHES = 4
TIMED_STEPS = 5
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
HOST_BATCH = 2
HOST_OUT_TOL = dict(atol=1e-3, rtol=1e-3)
HOST_GRAD_REL = 1e-3
HOST_AUX_TOL = 1e-4

# Gluon training configuration: the same GPT-2-small widths, batch 8
GLUON_BATCH = 8
GLUON_WARMUP, GLUON_TIMED = 2, 5
ADAM = {"learning_rate": 6e-4}
GLUON_HOST_LAYERS = 2
GLUON_GRAD_REL = 1e-3
LSE_TOL = dict(atol=1e-4, rtol=1e-4)
# the default zoo TransformerLM's head_dim at a training shape: B, Sq, Sk,
# H, D
D32_FLASH = (8, 1024, 1024, 4, 32)
# flash backward (f32): the same f32 math in another order
FLASH_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


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


def _bound(ops, nbytes, peak):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms_back_to_back(fn, launches=20, reps=10):
    """Median over ``reps`` runs of ``launches`` calls in a row between two
    CUDA events, per call: the kernel's own time, with the host's launch
    overhead hidden behind the queued work (``time_ms`` times one call
    and so also counts the wrapper's host time)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return float(np.median(times))


def host_us(fn, calls=1000):
    """Host microseconds per call of ``fn`` over ``calls`` calls in a row,
    the stream not synchronized: the wrapper's own cost, as long as the
    device keeps up (a kernel longer than the wrapper makes the launch
    queue, and this figure, wait for it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def device_ms_per_call(fn, calls=20):
    """(device ms, device kernels) per call of ``fn``, from torch.profiler
    over ``calls`` calls in a row: the kernels' own time, no host time.
    None when the profiler saw no device events."""
    rows = profile_kernels(lambda: [fn() for _ in range(calls)])
    if not rows:
        return None
    return (sum(ms for _, ms, _ in rows) / calls,
            sum(n for _, _, n in rows) / calls)


def _device_text(dev):
    return "not measured" if dev is None else \
        "%.4f ms (%.0f kernel%s a call)" % (dev[0], dev[1],
                                           "" if dev[1] == 1 else "s")


def flash_bound(q, sk, causal, kv_lens, extra_bytes=0):
    """Least time (ms) the card needs for this attention call, and what
    bounds it: 4*D*H operations per valid (row, key) pair of these
    inputs, at f32 accuracy on the tensor cores (three TF32 passes) for
    f32 and at the bf16 rate for bf16, against q, k, v read once and o
    (and ``extra_bytes`` more output) written once.  Also returns the
    bound at the CUDA cores' f32 rate, the figure used before the kernel
    ran on the tensor cores."""
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
    nbytes += extra_bytes
    if q.dtype != torch.float32:
        bound = _bound(ops, nbytes, PEAK_BF16_FLOPS)
        return bound, bound
    return (_bound(ops, nbytes, PEAK_TF32X3_FLOPS),
            _bound(ops, nbytes, PEAK_F32_FLOPS))


def _instance(label, max_err, ms, plain_ms, bound, library_ms):
    return {"instance": label, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def check_flash(seed):
    """Phase 2a: the flash kernel against its plain version on the card,
    timed at the serving shape (its record for the kernels line) and at
    the default LM's head_dim 32 in f32 and bf16 (its instances).
    Returns ([record], [(name, instance)])."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = [  # name, B, Sq, Sk, H, D, causal, dtype, kv_lens, timed as
        ("serving", 4, 1024, 1024, 12, 64, True, torch.float32, None,
         "record"),
        ("s1000-full", 2, 1000, 1000, 12, 64, False, torch.float32, None,
         None),
        ("ragged-lens", 4, 256, 256, 12, 64, True, torch.float32,
         [256, 0, 77, 130], None),
        ("d128", 2, 512, 512, 8, 128, True, torch.float32, [512, 300], None),
        ("bf16", 4, 1024, 1024, 12, 64, True, torch.bfloat16, None, None),
        *(("d32-" + dt, *D32_FLASH, True, getattr(torch, dt), None,
           "instance") for dt in ("float32", "bfloat16")),
    ]
    record, instances = None, []
    for name, b, sq, sk, h, d, causal, dtype, lens, timed in cases:
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
        if timed is None:
            continue
        run = lambda: K.flash_attention(  # noqa: E731
            q, k, v, causal=True, scale=scale)
        ms = time_ms(run)
        plain_ms = time_ms(lambda: K._reference_attention(q, k, v, True,
                                                          scale))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, scale=scale)
        library_ms = time_ms(sdpa)
        (bound_ms, bound_by), old = flash_bound(q, sk, True, None)
        print("kernel flash_attn_fwd %s: %.4f ms, plain %.4f ms, "
              "sdpa %.4f ms, bound %.4f ms (%s, 3xTF32 for f32), roofline "
              "share %.1f%%; at the CUDA cores' f32 rate the bound is %.4f "
              "ms (share %.1f%%); card %s"
              % (name, ms, plain_ms, library_ms, bound_ms, bound_by,
                 100.0 * bound_ms / ms, old[0], 100.0 * old[0] / ms,
                 card_line()))
        print("kernel flash_attn_fwd %s, %d calls back to back: %.4f ms "
              "a call, sdpa %.4f ms"
              % (name, 20, time_ms_back_to_back(run),
                 time_ms_back_to_back(sdpa)))
        if timed == "instance":
            instances.append(("flash_attn_fwd", _instance(
                name, max_err, ms, plain_ms, (bound_ms, bound_by),
                library_ms)))
            continue
        sdpa_kernels = profile_kernels(sdpa)
        print("sdpa at the serving shape runs: %s"
              % "; ".join("%s (%.4f ms)" % kv[:2] for kv in sdpa_kernels))
        record = {"name": "flash_attn_fwd", "route": "cuda",
                  "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
                  "replaces": "mxnet_tpu/ops/pallas_kernels.py:338",
                  "launches": 0, "max_abs_err": max_err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": library_ms}
    return [record], instances


def flash_bwd_bound(q, causal):
    """Least time (ms) of the flash backward at these shapes: 10*D*H
    operations per valid (row, key) pair (recomputed scores, dP, dV, dQ,
    dK) at f32 accuracy on the tensor cores (3xTF32), against q, k, v, o,
    dO and the LSE read once and dq, dk, dv written once; and the same at
    the CUDA cores' f32 rate, the figure used before."""
    b, s, h, d = q.shape
    pairs = b * (s * (s + 1) // 2 if causal else s * s)
    ops = 10 * d * h * pairs
    nbytes = 4 * (8 * q.numel() + b * h * s)
    return (_bound(ops, nbytes, PEAK_TF32X3_FLOPS),
            _bound(ops, nbytes, PEAK_F32_FLOPS))


def check_flash_lse(seed):
    """Phase 2a': the kernel's LSE variant and the differentiable
    attention (``_FlashAttnFn``) against their plain versions on the
    card, timed at the LM's training shape (the LSE variant's record for
    the kernels line) and at head_dim 32 in f32 and bf16 (its instances).
    Returns ([record], [(name, instance)])."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    cases = [  # name, B, S, H, D, causal, dtype, kv_lens, timed as
        ("train", GLUON_BATCH, 1024, 12, 64, True, torch.float32, None,
         "record"),
        ("d128-bf16", 2, 512, 8, 128, True, torch.bfloat16, None, None),
        ("ragged-lens", 4, 256, 12, 64, True, torch.float32,
         [256, 0, 77, 130], None),
        *(("d32-" + dt, D32_FLASH[0], *D32_FLASH[2:], True,
           getattr(torch, dt), None, "instance")
          for dt in ("float32", "bfloat16")),
    ]
    record, instances = None, []
    for name, b, s, h, d, causal, dtype, lens, timed in cases:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        kl = None if lens is None else \
            torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = 1.0 / d ** 0.5
        out, lse = K.flash_attention(q, k, v, causal=causal, scale=scale,
                                     kv_lens=kl, with_lse=True)
        ref_out, ref_lse = K._reference_attention_lse(q, k, v, causal, scale,
                                                      kl)
        torch.cuda.synchronize()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err_o, ok_o = _agree(out, ref_out, tol)
        err_l, ok_l = _agree(lse, ref_lse, LSE_TOL)
        # the gradients: kernel LSE forward + flash backward, against the
        # plain forward's (out, lse) through the same backward and against
        # torch autograd through the plain forward
        dout = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        got = torch.autograd.grad(
            K.attention(qg, kg, vg, causal=causal, scale=scale, kv_lens=kl),
            (qg, kg, vg), dout)
        plain = K._flash_backward(q, k, v, ref_out, ref_lse, dout, causal,
                                  scale, kl)
        qa, ka, va = (t.float().clone().requires_grad_() for t in (q, k, v))
        auto = torch.autograd.grad(
            K._reference_attention(qa, ka, va, causal, scale, kl),
            (qa, ka, va), dout.float())
        torch.cuda.synchronize()
        gtol = FLASH_GRAD_TOL if dtype == torch.float32 else \
            dict(atol=3e-2, rtol=3e-2)
        errs = [_agree(g, w, gtol) for g, w in zip(got, plain)] \
            + [_agree(g, w, gtol) for g, w in zip(got, auto)]
        err_g = max(e for e, _ in errs)
        ok = ok_o and ok_l and all(o for _, o in errs)
        print("kernel flash_attn_fwd_lse %-11s B%d S%d H%d D%d %s: out "
              "max_abs_err %.3g, lse %.3g (atol %g rtol %g), dq/dk/dv vs "
              "plain and vs autograd %.3g (atol %g rtol %g) %s"
              % (name, b, s, h, d, str(dtype).replace("torch.", ""), err_o,
                 err_l, LSE_TOL["atol"], LSE_TOL["rtol"], err_g,
                 gtol["atol"], gtol["rtol"], "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("the LSE variant or its backward disagrees "
                                 "with the plain version on case %s" % name)
        if timed is None:
            continue
        del qa, ka, va, auto
        run = lambda: K.flash_attention(  # noqa: E731
            q, k, v, causal=True, scale=scale, with_lse=True)
        ms = time_ms(run)
        plain_ms = time_ms(lambda: K._reference_attention_lse(
            q, k, v, True, scale))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, scale=scale)
        library_ms = time_ms(sdpa)
        # the LSE output adds its f32 [B, H, S] to the bytes written
        (bound_ms, bound_by), old = flash_bound(q, s, True, None,
                                                extra_bytes=4 * b * h * s)
        _report("kernel flash_attn_fwd_lse %s" % name, ms, plain_ms,
                library_ms, (bound_ms, bound_by))
        print("kernel flash_attn_fwd_lse %s: at the CUDA cores' f32 rate "
              "the bound is %.4f ms (share %.1f%%); %d calls back to back: "
              "%.4f ms a call, sdpa forward %.4f ms"
              % (name, old[0], 100.0 * old[0] / ms, 20,
                 time_ms_back_to_back(run), time_ms_back_to_back(sdpa)))
        if timed == "instance":
            instances.append(("flash_attn_fwd_lse", _instance(
                name, max(err_o, err_l), ms, plain_ms, (bound_ms, bound_by),
                library_ms)))
            continue
        record = {"name": "flash_attn_fwd_lse", "route": "cuda",
                  "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
                  "replaces": "mxnet_tpu/ops/pallas_kernels.py:338",
                  "launches": 0, "max_abs_err": max(err_o, err_l),
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": library_ms}
        bwd_ms = time_ms(lambda: K._flash_backward(q, k, v, out, lse, dout,
                                                   True, scale))
        st = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            scale=scale)
        dt = dout.transpose(1, 2)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
            st, (qt, kt, vt), dt, retain_graph=True))
        bwd_bound, bwd_old = flash_bwd_bound(q, True)
        print("flash backward (torch ops, not a TPU kernel) train: %.4f ms, "
              "sdpa backward %.4f ms, bound %.4f ms (%s, 3xTF32), roofline "
              "share %.1f%%; at the CUDA cores' f32 rate the bound is %.4f ms "
              "(share %.1f%%); card %s"
              % (bwd_ms, sdpa_bwd_ms, bwd_bound[0], bwd_bound[1],
                 100.0 * bwd_bound[0] / bwd_ms, bwd_old[0],
                 100.0 * bwd_old[0] / bwd_ms, card_line()))
    return [record], instances


def bytes_bound(nbytes):
    """Least ms to move ``nbytes`` at the card's memory rate."""
    return nbytes / PEAK_BYTES * 1e3, "bytes"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _agree(got, want, tol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
    return float(err.max()) if err.numel() else 0.0, ok


def _report(line, rec_ms, plain_ms, lib_ms, bound):
    print("%s: %.4f ms, plain %.4f ms, library %.4f ms, bound %.4f ms "
          "(%s), roofline share %.1f%%; card %s"
          % (line, rec_ms, plain_ms, lib_ms, bound[0], bound[1],
             100.0 * bound[0] / rec_ms, card_line()))


# ResNet-50 v2's train-mode BatchNorm inputs at batch 32 (f32), each with
# the number of BatchNorms that see it: 51 in all (MXNet's resnet.py v2
# bottleneck graph, models/resnet.py)
BN_STEP_SHAPES = [
    ((32, 3, 224, 224), 1), ((32, 64, 112, 112), 1), ((32, 64, 56, 56), 7),
    ((32, 128, 56, 56), 1), ((32, 256, 56, 56), 3), ((32, 128, 28, 28), 7),
    ((32, 256, 28, 28), 1), ((32, 512, 28, 28), 4), ((32, 256, 14, 14), 11),
    ((32, 512, 14, 14), 1), ((32, 1024, 14, 14), 6), ((32, 512, 7, 7), 5),
    ((32, 2048, 7, 7), 3)]


def bn_library(a, pair):
    """One PyTorch call over the same inputs: ``batch_norm_stats`` for the
    statistics (mean and invstd, the same reads), and for the pair
    ``batch_norm_backward_reduce`` with mean 0 and invstd 1, whose
    (sum dy, sum dy * (x - mean)) is the kernel's (sum a, sum a * b)."""
    import torch
    if pair is None:
        return lambda: torch.batch_norm_stats(a, 1e-5)
    c = a.shape[1]
    zero = torch.zeros(c, device=a.device)
    one = torch.ones(c, device=a.device)
    return lambda: torch.batch_norm_backward_reduce(a, pair, zero, one, None,
                                                    True, False, False)


def bn_bytes(a, pair):
    return _nbytes(a) * (1 if pair is None else 2) + 2 * 4 * a.shape[1]


def check_bn_sums(seed):
    """Phase 2b: bn_channel_sums against its plain version; timed at the
    input of BatchNorm bn0 (stats and pair; the record for the kernels
    line), in bf16 at bn0's input, at (32, 256, 14, 14) and at (32, 2048,
    7, 7), in f16 and f64 at bn0's input and at (32, 2048, 7, 7), each
    beside ``batch_norm_stats`` in the same dtype (its instances), then the
    13-shape sweep.  Inputs have a nonzero mean so that no channel sum sits
    near 0, where only atol would hold; f16 and f64 inputs are summed in
    f32, so their sums keep the f32 tolerance.  Returns ([record],
    [(name, instance)])."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    cases = [  # shape, dtype, timed as
        ((32, 3, 224, 224), torch.float32, None),
        ((32, 64, 112, 112), torch.float32, "record"),
        ((32, 2048, 7, 7), torch.float32, None),
        ((3, 5, 7, 9), torch.float32, None),
        # bf16: bn0's input takes the 8-wide loads; the 14x14 and 7x7
        # planes of the later stages take the one-element ones
        *((shape, torch.bfloat16, "instance") for shape in (
            (32, 64, 112, 112), (32, 256, 14, 14), (32, 2048, 7, 7))),
        *((shape, dtype, "instance") for dtype in (torch.float16,
                                                   torch.float64)
          for shape in ((32, 64, 112, 112), (32, 2048, 7, 7)))]
    record, instances = None, []
    for shape, dtype, timed in cases:
        draw = torch.float64 if dtype == torch.float64 else torch.float32
        a = (torch.randn(*shape, generator=gen, device=dev, dtype=draw)
             + 0.5).to(dtype)
        b = (torch.randn(*shape, generator=gen, device=dev, dtype=draw)
             + 0.5).to(dtype)
        tol = BF16_SUM_TOL if dtype == torch.bfloat16 else F32_TOL
        for pair in (None, b):
            got = K.bn_channel_sums(a, pair)
            want = K._plain_channel_sums(a, pair)
            again = K.bn_channel_sums(a, pair)
            torch.cuda.synchronize()
            errs = [_agree(g, w, tol) for g, w in zip(got, want)]
            max_err = max(e for e, _ in errs)
            same = all(torch.equal(g, h) for g, h in zip(got, again))
            ok = all(o for _, o in errs) and same
            print("kernel bn_channel_sums %-18s %-6s %s: max_abs_err %.3g "
                  "(atol %g rtol %g), rerun bit-identical %s %s"
                  % ("x".join(map(str, shape)),
                     "single" if pair is None else "paired",
                     str(dtype).replace("torch.", ""), max_err, tol["atol"],
                     tol["rtol"], same, "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("bn_channel_sums disagrees with its "
                                     "plain version at %s" % (shape,))
            if timed is None:
                continue
            run = lambda: K.bn_channel_sums(a, pair)  # noqa: E731
            form = "stats" if pair is None else "pair"
            if timed == "instance":
                label = "%s-%s-%s" % ("x".join(map(str, shape)), form,
                                      str(dtype).replace("torch.", ""))
                ms = time_ms(run)
                plain_ms = time_ms(lambda: K._plain_channel_sums(a, pair))
                # batch_norm_stats in the same dtype; the pair's yardstick
                # takes f32 statistics only
                lib_ms = time_ms(bn_library(a, None)) if pair is None \
                    else None
                bound = bytes_bound(bn_bytes(a, pair))
                print("kernel bn_channel_sums %s: %.4f ms, plain %.4f ms, "
                      "batch_norm_stats %s, bound %.4f ms (%s), roofline "
                      "share %.1f%%; device only %s; card %s"
                      % (label, ms, plain_ms, "%.4f ms" % lib_ms
                         if lib_ms is not None else "not timed (pair)",
                         bound[0], bound[1], 100.0 * bound[0] / ms,
                         _device_text(device_ms_per_call(run)), card_line()))
                instances.append(("bn_channel_sums", _instance(
                    label, max_err, ms, plain_ms, bound, lib_ms)))
                continue
            lib = bn_library(a, pair)
            if pair is None:
                lib_note = "batch_norm_stats"
            else:  # the yardstick computes the kernel's function
                lib_note = ("batch_norm_backward_reduce, whose sums are "
                            "max_abs_err %.3g from the plain version"
                            % max(_agree(r, w, F32_TOL)[0]
                                  for r, w in zip(lib()[:2], want)))
            ms = time_ms(run)
            plain_ms = time_ms(lambda: K._plain_channel_sums(a, pair))
            lib_ms = time_ms(lib)
            bound = bytes_bound(bn_bytes(a, pair))
            _report("kernel bn_channel_sums bn0 %s" % form, ms, plain_ms,
                    lib_ms, bound)
            b2b, lib_b2b = time_ms_back_to_back(run), \
                time_ms_back_to_back(lib)
            print("kernel bn_channel_sums bn0 %s, %d calls back to back: "
                  "%.4f ms a call (%.1f%% of the bound), library %.4f ms "
                  "(%s); device only: kernel %s, library %s"
                  % (form, 20, b2b, 100.0 * bound[0] / b2b, lib_b2b,
                     lib_note, _device_text(device_ms_per_call(run)),
                     _device_text(device_ms_per_call(lib))))
            if pair is None:
                record = {"name": "bn_channel_sums", "route": "cuda",
                          "source": "mxnet_tpu_torch/csrc/bn_channel_sums.cu",
                          "replaces": "mxnet_tpu/ops/pallas_kernels.py:699",
                          "launches": 0, "max_abs_err": max_err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound[0],
                          "bound_by": bound[1], "library_ms": lib_ms}
    small = torch.randn(32, 512, 7, 7, generator=gen, device=dev)
    print("kernel bn_channel_sums host time per wrapper call at (32, 512, "
          "7, 7) over 1000 calls: stats %.1f us (batch_norm_stats %.1f us), "
          "pair %.1f us (batch_norm_backward_reduce %.1f us)"
          % (host_us(lambda: K.bn_channel_sums(small)),
             host_us(bn_library(small, None)),
             host_us(lambda: K.bn_channel_sums(small, small)),
             host_us(bn_library(small, small))))
    bn_sweep(gen)
    return [record], instances


def bn_sweep(gen):
    """All 13 BatchNorm input shapes of ResNet-50 v2 at batch 32, f32,
    single (statistics) and paired (backward), each against its plain
    version and timed back to back beside its library call; weighted by
    the BatchNorms that see each shape into ms per training step."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", 0)
    step = {"kernel": 0.0, "device": 0.0, "library": 0.0, "bound": 0.0}
    for shape, count in BN_STEP_SHAPES:
        a = torch.randn(*shape, generator=gen, device=dev) + 0.5
        b = torch.randn(*shape, generator=gen, device=dev) + 0.5
        for pair in (None, b):
            errs = [_agree(g, w, F32_TOL) for g, w in zip(
                K.bn_channel_sums(a, pair), K._plain_channel_sums(a, pair))]
            if not all(o for _, o in errs):
                raise AssertionError("bn_channel_sums disagrees with its "
                                     "plain version at %s" % (shape,))
            run = lambda: K.bn_channel_sums(a, pair)  # noqa: E731
            ms = time_ms_back_to_back(run)
            lib_ms = time_ms_back_to_back(bn_library(a, pair))
            dev_ms = device_ms_per_call(run)
            bound = bytes_bound(bn_bytes(a, pair))[0]
            print("bn sweep %-18s x%-2d %-6s: %.4f ms back to back, device "
                  "only %s, bound %.4f ms (%.1f%% of the device time), "
                  "library %.4f ms back to back, max_abs_err %.3g"
                  % ("x".join(map(str, shape)), count,
                     "stats" if pair is None else "pair", ms,
                     _device_text(dev_ms), bound,
                     100.0 * bound / dev_ms[0] if dev_ms else float("nan"),
                     lib_ms, max(e for e, _ in errs)))
            step["kernel"] += count * ms
            step["device"] += count * (dev_ms[0] if dev_ms else float("nan"))
            step["library"] += count * lib_ms
            step["bound"] += count * bound
        del a, b
    print("bn sweep: per ResNet-50 step (%d BatchNorms, stats + pair) "
          "device only %.4f ms against a bound of %.4f ms (%.1f%%); back to "
          "back %.4f ms (the smaller shapes wait on the host), the library "
          "calls %.4f ms; card %s"
          % (sum(n for _, n in BN_STEP_SHAPES), step["device"], step["bound"],
             100.0 * step["bound"] / step["device"], step["kernel"],
             step["library"], card_line()))


def check_pool_bwd(seed):
    """Phase 2c: the pooling backwards against their plain versions,
    exactly (each pixel's sum has the same terms in the same order);
    timed at ResNet-50's stem max pool and global average pool (the
    records for the kernels line), and there in bf16, f16 and f64 beside
    the aten backward in the same dtype (their instances).  f64 inputs are
    drawn in f64, and the f64 stem plants in every plane a window whose
    two largest taps differ below f32's resolution: the gradient must go
    to the larger.  Returns ([records], [(name, instance)])."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.ops import nn as nn_ops
    aten = torch.ops.aten
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    stem = ("max", (32, 64, 112, 112), (3, 3), (2, 2), (1, 1), "valid", True)
    glob = ("avg", (32, 2048, 7, 7), (7, 7), (1, 1), (0, 0), "valid", True)
    cases = [  # label, pool, shape, kernel, stride, pad, convention,
        #        count_include_pad, dtype, timed as
        ("stem", *stem, torch.float32, "record"),
        ("full", "max", (8, 16, 27, 31), (3, 3), (2, 2), (1, 1), "full",
         True, torch.float32, None),
        ("stem-bf16", *stem, torch.bfloat16, "instance"),
        ("global7", *glob, torch.float32, "record"),
        ("global7-bf16", *glob, torch.bfloat16, "instance"),
        ("excl-pad-full", "avg", (8, 16, 27, 31), (3, 3), (2, 2), (1, 1),
         "full", False, torch.float32, None),
        ("sum", "sum", (8, 16, 27, 31), (2, 3), (2, 1), (0, 1), "valid",
         True, torch.float32, None),
        *(row for dt in ("float16", "float64") for row in (
            ("stem-" + dt, *stem, getattr(torch, dt), "instance"),
            ("global7-" + dt, *glob, getattr(torch, dt), "instance"))),
    ]
    records, instances = {}, []
    for (label, pool, shape, kernel, stride, pad, conv, cip, dtype,
         timed) in cases:
        draw = torch.float64 if dtype == torch.float64 else torch.float32
        x = torch.randn(*shape, generator=gen, device=dev, dtype=draw)
        if pool == "max":
            x = torch.clamp_min(x, 0.0)  # post-ReLU: windows of tied zeros
        near_tie = pool == "max" and dtype == torch.float64
        if near_tie:  # pixel (2, 2) lies in one window, with (2, 3)
            x[:, :, 2, 2], x[:, :, 2, 3] = 8.0, 8.0 + 2.0 ** -37
        x = x.to(dtype)
        pads = nn_ops._pool_spatial_pads(shape[2:], kernel, stride, pad,
                                         conv)
        out_shape = tuple(nn_ops._pool_out_dim(shape[2 + i], kernel[i],
                                               stride[i], pad[i], conv)
                          for i in range(2))
        dy = torch.randn(shape[:2] + out_shape, generator=gen, device=dev,
                         dtype=draw).to(dtype)
        if pool == "max":
            name = "max_pool_backward"
            run = lambda: K.max_pool_backward(x, dy, kernel, stride, pads)  # noqa: E731
            plain = lambda: K._plain_max_pool_backward(  # noqa: E731
                x, dy, kernel, stride, pads)
            _, idx = aten.max_pool2d_with_indices(x, kernel, stride, pad)
            lib = lambda: aten.max_pool2d_with_indices_backward(  # noqa: E731
                dy, x, kernel, stride, pad, (1, 1), False, idx)
            nbytes = _nbytes(x, dy) + x.numel() * x.element_size()
        else:
            name = "avg_pool_backward"
            div = nn_ops._pool_divisor(pool, cip, shape, kernel, stride,
                                       pads, out_shape, dev,
                                       K._acc_dtype(dtype))
            run = lambda: K.avg_pool_backward(  # noqa: E731
                dy, div, shape, kernel, stride, pads)
            plain = lambda: K._plain_avg_pool_backward(  # noqa: E731
                dy, div, shape, kernel, stride, pads, dtype)
            lib = lambda: aten.avg_pool2d_backward(  # noqa: E731
                dy, x, kernel, stride, pad, False, True, None)
            nbytes = _nbytes(dy, div) + x.numel() * x.element_size()
        got, want = run(), plain()
        torch.cuda.synchronize()
        max_err = float((got.double() - want.double()).abs().max())
        ok = bool(torch.equal(got, want))
        if near_tie:
            ok = ok and not got[:, :, 2, 2].any() and bool(
                (got[:, :, 2, 3] != 0).all())
        print("kernel %s %-13s %s %s: max_abs_err %.3g (exact%s) %s"
              % (name, label, "x".join(map(str, shape)),
                 str(dtype).replace("torch.", ""), max_err,
                 ", f64 near-ties to the larger tap" if near_tie else "",
                 "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("%s disagrees with its plain version on "
                                 "case %s" % (name, label))
        if timed is None:
            continue
        ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(lib)
        bound = bytes_bound(nbytes)
        # the max-pool backward is one launch with no argmax scratch
        _report("kernel %s %s%s" % (name, label, " (one launch, no scratch)"
                                    if pool == "max" else ""),
                ms, plain_ms, lib_ms, bound)
        b2b = time_ms_back_to_back(run)
        print("kernel %s %s, %d calls back to back: %.4f ms a call (%.1f%% "
              "of the bound), library %.4f ms; device only: kernel %s, "
              "library %s; host per wrapper call over 1000 calls: kernel "
              "%.1f us, library %.1f us"
              % (name, label, 20, b2b, 100.0 * bound[0] / b2b,
                 time_ms_back_to_back(lib),
                 _device_text(device_ms_per_call(run)),
                 _device_text(device_ms_per_call(lib)), host_us(run),
                 host_us(lib)))
        if timed == "instance":
            instances.append((name, _instance(label, max_err, ms, plain_ms,
                                              bound, lib_ms)))
            continue
        if label == "global7":
            global_pool_launches_only_its_kernel(x, dy)
        records[name] = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/pool_bwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:580",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms}
    return ([records["max_pool_backward"], records["avg_pool_backward"]],
            instances)


def global_pool_launches_only_its_kernel(x, dy):
    """The global average pool's backward through autograd, as the
    training step runs it (``_PoolFn``, the cached divisor map): one
    device kernel, the kernel's own."""
    import torch
    from mxnet_tpu_torch.ops import nn as nn_ops
    xr = x.detach().requires_grad_()
    y = nn_ops._pooling(xr, pool_type="avg", global_pool=True)
    rows = profile_kernels(lambda: torch.autograd.grad(y, xr, dy,
                                                       retain_graph=True))
    print("kernel avg_pool_backward global7 through autograd launches: %s"
          % ("; ".join("%s x%d" % (k[:60], n) for k, _, n in rows)
             or "not measured (the profiler saw no device events)"))
    if rows and (len(rows) != 1 or rows[0][2] != 1
                 or "avg_pool_bwd_global_kernel" not in rows[0][0]):
        raise AssertionError("the global pool's backward launched more than "
                             "its kernel: %s" % rows)


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


def expected_train_launches(symbol):
    """Kernel launches one training step of ``symbol`` makes, read off the
    graph: two bn_channel_sums (statistics, backward pair) per train-mode
    BatchNorm over NCHW, and one pooling backward per 2-D Pooling node of
    at most 64 taps."""
    counts = {"bn_channel_sums": 0, "max_pool_backward": 0,
              "avg_pool_backward": 0}
    for node in symbol._topo():
        if node.op_name == "BatchNorm":
            counts["bn_channel_sums"] += 2
        elif node.op_name == "Pooling":
            kind = node.attrs.get("pool_type", "max")
            counts["max_pool_backward" if kind == "max"
                   else "avg_pool_backward"] += 1
    return counts


def train(mx, seed):
    """Phase 4: fit ResNet-50 v2 on the card.  Returns the kernel launches
    of the main path (the fit)."""
    import torch
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import kernels as K

    symbol = resnet.get_symbol(**RESNET)
    per_step = expected_train_launches(symbol)
    print("train: ResNet-50 v2, %d arguments, %d aux states; expected "
          "launches per step %s" % (len(symbol.list_arguments()),
                                    len(symbol.list_auxiliary_states()),
                                    per_step))
    rng = np.random.default_rng(seed + 2)
    n = TRAIN_BATCH * TRAIN_BATCHES
    shape = tuple(int(d) for d in RESNET["image_shape"].split(","))
    images = rng.random((n,) + shape, dtype=np.float32)
    labels = rng.integers(0, RESNET["num_classes"], n).astype(np.float32)
    train_iter = mx.io.NDArrayIter(images, labels, batch_size=TRAIN_BATCH)
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    mod.bind(train_iter.provide_data, train_iter.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    arg0, aux0 = (
        {k: v.asnumpy().copy() for k, v in table.items()}
        for table in mod.get_params())

    losses, step_launches, step_ms = [], [], []
    marks = {"t": None, "counts": None}

    def on_batch(param):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), K.launch_counts()
        prob = mod.get_outputs()[0].asnumpy()
        lab = param.locals["batch"].label[0].asnumpy().astype(np.int64)
        losses.append(float(-np.log(prob[np.arange(len(lab)), lab]
                                    + 1e-12).mean()))
        step_launches.append({k: counts[k] - marks["counts"][k]
                              for k in per_step})
        step_ms.append((now - marks["t"]) * 1e3)
        marks["t"], marks["counts"] = now, counts

    torch.cuda.synchronize()
    K.reset_launch_counts()
    marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()
    mod.fit(train_iter, num_epoch=1, batch_end_callback=on_batch,
            optimizer_params=SGD, eval_metric="ce")
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print("train: fit of %d batches of %d: cross-entropy per batch %s; "
          "host-clock ms per step (synchronized) %s; card %s"
          % (TRAIN_BATCHES, TRAIN_BATCH, ", ".join("%.4f" % v
                                                   for v in losses),
             ", ".join("%.1f" % v for v in step_ms), card_line()))
    print("train: launches per step %s; total %s" % (step_launches,
                                                     launches))
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_BATCHES:
        raise AssertionError("non-finite or missing batch losses %s"
                             % losses)
    if any(d != per_step for d in step_launches):
        raise AssertionError("launches per step %s, expected %s"
                             % (step_launches, per_step))
    arg1, aux1 = mod.get_params()
    frozen = [k for k in arg0 if np.array_equal(arg0[k], arg1[k].asnumpy())]
    still = [k for k in aux0 if np.array_equal(aux0[k], aux1[k].asnumpy())]
    print("train: parameters changed %d/%d, moving stats changed %d/%d"
          % (len(arg0) - len(frozen), len(arg0), len(aux0) - len(still),
             len(aux0)))
    if frozen or still:
        raise AssertionError("unchanged after fit: %s" % (frozen + still))

    before = K.launch_counts()
    score = mod.score(train_iter, "acc")
    torch.cuda.synchronize()
    added = {k: K.launch_counts()[k] - before[k] for k in per_step}
    print("train: score %s added launches %s" % (score, added))
    if any(added.values()):
        raise AssertionError("the eval forward launched training kernels")

    from mxnet_tpu_torch.module.fused_step import WARMUP_STEPS
    fused = mod._fused_step
    if fused is None or fused.captures != 1 \
            or fused.replays != TRAIN_BATCHES - WARMUP_STEPS \
            or fused.graph_launches != per_step:
        raise AssertionError("the f32 fit did not run as one captured CUDA "
                             "graph a step after its warm-up")
    train_iter.reset()
    batch = next(train_iter)
    ms = time_steps(mod, batch)
    print("train: path fused f32 (Module.fit's default: one CUDA graph "
          "replay a step after %d eager step): ms per step %.2f (median of "
          "%d after warm-up, synchronized), %.1f images/s; capture %.1f ms; "
          "card %s" % (WARMUP_STEPS, ms, TIMED_STEPS, TRAIN_BATCH / ms * 1e3,
                       fused.capture_seconds * 1e3, card_line()))
    # the split below calls forward, backward and update one at a time,
    # which retires the fused step (the JAX package's semantics): leave it
    # explicitly, so the numbers are the general path's
    mod._fused_step = None
    train_step_split(mod, train_iter, per_step)
    host_check(mx, symbol, arg0, aux0, images[:HOST_BATCH],
               labels[:HOST_BATCH], seed)
    return launches


def time_steps(mod, batch, steps=TIMED_STEPS, warmup=2):
    """Median synchronized host-clock ms of ``forward_backward`` +
    ``update`` on one batch over ``steps`` steps after ``warmup``."""
    import torch
    times = []
    for _ in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[warmup:]))


def train_step_split(mod, train_iter, per_step):
    """Median synchronized host-clock ms of forward (is_train), backward
    and update, and of a whole step, over TIMED_STEPS batches (launches
    here come after the main path's counts were read)."""
    import torch
    train_iter.reset()
    batch = next(train_iter)
    parts = {"forward": [], "backward": [], "update": [], "step": []}
    for _ in range(TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward(batch, is_train=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mod.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mod.update()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in (("forward", t1 - t0), ("backward", t2 - t1),
                     ("update", t3 - t2), ("step", t3 - t0)):
            parts[k].append(v * 1e3)
    med = {k: float(np.median(v[1:])) for k, v in parts.items()}
    profile_step(mod, batch, per_step)
    print("train: path general f32 (eager): ms per step %.2f (median of "
          "%d, synchronized), %.1f "
          "images/s; forward %.2f ms, backward %.2f ms, update %.2f ms; "
          "peak memory %.2f GB; card %s"
          % (med["step"], TIMED_STEPS, TRAIN_BATCH / med["step"] * 1e3,
             med["forward"], med["backward"], med["update"],
             torch.cuda.max_memory_allocated() / 1e9, card_line()))


# device kernel name of each hand-written kernel's launches
HAND_SPLIT = (("bn_channel_sums", "channel_sums_kernel"),
              ("max_pool_backward", "max_pool_bwd_band_kernel"),
              ("avg_pool_backward", "avg_pool_bwd"))
HAND_KERNELS = tuple(k for _, k in HAND_SPLIT) + ("flash_fwd_kernel",)
KERNEL_GROUPS = (  # (label, substrings of a device kernel's name)
    ("hand-written (flash, bn sums, pool backward)", HAND_KERNELS),
    ("convolution and matmul (cuDNN, cuBLAS)",
     ("conv", "cudnn", "xmma", "gemm", "sm90", "sm80", "cutlass", "wgrad",
      "dgrad", "fprop")),
    ("elementwise and reductions (torch)",
     ("elementwise", "vectorized", "reduce", "unrolled", "fill", "copy",
      "softmax")),
)


def profile_step(mod, batch, per_step):
    """One training step (forward, backward, update) under torch.profiler:
    device time by kernel group, the device's busy share of the step,
    the largest kernels, and the hand-written kernels' device time and
    device launches, which must be one per wrapper call."""
    def run():
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    table = profile_run(run, "train")
    if table is None:
        return
    parts, total = [], 0.0
    for name, key in HAND_SPLIT:
        ms = sum(v[0] for k, v in table.items() if key in k)
        n = sum(v[1] for k, v in table.items() if key in k)
        total += ms
        parts.append("%s %.4f ms over %d device launches" % (name, ms, n))
        if n != per_step[name]:
            raise AssertionError("%s: %d device launches in the step, %d "
                                 "wrapper calls" % (name, n, per_step[name]))
    print("train: the profiled step's hand-written kernels %.4f ms: %s; "
          "card %s" % (total, "; ".join(parts), card_line()))
    if any("combine_kernel" in k for k in table):
        raise AssertionError("a second channel-sums launch ran")


def profile_kernels(run):
    """(device kernel name, ms, launches) of the kernels ``run()``
    launches, from torch.profiler, largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = [(e.key, _dev_ms(e), e.count) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(out, key=lambda kv: -kv[1])


def _dev_ms(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0)) / 1e3


class Profile(dict):
    """{device kernel name: (ms, launches)} of one profiled run, with the
    run's ``busy_ms`` (the union of its device activity intervals) and
    ``span_ms`` (from its first event to its last), both read off the one
    trace."""
    busy_ms = span_ms = None

    def share(self):
        return "device busy %.2f ms of the profiled run's %.2f ms span " \
            "(%.1f%%, idle %.1f%%)" % (self.busy_ms, self.span_ms,
                                      100.0 * self.busy_ms / self.span_ms,
                                      100.0 - 100.0 * self.busy_ms
                                      / self.span_ms)


def _trace_share(events):
    """(busy ms, span ms) of a trace: the union of the device events'
    intervals, and the span from the first event (host or device) to the
    last."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    ranges = [(e.time_range.start, e.time_range.end) for e in events]
    span = max(b for _, b in ranges) - min(a for a, _ in ranges)
    return busy / 1e3, span / 1e3


def profile_run(run, tag, kernel_groups=KERNEL_GROUPS, op_groups=None):
    """``run()`` once under torch.profiler, synchronized: device time by
    kernel group (the first of ``kernel_groups`` whose substrings a
    kernel's name holds), the device's busy share of the run's span (both
    from the trace: see ``Profile``), the largest kernels; with
    ``op_groups``, also the device time of the kernels each outermost
    host op (an aten op, or an autograd node in the backward) launched,
    itself or through the ops under it, by the first group whose
    substrings its name holds.
    Returns a ``Profile``, None when the profiler saw no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_dev_ms(e) for e in device)
    if busy <= 0:
        print("%s: profiled step %.2f ms; device time not measured (the "
              "profiler saw no device events)" % (tag, wall_ms))
        return None
    groups = {label: 0.0 for label, _ in kernel_groups}
    groups["other"] = 0.0
    for e in device:
        name = e.key.lower()
        label = next((lab for lab, keys in kernel_groups
                      if any(k.lower() in name for k in keys)), "other")
        groups[label] += _dev_ms(e)
    table = Profile((e.key, (_dev_ms(e), e.count)) for e in device)
    table.busy_ms, table.span_ms = _trace_share(prof.events())
    print("%s: profiled step %.2f ms wall (host clock), device time %.2f ms "
          "in all; %s; by group: %s; card %s"
          % (tag, wall_ms, busy, table.share(),
             "; ".join("%s %.2f ms" % kv for kv in groups.items()),
             card_line()))
    for e in sorted(device, key=_dev_ms, reverse=True)[:8]:
        print("%s:   %8.3f ms x%-4d %s" % (tag, _dev_ms(e), e.count,
                                           e.key[:90]))
    if op_groups:
        by_op = {label: 0.0 for label, _ in op_groups}
        by_op["other"] = 0.0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CPU \
                    or e.cpu_parent is not None:
                continue
            name = e.name.lower()
            label = next((lab for lab, keys in op_groups
                          if any(k in name for k in keys)), "other")
            by_op[label] += e.device_time_total / 1e3
        print("%s: device time by the host op that launched it: %s"
              % (tag, "; ".join("%s %.2f ms" % kv for kv in by_op.items())))
    return table


def host_check(mx, symbol, arg0, aux0, images, labels, seed):
    """One batch-2 training forward and backward on the card and on the
    host (plain versions) from the same parameters: outputs, every
    parameter's gradient and the moving statistics.

    The parameters are the fit's initial ones with every BatchNorm gamma
    and beta drawn away from Xavier's 1 and 0: with beta 0 the loss does
    not depend on bn0's gamma (relu and max pooling commute with a
    positive per-channel scale, and the next BatchNorm removes it), so
    that gradient is rounding noise.  Even so, at initialization the
    backward of this 50-layer BatchNorm net amplifies f32 rounding: the
    host's own gradients move by ~1% when a few input pixels move by one
    ulp.  So a third run, on the host with the input perturbed by one
    relative 1e-7, measures that floor, and every gradient passes within
    HOST_GRAD_REL or within 4 times the largest floor.  (A wrong formula
    or routing shows as an O(1) error; the kernels themselves are held
    against their plain versions in phase 2.)"""
    rng = np.random.default_rng(seed + 3)
    arg0 = dict(arg0)
    for k, v in arg0.items():
        if k.endswith("_gamma"):
            arg0[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        elif k.endswith("_beta"):
            arg0[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    nudged = (images * (1 + 1e-7 * rng.standard_normal(images.shape))
              ).astype(np.float32)
    results = []
    for ctx, data in ((mx.gpu(0), images), (mx.cpu(), images),
                      (mx.cpu(), nudged)):
        exe = symbol.simple_bind(
            ctx, grad_req={k: "write" for k in arg0},
            data=data.shape, softmax_label=labels.shape)
        args, auxs = mx.convert.params_from_numpy(
            dict(arg0, **{"aux:" + k: v for k, v in aux0.items()}), ctx)
        exe.copy_params_from(args, auxs)
        exe.forward(is_train=True, data=data, softmax_label=labels)
        exe.backward()
        results.append((exe.outputs[0].asnumpy(),
                        {k: exe.grad_dict[k].asnumpy() for k in arg0},
                        {k: exe.aux_dict[k].asnumpy() for k in aux0}))
    (out_g, grad_g, aux_g), (out_h, grad_h, aux_h), (_, grad_n, _) = results

    def rel(a, b):
        return {k: float(np.linalg.norm(a[k] - b[k])
                         / np.linalg.norm(b[k]))
                for k in b if np.linalg.norm(b[k]) > 0}

    err, floor = rel(grad_g, grad_h), rel(grad_n, grad_h)
    limit = max(HOST_GRAD_REL, 4.0 * max(floor.values()))
    worst = max(err, key=err.get)
    out_err = np.abs(out_g - out_h)
    out_ok = bool((out_err <= HOST_OUT_TOL["atol"]
                   + HOST_OUT_TOL["rtol"] * np.abs(out_h)).all())
    aux_err = {k: float(np.abs(aux_g[k] - aux_h[k]).max()) for k in aux_h}
    worst_aux = max(aux_err, key=aux_err.get)
    print("train: batch-%d forward+backward card vs host: outputs "
          "max_abs_err %.3g (atol %g rtol %g); gradients relative L2: "
          "largest %.3g (%s), median %.3g, %d/%d within %g; the host's own "
          "floor (input moved by 1e-7) largest %.3g, median %.3g, so the "
          "limit is %.3g; worst moving stat %.3g (%s, limit %g)"
          % (len(labels), float(out_err.max()), HOST_OUT_TOL["atol"],
             HOST_OUT_TOL["rtol"], max(err.values()), max(err, key=err.get),
             float(np.median(list(err.values()))),
             sum(v <= HOST_GRAD_REL for v in err.values()), len(err),
             HOST_GRAD_REL, max(floor.values()),
             float(np.median(list(floor.values()))), limit,
             aux_err[worst_aux], worst_aux, HOST_AUX_TOL))
    if not out_ok or err[worst] > limit \
            or aux_err[worst_aux] > HOST_AUX_TOL:
        raise AssertionError("the card's training step disagrees with the "
                             "host's")


def gluon_net(mx, layers, arrays, ctx):
    """The zoo TransformerLM at GPT-2 small's widths with ``layers``
    blocks, its parameters set from ``arrays`` on ``ctx``, hybridized."""
    from mxnet_tpu_torch import gluon
    with mx.sym.NameManager():  # names as transformer_lm_symbol's
        net = gluon.model_zoo.TransformerLM(**dict(GPT2S, num_layers=layers))
    mx.convert.set_gluon_params(net, arrays, ctx=ctx)
    net.hybridize()
    return net


def lm_batch(mx, rng, batch, ctx):
    """Random tokens and next-token labels, (batch, seq_len) each."""
    shape = (batch, GPT2S["seq_len"])
    return [mx.nd.array(rng.integers(0, GPT2S["vocab_size"], shape),
                        ctx=ctx, dtype="float32") for _ in range(2)]


def train_gluon(mx, seed):
    """Phase 5: train the GPT-2-small-width zoo TransformerLM through
    Gluon on the card.  Returns the kernel launches of the main path (the
    warm-up and timed steps)."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.models import transformer_lm_symbol
    from mxnet_tpu_torch.ops import kernels as K

    layers = GPT2S["num_layers"]
    t0 = time.perf_counter()
    arrays = gpt2s_params(transformer_lm_symbol(**GPT2S), seed)
    dev = mx.gpu(0)
    net = gluon_net(mx, layers, arrays, dev)
    params = net.collect_params()
    x, y = lm_batch(mx, np.random.default_rng(seed + 4), GLUON_BATCH, dev)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(params, "adam", dict(ADAM))
    tokens = GLUON_BATCH * GPT2S["seq_len"]
    print("gluon: TransformerLM %d parameters in %d Parameters, set from "
          "seed %d and hybridized in %.1f s; batch %d x %d tokens"
          % (sum(a.size for a in arrays.values()), len(params.keys()), seed,
             time.perf_counter() - t0, GLUON_BATCH, GPT2S["seq_len"]))

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(x), y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(GLUON_BATCH)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return (float(loss.asnumpy().mean()),
                {"forward": (t1 - t0) * 1e3, "backward": (t2 - t1) * 1e3,
                 "update": (t3 - t2) * 1e3, "step": (t3 - t0) * 1e3})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, parts, per_step = [], [], []
    for _ in range(GLUON_WARMUP + GLUON_TIMED):
        before = K.launch_counts()
        loss, t = step()
        after = K.launch_counts()
        losses.append(loss)
        parts.append(t)
        per_step.append({k: after[k] - before[k]
                         for k in ("flash_attn_fwd", "flash_attn_fwd_lse")})
    launches = K.launch_counts()
    timed = parts[GLUON_WARMUP:]
    med = {k: float(np.median([t[k] for t in timed])) for k in timed[0]}
    print("gluon: losses per step %s; launches per step %s"
          % (", ".join("%.4f" % v for v in losses), per_step))
    print("gluon: ms per step %.2f (median of %d, synchronized), %.0f "
          "tokens/s; forward %.2f ms, backward %.2f ms, update %.2f ms; "
          "peak memory %.2f GB; card %s"
          % (med["step"], GLUON_TIMED, tokens / med["step"] * 1e3,
             med["forward"], med["backward"], med["update"],
             torch.cuda.max_memory_allocated() / 1e9, card_line()))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("gluon losses not finite and falling: %s"
                             % losses)
    want = {"flash_attn_fwd": 0, "flash_attn_fwd_lse": layers}
    if any(d != want for d in per_step):
        raise AssertionError("flash launches per step %s, expected %s"
                             % (per_step, want))

    def last_step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(GLUON_BATCH)

    profile_run(last_step, "gluon")
    frozen = [k for k, p in params.items()
              if np.array_equal(p.data().asnumpy(), arrays[k])]
    print("gluon: parameters changed %d/%d"
          % (len(arrays) - len(frozen), len(arrays)))
    if frozen:
        raise AssertionError("unchanged after training: %s" % frozen)

    before = K.launch_counts()
    with autograd.predict_mode():
        logits = net(x)
    torch.cuda.synchronize()
    added = {k: K.launch_counts()[k] - before[k]
             for k in ("flash_attn_fwd", "flash_attn_fwd_lse")}
    print("gluon: predict_mode forward launches %s" % added)
    if added != {"flash_attn_fwd": layers, "flash_attn_fwd_lse": 0}:
        raise AssertionError("predict forward launches %s" % added)
    if logits.shape != (GLUON_BATCH, GPT2S["seq_len"], GPT2S["vocab_size"]) \
            or not bool(torch.isfinite(logits.tensor).all()):
        raise AssertionError("predict forward gave %s or non-finite logits"
                             % (logits.shape,))
    del net, trainer, params, logits
    gluon_host_check(mx, seed)
    return launches


def gluon_host_check(mx, seed):
    """A 2-layer full-width copy: one batch-1 forward and backward on the
    card and on the host (plain versions) from the same weights; every
    gradient within GLUON_GRAD_REL relative L2.  The key biases are held
    apart: a constant added to every score of a row changes no
    probability, so their gradient is zero up to rounding in both runs,
    and a relative error between two roundings says nothing."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.models import transformer_lm_symbol
    t0 = time.perf_counter()
    arrays = gpt2s_params(transformer_lm_symbol(
        **dict(GPT2S, num_layers=GLUON_HOST_LAYERS)), seed + 9)
    rng_seed = seed + 10
    grads = []
    for ctx in (mx.gpu(0), mx.cpu()):
        net = gluon_net(mx, GLUON_HOST_LAYERS, arrays, ctx)
        x, y = lm_batch(mx, np.random.default_rng(rng_seed), 1, ctx)
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
        loss.backward()
        grads.append({k: p.grad().asnumpy()
                      for k, p in net.collect_params().items()})
    card, host = grads
    rel = {k: float(np.linalg.norm(card[k] - host[k])
                    / np.linalg.norm(host[k]))
           for k in host if not k.endswith("key_bias")}
    worst = max(rel, key=rel.get)
    ref = min(float(np.linalg.norm(host[k])) for k in rel)
    key_bias = max(max(float(np.linalg.norm(g[k])) for g in grads)
                   for k in host if k.endswith("key_bias"))
    print("gluon: %d-layer batch-1 forward+backward card vs host (%.1f s): "
          "gradients relative L2 largest %.3g (%s), median %.3g, limit %g; "
          "key-bias gradient norms at most %.3g (smallest other %.3g)"
          % (GLUON_HOST_LAYERS, time.perf_counter() - t0, rel[worst], worst,
             float(np.median(list(rel.values()))), GLUON_GRAD_REL, key_bias,
             ref))
    if rel[worst] > GLUON_GRAD_REL or key_bias > 1e-3 * ref:
        raise AssertionError("the card's Gluon gradients disagree with the "
                             "host's")


# the repairs' kernel instances: flash attention at the zoo TransformerLM's
# Gluon vision training configuration: the resnet50-train cell's model and
# hyperparameters, through the Gluon vision zoo
VISION_CLASSES = 1000
VISION_BATCH = 32
VISION_WARMUP, VISION_TIMED = 2, 5
VISION_HOST_BATCH = 2
VISION_TRAIN_KERNELS = ("bn_channel_sums", "max_pool_backward",
                        "avg_pool_backward")


def _blocks(block):
    yield block
    for child in block._children:
        yield from _blocks(child)


def expected_vision_launches(net):
    """Kernel launches one Gluon training step of zoo ResNet ``net`` makes,
    read off the net: one ``bn_channel_sums`` (the statistics) per
    train-mode BatchNorm, one more (the backward pair) per BatchNorm whose
    backward autograd runs, one max-pool backward per MaxPool2D and one
    avg-pool backward per average pool.  The v2 net's input BatchNorm
    (scale=False, center=False) normalizes the images, which need no
    gradient, and has no trainable parameter: no gradient reaches it, so
    its backward does not run and it launches no pair."""
    from mxnet_tpu_torch.gluon import nn
    head = net.features[0]
    counts = dict.fromkeys(VISION_TRAIN_KERNELS, 0)
    for blk in _blocks(net):
        if isinstance(blk, nn.BatchNorm):
            counts["bn_channel_sums"] += 1
            frozen = all(p.grad_req == "null" for p in (blk.gamma, blk.beta))
            if not (blk is head and frozen):
                counts["bn_channel_sums"] += 1
        elif isinstance(blk, nn.MaxPool2D):
            counts["max_pool_backward"] += 1
        elif isinstance(blk, (nn.AvgPool2D, nn.GlobalAvgPool2D)):
            counts["avg_pool_backward"] += 1
    return counts


def vision_net(mx, ctx, seed):
    """``gluon.model_zoo.vision.resnet50_v2(classes=1000)``, Xavier
    (gaussian, in, 2) from ``seed``, on ``ctx``, hybridized."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with mx.sym.NameManager():
        net = vision.resnet50_v2(classes=VISION_CLASSES)
    mx.random.seed(seed)
    net.initialize(mx.initializer.Xavier(rnd_type="gaussian",
                                         factor_type="in", magnitude=2),
                   ctx=ctx)
    net.hybridize()
    return net


def vision_batch(mx, ctx, seed):
    """Random images in [0, 1) and labels from ``seed``, on ``ctx``."""
    rng = np.random.default_rng(seed + 50)
    images = rng.random((VISION_BATCH, 3, 224, 224), dtype=np.float32)
    labels = rng.integers(0, VISION_CLASSES, VISION_BATCH).astype(np.float32)
    return mx.nd.array(images, ctx=ctx), mx.nd.array(labels, ctx=ctx)


def profile_vision_step_apart(seed):
    """Runs ``vision_profile_child`` in a process of its own and passes its
    lines on; raises when it fails.  In this process, after the earlier
    phases' many profiler sessions, torch.profiler loses a few kernel
    records of the vision step (ours and torch's own elementwise kernels
    alike, absent from its raw trace too) and can misstate durations
    (PERF.md section 6), so the device-side launch check runs where the
    step is the process's only profiled work."""
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--vision-profile"], capture_output=True, text=True, timeout=900)
    sys.stdout.write(child.stdout)
    if child.returncode != 0:
        sys.stdout.write(child.stderr[-4000:])
        raise AssertionError("the profiled vision step failed (exit %d)"
                             % child.returncode)
    print("vision: profiled step in a process of its own: %.1f s"
          % (time.perf_counter() - t0))


def vision_profile_child(mx, seed):
    """``--vision-profile``: the Gluon ResNet-50 v2 training step of phase
    6 (the same net, data and hyperparameters), 2 warm-up steps, then one
    step under torch.profiler: device time by kernel group, the busy
    share, and each hand-written kernel's device launches, which must
    equal its wrapper calls in that step."""
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.ops import kernels as K
    dev = mx.gpu(0)
    net = vision_net(mx, dev, seed)
    x, y = vision_batch(mx, dev, seed)
    net(x)
    per_step = expected_vision_launches(net)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    for _ in range(VISION_WARMUP):
        vision_step(mx, net, trainer, x, y)
    before = K.launch_counts()
    table = profile_run(lambda: vision_step(mx, net, trainer, x, y),
                        "vision")
    calls = {k: K.launch_counts()[k] - before[k] for k in per_step}
    if calls != per_step:
        raise AssertionError("profiled step: wrapper calls %s, expected %s"
                             % (calls, per_step))
    if table is None:
        return 0
    split = []
    for name, key in HAND_SPLIT:
        rows = {k: v for k, v in table.items() if key in k}
        n = sum(v[1] for v in rows.values())
        split.append("%s %.4f ms over %d device launches"
                     % (name, sum(v[0] for v in rows.values()), n))
        if n != calls[name]:
            raise AssertionError(
                "%s: %d device launches in the profiled step, %d wrapper "
                "calls: %s" % (name, n, calls[name],
                               {k[:90]: v[1] for k, v in rows.items()}))
    print("vision: the profiled step's hand-written kernels: %s; card %s"
          % ("; ".join(split), card_line()))
    return 0


def vision_step(mx, net, trainer, x, y):
    """One Gluon training step; (loss, {part: synchronized host ms})."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    trainer.step(x.shape[0])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return (float(loss.asnumpy().mean()),
            {"forward": (t1 - t0) * 1e3, "backward": (t2 - t1) * 1e3,
             "update": (t3 - t2) * 1e3, "step": (t3 - t0) * 1e3})


def train_gluon_vision(mx, seed):
    """Phase 6: train the Gluon vision zoo's ResNet-50 v2 on the card at
    batch 32, then run it as a SymbolBlock.  Returns the training
    kernels' launches of the main path (the warm-up and timed steps)."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    dev = mx.gpu(0)
    net = vision_net(mx, dev, seed)
    x, y = vision_batch(mx, dev, seed)
    net(x)  # the deferred shapes
    params = net.collect_params()
    before = {k: p.data().asnumpy().copy() for k, p in params.items()}
    per_step = expected_vision_launches(net)
    trainable = [k for k, p in params.items() if p.grad_req != "null"]
    print("vision: resnet50_v2 %d parameters in %d Parameters (%d "
          "trainable), initialized and hybridized in %.1f s; expected "
          "launches per step %s"
          % (sum(v.size for v in before.values()), len(before),
             len(trainable), time.perf_counter() - t0, per_step))
    trainer = gluon.Trainer(params, "sgd", dict(SGD))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, parts, step_launches = [], [], []
    for _ in range(VISION_WARMUP + VISION_TIMED):
        counts = K.launch_counts()
        loss, t = vision_step(mx, net, trainer, x, y)
        after = K.launch_counts()
        losses.append(loss)
        parts.append(t)
        step_launches.append({k: after[k] - counts[k]
                              for k in VISION_TRAIN_KERNELS})
    launches = K.launch_counts()
    timed = parts[VISION_WARMUP:]
    med = {k: float(np.median([t[k] for t in timed])) for k in timed[0]}
    print("vision: losses per step %s; launches per step %s"
          % (", ".join("%.4f" % v for v in losses), step_launches))
    print("vision: ms per step %.2f (median of %d, synchronized), %.1f "
          "images/s; forward %.2f ms, backward %.2f ms, update %.2f ms; "
          "peak memory %.2f GB; card %s"
          % (med["step"], VISION_TIMED, VISION_BATCH / med["step"] * 1e3,
             med["forward"], med["backward"], med["update"],
             torch.cuda.max_memory_allocated() / 1e9, card_line()))
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite vision losses %s" % losses)
    if any(d != per_step for d in step_launches):
        raise AssertionError("launches per step %s, expected %s"
                             % (step_launches, per_step))

    profile_vision_step_apart(seed)
    after = {k: p.data().asnumpy() for k, p in params.items()}
    must_move = [k for k in before if k in trainable or "running_" in k]
    still = [k for k in must_move if np.array_equal(before[k], after[k])]
    print("vision: trainable parameters and moving statistics changed "
          "%d/%d" % (len(must_move) - len(still), len(must_move)))
    if still:
        raise AssertionError("unchanged after training: %s" % still)

    counts = K.launch_counts()
    with autograd.predict_mode():
        logits = net(x)
    torch.cuda.synchronize()
    added = {k: K.launch_counts()[k] - counts[k] for k in counts}
    print("vision: predict_mode forward launches %s" % added)
    if any(added.values()):
        raise AssertionError("the predict forward launched kernels")
    if logits.shape != (VISION_BATCH, VISION_CLASSES) \
            or not bool(torch.isfinite(logits.tensor).all()):
        raise AssertionError("predict forward gave %s or non-finite logits"
                             % (logits.shape,))
    vision_symbol_block(mx, net, x, y, logits.asnumpy(), per_step)
    del net, trainer, params, logits
    vision_host_check(mx, seed)
    return launches


def vision_symbol_block(mx, net, x, y, want, per_step):
    """Export the trained net, load it back as ``SymbolBlock(sym.load(...),
    sym.var('data'))`` with ``collect_params().load(...)`` on the card:
    its predict forward equals the net's (bit for bit expected: the same
    ops in the same order; gated at atol=rtol=1e-5), and one Trainer step
    through it, with the net's frozen Parameters frozen, makes the net's
    kernel launches."""
    import tempfile
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import kernels as K
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet50_v2")
        t0 = time.perf_counter()
        net.export(prefix)
        block = gluon.SymbolBlock(mx.sym.load(prefix + "-symbol.json"),
                                  mx.sym.var("data"))
        block.collect_params().load(prefix + "-0000.params", ctx=mx.gpu(0))
        export_s = time.perf_counter() - t0
    # a SymbolBlock makes every argument trainable; the net's frozen ones
    # (the input BatchNorm's gamma and beta) stay frozen, as in the net
    frozen = [k for k, p in net.collect_params().items()
              if p.grad_req == "null"]
    for k in frozen:
        block.collect_params()[k].grad_req = "null"
    block.hybridize()
    with autograd.predict_mode():
        got = block(x).asnumpy()
    err = float(np.abs(got - want).max())
    ok = bool(np.allclose(got, want, atol=1e-5, rtol=1e-5))
    counts = K.launch_counts()
    loss, t = vision_step(mx, block, gluon.Trainer(
        block.collect_params(), "sgd", dict(SGD)), x, y)
    added = {k: K.launch_counts()[k] - counts[k]
             for k in VISION_TRAIN_KERNELS}
    print("vision: SymbolBlock from the export (%.1f s): %d Parameters, "
          "predict forward max_abs_err %.3g against the net (bit for bit "
          "%s; atol 1e-5 rtol 1e-5) %s; one Trainer step %.1f ms, loss %.4f, "
          "launches %s"
          % (export_s, len(block.collect_params().keys()), err,
             bool(np.array_equal(got, want)), "ok" if ok else "FAIL",
             t["step"], loss, added))
    if not ok or added != per_step or not np.isfinite(loss):
        raise AssertionError("the SymbolBlock disagrees with the net")


def vision_host_check(mx, seed):
    """One batch-2 training forward and backward of the same ResNet-50 v2
    on the card and on the host (plain versions) from the same weights,
    every BatchNorm gamma and beta drawn away from 1 and 0 (see
    ``host_check``): every gradient within HOST_GRAD_REL relative L2 or
    within 4 times the host's own largest change when its input moves by
    one relative 1e-7 (phase 4's rule)."""
    from mxnet_tpu_torch import autograd, gluon
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 51)
    ref = vision_net(mx, mx.cpu(), seed)
    images = rng.random((VISION_HOST_BATCH, 3, 224, 224), dtype=np.float32)
    labels = rng.integers(0, VISION_CLASSES,
                          VISION_HOST_BATCH).astype(np.float32)
    ref(mx.nd.array(images, ctx=mx.cpu()))
    arrays = {}
    for k, p in ref.collect_params().items():
        v = p.data().asnumpy()
        if k.endswith("gamma"):
            v = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("beta"):
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        arrays[k] = v
    nudged = (images * (1 + 1e-7 * rng.standard_normal(images.shape))
              ).astype(np.float32)
    grads = []
    for ctx, data in ((mx.gpu(0), images), (mx.cpu(), images),
                      (mx.cpu(), nudged)):
        net = vision_net(mx, ctx, seed)
        mx.convert.set_gluon_params(net, arrays, ctx=ctx)
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                net(mx.nd.array(data, ctx=ctx)), mx.nd.array(labels, ctx=ctx))
        loss.backward()
        grads.append({k: p.grad().asnumpy()
                      for k, p in net.collect_params().items()
                      if p.grad_req != "null"})
    card, host, nudge = grads

    def rel(a, b):
        return {k: float(np.linalg.norm(a[k] - b[k]) / np.linalg.norm(b[k]))
                for k in b if np.linalg.norm(b[k]) > 0}

    err, floor = rel(card, host), rel(nudge, host)
    limit = max(HOST_GRAD_REL, 4.0 * max(floor.values()))
    worst = max(err, key=err.get)
    print("vision: batch-%d forward+backward card vs host (%.1f s): "
          "gradients relative L2 largest %.3g (%s), median %.3g, %d/%d "
          "within %g; the host's own floor largest %.3g, median %.3g, so "
          "the limit is %.3g"
          % (VISION_HOST_BATCH, time.perf_counter() - t0, err[worst], worst,
             float(np.median(list(err.values()))),
             sum(v <= HOST_GRAD_REL for v in err.values()), len(err),
             HOST_GRAD_REL, max(floor.values()),
             float(np.median(list(floor.values()))), limit))
    if err[worst] > limit:
        raise AssertionError("the card's Gluon vision gradients disagree "
                             "with the host's")


# Gluon LSTM language model: Zaremba, Sutskever & Vinyals 2014, "Recurrent
# Neural Network Regularization", the medium configuration, as MXNet's Gluon
# example/gluon/word_language_model trains it (untied decoder)
LM = dict(vocab=10000, embed=650, hidden=650, layers=2, bptt=35, batch=20,
          dropout=0.5, init=0.05, lr=1.0, clip=5.0)
LM_PARAMETERS = 19780400
LM_WARMUP, LM_TIMED = 2, 5
LM_HOST_BATCH = 2
LM_OUT_TOL = dict(atol=1e-4, rtol=1e-4)
LM_GRAD_REL = 1e-3
# the other recurrent layers and the cells at a smaller width
RNN_CHECK = dict(width=256, steps=35, batch=16)
# CTC at a speech shape: Deep Speech 2's English alphabet (28 characters
# and the blank), 200 frames, transcripts up to 50 characters
CTC = dict(batch=32, steps=200, alphabet=29, max_label=50)
CTC_TOL = dict(atol=1e-4, rtol=1e-4)
LM_GROUPS = (  # by kernel name, first match wins
    ("cuDNN RNN gate kernels", ("rnn", "lstm", "persist")),
    ("softmax", ("softmax",)),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "sm90", "sm80", "cutlass")),
    ("elementwise and reductions (torch)",
     ("elementwise", "vectorized", "reduce", "unrolled", "fill", "copy",
      "index", "gather", "scatter", "embedding")),
)
LM_OP_GROUPS = (  # by the host op that launched the kernel
    ("cuDNN RNN (its GEMMs, gates and weight copies)", ("rnn", "lstm")),
    ("decoder GEMM and softmax cross-entropy",
     ("matmul", "mm", "softmax", "pick", "gather")),
    ("embedding", ("embedding",)),
)


def lstm_lm(mx, dropout):
    """The word-language-model example's ``RNNModel``: Embedding ->
    Dropout -> 2-layer LSTM -> Dropout -> Dense (untied), at ``LM``'s
    widths, under a fresh NameManager."""
    from mxnet_tpu_torch import gluon

    class RNNModel(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.encoder = gluon.nn.Embedding(LM["vocab"], LM["embed"])
                self.drop = gluon.nn.Dropout(dropout)
                self.rnn = gluon.rnn.LSTM(
                    LM["hidden"], num_layers=LM["layers"], dropout=dropout,
                    input_size=LM["embed"])
                self.decoder = gluon.nn.Dense(LM["vocab"], flatten=False,
                                              in_units=LM["hidden"])

        def forward(self, inputs, hidden):
            output, hidden = self.rnn(self.drop(self.encoder(inputs)), hidden)
            return self.decoder(self.drop(output)), hidden

    with mx.sym.NameManager():
        return RNNModel()


def lm_windows(seed, batches):
    """Random token ids from ``seed`` as (inputs, targets), each
    (batches * batch, bptt) float32: the stream is cut into ``batch`` rows
    as the example's ``batchify`` does, and window k of row r is item
    k * batch + r, so that row r of batch k continues row r of batch
    k - 1 in a sequential DataLoader."""
    b, t = LM["batch"], LM["bptt"]
    rows = np.random.default_rng(seed).integers(
        0, LM["vocab"], (b, batches * t + 1)).astype(np.float32)
    idx = np.arange(batches)[:, None] * t + np.arange(t)
    cut = [rows[:, idx + shift].transpose(1, 0, 2).reshape(-1, t)
           for shift in (0, 1)]
    return cut[0], cut[1]


def train_lstm_lm(mx, seed):
    """Phase 7: train the medium LSTM LM through DataLoader -> Gluon ->
    Trainer on the card, then check the recurrent layers, the cells and
    CTC against the host.  Returns the hand-written kernels' launches of
    the main path (the LM's 8 steps; none is expected)."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import kernels as K

    dev = mx.gpu(0)
    b, t = LM["batch"], LM["bptt"]
    tokens = b * t
    t0 = time.perf_counter()
    net = lstm_lm(mx, LM["dropout"])
    mx.random.seed(seed)
    net.initialize(mx.initializer.Uniform(LM["init"]), ctx=dev)
    params = net.collect_params()
    initial = {k: p.data().asnumpy() for k, p in params.items()}
    n_params = sum(v.size for v in initial.values())
    if n_params != LM_PARAMETERS:
        raise AssertionError("the LM has %d parameters, not %d"
                             % (n_params, LM_PARAMETERS))
    steps = LM_WARMUP + LM_TIMED + 1
    inputs, targets = lm_windows(seed + 70, steps)
    loader = gluon.data.DataLoader(
        gluon.data.ArrayDataset(inputs, targets), batch_size=b,
        shuffle=False, last_batch="discard", num_workers=2)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": LM["lr"]})
    grads = [p.grad() for p in params.values()]
    print("lstm-lm: %d parameters in %d Parameters (uniform +-%g from seed "
          "%d) in %.1f s; %d batches of %d x %d tokens through a "
          "DataLoader with 2 workers"
          % (n_params, len(initial), LM["init"], seed,
             time.perf_counter() - t0, len(loader), b, t))

    state = {"hidden": net.rnn.begin_state(b, ctx=dev)}

    def step(x, y):
        # truncated BPTT: the carried state leaves the previous graph
        hidden = [h.detach() for h in state["hidden"]]
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        with autograd.record():
            logits, hidden = net(mx.nd.transpose(x), hidden)
            loss = loss_fn(logits.reshape((-3, -1)),
                           mx.nd.transpose(y).reshape((-1,)))
        torch.cuda.synchronize()
        c1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        c2 = time.perf_counter()
        norm = gluon.utils.clip_global_norm(grads, LM["clip"] * t * b)
        torch.cuda.synchronize()
        c3 = time.perf_counter()
        trainer.step(b)
        torch.cuda.synchronize()
        c4 = time.perf_counter()
        state["hidden"] = hidden
        return (float(loss.asnumpy().mean()), norm,
                {"forward": (c1 - c0) * 1e3, "backward": (c2 - c1) * 1e3,
                 "clip": (c3 - c2) * 1e3, "update": (c4 - c3) * 1e3,
                 "step": (c4 - c0) * 1e3})

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # the weights, and earlier phases'
    K.reset_launch_counts()
    losses, norms, parts, peaks, seen = [], [], [], [], []
    for i, (x, y) in enumerate(loader):
        if x.context != dev or x.shape != (b, t):
            raise AssertionError("batch %d: %s on %s" % (i, x.shape,
                                                         x.context))
        seen.append((x.asnumpy(), y.asnumpy()))
        if i == steps - 1:
            break  # the last batch is the profiled step's
        torch.cuda.reset_peak_memory_stats()
        loss, norm, part = step(x, y)
        peaks.append(torch.cuda.max_memory_allocated())
        losses.append(loss)
        norms.append(norm)
        parts.append(part)
    last = {}
    profile_run(lambda: last.update(zip(("loss", "norm", "parts"),
                                        step(x, y))),
                "lstm-lm", LM_GROUPS, LM_OP_GROUPS)
    losses.append(last["loss"])
    launches = K.launch_counts()
    for k in range(1, len(seen)):  # row r of batch k continues batch k-1
        if not np.array_equal(seen[k][0][:, 0], seen[k - 1][1][:, -1]):
            raise AssertionError("batch %d does not continue batch %d"
                                 % (k, k - 1))
    if not np.array_equal(np.concatenate([s[0] for s in seen]), inputs):
        raise AssertionError("the DataLoader's batches are not the data")
    timed = parts[LM_WARMUP:]
    med = {k: float(np.median([p[k] for p in timed])) for k in timed[0]}
    print("lstm-lm: per-token losses %s (perplexity %.1f at the end); "
          "gradient norms before clipping %s"
          % (", ".join("%.4f" % v for v in losses), np.exp(losses[-1]),
             ", ".join("%.2f" % v for v in norms)))
    print("lstm-lm: ms per step %.2f (median of %d, synchronized), %.0f "
          "tokens/s; forward %.2f ms, backward %.2f ms, clip %.2f ms, "
          "update %.2f ms; peak memory per step %s GB, of which %.4f GB "
          "was allocated before the first step; card %s"
          % (med["step"], LM_TIMED, tokens / med["step"] * 1e3,
             med["forward"], med["backward"], med["clip"], med["update"],
             ", ".join("%.4f" % (v / 1e9) for v in peaks), held / 1e9,
             card_line()))
    if not all(np.isfinite(losses)):
        raise AssertionError("lstm-lm losses not finite: %s" % losses)
    flat = peaks[2:LM_WARMUP + LM_TIMED]  # steps 3 to 7
    if max(flat) - min(flat) > max(2 ** 20, 0.005 * max(flat)):
        raise AssertionError("peak memory grows from step 3 to 7: %s"
                             % flat)
    frozen = [k for k, p in params.items()
              if np.array_equal(p.data().asnumpy(), initial[k])]
    print("lstm-lm: parameters changed %d/%d; hand-written kernel launches "
          "%s" % (len(initial) - len(frozen), len(initial), launches))
    if frozen:
        raise AssertionError("unchanged after training: %s" % frozen)
    if any(launches.values()):
        raise AssertionError("the LM path launched %s" % launches)
    lstm_flatten_cost(mx, net, seed)
    lstm_lm_host_check(mx, net, seed)
    del net, trainer, params, grads, state
    rnn_layers_check(mx, seed)
    ctc_check(mx, seed)
    return launches


def lstm_flatten_cost(mx, net, seed):
    """One forward of the LM's LSTM layer, no gradient, through the port
    (``_flat_params`` concatenates the Parameters; cuDNN copies the views
    of that flat vector into its own layout) against ``torch.nn.LSTM``
    holding the same weights in cuDNN's packed buffer, timed only as a
    yardstick: the weight layout's cost, host and device."""
    import torch
    dev = mx.gpu(0).torch_device()
    h = LM["hidden"]
    ref = torch.nn.LSTM(LM["embed"], h, LM["layers"]).to(dev)
    with torch.no_grad():
        for layer in range(LM["layers"]):
            for ours, theirs in (("i2h_weight", "weight_ih"),
                                 ("h2h_weight", "weight_hh"),
                                 ("i2h_bias", "bias_ih"),
                                 ("h2h_bias", "bias_hh")):
                getattr(ref, "%s_l%d" % (theirs, layer)).copy_(getattr(
                    net.rnn, "l%d_%s" % (layer, ours)).data().tensor)
    ref.flatten_parameters()
    rng = np.random.default_rng(seed + 72)
    shape = (LM["bptt"], LM["batch"], LM["embed"])
    x = mx.nd.array(rng.standard_normal(shape, np.float32), ctx=mx.gpu(0))
    hidden = net.rnn.begin_state(LM["batch"], ctx=mx.gpu(0))
    with torch.no_grad():
        ours = net.rnn(x, hidden)[0].tensor
        theirs = ref(x.tensor)[0]
        err = float((ours - theirs).abs().max())
        port_ms = time_ms(lambda: net.rnn(x, hidden), reps=20)
        ref_ms = time_ms(lambda: ref(x.tensor), reps=20)
        port_host = host_us(lambda: net.rnn(x, hidden), calls=100)
        ref_host = host_us(lambda: ref(x.tensor), calls=100)
    print("lstm-lm: LSTM layer forward (T %d, N %d, 2 x %d), one call: "
          "port %.4f ms (%.0f us host a call) against torch.nn.LSTM on a "
          "packed buffer %.4f ms (%.0f us host); max abs difference %.3g; "
          "card %s" % (LM["bptt"], LM["batch"], h, port_ms, port_host,
                       ref_ms, ref_host, err, card_line()))
    if err > 1e-5:
        raise AssertionError("the LSTM layer disagrees with torch.nn.LSTM")


def _rel(card, host):
    return {k: float(np.linalg.norm(card[k] - host[k])
                     / max(np.linalg.norm(host[k]), 1e-30)) for k in host}


def lstm_lm_host_check(mx, net, seed):
    """The trained LM at full width, batch 2, dropout off, the same
    weights: one forward and backward on the card and on the host; the
    LSTM output within LM_OUT_TOL, every gradient within LM_GRAD_REL
    relative L2."""
    from mxnet_tpu_torch import autograd, gluon
    t0 = time.perf_counter()
    weights = {k: p.data().asnumpy() for k, p in
               net.collect_params().items()}
    rng = np.random.default_rng(seed + 73)
    shape = (LM["bptt"], LM_HOST_BATCH)
    x0, y0 = (rng.integers(0, LM["vocab"], shape).astype(np.float32)
              for _ in range(2))
    h0 = [rng.standard_normal((LM["layers"], LM_HOST_BATCH, LM["hidden"]),
                              np.float32) * 0.1 for _ in range(2)]
    runs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        m = lstm_lm(mx, 0.0)
        mx.convert.set_gluon_params(m, weights, ctx=ctx)
        hidden = [mx.nd.array(h, ctx=ctx) for h in h0]
        with autograd.record():
            out, _ = m.rnn(m.encoder(mx.nd.array(x0, ctx=ctx)), hidden)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                m.decoder(out).reshape((-3, -1)),
                mx.nd.array(y0.reshape(-1), ctx=ctx))
        loss.backward()
        runs.append((out.asnumpy(), {k: p.grad().asnumpy() for k, p in
                                     m.collect_params().items()}))
    (out, card), (hout, host) = runs
    err = float(np.abs(out - hout).max())
    rel = _rel(card, host)
    worst = max(rel, key=rel.get)
    print("lstm-lm: batch-%d forward+backward card vs host (%.1f s): LSTM "
          "output max abs difference %.3g (tolerance %s); gradients "
          "relative L2 largest %.3g (%s), limit %g"
          % (LM_HOST_BATCH, time.perf_counter() - t0, err, LM_OUT_TOL,
             rel[worst], worst, LM_GRAD_REL))
    if not np.allclose(out, hout, **LM_OUT_TOL) or rel[worst] > LM_GRAD_REL:
        raise AssertionError("the card's LSTM LM disagrees with the host's")


def rnn_layers_check(mx, seed):
    """At RNN_CHECK's width: a 2-layer GRU and a bidirectional 2-layer
    rnn_tanh layer, forward and backward on the card against the host
    (outputs within LM_OUT_TOL, gradients within LM_GRAD_REL relative
    L2); then ``LSTMCell.unroll`` against the fused one-layer LSTM with
    the same weights, on the card (LM_OUT_TOL)."""
    from mxnet_tpu_torch import autograd, gluon
    w, t, n = RNN_CHECK["width"], RNN_CHECK["steps"], RNN_CHECK["batch"]
    rng = np.random.default_rng(seed + 74)
    x0 = rng.standard_normal((t, n, w), np.float32)
    for name, make in (
            ("gru", lambda: gluon.rnn.GRU(w, num_layers=2, input_size=w)),
            ("bidirectional rnn_tanh", lambda: gluon.rnn.RNN(
                w, num_layers=2, activation="tanh", bidirectional=True,
                input_size=w))):
        runs, weights = [], None
        for ctx in (mx.gpu(0), mx.cpu()):
            with mx.sym.NameManager():
                layer = make()
            if weights is None:
                mx.random.seed(seed)
                layer.initialize(mx.initializer.Uniform(0.1), ctx=ctx)
                weights = {k: p.data().asnumpy()
                           for k, p in layer.collect_params().items()}
            else:
                mx.convert.set_gluon_params(layer, weights, ctx=ctx)
            x = mx.nd.array(x0, ctx=ctx)
            x.attach_grad()
            with autograd.record():
                out = layer(x)
                loss = (out * out).sum()
            loss.backward()
            grads = {k: p.grad().asnumpy()
                     for k, p in layer.collect_params().items()}
            grads["data"] = x.grad.asnumpy()
            runs.append((out.asnumpy(), grads))
        (out, card), (hout, host) = runs
        rel = _rel(card, host)
        worst = max(rel, key=rel.get)
        print("rnn: %s (T %d, N %d, width %d) card vs host: output max abs "
              "difference %.3g; gradients relative L2 largest %.3g (%s)"
              % (name, t, n, w, float(np.abs(out - hout).max()), rel[worst],
                 worst))
        if not np.allclose(out, hout, **LM_OUT_TOL) or \
                rel[worst] > LM_GRAD_REL:
            raise AssertionError("%s: the card disagrees with the host"
                                 % name)
    dev = mx.gpu(0)
    with mx.sym.NameManager():
        fused = gluon.rnn.LSTM(w, input_size=w, layout="NTC")
        cell = gluon.rnn.LSTMCell(w, input_size=w)
    mx.random.seed(seed + 1)
    fused.initialize(mx.initializer.Uniform(0.1), ctx=dev)
    cell.initialize(ctx=dev)
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, name).set_data(getattr(fused, "l0_" + name).data())
    x = mx.nd.array(x0.transpose(1, 0, 2), ctx=dev)
    outs, _ = cell.unroll(t, x, layout="NTC", merge_outputs=True)
    ref = fused(x)
    err = float(np.abs(outs.asnumpy() - ref.asnumpy()).max())
    print("rnn: LSTMCell.unroll against the fused LSTM on the card (T %d, N "
          "%d, width %d): max abs difference %.3g" % (t, n, w, err))
    if not np.allclose(outs.asnumpy(), ref.asnumpy(), **LM_OUT_TOL):
        raise AssertionError("LSTMCell.unroll disagrees with the fused LSTM")


def ctc_check(mx, seed):
    """``CTCLoss`` at CTC's shape (blank first, labels padded with 0):
    loss and data gradient on the card against the host (CTC_TOL), timed
    forward and backward beside ``torch.nn.functional.ctc_loss`` on the
    same inputs (a yardstick, never the port's path)."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch import autograd
    n, t, a, lmax = CTC["batch"], CTC["steps"], CTC["alphabet"], \
        CTC["max_label"]
    rng = np.random.default_rng(seed + 75)
    data = rng.standard_normal((t, n, a), np.float32) * 2
    lengths = rng.integers(10, lmax + 1, n)
    labels = np.zeros((n, lmax), np.float32)
    for i, k in enumerate(lengths):
        labels[i, :k] = rng.integers(1, a, k)
    res = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        d = mx.nd.array(data, ctx=ctx)
        y = mx.nd.array(labels, ctx=ctx)
        d.attach_grad()

        def fwd_bwd():
            with autograd.record():
                loss = mx.nd.CTCLoss(d, y)
            loss.backward()
            return loss

        loss = fwd_bwd()
        res[str(ctx)] = (loss.asnumpy(), d.grad.asnumpy())
        if ctx == mx.gpu(0):
            port_ms = time_ms(fwd_bwd, reps=10, warmup=2)
    (loss, grad), (hloss, hgrad) = res[str(mx.gpu(0))], res[str(mx.cpu())]
    dev = mx.gpu(0).torch_device()
    logits = torch.tensor(data, device=dev, requires_grad=True)
    targets = torch.tensor(labels, device=dev).long()
    in_lens = torch.full((n,), t, dtype=torch.long, device=dev)
    tgt_lens = torch.tensor(lengths, device=dev)

    def torch_ctc():
        out = TF.ctc_loss(torch.log_softmax(logits, -1), targets, in_lens,
                          tgt_lens, blank=0, reduction="none")
        out.sum().backward()
        return out

    lib = torch_ctc().detach().cpu().numpy()
    lib_ms = time_ms(torch_ctc, reps=10, warmup=2)
    print("ctc: N %d, T %d, alphabet %d, labels %d-%d: card vs host loss "
          "max relative difference %.3g, gradient max abs difference %.3g "
          "(tolerance %s); forward+backward %.3f ms on the card, "
          "torch.nn.functional.ctc_loss %.3f ms (its loss within %.3g "
          "relative); card %s"
          % (n, t, a, lengths.min(), lengths.max(),
             float(np.max(np.abs(loss - hloss) / np.abs(hloss))),
             float(np.abs(grad - hgrad).max()), CTC_TOL, port_ms, lib_ms,
             float(np.max(np.abs(loss - lib) / np.abs(lib))), card_line()))
    if not (np.allclose(loss, hloss, **CTC_TOL)
            and np.allclose(grad, hgrad, **CTC_TOL)
            and np.isfinite(grad).all()):
        raise AssertionError("CTC on the card disagrees with the host")


# Phase 8: ResNet-50 v2 in bf16 with f32 masters through Module.fit and the
# fused train step (one CUDA graph replay a batch), with a learning-rate
# schedule, the Speedometer, checkpoints with optimizer states and resume
FUSED_BATCHES = 6  # an epoch
FUSED_EPOCHS = 2
FUSED_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
             "multi_precision": True}
FUSED_LR_STEP, FUSED_LR_FACTOR = 4, 0.1
# graph against eager, and a resumed run against the uninterrupted one:
# relative L2 per parameter (bit for bit expected: the same arithmetic)
FUSED_SAME_REL = 1e-6
# the card's bf16 step against the host's: relative L2 of each
# parameter's first momentum, or 4x the host's own largest change when its
# input moves by one bf16 ulp (phase 4's rule)
FUSED_HOST_REL = 1e-3
# the path check of bn_channel_sums: |kernel - plain| per channel over the
# channel's sum of absolute terms.  Both sum the same f32 terms (products
# of bf16 values are exact in f32) in two orders, which rounding sets
# apart by at most about 2**-24 x the longest serial chain of additions
# (a few hundred terms here) of that absolute sum, 1e-5 or less; a term
# missed or read from the wrong place moves it by about that term.
PATH_SUM_REL = 1e-4
# the Speedometer line of the JAX package (tools/parse_log.py scrapes it)
SPEED_LINE = r"^Epoch\[(\d+)\] Batch \[(\d+)\]\tSpeed: ([\d.]+) " \
    r"samples/sec((\t[\w-]+=[-\d.e]+)*)$"


def fused_state(mod):
    """{name: (f32 master, momentum)} of a module's fused step, on the
    host."""
    fs = mod._fused_step
    return {n: (fs._masters[j].float().cpu().clone(),
                fs.states[j].float().cpu().clone())
            for j, n in enumerate(fs.param_names)}


def state_gap(got, want):
    """(largest relative L2 of the masters, of the momenta, parameters
    whose master and momentum are bit for bit equal).  Raises where a
    master or momentum on either side is not finite: a NaN difference
    would read as none."""
    import torch
    if set(got) != set(want):
        raise AssertionError("the two states name different parameters")
    for side in (got, want):
        bad = [k for k, (m, s) in side.items()
               if not (bool(torch.isfinite(m).all())
                       and bool(torch.isfinite(s).all()))]
        if bad:
            raise AssertionError("non-finite masters or momenta: %s" % bad)
    worst_m = worst_s = 0.0
    same = 0
    for k, (m, s) in want.items():
        gm, gs = got[k]
        worst_m = max(worst_m, float((gm - m).norm() / m.norm()))
        worst_s = max(worst_s, float((gs - s).norm()
                                     / max(float(s.norm()), 1e-30)))
        same += int(torch.equal(gm, m) and torch.equal(gs, s))
    return worst_m, worst_s, same


def bf16_iter(mx, seed, batch=TRAIN_BATCH, batches=FUSED_BATCHES):
    rng = np.random.default_rng(seed + 8)
    n = batch * batches
    shape = tuple(int(d) for d in RESNET["image_shape"].split(","))
    images = rng.random((n,) + shape, dtype=np.float32)
    labels = rng.integers(0, RESNET["num_classes"], n).astype(np.float32)
    return mx.io.NDArrayIter(images, labels, batch_size=batch)


def bf16_module(mx, symbol, it, seed, ctx=None):
    """A bound module, Xavier (gaussian, in, 2) from ``seed``."""
    mod = mx.mod.Module(symbol, context=ctx or mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    return mod


def fused_optimizer(mx):
    return dict(FUSED_SGD, lr_scheduler=mx.lr_scheduler.MultiFactorScheduler(
        step=[FUSED_LR_STEP], factor=FUSED_LR_FACTOR))


def train_bf16_fused(mx, seed):
    """Phase 8.  Returns the kernel launches of the main path (the
    fit)."""
    import logging
    import re
    import tempfile
    import torch
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.module.fused_step import WARMUP_STEPS
    from mxnet_tpu_torch.ops import kernels as K

    symbol = resnet.get_symbol(dtype="bfloat16", **RESNET)
    per_step = expected_train_launches(symbol)
    it = bf16_iter(mx, seed)
    mod = bf16_module(mx, symbol, it, seed)
    arg0 = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    aux0 = {k: v.asnumpy().copy() for k, v in mod.get_params()[1].items()}
    losses, lrs, step_launches, step_ms_ = [], [], [], []
    marks = {"t": None, "counts": None}

    def on_batch(param):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), K.launch_counts()
        prob = mod.get_outputs()[0].asnumpy()
        lab = param.locals["batch"].label[0].asnumpy().astype(np.int64)
        losses.append(float(-np.log(prob[np.arange(len(lab)), lab]
                                    + 1e-12).mean()))
        lrs.append(mod._optimizer._get_lr(0))
        step_launches.append({k: counts[k] - marks["counts"][k]
                              for k in per_step})
        step_ms_.append((now - marks["t"]) * 1e3)
        marks["t"], marks["counts"] = now, counts

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    speed = Lines()
    root = logging.getLogger()
    level = root.level
    root.setLevel(logging.INFO)
    root.addHandler(speed)
    snapshots = {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fused_")
    prefix = os.path.join(workdir, "resnet50-bf16")
    # deterministic cuDNN for the runs compared bit for bit below (graph
    # against eager, the resumed epoch against the uninterrupted one)
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()  # earlier phases' tensors
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()
        mod.fit(it, num_epoch=FUSED_EPOCHS, eval_metric="ce",
                optimizer_params=fused_optimizer(mx),
                batch_end_callback=[on_batch,
                                    mx.callback.Speedometer(TRAIN_BATCH, 2)],
                epoch_end_callback=[
                    mx.callback.module_checkpoint(
                        mod, prefix, save_optimizer_states=True),
                    lambda epoch, *_: snapshots.__setitem__(
                        epoch, fused_state(mod))])
        torch.cuda.synchronize()
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        root.removeHandler(speed)
        root.setLevel(level)
    fs = mod._fused_step
    n = FUSED_BATCHES * FUSED_EPOCHS
    print("fused: ResNet-50 v2 bf16 (f32 masters) fit of %d epochs x %d "
          "batches of %d: cross-entropy per batch %s; lr per step %s; "
          "host-clock ms per step (synchronized) %s; card %s"
          % (FUSED_EPOCHS, FUSED_BATCHES, TRAIN_BATCH,
             ", ".join("%.4f" % v for v in losses),
             ", ".join("%g" % v for v in lrs),
             ", ".join("%.1f" % v for v in step_ms_), card_line()))
    print("fused: %d parameters (%d with f32 masters), captures %d, "
          "replays %d, capture %.1f ms, num_update %d; launches per step "
          "%s; per replay from the capture record %s; total %s; peak "
          "memory over the fit %.2f GB allocated (%.2f GB held before it: "
          "the fit's own %.2f GB, the eager step's and the capture's "
          "allocations in the graph's pool included), %.2f GB reserved"
          % (len(fs.param_names), sum(fs.mixed), fs.captures, fs.replays,
             fs.capture_seconds * 1e3, mod._optimizer.num_update,
             step_launches[-1], fs.graph_launches, launches, peak / 1e9,
             held / 1e9, (peak - held) / 1e9,
             torch.cuda.memory_reserved() / 1e9))
    want_lrs = [FUSED_SGD["learning_rate"] * (FUSED_LR_FACTOR if t >
                                              FUSED_LR_STEP else 1.0)
                for t in range(1, n + 1)]
    if fs is None or not fs.ran or fs.captures != 1 \
            or fs.replays != n - WARMUP_STEPS:
        raise AssertionError("the fit did not run as one captured CUDA "
                             "graph replayed for every later batch")
    if mod._optimizer.num_update != n or len(losses) != n \
            or not np.allclose(lrs, want_lrs, rtol=1e-12, atol=0):
        raise AssertionError("num_update %d or the lr schedule %s is off"
                             % (mod._optimizer.num_update, lrs))
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite losses %s" % losses)
    if any(d != per_step for d in step_launches) \
            or fs.graph_launches != per_step:
        raise AssertionError("launches per step %s, expected %s"
                             % (step_launches, per_step))
    arg1, aux1 = mod.get_params()
    end = fused_state(mod)
    frozen = [k for k, (m, _) in end.items()
              if np.array_equal(m.numpy(), arg0[k].astype(np.float32))]
    still = [k for k in aux0 if np.array_equal(aux0[k], aux1[k].asnumpy())]
    bf16 = [k for k, v in arg1.items() if v.dtype == torch.bfloat16]
    exe = mod._exec_group.execs[0]
    storage = {str(exe.arg_dict[k].tensor.dtype) for k in bf16}
    masters = {str(m.dtype) for m, mixed in zip(fs._masters, fs.mixed)
               if mixed}
    print("fused: masters moved %d/%d, moving stats moved %d/%d; bf16 "
          "parameters %d, their storage %s, their masters %s"
          % (len(end) - len(frozen), len(end), len(aux0) - len(still),
             len(aux0), len(bf16), storage, masters))
    if frozen or still or storage != {"torch.bfloat16"} \
            or masters != {"torch.float32"} or len(bf16) != sum(fs.mixed):
        raise AssertionError("unchanged or mistyped after fit: %s"
                             % (frozen + still))
    parsed = [re.match(SPEED_LINE, m) for m in speed.lines
              if "\tSpeed: " in m]
    print("fused: Speedometer lines %s" % [m.group(0) if m else None
                                           for m in parsed])
    # one line at batches 2, 4, ... of every epoch (batch 0 starts the clock)
    if len(parsed) != FUSED_EPOCHS * len(range(2, FUSED_BATCHES, 2)) or \
            not all(parsed):
        raise AssertionError("Speedometer lines off the JAX format: %s"
                             % speed.lines)

    # 2. launches of one profiled replay, by device kernel
    it.reset()
    batch = next(it)
    table = profile_run(lambda: (mod.forward_backward(batch), mod.update()),
                        "fused replay")
    if table is not None:
        seen = {name: sum(v[1] for k, v in table.items() if key in k)
                for name, key in HAND_SPLIT}
        bf16 = sorted({re.search(r"(\w+)<__nv_bfloat16", k).group(1)
                       for k in table if "<__nv_bfloat16" in k and any(
                           key in k for _, key in HAND_SPLIT)})
        print("fused: the profiled replay's hand-written device launches %s, "
              "bf16 instances of %s" % (seen, bf16))
        if seen != per_step:
            raise AssertionError("the replay's device launches %s, expected "
                                 "%s" % (seen, per_step))
    fused_same_path_checks(mx, symbol, seed, prefix, snapshots, end)
    fused_host_check(mx, symbol, arg0, aux0, seed)
    fused_numbers(mod, batch, table)
    check_path_bn_sums(mod, batch)
    return launches


def fused_same_path_checks(mx, symbol, seed, prefix, snapshots, end):
    """3. Graph against eager from one state on the same batches; 4. the
    checkpoint of epoch 1 resumed for epoch 2 against the uninterrupted
    run.  Both under deterministic cuDNN (set by the caller)."""
    import torch
    it = bf16_iter(mx, seed)
    batches = list(it)[:1 + 3]
    states = {}
    for path in ("graph", "eager"):
        mod = bf16_module(mx, symbol, it, seed)
        mod.init_optimizer(optimizer_params=FUSED_SGD)
        if path == "eager":
            mod._fused_step = None  # the Updater, mp_sgd_mom_update
        for b in batches:
            mod.forward_backward(b)
            mod.update()
        torch.cuda.synchronize()
        if path == "graph":
            fs = mod._fused_step
            if fs.replays != 3:
                raise AssertionError("the graph ran %d steps" % fs.replays)
            states[path] = fused_state(mod)
        else:
            states[path] = {}
            for i, st in mod._updater.states.items():
                if isinstance(st, tuple):  # multi-precision: (mom, w32)
                    mom, master = st
                else:
                    mom, master = st, mod._exec_group.param_arrays[i][0]
                states[path][mod._param_names[i]] = (
                    master.tensor.float().cpu().clone(),
                    mom.tensor.float().cpu().clone())
        del mod
    gap = state_gap(states["graph"], states["eager"])
    print("fused: 1 eager + 3 graph steps against 4 general-path steps, "
          "deterministic cuDNN: masters largest relative L2 %.3g, momenta "
          "%.3g, bit for bit %d/%d (limit %g)"
          % (gap[0], gap[1], gap[2], len(states["eager"]), FUSED_SAME_REL))
    if max(gap[:2]) > FUSED_SAME_REL:
        raise AssertionError("the graph's step disagrees with the eager "
                             "general path")
    # 4. resume: MXNet's fit.py _get_lr_scheduler: the lr already decayed
    # for the epochs done, the remaining steps shifted by begin_epoch x
    # epoch size (none remain here)
    begin = 1
    lr = FUSED_SGD["learning_rate"] * (
        FUSED_LR_FACTOR if begin * FUSED_BATCHES > FUSED_LR_STEP else 1.0)
    steps = [FUSED_LR_STEP - begin * FUSED_BATCHES] \
        if FUSED_LR_STEP > begin * FUSED_BATCHES else []
    opt = dict(FUSED_SGD, learning_rate=lr)
    if steps:
        opt["lr_scheduler"] = mx.lr_scheduler.MultiFactorScheduler(
            step=steps, factor=FUSED_LR_FACTOR)
    mod = mx.mod.Module.load(prefix, begin, load_optimizer_states=True,
                             context=mx.gpu(0))
    it.reset()
    mod.bind(it.provide_data, it.provide_label)
    mod.init_optimizer(optimizer_params=opt)
    loaded = state_gap(fused_state(mod), snapshots[begin - 1])
    mod.fit(it, begin_epoch=begin, num_epoch=FUSED_EPOCHS,
            optimizer_params=opt, eval_metric="ce")
    torch.cuda.synchronize()
    resumed = state_gap(fused_state(mod), end)
    print("fused: resume from epoch %d (lr %g, schedule steps %s): loaded "
          "masters and momenta bit for bit %d/%d (largest relative L2 %.3g, "
          "%.3g); after epoch %d against the uninterrupted run: masters "
          "%.3g, momenta %.3g, bit for bit %d/%d (limit %g)"
          % (begin, lr, steps, loaded[2], len(end), loaded[0], loaded[1],
             FUSED_EPOCHS, resumed[0], resumed[1], resumed[2], len(end),
             FUSED_SAME_REL))
    if loaded[2] != len(end) or max(resumed[:2]) > FUSED_SAME_REL:
        raise AssertionError("the resumed run does not reproduce the "
                             "uninterrupted one")
    del mod


def bf16_ulp_up(images, pixels):
    """``images`` as bf16 values, with the flat ``pixels`` of every image
    moved to the next bf16 value up."""
    import torch
    t = torch.from_numpy(images).bfloat16().reshape(len(images), -1)
    bits = t.view(torch.int16)
    bits[:, pixels] += 1  # positive values: the next one up
    return t.float().reshape(images.shape).numpy()


def fused_host_check(mx, symbol, arg0, aux0, seed):
    """5. One batch-2 bf16 fused step on the card against the same step on
    the host: the step's outputs by max abs error, within HOST_OUT_TOL's
    atol or 4x the host's own floor, and each parameter's first momentum
    (-lr * (gradient / batch + wd * weight)) by relative L2, within
    FUSED_HOST_REL or 4x the host's
    own largest change when a few pixels of its input move by one bf16
    ulp.  BatchNorm gammas and betas drawn away from 1 and 0, as phase 4's
    check.

    In bf16 at Xavier init this floor is near 1: a one-ulp change of the
    input flips the bf16 rounding of activations throughout the 50
    layers, and the chaotic BatchNorm net carries that to the whole
    gradient.  So this check catches only gross faults (non-finite
    values, wrong shapes, an error far beyond the host's own); the bf16
    kernels on the path are held to their plain versions by phase 2 and
    ``check_path_bn_sums``."""
    rng = np.random.default_rng(seed + 9)
    arg = dict(arg0)
    for k, v in arg.items():
        if k.endswith("_gamma"):
            arg[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        elif k.endswith("_beta"):
            arg[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    images = rng.random((HOST_BATCH, 3, 224, 224), dtype=np.float32)
    labels = rng.integers(0, RESNET["num_classes"], HOST_BATCH).astype(
        np.float32)
    # a few pixels of each image one bf16 ulp up (the graph casts its
    # input to bf16 first)
    nudged = bf16_ulp_up(images, rng.choice(images[0].size, 16,
                                            replace=False))
    moms, outs = [], []
    for ctx, data in ((mx.gpu(0), images), (mx.cpu(), images),
                      (mx.cpu(), nudged)):
        it = mx.io.NDArrayIter(data, labels, batch_size=HOST_BATCH)
        mod = mx.mod.Module(symbol, context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        types = dict(zip(symbol.list_arguments(),
                         symbol.infer_type(data="float32")[0]))
        mod.init_params(
            arg_params={k: mx.nd.array(v, ctx=mx.cpu()).astype(
                mx.base.dtype_name(types[k])) for k, v in arg.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux0.items()})
        mod.init_optimizer(optimizer_params=FUSED_SGD)
        mod.forward_backward(next(it))
        mod.update()
        moms.append({k: s for k, (_, s) in fused_state(mod).items()})
        outs.append(mod.get_outputs()[0].asnumpy())

    def rel(a, b):
        return {k: float((a[k] - b[k]).norm() / b[k].norm())
                for k in b if float(b[k].norm()) > 0}

    err, floor = rel(moms[0], moms[1]), rel(moms[2], moms[1])
    if not all(np.isfinite(o).all() for o in outs) or not all(
            np.isfinite(v) for v in [*err.values(), *floor.values()]):
        raise AssertionError("non-finite outputs or momenta in the bf16 "
                             "step on the card or the host")
    limit = max(FUSED_HOST_REL, 4.0 * max(floor.values()))
    worst = max(err, key=err.get)
    out_err = float(np.abs(outs[0] - outs[1]).max())
    out_floor = float(np.abs(outs[2] - outs[1]).max())
    out_limit = max(HOST_OUT_TOL["atol"], 4.0 * out_floor)
    print("fused: batch-%d bf16 step card vs host: the step's outputs "
          "max_abs_err %.3g, the host's own floor %.3g, so the limit is %.3g"
          % (HOST_BATCH, out_err, out_floor, out_limit))
    print("fused: batch-%d bf16 step card vs host: first momenta relative "
          "L2 largest %.3g (%s), median %.3g, %d/%d within %g; the host's "
          "own floor (16 pixels an image moved by one bf16 ulp) largest "
          "%.3g, median "
          "%.3g, so the limit is %.3g"
          % (HOST_BATCH, err[worst], worst, float(np.median(list(
              err.values()))), sum(v <= FUSED_HOST_REL for v in err.values()),
             len(err), FUSED_HOST_REL, max(floor.values()),
             float(np.median(list(floor.values()))), limit))
    if not (err[worst] <= limit and out_err <= out_limit):
        raise AssertionError("the card's bf16 step disagrees with the host's")


def fused_numbers(mod, batch, replay):
    """6. ms a step and images/s of the bf16 fused graph and the bf16
    general path (median of TIMED_STEPS unprofiled steps after warm-up,
    deterministic cuDNN off), and the device's busy share of one profiled
    replay and of one profiled general step, each from its own trace."""
    import torch
    torch.backends.cudnn.deterministic = False
    graph_ms = time_steps(mod, batch)
    mod._fused_step = None  # the general path from here
    eager_ms = time_steps(mod, batch)
    eager = profile_run(lambda: (mod.forward_backward(batch), mod.update()),
                        "bf16 general step")

    def share(table):
        return "not measured" if table is None else table.share()

    print("fused: path fused bf16 (graph) ms per step %.2f, %.1f images/s, "
          "profiled replay: %s; path general bf16 (eager) %.2f ms, %.1f "
          "images/s, profiled step: %s; card %s"
          % (graph_ms, TRAIN_BATCH / graph_ms * 1e3, share(replay), eager_ms,
             TRAIN_BATCH / eager_ms * 1e3, share(eager), card_line()))


def check_path_bn_sums(mod, batch):
    """bn_channel_sums on the tensors the bf16 path gives it: one general
    step (the same graph, dtypes and layouts as the fused step's) records
    a copy of the inputs of the first call of each distinct case (shape,
    dtype, strides, single or paired), then each case runs the kernel and
    its plain version on those copies, which keep the originals' strides,
    storage offsets and so the wrapper's choice of loads (8-wide or one
    element).  Within PATH_SUM_REL of each channel's absolute sum."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K

    def like(t):
        buf = torch.empty(t.untyped_storage().nbytes() // t.element_size(),
                          dtype=t.dtype, device=t.device)
        return buf.as_strided(t.size(), t.stride(),
                              t.storage_offset()).copy_(t)

    wrapper, cases, calls = K.bn_channel_sums, {}, []

    def record(a, b=None):
        ins = (a,) if b is None else (a, b)
        key = (tuple(a.shape), a.dtype, tuple(t.stride() for t in ins))
        calls.append(key)
        if key not in cases:
            cases[key] = (tuple(like(t) for t in ins),
                          K._bn_vec(ins, a.shape[2], a.shape[3]))
        return wrapper(a, b)

    K.bn_channel_sums = record
    try:
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
    finally:
        K.bn_channel_sums = wrapper
    worst, by_load = 0.0, {}
    for key, (ins, vec) in cases.items():
        h, w = key[0][2:]
        if K._bn_vec(ins, h, w) != vec:
            raise AssertionError("the copy of %s takes other loads" % (key,))
        got = wrapper(*ins)
        want = K._plain_channel_sums(*ins)
        scale = K._plain_channel_sums(*(t.abs() for t in ins))
        torch.cuda.synchronize()
        err = max(float(((g - w_) / s.clamp_min(1e-30)).abs().max())
                  for g, w_, s in zip(got, want, scale))
        if not err <= PATH_SUM_REL:
            raise AssertionError("bn_channel_sums disagrees with its plain "
                                 "version on the path's %s: %.3g of the "
                                 "absolute sum" % (key, err))
        worst = max(worst, err)
        load = "%s %d-wide%s" % (str(key[1]).replace("torch.", ""), vec[0],
                                 "" if vec[1] else " unflattened")
        n = sum(1 for k in calls if k == key)
        by_load[load] = by_load.get(load, 0) + n
    print("path bn_channel_sums: %d calls in one bf16 step, %d distinct "
          "cases (shape, dtype, strides, single or paired), each against "
          "its plain version on copies of the path's own tensors: largest "
          "|kernel - plain| %.3g of the channel's absolute sum (limit %g); "
          "calls by load %s" % (len(calls), len(cases), worst, PATH_SUM_REL,
                                by_load))


# phase 9: BASELINE config 4's LSTM LM (examples/rnn/lstm_bucketing.py at
# bench.py's _bench_lstm widths) through mx.rnn and BucketingModule
BUCKET_LM = dict(vocab=10000, embed=200, hidden=200, layers=2, batch=32)
BUCKET_LM_PARAMETERS = 4653200
BUCKET_KEYS = [10, 20, 30, 40]
BUCKET_SENTENCES = 4000  # split 4:1 into train and eval
BUCKET_EPOCHS = 2
BUCKET_SGD = {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-5}
# graph against eager and the monitor handover: SGD with momentum, so that
# one shared optimizer state is what is compared
BUCKET_MOM_SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-5}
BUCKET_ROUNDS = 3  # batches per bucket in the graph-against-eager run
BUCKET_SAME_REL = 1e-6
# the fit against the eager fit of the same batches: both run the same
# kernels under deterministic cuDNN, but the graphs' stream may get other
# cuBLAS splits than the default stream's
BUCKET_FIT_REL = 1e-5
# card against host: the softmax outputs (about 1e-4 each over 10,000
# classes) and the gradients by relative L2
BUCKET_OUT_REL = 1e-5
BUCKET_GRAD_REL = LM_GRAD_REL
BUCKET_GROUPS = (  # by kernel name, first match wins
    ("cuDNN RNN", ("rnn", "lstm", "persist")),
    ("cuBLAS", ("gemm", "xmma", "sm90", "sm80", "cutlass")),
    ("elementwise and reductions (torch)",
     ("elementwise", "vectorized", "reduce", "unrolled", "fill", "copy",
      "index", "gather", "scatter", "embedding", "softmax")),
)


def bucket_sentences(n, vocab, seed):
    """``examples/rnn/lstm_bucketing.py``'s synthetic_sentences: lengths
    5-39, each word a Markov step from the last, ids in [1, vocab)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = rng.randint(5, 40)
        s = [int(rng.randint(1, vocab))]
        for _ in range(length - 1):
            s.append(int((s[-1] * 7 + rng.randint(0, 3)) % vocab) or 1)
        out.append(s)
    return out


def bucket_sym_gen(mx):
    """The example's sym_gen: Embedding -> FusedRNNCell.unroll ->
    Reshape -> FullyConnected -> SoftmaxOutput."""
    cfg = BUCKET_LM
    stack = mx.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"],
                                mode="lstm")

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=cfg["vocab"],
                                 output_dim=cfg["embed"], name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, cfg["hidden"]))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=cfg["vocab"],
                                     name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def bucket_batch(mx, key, seed):
    """A batch of bucket ``key``: random ids, next-token labels."""
    rng = np.random.RandomState(seed)
    b, v = BUCKET_LM["batch"], BUCKET_LM["vocab"]
    data = rng.randint(1, v, (b, key)).astype(np.float32)
    label = np.concatenate([data[:, 1:], np.zeros((b, 1), np.float32)], 1)
    return mx.io.DataBatch(
        [mx.nd.array(data, ctx=mx.cpu())], [mx.nd.array(label, ctx=mx.cpu())],
        pad=0, bucket_key=key,
        provide_data=[mx.io.DataDesc("data", (b, key))],
        provide_label=[mx.io.DataDesc("softmax_label", (b, key))])


def bucket_module(mx, seed, ctx, optimizer_params):
    """A BucketingModule with every bucket bound, Xavier (in, 2.34) from
    ``seed``, its optimizer initialized."""
    mod = mx.mod.BucketingModule(bucket_sym_gen(mx),
                                 default_bucket_key=max(BUCKET_KEYS),
                                 context=ctx)
    first = bucket_batch(mx, max(BUCKET_KEYS), 0)
    mod.bind(first.provide_data, first.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(factor_type="in", magnitude=2.34))
    mod.init_optimizer(optimizer_params=dict(optimizer_params))
    for key in BUCKET_KEYS:
        mod.prepare(bucket_batch(mx, key, 0))
    return mod


def bucket_state(mod):
    """{name: (master, momentum)} on the host: the shared fused state, or
    the Updater's after the fused steps are gone."""
    anchor = mod._buckets[max(BUCKET_KEYS)]
    fs = anchor._fused_step
    if fs is not None:
        shared = fs.shared
        return {n: (shared.masters[n].float().cpu().clone(),
                    shared.states[n].float().cpu().clone())
                for n in shared.index}
    exe = anchor._exec_group.execs[0]
    return {n: (exe.arg_dict[n].tensor.float().cpu().clone(),
                anchor._updater.states[i].tensor.float().cpu().clone())
            for i, n in enumerate(anchor._param_names)}


def bucket_fit_setup(mx, seed, sentences):
    """The example's fit on the card, made ready: its iterators (shuffled
    from ``seed``), a BucketingModule bound and initialized with Xavier
    (in, 2.34) from ``seed``, and the eval split's perplexity over every
    label before training.  Returns the module, the train iterator and a
    record whose ``fit(*batch_end_callbacks)`` runs ``fit`` and fills in
    the per-batch cross-entropy over the real words, the batches' bucket
    keys, and each epoch's eval Perplexity(0) and perplexity over every
    label."""
    random.seed(seed)
    np.random.seed(seed)
    cfg = BUCKET_LM
    split = len(sentences) * 4 // 5
    train_it = mx.rnn.BucketSentenceIter(sentences[:split], cfg["batch"],
                                         buckets=BUCKET_KEYS,
                                         invalid_label=0)
    eval_it = mx.rnn.BucketSentenceIter(sentences[split:], cfg["batch"],
                                        buckets=BUCKET_KEYS, invalid_label=0)
    mod = mx.mod.BucketingModule(bucket_sym_gen(mx),
                                 default_bucket_key=train_it.default_bucket_key,
                                 context=mx.gpu(0))
    mod.bind(train_it.provide_data, train_it.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(factor_type="in", magnitude=2.34))
    rec = {"eval_it": eval_it, "losses": [], "keys": [], "evals": [],
           "objective": []}
    marks = {"sum": 0.0, "n": 0}

    def objective():
        return dict(mod.score(eval_it, mx.metric.Perplexity(None)))[
            "perplexity"]

    def on_batch(param):
        m = param.eval_metric
        if param.nbatch == 0 or m.num_inst < marks["n"]:
            # a new epoch, or the Speedometer reset the metric after the
            # last batch
            marks["sum"], marks["n"] = 0.0, 0
        d_sum, d_n = m.sum_metric - marks["sum"], m.num_inst - marks["n"]
        marks["sum"], marks["n"] = m.sum_metric, m.num_inst
        rec["losses"].append(float(np.log(d_sum / d_n)) if d_n
                             else float("nan"))
        rec["keys"].append(param.locals["batch"].bucket_key)

    def fit(*batch_end_callbacks):
        mod.fit(train_it, eval_data=eval_it,
                eval_metric=mx.metric.Perplexity(0), optimizer="sgd",
                optimizer_params=dict(BUCKET_SGD),
                initializer=mx.initializer.Xavier(factor_type="in",
                                                  magnitude=2.34),
                num_epoch=BUCKET_EPOCHS,
                batch_end_callback=[on_batch, *batch_end_callbacks],
                epoch_end_callback=lambda *_: rec["objective"].append(
                    objective()),
                eval_end_callback=lambda p: rec["evals"].append(
                    dict(p.eval_metric.get_name_value())["perplexity"]))

    rec["start"] = objective()
    rec["fit"] = fit
    return mod, train_it, rec


def bucket_fit_witness(mx, seed, sentences, fused):
    """The fit again from the same state on the same batches in the same
    order, every bucket on the eager general path (the anchor's fused
    step retired before ``fit``): its per-batch cross-entropy, eval
    perplexities and objective must be the graphs' within BUCKET_FIT_REL,
    whatever the model learns in two epochs."""
    import torch
    mod, _, rec = bucket_fit_setup(mx, seed, sentences)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(BUCKET_SGD))
    mod._buckets[max(BUCKET_KEYS)]._retire_fused_step("the eager witness")
    t0 = time.perf_counter()
    rec["fit"](mx.callback.Speedometer(BUCKET_LM["batch"], 20))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    if any(m._fused_step is not None for m in mod._buckets.values()):
        raise AssertionError("a bucket of the eager witness ran fused")
    gaps = {}
    for k in ("start", "losses", "evals", "objective"):
        a = np.atleast_1d(np.asarray(fused[k], np.float64))
        b = np.atleast_1d(np.asarray(rec[k], np.float64))
        gaps[k] = float(np.max(np.abs(a - b) / np.abs(b))) \
            if a.shape == b.shape else float("inf")
    same = sum(a == b for a, b in zip(fused["losses"], rec["losses"]))
    print("bucketing: the fit against an eager fit of the same %d batches "
          "(every bucket on the general path, %.2f s, %.2f batches/s, host "
          "clock): largest relative difference of the per-batch "
          "cross-entropy %.3g (%d/%d bit for bit), of the eval "
          "perplexities %.3g, of the objective %.3g (limit %g); eager eval "
          "perplexity per epoch %s"
          % (len(rec["losses"]), eager_s, len(rec["losses"]) / eager_s,
             gaps["losses"], same, len(rec["losses"]), gaps["evals"],
             gaps["objective"], BUCKET_FIT_REL,
             ", ".join("%.2f" % v for v in rec["evals"])))
    if fused["keys"] != rec["keys"] or max(gaps.values()) > BUCKET_FIT_REL:
        raise AssertionError("the fit disagrees with the eager fit of the "
                             "same batches: %s" % gaps)
    del mod


def train_bucketing(mx, seed):
    """Phase 9.  Returns the kernel launches of the main path (the fit;
    none of the hand-written kernels lies on it)."""
    import torch
    from mxnet_tpu_torch.module import fused_step as F
    from mxnet_tpu_torch.ops import kernels as K

    cfg = BUCKET_LM
    t0 = time.perf_counter()
    sentences = bucket_sentences(BUCKET_SENTENCES, cfg["vocab"], seed + 90)
    mod, train_it, rec = bucket_fit_setup(mx, seed, sentences)
    per_bucket = {k: 0 for k in BUCKET_KEYS}
    for b, _ in train_it.idx:
        per_bucket[BUCKET_KEYS[b]] += 1
    # each capture's memory: what its graph's private pool still holds
    captured = {}
    capture = F.FusedTrainStep._capture

    def measured_capture(step):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        capture(step)
        torch.cuda.synchronize()
        captured[tuple(step.exe.arg_dict["data"].shape)] = \
            torch.cuda.memory_allocated() - before

    print("bucketing: %d sentences of lengths 5-39 (vocabulary %d, seed "
          "%d) in %.1f s; %d train batches a epoch by bucket %s, %d eval "
          "batches" % (len(sentences), cfg["vocab"], seed + 90,
                       time.perf_counter() - t0, len(train_it.idx),
                       per_bucket, len(rec["eval_it"].idx)))
    F.FusedTrainStep._capture = measured_capture
    # deterministic cuDNN, so that the eager witness below may repeat the
    # fit's every batch
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        f0 = time.perf_counter()
        rec["fit"](mx.callback.Speedometer(cfg["batch"], 20))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - f0
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        F.FusedTrainStep._capture = capture
    losses, keys, evals, objective, start = (
        rec[k] for k in ("losses", "keys", "evals", "objective", "start"))
    n = len(train_it.idx) * BUCKET_EPOCHS
    anchor = mod._buckets[train_it.default_bucket_key]
    n_params = sum(v.size for v in mod.get_params()[0].values())
    steps = {k: m._fused_step for k, m in mod._buckets.items()}
    print("bucketing: %d parameters; fit of %d epochs: %d batches in %.2f s "
          "(%.2f batches/s, host clock, eval and the first batch's "
          "captures included, deterministic cuDNN); per-batch cross-entropy "
          "first %s, last %s; eval perplexity per epoch %s (the padding "
          "label 0 ignored); over every label (the objective SGD lowers) "
          "%.2f before the fit, then %s; card %s"
          % (n_params, BUCKET_EPOCHS, n, fit_s, n / fit_s,
             ", ".join("%.3f" % v for v in losses[:4]),
             ", ".join("%.3f" % v for v in losses[-4:]),
             ", ".join("%.2f" % v for v in evals), start,
             ", ".join("%.2f" % v for v in objective), card_line()))
    if n_params != BUCKET_LM_PARAMETERS:
        raise AssertionError("the LM has %d parameters, not %d"
                             % (n_params, BUCKET_LM_PARAMETERS))
    if sorted(mod._buckets) != BUCKET_KEYS or any(
            s is None or not s.ran for s in steps.values()):
        raise AssertionError("a bucket did not train through the fused "
                             "step: %s" % steps)
    counts = {k: keys.count(k) for k in BUCKET_KEYS}
    for k, s in steps.items():
        print("bucketing: bucket %d: %d batches, captures %d, replays %d, "
              "capture %.1f ms, graph memory %.1f MB"
              % (k, counts[k], s.captures, s.replays, s.capture_seconds * 1e3,
                 captured.get((cfg["batch"], k), float("nan")) / 1e6))
        if s.captures != 1 or s.replays != counts[k] - F.WARMUP_STEPS:
            raise AssertionError("bucket %d was not captured once and "
                                 "replayed for every later batch" % k)
    shared = anchor._fused_step.shared
    for k, m in mod._buckets.items():
        exe = m._exec_group.execs[0]
        s = steps[k]
        for name in shared.index:
            ptr = anchor._exec_group.execs[0].arg_dict[name].tensor.data_ptr()
            if exe.arg_dict[name].tensor.data_ptr() != ptr or \
                    s.shared is not shared or not any(
                        t.data_ptr() == ptr for t in s._bound):
                raise AssertionError("bucket %d does not hold the anchor's "
                                     "%s" % (k, name))
    if mod._optimizer.num_update != n or len(losses) != n:
        raise AssertionError("num_update %d for %d batches"
                             % (mod._optimizer.num_update, n))
    # The example trains the padding label 0 too (SoftmaxOutput without
    # use_ignore).  At this width and learning rate two epochs learn little
    # beyond it, and learning it moves probability off the real words, so
    # Perplexity(0) on the eval split need not fall.  What SGD lowers is
    # the perplexity over every label, which must end each epoch below
    # where it started; note that this check passes whenever the padding
    # label alone is learned.  That the fit computes what it should is
    # held below against an eager fit of the same batches.
    if not (all(np.isfinite(losses)) and all(np.isfinite(evals))
            and len(evals) == len(objective) == BUCKET_EPOCHS
            and max(objective) < start):
        raise AssertionError("losses %s, eval perplexities %s or %s from %s"
                             % (losses, evals, objective, start))
    print("bucketing: peak memory over the fit %.3f GB allocated (%.3f GB "
          "held before it; the graphs' pools included), %.3f GB reserved"
          % (peak / 1e9, held / 1e9, torch.cuda.memory_reserved() / 1e9))
    if any(launches.values()):
        raise AssertionError("the bucketing path launched %s" % launches)
    bucket_fit_witness(mx, seed, sentences, rec)
    torch.backends.cudnn.deterministic = False
    bucket_numbers(mx, mod)
    del mod, anchor, steps, shared
    bucket_same_path_checks(mx, seed)
    bucket_host_check(mx, seed)
    return launches


def bucket_numbers(mx, mod):
    """ms per step and tokens/s per bucket (median of TIMED_STEPS after
    warm-up) of the graph replay and of the eager general path; the busy
    share and device time by group of one profiled replay and one
    profiled eager step at the largest bucket, each from its own trace."""
    import torch
    torch.backends.cudnn.deterministic = False
    b = BUCKET_LM["batch"]
    batches = {k: bucket_batch(mx, k, 900 + k) for k in BUCKET_KEYS}
    graph = {k: time_steps(mod, batches[k]) for k in BUCKET_KEYS}
    big = batches[max(BUCKET_KEYS)]
    replay = profile_run(lambda: (mod.forward_backward(big), mod.update()),
                         "bucketing replay (bucket %d)" % max(BUCKET_KEYS),
                         BUCKET_GROUPS)
    anchor = mod._buckets[max(BUCKET_KEYS)]
    anchor._retire_fused_step("timing the general path")
    eager = {k: time_steps(mod, batches[k]) for k in BUCKET_KEYS}
    general = profile_run(lambda: (mod.forward_backward(big), mod.update()),
                          "bucketing eager (bucket %d)" % max(BUCKET_KEYS),
                          BUCKET_GROUPS)

    def share(table):
        return "not measured" if table is None else table.share()

    for k in BUCKET_KEYS:
        print("bucketing: bucket %d: graph replay %.3f ms per step, %.0f "
              "tokens/s; eager general path %.3f ms, %.0f tokens/s"
              % (k, graph[k], b * k / graph[k] * 1e3, eager[k],
                 b * k / eager[k] * 1e3))
    print("bucketing: at bucket %d the profiled replay: %s; the profiled "
          "eager step: %s; card %s" % (max(BUCKET_KEYS), share(replay),
                                       share(general), card_line()))


def bucket_same_path_checks(mx, seed):
    """2. Graph against eager: BUCKET_ROUNDS rounds over the buckets from
    one state, once through the fused graphs and once on the eager general
    path (one Updater), SGD with momentum, deterministic cuDNN; 3. the
    same run with a Monitor(1) installed after all but the last round:
    every bucket's step retires, the monitor sees every op output, and the
    end state is the eager run's."""
    import torch
    torch.backends.cudnn.deterministic = True
    dev = mx.gpu(0)
    order = BUCKET_KEYS * BUCKET_ROUNDS
    batches = [bucket_batch(mx, k, 500 + i) for i, k in enumerate(order)]
    states, rows = {}, []
    for path in ("graph", "eager", "monitor"):
        mod = bucket_module(mx, seed, dev, BUCKET_MOM_SGD)
        if path == "eager":
            mod._buckets[max(BUCKET_KEYS)]._retire_fused_step("eager path")
        mon = mx.Monitor(1)
        for i, batch in enumerate(batches):
            if path == "monitor" and i == len(order) - len(BUCKET_KEYS):
                mod.install_monitor(mon)
                if any(m._fused_step is not None
                       for m in mod._buckets.values()):
                    raise AssertionError("a bucket's fused step survived "
                                         "the monitor")
            if path == "monitor" and i >= len(order) - len(BUCKET_KEYS):
                mon.tic()
            mod.forward_backward(batch)
            mod.update()
            if path == "monitor" and i >= len(order) - len(BUCKET_KEYS):
                rows.append((batch.bucket_key, mon.toc()))
        torch.cuda.synchronize()
        if path == "graph":
            reps = {k: m._fused_step.replays for k, m in mod._buckets.items()}
            if set(reps.values()) != {BUCKET_ROUNDS - 1}:
                raise AssertionError("replays per bucket %s" % reps)
        states[path] = bucket_state(mod)
        if path == "monitor":
            for key, stats in rows:
                sym = mod._buckets[key].symbol
                want = {node.name + ("_output" if i == 0 else "_output%d" % i)
                        for node in sym._topo() if not node.is_var
                        for i in range(node.num_outputs())}
                got = {name for _, name, _ in stats}
                if not want <= got or not all(
                        np.isfinite(float(v.split(",")[0]))
                        for _, _, v in stats):
                    raise AssertionError("the monitor missed %s at bucket "
                                         "%d" % (sorted(want - got), key))
        del mod
    gap = state_gap(states["graph"], states["eager"])
    mon_gap = state_gap(states["monitor"], states["eager"])
    print("bucketing: %d batches over buckets %s (%d rounds; per bucket 1 "
          "eager step, then graph replays), SGD momentum 0.9, "
          "deterministic cuDNN: graph against the eager general path: "
          "masters largest relative L2 %.3g, momenta %.3g, bit for bit "
          "%d/%d; with a Monitor(1) from batch %d: %.3g, %.3g, bit for bit "
          "%d/%d, %d stats over the %d monitored batches (limit %g)"
          % (len(order), BUCKET_KEYS, BUCKET_ROUNDS, gap[0], gap[1], gap[2],
             len(states["eager"]), len(order) - len(BUCKET_KEYS) + 1,
             mon_gap[0], mon_gap[1], mon_gap[2], len(states["eager"]),
             sum(len(s) for _, s in rows), len(rows), BUCKET_SAME_REL))
    if max(gap[:2] + mon_gap[:2]) > BUCKET_SAME_REL:
        raise AssertionError("the graphs or the monitor handover disagree "
                             "with the eager general path")
    torch.backends.cudnn.deterministic = False


def bucket_host_check(mx, seed):
    """4. One bucket-10 step at batch 32 on the card against the host:
    the softmax outputs within BUCKET_OUT_REL and every gradient within
    BUCKET_GRAD_REL, by relative L2."""
    key = min(BUCKET_KEYS)
    batch = bucket_batch(mx, key, 77)
    sym, data_names, label_names = bucket_sym_gen(mx)(key)
    params = None
    got = []
    for ctx in (mx.gpu(0), mx.cpu()):
        mod = mx.mod.Module(sym, data_names, label_names, context=ctx)
        mod.bind(batch.provide_data, batch.provide_label)
        if params is None:
            mx.random.seed(seed)
            mod.init_params(mx.initializer.Xavier(factor_type="in",
                                                  magnitude=2.34))
            params = {k: v.copyto(mx.cpu())
                      for k, v in mod.get_params()[0].items()}
        else:
            mod.init_params(arg_params=params)
        mod.forward(batch, is_train=True)
        mod.backward()
        exe = mod._exec_group.execs[0]
        got.append((mod.get_outputs()[0].asnumpy(),
                    {n: exe.grad_dict[n].asnumpy() for n in params}))
    (out_c, grad_c), (out_h, grad_h) = got
    out_err = float(np.abs(out_c - out_h).max())
    out_rel = float(np.linalg.norm(out_c - out_h) / np.linalg.norm(out_h))
    rel = {n: float(np.linalg.norm(grad_c[n] - grad_h[n])
                    / max(np.linalg.norm(grad_h[n]), 1e-30))
           for n in grad_h}
    worst = max(rel, key=rel.get)
    print("bucketing: bucket-%d step at batch %d, card against host: "
          "outputs relative L2 %.3g (limit %g, max_abs_err %.3g); gradients "
          "largest relative L2 %.3g (%s), limit %g"
          % (key, BUCKET_LM["batch"], out_rel, BUCKET_OUT_REL, out_err,
             rel[worst], worst, BUCKET_GRAD_REL))
    if not (out_rel <= BUCKET_OUT_REL and rel[worst] <= BUCKET_GRAD_REL):
        raise AssertionError("the card's bucket step disagrees with the "
                             "host's")


# phase 10: the rest of serving.  (a) paged-KV decode of the zoo
# TransformerLM at GPT-2 small's widths (gpt2s-serve's configuration)
DECODE_SLOTS = 8
DECODE_PAGE = 16
DECODE_PAGES = 512
DECODE_STREAMS = 16
DECODE_PROMPT = (16, 512)     # prompt tokens, uniform
DECODE_NEW = (32, 128)        # new tokens, uniform
DECODE_LONG = (900, 100)      # one stream near the full context
DECODE_HEAD, DECODE_TAIL = 256, 16
DECODE_TAILS = 4              # the head with 4 different tails, then whole
DECODE_HEAD_NEW = 32
DECODE_SOLO = 3               # streams held to a solo decode, bit for bit
DECODE_FWD_TOL = 2e-3         # decode vs the full-sequence forward
# (b) BASELINE config 4's LSTM LM (bench.py's _bench_lstm widths) as one
# step symbol of two LSTMCells, through the continuous batcher
CB_LM = dict(vocab=10000, embed=200, hidden=200)
CB_SLOTS = 8
CB_STREAMS = 32               # of 10-40 tokens, joining and leaving
CB_SOLO = 3
CB_HOST_TOL = dict(atol=1e-4, rtol=1e-4)
# (c) int8 ResNet-50 v2 served at batch up to 32; (d) a 2-replica fleet
INT8_MAX_BATCH = 32
INT8_CAL_BATCHES = 4
INT8_HOST_ROWS = 2
INT8_HOST_REL = 1e-2          # served card logits vs host, relative L2
INT8_LAYER_TOL = 1e-5         # a quantized op on the host's input, card
FLEET_MAX_BATCH = 8
FLEET_REQUESTS = 16           # of 1-8 rows, concurrent


def _image_shape():
    return tuple(int(d) for d in RESNET["image_shape"].split(","))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def decode_traffic(dec, rng):
    """Phase 10a's traffic: the long stream, then DECODE_STREAMS streams
    submitted two steps apart, drained; then the shared head with
    DECODE_TAILS tails (the first fills the prefix cache) and the head
    whole (the copy-on-write case).  Returns (streams by name, steps,
    appended tokens, clones of the whole-head resubmission)."""
    vocab = dec.vocab_size
    streams, steps, appended = {}, 0, 0

    def step():
        nonlocal steps, appended
        appended += dec.step()
        steps += 1

    streams["long"] = dec.submit(rng.integers(0, vocab, DECODE_LONG[0]),
                                 max_new_tokens=DECODE_LONG[1])
    for i in range(DECODE_STREAMS):
        streams["s%d" % i] = dec.submit(
            rng.integers(0, vocab, int(rng.integers(DECODE_PROMPT[0],
                                                    DECODE_PROMPT[1] + 1))),
            max_new_tokens=int(rng.integers(DECODE_NEW[0],
                                            DECODE_NEW[1] + 1)))
        step()
        step()
    while dec.pending():
        step()
    head = rng.integers(0, vocab, DECODE_HEAD)
    for t in range(DECODE_TAILS):
        streams["tail%d" % t] = dec.submit(
            np.concatenate([head, rng.integers(0, vocab, DECODE_TAIL)]),
            max_new_tokens=DECODE_HEAD_NEW)
        if t == 0:  # the first fills the prefix cache
            while dec.pending():
                step()
    while dec.pending():
        step()
    clones = dec.pool.cow_clones
    streams["whole"] = dec.submit(head, max_new_tokens=DECODE_HEAD_NEW)
    while dec.pending():
        step()
    return streams, steps, appended, dec.pool.cow_clones - clones


def _decoder(mx, params, config, ctx, cuda_graph=True):
    pool = mx.serving.KVBlockPool(
        config["num_layers"], config["num_heads"],
        config["embed_dim"] // config["num_heads"], num_pages=DECODE_PAGES,
        page_size=DECODE_PAGE, ctx=ctx)
    dec = mx.serving.PagedTransformerDecoder(
        params, config, slot_count=DECODE_SLOTS, pool=pool)
    dec.cuda_graph = dec.cuda_graph and cuda_graph
    return dec


def _solo(mx, params, config, prompt, n_new):
    dec = _decoder(mx, params, config, mx.gpu(0))
    try:
        dec.warmup(verify=False)
        s = dec.submit(prompt, max_new_tokens=n_new)
        dec.drain()
        return s.outputs()
    finally:
        dec.close()


def _teacher_forced(mx, net, streams, ctx):
    """Each stream's generated-token logits from one full-sequence
    forward of the zoo net over prompt + generated tokens (zero-padded to
    the context; causal, so the padding is never seen)."""
    seq = GPT2S["seq_len"]
    tokens = np.zeros((len(streams), seq), np.float32)
    for i, s in enumerate(streams):
        hist = s.prompt + s.generated[:-1]
        tokens[i, :len(hist)] = hist
    logits = net(mx.nd.array(tokens, ctx=ctx)).asnumpy()
    return [logits[i, len(s.prompt) - 1:len(s.prompt) - 1
                   + len(s.generated)] for i, s in enumerate(streams)]


def paged_decode(mx, seed):
    """Phase 10a: paged-KV decode of the zoo TransformerLM at GPT-2
    small's widths.  Returns the main path's kernel launches."""
    import torch
    from mxnet_tpu_torch import executor_cache
    from mxnet_tpu_torch.models import transformer_lm_symbol
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.serving import metrics

    arrays = gpt2s_params(transformer_lm_symbol(**GPT2S), seed)
    net = gluon_net(mx, GPT2S["num_layers"], arrays, mx.gpu(0))
    params, config = net.decode_param_arrays(), net.config
    dec = _decoder(mx, params, config, mx.gpu(0))
    pool = dec.pool
    print("decode: pool of %d pages x %d tokens, page_bytes %d, %.3f GB; "
          "slot_count %d, window %d pages"
          % (pool.num_pages, pool.page_size, pool.page_bytes,
             pool.page_bytes * (pool.num_pages + 1) / 1e9, dec.slot_count,
             dec.max_pages))
    rng = np.random.default_rng(seed + 10)
    metrics.reset()
    try:
        report = dec.warmup()
        print("decode: warmup %d plan builds, %d capture (%.1f ms)"
              % (report["traces"], report["captures"],
                 dec.capture_seconds * 1e3))
        captures = dec.captures
        K.reset_launch_counts()
        torch.cuda.synchronize()
        with executor_cache.watch_traces() as w:
            t0 = time.perf_counter()
            streams, steps, appended, clones = decode_traffic(dec, rng)
            wall = time.perf_counter() - t0
        launches = K.launch_counts()
        if w.total() or dec.captures != captures:
            raise AssertionError("decode built %s plans and %d captures "
                                 "after warmup" % (w.delta(),
                                                   dec.captures - captures))
        generated = sum(len(s.generated) for s in streams.values())
        counters = metrics.snapshot()["counters"]
        stats = pool.stats()
        print("decode: %d streams, %d steps in %.2f s: %.1f generated "
              "tokens/s, %.1f appended tokens/s (%.2f ms a step); pages "
              "high water %d of %d, prefix hit pages %d, copy-on-write "
              "clones %d; card %s"
              % (len(streams), steps, wall, generated / wall,
                 appended / wall, wall / steps * 1e3,
                 stats["pages_high_water"], pool.num_pages,
                 counters.get("serving.decode.prefix_hits", 0),
                 stats["cow_clones"], card_line()))
        whole = streams["whole"]
        if whole.prefix_pages != DECODE_HEAD // DECODE_PAGE or clones != 1:
            raise AssertionError("the whole-head resubmission hit %d "
                                 "prefix pages and cloned %d"
                                 % (whole.prefix_pages, clones))
        hits = [streams["tail%d" % t].prefix_pages
                for t in range(1, DECODE_TAILS)]
        if hits != [DECODE_HEAD // DECODE_PAGE] * (DECODE_TAILS - 1):
            raise AssertionError("tail resubmissions hit %s pages" % hits)
        for s in streams.values():
            toks, logits = s.outputs()
            if len(toks) != s.max_new_tokens \
                    or not np.isfinite(logits).all():
                raise AssertionError("a stream ended short or non-finite")
        # one full step's time: the replay, the eager step, the logits copy
        tokens, positions, active, tables = dec._inputs()
        active[:] = True
        positions[:] = (2 * np.arange(DECODE_SLOTS) + 1) * dec.max_len \
            // (2 * DECODE_SLOTS)
        for i in range(DECODE_SLOTS):
            tables[i] = (np.arange(dec.max_pages) + i) % pool.num_pages + 1
        run = lambda: dec._run(tokens, positions, active, tables)  # noqa
        replay_ms = time_ms(run)
        eager = _decoder(mx, params, config, mx.gpu(0), cuda_graph=False)
        try:
            eager_ms = time_ms(
                lambda: eager._run(tokens, positions, active, tables))
        finally:
            eager.close()
        logits_dev = run()[1]
        copy_ms = time_ms(lambda: logits_dev.cpu())
        print("decode: one 8-slot step: replay %.3f ms, eager %.3f ms; the "
              "[%d, %d] logits to the host %.3f ms (%.2f MB, pageable)"
              % (replay_ms, eager_ms, DECODE_SLOTS, dec.vocab_size,
                 copy_ms, logits_dev.numel() * 4 / 1e6))
        profile_run(run, "decode: profiled replay")
        # co-batched == solo at the same slot count and pool geometry
        checked = [streams[k] for k in ("s0", "s%d" % (DECODE_STREAMS - 1),
                                        "tail2")][:DECODE_SOLO]
        for s in checked:
            toks, logits = _solo(mx, params, config, s.prompt,
                                 s.max_new_tokens)
            if toks != s.generated or not np.array_equal(
                    logits, s.outputs()[1]):
                raise AssertionError("a co-batched stream differs from its "
                                     "solo decode")
        print("decode: %d streams bit for bit their solo decodes (slot "
              "count %d)" % (len(checked), DECODE_SLOTS))
    finally:
        dec.close()
    # against the full-sequence forward of the zoo net, card and host
    host_net = gluon_net(mx, GPT2S["num_layers"], arrays, mx.cpu())
    for where, n in (("card", net), ("host", host_net)):
        t0 = time.perf_counter()
        want = _teacher_forced(mx, n, checked,
                               mx.gpu(0) if where == "card" else mx.cpu())
        err = max(float(np.abs(s.outputs()[1] - w).max())
                  for s, w in zip(checked, want))
        print("decode: logits vs the %s's full-sequence forward (%.1f s): "
              "max_abs_err %.3g (atol %g)"
              % (where, time.perf_counter() - t0, err, DECODE_FWD_TOL))
        if not err <= DECODE_FWD_TOL:
            raise AssertionError("decode logits disagree with the forward")
    replay_vs_eager(mx, params, config, seed)
    return launches


def replay_vs_eager(mx, params, config, seed):
    """The same traffic through a graph decoder and an eager one on the
    card: every token and logit bit for bit."""
    outs = []
    for graph in (True, False):
        rng = np.random.default_rng(seed + 11)
        dec = _decoder(mx, params, config, mx.gpu(0), cuda_graph=graph)
        try:
            dec.warmup()
            streams = [dec.submit(rng.integers(0, dec.vocab_size,
                                               int(rng.integers(16, 80))),
                                  max_new_tokens=16) for _ in range(10)]
            dec.drain()
            streams.append(dec.submit(streams[0].prompt[:32],
                                      max_new_tokens=8))  # a prefix hit
            dec.drain()
            outs.append([s.outputs() for s in streams])
            steps = dec.iterations
        finally:
            dec.close()
    same = all(a[0] == b[0] and np.array_equal(a[1], b[1])
               for a, b in zip(*outs))
    print("decode: graph replay vs eager step over the same %d iterations: "
          "%s" % (steps, "bit for bit" if same else "DIFFER"))
    if not same:
        raise AssertionError("the decode graph replay differs from eager")


def lstm_step_symbol(mx):
    """BASELINE config 4's LSTM LM as one decode step: a token, two
    LSTMCells with four states, the vocabulary projection."""
    data = mx.sym.Embedding(mx.sym.Variable("data"),
                            input_dim=CB_LM["vocab"],
                            output_dim=CB_LM["embed"], name="embed")
    states = []
    for i in range(2):
        cell = mx.rnn.LSTMCell(CB_LM["hidden"], prefix="lstm_l%d_" % i)
        data, (h, c) = cell(data, [mx.sym.Variable("l%d_h" % i),
                                   mx.sym.Variable("l%d_c" % i)])
        states += [h, c]
    logits = mx.sym.FullyConnected(data, num_hidden=CB_LM["vocab"],
                                   name="pred")
    return mx.sym.Group([logits] + states)


def continuous_lstm(mx, seed):
    """Phase 10b: the LSTM LM's decode through the continuous batcher.
    Returns the main path's kernel launches."""
    from mxnet_tpu_torch import executor_cache
    from mxnet_tpu_torch.ops import kernels as K
    step = lstm_step_symbol(mx)
    names = ["l0_h", "l0_c", "l1_h", "l1_c"]
    shapes, _, _ = step.infer_shape(data=(1,), **{
        n: (1, CB_LM["hidden"]) for n in names})
    rng = np.random.default_rng(seed + 20)
    params = {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
              for n, s in zip(step.list_arguments(), shapes)
              if n != "data" and n not in names}
    seqs = [rng.integers(0, CB_LM["vocab"], int(rng.integers(10, 41)))
            .astype(np.float32) for _ in range(CB_STREAMS)]

    def batcher(ctx):
        return mx.serving.ContinuousBatcher(
            step, params, input_shapes={"data": ()},
            state_shapes={n: (CB_LM["hidden"],) for n in names},
            state_pairs=[(n, i + 1) for i, n in enumerate(names)],
            slot_count=CB_SLOTS, ctx=ctx)

    cb = batcher(mx.gpu(0))
    cb.warmup()
    K.reset_launch_counts()
    with executor_cache.watch_traces() as w:
        t0 = time.perf_counter()
        streams = [cb.submit({"data": s}) for s in seqs[:CB_SLOTS]]
        for s in seqs[CB_SLOTS:]:
            cb.step()
            cb.step()
            streams.append(cb.submit({"data": s}))
        cb.drain()
        wall = time.perf_counter() - t0
    launches = K.launch_counts()
    cb.close()
    if w.total():
        raise AssertionError("the continuous batcher built %s plans after "
                             "warmup" % w.delta())
    tokens = sum(len(s) for s in seqs)
    print("continuous: %d streams of %d-%d tokens through %d slots: %d "
          "steps in %.2f s, %.1f steps/s, %.1f tokens/s; card %s"
          % (CB_STREAMS, min(map(len, seqs)), max(map(len, seqs)),
             CB_SLOTS, cb.iterations, wall, cb.iterations / wall,
             tokens / wall, card_line()))
    for i in range(CB_SOLO):
        solo = batcher(mx.gpu(0))
        solo.warmup()
        s = solo.submit({"data": seqs[i]})
        solo.drain()
        if not np.array_equal(s.outputs()[0], streams[i].outputs()[0]):
            raise AssertionError("a co-batched LSTM stream differs from its "
                                 "solo decode")
    host = batcher(mx.cpu())
    host.warmup()
    hs = [host.submit({"data": s}) for s in seqs[:CB_SOLO]]
    host.drain()
    err = max(float(np.abs(a.outputs()[0] - b.outputs()[0]).max())
              for a, b in zip(streams, hs))
    ok = all(np.allclose(a.outputs()[0], b.outputs()[0], **CB_HOST_TOL)
             for a, b in zip(streams, hs))
    print("continuous: %d streams bit for bit their solo decodes; card vs "
          "host max_abs_err %.3g (atol=rtol=%g) %s"
          % (CB_SOLO, err, CB_HOST_TOL["atol"], "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("continuous decode: card disagrees with host")
    return launches


def resnet_serving_params(mx, symbol, seed):
    """Seeded weights (numpy): He-normal convolutions, N(0, 0.01) for the
    classifier, unit BatchNorm gains, zero shifts; moving statistics 0
    and 1 (:func:`settle_bn` makes them the data's)."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(
        data=(1,) + _image_shape())
    rng = np.random.default_rng(seed)
    args, auxs = {}, {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            args[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            args[name] = np.zeros(shape, np.float32)
        elif len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            args[name] = (rng.standard_normal(shape, np.float32)
                          * np.float32(np.sqrt(2.0 / fan_in)))
        else:
            args[name] = rng.standard_normal(shape, np.float32) * 0.01
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        auxs[name] = (np.ones if name.endswith("_var") else np.zeros)(
            shape, np.float32)
    return args, auxs


def settle_bn(mx, symbol, args, auxs, batch):
    """Trained-like BatchNorm statistics: every moving mean and variance
    set to its layer's batch statistics over ``batch`` in one training
    forward with momentum 0, so inference normalizes each layer's input
    as training would (numpy in, numpy out; on the card)."""
    graph = json.loads(symbol.tojson())
    for node in graph["nodes"]:
        if node["op"] == "BatchNorm":
            node["attrs"]["momentum"] = "0.0"
    net = mx.sym.load_json(json.dumps(graph))
    exe = net.simple_bind(mx.gpu(0), grad_req="null", data=batch.shape)
    exe.copy_params_from(
        {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in args.items()},
        {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in auxs.items()})
    exe.forward(is_train=True, data=batch)
    return {k: exe.aux_dict[k].asnumpy() for k in auxs}


def int8_layer_witness(mx, symbol, args, auxs, calibration, x):
    """Per quantized layer, card against host at INT8_HOST_ROWS rows:
    (a) whether the card's own input to the layer equals the host's, and
    (b) the witness: the layer's op run on the card over the HOST's input,
    its int8 activations and output held to the host's.  An activation
    may differ only where the host's x/scale is an exact .5 tie; the
    outputs of rows without such a flip agree within INT8_LAYER_TOL."""
    import torch
    from mxnet_tpu_torch.ops import quantize as Q
    from mxnet_tpu_torch.ops.registry import get_op
    qsym, qargs, qauxs = Q.quantize_symbol(symbol, args, auxs,
                                           calibration=calibration)
    qnodes = [n for n in qsym._topo() if not n.is_var
              and n.op_name.startswith("_contrib_quantized")]
    names = {n.name + s for n in qnodes for s in ("_data", "_output")}
    seen = {}
    exes = {}
    for where, ctx in (("host", mx.cpu()), ("card", mx.gpu(0))):
        exe = qsym.simple_bind(ctx, grad_req="null", data=x.shape)
        exe.copy_params_from(qargs, qauxs, allow_extra_params=True)
        taps = seen.setdefault(where, {})

        def keep(name, arr, taps=taps):
            if name in names:
                taps[name] = arr.tensor.clone()
        exe.set_monitor_callback(keep, monitor_all=True)
        exe.forward(is_train=False, data=x)
        exe.set_monitor_callback(None)
        exes[where] = exe
    card = exes["card"]
    dev = mx.gpu(0).torch_device()
    same_inputs, first_diff, ties, err = 0, None, 0, 0.0
    for node in qnodes:
        x_host = seen["host"][node.name + "_data"]
        x_card = seen["card"][node.name + "_data"]
        if torch.equal(x_card.cpu(), x_host):
            same_inputs += 1
        elif first_diff is None:
            first_diff = (node.name, float(
                (x_card.cpu() - x_host).abs().max()))
        op = get_op(node.op_name)
        attrs = op.normalize_attrs(node.attrs, len(node.inputs))
        rest = [card.arg_dict[src.name].tensor for src, _ in node.inputs[1:]]
        with torch.inference_mode():
            y = op.impl(x_host.to(dev), *rest, **attrs).cpu()
            data = x_host.reshape(x_host.shape[0], -1) \
                if node.op_name == "_contrib_quantized_fc" else x_host
            q_host, s_host = Q.quantize_act(data, attrs["act_scale"])
            q_card, _ = Q.quantize_act(data.to(dev), attrs["act_scale"])
        flip = q_card.cpu() != q_host
        frac = torch.abs(data / s_host) % 1.0
        if bool((flip & (frac != 0.5)).any()):
            raise AssertionError("int8 activations of %s differ from the "
                                 "host's away from a .5 tie" % node.name)
        ties += int(flip.sum())
        rows = ~flip.reshape(flip.shape[0], -1).any(1)
        want = seen["host"][node.name + "_output"]
        err = max(err, float((y[rows] - want[rows]).abs().max())
                  if bool(rows.any()) else 0.0)
        if not torch.allclose(y[rows], want[rows], atol=INT8_LAYER_TOL,
                              rtol=INT8_LAYER_TOL):
            raise AssertionError("%s on the card over the host's input "
                                 "disagrees with the host" % node.name)
    print("int8: %s per-layer witness, %d quantized layers at %d rows: on "
          "the host's input the card's int8 activations flip at %d exact "
          ".5 ties and none elsewhere, outputs max_abs_err %.3g (tol %g); "
          "the card's own input equals the host's at %d of %d layers%s"
          % ("calibrated" if calibration else "dynamic", len(qnodes),
             x.shape[0], ties, err, INT8_LAYER_TOL, same_inputs,
             len(qnodes), "" if first_diff is None else
             " (first difference at %s, max abs %.3g)" % first_diff))


def int8_accumulators_check(mx, qsym, seed):
    """Every distinct quantized convolution of the served graph and its
    FC at bucket INT8_MAX_BATCH: the cuBLAS route's int32 accumulators
    against the plain version's on the same (random, full-range) int8
    operands."""
    import torch
    from mxnet_tpu_torch.base import str_to_attr
    from mxnet_tpu_torch.ops import quantize as Q
    shapes, _ = qsym._infer({"data": (INT8_MAX_BATCH,) + _image_shape()},
                            {})
    cases = {}
    for node in qsym._topo():
        if node.is_var or not node.op_name.startswith("_contrib_quantized"):
            continue
        geometry = tuple(str_to_attr(node.attrs[k]) if k in node.attrs
                         else None for k in ("stride", "pad", "dilate"))
        key = (node.op_name, shapes[node.inputs[0]],
               shapes[node.inputs[1]], geometry,
               int(node.attrs.get("num_group", 1)))
        cases.setdefault(key, node.name)
    dev = mx.gpu(0).torch_device()
    g = torch.Generator(device=dev).manual_seed(seed)
    counts = {"_contrib_quantized_conv": 0, "_contrib_quantized_fc": 0}
    for (op, dshape, wshape, geometry, groups), name in cases.items():
        x = torch.randint(-127, 128, dshape, generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, wshape, generator=g, device=dev,
                          dtype=torch.int8)
        if op == "_contrib_quantized_fc":
            x = x.reshape(dshape[0], -1)
            got, want = Q.int8_matmul(x, w), Q.plain_int8_matmul(x, w)
        else:
            got = Q.int8_conv(x, w, *geometry, groups)
            want = Q.plain_int8_conv(x, w, *geometry, groups)
        counts[op] += 1
        if not torch.equal(got, want):
            raise AssertionError("int8 accumulators of %s (%s) differ from "
                                 "the plain version" % (name, op))
    print("int8: the _int_mm route's int32 accumulators bit for bit the "
          "plain version's at %d distinct convolution shapes and %d FC, "
          "batch %d" % (counts["_contrib_quantized_conv"],
                        counts["_contrib_quantized_fc"], INT8_MAX_BATCH))


def int8_serve(mx, seed):
    """Phase 10c: int8 ResNet-50 v2 through ``Server.add_model(quantize=
    "int8")``, dynamic and calibrated.  Returns (main path launches,
    symbol, args, auxs)."""
    import torch
    from mxnet_tpu_torch import executor_cache
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.ops import quantize as Q

    # the logits: the graph below SoftmaxOutput (whose probabilities
    # saturate at these random weights)
    symbol = resnet.get_symbol(**RESNET).get_children()[0]
    args_np, auxs_np = resnet_serving_params(mx, symbol, seed + 30)
    rng = np.random.default_rng(seed + 31)
    feat = _image_shape()
    images = rng.standard_normal((INT8_MAX_BATCH,) + feat, np.float32)
    cal = [{"data": rng.standard_normal((INT8_MAX_BATCH,) + feat,
                                        np.float32)}
           for _ in range(INT8_CAL_BATCHES)]
    auxs_np = settle_bn(mx, symbol, args_np, auxs_np, cal[0]["data"])
    args, auxs = (mx.convert.params_from_numpy(d, mx.cpu())[0]
                  for d in (args_np, auxs_np))
    t0 = time.perf_counter()
    table = Q.calibrate(symbol, args, auxs,
                        {"data": (INT8_MAX_BATCH,) + feat}, cal)
    print("int8: calibrated %d layers over %d batches of %d in %.2f s"
          % (len(table), INT8_CAL_BATCHES, INT8_MAX_BATCH,
             time.perf_counter() - t0))
    server = mx.serving.Server(max_batch_size=INT8_MAX_BATCH)
    K.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        server.add_model("r50q8", symbol, args, auxs,
                         input_shapes={"data": feat}, quantize="int8")
        server.add_model("r50q8cal", symbol, args, auxs,
                         input_shapes={"data": feat}, quantize="int8",
                         calibration=table)
        server.add_model("r50f32", symbol, args, auxs,
                         input_shapes={"data": feat})
        report = server.warmup()
        print("int8: add_model x3 + warmup %.1f s, buckets %s, verify pass "
              "plan builds %s" % (time.perf_counter() - t0,
                                  report["r50q8"]["buckets"],
                                  {k: v["traces_verify_pass"]
                                   for k, v in report.items()}))
        rows = [1, 3, 8, 16, 32, 5]
        with executor_cache.watch_traces() as w:
            t0 = time.perf_counter()
            futs = {m: [server.submit_async(m, {"data": images[:r]})
                        for r in rows] for m in ("r50q8", "r50q8cal")}
            outs = {m: [f.result(timeout=600)[0] for f in fs]
                    for m, fs in futs.items()}
            wall = time.perf_counter() - t0
        launches = K.launch_counts()
        if w.total():
            raise AssertionError("int8 serving built %s plans after warmup"
                                 % w.delta())
        print("int8: served %d images across buckets 1-%d (both models) in "
              "%.2f s, %.1f images/s; card %s"
              % (2 * sum(rows), INT8_MAX_BATCH, wall, 2 * sum(rows) / wall,
                 card_line()))
        per_bucket = []
        for b in server.registry.get("r50q8").buckets:
            x = images[:b]
            per_bucket.append((b,) + tuple(
                time_ms(lambda p=server.registry.get(m).predictor_for(b):
                        p.forward(data=x), reps=5, warmup=1)
                for m in ("r50q8", "r50f32")))
        print("int8: ms per bucket forward, int8 / f32 (CUDA events, "
              "input upload included): %s; bucket %d int8 %.1f images/s, "
              "f32 %.1f" % ("; ".join("%d: %.2f / %.2f" % t
                                      for t in per_bucket),
                            INT8_MAX_BATCH,
                            INT8_MAX_BATCH / per_bucket[-1][1] * 1e3,
                            INT8_MAX_BATCH / per_bucket[-1][2] * 1e3))
        f32 = server.submit("r50f32", {"data": images})[0]
        for m in ("r50q8", "r50q8cal"):
            q8 = server.submit(m, {"data": images})[0]
            print("int8: %s vs the f32 model on the card: max deviation "
                  "%.4g, relative L2 %.4g, top-1 agreement %.4f"
                  % (m, float(np.abs(q8 - f32).max()), _rel_l2(q8, f32),
                     float(np.mean(q8.argmax(1) == f32.argmax(1)))))
    finally:
        server.close()
    qsym, _, _ = Q.quantize_symbol(symbol, args, auxs)
    int8_accumulators_check(mx, qsym, seed)
    blob = dict({"arg:" + k: v for k, v in args.items()},
                **{"aux:" + k: v for k, v in auxs.items()})
    x = images[:INT8_HOST_ROWS]
    for name, cal in (("r50q8", None), ("r50q8cal", table)):
        host = mx.Predictor(symbol.tojson(), blob,
                            {"data": (INT8_HOST_ROWS,) + feat},
                            ctx=mx.cpu(), quantize="int8", calibration=cal)
        t0 = time.perf_counter()
        host.forward(data=x)
        want = host.get_output(0).asnumpy()
        got = outs[name][1][:INT8_HOST_ROWS]
        print("int8: %s, %d served rows vs the port's int8 on the host "
              "(%.1f s): relative L2 %.4g (limit %g), max abs %.4g; the "
              "same rows int8 vs f32 on the card: relative L2 %.4g"
              % (name, INT8_HOST_ROWS, time.perf_counter() - t0,
                 _rel_l2(got, want), INT8_HOST_REL,
                 float(np.abs(got - want).max()),
                 _rel_l2(got, f32[:INT8_HOST_ROWS])))
        int8_layer_witness(mx, symbol, args, auxs, cal, x)
        if not _rel_l2(got, want) <= INT8_HOST_REL:
            raise AssertionError("int8 logits: card disagrees with host")
    return launches, symbol, args, auxs


def int8_fleet(mx, symbol, args, auxs, seed):
    """Phase 10d: the int8 model behind a 2-replica fleet on the card.
    Returns the main path's kernel launches."""
    from mxnet_tpu_torch.ops import kernels as K
    feat = _image_shape()
    rng = np.random.default_rng(seed + 40)
    fleet = mx.serving.FleetServer(ctxs=[mx.gpu(0), mx.gpu(0)],
                                   max_batch_size=FLEET_MAX_BATCH)
    try:
        fleet.add_model("r50q8", symbol, args, auxs,
                        input_shapes={"data": feat}, quantize="int8")
        report = fleet.warmup()
        costs = [report["r50q8"]["per_replica"][r.index]["bucket_cost_ms"]
                 for r in fleet.group.replicas]
        for r in fleet.group.replicas:
            for b in fleet.registry.get("r50q8").buckets:
                if not r.bucket_cost_ms.get(("r50q8", b), 0.0) > 0.0:
                    raise AssertionError("replica %d bucket %d cost not "
                                         "measured" % (r.index, b))
        print("fleet: bucket costs measured at warmup (ms): %s" % costs)
        payloads = [rng.standard_normal(
            (int(rng.integers(1, FLEET_MAX_BATCH + 1)),) + feat, np.float32)
                    for _ in range(FLEET_REQUESTS)]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [fleet.submit_async("r50q8", {"data": p}) for p in payloads]
        outs = [f.result(timeout=600)[0] for f in futs]
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        stats = fleet.group.stats()
    finally:
        fleet.close()
    if not all(s["dispatches"] > 0 for s in stats):
        raise AssertionError("a replica was never dispatched: %s" % stats)
    blob = dict({"arg:" + k: v for k, v in args.items()},
                **{"aux:" + k: v for k, v in auxs.items()})
    oracles = {}
    for p, f, o in zip(payloads, futs, outs):
        b = f.request.dispatch_bucket
        if b not in oracles:
            oracles[b] = mx.Predictor(symbol.tojson(), blob,
                                      {"data": (b,) + feat},
                                      quantize="int8")
        solo = np.zeros((b,) + feat, np.float32)
        solo[:len(p)] = p
        oracles[b].forward(data=solo)
        if not np.array_equal(o, oracles[b].get_output(0).asnumpy()[
                :len(p)]):
            raise AssertionError("a fleet response differs from the "
                                 "serverless replay of its bucket")
    print("fleet: %d requests (%d images) in %.2f s over 2 replicas "
          "(dispatches %s), every response bit for bit a serverless replay "
          "of its dispatch bucket; card %s"
          % (len(payloads), sum(len(p) for p in payloads), wall,
             [s["dispatches"] for s in stats], card_line()))
    return launches


def http_checkpoint(mx, symbol, args, auxs, seed):
    """Phase 10e: a checkpoint written by ``save_checkpoint``, served by
    ``load_model`` over the loopback HTTP front end.  Returns the main
    path's kernel launches."""
    import tempfile
    from urllib import request as urlreq
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.serving import metrics
    feat = _image_shape()
    image = np.random.default_rng(seed + 50).standard_normal(
        (1,) + feat, np.float32)
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        prefix = os.path.join(tmp, "r50")
        mx.model.save_checkpoint(prefix, 1, symbol, args, auxs)
        server = mx.serving.Server(max_batch_size=1, serve_http=True)
        metrics.reset()
        K.reset_launch_counts()
        try:
            server.load_model("r50", prefix, 1, {"data": feat},
                              quantize="int8")
            server.warmup()
            base = "http://%s:%d" % server.http_address
            want = server.submit("r50", {"data": image})[0]
            body = json.dumps({"inputs": {"data": image.tolist()}}).encode()
            for route in ("/v1/models/r50:predict", "/predict/r50"):
                req = urlreq.Request(base + route, data=body, headers={
                    "Content-Type": "application/json"})
                with urlreq.urlopen(req, timeout=120) as r:
                    got = np.asarray(json.loads(r.read())["outputs"][0],
                                     np.float32)
                if not np.array_equal(got, want):
                    raise AssertionError("HTTP %s differs from submit"
                                         % route)
            with urlreq.urlopen(base + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            with urlreq.urlopen(base + "/metrics", timeout=30) as r:
                prom = r.read().decode()
            launches = K.launch_counts()
        finally:
            server.close()
    if health["models"] != ["r50"] \
            or "serving_requests_total 3" not in prom:
        raise AssertionError("healthz/metrics: %s / %r"
                             % (health, prom[:200]))
    print("http: load_model of a save_checkpoint checkpoint; POST under "
          "both routes equals submit bit for bit; /healthz %s; /metrics "
          "%d lines" % (health, len(prom.splitlines())))
    return launches


def serve_rest(mx, seed):
    """Phase 10: the rest of serving.  Returns {path: launches}."""
    clock = time.perf_counter()
    paths = {"paged_decode": paged_decode(mx, seed)}
    paths["continuous_lstm"] = continuous_lstm(mx, seed)
    paths["int8_serve"], symbol, args, auxs = int8_serve(mx, seed)
    paths["int8_fleet"] = int8_fleet(mx, symbol, args, auxs, seed)
    paths["http_checkpoint"] = http_checkpoint(mx, symbol, args, auxs, seed)
    print("phase 10 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths


# -- phase 11: BASELINE config 1 (LeNet on MNIST through Module), the MLP,
# check_consistency, the symbol zoo ------------------------------------------

# the settings of examples/image-classification/train_mnist.py:35-36 and
# common/fit.py:21-27: batch 64, lr 0.05, SGD momentum 0.9, wd 1e-4, the
# lr down 10x after epoch 10; Xavier (gaussian, in, 2) (fit.py:127).  One
# epoch here, where the example runs 10.
MNIST_SIZES = {"train": 60000, "t10k": 10000}
MNIST_BATCH = 64
MNIST_EPOCHS = 1
MNIST_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
# the data's rule (a class per stroke template, shifted and noised) is
# one a LeNet learns in an epoch: train accuracy at least this, where
# chance is 0.1
MNIST_MIN_TRAIN_ACC = 0.9
LENET_POOLS = ((64, 20, 24, 24), (64, 50, 8, 8))  # its 2x2/s2 max pools
LENET_HOST_STEPS = 3
LENET_OUT_REL = 1e-4   # PERF.md section 2: LMs and RNNs vs host
LENET_GRAD_REL = 1e-3
CONSISTENCY_TOL = 1e-4  # check_consistency, card against host, f32
ZOO_BATCH = 2
ZOO_REL = 2e-3  # the served-logits limit of PERF.md section 2
ZOO_INPUTS = {  # builder -> (input shape, builder kwargs), 1000 classes
    "lenet": ((1, 28, 28), {}),
    "mlp": ((1, 28, 28), {}),
    "alexnet": ((3, 224, 224), {}),
    "vgg": ((3, 224, 224), {"num_layers": 16}),
    "googlenet": ((3, 224, 224), {}),
    "inception_bn": ((3, 224, 224), {}),
    "inception_v3": ((3, 299, 299), {}),
    "inception_v4": ((3, 299, 299), {}),
    "inception_resnet_v2": ((3, 299, 299), {}),
    "resnet_v1": ((3, 224, 224), {"num_layers": 50,
                                  "image_shape": "3,224,224"}),
    "resnext": ((3, 224, 224), {"num_layers": 50,
                                "image_shape": "3,224,224"}),
    "mobilenet": ((3, 224, 224), {}),
}


def mnist_templates(rng):
    """Ten 28x28 class templates, each three blurred strokes."""
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    t = np.linspace(0.0, 1.0, 32, dtype=np.float32)[:, None, None]
    out = np.zeros((10, 28, 28), np.float32)
    for c in range(10):
        for _ in range(3):
            (y0, x0), (y1, x1) = rng.uniform(5, 23, (2, 2))
            py, px = y0 + (y1 - y0) * t, x0 + (x1 - x0) * t
            d2 = (yy - py) ** 2 + (xx - px) ** 2
            out[c] = np.maximum(out[c], np.exp(-d2 / 2.0).max(axis=0))
    return out


def write_mnist(root, seed, sizes=MNIST_SIZES):
    """11a. MNIST-format idx-ubyte files under ``root``: per split, uint8
    images of a class's template shifted by up to 2 pixels each way,
    scaled and noised, and their labels.  Returns the file paths."""
    import struct
    rng = np.random.default_rng(seed + 40)
    templates = mnist_templates(rng)
    paths = {}
    for split, n in sizes.items():
        labels = rng.integers(0, 10, n)
        shifts = rng.integers(-2, 3, (n, 2))
        images = np.empty((n, 28, 28), np.float32)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                rows = np.flatnonzero((shifts[:, 0] == dy)
                                      & (shifts[:, 1] == dx))
                images[rows] = np.roll(templates, (dy, dx),
                                       axis=(1, 2))[labels[rows]]
        images *= rng.uniform(0.6, 1.0, (n, 1, 1)).astype(np.float32)
        images += rng.normal(0.0, 0.2, images.shape).astype(np.float32)
        pixels = (np.clip(images, 0.0, 1.0) * 255).astype(np.uint8)
        paths[split] = (os.path.join(root, "%s-images-idx3-ubyte" % split),
                        os.path.join(root, "%s-labels-idx1-ubyte" % split))
        with open(paths[split][0], "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(pixels.tobytes())
        with open(paths[split][1], "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(labels.astype(np.uint8).tobytes())
    return paths


def mnist_iter(mx, paths, split, flat, seed=0):
    image, label = paths[split]
    return mx.io.MNISTIter(image=image, label=label, batch_size=MNIST_BATCH,
                           shuffle=split == "train", flat=flat, seed=seed)


def mnist_optimizer(mx):
    steps = MNIST_SIZES["train"] // MNIST_BATCH * 10
    return dict(MNIST_SGD, lr_scheduler=mx.lr_scheduler.MultiFactorScheduler(
        step=[steps], factor=0.1))


def check_lenet_pools(seed):
    """Phase 2d: ``max_pool_backward`` at LeNet's two 2x2/s2 pools (phase
    11's main path; post-tanh inputs, f32) against its plain version, bit
    for bit, timed (one call, 20 back to back, device only) beside its
    bytes bound (x + dy + dx at the card's memory rate) and the aten
    backward.  Timed here, early: late in the process torch.profiler
    loses kernel records.  Returns ([], [(kernel, instance)])."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    aten = torch.ops.aten
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    out = []
    for label, shape in zip(("lenet-pool1", "lenet-pool2"), LENET_POOLS):
        x = torch.tanh(torch.randn(*shape, generator=gen, device=dev))
        dy = torch.randn(shape[:2] + (shape[2] // 2, shape[3] // 2),
                         generator=gen, device=dev)
        pads = ((0, 0), (0, 0))
        run = lambda: K.max_pool_backward(x, dy, (2, 2), (2, 2), pads)  # noqa: E731
        plain = lambda: K._plain_max_pool_backward(  # noqa: E731
            x, dy, (2, 2), (2, 2), pads)
        _, idx = aten.max_pool2d_with_indices(x, (2, 2), (2, 2), (0, 0))
        lib = lambda: aten.max_pool2d_with_indices_backward(  # noqa: E731
            dy, x, (2, 2), (2, 2), (0, 0), (1, 1), False, idx)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        exact = bool(torch.equal(got, want))
        print("kernel max_pool_backward %s %s f32 2x2/s2: max_abs_err %.3g "
              "(bit for bit: %s) %s" % (label, "x".join(map(str, shape)),
                                        err, exact, "ok" if exact
                                        else "FAIL"))
        if not exact:
            raise AssertionError("max_pool_backward disagrees with its "
                                 "plain version at %s" % label)
        ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(lib)
        bound = bytes_bound(_nbytes(x, dy) + x.numel() * x.element_size())
        _report("kernel max_pool_backward %s" % label, ms, plain_ms, lib_ms,
                bound)
        b2b = time_ms_back_to_back(run)
        print("kernel max_pool_backward %s, 20 calls back to back: %.4f ms a "
              "call (%.1f%% of the bound), library %.4f ms; device only: "
              "kernel %s, library %s"
              % (label, b2b, 100.0 * bound[0] / b2b,
                 time_ms_back_to_back(lib),
                 _device_text(device_ms_per_call(run)),
                 _device_text(device_ms_per_call(lib))))
        out.append(("max_pool_backward",
                    _instance(label, err, ms, plain_ms, bound, lib_ms)))
    return [], out


def fit_mnist(mx, seed, paths, symbol, flat, tag):
    """11b/c. ``MNISTIter`` -> ``Module(context=gpu(0)).fit`` for an epoch
    at the example's settings; the checks and numbers of the fit.
    Returns (module, the fit's kernel launches, initial parameters)."""
    import torch
    from mxnet_tpu_torch.module.fused_step import FusedTrainStep, WARMUP_STEPS
    from mxnet_tpu_torch.ops import kernels as K
    per_step = expected_train_launches(symbol)
    train, val = (mnist_iter(mx, paths, s, flat, seed)
                  for s in ("train", "t10k"))
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    mod.bind(train.provide_data, train.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    arg0, aux0 = ({k: v.asnumpy().copy() for k, v in t.items()}
                  for t in mod.get_params())
    step_ms, step_launches, marks = [], [], {}

    def on_batch(param):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), K.launch_counts()
        step_ms.append((now - marks["t"]) * 1e3)
        step_launches.append({k: counts[k] - marks["counts"][k]
                              for k in per_step})
        marks["t"], marks["counts"] = now, counts

    torch.cuda.synchronize()
    K.reset_launch_counts()
    marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()
    t0 = time.perf_counter()
    mod.fit(train, num_epoch=MNIST_EPOCHS, eval_metric="acc",
            optimizer="sgd", optimizer_params=mnist_optimizer(mx),
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = K.launch_counts()
    n = len(step_ms)
    fs = mod._fused_step
    why = FusedTrainStep.refusal(mod) if fs is None else None
    ms = float(np.median(step_ms[WARMUP_STEPS + 1:]))
    print("%s: fit of %d epoch x %d batches of %d in %.2f s; ms per step "
          "(synchronized, median after the capture) %.3f, %.1f images/s; "
          "the fused step (one CUDA graph) carried the fit: %s%s; launches "
          "per step %s (all %d steps alike: %s), in all %s; card %s"
          % (tag, MNIST_EPOCHS, n, MNIST_BATCH, fit_s, ms,
             MNIST_BATCH / ms * 1e3, fs is not None and fs.captures == 1,
             "" if fs is not None else " (refused: %s)" % why,
             step_launches[-1], n, all(d == per_step for d in step_launches),
             {k: launches[k] for k in per_step}, card_line()))
    if fs is None or fs.captures != 1 or fs.replays != n - WARMUP_STEPS:
        raise AssertionError("%s: the fit did not run as one captured CUDA "
                             "graph a step (%s)" % (tag, why))
    off = [d for d in step_launches if d != per_step]
    if n != -(-MNIST_SIZES["train"] // MNIST_BATCH) or off \
            or {k: fs.graph_launches.get(k, 0) for k in per_step} \
            != per_step:
        raise AssertionError("%s: %d steps, %d with launches other than %s "
                             "(%s)" % (tag, n, len(off), per_step, off[:3]))
    train_acc = dict(mod.score(mnist_iter(mx, paths, "train", flat),
                               "acc"))["accuracy"]
    test_acc = dict(mod.score(val, "acc"))["accuracy"]
    train.reset()
    batch = next(train)
    graph_ms = time_steps(mod, batch)
    print("%s: after the epoch train accuracy %.4f (at least %.2f; chance "
          "0.1), score on the test file %.4f; a replayed step on one batch "
          "%.3f ms (median of %d after warm-up), %.1f images/s; card %s"
          % (tag, train_acc, MNIST_MIN_TRAIN_ACC, test_acc, graph_ms,
             TIMED_STEPS, MNIST_BATCH / graph_ms * 1e3, card_line()))
    if not train_acc >= MNIST_MIN_TRAIN_ACC or not np.isfinite(test_acc):
        raise AssertionError("%s: train accuracy %.4f below %.2f"
                             % (tag, train_acc, MNIST_MIN_TRAIN_ACC))
    return mod, launches, (arg0, aux0)


def lenet_profile_apart(seed):
    """Runs ``lenet_profile_child`` in a process of its own (as phase 6
    does: late in this process torch.profiler loses kernel records) and
    passes its lines on; raises when it fails."""
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--lenet-profile"], capture_output=True, text=True, timeout=600)
    sys.stdout.write(child.stdout)
    if child.returncode != 0:
        sys.stdout.write(child.stderr[-4000:])
        raise AssertionError("the profiled LeNet step failed (exit %d)"
                             % child.returncode)


def lenet_profile_child(mx, seed):
    """``--lenet-profile``: LeNet through ``Module`` on the card at the fit's
    settings, on random MNIST-shaped batches: the eager step, the
    capture, then one replay under torch.profiler; its max-pool backward
    device launches must equal the 2 the graph implies."""
    import torch
    from mxnet_tpu_torch.models import lenet
    from mxnet_tpu_torch.ops import kernels as K
    symbol = lenet.get_symbol(10)
    per_step = expected_train_launches(symbol)
    rng = np.random.default_rng(seed + 42)
    it = mx.io.NDArrayIter(
        rng.random((MNIST_BATCH, 1, 28, 28), dtype=np.float32),
        rng.integers(0, 10, MNIST_BATCH).astype(np.float32),
        batch_size=MNIST_BATCH)
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    mod.init_optimizer(optimizer_params=mnist_optimizer(mx))
    batch = next(it)
    for _ in range(3):
        mod.forward_backward(batch)
        mod.update()
    before = K.launch_counts()
    table = profile_run(lambda: (mod.forward_backward(batch), mod.update()),
                        "lenet replay")
    calls = {k: K.launch_counts()[k] - before[k] for k in per_step}
    if mod._fused_step is None or mod._fused_step.replays < 2 \
            or calls != per_step:
        raise AssertionError("the profiled LeNet step was not a replay of "
                             "%s launches: %s" % (per_step, calls))
    if table is None:
        return 0
    rows = {k: v for k, v in table.items() if "max_pool_bwd_band_kernel" in k}
    n = sum(v[1] for v in rows.values())
    print("lenet: the profiled replay's max_pool_backward: %d device "
          "launches (%.4f ms), %d counted; card %s"
          % (n, sum(v[0] for v in rows.values()),
             calls["max_pool_backward"], card_line()))
    if n != calls["max_pool_backward"]:
        raise AssertionError("the replay's max_pool_backward device launches "
                             "%d, expected %d" % (n, calls["max_pool_backward"]))
    return 0


def lenet_host_check(mx, seed, paths, symbol, arg0, aux0):
    """11d. LeNet's first steps from the fit's initial weights on the
    fit's first batches, on the card (the fused step: eager, capture,
    replay) and through the port on the host: each step's outputs within
    LENET_OUT_REL and each parameter's gradient within LENET_GRAD_REL,
    relative L2.  The gradient is read off the step's momentum update
    (``mom = 0.9 mom - lr (g + wd w)``)."""
    runs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        it = mnist_iter(mx, paths, "train", False, seed)
        mod = mx.mod.Module(symbol, context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in arg0.items()},
                        aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in aux0.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=mnist_optimizer(mx))
        steps = []
        for _ in range(LENET_HOST_STEPS):
            before = fused_state(mod)
            mod.forward_backward(next(it))
            mod.update()
            after = fused_state(mod)
            grads = {
                k: ((MNIST_SGD["momentum"] * before[k][1] - after[k][1])
                    / MNIST_SGD["learning_rate"]
                    - MNIST_SGD["wd"] * before[k][0]).numpy()
                for k in after}
            steps.append((mod.get_outputs()[0].asnumpy(), grads))
        runs.append(steps)
    worst_out, worst_grad = 0.0, (0.0, "")
    for (out_c, g_c), (out_h, g_h) in zip(*runs):
        worst_out = max(worst_out, _rel_l2(out_c, out_h))
        for k in g_h:
            worst_grad = max(worst_grad, (_rel_l2(g_c[k], g_h[k]), k))
    print("lenet: %d steps card vs host from the same weights and batches: "
          "outputs relative L2 largest %.3g (limit %g); gradients relative "
          "L2 largest %.3g (%s; limit %g); card %s"
          % (LENET_HOST_STEPS, worst_out, LENET_OUT_REL, worst_grad[0],
             worst_grad[1], LENET_GRAD_REL, card_line()))
    if not (worst_out <= LENET_OUT_REL and worst_grad[0] <= LENET_GRAD_REL):
        raise AssertionError("LeNet's steps on the card disagree with the "
                             "host's")


def _signed_values(rng, *shape):
    v = rng.uniform(-2.0, 2.0, shape)
    return np.where(np.abs(v) < 0.1, 0.3, v).astype(np.float32)


def consistency_graphs(mx, rng):
    """{name: (symbol, {input: values})}: one small graph per operator of
    ``==``, ``!=``, ``**``, ``%`` and per op behind each of the 29 fluent
    methods of ``NDArray``."""
    s = mx.sym
    a, b, c, e = s.var("a"), s.var("b"), s.var("c"), s.var("e")
    p, i = s.var("p"), s.var("i")
    va = _signed_values(rng, 3, 4)
    vb = np.where(rng.random((3, 4)) < 0.5, va,
                  _signed_values(rng, 3, 4)).astype(np.float32)
    vp = rng.uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    ve = _signed_values(rng, 2, 3, 4)
    vc = _signed_values(rng, 4, 2)
    vi = np.array([2, 0, 1], np.float32)
    ab, ap, a_ = {"a": va, "b": vb}, {"a": va, "p": vp}, {"a": va}
    return {
        "==": (a == b, ab), "!=": (a != b, ab),
        "**": (p ** a, ap), "%": (s.broadcast_mod(p * 5.0, s.abs(a)), ap),
        "transpose": (s.transpose(e, axes=(2, 0, 1)), {"e": ve}),
        "abs": (s.abs(a), a_), "argmax": (s.argmax(a, axis=1), a_),
        "argmin": (s.argmin(a, axis=0), a_),
        "broadcast_to": (s.broadcast_to(s.slice_axis(a, axis=1, begin=0,
                                                     end=1), shape=(3, 4)),
                         a_),
        "clip": (s.clip(a, a_min=-0.7, a_max=0.9), a_),
        "dot": (s.dot(a, c), {"a": va, "c": vc}),
        "exp": (s.exp(a), a_), "expand_dims": (s.expand_dims(a, axis=1), a_),
        "flatten": (s.Flatten(e), {"e": ve}),
        "flip": (s.reverse(a, axis=1), a_), "log": (s.log(p), {"p": vp}),
        "max": (s.max(a, axis=1), a_), "min": (s.min(a, axis=0), a_),
        "one_hot": (s.one_hot(i, depth=4), {"i": vi}),
        "relu": (s.relu(a), a_), "round": (s.rint(a * 3.0), a_),
        "sigmoid": (s.sigmoid(a), a_), "sign": (s.sign(a), a_),
        "slice": (s.slice(a, begin=(1, 0), end=(3, 4)), a_),
        "slice_axis": (s.slice_axis(a, axis=1, begin=1, end=3), a_),
        "softmax": (s.softmax(a), a_),
        "split": (s.split(a, num_outputs=2, axis=1), a_),
        "sqrt": (s.sqrt(p), {"p": vp}), "square": (s.square(a), a_),
        "swapaxes": (s.SwapAxis(e, dim1=0, dim2=2), {"e": ve}),
        "take": (s.take(a, i), {"a": va, "i": vi}),
        "tanh": (s.tanh(a), a_), "tile": (s.tile(a, reps=(2, 3)), a_),
    }


def consistency_checks(mx, seed):
    """11e. ``mx.test_utils.check_consistency`` over [cpu(), gpu(0)]: the
    LeNet and MLP graphs at the fit's batch (random weights, as the
    reference draws them), and one small graph per operator and fluent
    method, within CONSISTENCY_TOL."""
    from mxnet_tpu_torch.models import lenet, mlp
    rng = np.random.default_rng(seed + 43)
    graphs = {
        "lenet": (lenet.get_symbol(10), None),
        "mlp": (mlp.get_symbol(10), None)}
    graphs.update(consistency_graphs(mx, rng))
    for name, (sym, values) in graphs.items():
        shapes = {"data": (MNIST_BATCH, 1, 28, 28)} if values is None \
            else {k: v.shape for k, v in values.items()}
        ctx_list = [dict(shapes, ctx=ctx) for ctx in (mx.cpu(), mx.gpu(0))]
        np.random.seed(seed + 44)
        mx.test_utils.check_consistency(
            sym, ctx_list, arg_params=dict(values) if values else None,
            tol=CONSISTENCY_TOL)
    print("consistency: check_consistency over [cpu(0), gpu(0)] passed for "
          "%d graphs (LeNet, the MLP, ==, !=, **, %% and the 29 fluent "
          "methods' ops) within %g; card %s"
          % (len(graphs), CONSISTENCY_TOL, card_line()))
    if len(graphs) != 2 + 4 + 29:
        raise AssertionError("%d consistency graphs" % len(graphs))


def zoo_weights(symbol, data_shape, seed):
    """He-normal weights, BatchNorm gamma/beta and moving statistics drawn
    away from 1 and 0, all from ``seed``: {"arg:"/"aux:" name: array}."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=data_shape)
    out = {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            v = 1.0 + 0.1 * rng.standard_normal(s, np.float32)
        elif n.endswith(("_beta", "_bias")):
            v = 0.1 * rng.standard_normal(s, np.float32)
        else:
            v = rng.standard_normal(s, np.float32) \
                * np.float32(np.sqrt(2.0 / np.prod(s[1:])))
        out["arg:" + n] = v
    for n, s in zip(symbol.list_auxiliary_states(), aux_shapes):
        out["aux:" + n] = (0.5 + rng.random(s, np.float32)) \
            if n.endswith("_var") else 0.1 * rng.standard_normal(s,
                                                                np.float32)
    return out


def zoo_forwards(mx, seed):
    """11f. Each builder of the symbol zoo: one inference forward of its
    logits (the graph below ``SoftmaxOutput``) at batch 2, at its input
    size, 1000 classes, on the card, timed, against the same forward
    through the port on the host (relative L2 within ZOO_REL)."""
    from mxnet_tpu_torch import models
    for k, (name, (shape, kwargs)) in enumerate(ZOO_INPUTS.items()):
        symbol = getattr(models, name).get_symbol(num_classes=1000, **kwargs)
        logits = symbol.get_children()[0]
        data_shape = (ZOO_BATCH,) + shape
        weights = zoo_weights(logits, data_shape, seed + 50 + k)
        x = np.random.default_rng(seed + 70 + k).random(data_shape,
                                                          np.float32)
        outs, ms = [], None
        for ctx in (mx.gpu(0), mx.cpu()):
            exe = logits.simple_bind(ctx, grad_req="null", data=data_shape)
            args, auxs = mx.convert.params_from_numpy(weights, ctx)
            exe.copy_params_from(args, auxs)
            exe.forward(data=x)
            outs.append(exe.outputs[0].asnumpy())
            if ms is None:  # the card's
                ms = time_ms(exe.forward, reps=10, warmup=2)
        rel = _rel_l2(outs[0], outs[1])
        print("zoo %s: batch %d at %s, %d parameters: forward %.3f ms on the "
              "card; logits card vs host relative L2 %.3g (limit %g); card %s"
              % (name, ZOO_BATCH, "x".join(map(str, shape)),
                 sum(int(np.prod(v.shape)) for v in weights.values()), ms,
                 rel, ZOO_REL, card_line()))
        if outs[0].shape != (ZOO_BATCH, 1000) or not np.isfinite(
                outs[0]).all() or not rel <= ZOO_REL:
            raise AssertionError("zoo %s: the card's forward disagrees with "
                                 "the host's" % name)


def train_mnist(mx, seed):
    """Phase 11.  Returns {path: launches}."""
    import tempfile
    import torch
    from mxnet_tpu_torch.models import lenet, mlp
    clock = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory(dir=HERE) as root:
        files = write_mnist(root, seed)
        print("mnist: wrote %s in %.1f s" % (
            ", ".join("%s %d images" % kv for kv in MNIST_SIZES.items()),
            time.perf_counter() - clock))
        symbol = lenet.get_symbol(10)
        _, paths["module_lenet"], (arg0, aux0) = fit_mnist(
            mx, seed, files, symbol, False, "lenet")
        lenet_profile_apart(seed)
        lenet_host_check(mx, seed, files, symbol, arg0, aux0)
        _, paths["module_mlp"], _ = fit_mnist(mx, seed, files,
                                              mlp.get_symbol(10), True, "mlp")
    consistency_checks(mx, seed)
    zoo_forwards(mx, seed)
    torch.cuda.synchronize()
    print("phase 11 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths


# -- phase 12: DCGAN (MXNet 1.0's example/gan/dcgan.py) through two Modules,
# the random ops, a replayed step that draws, the last nn and update ops ---

# dcgan.py's settings (Radford, Metz and Chintala 2016, arXiv:1511.06434):
# ngf = ndf = 64, Z 100, batch 64 of 64x64x3 images, Normal(0.02), Adam lr
# 2e-4, beta1 0.5, wd 0.  Cut: 200 iterations of one epoch, where the
# example runs 100 epochs; the widths are not cut.
DCGAN = dict(ngf=64, ndf=64, nc=3, z=100, batch=64, size=64)
DCGAN_ADAM = {"learning_rate": 2e-4, "wd": 0.0, "beta1": 0.5}
DCGAN_EPS = 1e-5 + 1e-12
DCGAN_IMAGES = 60000     # phase 11's training file
DCGAN_ITERS = 200
DCGAN_WARMUP = 10        # iterations before the median
DCGAN_SPLIT_ITERS = 5
DCGAN_HOST_ITERS = 2
DCGAN_OUT_TOL = dict(atol=1e-4, rtol=1e-4)
DCGAN_GRAD_REL = 1e-3    # phase 4's BatchNorm-net rule, or 4x the floor
# D's accuracy on real and fake (dcgan.py's facc) leaves chance by this
# much in some 10-iteration window
DCGAN_ACC_MOVE = 0.1
# its 7 train-mode BatchNorm inputs: gbn1-gbn4, then dbn2-dbn4
DCGAN_BN_SHAPES = (("gbn1", (64, 512, 4, 4)), ("gbn2", (64, 256, 8, 8)),
                   ("gbn3", (64, 128, 16, 16)), ("gbn4", (64, 64, 32, 32)),
                   ("dbn2", (64, 128, 16, 16)), ("dbn3", (64, 256, 8, 8)),
                   ("dbn4", (64, 512, 4, 4)))
RANDOM_DRAWS = 1000000
RANDOM_SIGMAS = 6.0
RANDOM_P_MIN = 1e-4
RANDOM_SEEDS = 20        # multinomial chi-square p-values over seeds
NOISY = dict(batch=64, features=256, classes=10, batches=4, epochs=2)
NOISY_REL = 1e-6
NN_CHECK_TOL = 1e-4      # check_consistency, card against host, f32
SEQ_SHAPE = (35, 20, 650)  # the medium LSTM's T, N, C (phase 7)
UPDATE_SHAPE = (2600, 650)  # the medium LSTM's i2h weight


def check_dcgan_bn(seed):
    """Phase 2e: ``bn_channel_sums`` at DCGAN's seven BatchNorm inputs
    (phase 12's main path), f32, statistics and pair, against its plain
    version, timed (one call, 20 back to back, device only) beside
    ``batch_norm_stats`` / ``batch_norm_backward_reduce`` and the bytes
    bound.  Timed here, early: late in the process torch.profiler loses
    kernel records.  Returns ([], [(kernel, instance)])."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 60)
    out = []
    for name, shape in DCGAN_BN_SHAPES:
        a = torch.randn(*shape, generator=gen, device=dev) + 0.5
        b = torch.randn(*shape, generator=gen, device=dev) + 0.5
        for pair in (None, b):
            form = "stats" if pair is None else "pair"
            label = "dcgan-%s-%s-%s" % (name, "x".join(map(str, shape)),
                                        form)
            errs = [_agree(g, w, F32_TOL) for g, w in zip(
                K.bn_channel_sums(a, pair), K._plain_channel_sums(a, pair))]
            err = max(e for e, _ in errs)
            if not all(o for _, o in errs):
                raise AssertionError("bn_channel_sums disagrees with its "
                                     "plain version at %s" % label)
            run = lambda: K.bn_channel_sums(a, pair)  # noqa: E731
            lib = bn_library(a, pair)
            ms, lib_ms = time_ms(run), time_ms(lib)
            plain_ms = time_ms(lambda: K._plain_channel_sums(a, pair))
            bound = bytes_bound(bn_bytes(a, pair))
            b2b, lib_b2b = time_ms_back_to_back(run), \
                time_ms_back_to_back(lib)
            print("kernel bn_channel_sums %s: max_abs_err %.3g; one call "
                  "%.4f ms, plain %.4f ms, %s %.4f ms; 20 back to back "
                  "%.4f ms a call (library %.4f ms); device only: kernel %s, "
                  "library %s; bound %.4f ms (%s); card %s"
                  % (label, err, ms, plain_ms, "batch_norm_stats"
                     if pair is None else "batch_norm_backward_reduce",
                     lib_ms, b2b, lib_b2b,
                     _device_text(device_ms_per_call(run)),
                     _device_text(device_ms_per_call(lib)), bound[0],
                     bound[1], card_line()))
            out.append(("bn_channel_sums",
                        _instance(label, err, ms, plain_ms, bound, lib_ms)))
    return [], out


def dcgan_symbols(mx, cfg):
    """dcgan.py's ``make_dcgan_sym`` (no_bias, fix_gamma): (generator,
    discriminator with ``LogisticRegressionOutput``)."""
    s = mx.sym

    def bn(x, name):
        return s.BatchNorm(x, name=name, fix_gamma=True, eps=DCGAN_EPS)

    ngf, ndf = cfg["ngf"], cfg["ndf"]
    x = s.Variable("rand")
    for i, width in enumerate([ngf * 8, ngf * 4, ngf * 2, ngf], 1):
        stride = dict(stride=(2, 2), pad=(1, 1)) if i > 1 else {}
        x = s.Deconvolution(x, name="g%d" % i, kernel=(4, 4),
                            num_filter=width, no_bias=True, **stride)
        x = s.Activation(bn(x, "gbn%d" % i), name="gact%d" % i,
                         act_type="relu")
    x = s.Deconvolution(x, name="g5", kernel=(4, 4), stride=(2, 2),
                        pad=(1, 1), num_filter=cfg["nc"], no_bias=True)
    gout = s.Activation(x, name="gact5", act_type="tanh")
    d = s.Variable("data")
    for i, width in enumerate([ndf, ndf * 2, ndf * 4, ndf * 8], 1):
        d = s.Convolution(d, name="d%d" % i, kernel=(4, 4), stride=(2, 2),
                          pad=(1, 1), num_filter=width, no_bias=True)
        if i > 1:
            d = bn(d, "dbn%d" % i)
        d = s.LeakyReLU(d, name="dact%d" % i, act_type="leaky", slope=0.2)
    d = s.Flatten(s.Convolution(d, name="d5", kernel=(4, 4), num_filter=1,
                                no_bias=True))
    return gout, s.LogisticRegressionOutput(data=d, label=s.Variable("label"),
                                            name="dloss")


def dcgan_modules(mx, ctx, cfg, arrays=None):
    """dcgan.py's ``modG`` and ``modD`` (``inputs_need_grad``) on ``ctx``:
    Normal(0.02) from the port's generator, or ``arrays`` ({name: numpy}
    with "arg:"/"aux:" keys, through ``params_from_numpy``)."""
    sym_g, sym_d = dcgan_symbols(mx, cfg)
    b = cfg["batch"]
    mods = []
    for sym, data, label in (
            (sym_g, ("rand", (b, cfg["z"], 1, 1)), None),
            (sym_d, ("data", (b, cfg["nc"], cfg["size"], cfg["size"])),
             ("label", (b,)))):
        mod = mx.mod.Module(sym, data_names=(data[0],),
                            label_names=(label[0],) if label else None,
                            context=ctx)
        mod.bind(data_shapes=[data], label_shapes=[label] if label else None,
                 inputs_need_grad=label is not None)
        if arrays is None:
            mod.init_params(initializer=mx.initializer.Normal(0.02))
        else:
            mine = set(sym.list_arguments()) | set(
                sym.list_auxiliary_states())
            args, auxs = mx.convert.params_from_numpy(
                {k: v for k, v in arrays.items()
                 if k.split(":", 1)[1] in mine}, mx.cpu())
            mod.init_params(arg_params=args, aux_params=auxs)
        mod.init_optimizer(optimizer="adam",
                           optimizer_params=dict(DCGAN_ADAM))
        mods.append(mod)
    return mods


def dcgan_weights(mx, cfg, seed):
    """Normal(0.02) weights, unit gammas, zero betas, moving statistics 0
    and 1, drawn on the host with numpy: {"arg:"/"aux:" name: array}."""
    rng = np.random.default_rng(seed)
    out = {}
    b = cfg["batch"]
    for sym, shapes in zip(dcgan_symbols(mx, cfg), (
            {"rand": (b, cfg["z"], 1, 1)},
            {"data": (b, cfg["nc"], cfg["size"], cfg["size"]),
             "label": (b,)})):
        arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
        for n, s in zip(sym.list_arguments(), arg_shapes):
            if n in shapes:
                continue
            out["arg:" + n] = np.ones(s, np.float32) if n.endswith("gamma") \
                else np.zeros(s, np.float32) if n.endswith("beta") \
                else (0.02 * rng.standard_normal(s)).astype(np.float32)
        for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
            out["aux:" + n] = (np.ones if n.endswith("var") else np.zeros)(
                s, np.float32)
    return out


def dcgan_facc(label, pred):
    """dcgan.py's discriminator accuracy."""
    return ((pred.ravel() > 0.5) == label.ravel()).mean()


def dcgan_fentropy(label, pred):
    """dcgan.py's binary cross-entropy."""
    pred, label = pred.ravel(), label.ravel()
    return -(label * np.log(pred + 1e-12)
             + (1.0 - label) * np.log(1.0 - pred + 1e-12)).mean()


def dcgan_iteration(mx, mod_g, mod_d, noise, batch, label, metrics=None,
                    split=None, seen=None):
    """dcgan.py's training iteration: ``noise`` a DataBatch of G's input,
    ``batch`` the real images' DataBatch, ``label`` dcgan.py's label
    array.  ``metrics`` (mG, mD, mACC) are updated as dcgan.py updates
    them; ``split`` (a list) gets the synchronized ms of each part;
    ``seen`` (a dict) gets what the iteration computed, on the host."""
    import torch
    marks = [time.perf_counter()]

    def part():
        if split is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

    mod_g.forward(noise, is_train=True)
    out_g = mod_g.get_outputs()
    part()
    label[:] = 0
    mod_d.forward(mx.io.DataBatch(out_g, [label]), is_train=True)
    mod_d.backward()
    grad_d = [[g.copyto(g.context) for g in grads]
              for grads in mod_d._exec_group.grad_arrays]
    if metrics:
        mod_d.update_metric(metrics[1], [label])
        metrics[2].update([label], mod_d.get_outputs())
    if seen is not None:
        seen["G"] = out_g[0].asnumpy()
        seen["D fake"] = mod_d.get_outputs()[0].asnumpy()
    part()
    label[:] = 1
    batch.label = [label]
    mod_d.forward(batch, is_train=True)
    mod_d.backward()
    for grads_r, grads_f in zip(mod_d._exec_group.grad_arrays, grad_d):
        for grad_r, grad_f in zip(grads_r, grads_f):
            grad_r += grad_f
    if metrics:
        mod_d.update_metric(metrics[1], [label])
        metrics[2].update([label], mod_d.get_outputs())
    if seen is not None:
        seen["D real"] = mod_d.get_outputs()[0].asnumpy()
        seen["D grads"] = {n: g[0].asnumpy() for n, g in zip(
            mod_d._param_names, mod_d._exec_group.grad_arrays)}
    part()
    mod_d.update()
    part()
    label[:] = 1
    mod_d.forward(mx.io.DataBatch(out_g, [label]), is_train=True)
    mod_d.backward()
    diff_d = mod_d.get_input_grads()
    if metrics:
        mod_d.update_metric(metrics[0], [label])
    if seen is not None:
        seen["D fake as real"] = mod_d.get_outputs()[0].asnumpy()
        seen["D input grads"] = diff_d[0].asnumpy()
    part()
    mod_g.backward(diff_d)
    if seen is not None:
        seen["G grads"] = {n: g[0].asnumpy() for n, g in zip(
            mod_g._param_names, mod_g._exec_group.grad_arrays)}
    part()
    mod_g.update()
    part()
    if split is not None:
        split.append(np.diff(marks) * 1e3)
    if seen is not None:
        for tag, mod in (("G", mod_g), ("D", mod_d)):
            args, auxs = mod.get_params()
            seen[tag + " params"] = {k: v.asnumpy() for k, v in args.items()}
            seen[tag + " aux"] = {k: v.asnumpy() for k, v in auxs.items()}


DCGAN_PARTS = ("G forward", "D pass 1 (fake, label 0)",
               "D pass 2 (real, label 1, gradients added)", "D update",
               "D pass 3 (fake, label 1, input gradients)", "G backward",
               "G update")


def dcgan_images(root, seed):
    """dcgan.py's MNIST path over phase 11's written training images: each
    resized to 64x64 (bilinear, ``torch.nn.functional.interpolate`` on
    the host in place of ``cv2.resize``), tiled to 3 channels, scaled to
    [-1, 1]: (n, 3, 64, 64) float32."""
    import torch
    import torch.nn.functional as F
    n = DCGAN_IMAGES
    image_file, _ = write_mnist(root, seed, {"train": n})["train"]
    with open(image_file, "rb") as f:
        pixels = np.frombuffer(f.read(), np.uint8, offset=16).reshape(
            n, 1, 28, 28)
    size = DCGAN["size"]
    out = np.empty((n, DCGAN["nc"], size, size), np.float32)
    for lo in range(0, n, 4096):
        x = torch.from_numpy(pixels[lo:lo + 4096].astype(np.float32))
        y = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False)
        out[lo:lo + 4096] = (y / (255.0 / 2) - 1.0).numpy()
    return out


def expected_dcgan_launches(mx):
    """``bn_channel_sums`` launches of one dcgan.py iteration, read off the
    graphs: per train-mode BatchNorm one statistics launch a forward and
    one paired launch a backward; G runs one forward and one backward, D
    three of each."""
    sym_g, sym_d = dcgan_symbols(mx, DCGAN)

    def bns(sym):
        return sum(node.op_name == "BatchNorm" for node in sym._topo())

    return {"bn_channel_sums": 2 * bns(sym_g) + 3 * 2 * bns(sym_d)}


def train_dcgan(mx, seed, images):
    """12a.  dcgan.py's loop on the card for DCGAN_ITERS iterations: noise
    from ``mx.random.normal`` on the card, the real batches through
    ``NDArrayIter(shuffle=True)`` after ``mx.random.seed(seed)``.  Returns
    the loop's kernel launches."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    cfg, ctx = DCGAN, mx.gpu(0)
    per_iter = expected_dcgan_launches(mx)
    mx.random.seed(seed)
    train_iter = mx.io.NDArrayIter(images, batch_size=cfg["batch"],
                                   shuffle=True)
    mod_g, mod_d = dcgan_modules(mx, ctx, cfg)
    label = mx.nd.zeros((cfg["batch"],), ctx=ctx)
    metrics = (mx.metric.CustomMetric(dcgan_fentropy),
               mx.metric.CustomMetric(dcgan_fentropy),
               mx.metric.CustomMetric(dcgan_facc))
    windows, iter_ms, iter_launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    K.reset_launch_counts()
    t_fit = time.perf_counter()
    for t in range(DCGAN_ITERS):
        before = K.launch_counts()
        t0 = time.perf_counter()
        noise = mx.io.DataBatch([mx.random.normal(
            0, 1.0, shape=(cfg["batch"], cfg["z"], 1, 1))], [])
        dcgan_iteration(mx, mod_g, mod_d, noise, next(train_iter), label,
                        metrics)
        torch.cuda.synchronize()
        iter_ms.append((time.perf_counter() - t0) * 1e3)
        now = K.launch_counts()
        iter_launches.append({k: now[k] - before[k] for k in per_iter})
        if (t + 1) % 10 == 0:
            windows.append(tuple(m.get()[1] for m in metrics))
            for m in metrics:
                m.reset()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t_fit
    launches = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = float(np.median(iter_ms[DCGAN_WARMUP:]))
    acc = [w[2] for w in windows]
    print("dcgan: %d iterations of batch %d (ngf %d, ndf %d, Z %d, %dx%d) in "
          "%.2f s; ms per iteration %.3f (median after %d), %.1f real "
          "images/s; peak memory %.2f GB (%.2f GB above the %.2f GB held "
          "before the loop); bn_channel_sums launches per iteration %s (all "
          "%d alike: %s), in all %d; card %s"
          % (DCGAN_ITERS, cfg["batch"], cfg["ngf"], cfg["ndf"], cfg["z"],
             cfg["size"], cfg["size"], fit_s, ms, DCGAN_WARMUP,
             cfg["batch"] / ms * 1e3, peak_gb, peak_gb - held_gb, held_gb,
             iter_launches[-1],
             len(iter_launches), all(d == per_iter for d in iter_launches),
             launches["bn_channel_sums"], card_line()))
    print("dcgan: every 10 iterations (G entropy, D entropy, D accuracy): %s"
          % "; ".join("%.4f %.4f %.4f" % w for w in windows))
    if any(d != per_iter for d in iter_launches):
        raise AssertionError("dcgan: bn_channel_sums launches per iteration "
                             "other than %s" % per_iter)
    if not np.isfinite(windows).all() \
            or max(abs(a - 0.5) for a in acc) < DCGAN_ACC_MOVE:
        raise AssertionError("dcgan: losses not finite or D's accuracy "
                             "stayed at chance: %s" % windows)
    split = []
    for _ in range(DCGAN_SPLIT_ITERS):
        noise = mx.io.DataBatch([mx.random.normal(
            0, 1.0, shape=(cfg["batch"], cfg["z"], 1, 1))], [])
        dcgan_iteration(mx, mod_g, mod_d, noise, next(train_iter), label,
                        split=split)
    med = np.median(np.stack(split), axis=0)
    print("dcgan: one iteration split (synchronized, median of %d): %s; "
          "sum %.3f ms" % (DCGAN_SPLIT_ITERS, "; ".join(
              "%s %.3f ms" % kv for kv in zip(DCGAN_PARTS, med)),
                           float(med.sum())))
    return {k: launches[k] for k in per_iter}


def dcgan_profile_apart(seed):
    """Runs ``dcgan_profile_child`` in a process of its own (late in this
    process torch.profiler loses kernel records) and passes its lines on;
    raises when it fails."""
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--dcgan-profile"], capture_output=True, text=True, timeout=600)
    sys.stdout.write(child.stdout)
    if child.returncode != 0:
        sys.stdout.write(child.stderr[-4000:])
        raise AssertionError("the profiled DCGAN iteration failed (exit %d)"
                             % child.returncode)


def dcgan_profile_child(mx, seed):
    """``--dcgan-profile``: dcgan.py's iteration at full width on random
    images, 3 warm-up iterations, then one under torch.profiler: the busy
    share, device time by group, and ``bn_channel_sums``'s device
    launches, which must equal the launches counted for the iteration."""
    from mxnet_tpu_torch.ops import kernels as K
    cfg, ctx = DCGAN, mx.gpu(0)
    per_iter = expected_dcgan_launches(mx)
    mod_g, mod_d = dcgan_modules(mx, ctx, cfg)
    label = mx.nd.zeros((cfg["batch"],), ctx=ctx)
    rng = np.random.default_rng(seed + 61)

    def one():
        noise = mx.io.DataBatch([mx.random.normal(
            0, 1.0, shape=(cfg["batch"], cfg["z"], 1, 1))], [])
        real = mx.io.DataBatch([mx.nd.array(rng.uniform(
            -1, 1, (cfg["batch"], cfg["nc"], cfg["size"], cfg["size"])
        ).astype(np.float32), ctx=ctx)], [])
        dcgan_iteration(mx, mod_g, mod_d, noise, real, label)

    for _ in range(3):
        one()
    before = K.launch_counts()
    table = profile_run(one, "dcgan iteration")
    calls = {k: K.launch_counts()[k] - before[k] for k in per_iter}
    if calls != per_iter:
        raise AssertionError("the profiled DCGAN iteration counted %s, "
                             "expected %s" % (calls, per_iter))
    if table is None:
        return 0
    n = sum(v[1] for k, v in table.items() if "channel_sums_kernel" in k)
    print("dcgan: the profiled iteration's bn_channel_sums: %d device "
          "launches (%.4f ms), %d counted; card %s"
          % (n, sum(v[0] for k, v in table.items()
                    if "channel_sums_kernel" in k),
             calls["bn_channel_sums"], card_line()))
    if n != calls["bn_channel_sums"]:
        raise AssertionError("the iteration's bn_channel_sums device "
                             "launches %d, expected %d"
                             % (n, calls["bn_channel_sums"]))
    return 0


def dcgan_host_check(mx, seed, images):
    """12b.  DCGAN's first DCGAN_HOST_ITERS iterations at full width from
    the same weights (``params_from_numpy``), noise and images, all made
    on the host, on the card and through the port on the host, and twice
    more on the host with the noise and the images moved by a relative
    1e-7 (two draws): the larger of those runs' distances from the host's
    is the host's own floor for each tensor (phase 4's rule for
    BatchNorm nets).  Each output within DCGAN_OUT_TOL, or within 4 times
    its floor's largest error.  D's summed gradients, D's input
    gradients, G's gradients and both nets' updated parameters and moving
    statistics each within DCGAN_GRAD_REL relative L2, or within 4 times
    the largest floor of its kind (the same iteration, record and name
    suffix: the weights, the betas, the moving means, ...): phase 4's
    rule, whose limit is the largest floor of all, narrowed to a kind.
    The outputs of the first iteration's passes before an update have a
    floor of ~1e-7, so they are held to DCGAN_OUT_TOL.  Adam's first
    steps move each weight by about +-lr whatever the size of its
    gradient, so the sign of a gradient that is 0 up to rounding moves a
    weight by 2 lr; every later tensor carries that floor, and a flip in
    a small tensor (a beta of 256 channels) is a rare event that a floor
    run shows in some tensors of the kind, not in each."""
    cfg = DCGAN
    rng = np.random.default_rng(seed + 62)
    weights = dcgan_weights(mx, cfg, seed + 63)
    b = cfg["batch"]
    noises = [rng.standard_normal((b, cfg["z"], 1, 1)).astype(np.float32)
              for _ in range(DCGAN_HOST_ITERS)]
    reals = [images[i * b:(i + 1) * b] for i in range(DCGAN_HOST_ITERS)]

    def nudge(arrays):
        return [(a * (1 + 1e-7 * rng.standard_normal(a.shape))).astype(
            np.float32) for a in arrays]

    runs = []
    t0 = time.perf_counter()
    for ctx, inputs in ((mx.gpu(0), (noises, reals)),
                        (mx.cpu(), (noises, reals)),
                        (mx.cpu(), (nudge(noises), nudge(reals))),
                        (mx.cpu(), (nudge(noises), nudge(reals)))):
        mod_g, mod_d = dcgan_modules(mx, ctx, cfg, weights)
        label = mx.nd.zeros((b,), ctx=ctx)
        steps = []
        for noise, real in zip(*inputs):
            seen = {}
            dcgan_iteration(
                mx, mod_g, mod_d,
                mx.io.DataBatch([mx.nd.array(noise, ctx=ctx)], []),
                mx.io.DataBatch([mx.nd.array(real, ctx=ctx)], []), label,
                seen=seen)
            steps.append(seen)
        runs.append(steps)
    card, host, floor1, floor2 = runs
    outs, tensors = [], []  # (tag, error, floor, ok)
    for k, (c, h, f1, f2) in enumerate(zip(card, host, floor1, floor2)):
        for key in ("G", "D fake", "D real", "D fake as real"):
            err = np.abs(c[key] - h[key])
            floor = max(float(np.abs(f[key] - h[key]).max())
                        for f in (f1, f2))
            ok = bool((err <= DCGAN_OUT_TOL["atol"] + DCGAN_OUT_TOL["rtol"]
                       * np.abs(h[key])).all()) or err.max() <= 4.0 * floor
            outs.append(("%d %s" % (k + 1, key), float(err.max()), floor,
                         ok))
        for key in ("D input grads", "D grads", "G grads", "G params",
                    "D params", "G aux", "D aux"):
            pairs = [(key, c[key], h[key], f1[key], f2[key])] \
                if key == "D input grads" else [
                    ("%s %s" % (key, n), c[key][n], h[key][n], f1[key][n],
                     f2[key][n])
                    for n in h[key] if np.linalg.norm(h[key][n]) > 0]
            for name, cv, hv, fv1, fv2 in pairs:
                tensors.append(("%d %s" % (k + 1, name),
                                "%d %s %s" % (k + 1, key,
                                              name.rsplit("_", 1)[-1]),
                                _rel_l2(cv, hv),
                                max(_rel_l2(fv1, hv), _rel_l2(fv2, hv))))
    kind_floor = {}
    for _, kind, _, floor in tensors:
        kind_floor[kind] = max(kind_floor.get(kind, 0.0), floor)
    tensors = [(tag, err, kind_floor[kind],
                err <= max(DCGAN_GRAD_REL, 4.0 * kind_floor[kind]))
               for tag, kind, err, _ in tensors]
    worst_out = max(outs, key=lambda o: o[1])
    worst = max(tensors, key=lambda t: t[1] / max(DCGAN_GRAD_REL,
                                                  4.0 * t[2]))
    above = sorted((t for t in tensors if t[1] > DCGAN_GRAD_REL),
                   key=lambda t: -t[1])
    print("dcgan: %d iterations card vs host from the same weights, noise "
          "and images (%.1f s); outputs: largest max_abs_err %.3g (iteration "
          "%s; its floor %.3g), %d/%d within atol=rtol=%g, the rest within "
          "4x their floor: %s; gradients, parameters and moving statistics "
          "(%d tensors): relative L2 median %.3g, largest against its limit "
          "%.3g (iteration %s; floor %.3g), %d above %g, each within 4x the "
          "floor of its kind (the host's noise and images moved by 1e-7): "
          "%s; card %s"
          % (DCGAN_HOST_ITERS, time.perf_counter() - t0, worst_out[1],
             worst_out[0], worst_out[2],
             sum(o[1] <= DCGAN_OUT_TOL["atol"] for o in outs), len(outs),
             DCGAN_OUT_TOL["atol"], "; ".join(
                 "%s %.3g (floor %.3g)" % o[:3] for o in outs
                 if o[1] > DCGAN_OUT_TOL["atol"]) or "none",
             len(tensors), float(np.median([t[1] for t in tensors])),
             worst[1], worst[0], worst[2], len(above), DCGAN_GRAD_REL,
             "; ".join("%s %.3g (floor %.3g)" % t[:3] for t in above[:8])
             + ("; ..." if len(above) > 8 else "") if above else "none",
             card_line()))
    bad = [o for o in outs + tensors if not o[3]]
    if bad:
        raise AssertionError("dcgan: the card's iterations disagree with the "
                             "host's beyond the host's own floor: %s"
                             % "; ".join("%s %.3g (floor %.3g)" % t[:3]
                                         for t in bad[:8]))


# canonical op -> two cases: (scalar attrs, or tensor params one row per
# parameter), the analytic (mean, variance) per row, the support
RANDOM_CASES = {
    "_random_uniform": [({"low": -1.0, "high": 3.0}, [(1.0, 16 / 12)],
                         ("range", -1.0, 3.0)),
                        ({"low": 0.0, "high": 1.0}, [(0.5, 1 / 12)],
                         ("range", 0.0, 1.0))],
    "_random_normal": [({"loc": 2.0, "scale": 0.5}, [(2.0, 0.25)], None),
                       ({"loc": -10.0, "scale": 3.0}, [(-10.0, 9.0)], None)],
    "_random_gamma": [({"alpha": 2.5, "beta": 1.5}, [(3.75, 5.625)],
                       ("positive",)),
                      ({"alpha": 0.5, "beta": 2.0}, [(1.0, 2.0)],
                       ("positive",))],
    "_random_exponential": [({"lam": 2.0}, [(0.5, 0.25)], ("nonnegative",)),
                            ({"lam": 0.1}, [(10.0, 100.0)],
                             ("nonnegative",))],
    "_random_poisson": [({"lam": 4.0}, [(4.0, 4.0)], ("count",)),
                        ({"lam": 0.3}, [(0.3, 0.3)], ("count",))],
    "_random_negative_binomial": [({"k": 3, "p": 0.4}, [(4.5, 11.25)],
                                   ("count",)),
                                  ({"k": 10, "p": 0.8}, [(2.5, 3.125)],
                                   ("count",))],
    "_random_generalized_negative_binomial": [
        ({"mu": 5.0, "alpha": 0.3}, [(5.0, 12.5)], ("count",)),
        ({"mu": 1.5, "alpha": 2.0}, [(1.5, 6.0)], ("count",))],
    "_random_randint": [({"low": -3, "high": 7}, [(1.5, 8.25)],
                         ("integer", -3, 7)),
                        ({"low": 0, "high": 2}, [(0.5, 0.25)],
                         ("integer", 0, 2))],
    "_sample_uniform": [([[0.0, -2.0], [1.0, 2.0]],
                         [(0.5, 1 / 12), (0.0, 16 / 12)], ("rows",)),
                        ([[5.0], [5.5]], [(5.25, 0.25 / 12)], ("rows",))],
    "_sample_normal": [([[0.0, 3.0], [1.0, 0.5]], [(0.0, 1.0), (3.0, 0.25)],
                        None),
                       ([[-1.0], [4.0]], [(-1.0, 16.0)], None)],
    "_sample_gamma": [([[1.0, 8.0], [1.0, 2.0]], [(1.0, 1.0), (16.0, 32.0)],
                       ("positive",)),
                      ([[0.7], [0.5]], [(0.35, 0.175)], ("positive",))],
    "_sample_exponential": [([[1.0, 4.0]], [(1.0, 1.0), (0.25, 1 / 16)],
                             ("nonnegative",)),
                            ([[0.5]], [(2.0, 4.0)], ("nonnegative",))],
    "_sample_poisson": [([[2.0, 10.0]], [(2.0, 2.0), (10.0, 10.0)],
                         ("count",)),
                        ([[30.0]], [(30.0, 30.0)], ("count",))],
    "_sample_negative_binomial": [
        ([[3.0, 5.0], [0.4, 0.7]], [(4.5, 11.25), (5 * 0.3 / 0.7,
                                                   5 * 0.3 / 0.49)],
         ("count",)),
        ([[1.0], [0.5]], [(1.0, 2.0)], ("count",))],
    "_sample_generalized_negative_binomial": [
        ([[5.0, 2.0], [0.3, 1.0]], [(5.0, 12.5), (2.0, 6.0)], ("count",)),
        ([[8.0], [0.1]], [(8.0, 14.4)], ("count",))],
}
RANDOM_PROBS = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.25, 0.125, 0.125]],
                        np.float32)


def _z_scores(x, mean, var):
    """The sample mean's and variance's distance from the analytic values
    in standard errors (the variance's from the sample's fourth central
    moment)."""
    n = x.size
    m4 = ((x - x.mean()) ** 4).mean()
    return (abs(x.mean() - mean) / np.sqrt(var / n),
            abs(x.var() - var) / np.sqrt(max(m4 - x.var() ** 2, 1e-300) / n))


def _support_ok(x, support, params):
    if not np.isfinite(x).all():
        return False
    if support is None:
        return True
    kind = support[0]
    if kind == "range":
        return x.min() >= support[1] and x.max() < support[2]
    if kind == "integer":
        return bool((x == np.round(x)).all()) and x.min() >= support[1] \
            and x.max() < support[2]
    if kind == "count":
        return bool((x == np.round(x)).all()) and x.min() >= 0
    if kind == "positive":
        return x.min() > 0
    if kind == "nonnegative":
        return x.min() >= 0
    lo, hi = params
    return all(r.min() >= a and r.max() < b
               for r, a, b in zip(x.reshape(len(lo), -1), lo, hi))


def _random_draw(mx, name, case, n, dtype=None):
    """``mx.nd.<name>`` on the card at its case, ``n`` draws per row."""
    attrs_or_params = case[0]
    kw = {"shape": (n,)}
    if dtype is not None:
        kw["dtype"] = dtype
    fn = getattr(mx.nd, name)
    if isinstance(attrs_or_params, dict):
        return fn(ctx=mx.gpu(0), **attrs_or_params, **kw)
    return fn(*[mx.nd.array(np.asarray(p, np.float32), ctx=mx.gpu(0))
                for p in attrs_or_params], **kw)


def random_ops_on_card(mx, seed):
    """12c.  Every canonical random op on the card: 10^6 draws at each of
    two parameter settings in f32 (and uniform and normal in f16 and
    f64): the output on the card, its support, mean and variance within
    RANDOM_SIGMAS standard errors; the same ``mx.random.seed`` the same
    bits twice, another seed others, ``torch.manual_seed`` nothing.
    Multinomial frequencies by a chi-square at p RANDOM_P_MIN, the
    chi-square p-values over RANDOM_SEEDS seeds uniform by a KS test at p
    RANDOM_P_MIN, and ``get_prob`` equal to ``log p[idx]`` exactly;
    ``_shuffle`` a row permutation; ``sgld_update``'s noise (its output
    less the host's deterministic part) N(0, lr) by its moments."""
    import torch
    from scipy import stats
    worst = (0.0, "")
    n_checked = 0
    for name, cases in RANDOM_CASES.items():
        for k, case in enumerate(cases):
            rows = len(case[1])
            cases_dt = [None] + (["float16", "float64"]
                                 if name in ("_random_uniform",
                                             "_random_normal") and k == 0
                                 else [])
            for dtype in cases_dt:
                mx.random.seed(seed + 64)
                t0 = time.perf_counter()
                out = _random_draw(mx, name, case, RANDOM_DRAWS // rows,
                                   dtype)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                x = out.asnumpy().astype(np.float64)
                on_card = out.context == mx.gpu(0)
                ok = on_card and _support_ok(
                    x, case[2], None if isinstance(case[0], dict)
                    else case[0])
                for row, (mean, var) in zip(x.reshape(rows, -1), case[1]):
                    zm, zv = _z_scores(row, mean, var)
                    worst = max(worst, (max(zm, zv), "%s case %d %s"
                                        % (name, k, dtype or "float32")))
                    ok = ok and zm < RANDOM_SIGMAS and zv < RANDOM_SIGMAS
                if dtype is None:
                    mx.random.seed(seed + 64)
                    torch.manual_seed(seed + 999)
                    again = _random_draw(mx, name, case,
                                         RANDOM_DRAWS // rows).asnumpy()
                    mx.random.seed(seed + 65)
                    other = _random_draw(mx, name, case,
                                         RANDOM_DRAWS // rows).asnumpy()
                    ok = ok and np.array_equal(again, out.asnumpy()) \
                        and not np.array_equal(other, out.asnumpy())
                n_checked += 1
                print("random %s case %d %s: %d draws on the card in %.3f ms "
                      "(host clock, synchronized), %s"
                      % (name, k, dtype or "float32", x.size, ms,
                         "ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError("random op %s case %d %s failed its "
                                         "checks" % (name, k, dtype))
    mx.random.seed(seed + 66)
    data = mx.nd.array(RANDOM_PROBS, ctx=mx.gpu(0))
    idx, prob = mx.nd.random.multinomial(data, shape=RANDOM_DRAWS // 2,
                                         get_prob=True)
    on_card = idx.context == prob.context == mx.gpu(0)
    idx = idx.asnumpy()
    pvals, freqs = [], []
    for row, p in zip(idx, RANDOM_PROBS):
        expected = p.astype(np.float64) / p.astype(np.float64).sum()
        counts = np.bincount(row, minlength=len(p))
        freqs.append("/".join("%.5f" % c for c in counts / row.size))
        pvals.append(stats.chisquare(counts, expected * row.size).pvalue)
    exact = np.array_equal(prob.asnumpy(), np.take_along_axis(
        mx.nd.log(data).asnumpy(), idx, axis=1))
    # over seeds the chi-square p-values of an unbiased sampler are uniform
    seed_p = []
    for k in range(RANDOM_SEEDS):
        mx.random.seed(seed + 100 + k)
        rows = mx.nd.random.multinomial(data, shape=RANDOM_DRAWS // 2)
        for row, p in zip(rows.asnumpy(), RANDOM_PROBS):
            expected = p.astype(np.float64) / p.astype(np.float64).sum()
            seed_p.append(stats.chisquare(np.bincount(row, minlength=len(
                p)), expected * row.size).pvalue)
    seed_ks = stats.kstest(seed_p, "uniform").pvalue
    rows = np.arange(2 * 20000, dtype=np.float32).reshape(20000, 2)
    shuffled = mx.nd.random.shuffle(mx.nd.array(rows, ctx=mx.gpu(0)))
    perm_ok = shuffled.context == mx.gpu(0) and np.array_equal(
        np.sort(shuffled.asnumpy()[:, 0]), rows[:, 0]) and np.array_equal(
        shuffled.asnumpy()[:, 1] - shuffled.asnumpy()[:, 0],
        np.ones(20000, np.float32))
    lr, wd = 0.04, 0.01
    rng = np.random.default_rng(seed + 67)
    w = rng.uniform(-1, 1, RANDOM_DRAWS).astype(np.float32)
    g = rng.uniform(-1, 1, RANDOM_DRAWS).astype(np.float32)
    sgld = mx.nd.sgld_update(mx.nd.array(w, ctx=mx.gpu(0)),
                             mx.nd.array(g, ctx=mx.gpu(0)), lr=lr, wd=wd,
                             clip_gradient=0.5)
    noise = sgld.asnumpy().astype(np.float64) - (
        w - lr / 2 * np.clip(g + wd * w, -0.5, 0.5))
    z_sgld = _z_scores(noise, 0.0, lr)
    print("random: %d cases of %d samplers passed; worst "
          "moment %.2f standard errors (%s, limit %g); multinomial "
          "frequencies %s, chi-square p %s (limit %g), over %d seeds the "
          "%d p-values' KS test against uniform p %.3g, get_prob exact %s, "
          "on the card %s; "
          "shuffle a permutation of 20,000 rows %s; sgld_update noise mean "
          "and variance %.2f and %.2f standard errors from N(0, %g); card %s"
          % (n_checked, len(RANDOM_CASES), worst[0], worst[1], RANDOM_SIGMAS,
             ", ".join(freqs), ", ".join("%.3g" % p for p in pvals),
             RANDOM_P_MIN, RANDOM_SEEDS, len(seed_p), seed_ks, exact,
             on_card, perm_ok, z_sgld[0], z_sgld[1], lr, card_line()))
    if not (on_card and exact and perm_ok and min(pvals) > RANDOM_P_MIN
            and seed_ks > RANDOM_P_MIN and max(z_sgld) < RANDOM_SIGMAS):
        raise AssertionError("multinomial, shuffle or sgld_update failed its "
                             "checks on the card")


def noisy_module(mx, fused, seed):
    """A Module whose graph adds ``mx.sym.random.normal`` noise to its
    input, SGD momentum, on the card; its batches."""
    cfg = NOISY
    rng = np.random.default_rng(seed + 68)
    x = rng.standard_normal((cfg["batch"] * cfg["batches"],
                             cfg["features"])).astype(np.float32)
    y = (x @ rng.standard_normal((cfg["features"], cfg["classes"]))).argmax(
        1).astype(np.float32)
    data = mx.sym.Variable("data")
    noisy = data + mx.sym.random.normal(0.0, 0.5, shape=(cfg["batch"],
                                                         cfg["features"]))
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        noisy, num_hidden=cfg["classes"], name="fc"), name="softmax")
    it = mx.io.NDArrayIter(x, y, batch_size=cfg["batch"])
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={
        "fc_weight": mx.nd.array(rng.uniform(-0.05, 0.05, (
            cfg["classes"], cfg["features"])).astype(np.float32),
            ctx=mx.cpu()),
        "fc_bias": mx.nd.zeros((cfg["classes"],), ctx=mx.cpu())})
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
    if not fused:
        mod._fused_step = None
    return mod, it, opt


def noisy_fit_check(mx, seed):
    """12d.  ``Module.fit`` of a graph that adds ``mx.sym.random.normal``
    noise to its input, on the fused step (one CUDA graph): every step's
    outputs and the trained parameters equal the eager general path's
    from the same generator state within NOISY_REL; then, at lr 0, two
    replays on one batch draw different noise."""
    import torch
    runs = {}
    for fused in (True, False):
        mod, it, opt = noisy_module(mx, fused, seed)
        outs = []
        mx.random.seed(seed + 69)
        if fused:
            mod.fit(it, num_epoch=NOISY["epochs"], optimizer="sgd",
                    optimizer_params=opt, batch_end_callback=lambda p: (
                        outs.append(mod.get_outputs()[0].asnumpy())))
        else:
            for _ in range(NOISY["epochs"]):
                it.reset()
                for batch in it:
                    mod.forward_backward(batch)
                    mod.update()
                    outs.append(mod.get_outputs()[0].asnumpy())
        runs[fused] = (mod, outs, {k: v.asnumpy() for k, v in
                                   mod.get_params()[0].items()})
    mod, outs, params = runs[True]
    _, eager_outs, eager_params = runs[False]
    fs = mod._fused_step
    steps = NOISY["batches"] * NOISY["epochs"]
    worst = max([_rel_l2(a, b) for a, b in zip(outs, eager_outs)]
                + [_rel_l2(params[k], eager_params[k]) for k in params])
    it = noisy_module(mx, True, seed)[1]
    batch = next(it)
    mod._optimizer.lr = 0.0
    mod._optimizer.wd = 0.0
    fresh = []
    for _ in range(2):
        mod.forward_backward(batch)
        mod.update()
        fresh.append(mod.get_outputs()[0].asnumpy())
    torch.cuda.synchronize()
    print("noisy fit: %d steps of batch %d through Module.fit on the fused "
          "step (captures %d, replays %d) against the eager general path "
          "from the same generator state: largest relative L2 %.3g (limit "
          "%g); two lr-0 replays on one batch differ: %s; card %s"
          % (steps, NOISY["batch"], fs.captures if fs else 0,
             fs.replays if fs else 0, worst, NOISY_REL,
             not np.array_equal(fresh[0], fresh[1]), card_line()))
    if fs is None or fs.captures != 1 or fs.replays != steps + 1 \
            or len(outs) != steps or worst > NOISY_REL \
            or np.array_equal(fresh[0], fresh[1]):
        raise AssertionError("the fused step with a random node did not "
                             "replay fresh draws equal to the eager path")


def nn_rest_graphs(mx, rng):
    """{name: (symbol, {input: values})}: the 8 ``nn`` ops and the 4
    deterministic update ops at real shapes."""
    s = mx.sym
    t, n, c = SEQ_SHAPE
    seq = {"data": rng.standard_normal(SEQ_SHAPE).astype(np.float32),
           "sl": rng.integers(1, t + 1, n).astype(np.float32)}
    data, sl = s.var("data"), s.var("sl")
    graphs = {
        "SequenceLast": (s.SequenceLast(data, sequence_length=sl,
                                        use_sequence_length=True), seq),
        "SequenceMask": (s.SequenceMask(data, sequence_length=sl,
                                        use_sequence_length=True,
                                        value=-1.0), seq),
        "SequenceReverse": (s.SequenceReverse(data, sequence_length=sl,
                                              use_sequence_length=True),
                            seq),
        "UpSampling": (s.UpSampling(data, scale=2, sample_type="nearest"),
                       {"data": rng.standard_normal((64, 128, 16, 16))
                        .astype(np.float32)}),
        "SVMOutput": (s.SVMOutput(data, s.var("label")), {
            "data": rng.standard_normal((64, 10)).astype(np.float32),
            "label": rng.integers(0, 10, 64).astype(np.float32)}),
    }
    for head in ("LinearRegressionOutput", "LogisticRegressionOutput",
                 "MAERegressionOutput"):
        for width in (1, 10):
            label = rng.integers(0, 2, (64, width)) \
                if head == "LogisticRegressionOutput" \
                else rng.standard_normal((64, width))
            graphs["%s-%d" % (head, width)] = (
                getattr(s, head)(data, s.var("label")), {
                    "data": rng.standard_normal((64, width)).astype(
                        np.float32),
                    "label": label.astype(np.float32)})
    w, g = s.var("weight"), s.var("grad")

    def state(positive=False):
        v = rng.standard_normal(UPDATE_SHAPE).astype(np.float32)
        return np.abs(v) + 0.1 if positive else v

    wg = {"weight": state(), "grad": state()}
    graphs["adamax_update"] = (s.adamax_update(
        w, g, s.var("mean"), s.var("var"), lr=0.01, t=3, wd=1e-4),
        dict(wg, mean=state(), var=state(True)))
    graphs["nadam_update"] = (s.nadam_update(
        w, g, s.var("mean"), s.var("var"), lr=0.01, t=4, wd=1e-4),
        dict(wg, mean=state(), var=state(True)))
    graphs["ftml_update"] = (s.ftml_update(
        w, g, s.var("d"), s.var("v"), s.var("z"), lr=0.01, t=2, wd=1e-4),
        dict(wg, d=state(True), v=state(True), z=state()))
    graphs["nag_mom_update"] = (s.nag_mom_update(
        w, g, s.var("mom"), lr=0.1, momentum=0.9, wd=1e-4),
        dict(wg, mom=state()))
    return graphs


def nn_rest_consistency(mx, seed):
    """12e.  ``mx.test_utils.check_consistency`` over [cpu(0), gpu(0)] on
    the 8 ``nn`` ops (the sequence ops at the medium LSTM's T 35, N 20,
    C 650 with ragged lengths, ``UpSampling`` nearest at a generator's
    (64, 128, 16, 16), the regression heads at (64, 1) and (64, 10),
    ``SVMOutput``) and the 4 deterministic update ops at (2600, 650),
    within NN_CHECK_TOL; and each graph's training backward (head
    gradient ones) card against host within the same tolerance."""
    rng = np.random.default_rng(seed + 70)
    graphs = nn_rest_graphs(mx, rng)
    for name, (sym, values) in graphs.items():
        shapes = {k: v.shape for k, v in values.items()}
        mx.test_utils.check_consistency(
            sym, [dict(shapes, ctx=ctx) for ctx in (mx.cpu(), mx.gpu(0))],
            arg_params=dict(values), tol=NN_CHECK_TOL)
        grads = []
        for ctx in (mx.gpu(0), mx.cpu()):
            ex = sym.bind(ctx, args={k: mx.nd.array(v, ctx=ctx)
                                     for k, v in values.items()},
                          args_grad={k: mx.nd.zeros(v.shape, ctx=ctx)
                                     for k, v in values.items()})
            ex.forward(is_train=True)
            ex.backward()
            grads.append({k: v.asnumpy() for k, v in ex.grad_dict.items()})
        for k in grads[1]:
            if not np.allclose(grads[0][k], grads[1][k], atol=NN_CHECK_TOL,
                               rtol=NN_CHECK_TOL):
                raise AssertionError("%s: the gradient of %s on the card "
                                     "differs from the host's" % (name, k))
    print("nn ops: check_consistency over [cpu(0), gpu(0)] and the training "
          "backward card vs host passed for %d graphs (%s) within %g; card %s"
          % (len(graphs), ", ".join(graphs), NN_CHECK_TOL, card_line()))
    if len(graphs) != 5 + 6 + 4:
        raise AssertionError("%d nn graphs" % len(graphs))


def train_dcgan_phase(mx, seed):
    """Phase 12.  Returns {path: launches}."""
    import tempfile
    import torch
    clock = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HERE) as root:
        images = dcgan_images(root, seed)
    print("dcgan: %d MNIST-format images resized to %dx%d, tiled to %d "
          "channels, scaled to [-1, 1] in %.1f s"
          % (len(images), DCGAN["size"], DCGAN["size"], DCGAN["nc"],
             time.perf_counter() - clock))
    paths = {"module_dcgan": train_dcgan(mx, seed, images)}
    dcgan_profile_apart(seed)
    dcgan_host_check(mx, seed, images)
    del images
    random_ops_on_card(mx, seed)
    noisy_fit_check(mx, seed)
    nn_rest_consistency(mx, seed)
    torch.cuda.synchronize()
    print("phase 12 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths


def ptxas_entries(text):
    """(kernel, "N registers, S bytes spill stores, L bytes spill loads")
    per compiled entry of an ``nvcc -Xptxas=-v`` report.  The kernel is
    read off its mangled name: the function's name, then its template
    arguments as mangled (``IfLi64EE``: float, 64; ``I13__nv_bfloat16Li3E
    Li3ELi2ELi2EE``: bf16 and a 3x3/s2 window)."""
    import re
    out, entry, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"entry function '_ZN(\d+)", line)
        if m:
            rest = line[m.end() + int(m.group(1)):]  # past the namespace
            n = re.match(r"\d+", rest)
            name = rest[n.end():n.end() + int(n.group())]
            tail = rest[n.end() + len(name):]
            entry = name + (tail[:tail.index("EEv") + 1]
                            if tail.startswith("I") and "EEv" in tail else "")
            spill = ""
        elif "spill stores" in line:
            spill = ", ".join(p.strip() for p in line.split(",")[1:])
        elif "registers" in line and entry:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((entry, "%s registers, %s" % (regs, spill)))
            entry = None
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--vision-profile", action="store_true",
                        help=argparse.SUPPRESS)  # profile_vision_step_apart
    parser.add_argument("--lenet-profile", action="store_true",
                        help=argparse.SUPPRESS)  # lenet_profile_apart
    parser.add_argument("--dcgan-profile", action="store_true",
                        help=argparse.SUPPRESS)  # dcgan_profile_apart
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
    if args.vision_profile:
        return vision_profile_child(mx, args.seed)
    if args.lenet_profile:
        return lenet_profile_child(mx, args.seed)
    if args.dcgan_profile:
        return dcgan_profile_child(mx, args.seed)
    print("card: %s" % card_line())
    print("torch %s, CUDA %s, %d device(s)"
          % (torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    t0 = time.perf_counter()
    _build.build_all(["flash_attn_fwd", "bn_channel_sums", "pool_bwd"])
    print("kernels built in %.1f s" % (time.perf_counter() - t0))
    for name, info in sorted(_build.BUILD_INFO.items()):
        print("  %s: %.1f s" % (name, info["seconds"]))
        for entry, report in ptxas_entries(info["ptxas"]):
            print("    %s: %s" % (entry, report))

    clock = {"t": time.perf_counter()}

    def lap(phase):
        now = time.perf_counter()
        print("phase %s: %.1f s" % (phase, now - clock["t"]))
        clock["t"] = now

    lap("1 (card, build)")
    records, instances = [], {}
    for check in (check_flash, check_flash_lse, check_bn_sums,
                  check_pool_bwd, check_lenet_pools, check_dcgan_bn):
        recs, insts = check(args.seed)
        records += recs
        for name, inst in insts:
            instances.setdefault(name, []).append(inst)
    lap("2 (kernels against their plain versions)")
    # each path's launches, counted from 0 just before it runs
    paths = {"serve": {"flash_attn_fwd": serve(mx, args.seed)}}
    lap("3 (serving)")
    paths["module_fit"] = train(mx, args.seed)
    lap("4 (Module training)")
    paths["gluon_lm"] = train_gluon(mx, args.seed)
    lap("5 (Gluon TransformerLM)")
    paths["gluon_resnet50"] = train_gluon_vision(mx, args.seed)
    lap("6 (Gluon vision ResNet-50 v2, SymbolBlock)")
    paths["gluon_lstm_lm"] = train_lstm_lm(mx, args.seed)
    lap("7 (Gluon LSTM LM, recurrent layers and cells, CTC)")
    paths["module_bf16_fused"] = train_bf16_fused(mx, args.seed)
    lap("8 (bf16 fused Module training)")
    paths["module_bucketing"] = train_bucketing(mx, args.seed)
    lap("9 (bucketed LSTM LM through BucketingModule)")
    paths.update(serve_rest(mx, args.seed))
    lap("10 (paged decode, continuous batching, int8, fleet, HTTP)")
    paths.update(train_mnist(mx, args.seed))
    lap("11 (LeNet and the MLP on MNIST through Module, check_consistency, "
        "the symbol zoo)")
    paths.update(train_dcgan_phase(mx, args.seed))
    lap("12 (DCGAN through two Modules, the random ops, a replayed step "
        "that draws, the last nn and update ops)")
    # "launches": the path each kernel serves in this script (the serving
    # forward, the LM's training, and the bf16 fused training; LeNet's and
    # DCGAN's are in launches_by_path)
    main_path = {"flash_attn_fwd": "serve", "flash_attn_fwd_lse": "gluon_lm",
                 "bn_channel_sums": "module_bf16_fused",
                 "max_pool_backward": "module_bf16_fused",
                 "avg_pool_backward": "module_bf16_fused"}
    for rec in records:
        name = rec["name"]
        rec["launches"] = paths[main_path[name]].get(name, 0)
        rec["launches_by_path"] = {p: c.get(name, 0)
                                   for p, c in paths.items()}
        rec["instances"] = instances.get(name, [])
        if rec["launches"] == 0:
            raise AssertionError("%s was not launched on its path" % name)
    print(card_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
