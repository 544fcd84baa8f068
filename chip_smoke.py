#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, each of which raises on failure:

1. Card: the card's name and power limit, torch and CUDA versions, and
   the build of every kernel source (one ``nvcc`` each, in parallel),
   with each compiled kernel's registers and spills from ``ptxas``; the
   native record reader and engine (``g++``) and the image codec in use
   (cv2 or PIL).
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
   way beside ``batch_norm_stats`` / ``batch_norm_backward_reduce``; and
   the pooling backwards at the LeNet-STN localisation net's pools (phase
   19a's path): ``max_pool_backward`` 2x2/s2 over (64, 30, 12, 12) and
   ``avg_pool_backward`` global over (64, 60, 6, 6), post-ReLU, bit for
   bit, timed the same way.
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
      logits at batch 1, at its input size (299 for the inception v3/v4/
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
13. BASELINE configs 2 and 3 from files (kept for phase 14), f32 with
   TF32 off:
   a. 320 ImageNet-like records written from ``--seed`` through the
      port's ``recordio.pack_img`` (JPEG quality 95, shorter side 256,
      longer 256-384, 1000 labels, a class's smooth pattern plus noise)
      with a ``.idx``; the iterators alone in images/s (``ImageIter``, and
      ``ImageRecordIter(ctx=gpu(0))`` at ``preprocess_threads`` 1 and 4);
      ResNet-50 (``models/resnet.py``, 1000 classes) through
      ``Module.fit`` for one epoch of 10 batches of 32 at
      ``train_imagenet.py``'s settings (SGD lr 0.1, momentum 0.9, wd
      1e-4), fed (i) by ``common/data.py:get_rec_iter``'s ``ImageIter``
      call and (ii) by MXNet 1.0's ``ImageRecordIter(preprocess_threads=
      4, ctx=gpu(0))``: the fused step carries each fit, 102
      ``bn_channel_sums``, 1 max- and 1 avg-pool backward a step, ms per
      step, images/s and the step's wait on ``next()``, a profiled
      iteration of run (ii) in a process of its own, which 13b's profile
      shares once the CIFAR files exist (``--file-profiles``, its device
      launches equal to the replay's); the native reader
      and engine were the ones used; the first 3 batches on the card
      equal the host's at 4 and 1 threads bit for bit; the first 3 steps
      against the host by phase 4's rule, each from the host run's state
      before it;
   b. CIFAR-10's python batches written from ``--seed`` (25,000 + 10,000
      images of learnable class patterns: half the training set), then ``examples/gluon/
      image_classification.py``'s loop: ``gluon.data.vision.CIFAR10``
      -> ``transform_first(Compose([ToTensor(), Normalize(...)]))`` ->
      ``DataLoader(128, shuffle, last_batch="discard")``, hybridized
      ``resnet18_v1`` thumbnail, ``Trainer("sgd", lr 0.1, momentum 0.9,
      wd 1e-4)``, one epoch of 195 steps: ms per step and images/s, the
      loader's time apart, train accuracy above chance, 38
      ``bn_channel_sums`` and 1 ``avg_pool_backward`` a step, a profiled
      iteration's busy share in the process of 13a's profile
      (``--file-profiles``), the first 3 steps against the host by phase
      4's rule,
      each from the host run's state before it (a step in which a ReLU
      unit flips between card and host held to 5e-2);
   c. the deterministic image ops through ``check_consistency`` over
      [cpu(0), gpu(0)] at (128, 3, 32, 32) / (128, 32, 32, 3) and HWC
      (224, 224, 3) within 1e-6; the random ones by their moments over
      5,000 draws of a 2x2 image (6 standard errors).
14. Data input through ``mx.io_pipeline`` and detection data, f32 with
   TF32 off, over phase 13's files:
   a. BASELINE config 2's ResNet-50 (13a's symbol and settings) through
      ``Module.fit(train_data=Pipeline(...))``: ``RecordFileSource`` over
      13a's records, ``ImageRecordDecoder`` with a random 224 crop, a
      random mirror and ImageNet's mean and std, shuffled from ``--seed``;
      one epoch of 10 batches of 32 with 4 thread workers, then one with
      4 spawn-process workers.  The host batches of both modes bit for bit
      the 1-worker run's; every batch the steps read on the card bit for
      bit its host batch; 102 ``bn_channel_sums``, 1 max- and 1 avg-pool
      backward a step; ms per step and the wait on ``next()`` beside 13a's
      ``ImageRecordIter`` x4; fit closed the adapter it made (no
      io_pipeline thread or worker process left); one step against the
      host by phase 4's rule;
   b. 512 JPEG records at PASCAL VOC's sizes (500x375, 500x333, 375x500,
      500x366) with 1-8 boxes each in im2rec's detection layout, through
      ``ImageDetIter(batch_size=32, data_shape=(3, 300, 300))`` with
      ``CreateDetAugmenter(rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
      mean=True, std=True)`` (MXNet 1.0's ``example/ssd/train.py``) into
      ``DevicePrefetchIter(ctx=gpu(0))``: every live box in [0, 1] with
      x2 > x1 and y2 > y1, padding rows -1, every batch on the card bit
      for bit its host batch, images/s;
   c. ``save_checkpoint`` of 14a's trained model to a registered
      ``mem://`` scheme, ``load_checkpoint`` into a new Module on gpu(0):
      its predict outputs on one batch bit for bit the trained module's.
15. BASELINE config 5 on one card, data parallelism through the KVStore,
   f32 with TF32 off, inputs from ``--seed``:
   a. ResNet-50 (13a's symbol and ``train_imagenet.py``'s settings) through
      ``Module(context=[gpu(0), gpu(0)]).fit`` at batch 64 (32 a context)
      over an ``NDArrayIter`` of random images, 8 steps with
      ``kvstore='tpu_ici'`` (its SGD a subclass overriding ``update``
      alone, which the fused step's gating refuses, so that this run
      keeps measuring the general path: the store's reduction and the
      Updater; phase 18 runs the fused dp step) and 8 with
      ``'device'``: per step the ms, the
      store calls' span, the launches (the single-context path's,
      twice) and both contexts' weights bit for bit; a profiled step's
      busy share of each; then ``'device'`` with 2-bit compression for 4
      steps, the first push's codes on the card bit for bit the host
      quantizer's and the loss finite; the first 3 steps of each store
      against the host's two-context Module by phase 4's rule;
   b. two processes on gpu(0) started by ``tools/launch.py`` (this script
      with ``--dist-child``), each ``Module(context=gpu(0))`` at batch 32
      with ``kvstore='dist_sync'`` for 4 steps: the backend chosen (gloo:
      NCCL refuses two ranks on one card), the ranks' weights bit for bit
      after every step, each step against 15a's ``'device'`` run over the
      same images split the same way, ms per step and the all-reduces'
      ms; both exit 0, nothing left alive, the group killed past a hard
      timeout;
   c. phase 13b's ``resnet18_v1`` thumbnail at batch 128 over the CIFAR-10
      files through ``split_and_load`` over [gpu(0), gpu(0)] and
      ``Trainer(kvstore='device')``, hybridized, 4 steps: ms per step,
      launches, both contexts' weights bit for bit; the first 3 steps
      against the host's two contexts by phase 4's rule.
16. The mesh layer (``mx.parallel``) on one card, f32 with TF32 off,
   inputs from ``--seed``:
   a. the JAX package's multichip LM (``__graft_entry__.py:210-286``:
      embedding, causal ring self-attention over sp, a GPipe FFN stack
      over pp, a top-1 MoE over ep, a tp-split output projection) at
      GPT-2 small's widths (vocab 50257, width 768, 12 heads, 1024
      tokens, FFN 3072, 2 stages, 8 experts at capacity 1.25), batch 8,
      ``n_micro = 2*dp``, through ``ShardedTrainStep`` (SGD lr 0.01,
      momentum 0.9) with the dry-run's ``param_spec``, 4 steps on each of
      two meshes of 8 x gpu(0), ``dp=2, pp=2, ep=2`` and ``dp=2, sp=2,
      tp=2``: the first 2 steps (loss and every parameter's update)
      against a one-position mesh over [gpu(0)] by phase 4's rule (the
      floor: that run with the embedding moved by 1e-7), whose first step
      is held to the host's one position the same way; ms per step, the
      collectives' count and span a step by kind, one profiled step's
      busy share, peak memory;
   b. causal ``ring_attention`` at [8, 1024, 12, 64] over sp=4 positions
      against the flash kernel on the same q/k/v, both against the plain
      attention at phase 2's limits, each timed;
   c. the LM without the pp/ep/sp primitives over ``dp=4`` positions:
      the monolithic path and the overlap path at
      ``MXNET_TPU_COMM_BUCKET_MB=25`` from one state for 3 steps by phase
      4's rule, one all-reduce a bucket; then 2-bit at threshold 0.5 for 4
      steps, and again at the threshold about a tenth of the first
      bucket's values reach (no value of these gradients reaches 0.5, so
      there every code is 0): the first bucket's codes on the card bit
      for bit the host quantizer's and every loss finite; each variant's
      ms per step, its collectives' span and ``reduce_buckets``' span.
17. The mesh Modules on one card, f32 with TF32 off, inputs from
   ``--seed``:
   a. BASELINE config 5's ResNet-50 v2 (15a's symbol, ``train_imagenet.
      py``'s SGD) at batch 32 through ``mx.mod.ShardedModule`` on
      ``create_mesh(dp=2, tp=2, devices=[gpu(0)] * 4)``, ``dp_mode``
      "split" (each dp group its 16 rows, BatchNorm's channel sums
      psum'd over the groups), 5 steps: the first 2 (loss, every
      parameter's and moving statistic's update) against a plain
      ``Module`` on gpu(0) at batch 32 from the same state by phase 4's
      rule (the floor: that run with the images moved by 1e-7), and
      against ``ShardedModule`` on a one-position mesh; the first step
      against the host's one-position run; ms per step, a profiled step's
      busy share, peak memory, the collectives' count and span a step
      (BatchNorm psums, gradient psums, tp all-gathers), the launches a
      step (the single-context path's, twice);
   b. a stack of 6 GPT-2-small blocks (pre-LN as ``transformer_lm_
      symbol`` writes them: LN, causal ``multi_head_attention`` with 12
      heads, +x, LN, exact-GELU FFN to 3072, +x) through
      ``mx.mod.PipelineModule`` with an embedding-plus-positions stem
      and a final-LN vocab head (50257, ``SoftmaxOutput(preserve_shape=
      True)`` over per-token labels), batch 8 x 1024 tokens on
      ``create_mesh(dp=2, pp=2, devices=[gpu(0)] * 4)``, SGD lr 0.01
      momentum 0.9, 4 steps: the first 2 against a plain ``Module`` on
      gpu(0) over the graph flattened (the JAX test's oracle) by phase
      4's rule (the floor: the embedding moved by 1e-7), the first step
      against the host's one-position run; ms per step, busy share, peak
      memory, the collectives a step, and the flash kernel's LSE
      launches a step against ticks x stages a position x positions.
18. The fused data-parallel Module step and ``group2ctx`` on one card,
   inputs from ``--seed``, TF32 off:
   a. BASELINE config 5's ResNet-50 v2 (15a's symbol, ``train_imagenet.
      py``'s SGD) through ``Module(context=[gpu(0)] * 2).fit(kvstore=
      'tpu_ici')`` at batch 64 (32 a position), f32, 8 steps: the fused
      dp step engages (``dp_mode`` "split": each position its rows,
      BatchNorm's channel sums and the gradients psum'd over the
      positions), its first step eager, its second captured, then
      replays; the first 2 steps (loss, every parameter and moving
      statistic) against one context on gpu(0) at batch 64 from the same
      state by phase 4's rule (the floor: that run with the images moved
      by 1e-7), the first against the host's ``[cpu(0), cpu(1)]``; the
      replicas bit for bit after every step; ms per step of the replays
      and of the same step with no graph, capture ms, a profiled step's
      busy share, peak memory, the collectives a step (2 a BatchNorm, 1 a
      gradient) and the launches a step (the single-context path's, once
      a position); then the same fit in bf16 with f32 masters (phase 8's
      settings), 4 steps, each held to the bf16 single-context fused
      step at batch 64 by phase 8's rule;
   b. the zoo TransformerLM at GPT-2 small's widths with a per-token
      softmax, batch 8 x 1024 over [gpu(0)] * 2, SGD lr 0.01 momentum
      0.9: the monolithic dp step and ``MXNET_TPU_COMM_BUCKET_MB=25``
      from one state for 3 steps by phase 4's rule, one all-reduce a
      bucket; 2-bit at threshold 0.5 and at about a tenth of the first
      bucket's values, the first bucket's codes bit for bit the host
      quantizer's, one all-gather a bucket; ms per step of each, the
      flash LSE launches a step (12 layers x 2 positions);
   c. MXNet 1.0's ``example/model-parallel/lstm/lstm.py`` layout: an
      embedding, a 2-layer unrolled ``mx.rnn.LSTMCell`` LM at Zaremba et
      al.'s medium widths (phase 7's LM) and its decoder, each in its own
      ``ctx_group``, bound on gpu(0) with the embedding's group on the
      host, 4 steps of SGD through ``mx.optimizer.get_updater``: every
      step's outputs and weights bit for bit the plain gpu(0) bind's, the
      embedding's weight and gradient on the host, ms per step.
19. The dense op surface on one card, TF32 off, inputs from ``--seed``:
   a. MXNet 1.0's LeNet-STN (``symbols/lenet.py`` with ``add_stn=True``:
      a localisation net of conv 30 5x5/2, relu, max pool 2x2/2, conv 60
      3x3, relu, global average pool and ``FullyConnected(6, "stn_loc",
      lr_mult 0.01)`` at the identity transform, feeding
      ``SpatialTransformer(target_shape=(28, 28))``, then LeNet) through
      ``MNISTIter`` -> ``Module.fit`` on phase 11's MNIST files, written
      again, at phase 11's settings for one epoch of 938 steps of 64, f32,
      on the fused step: 3 max- and 1 avg-pool backward a step (the
      localisation net's pools are phase 2's ``stn-loc-*`` instances),
      train accuracy at least 0.9; then the first 3 steps card against
      host by phase 4's rule, each from the host run's state, in float64
      where ReLU units flip;
   b. SSD-300's multibox head (MXNet 1.0's ``example/ssd`` VGG16-reduced
      300 settings) on a batch of 32 of phase 14's ``ImageDetIter``
      records: ``MultiBoxPrior`` over the six maps (8,732 anchors),
      ``MultiBoxTarget`` (threshold 0.5, explicit variances),
      ``MultiBoxDetection`` (nms 0.45, topk 400, threshold 0.01) of a
      seeded softmax and seeded offsets, ``box_nms`` over the decoded rows
      (MultiBoxDetection's own suppression, bit for bit) and ``box_iou``;
      against the host (the detections of 2 pictures: a differing NMS
      decision must sit within 1e-5 of the threshold, or follow one that
      does); the ``box_nms`` kernel (``csrc/box_nms.cu``) bit for bit its
      plain version on the 32 pictures, timed beside it and its bound;
   c. FlowNet-C's ``Correlation`` (4 x 256 x 48 x 64, pad 20, max
      displacement 20, stride2 2), Fast R-CNN VGG16's ``ROIPooling`` (1 x
      512 x 38 x 63, 128 ROIs, 7x7, 1/16), the ten ``linalg`` ops on 16
      SPD 512 x 512 matrices (``gelqf`` on 256 x 512), ``fft``/``ifft``
      on 64 x 4096, ``quantize``/``dequantize``, ``depth_to_space``/
      ``space_to_depth``, ``Crop``, ``smooth_l1`` and ``khatri_rao`` at
      the sizes printed: forward and backward on the card (ms), against
      the host on a part of each batch (1e-4 of the outputs' scale, 1e-3
      of the gradients'; layout ops and codes bit for bit).
20. The detection ops and sparse storage on one card, TF32 off, inputs
   from ``--seed``:
   a. Faster R-CNN VGG16 served: MXNet 1.0's ``example/rcnn``
      ``get_vgg_test(num_classes=21, num_anchors=9)`` at rcnn/config.py's
      TEST settings (a 600 x 1000 picture; anchors at scales (8, 16, 32),
      ratios (0.5, 1, 2), stride 16; 6,000 proposals before the
      suppression at 0.7, 300 after, min size 16; ROIPooling 7x7 at
      1/16; fc6/fc7 4096) with seeded weights, through
      ``Module.bind(for_training=False)`` -> ``forward``: batch 1 with
      ``Proposal``, batch 2 with ``MultiProposal``; ``rois``,
      ``cls_prob`` and ``bbox_pred`` against the port's host run of the
      same picture (a differing suppression decision must sit within
      1e-5 of 0.7, or follow one that does), the second picture's
      batch against batch 1; ms a forward and Proposal's ms; the
      suppression kernel in Proposal's mode bit for bit its plain version
      on the 6,000 sorted boxes, timed beside its bound;
   b. Deformable R-FCN's ops at published sizes (msracver/
      Deformable-ConvNets ``rfcn/symbols/resnet_v1_101_rfcn_dcn.py``):
      ``DeformableConvolution`` at res5's branch2b (1 x 512 x 38 x 63,
      offsets from a seeded 3x3 conv, 512 filters, pad 2, dilate 2, 4
      deformable groups, no bias), ``PSROIPooling`` and
      ``DeformablePSROIPooling`` (with and without offsets) on the
      1,029- and 392-channel maps over 20a's 300 ROIs, ``count_sketch``
      as compact bilinear pooling ((25,088, 512) -> 8,192) and
      ``bipartite_matching`` on (32, 50, 8,732) scores: forward and
      backward ms, against the host (1e-4 of the outputs' scale, 1e-3 of
      the gradients'; matchings bit for bit); the path's launches from
      3 forwards and backwards through ``mx.nd.contrib.
      DeformableConvolution``, one im2col a forward and none from the
      backward; the im2col kernel (``csrc/deformable_im2col.cu``) bit for
      bit its plain version, timed beside its bound and beside torch's
      ``grid_sample`` of the same column;
   c. sparse linear classification at Avazu's width (MXNet 1.0's
      ``example/sparse/linear_classification.py``, batch 8,192, over
      LIBSVM's ``avazu-app`` dimensionality of 1,000,000 features): a
      written LibSVM file of 20 batches with 15 one-valued features a
      row through ``LibSVMIter``; weight and bias in a ``'local'`` store
      on the card; ``row_sparse_pull`` of each batch's columns,
      ``sparse.dot`` forward and transposed, the logistic gradient
      ``retain``ed to those columns, ``push`` into a lazy
      ``SGD(momentum=0.9)``, then again with a lazy ``Adam``; the pull,
      retain and push under ``torch.cuda.set_sync_debug_mode("error")``;
      log loss falling, untouched rows bit for bit their initial values,
      the first 3 steps within 1e-5 of the host's; ms a step and the
      pull, dot and push spans.
21. ``Custom``, ``mx.rtc`` and the runtime telemetry on one card, TF32
   off, inputs from ``--seed``:
   a. MXNet 1.0's ``example/numpy-ops/custom_softmax.py``: the MLP
      784-128-64-10 with its numpy ``Softmax`` as ``Custom(op_type=
      'softmax')`` (need_top_grad=False) through ``Module.fit`` over
      phase 19's MNIST files (``MNISTIter(flat=True)``, batch 100) for
      one epoch at the example's SGD (lr 0.1, momentum 0.9, wd 1e-5),
      with the changes the JAX package's contract forces (ROADMAP R17):
      the label passed to ``Custom`` explicitly and ``np.asarray(
      in_data[i])`` for ``.asnumpy()``; the fused step's refusal; ms a
      step beside the same MLP with ``SoftmaxOutput`` from the same
      initial parameters; after 3 steps both within 1e-5 relative, and
      the loss falling;
   b. ``mx.rtc`` with CUDA C through NVRTC: MXNet 1.0's ``test_cuda_rtc``
      axpy at 2^26 f32 elements bit for bit its plain version (compiled
      with ``--fmad=false``), timed beside ``torch.add(alpha=)`` and its
      bytes bound; ``scale<float>``/``scale<double>`` through
      ``exports``; a row sum over (4096, 4096) with ``extern __shared__``
      memory sized by ``shared_mem=`` within 1e-5 of ``torch.sum``; the
      compile cold and cached; a compile error's log; a host context
      refused;
   c. phase 4's ResNet-50 v2 Module at batch 32 under ``mx.profiler``:
      5 general-path steps in ``all`` mode (each op's span inside its
      ``executor_forward`` span, the dump loads), 5 fused steps in
      ``symbolic`` mode (still one capture and 102/1/1 launches a step;
      the replay's ms with the profiler on and off), 10 ``fit`` steps
      whose ``StepTracker`` components cover 80-100.1% of each step
      span, with ``device.live_bytes``/``peak_bytes`` from ``torch.cuda``
      and ``Speedometer(telemetry=True)``'s gauge; the symbol zoo's LeNet
      behind ``Server(serve_http=True)`` answering 8 requests, then
      ``GET /metrics`` carrying the JAX package's metric names; in a
      child process, ``start_jax_trace``/``stop_jax_trace`` around two
      steps of a BatchNorm and pooling net, whose torch.profiler trace
      must hold the hand kernels' device events.
22. The health sentinel, the flight recorder and memprof on one card, f32
   with TF32 off, inputs from ``--seed``:
   a. phase 4's ResNet-50 v2 at batch 32 through ``Module.fit`` on the
      fused step, first with ``MXNET_TPU_HEALTH`` off (the parent's graph:
      102/1/1 launches, no ``health.*`` series), then on with
      ``MXNET_TPU_MEMPROF=1`` over 4 batches whose fourth holds a NaN
      image: each step's in-graph vector (the eager step's, then the
      replays') within 1e-5 relative of its float64 recomputation from the
      same step's outputs, gradients and masters; ``TrainingDivergedError``
      at step 3 after exactly one flight dump whose steps run 0-3; one
      plan build and one capture, whose record's graph-pool bytes equal
      the allocator's segments of the graph's pool; the replay's and the
      step's ms, device kernels and device ms a replay, off and on; then
      the general path over ``[gpu(0)] * 2`` at batch 2: each executor's
      vector against its recomputation, the module's against ``combine``;
   b. the zoo TransformerLM at GPT-2 small's widths with a per-token
      softmax through ``Module.fit`` at batch 8 x 1024, 4 steps under the
      sentinel: the first 8 of its 12 attention nodes' taps within 1e-5
      of scale x max||q|| x max||k|| recomputed in float64 from each
      node's inputs (a monitored forward from the step's weights), 12
      flash LSE launches a step; ms a step with the taps off and on;
   c. in a child process, started during 22a-b and handed its batch
      after them: ResNet-50's general-path step at twice the card's
      capacity at 22a's peak an image (at least 1,024 images) runs out of
      memory twice and through ``fit`` under the sentinel:
      ``torch.cuda.OutOfMemoryError`` each time, unchanged, after exactly
      one dump, never overwritten; the dump's memory section (program
      records, the census and its largest group, ``device_memory`` with
      the card's total as ``bytes_limit``);
   d. phase 3's GPT-2-small ``Server`` under the sentinel and memprof
      beside the symbol zoo's MLP with an inf planted in ``fc3_weight``:
      ``warmup()``'s memory section (the card's total, the headroom), 8
      finite GPT-2-small responses, 4 non-finite ones shipped and counted
      exactly (``serving.nonfinite_responses``, ``serving_nonfinite``
      notes); phase 10's paged decoder's ``KVBlockPool`` row at 8 streams
      equal to the pool's own count, gone after ``close``.
23. The ``kernels`` JSON line (each kernel's record with its launches on
   every path, phase 10's five and the MLP's with 0 of each, LeNet's with
   2 max-pool backwards a step, DCGAN's with 26 channel sums an
   iteration, phase 13's two paths, and its bf16/f16/f64, head_dim 32,
   LeNet, DCGAN, ResNet-18 and LeNet-STN instances; phase 14's paths;
   phase 15's three; phase 16's three, with 0 of each; phase 17's two;
   phase 18's four; phase 19's two; phase 20's three; phase 22's three),
   after a line of the same keys for the hand kernels with no TPU
   counterpart (``box_nms`` with its Proposal instance,
   ``deformable_im2col``), then the result line.

Exits non-zero, printing no result, when there is no CUDA device or the
package is not beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
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


def registry_value(snap, name):
    """A counter's or gauge's value in a telemetry snapshot (0 when the
    instrument was never touched)."""
    return snap.get(name, {}).get("value", 0)


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
    from mxnet_tpu_torch.observability import telemetry

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

    telemetry.reset()
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
        before = telemetry.snapshot()
        batches0 = registry_value(before, "serving.batches")
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
        after = telemetry.snapshot()
        batches = registry_value(after, "serving.batches") - batches0
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
    dispatch = telemetry.delta_snapshot(
        before.get("serving.dispatch_ms"), after["serving.dispatch_ms"])
    print("slice: dispatch ms per batch (forward + device-to-host copy): "
          "mean %.1f over %d batches, max %.1f (the registry's "
          "serving.dispatch_ms)" % (dispatch["sum"] / dispatch["count"],
                                    dispatch["count"], dispatch["max"]))
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
    from mxnet_tpu_torch.observability import telemetry

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
    telemetry.reset()
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
        snap = telemetry.snapshot()
        stats = pool.stats()
        print("decode: %d streams, %d steps in %.2f s: %.1f generated "
              "tokens/s, %.1f appended tokens/s (%.2f ms a step); pages "
              "high water %d of %d, prefix hit pages %d, copy-on-write "
              "clones %d; card %s"
              % (len(streams), steps, wall, generated / wall,
                 appended / wall, wall / steps * 1e3,
                 stats["pages_high_water"], pool.num_pages,
                 registry_value(snap, "serving.decode.prefix_hits"),
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
    from mxnet_tpu_torch.observability import telemetry
    feat = _image_shape()
    image = np.random.default_rng(seed + 50).standard_normal(
        (1,) + feat, np.float32)
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        prefix = os.path.join(tmp, "r50")
        mx.model.save_checkpoint(prefix, 1, symbol, args, auxs)
        server = mx.serving.Server(max_batch_size=1, serve_http=True)
        telemetry.reset()
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
            or "mxnet_tpu_serving_requests_total 3\n" not in prom:
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
ZOO_BATCH = 1
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


def fit_mnist(mx, seed, paths, symbol, flat, tag, start=None):
    """11b/c. ``MNISTIter`` -> ``Module(context=gpu(0)).fit`` for an epoch
    at the example's settings; the checks and numbers of the fit.
    ``start``: {name: numpy} set over the initializer's values (19a's
    ``stn_loc``).  Returns (module, the fit's kernel launches, initial
    parameters)."""
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
    if start:
        args, auxs = mod.get_params()
        args.update((k, mx.nd.array(v, ctx=mx.cpu()))
                    for k, v in start.items())
        mod.set_params(args, auxs)
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
    logits (the graph below ``SoftmaxOutput``) at batch ZOO_BATCH, at its
    input size, 1000 classes, on the card, timed, against the same forward
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


# -- phase 13: BASELINE configs 2 and 3 from files (record I/O, images,
# vision data) and the image ops on the card ------------------------------

# BASELINE config 2: examples/image-classification/train_imagenet.py at its
# settings (ResNet-50 of models/resnet.py, 1000 classes, 3x224x224, batch
# 32, SGD lr 0.1, momentum 0.9, wd 1e-4).  Cut: num_examples 1,281,167 ->
# 320 written records, one epoch of 10 batches.
REC_IMAGES = 320
REC_BATCH = 32
REC_CLASSES = 1000
REC_SHAPE = (3, 224, 224)
REC_SHORT_SIDE = 256
REC_LONG_SIDE = (256, 384)
REC_QUALITY = 95
REC_RGB_MEAN = (123.68, 116.779, 103.939)
REC_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
REC_THREADS = (1, 4)
REC_SAME_BATCHES = 3          # card against host batches, bit for bit
REC_HOST_STEPS = 3            # card against host steps (phase 4's rule)
FIT_TIMES = {}                # tag -> (ms per step, next() wait), medians
# BASELINE config 3: examples/gluon/image_classification.py at its settings
# (resnet18_v1 thumbnail, 10 classes, batch 128, SGD lr 0.1, momentum 0.9,
# wd 1e-4, hybridized).  Cut: one epoch of the example's 5, over half of
# CIFAR-10's 50,000 training images (195 steps; the rule is learnt well
# before: 0.9995 over the last 50 steps of a full epoch, PERF.md).
CIFAR_SIZES = {"train": 25000, "test": 10000}
CIFAR_BATCH = 128
CIFAR_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2023, 0.1994, 0.2010)
CIFAR_WARMUP = 5              # steps before the medians
CIFAR_LAST = 50               # steps whose accuracy must beat chance
CIFAR_MIN_ACC = 0.2           # chance is 0.1
CIFAR_HOST_STEPS = 3
CIFAR_HOST_BATCH = 8          # images of each card-vs-host step
# ResNet-18 thumbnail's train-mode BatchNorm inputs at batch 128 and its
# global 4x4 average pool (phase 13b's main path, timed in phase 2f)
RESNET18_BN_SHAPES = ((128, 64, 32, 32), (128, 128, 16, 16),
                      (128, 256, 8, 8), (128, 512, 4, 4))
RESNET18_POOL = (128, 512, 4, 4)
IMAGE_OP_DRAWS = 5000         # random image ops: draws (calls) of each
IMAGE_OP_GRAPH_CALLS = 500    # of them in one captured CUDA graph
IMAGE_OP_SIGMAS = 6.0
IMAGE_OP_TOL = 1e-6


def check_resnet18_kernels(seed):
    """Phase 2f: ``bn_channel_sums`` at ResNet-18 thumbnail's four BatchNorm
    input shapes at batch 128 (statistics and pair) and ``avg_pool_backward``
    at its global 4x4 pool (phase 13b's main path), f32, against their plain
    versions (sums within 1e-4, pooling bit for bit), timed (one call, 20
    back to back, device only) beside the library call and the bytes bound.
    Returns ([], [(kernel, instance)])."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    aten = torch.ops.aten
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 70)
    out = []
    for shape in RESNET18_BN_SHAPES:
        a = torch.randn(*shape, generator=gen, device=dev) + 0.5
        b = torch.randn(*shape, generator=gen, device=dev) + 0.5
        for pair in (None, b):
            label = "resnet18-%s-%s" % ("x".join(map(str, shape)),
                                        "stats" if pair is None else "pair")
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
            print("kernel bn_channel_sums %s: max_abs_err %.3g; one call "
                  "%.4f ms, plain %.4f ms, %s %.4f ms; 20 back to back %.4f "
                  "ms a call (library %.4f ms); device only: kernel %s, "
                  "library %s; bound %.4f ms (%s); card %s"
                  % (label, err, ms, plain_ms, "batch_norm_stats"
                     if pair is None else "batch_norm_backward_reduce",
                     lib_ms, time_ms_back_to_back(run),
                     time_ms_back_to_back(lib),
                     _device_text(device_ms_per_call(run)),
                     _device_text(device_ms_per_call(lib)), bound[0],
                     bound[1], card_line()))
            out.append(("bn_channel_sums",
                        _instance(label, err, ms, plain_ms, bound, lib_ms)))
    n, c, h, w = RESNET18_POOL
    dy = torch.randn(n, c, 1, 1, generator=gen, device=dev)
    pads = ((0, 0), (0, 0))
    div = torch.full((1, 1), 1.0 / (h * w), device=dev)  # avg over h x w
    run = lambda: K.avg_pool_backward(  # noqa: E731
        dy, div, (n, c, h, w), (h, w), (1, 1), pads)
    plain = lambda: K._plain_avg_pool_backward(  # noqa: E731
        dy, div, (n, c, h, w), (h, w), (1, 1), pads, dy.dtype)
    x = torch.empty(n, c, h, w, device=dev)
    lib = lambda: aten.avg_pool2d_backward(  # noqa: E731
        dy, x, (h, w), (1, 1), (0, 0), False, True, None)
    got, want = run(), plain()
    torch.cuda.synchronize()
    exact = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    print("kernel avg_pool_backward resnet18-global4 %s: max_abs_err %.3g "
          "(bit for bit: %s) %s" % ("x".join(map(str, RESNET18_POOL)), err,
                                    exact, "ok" if exact else "FAIL"))
    if not exact:
        raise AssertionError("avg_pool_backward disagrees with its plain "
                             "version at ResNet-18's global pool")
    ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(lib)
    bound = bytes_bound(_nbytes(dy, div) + n * c * h * w * 4)
    _report("kernel avg_pool_backward resnet18-global4", ms, plain_ms,
            lib_ms, bound)
    b2b = time_ms_back_to_back(run)
    print("kernel avg_pool_backward resnet18-global4, 20 calls back to back: "
          "%.4f ms a call (%.1f%% of the bound), library %.4f ms; device "
          "only: kernel %s, library %s"
          % (b2b, 100.0 * bound[0] / b2b, time_ms_back_to_back(lib),
             _device_text(device_ms_per_call(run)),
             _device_text(device_ms_per_call(lib))))
    out.append(("avg_pool_backward",
                _instance("resnet18-global4", err, ms, plain_ms, bound,
                          lib_ms)))
    return [], out


def _class_pattern(label, h, w, rng_noise):
    """A smooth pattern of class ``label`` (its frequencies, phase and
    colours drawn from the label) at h x w, plus noise, as BGR uint8."""
    r = np.random.RandomState(label)
    fy, fx = r.uniform(0.5, 4.0, 2)
    phase = r.uniform(0, 2 * np.pi, 3)
    colors = r.uniform(40, 215, 3)
    y = np.linspace(0, 2 * np.pi, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 2 * np.pi, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for ch in range(3):
        img[:, :, ch] = colors[ch] + 40 * np.sin(fy * y + fx * x
                                                 + phase[ch])
    img += rng_noise.normal(0, 12, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_imagenet_rec(mx, root, seed):
    """REC_IMAGES ImageNet-like records from ``seed`` through the port's
    ``recordio.pack_img`` (JPEG quality 95) into ``root/train.rec`` with
    its ``.idx``: shorter side 256, longer side 256-384, 1000 labels, each
    image its class's smooth pattern plus noise.  Returns (rec, idx,
    labels)."""
    rng = np.random.RandomState(seed + 80)
    rec, idx = os.path.join(root, "train.rec"), os.path.join(root,
                                                             "train.idx")
    labels = rng.randint(0, REC_CLASSES, REC_IMAGES)
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i, label in enumerate(labels):
        long_side = rng.randint(REC_LONG_SIDE[0], REC_LONG_SIDE[1] + 1)
        h, wd = (REC_SHORT_SIDE, long_side) if rng.rand() < 0.5 \
            else (long_side, REC_SHORT_SIDE)
        img = _class_pattern(int(label), h, wd, rng)
        w.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(label), i, 0), img,
            quality=REC_QUALITY))
    w.close()
    return rec, idx, labels


class TimedIter:
    """An iterator that passes ``base``'s batches on and keeps the host time
    each ``next()`` took (the training loop's wait for its data)."""

    def __init__(self, base):
        self.base = base
        self.waits = []
        self.provide_data = base.provide_data
        self.provide_label = base.provide_label
        self.batch_size = getattr(base, "batch_size", None)

    def __iter__(self):
        return self

    def reset(self):
        self.base.reset()

    def __next__(self):
        return self.next()

    def next(self):
        t0 = time.perf_counter()
        try:
            return self.base.next()
        finally:
            self.waits.append((time.perf_counter() - t0) * 1e3)


def rec_image_iter(mx, rec, seed):
    """Run (i): ``examples/image-classification/common/data.py:
    get_rec_iter``'s own call (the example's ``mean=`` without a std adds
    no normalization, in the JAX package and here alike)."""
    import random as _pyrandom
    _pyrandom.seed(seed)
    np.random.seed(seed)
    return mx.image.ImageIter(
        batch_size=REC_BATCH, data_shape=REC_SHAPE, path_imgrec=rec,
        shuffle=True, part_index=0, num_parts=1, rand_crop=True,
        rand_mirror=True, mean=np.asarray(REC_RGB_MEAN))


def rec_record_iter(mx, rec, idx, seed, threads, ctx):
    """Run (ii): MXNet 1.0's ``ImageRecordIter`` call."""
    return mx.io.ImageRecordIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=REC_SHAPE,
        batch_size=REC_BATCH, shuffle=True, rand_crop=True, rand_mirror=True,
        mean_r=REC_RGB_MEAN[0], mean_g=REC_RGB_MEAN[1],
        mean_b=REC_RGB_MEAN[2], preprocess_threads=threads, ctx=ctx,
        seed=seed)


def iterator_rate(make, tag):
    """Images/s of one pass over the iterator ``make()`` alone (every batch
    synchronized where it lands on the card)."""
    import torch
    it = make()
    n = 0
    t0 = time.perf_counter()
    for batch in it:
        batch.data[0].wait_to_read()
        n += batch.data[0].shape[0] - (batch.pad or 0)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    if hasattr(it, "close"):
        it.close()
    print("rec: iterator alone, %s: %d images in %.2f s, %.1f images/s; "
          "card %s" % (tag, n, s, n / s, card_line()))
    return n / s


def rec_fit(mx, symbol, it, seed, tag, per_step):
    """``Module(context=gpu(0)).fit`` of ``symbol`` for one epoch of ``it``
    at REC_SGD; per-step launches, ms per step, images/s and the wait on
    ``next()``.  Returns (module, initial arg and aux params, launches)."""
    import torch
    from mxnet_tpu_torch.module.fused_step import WARMUP_STEPS
    from mxnet_tpu_torch.ops import kernels as K
    timed = TimedIter(it)
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    mod.bind(timed.provide_data, timed.provide_label)
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
    marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()
    t0 = time.perf_counter()
    mod.fit(timed, num_epoch=1, eval_metric="acc", optimizer="sgd",
            optimizer_params=dict(REC_SGD), batch_end_callback=on_batch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    n = len(step_ms)
    fs = mod._fused_step
    steady = step_ms[WARMUP_STEPS + 1:]
    waits = timed.waits[WARMUP_STEPS + 1:n]
    ms = float(np.median(steady))
    wait = float(np.median(waits))
    print("%s: fit of %d batches of %d in %.2f s: ms per step (synchronized, "
          "median after the capture) %.2f, %.1f images/s; the step's wait "
          "on next() median %.2f ms, mean %.2f ms, max %.2f ms (%.1f%% of "
          "the step); the fused step carried the fit: %s; launches per "
          "step %s (all alike: %s); card %s"
          % (tag, n, REC_BATCH, fit_s, ms, REC_BATCH / ms * 1e3, wait,
             float(np.mean(waits)), float(np.max(waits)),
             100.0 * wait / ms, fs is not None and fs.captures == 1,
             step_launches[-1], all(d == per_step for d in step_launches),
             card_line()))
    if n != REC_IMAGES // REC_BATCH:
        raise AssertionError("%s: %d steps, expected %d"
                             % (tag, n, REC_IMAGES // REC_BATCH))
    if any(d != per_step for d in step_launches):
        raise AssertionError("%s: launches per step %s, expected %s"
                             % (tag, step_launches[:3], per_step))
    if fs is None or fs.captures != 1:
        raise AssertionError("%s: the fit did not run as one captured CUDA "
                             "graph a step" % tag)
    FIT_TIMES[tag] = (ms, wait)
    return mod, (arg0, aux0)


def rec_same_batches(mx, rec, idx, seed):
    """The first REC_SAME_BATCHES batches of ``ImageRecordIter`` at 4
    threads on the card, at 4 threads on the host and at 1 thread on the
    host, bit for bit (one codec ran in all three)."""
    from mxnet_tpu_torch.image import codec
    runs = {}
    for tag, threads, ctx in (("card x4", 4, mx.gpu(0)),
                              ("host x4", 4, None), ("host x1", 1, None)):
        it = rec_record_iter(mx, rec, idx, seed, threads, ctx)
        got = []
        for batch in it:
            got.append((batch.data[0].asnumpy(), batch.label[0].asnumpy(),
                        batch.data[0].context))
            if len(got) == REC_SAME_BATCHES:
                break
        it.close()
        runs[tag] = got
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for other in ("host x4", "host x1")
               for a, b in zip(runs["card x4"], runs[other]))
    print("rec: the first %d batches of ImageRecordIter on the card (on %s) "
          "and on the host at 4 and 1 threads, codec %s: bit for bit %s"
          % (REC_SAME_BATCHES, runs["card x4"][0][2], codec.backend(),
             same))
    if not same or runs["card x4"][0][2] != mx.gpu(0):
        raise AssertionError("ImageRecordIter's batches on the card differ "
                             "from the host's")
    return [b for b, _, _ in runs["host x4"]], \
        [lab for _, lab, _ in runs["host x4"]]


def teacher_forced_steps(tag, run, states, batches, seed, flips=None,
                         run64=None):
    """Phase 4's rule at each of the first steps of a training run: from
    the host run's own state before step k (``states[k]``), one training
    forward and backward of step k's batch on the card, on the host, and
    on the host with the images moved by 1e-7 (``run(where, state, x, y)``
    -> (output, {name: gradient})).  Outputs within HOST_OUT_TOL; each
    gradient within HOST_GRAD_REL or 4 times the largest gradient change
    the nudge makes on the host.  Starting each step from the host's state
    keeps the card's rounding of earlier steps out of later ones: three
    chained SGD steps at lr 0.1 of a BatchNorm net carry any rounding
    difference far past both limits.

    A ReLU unit whose input lies within f32 rounding of 0 passes its
    gradient on one device and not on the other (or on the host with and
    without the nudge, which raises the floor), and moves the gradients of
    its channel and of every layer before it.  Where a step's gradients
    differ by more than HOST_GRAD_REL, ``flips(state, x)`` counts the ReLU
    units whose output is 0 on one device and positive on the other in
    that step's forward.  With at least one, the step runs again in
    float64 on the card and on the host (``run64``, as ``run``), where
    rounding no longer decides the flipped units: every gradient must be
    within HOST_GRAD_REL there and the outputs within HOST_OUT_TOL, and
    that decides the step.  At least one step must pass in f32 by the
    limit above: an error of the card's f32 path shows in every step."""
    rng = np.random.default_rng(seed + 81)
    ok, worst_out, worst, limits = True, 0.0, (0.0, ""), []
    in64 = over = 0
    for state, (x, y) in zip(states, batches):
        nudged = (x * (1 + 1e-7 * rng.standard_normal(x.shape))).astype(
            np.float32)
        (out_c, g_c), (out_h, g_h), (_, g_n) = (
            run(where, state, data, y) for where, data in
            (("card", x), ("host", x), ("host", nudged)))
        err = np.abs(out_c - out_h)
        ok &= bool((err <= HOST_OUT_TOL["atol"]
                    + HOST_OUT_TOL["rtol"] * np.abs(out_h)).all())
        worst_out = max(worst_out, float(err.max()))
        rel = {k: _rel_l2(g_c[k], g_h[k]) for k in g_h
               if np.linalg.norm(g_h[k]) > 0}
        floor = max(_rel_l2(g_n[k], g_h[k]) for k in rel)
        limit = max(HOST_GRAD_REL, 4.0 * floor)
        k = max(rel, key=rel.get)
        note, step_ok = "", rel[k] <= limit
        over += not step_ok
        if rel[k] > HOST_GRAD_REL and flips is not None:
            n = flips(state, x)
            note = "; %d ReLU units flipped between card and host" % n
            if n:
                step_ok, text = float64_step(run64, state, x, y, rel)
                note += "; " + text
                in64 += 1
        limits.append(limit)
        worst = max(worst, (rel[k], k))
        ok &= step_ok
        print("%s: step %d: gradients relative L2 largest %.3g (%s), the "
              "host's floor %.3g, limit %.3g%s"
              % (tag, len(limits), rel[k], k, floor, limit, note))
    print("%s: %d steps card vs host, each from the host run's state before "
          "it, on its first batches (%d images each): outputs max_abs_err "
          "%.3g (atol %g rtol %g); gradients relative L2 largest %.3g (%s), "
          "limits per step %s, %d steps over them; %d steps held in "
          "float64; card %s"
          % (tag, len(states), len(batches[0][1]), worst_out,
             HOST_OUT_TOL["atol"], HOST_OUT_TOL["rtol"], worst[0], worst[1],
             ", ".join("%.3g" % v for v in limits), over, in64,
             card_line()))
    if not ok or over == len(states):
        raise AssertionError("%s: the card's training steps disagree with "
                             "the host's" % tag)


def float64_step(run64, state, x, y, rel):
    """A step of ``teacher_forced_steps`` whose f32 gradients ``rel``
    ({name: relative L2 card vs host}) exceed HOST_GRAD_REL where ReLU
    units flipped: (passes, text).  The step again in float64 on the card
    and on the host; every gradient within HOST_GRAD_REL, the outputs
    within HOST_OUT_TOL."""
    (out_c, g_c), (out_h, g_h) = (run64(where, state, x, y)
                                  for where in ("card", "host"))
    err = np.abs(out_c - out_h)
    ok = bool((err <= HOST_OUT_TOL["atol"]
               + HOST_OUT_TOL["rtol"] * np.abs(out_h)).all())
    rel64 = {k: _rel_l2(g_c[k], g_h[k]) for k in rel}
    k = max(rel64, key=rel64.get)
    above = sorted((k for k in rel if rel[k] > HOST_GRAD_REL),
                   key=rel.get)[::-1]
    ok &= rel64[k] <= HOST_GRAD_REL
    return ok, ("in float64 on both, outputs max_abs_err %.3g, gradients "
                "relative L2 largest %.3g (%s) of %d, limit %g; the %d over "
                "it in f32 (%s) there %s"
                % (err.max(), rel64[k], k, len(rel64), HOST_GRAD_REL,
                   len(above), ", ".join(above[:3]),
                   ", ".join("%.3g" % rel64[n] for n in above[:3])))


def relu_flips(mx, sym, state, x):
    """ReLU units whose output is 0 on the card and positive on the host,
    or the reverse, in a training forward of ``x`` through ``sym`` (a
    net's symbol) from the parameters ``state`` ({name: numpy})."""
    relus = type(sym)([(node, 0) for node in sym._topo()
                       if node.op_name == "Activation"
                       and node.attrs.get("act_type") == "relu"])
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        exe = relus.simple_bind(ctx, grad_req="null", data=x.shape)
        exe.copy_params_from(
            {k: mx.nd.array(state[k], ctx=ctx) for k in exe.arg_dict
             if k in state},
            {k: mx.nd.array(state[k], ctx=ctx) for k in exe.aux_dict},
            allow_extra_params=True)
        outs.append([o.asnumpy() > 0 for o in exe.forward(is_train=True,
                                                          data=x)])
    return int(sum((a != b).sum() for a, b in zip(*outs)))


def rec_host_steps(mx, symbol, arg0, aux0, images, labels, seed,
                   tag="rec"):
    """13a's card-vs-host check: the fit's initial weights (BatchNorm
    scales drawn away from 1 and 0, as phase 4 does), HOST_BATCH images of
    each of the iterator's first batches; the host trajectory through
    ``Module`` forward_backward + update at REC_SGD, then each step by
    ``teacher_forced_steps`` through bound executors."""
    rng = np.random.default_rng(seed + 82)
    arg0 = dict(arg0)
    for k, v in arg0.items():
        if k.endswith("_gamma"):
            arg0[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        elif k.endswith("_beta"):
            arg0[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    batches = [(x[:HOST_BATCH], y[:HOST_BATCH])
               for x, y in zip(images, labels)][:REC_HOST_STEPS]
    mod = mx.mod.Module(symbol, context=mx.cpu())
    mod.bind([("data", (HOST_BATCH,) + REC_SHAPE)],
             [("softmax_label", (HOST_BATCH,))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in arg0.items()},
                    aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in aux0.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(REC_SGD))
    states = []
    for x, y in batches:
        arg, aux = mod.get_params()
        states.append(({k: v.asnumpy() for k, v in arg.items()},
                       {k: v.asnumpy() for k, v in aux.items()}))
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                                             [mx.nd.array(y, ctx=mx.cpu())]))
        mod.update()
    exes = {where: symbol.simple_bind(
        ctx, grad_req={k: "write" for k in arg0},
        data=(HOST_BATCH,) + REC_SHAPE, softmax_label=(HOST_BATCH,))
        for where, ctx in (("card", mx.gpu(0)), ("host", mx.cpu()))}

    def run(where, state, x, y):
        exe = exes[where]
        ctx = mx.gpu(0) if where == "card" else mx.cpu()
        args, auxs = mx.convert.params_from_numpy(
            dict(state[0], **{"aux:" + k: v for k, v in state[1].items()}),
            ctx)
        exe.copy_params_from(args, auxs)
        exe.forward(is_train=True, data=x, softmax_label=y)
        exe.backward()
        return exe.outputs[0].asnumpy(), {k: exe.grad_dict[k].asnumpy()
                                          for k in arg0}

    teacher_forced_steps(tag, run, states, batches, seed)


def rec_profile_child(mx, seed, root):
    """``--rec-profile ROOT``: run (ii) of 13a on ``ROOT/train.rec``: 3
    steps, then one iteration (``next()`` of ``ImageRecordIter(
    preprocess_threads=4, ctx=gpu(0))`` and a replayed step) under
    torch.profiler: the busy share, and each training kernel's device
    launches, which must equal the replay's 102/1/1."""
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import kernels as K
    symbol = resnet.get_symbol(REC_CLASSES, 50, "%d,%d,%d" % REC_SHAPE)
    per_step = expected_train_launches(symbol)
    it = rec_record_iter(mx, os.path.join(root, "train.rec"),
                         os.path.join(root, "train.idx"), seed, 4, mx.gpu(0))
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    mod.init_optimizer(optimizer_params=dict(REC_SGD))

    def iteration():
        mod.forward_backward(next(it))
        mod.update()

    for _ in range(3):
        iteration()
    before = K.launch_counts()
    table = profile_run(iteration, "rec replay")
    calls = {k: K.launch_counts()[k] - before[k] for k in per_step}
    it.close()
    if mod._fused_step is None or mod._fused_step.replays < 2 \
            or calls != per_step:
        raise AssertionError("the profiled .rec step was not a replay of %s "
                             "launches: %s" % (per_step, calls))
    if table is None:
        return 0
    for name, key in HAND_SPLIT:
        n = sum(v[1] for k, v in table.items() if key in k)
        print("rec: profiled iteration: %s %d device launches, %d counted"
              % (name, n, calls[name]))
        if n != calls[name]:
            raise AssertionError("%s: %d device launches, %d counted"
                                 % (name, n, calls[name]))
    return 0


def train_imagenet_rec(mx, seed, root):
    """13a.  Returns the launches of the two fits."""
    from mxnet_tpu_torch import io_native
    from mxnet_tpu_torch.image import codec
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import kernels as K
    t0 = time.perf_counter()
    rec, idx, _ = write_imagenet_rec(mx, root, seed)
    print("rec: wrote %d records (%.1f MB, JPEG quality %d, codec %s) with "
          "the port's recordio in %.1f s; native writer used: %s"
          % (REC_IMAGES, os.path.getsize(rec) / 1e6, REC_QUALITY,
             codec.backend(), time.perf_counter() - t0,
             io_native.OPENED["writer"] > 0))
    rates = {"ImageIter (run i)": iterator_rate(
        lambda: rec_image_iter(mx, rec, seed), "ImageIter, 1 thread")}
    for threads in REC_THREADS:
        rates["ImageRecordIter x%d" % threads] = iterator_rate(
            lambda: rec_record_iter(mx, rec, idx, seed, threads, mx.gpu(0)),
            "ImageRecordIter(preprocess_threads=%d, ctx=gpu(0))" % threads)
    symbol = resnet.get_symbol(REC_CLASSES, 50, "%d,%d,%d" % REC_SHAPE)
    per_step = expected_train_launches(symbol)
    opened = dict(io_native.OPENED)
    K.reset_launch_counts()
    mod, (arg0, aux0) = rec_fit(mx, symbol, rec_image_iter(mx, rec, seed),
                                seed, "rec run (i) ImageIter", per_step)
    it = rec_record_iter(mx, rec, idx, seed, 4, mx.gpu(0))
    rec_fit(mx, symbol, it, seed, "rec run (ii) ImageRecordIter x4 gpu(0)",
            per_step)
    launches = K.launch_counts()
    it.close()
    used = {k: io_native.OPENED[k] - opened[k] for k in opened}
    print("rec: the runs' native readers %d, engines %d, native decode "
          "chain calls %d (it builds where OpenCV's headers exist: %s); "
          "launches of both fits %s"
          % (used["reader"], used["engine"], used["imgdec_calls"],
             io_native.get_imgdec_lib() is not None, launches))
    if used["reader"] < 2 or used["engine"] < 1:
        raise AssertionError("the native record reader and engine were not "
                             "the ones used (%s)" % used)
    del mod
    images, labels = rec_same_batches(mx, rec, idx, seed)
    rec_host_steps(mx, symbol, arg0, aux0, images, labels, seed)
    return launches, rates, rec


def write_cifar10(root, seed):
    """CIFAR-10's python pickle batches (``data_batch_1..5``, ``test_batch``
    of 10,000 32x32x3 images each, rows R, G, B planes) from ``seed``: each
    image its class's template (a smooth pattern) under a random
    brightness, shift and noise, so that the classes can be learnt."""
    import pickle
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    rng = np.random.RandomState(seed + 90)
    templates = np.stack([_class_pattern(c, 40, 40, np.random.RandomState(0))
                          for c in range(10)]).astype(np.float32)
    names = ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]
    per_file = (CIFAR_SIZES["train"] // 5, CIFAR_SIZES["test"])
    for name in names:
        n = per_file[1] if name == "test_batch" else per_file[0]
        labels = rng.randint(0, 10, n)
        dy, dx = rng.randint(0, 9, n), rng.randint(0, 9, n)
        rows = np.arange(32)[None, :, None] + dy[:, None, None]
        cols = np.arange(32)[None, None, :] + dx[:, None, None]
        imgs = templates[labels[:, None, None], rows, cols]  # N,32,32,3
        imgs = imgs * rng.uniform(0.7, 1.3, (n, 1, 1, 1)).astype(np.float32)
        imgs += rng.normal(0, 25, imgs.shape).astype(np.float32)
        data = np.clip(imgs, 0, 255).astype(np.uint8)[:, :, :, ::-1]  # RGB
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": np.ascontiguousarray(
                data.transpose(0, 3, 1, 2)).reshape(n, 3072),
                b"labels": [int(v) for v in labels],
                b"batch_label": name.encode()}, f, protocol=4)
    return root


def cifar_loader(mx, root):
    """The example's training loader."""
    from mxnet_tpu_torch import gluon
    t = gluon.data.vision.transforms
    transform = t.Compose([t.ToTensor(), t.Normalize(list(CIFAR_MEAN),
                                                     list(CIFAR_STD))])
    return gluon.data.DataLoader(
        gluon.data.vision.CIFAR10(root=root, train=True).transform_first(
            lambda x: transform(x)),
        batch_size=CIFAR_BATCH, shuffle=True, last_batch="discard")


def cifar_net(mx, ctx, seed, hybridize=True):
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with mx.sym.NameManager():
        net = vision.get_model("resnet18_v1", classes=10, thumbnail=True)
    mx.random.seed(seed)
    net.initialize(mx.initializer.Xavier(magnitude=2), ctx=ctx)
    if hybridize:
        net.hybridize()
    return net


def cifar_step(mx, net, trainer, loss_fn, data, label, ctx):
    """One step of the example's loop; returns the outputs."""
    from mxnet_tpu_torch import autograd
    data = data.as_in_context(ctx)
    label = label.as_in_context(ctx)
    with autograd.record():
        out = net(data)
        loss = loss_fn(out, label)
    loss.backward()
    trainer.step(data.shape[0])
    return out, label


def train_cifar(mx, seed, root):
    """13b.  Returns the epoch's launches."""
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.ops import kernels as K
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    loader = cifar_loader(mx, root)
    print("cifar: CIFAR10(root) read %d images in %.1f s"
          % (CIFAR_SIZES["train"], time.perf_counter() - t0))
    net = cifar_net(mx, ctx, seed)
    np.random.seed(seed)  # the loader's sampler draws from numpy
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(CIFAR_SGD))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    per_step, loads, steps, hits = None, [], [], []
    launches_each = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    it = iter(loader)
    t_epoch = time.perf_counter()
    while True:
        t_load = time.perf_counter()
        try:
            data, label = next(it)
        except StopIteration:
            break
        t_step = time.perf_counter()
        counts = K.launch_counts()
        out, lab = cifar_step(mx, net, trainer, loss_fn, data, label, ctx)
        metric.update([lab], [out])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        after = K.launch_counts()
        if per_step is None:
            per_step = {k: v for k, v in expected_vision_launches(
                net).items()}
        launches_each.append({k: after[k] - counts[k] for k in per_step})
        hits.append(float((out.asnumpy().argmax(1) == lab.asnumpy()).mean()))
        loads.append((t_step - t_load) * 1e3)
        steps.append((t_end - t_step) * 1e3)
    epoch_s = time.perf_counter() - t_epoch
    launches = K.launch_counts()
    n = len(steps)
    step_ms = float(np.median(steps[CIFAR_WARMUP:]))
    load_ms = float(np.median(loads[CIFAR_WARMUP:]))
    last = float(np.mean(hits[-CIFAR_LAST:]))
    print("cifar: one epoch of %d steps of %d in %.2f s (%.1f images/s end "
          "to end): step (synchronized, median after %d) %.2f ms, %.1f "
          "images/s; loading a batch (DataLoader next(): per-sample "
          "ToTensor/Normalize, stack) median %.2f ms, mean %.2f ms (%.1f%% "
          "of a step and its load); train accuracy over the epoch %.4f, "
          "over its last %d steps %.4f (at least %.2f; chance 0.1); "
          "launches per step %s (all alike: %s); card %s"
          % (n, CIFAR_BATCH, epoch_s, n * CIFAR_BATCH / epoch_s,
             CIFAR_WARMUP, step_ms, CIFAR_BATCH / step_ms * 1e3, load_ms,
             float(np.mean(loads[CIFAR_WARMUP:])),
             100.0 * load_ms / (load_ms + step_ms), metric.get()[1],
             CIFAR_LAST, last, CIFAR_MIN_ACC, launches_each[-1],
             all(d == per_step for d in launches_each), card_line()))
    if n != CIFAR_SIZES["train"] // CIFAR_BATCH:
        raise AssertionError("cifar: %d steps, expected %d"
                             % (n, CIFAR_SIZES["train"] // CIFAR_BATCH))
    if any(d != per_step for d in launches_each):
        raise AssertionError("cifar: launches per step %s, expected %s"
                             % (launches_each[:3], per_step))
    if not last >= CIFAR_MIN_ACC:
        raise AssertionError("cifar: train accuracy %.4f over the last %d "
                             "steps, not above chance" % (last, CIFAR_LAST))
    file_profiles_apart(seed, os.path.dirname(root))
    cifar_host_steps(mx, seed, root)
    return launches


def file_profiles_apart(seed, root):
    """Runs ``rec_profile_child`` on ``ROOT/train.rec`` and then
    ``cifar_profile_child`` on ``ROOT/cifar`` in one process of its own (as
    phase 6 does: late in this process torch.profiler loses kernel
    records; one process start serves both) and passes its lines on."""
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--file-profiles", root], capture_output=True, text=True,
        timeout=900)
    sys.stdout.write(child.stdout)
    if child.returncode != 0:
        sys.stdout.write(child.stderr[-4000:])
        raise AssertionError("the profiled .rec and CIFAR steps failed "
                             "(exit %d)" % child.returncode)
    print("rec, cifar: profiled steps in one process of their own: %.1f s"
          % (time.perf_counter() - t0))


def file_profiles_child(mx, seed, root):
    """``--file-profiles ROOT``: 13a's profiled replay, then 13b's
    profiled iteration."""
    rc = rec_profile_child(mx, seed, root)
    return rc or cifar_profile_child(mx, seed, os.path.join(root, "cifar"))


def cifar_profile_child(mx, seed, root):
    """``--cifar-profile ROOT``: phase 13b's loop on the written files, 5
    warm-up iterations, then one iteration (the loader's next() and the
    step) under torch.profiler: the device's busy share of the iteration,
    device time by kernel group, and the hand-written kernels' device
    launches, which must equal their wrapper calls."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.ops import kernels as K
    ctx = mx.gpu(0)
    net = cifar_net(mx, ctx, seed)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(CIFAR_SGD))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    it = iter(cifar_loader(mx, root))

    def iteration():
        data, label = next(it)
        cifar_step(mx, net, trainer, loss_fn, data, label, ctx)

    for _ in range(CIFAR_WARMUP):
        iteration()
    before = K.launch_counts()
    table = profile_run(iteration, "cifar")
    calls = {k: K.launch_counts()[k] - before[k]
             for k in ("bn_channel_sums", "avg_pool_backward")}
    if table is None:
        return 0
    for name, key in HAND_SPLIT:
        if name not in calls:
            continue
        n = sum(v[1] for k, v in table.items() if key in k)
        print("cifar: profiled iteration: %s %d device launches, %d wrapper "
              "calls" % (name, n, calls[name]))
        if n != calls[name]:
            raise AssertionError("%s: %d device launches, %d wrapper calls"
                                 % (name, n, calls[name]))
    return 0


def cifar_host_steps(mx, seed, root):
    """13b's card-vs-host check: one set of numpy weights (He-normal
    convolutions, BatchNorm scales near 1 and 0) through ``convert.
    set_gluon_params``, CIFAR_HOST_BATCH images of each of the loader's
    first batches; the host trajectory through ``Trainer`` at CIFAR_SGD,
    then each step by ``teacher_forced_steps``, with float64 copies of
    the card's and the host's nets for a step where ReLU units flip."""
    from mxnet_tpu_torch import autograd, gluon
    np.random.seed(seed)
    batches = []
    with mx.cpu():
        for data, label in cifar_loader(mx, root):
            batches.append((data.asnumpy()[:CIFAR_HOST_BATCH],
                            label.asnumpy()[:CIFAR_HOST_BATCH]))
            if len(batches) == CIFAR_HOST_STEPS:
                break
    rng = np.random.RandomState(seed + 91)
    nets = {}
    for where, ctx in (("host", mx.cpu()), ("card", mx.gpu(0)),
                       ("trajectory", mx.cpu()), ("host64", mx.cpu()),
                       ("card64", mx.gpu(0))):
        with mx.sym.NameManager():
            nets[where] = gluon.model_zoo.vision.get_model(
                "resnet18_v1", classes=10, thumbnail=True)
        nets[where].initialize(ctx=ctx)
        nets[where](mx.nd.array(batches[0][0], ctx=ctx))  # the shapes
        if where.endswith("64"):
            nets[where].cast("float64")
        nets[where].hybridize()
    weights = {}
    for name, p in nets["host"].collect_params().items():
        shape = tuple(p.shape)
        if name.endswith(("gamma", "running_var")):
            v = 1 + 0.1 * rng.uniform(-1, 1, shape)
        elif name.endswith(("beta", "running_mean", "bias")):
            v = 0.1 * rng.uniform(-1, 1, shape)
        else:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        weights[name] = v.astype(np.float32)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def forward_backward(net, ctx, x, y, dtype="float32"):
        with autograd.record():
            out = net(mx.nd.array(x, ctx=ctx, dtype=dtype))
            loss = loss_fn(out, mx.nd.array(y, ctx=ctx, dtype=dtype))
        loss.backward()
        return out.asnumpy(), {n: p.grad().asnumpy() for n, p
                               in net.collect_params().items()
                               if p.grad_req != "null"}

    traj = nets["trajectory"]
    mx.convert.set_gluon_params(traj, weights, ctx=mx.cpu())
    trainer = gluon.Trainer(traj.collect_params(), "sgd", dict(CIFAR_SGD))
    states = []
    for x, y in batches:
        states.append({n: p.data().asnumpy()
                       for n, p in traj.collect_params().items()})
        forward_backward(traj, mx.cpu(), x, y)
        trainer.step(x.shape[0])

    def run(where, state, x, y, dtype="float32"):
        ctx = mx.gpu(0) if where == "card" else mx.cpu()
        net = nets[where + ("64" if dtype == "float64" else "")]
        mx.convert.set_gluon_params(net, state, ctx=ctx)
        return forward_backward(net, ctx, x, y, dtype)

    sym = nets["host"](mx.sym.var("data"))
    teacher_forced_steps("cifar", run, states, batches, seed,
                         lambda state, x: relu_flips(mx, sym, state, x),
                         lambda where, state, x, y: run(where, state, x, y,
                                                        "float64"))


IMAGE_OP_CONSISTENCY = (  # (op, input shape, attrs)
    ("to_tensor", (224, 224, 3), {}),
    ("to_tensor", (128, 32, 32, 3), {}),
    ("normalize", (128, 3, 32, 32), {"mean": CIFAR_MEAN, "std": CIFAR_STD}),
    ("normalize", (3, 224, 224), {"mean": CIFAR_MEAN, "std": CIFAR_STD}),
    ("flip_left_right", (224, 224, 3), {}),
    ("flip_left_right", (128, 32, 32, 3), {}),
    ("flip_top_bottom", (224, 224, 3), {}),
    ("flip_top_bottom", (128, 32, 32, 3), {}),
    ("adjust_lighting", (224, 224, 3), {"alpha": (0.1, -0.2, 0.3)}),
)
_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                    [-0.5836, -0.6948, 0.4203]])
_EIGVAL = np.array([55.46, 4.794, 1.148])


def _uniform_moments(lo, hi):
    return (lo + hi) / 2.0, (hi - lo) ** 2 / 12.0


def graph_draws(name, attrs, x):
    """IMAGE_OP_DRAWS calls of the image op ``name`` on the card tensor
    ``x``, as (IMAGE_OP_DRAWS,) + x.shape numpy: its impl called
    IMAGE_OP_GRAPH_CALLS times inside one CUDA graph (the port's generator
    registered with it, as the fused train step registers it), the graph
    replayed until the draws are made.  A capture fails if the op reads a
    value back to the host."""
    import torch
    from mxnet_tpu_torch import random as prandom
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op("_image_" + name)
    kw = op.normalize_attrs(attrs)
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        op.impl(x, **kw)  # constants and allocations outside the capture
    torch.cuda.current_stream(x.device).wait_stream(side)
    calls = torch.empty((IMAGE_OP_GRAPH_CALLS,) + tuple(x.shape),
                        device=x.device)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(prandom.generator(x.device))
    with torch.cuda.graph(graph):
        for k in range(IMAGE_OP_GRAPH_CALLS):
            calls[k].copy_(op.impl(x, **kw))
    out = torch.empty((IMAGE_OP_DRAWS,) + tuple(x.shape), device=x.device)
    for r in range(IMAGE_OP_DRAWS // IMAGE_OP_GRAPH_CALLS):
        graph.replay()
        out[r * IMAGE_OP_GRAPH_CALLS:(r + 1) * IMAGE_OP_GRAPH_CALLS].copy_(
            calls)
    return out.cpu().numpy()


_LUMA = np.array([0.299, 0.587, 0.114])
_HUE_BASE = np.array([_LUMA] * 3)
_HUE_COS = np.array([[0.701, -0.587, -0.114], [-0.299, 0.413, -0.114],
                     [-0.299, -0.587, 0.886]])
_HUE_SIN = np.array([[0.168, -0.331, 0.5], [0.328, 0.035, -0.5],
                     [-0.497, 0.296, 0.201]])
_JITTER_ORDERS = ((0, 1, 2, 3), (3, 2, 1, 0), (1, 3, 0, 2), (2, 0, 3, 1))
# random_color_jitter: all four factors; then saturation and hue alone,
# which do not commute, so that the order drawn shows in the variance
JITTER_CASES = ({"brightness": 0.3, "contrast": 0.3, "saturation": 0.3,
                 "hue": 0.2},
                {"brightness": 0.0, "contrast": 0.0, "saturation": 1.0,
                 "hue": 0.5})


def plain_color_jitter(x, n, rng, brightness, contrast, saturation, hue):
    """``n`` draws of random_color_jitter of the HWC image ``x`` in numpy
    float64, from the reference's definition: brightness, contrast,
    saturation and hue factors uniform on [1 - b, 1 + b] ([-hue, hue]),
    applied in one of four orders drawn uniformly (MXNet's shuffled order,
    the JAX package's fixed set); (n,) + x.shape."""
    lo_hi = ((1 - brightness, 1 + brightness), (1 - contrast, 1 + contrast),
             (1 - saturation, 1 + saturation), (-hue, hue))
    alphas = [rng.uniform(lo, hi, n)[:, None, None, None] for lo, hi in lo_hi]
    order = rng.integers(0, 4, n)

    def gray(v):
        return (v @ _LUMA)[..., None]

    def hue_rot(v, a):
        a = a[:, 0, 0]  # (n, 1)
        t = _HUE_BASE + np.cos(a * np.pi)[:, :, None] * _HUE_COS \
            + np.sin(a * np.pi)[:, :, None] * _HUE_SIN
        return np.einsum("nhwc,ndc->nhwd", v, t)

    fns = (lambda v, a: v * a,
           lambda v, a: v * a + gray(v).mean(axis=(1, 2, 3), keepdims=True)
           * (1 - a),
           lambda v, a: v * a + gray(v) * (1 - a),
           hue_rot)
    out = np.empty((n,) + x.shape)
    for k, seq in enumerate(_JITTER_ORDERS):
        rows = order == k
        v = np.broadcast_to(x, (rows.sum(),) + x.shape).astype(np.float64)
        for i in seq:
            v = fns[i](v, alphas[i][rows])
        out[rows] = v
    return out


def image_ops_on_card(mx, seed):
    """13c.  The deterministic image ops through ``check_consistency`` over
    [cpu(0), gpu(0)] within IMAGE_OP_TOL; each random op IMAGE_OP_DRAWS
    times on a 2x2 image on the card, drawn inside a captured CUDA graph
    (``graph_draws``), its factor read off each output: mean and variance
    within IMAGE_OP_SIGMAS standard errors of the distribution's (the
    flips' coin, the uniform factors, the hue's angle, the lighting's
    normals), and the colour jitter's first pixel against as many draws of
    its plain numpy version (JITTER_CASES)."""
    import torch
    for name, shape, attrs in IMAGE_OP_CONSISTENCY:
        sym = getattr(mx.sym.image, name)(mx.sym.var("data"), **attrs)
        mx.test_utils.check_consistency(
            sym, [{"ctx": mx.cpu(0), "data": shape},
                  {"ctx": mx.gpu(0), "data": shape}], tol=IMAGE_OP_TOL)
    print("image ops: %d deterministic cases card vs host through "
          "check_consistency within %g: ok"
          % (len(IMAGE_OP_CONSISTENCY), IMAGE_OP_TOL))
    rng = np.random.RandomState(seed + 95)
    x_np = rng.uniform(10, 240, (2, 2, 3)).astype(np.float32)
    x = torch.from_numpy(x_np).cuda()
    gray = x_np.astype(np.float64) @ _LUMA
    results = []

    def z_scores(a, b=None, mean=None, var=None):
        """z of the mean and of the variance of sample ``a`` against the
        sample ``b``, or against the distribution's ``mean`` and ``var``."""
        a = np.asarray(a, np.float64)
        m4a = np.mean((a - a.mean()) ** 4) - a.var() ** 2
        if b is None:
            return (abs(a.mean() - mean) / np.sqrt(var / len(a)),
                    abs(a.var() - var) / np.sqrt(max(m4a, 1e-30) / len(a)))
        m4b = np.mean((b - b.mean()) ** 4) - b.var() ** 2
        return (abs(a.mean() - b.mean())
                / np.sqrt(a.var() / len(a) + b.var() / len(b)),
                abs(a.var() - b.var()) / np.sqrt(m4a / len(a) + m4b / len(b)))

    def gate(label, values, mean, var):
        results.append((label,) + z_scores(values, mean=mean, var=var))

    mx.random.seed(seed)
    t0 = time.perf_counter()
    o = graph_draws("random_flip_left_right", {}, x)
    gate("random_flip_left_right",
         (o == x_np[:, ::-1]).all(axis=(1, 2, 3)), 0.5, 0.25)
    o = graph_draws("random_flip_top_bottom", {}, x)
    gate("random_flip_top_bottom",
         (o == x_np[::-1]).all(axis=(1, 2, 3)), 0.5, 0.25)
    o = graph_draws("random_brightness", {"min_factor": 0.5,
                                          "max_factor": 1.5}, x)
    gate("random_brightness", o[:, 0, 0, 0] / x_np[0, 0, 0],
         *_uniform_moments(0.5, 1.5))
    o = graph_draws("random_contrast", {"min_factor": 0.6,
                                        "max_factor": 1.4}, x)
    m = gray.mean()
    gate("random_contrast", (o[:, 0, 0, 0] - m) / (x_np[0, 0, 0] - m),
         *_uniform_moments(0.6, 1.4))
    o = graph_draws("random_saturation", {"min_factor": 0.2,
                                          "max_factor": 1.8}, x)
    gate("random_saturation", (o[:, 0, 0, 0] - gray[0, 0])
         / (x_np[0, 0, 0] - gray[0, 0]), *_uniform_moments(0.2, 1.8))
    o = graph_draws("random_hue", {"min_factor": -0.4, "max_factor": 0.4}, x)
    # out = (BASE + cos(a pi) COS + sin(a pi) SIN) x: solve for cos, sin
    p0 = x_np[0, 0].astype(np.float64)
    basis = np.stack([_HUE_COS @ p0, _HUE_SIN @ p0], 1)
    cs = np.linalg.lstsq(basis, (o[:, 0, 0, :] - _HUE_BASE @ p0).T,
                         rcond=None)[0]
    gate("random_hue", np.arctan2(cs[1], cs[0]) / np.pi,
         *_uniform_moments(-0.4, 0.4))
    o = graph_draws("random_lighting", {"alpha_std": 0.5}, x)
    alphas = np.linalg.solve(_EIGVEC, (o[:, 0, 0, :] - x_np[0, 0]).T).T \
        / _EIGVAL
    for j in range(3):
        gate("random_lighting alpha[%d]" % j, alphas[:, j], 0.0, 0.25)
    for j, jitter in enumerate(JITTER_CASES):
        o = graph_draws("random_color_jitter", jitter, x)
        plain = plain_color_jitter(x_np.astype(np.float64), IMAGE_OP_DRAWS,
                                   np.random.default_rng(seed + 96 + j),
                                   **jitter)
        for c in range(3):
            results.append(("random_color_jitter case %d [0,0,%d] (card vs "
                            "plain)" % (j, c),)
                           + z_scores(o[:, 0, 0, c], plain[:, 0, 0, c]))
    bad = [r for r in results if r[1] > IMAGE_OP_SIGMAS
           or r[2] > IMAGE_OP_SIGMAS]
    print("image ops: random ops on the card, %d draws each of a 2x2 image "
          "(%d calls captured in a CUDA graph, replayed %d times) in %.1f s: "
          "%s (z of mean, z of variance; limit %g); card %s"
          % (IMAGE_OP_DRAWS, IMAGE_OP_GRAPH_CALLS,
             IMAGE_OP_DRAWS // IMAGE_OP_GRAPH_CALLS,
             time.perf_counter() - t0, "; ".join(
                 "%s %.2f/%.2f" % r for r in results), IMAGE_OP_SIGMAS,
             card_line()))
    if bad:
        raise AssertionError("random image ops off their distributions: %s"
                             % bad)


def train_from_files(mx, seed, root):
    """Phase 13, its files written under ``root``.  Returns {path:
    launches}."""
    import torch
    clock = time.perf_counter()
    paths = {}
    paths["module_resnet50_rec"], _, _ = train_imagenet_rec(mx, seed, root)
    image_ops_on_card(mx, seed)
    t0 = time.perf_counter()
    write_cifar10(os.path.join(root, "cifar"), seed)
    print("cifar: wrote data_batch_1..5 and test_batch (%d + %d images) "
          "in %.1f s" % (CIFAR_SIZES["train"], CIFAR_SIZES["test"],
                         time.perf_counter() - t0))
    paths["gluon_resnet18_cifar"] = train_cifar(
        mx, seed, os.path.join(root, "cifar"))
    torch.cuda.synchronize()
    print("phase 13 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths


# -- phase 14: BASELINE config 2 from an io_pipeline Pipeline, detection
# batches at SSD-300's input, a checkpoint over a registered URI scheme ---

# 14a: phase 13a's records and fit settings through mx.io_pipeline: 4
# workers in thread mode, then 4 spawn-process workers
PIPE_WORKERS = 4
PIPE_MODES = ("thread", "process")
PIPE_STD = (58.395, 57.12, 57.375)  # ImageNet's RGB std in pixel units
# 14b: MXNet 1.0's example/ssd/train.py data settings (ImageDetIter,
# batch 32, data_shape 300, rand_crop 0.5, rand_pad 0.5, rand_mirror,
# mean and std) over records at PASCAL VOC's image sizes with 1-8 boxes
DET_IMAGES = 512
DET_SIZES = ((500, 375), (500, 333), (375, 500), (500, 366))  # w x h
DET_BOXES = (1, 8)
DET_CLASSES = 20
DET_BATCH = 32
DET_SHAPE = (3, 300, 300)
DET_QUALITY = 90


def _batch_digest(data, label):
    import hashlib
    h = hashlib.sha256(np.ascontiguousarray(data).tobytes())
    h.update(np.ascontiguousarray(label).tobytes())
    return h.hexdigest()


def image_pipeline(mx, rec, idx, seed, workers, mode, ctx):
    """14a's Pipeline over phase 13a's records: ``ImageRecordDecoder`` with
    a random 224 crop, a random mirror and the mean/std normalization,
    shuffled from ``seed``."""
    iop = mx.io_pipeline
    decoder = iop.ImageRecordDecoder(REC_SHAPE, rand_crop=True,
                                     rand_mirror=True, mean=REC_RGB_MEAN,
                                     std=PIPE_STD)
    return iop.Pipeline(iop.RecordFileSource(rec, idx), decoder,
                        batch_size=REC_BATCH, shuffle=True, seed=seed,
                        num_workers=workers, mode=mode, ctx=ctx)


def pipeline_host_digests(mx, rec, idx, seed, workers, mode):
    """The epoch-0 host batches of 14a's Pipeline: their digests, and the
    first batch's arrays."""
    t0 = time.perf_counter()
    with image_pipeline(mx, rec, idx, seed, workers, mode, None) as pipe:
        digests, first = [], None
        for hb in pipe.host_batches(0):
            digests.append(_batch_digest(hb.data, hb.label))
            if first is None:
                first = (hb.data, hb.label)
    s = time.perf_counter() - t0
    print("pipe: host batches at %d %s worker(s): %d batches in %.2f s "
          "(%.1f images/s, the spawn included)"
          % (workers, mode, len(digests), s, REC_IMAGES / s))
    return digests, first


def pipeline_fit(mx, symbol, pipe, seed, tag, per_step, want):
    """``Module(context=gpu(0)).fit(train_data=pipe)`` for one epoch at
    REC_SGD, ``pipe`` the raw Pipeline: ms per step, the wait on the
    adapter's ``next()`` and the launches per step as ``rec_fit`` reads
    them; every batch the steps read on the card against ``want`` (the
    host batches' digests) bit for bit; the adapter that fit made is
    closed and no io_pipeline thread or worker process is alive.  Returns
    (module, initial arg and aux params)."""
    import multiprocessing
    import torch
    from mxnet_tpu_torch.module.fused_step import WARMUP_STEPS
    from mxnet_tpu_torch.ops import kernels as K
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    mod.bind(pipe.provide_data, pipe.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    arg0, aux0 = ({k: v.asnumpy().copy() for k, v in t.items()}
                  for t in mod.get_params())
    waits, seen, adapters = [], [], []
    plain_adapt = pipe.as_dataiter

    def adapt(warm_start=True):
        it = plain_adapt(warm_start=warm_start)
        plain_next = it.next

        def timed_next():
            t0 = time.perf_counter()
            batch = plain_next()
            waits.append((time.perf_counter() - t0) * 1e3)
            # what the step reads, copied on the consumer's stream after
            # the hand-over (a device copy: no host sync in the loop)
            seen.append((batch.data[0].tensor.clone(),
                         batch.label[0].tensor.clone()))
            return batch

        it.next = timed_next
        adapters.append(it)
        return it

    pipe.as_dataiter = adapt
    step_ms, step_launches, marks = [], [], {}

    def on_batch(param):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), K.launch_counts()
        step_ms.append((now - marks["t"]) * 1e3)
        step_launches.append({k: counts[k] - marks["counts"][k]
                              for k in per_step})
        marks["t"], marks["counts"] = now, counts

    torch.cuda.synchronize()
    marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()
    t0 = time.perf_counter()
    mod.fit(pipe, num_epoch=1, eval_metric="acc", optimizer="sgd",
            optimizer_params=dict(REC_SGD), batch_end_callback=on_batch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    n = len(step_ms)
    fs = mod._fused_step
    ms = float(np.median(step_ms[WARMUP_STEPS + 1:]))
    wait = float(np.median(waits[WARMUP_STEPS + 1:n]))
    got = [_batch_digest(d.cpu().numpy(), lab.cpu().numpy())
           for d, lab in seen]
    left = [t.name for t in mx.threads.live_package_threads()
            if "io_pipeline" in t.name]
    children = multiprocessing.active_children()
    rec_ms, rec_wait = FIT_TIMES["rec run (ii) ImageRecordIter x4 gpu(0)"]
    print("%s: fit(train_data=Pipeline) of %d batches of %d in %.2f s: ms "
          "per step (synchronized, median after the capture) %.2f, %.1f "
          "images/s; the step's wait on next() median %.2f ms, mean %.2f "
          "ms, max %.2f ms (%.1f%% of the step); beside 13a's "
          "ImageRecordIter x4: %.2f ms a step, wait %.2f ms; the fused "
          "step carried the fit: %s; launches per step %s (all alike: %s); "
          "every batch on the card bit for bit its host batch: %s; the "
          "adapter closed: %s, io_pipeline threads left %s, worker "
          "processes left %d; card %s"
          % (tag, n, REC_BATCH, fit_s, ms, REC_BATCH / ms * 1e3, wait,
             float(np.mean(waits)), float(np.max(waits)), 100.0 * wait / ms,
             rec_ms, rec_wait, fs is not None and fs.captures == 1,
             step_launches[-1], all(d == per_step for d in step_launches),
             got == want, [a._closed for a in adapters], left,
             len(children), card_line()))
    if n != REC_IMAGES // REC_BATCH or len(got) != n:
        raise AssertionError("%s: %d steps over %d batches, expected %d"
                             % (tag, n, len(got), REC_IMAGES // REC_BATCH))
    if any(d != per_step for d in step_launches):
        raise AssertionError("%s: launches per step %s, expected %s"
                             % (tag, step_launches[:3], per_step))
    if fs is None or fs.captures != 1:
        raise AssertionError("%s: the fit did not run as one captured CUDA "
                             "graph a step" % tag)
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError("%s: batches %s on the card differ from the "
                             "host's" % (tag, bad[:8]))
    if len(adapters) != 1 or not adapters[0]._closed or left or children:
        raise AssertionError("%s: fit left its adapter open (%s), threads %s "
                             "or worker processes %s" % (tag, adapters, left,
                                                          children))
    return mod, (arg0, aux0)


def train_resnet50_pipeline(mx, seed, root):
    """14a.  Returns (the launches of both fits, the process-mode fit's
    module, the first host batch)."""
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import kernels as K
    rec, idx = os.path.join(root, "train.rec"), os.path.join(root,
                                                             "train.idx")
    symbol = resnet.get_symbol(REC_CLASSES, 50, "%d,%d,%d" % REC_SHAPE)
    per_step = expected_train_launches(symbol)
    want, first = pipeline_host_digests(mx, rec, idx, seed, 1, "thread")
    for mode in PIPE_MODES:
        got, _ = pipeline_host_digests(mx, rec, idx, seed, PIPE_WORKERS, mode)
        print("pipe: host batches at %d %s workers bit for bit the 1-worker "
              "run's: %s" % (PIPE_WORKERS, mode, got == want))
        if got != want:
            raise AssertionError("io_pipeline's %s-mode batches differ from "
                                 "the 1-worker run's" % mode)
    K.reset_launch_counts()
    mods = {}
    for mode in PIPE_MODES:
        pipe = image_pipeline(mx, rec, idx, seed, PIPE_WORKERS, mode,
                              mx.gpu(0))
        mods[mode] = pipeline_fit(
            mx, symbol, pipe, seed, "pipe run %s x%d gpu(0)"
            % (mode, PIPE_WORKERS), per_step, want)
    launches = K.launch_counts()
    print("pipe: launches of both fits %s" % launches)
    _, (arg0, aux0) = mods["thread"]
    rec_host_steps(mx, symbol, arg0, aux0, [first[0]], [first[1]], seed,
                   tag="pipe")
    return launches, mods["process"][0], symbol, first


def write_det_rec(mx, root, seed):
    """DET_IMAGES JPEG records at PASCAL VOC's sizes, each a smooth
    pattern with 1-8 boxes drawn on it, labelled in im2rec's detection
    layout [2, 5, (class, x1, y1, x2, y2) per box] with coordinates
    normalized to [0, 1].  Returns (rec, idx)."""
    rng = np.random.RandomState(seed + 140)
    rec, idx = os.path.join(root, "det.rec"), os.path.join(root, "det.idx")
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(DET_IMAGES):
        wd, h = DET_SIZES[rng.randint(len(DET_SIZES))]
        img = _class_pattern(int(rng.randint(DET_CLASSES)), h, wd, rng)
        boxes = []
        for _ in range(rng.randint(DET_BOXES[0], DET_BOXES[1] + 1)):
            x1, y1 = rng.uniform(0.0, 0.8, 2)
            x2 = min(1.0, x1 + rng.uniform(0.05, 0.5))
            y2 = min(1.0, y1 + rng.uniform(0.05, 0.5))
            cls = rng.randint(DET_CLASSES)
            img[int(y1 * h):int(y2 * h), int(x1 * wd):int(x2 * wd)] = \
                rng.randint(0, 256, 3)
            boxes.append([cls, x1, y1, x2, y2])
        label = np.concatenate([[2.0, 5.0], np.asarray(boxes).ravel()])
        w.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, label.astype(np.float32), i, 0), img,
            quality=DET_QUALITY))
    w.close()
    return rec, idx


def stream_detection(mx, seed, root):
    """14b: the written detection records through ``ImageDetIter`` at
    SSD-300's input and example/ssd/train.py's augmentation, uploaded by
    ``DevicePrefetchIter(ctx=gpu(0))``: images/s; every live box in [0, 1]
    with x2 > x1 and y2 > y1, every padding row -1; every batch on the card
    bit for bit its host batch."""
    import random as _pyrandom
    import torch
    t0 = time.perf_counter()
    rec, idx = write_det_rec(mx, root, seed)
    print("det: wrote %d records (%.1f MB, JPEG quality %d, %s) in %.1f s"
          % (DET_IMAGES, os.path.getsize(rec) / 1e6, DET_QUALITY,
             "/".join("%dx%d" % s for s in DET_SIZES),
             time.perf_counter() - t0))
    _pyrandom.seed(seed)
    np.random.seed(seed)
    t0 = time.perf_counter()
    it = mx.image.ImageDetIter(
        batch_size=DET_BATCH, data_shape=DET_SHAPE, path_imgrec=rec,
        path_imgidx=idx, shuffle=True, rand_crop=0.5, rand_pad=0.5,
        rand_mirror=True, mean=True, std=True)
    scan_s = time.perf_counter() - t0
    host = []
    plain_next = it.next

    def keep():
        batch = plain_next()
        host.append(batch)
        return batch

    it.next = keep
    dev = mx.io.DevicePrefetchIter(it, ctx=mx.gpu(0))
    seen = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in dev:
        seen.append((batch.data[0].context, batch.data[0].tensor.clone(),
                     batch.label[0].tensor.clone(), batch.pad or 0))
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    n = sum(DET_BATCH - pad for _, _, _, pad in seen)
    same = len(seen) == len(host) and all(
        ctx == mx.gpu(0)
        and np.array_equal(d.cpu().numpy(), hb.data[0].asnumpy())
        and np.array_equal(lab.cpu().numpy(), hb.label[0].asnumpy())
        for (ctx, d, lab, _), hb in zip(seen, host))
    labels = np.concatenate([hb.label[0].asnumpy() for hb in host])
    live = labels[labels[..., 0] >= 0]
    boxes_ok = bool(((live[:, 1:5] >= 0) & (live[:, 1:5] <= 1)).all()
                    and (live[:, 3] > live[:, 1]).all()
                    and (live[:, 4] > live[:, 2]).all())
    pad_rows = labels[labels[..., 0] < 0]
    pads_ok = bool((pad_rows == -1).all())
    print("det: ImageDetIter(batch_size=%d, data_shape=%s, rand_crop=0.5, "
          "rand_pad=0.5, rand_mirror=True, mean=True, std=True) -> "
          "DevicePrefetchIter(gpu(0)): label scan of every record %.2f s, "
          "label shape %s; %d images in %d batches in %.2f s, %.1f images/s; "
          "%d live boxes, all in [0, 1] with x2 > x1 and y2 > y1: %s; %d "
          "padding rows all -1: %s; every batch on the card bit for bit its "
          "host batch: %s; card %s"
          % (DET_BATCH, DET_SHAPE, scan_s, it.label_shape, n, len(seen), s,
             n / s, len(live), boxes_ok, len(pad_rows), pads_ok, same,
             card_line()))
    if not (same and boxes_ok and pads_ok and n >= DET_IMAGES - DET_BATCH
            and it.label_shape[0] <= DET_BOXES[1]
            and seen[0][1].shape == (DET_BATCH,) + DET_SHAPE):
        raise AssertionError("detection batches failed their checks")
    return n / s


class _MemStore:
    """A dict-backed object store for a ``mem://`` scheme: writes publish
    on close."""

    def __init__(self):
        self.blobs = {}

    def opener(self, path, mode):
        import io
        store = self
        if mode.startswith("r"):
            raw = store.blobs[path]
            return io.StringIO(raw.decode()) if mode == "r" \
                else io.BytesIO(raw)

        class Writer(io.StringIO if mode == "w" else io.BytesIO):
            def close(self):
                value = self.getvalue()
                store.blobs[path] = value.encode() if mode == "w" else value
                super().close()

        return Writer()


def checkpoint_over_mem(mx, mod, symbol, first):
    """14c: ``save_checkpoint`` of 14a's trained module to a registered
    ``mem://`` scheme, ``load_checkpoint`` into a new Module on gpu(0):
    its predict outputs on one batch equal the trained module's bit for
    bit."""
    store = _MemStore()
    prev = mx.filesystem.register_scheme("mem", store.opener)
    try:
        arg, aux = mod.get_params()
        mx.model.save_checkpoint("mem://ckpt/resnet50", 1, symbol, arg, aux)
        sym2, arg2, aux2 = mx.model.load_checkpoint("mem://ckpt/resnet50", 1)
    finally:
        if prev is None:
            mx.filesystem.unregister_scheme("mem")
        else:
            mx.filesystem.register_scheme("mem", prev)
    loaded = mx.mod.Module(sym2, context=mx.gpu(0))
    loaded.bind(mod.data_shapes, mod.label_shapes, for_training=False)
    loaded.set_params(arg2, aux2)
    batch = mx.io.DataBatch([mx.nd.array(first[0], ctx=mx.gpu(0))],
                            [mx.nd.array(first[1], ctx=mx.gpu(0))])
    outs = []
    for m in (mod, loaded):
        m.forward(batch, is_train=False)
        outs.append(m.get_outputs()[0].asnumpy())
    same = np.array_equal(outs[0], outs[1])
    print("ckpt: save_checkpoint -> mem:// (%s, %.1f MB) -> load_checkpoint "
          "-> Module(gpu(0)): %d parameters and %d aux states back, predict "
          "outputs on one batch of %d bit for bit the trained module's: %s "
          "(finite: %s)"
          % (", ".join(sorted(store.blobs)),
             sum(len(v) for v in store.blobs.values()) / 1e6, len(arg2),
             len(aux2), REC_BATCH, same, bool(np.isfinite(outs[0]).all())))
    if not same or sorted(arg2) != sorted(arg) or sorted(aux2) != sorted(aux):
        raise AssertionError("the mem:// checkpoint did not load back as "
                             "the trained module")


def train_from_pipeline(mx, seed, root):
    """Phase 14 over phase 13's files under ``root``.  Returns {path:
    launches}."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    clock = time.perf_counter()
    paths = {}
    paths["module_resnet50_pipeline"], mod, symbol, first = \
        train_resnet50_pipeline(mx, seed, root)
    K.reset_launch_counts()
    stream_detection(mx, seed, root)
    paths["image_det_ssd300"] = K.launch_counts()
    K.reset_launch_counts()
    checkpoint_over_mem(mx, mod, symbol, first)
    paths["checkpoint_mem"] = K.launch_counts()
    torch.cuda.synchronize()
    print("phase 14 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths


# -- phase 15: BASELINE config 5 on one card: data parallelism through the
# KVStore over two contexts, across two processes, and Gluon's Trainer ------

DP_CONTEXTS = 2
DP_BATCH = 64                 # 32 a context: the single-context paths' batch
DP_STEPS = 8
DP_WARMUP = 2                 # steps before the medians
DP_STORES = ("tpu_ici", "device")
DP_COMPRESSION = {"type": "2bit", "threshold": 0.5}
DP_COMPRESSED_STEPS = 4
DP_HOST_STEPS = 3
DP_HOST_PER_CONTEXT = 2       # images of each context in a card-vs-host step
DIST_STEPS = 4
DIST_TIMEOUT = 420            # seconds for both ranks; then the group is killed
GLUON_DP_STEPS = 4


def dp_data(seed):
    """DP_STEPS batches of DP_BATCH random images at ImageNet's input and
    1000-class labels, from ``seed``."""
    rng = np.random.default_rng(seed + 150)
    n = DP_BATCH * DP_STEPS
    images = rng.random((n,) + REC_SHAPE, dtype=np.float32)
    labels = rng.integers(0, REC_CLASSES, n).astype(np.float32)
    return images, labels


def dp_symbol():
    from mxnet_tpu_torch.models import resnet
    return resnet.get_symbol(REC_CLASSES, 50, "%d,%d,%d" % REC_SHAPE)


def dp_init(mx, symbol, seed):
    """The runs' initial weights (``train_imagenet.py``'s Xavier), as numpy,
    through a host Module's ``init_params``."""
    mod = mx.mod.Module(symbol, context=mx.cpu())
    mod.bind([("data", (1,) + REC_SHAPE)], [("softmax_label", (1,))],
             for_training=False)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    return tuple({k: v.asnumpy().copy() for k, v in t.items()}
                 for t in mod.get_params())


def _host_arrays(mx, table):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in table.items()}


class EventTimer:
    """The span between CUDA events recorded around each outermost call
    of the wrapped functions (a call made inside another is part of it),
    summed and cleared by ``take()`` (after a synchronize): the step's
    store calls whole, host gaps between their launches included, without
    a host sync inside the step."""

    def __init__(self):
        self.pairs = []
        self.depth = 0

    def wrap(self, fn):
        import torch

        def timed(*args, **kwargs):
            self.depth += 1
            if self.depth > 1:
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.depth -= 1
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            e1.record()
            self.pairs.append((e0, e1))
            return out
        return timed

    def take(self):
        ms = sum(a.elapsed_time(b) for a, b in self.pairs)
        self.pairs = []
        return ms


def general_path_sgd(mx, symbol, batch):
    """15a's SGD for ``'tpu_ici'``, kept on the general path PR 17
    measured: an SGD whose class overrides ``update`` alone (the same
    arithmetic: the Updater calls SGD's own), which the fused step's
    gating (the JAX package's: an optimizer without a fused update of its
    own) refuses, so the store reduces the gradients and the Updater
    applies them.  Its indices are named as Module names them."""
    class GeneralSGD(mx.optimizer.SGD):
        def update(self, index, weight, grad, state):
            super().update(index, weight, grad, state)
    names = [a for a in symbol.list_arguments()
             if a not in ("data", "softmax_label")]
    idx2name = {i * DP_CONTEXTS + k: n for i, n in enumerate(names)
                for k in range(DP_CONTEXTS)}
    return GeneralSGD(sym=symbol, param_idx2name=idx2name,
                      rescale_grad=1.0 / batch, **REC_SGD)


def replicas_equal(blocks):
    """Whether every context's copy of every array equals the first's, bit
    for bit."""
    import torch
    return all(torch.equal(b[0].tensor, c.tensor)
               for b in blocks for c in b[1:])


def dp_fit(mx, symbol, images, labels, arg0, aux0, store, steps, per_step,
           tag, compression=None, keep=0):
    """``Module(context=[gpu(0)] * 2).fit`` over ``steps`` batches of
    DP_BATCH with ``kvstore=store``: per step the ms (synchronized host
    clock), the store's span (CUDA events around each of its push, pull
    and push_pull_list calls, whole: the flattening and scatter, and the
    store's update when it updates), the kernel launches, the contexts' weights bit for bit and the training batch's
    cross-entropy.  Returns (module, {name: weights after step k} for k <
    keep, per-step cross-entropy)."""
    import torch
    from mxnet_tpu_torch import kvstore as kvs
    from mxnet_tpu_torch.kvstore import nccl
    from mxnet_tpu_torch.module.fused_step import FusedTrainStep
    from mxnet_tpu_torch.ops import kernels as K
    n = DP_BATCH * steps
    it = mx.io.NDArrayIter(images[:n], labels[:n], batch_size=DP_BATCH)
    mod = mx.mod.Module(symbol, context=[mx.gpu(0)] * DP_CONTEXTS,
                        compression_params=compression)
    timer = EventTimer()
    patched = [(cls, name, vars(cls)[name])
               for cls in (kvs.KVStore, nccl.NcclKVStore)
               for name in ("push", "pull", "push_pull", "push_pull_list")
               if name in vars(cls)]
    for owner, name, fn in patched:
        setattr(owner, name, timer.wrap(fn))
    rows, kept, marks = [], [], {}

    def on_batch(param):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), K.launch_counts()
        prob = mod.get_outputs()[0].asnumpy()
        lab = param.locals["batch"].label[0].asnumpy().astype(np.int64)
        rows.append(((now - marks["t"]) * 1e3, timer.take(),
                     {k: counts[k] - marks["counts"][k] for k in per_step},
                     replicas_equal(mod._exec_group.param_arrays),
                     float(-np.log(prob[np.arange(len(lab)), lab]
                                   + 1e-12).mean())))
        if len(kept) < keep:
            kept.append({k: v.asnumpy().copy()
                         for k, v in mod.get_params()[0].items()})
        torch.cuda.synchronize()
        marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()

    torch.cuda.synchronize()
    marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()
    try:
        mod.fit(it, num_epoch=1, kvstore=store,
                optimizer=general_path_sgd(mx, symbol, DP_BATCH)
                if store == "tpu_ici" else "sgd",
                optimizer_params=dict(REC_SGD), eval_metric="acc",
                arg_params=_host_arrays(mx, arg0),
                aux_params=_host_arrays(mx, aux0),
                batch_end_callback=on_batch)
    finally:
        for owner, name, fn in patched:
            setattr(owner, name, fn)
    torch.cuda.synchronize()
    ms = [r[0] for r in rows]
    red = [r[1] for r in rows]
    print("%s: %d steps of %d over %s, kvstore=%r (%s, update_on_kvstore "
          "%s), fused step refused: %s; ms per step %s, median after %d "
          "%.2f (%.1f images/s); the store's calls' span per step (%s; "
          "CUDA events, host gaps included) ms %s, median %.3f; launches "
          "per step %s; both contexts' weights bit "
          "for bit after every step: %s; training cross-entropy %s; card %s"
          % (tag, len(rows), DP_BATCH, [str(c) for c in mod._context], store,
             type(mod._kvstore).__name__, mod._update_on_kvstore,
             FusedTrainStep.refusal(mod), ", ".join("%.1f" % v for v in ms),
             DP_WARMUP, float(np.median(ms[DP_WARMUP:])),
             DP_BATCH / float(np.median(ms[DP_WARMUP:])) * 1e3,
             "a push and a pull a key, the store's SGD included"
             if mod._update_on_kvstore else
             "push_pull_list: flatten, sum, scatter back",
             ", ".join("%.3f" % v for v in red),
             float(np.median(red[DP_WARMUP:] or red)), rows[-1][2],
             all(r[3] for r in rows),
             ", ".join("%.4f" % r[4] for r in rows), card_line()))
    if len(rows) != steps:
        raise AssertionError("%s: %d steps, expected %d" % (tag, len(rows),
                                                           steps))
    if any(r[2] != per_step for r in rows):
        raise AssertionError("%s: launches per step %s, expected %s"
                             % (tag, [r[2] for r in rows], per_step))
    if not all(r[3] for r in rows):
        raise AssertionError("%s: the contexts' weights differ" % tag)
    if not np.all(np.isfinite([r[4] for r in rows])):
        raise AssertionError("%s: the loss is not finite" % tag)
    if mod._fused_step is not None:
        raise AssertionError("%s: a multi-context module took the fused "
                             "step" % tag)
    return mod, kept, [r[4] for r in rows]


def dp_profile(mx, mod, images, labels, tag):
    """A profiled step (forward_backward + update) of a trained module."""
    batch = mx.io.DataBatch([mx.nd.array(images[:DP_BATCH], ctx=mx.cpu())],
                            [mx.nd.array(labels[:DP_BATCH], ctx=mx.cpu())])

    def step():
        mod.forward_backward(batch)
        mod.update()
    step()
    return profile_run(step, tag)


def dp_codes_check(mx, symbol, images, labels, arg0, aux0, per_step):
    """15a's compressed run: ``'device'`` with 2-bit compression for
    DP_COMPRESSED_STEPS; the first push's codes on the card against the
    host quantizer's codes of the same gradients, bit for bit."""
    import torch
    from mxnet_tpu_torch.kvstore import gradient_compression as gc
    seen, real = [], gc.GradientCompression.quantize
    first_push = DP_CONTEXTS * len([a for a in symbol.list_arguments()
                                    if a not in ("data", "softmax_label")])

    def recording(self, key, grad):
        codes = real(self, key, grad)
        if len(seen) < first_push:
            seen.append((grad.detach().to("cpu", copy=True),
                         codes.to("cpu", copy=True)))
        return codes
    gc.GradientCompression.quantize = recording
    try:
        _, _, losses = dp_fit(mx, symbol, images, labels, arg0, aux0,
                              "device", DP_COMPRESSED_STEPS, per_step,
                              "dp2 device 2bit", compression=DP_COMPRESSION)
    finally:
        gc.GradientCompression.quantize = real
    threshold = DP_COMPRESSION["threshold"]
    same = sum(torch.equal(codes, gc.quantize_flat(
        grad, torch.zeros_like(grad), threshold)[0]) for grad, codes in seen)
    nbytes = sum(c.numel() for _, c in seen)
    print("dp2 device 2bit: the first push's codes, %d pushes of %d "
          "bytes of codes (%d gradient elements): bit for bit the host "
          "quantizer's in %d; training cross-entropy %s"
          % (len(seen), nbytes, sum(g.numel() for g, _ in seen), same,
             ", ".join("%.4f" % v for v in losses)))
    if not seen or same != len(seen):
        raise AssertionError("the card's 2-bit codes differ from the host "
                             "quantizer's")


def dp_reduced_grads(mx, mod, store):
    """Each parameter's gradient summed over the module's contexts by a
    fresh store of kind ``store`` (no updater), back into every context;
    the first context's, as numpy, after checking the others equal it."""
    names, grads = mod._param_names, mod._exec_group.grad_arrays
    kv = mx.kv.create(store)
    for name, g in zip(names, grads):
        kv.init(name, g[0])
    if hasattr(kv, "push_pull_list"):
        kv.push_pull_list(names, grads, grads)
    else:
        for name, g in zip(names, grads):
            kv.push(name, g)
            kv.pull(name, out=g)
    if not replicas_equal(grads):
        raise AssertionError("the reduced gradients differ between contexts")
    return {name: g[0].asnumpy() for name, g in zip(names, grads)}


def dp_host_steps(mx, symbol, arg0, aux0, images, labels, store, seed):
    """15a's card-vs-host check by phase 4's rule, as 13a's: DP_HOST_PER_
    CONTEXT images of each context's slice of each of the first
    DP_HOST_STEPS batches; the host trajectory through ``Module([cpu(0),
    cpu(1)])`` with the same store at the fit's settings, then each step
    from the host run's state before it, its gradients reduced over the
    two contexts by that store, on the card ([gpu(0)] * 2) and on the
    host."""
    rng = np.random.default_rng(seed + 151)
    arg0 = dict(arg0)
    for k, v in arg0.items():
        if k.endswith("_gamma"):
            arg0[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        elif k.endswith("_beta"):
            arg0[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    per, half = DP_HOST_PER_CONTEXT, DP_BATCH // DP_CONTEXTS
    batches = []
    for k in range(DP_HOST_STEPS):
        rows = np.concatenate([np.arange(per) + k * DP_BATCH + c * half
                               for c in range(DP_CONTEXTS)])
        batches.append((images[rows], labels[rows]))
    n = per * DP_CONTEXTS
    host_ctxs = [mx.cpu(c) for c in range(DP_CONTEXTS)]

    def module(ctxs):
        mod = mx.mod.Module(symbol, context=ctxs)
        mod.bind([("data", (n,) + REC_SHAPE)], [("softmax_label", (n,))])
        return mod

    traj = module(host_ctxs)
    traj.init_params(arg_params=_host_arrays(mx, arg0),
                     aux_params=_host_arrays(mx, aux0))
    traj.init_optimizer(kvstore=store,
                        optimizer=general_path_sgd(mx, symbol, n)
                        if store == "tpu_ici" else "sgd",
                        optimizer_params=dict(REC_SGD))
    if traj._fused_step is not None:
        raise AssertionError("dp2 %s: the host trajectory took the fused "
                             "step" % store)
    states = []
    for x, y in batches:
        arg, aux = traj.get_params()
        states.append({k: v.asnumpy().copy() for t in (arg, aux)
                       for k, v in t.items()})
        traj.forward_backward(mx.io.DataBatch(
            [mx.nd.array(x, ctx=mx.cpu())], [mx.nd.array(y, ctx=mx.cpu())]))
        traj.update()
    mods = {}

    def run(where, state, x, y):
        if where not in mods:
            mods[where] = module([mx.gpu(0)] * DP_CONTEXTS if where == "card"
                                 else host_ctxs)
        mod = mods[where]
        mod.init_params(
            arg_params={k: mx.nd.array(state[k], ctx=mx.cpu())
                        for k in mod._param_names},
            aux_params={k: mx.nd.array(state[k], ctx=mx.cpu())
                        for k in mod._aux_names}, force_init=True)
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(x, ctx=mx.cpu())], [mx.nd.array(y, ctx=mx.cpu())]))
        return (mod.get_outputs()[0].asnumpy(),
                dp_reduced_grads(mx, mod, store))

    teacher_forced_steps("dp2 %s" % store, run, states, batches, seed)


def dist_launch(root, seed):
    """``tools/launch.py -n 2`` running this script's ``--dist-child`` on
    each rank (the launcher's environment: coordinator address, process
    count and id, DMLC_*), in a session of its own; past DIST_TIMEOUT the
    whole group is killed and every rank's output printed.  Returns the
    output; raises unless both ranks exit 0 and nothing is left alive."""
    import signal
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    cmd = [sys.executable, os.path.join(HERE, "tools", "launch.py"), "-n",
           str(DP_CONTEXTS), "--port", str(port), "--", sys.executable,
           os.path.join(HERE, "chip_smoke.py"), "--seed", str(seed),
           "--dist-child", root]
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        print(out)
        raise AssertionError("dist: the ranks did not finish in %d s; the "
                             "process group was killed" % DIST_TIMEOUT)
    for line in out.splitlines():
        print("dist| " + line)
    alive = True
    try:
        os.killpg(proc.pid, 0)
    except ProcessLookupError:
        alive = False
    if alive:
        os.killpg(proc.pid, signal.SIGKILL)
    print("dist: launcher exit %d; processes left alive after it: %s"
          % (proc.returncode, alive))
    if proc.returncode != 0 or alive:
        raise AssertionError("dist: a rank failed or outlived the launcher")
    return out


def dist_child(mx, seed, root):
    """One rank of 15b: ``Module(context=gpu(0))`` at batch DP_BATCH / 2
    with ``kvstore='dist_sync'``, its half of each of 15a's first
    DIST_STEPS batches; writes per step its ms, the all-reduces' ms
    (synchronized host clock: gloo is synchronous), launches and a digest
    of its weights (rank 0 also the weights) under ``root``."""
    import hashlib
    import torch
    from mxnet_tpu_torch.kvstore import dist
    from mxnet_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # as 15a's 'device' run
    rank = int(os.environ["DMLC_WORKER_ID"])
    half = DP_BATCH // DP_CONTEXTS
    images = np.load(os.path.join(root, "dist_images.npy"))
    labels = np.load(os.path.join(root, "dist_labels.npy"))
    rows = np.concatenate([np.arange(half) + k * DP_BATCH + rank * half
                           for k in range(DIST_STEPS)])
    init = np.load(os.path.join(root, "dist_init.npz"))
    symbol = dp_symbol()
    aux_names = set(symbol.list_auxiliary_states())
    it = mx.io.NDArrayIter(images[rows], labels[rows], batch_size=half)
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    per_step = expected_train_launches(symbol)
    spent, real = [0.0], dist.DistKVStore._allreduce

    def timed(self, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, t)
        torch.cuda.synchronize()
        spent[0] += (time.perf_counter() - t0) * 1e3
        return out
    dist.DistKVStore._allreduce = timed
    record = {"ms": [], "reduce_ms": [], "launches": [], "digest": []}
    marks = {}

    def on_batch(param):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), K.launch_counts()
        record["ms"].append((now - marks["t"]) * 1e3)
        record["reduce_ms"].append(spent[0])
        record["launches"].append({k: counts[k] - marks["counts"][k]
                                   for k in per_step})
        weights = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        digest = hashlib.sha256()
        for k in sorted(weights):
            digest.update(weights[k].tobytes())
        record["digest"].append(digest.hexdigest())
        if rank == 0:
            np.savez(os.path.join(root, "dist_step%d.npz"
                                  % len(record["ms"])), **weights)
        spent[0] = 0.0
        torch.cuda.synchronize()
        marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()

    torch.cuda.synchronize()
    K.reset_launch_counts()
    marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()
    mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
            optimizer_params=dict(REC_SGD), eval_metric="acc",
            arg_params={k: mx.nd.array(init[k], ctx=mx.cpu())
                        for k in init.files if k not in aux_names},
            aux_params={k: mx.nd.array(init[k], ctx=mx.cpu())
                        for k in init.files if k in aux_names},
            batch_end_callback=on_batch)
    torch.cuda.synchronize()
    kv = mod._kvstore
    record.update(rank=rank, workers=kv.num_workers, backend=kv.backend,
                  update_on_kvstore=mod._update_on_kvstore,
                  total=K.launch_counts())
    with open(os.path.join(root, "dist_rank%d.json" % rank), "w") as f:
        json.dump(record, f)
    print("rank %d of %d: backend %s, ms per step %s, all-reduce ms per "
          "step %s" % (rank, kv.num_workers, kv.backend,
                       ", ".join("%.1f" % v for v in record["ms"]),
                       ", ".join("%.1f" % v for v in record["reduce_ms"])),
          flush=True)
    return 0


def train_dist(mx, seed, root, images, labels, init, want, per_step):
    """15b: two ranks on gpu(0) through ``tools/launch.py``; their weights
    bit for bit after every step, each step's weights against 15a's
    ``'device'`` run over the same images split the same way (relative
    L2 within HOST_GRAD_REL; bit for bit recorded).  Returns the ranks'
    launches, summed."""
    n = DP_BATCH * DIST_STEPS
    np.save(os.path.join(root, "dist_images.npy"), images[:n])
    np.save(os.path.join(root, "dist_labels.npy"), labels[:n])
    np.savez(os.path.join(root, "dist_init.npz"), **init)
    t0 = time.perf_counter()
    dist_launch(root, seed)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(DP_CONTEXTS):
        with open(os.path.join(root, "dist_rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    same = [len({rk["digest"][k] for rk in ranks}) == 1
            for k in range(DIST_STEPS)]
    rel, bitwise = [], []
    for k in range(DIST_STEPS):
        got = np.load(os.path.join(root, "dist_step%d.npz" % (k + 1)))
        rel.append(max(_rel_l2(got[name], want[k][name])
                       for name in want[k]))
        bitwise.append(all(np.array_equal(got[name], want[k][name])
                           for name in want[k]))
    per_rank_step = [{name: sum(rk["launches"][k][name] for rk in ranks)
                      for name in per_step} for k in range(DIST_STEPS)]
    ms = [float(np.median(rk["ms"][1:])) for rk in ranks]
    red = [float(np.median(rk["reduce_ms"][1:])) for rk in ranks]
    print("dist: 2 ranks on gpu(0), backend %s, update_on_kvstore %s, "
          "%d steps of %d a rank in %.1f s (launcher included): ms per step "
          "median after the first, by rank %s; all-reduce ms per step %s; "
          "launches per step, both ranks %s; the ranks' weights bit for bit "
          "after every step: %s; against 15a's 'device' run, each step's "
          "weights relative L2 largest %s (limit %g), bit for bit %s; "
          "card %s"
          % ("/".join(sorted({rk["backend"] for rk in ranks})),
             ranks[0]["update_on_kvstore"], DIST_STEPS, DP_BATCH // 2, wall,
             ", ".join("%.1f" % v for v in ms),
             ", ".join("%.1f" % v for v in red), per_rank_step[-1],
             all(same), ", ".join("%.3g" % v for v in rel), HOST_GRAD_REL,
             bitwise, card_line()))
    expect = {k: v * DP_CONTEXTS for k, v in per_step.items()}
    if any(rk["backend"] != "gloo" for rk in ranks):
        raise AssertionError("dist: two ranks on one card must reduce over "
                             "gloo")
    if not all(same):
        raise AssertionError("dist: the ranks' weights differ")
    if max(rel) > HOST_GRAD_REL:
        raise AssertionError("dist: the steps disagree with 15a's")
    if any(d != expect for d in per_rank_step):
        raise AssertionError("dist: launches per step %s, expected %s"
                             % (per_rank_step, expect))
    return {name: sum(rk["total"][name] for rk in ranks)
            for name in per_step}


def gluon_dp(mx, seed, root):
    """15c: BASELINE config 3's ``resnet18_v1`` thumbnail at batch
    CIFAR_BATCH over [gpu(0)] * 2 through ``split_and_load`` and
    ``Trainer(kvstore='device')``, hybridized, over phase 13's CIFAR-10
    files; per step the ms, launches and both contexts' weights bit for
    bit; then the card-vs-host check.  Returns the run's launches."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import kernels as K
    ctxs = [mx.gpu(0)] * DP_CONTEXTS
    net = cifar_net(mx, ctxs, seed)
    np.random.seed(seed)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(CIFAR_SGD),
                            kvstore="device")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    # the trained weights (each context keeps its own BatchNorm statistics)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    # phase 13b's single-context step, 38/0/1, on each context
    per_step = {"bn_channel_sums": 38 * DP_CONTEXTS, "max_pool_backward": 0,
                "avg_pool_backward": DP_CONTEXTS}
    rows = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with mx.cpu():
        batches = iter(cifar_loader(mx, os.path.join(root, "cifar")))
        for _ in range(GLUON_DP_STEPS):
            data, label = next(batches)
            torch.cuda.synchronize()
            before, t0 = K.launch_counts(), time.perf_counter()
            xs = gluon.utils.split_and_load(data.as_in_context(mx.gpu(0)),
                                            ctxs)
            ys = gluon.utils.split_and_load(label.as_in_context(mx.gpu(0)),
                                            ctxs)
            with autograd.record():
                losses = [loss_fn(net(x), y) for x, y in zip(xs, ys)]
            for loss in losses:
                loss.backward()
            trainer.step(data.shape[0])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = K.launch_counts()
            rows.append((ms, {k: after[k] - before[k] for k in per_step},
                         replicas_equal([p.list_data() for p in params]),
                         float(np.mean([l.asnumpy().mean()
                                        for l in losses]))))
    launches = K.launch_counts()
    print("gluon dp2: resnet18_v1 thumbnail, %d steps of %d over [gpu(0)] * "
          "2, Trainer(kvstore='device', update_on_kvstore %s): ms per step "
          "%s, median after the first %.2f (%.1f images/s); loss %s; "
          "launches per step %s; both contexts' weights bit for bit after "
          "every step: %s; card %s"
          % (len(rows), CIFAR_BATCH, trainer._update_on_kvstore,
             ", ".join("%.1f" % r[0] for r in rows),
             float(np.median([r[0] for r in rows[1:]])),
             CIFAR_BATCH / float(np.median([r[0] for r in rows[1:]])) * 1e3,
             ", ".join("%.4f" % r[3] for r in rows), rows[-1][1],
             all(r[2] for r in rows), card_line()))
    if any(r[1] != per_step for r in rows):
        raise AssertionError("gluon dp2: launches per step %s, expected %s"
                             % ([r[1] for r in rows], per_step))
    if not all(r[2] for r in rows) or not np.isfinite(rows[-1][3]):
        raise AssertionError("gluon dp2: the contexts' weights differ or "
                             "the loss is not finite")
    gluon_dp_host_steps(mx, seed, root)
    return launches


def gluon_dp_host_steps(mx, seed, root):
    """15c's card-vs-host check by phase 4's rule: CIFAR_HOST_BATCH images
    of each of the loader's first batches, split over two contexts; the
    host trajectory through ``Trainer(kvstore='device')`` over [cpu(0),
    cpu(1)], then each step from its state on [gpu(0)] * 2 and on the
    host, the gradients summed over the contexts by a 'device' store; a
    step where ReLU units flip again in float64."""
    from mxnet_tpu_torch import autograd, gluon
    np.random.seed(seed)
    batches = []
    with mx.cpu():
        for data, label in cifar_loader(mx, os.path.join(root, "cifar")):
            batches.append((data.asnumpy()[:CIFAR_HOST_BATCH],
                            label.asnumpy()[:CIFAR_HOST_BATCH]))
            if len(batches) == CIFAR_HOST_STEPS:
                break
    host_ctxs = [mx.cpu(c) for c in range(DP_CONTEXTS)]
    card_ctxs = [mx.gpu(0)] * DP_CONTEXTS
    rng = np.random.RandomState(seed + 152)
    nets = {}
    for where, ctxs in (("host", host_ctxs), ("card", card_ctxs),
                        ("trajectory", host_ctxs), ("host64", host_ctxs),
                        ("card64", card_ctxs)):
        with mx.sym.NameManager():
            nets[where] = gluon.model_zoo.vision.get_model(
                "resnet18_v1", classes=10, thumbnail=True)
        nets[where].initialize(ctx=ctxs)
        nets[where](mx.nd.array(batches[0][0][:1], ctx=ctxs[0]))
        if where.endswith("64"):
            nets[where].cast("float64")
        nets[where].hybridize()
    weights = {}
    for name, p in nets["host"].collect_params().items():
        shape = tuple(p.shape)
        if name.endswith(("gamma", "running_var")):
            v = 1 + 0.1 * rng.uniform(-1, 1, shape)
        elif name.endswith(("beta", "running_mean", "bias")):
            v = 0.1 * rng.uniform(-1, 1, shape)
        else:
            v = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        weights[name] = v.astype(np.float32)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def forward_backward(net, ctxs, x, y, dtype="float32"):
        xs = gluon.utils.split_and_load(mx.nd.array(x, ctx=ctxs[0],
                                                    dtype=dtype), ctxs)
        ys = gluon.utils.split_and_load(mx.nd.array(y, ctx=ctxs[0],
                                                    dtype=dtype), ctxs)
        with autograd.record():
            outs = [net(a) for a in xs]
            losses = [loss_fn(o, b) for o, b in zip(outs, ys)]
        for loss in losses:
            loss.backward()
        return np.concatenate([o.asnumpy() for o in outs])

    def set_weights(net, state, ctxs):
        for name, p in net.collect_params().items():
            p.set_data(mx.nd.array(state[name], ctx=mx.cpu(),
                                   dtype=p.list_data()[0].dtype))

    traj = nets["trajectory"]
    set_weights(traj, weights, host_ctxs)
    trainer = gluon.Trainer(traj.collect_params(), "sgd", dict(CIFAR_SGD),
                            kvstore="device")
    states = []
    for x, y in batches:
        states.append({n: p.data(host_ctxs[0]).asnumpy()
                       for n, p in traj.collect_params().items()})
        forward_backward(traj, host_ctxs, x, y)
        trainer.step(x.shape[0])

    def run(where, state, x, y, dtype="float32"):
        ctxs = card_ctxs if where == "card" else host_ctxs
        net = nets[where + ("64" if dtype == "float64" else "")]
        set_weights(net, state, ctxs)
        out = forward_backward(net, ctxs, x, y, dtype)
        trained = [(n, p) for n, p in net.collect_params().items()
                   if p.grad_req != "null"]
        kv = mx.kv.create("device")
        for i, (_, p) in enumerate(trained):
            grads = p.list_grad()
            kv.init(i, grads[0])
            kv.push(i, grads)
            kv.pull(i, out=grads)
        if not replicas_equal([p.list_grad() for _, p in trained]):
            raise AssertionError("gluon dp2: reduced gradients differ")
        return out, {n: p.list_grad()[0].asnumpy() for n, p in trained}

    sym = nets["host"](mx.sym.var("data"))
    half = CIFAR_HOST_BATCH // DP_CONTEXTS
    teacher_forced_steps(
        "gluon dp2", run, states, batches, seed,
        lambda state, x: sum(relu_flips(mx, sym, state,
                                        x[c * half:(c + 1) * half])
                             for c in range(DP_CONTEXTS)),
        lambda where, state, x, y: run(where, state, x, y, "float64"))


def train_data_parallel(mx, seed, root):
    """Phase 15.  Returns {path: launches}."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    clock = time.perf_counter()
    symbol = dp_symbol()
    single = expected_train_launches(symbol)
    per_step = {k: v * DP_CONTEXTS for k, v in single.items()}
    images, labels = dp_data(seed)
    arg0, aux0 = dp_init(mx, symbol, seed)
    print("dp2: ResNet-50 (models/resnet.py, 1000 classes, 3x224x224), "
          "Module(context=[gpu(0)] * 2) at batch %d (%d a context), SGD lr "
          "0.1 momentum 0.9 wd 1e-4, f32, TF32 off; expected launches per "
          "step %s (the single-context path's %s, twice)"
          % (DP_BATCH, DP_BATCH // DP_CONTEXTS, per_step, single))
    paths = {}
    K.reset_launch_counts()
    kept = {}
    for store in DP_STORES:
        # 15b is compared bit for bit with the 'device' run: both under
        # deterministic cuDNN
        torch.backends.cudnn.deterministic = store == "device"
        try:
            mod, kept[store], _ = dp_fit(
                mx, symbol, images, labels, arg0, aux0, store, DP_STEPS,
                per_step, "dp2 %s" % store + (" (cuDNN deterministic)"
                                              if store == "device" else ""),
                keep=DIST_STEPS if store == "device" else 0)
        finally:
            torch.backends.cudnn.deterministic = False
        launches = K.launch_counts()
        dp_profile(mx, mod, images, labels, "dp2 %s" % store)
        K.reset_launch_counts()
        K.LAUNCHES.update(launches)
        del mod
        torch.cuda.empty_cache()
    paths["module_resnet50_dp2"] = K.launch_counts()
    dp_codes_check(mx, symbol, images, labels, arg0, aux0, per_step)
    torch.cuda.empty_cache()
    for store in DP_STORES:
        dp_host_steps(mx, symbol, arg0, aux0, images, labels, store, seed)
    lap = time.perf_counter()
    paths["module_resnet50_dist2"] = train_dist(
        mx, seed, root, images, labels, dict(arg0, **aux0),
        kept["device"], single)
    print("dist: 15b in %.1f s" % (time.perf_counter() - lap))
    paths["gluon_resnet18_cifar_dp2"] = gluon_dp(mx, seed, root)
    print("phase 15 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths


# -- phase 16: the mesh layer (mx.parallel) on one card: the JAX package's
# multichip LM (__graft_entry__.py:210-286) at GPT-2 small's widths through
# ShardedTrainStep over 8-position meshes of gpu(0) --------------------------

# GPT-2 small's published widths (GPT2S above: vocab, width, heads, context,
# FFN hidden 4x the width) for the dry-run's layers; its 2 pipeline stages
# and 8 experts, top-1 at capacity 1.25; batch 8, n_micro = 2*dp, SGD lr
# 0.01 momentum 0.9, weights 0.05 * randn from --seed as the dry-run draws
# them.  Each mesh has 2 stages of FFN: a pipeline position holds stages/pp
# of them.  The output projection's columns are padded from 50257 to 50304
# (Megatron's make-vocab-size-divisible-by, 64 here) so that tp divides
# them; the pad's logits never reach the softmax.
MESH_LM = dict(vocab=50257, vocab_padded=50304, d_model=768, heads=12,
               seq=1024, hidden=3072, stages=2, experts=8, capacity=1.25,
               batch=8, lr=0.01, momentum=0.9)
MESH_LM_MESHES = (("parallel_lm_dp_pp_ep", dict(dp=2, pp=2, ep=2)),
                  ("parallel_lm_dp_sp_tp", dict(dp=2, sp=2, tp=2)))
MESH_POSITIONS = 8
MESH_DP = 2                   # both meshes' dp
MESH_LM_STEPS = 4             # a mesh's steps; the first is warm-up
MESH_LM_CHECKED = 2           # steps held to the one-position mesh
# phase 4's rule: each parameter's update (and the loss) within this
# relative L2 of the one-position mesh's, or within 4x the floor: the
# one-position run against itself with the embedding moved by 1e-7
MESH_LM_REL = 1e-3
# the dry-run's param_spec (__graft_entry__.py:219-230)
MESH_LM_SPEC = {
    "embed": (), "wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
    "wo": ("tp", None), "stage_w1": ("pp", None, None),
    "stage_w2": ("pp", None, None), "gate_w": (),
    "moe_w1": ("ep", None, None), "moe_w2": ("ep", None, None),
    "w_out": (None, "tp"),
}
RING_SHAPE = (8, 1024, 12, 64)   # B, S, H, D: 16b's causal ring attention
RING_SP = 4
DP4 = 4                          # 16c's pure data-parallel mesh
DP4_BUCKET_MB = "25"
DP4_STEPS = 3
DP4_2BIT_STEPS = 4
DP4_THRESHOLD = "0.5"
COMM_ENV = ("MXNET_TPU_COMM_BUCKET_MB", "MXNET_TPU_GRAD_COMPRESS",
            "MXNET_TPU_GRAD_COMPRESS_THRESHOLD")


def mesh_lm_data(seed, cfg=MESH_LM):
    """The LM's weights ({name: f32 numpy}, 0.05 * standard normal) and
    one batch of random token ids and targets, from ``seed``."""
    rng = np.random.default_rng(seed + 160)
    v, d, h = cfg["vocab"], cfg["d_model"], cfg["hidden"]
    s, e = cfg["stages"], cfg["experts"]
    shapes = {"embed": (v, d), "wq": (d, d), "wk": (d, d), "wv": (d, d),
              "wo": (d, d), "stage_w1": (s, d, h), "stage_w2": (s, h, d),
              "gate_w": (d, e), "moe_w1": (e, d, h), "moe_w2": (e, h, d),
              "w_out": (d, cfg["vocab_padded"])}
    params = {k: rng.standard_normal(shape, dtype=np.float32) * 0.05
              for k, shape in shapes.items()}
    batch = {k: rng.integers(0, v, (cfg["batch"], cfg["seq"]))
             for k in ("tokens", "targets")}
    return params, batch


def _ffn_stages(per):
    """The dry-run's FFN stage, ``x + relu(x @ w1) @ w2``, over ``per``
    stages in sequence."""
    import torch

    def stage(p, x):
        w1, w2 = p
        for i in range(per):
            x = x + torch.relu(x @ w1[i]) @ w2[i]
        return x
    return stage


def _nll(x, w_out, targets, vocab):
    """Mean cross-entropy of the output projection's first ``vocab``
    logits (the rest are the projection's pad)."""
    import torch
    logits = torch.einsum("bsd,dv->bsv", x, w_out)[..., :vocab]
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.gather(logp, -1, targets[..., None]))


def mesh_lm_loss(mx, mesh, moe_shards=1, cfg=MESH_LM):
    """The dry-run's ``loss_fn`` in the port: embedding, causal ring
    self-attention over sp, the GPipe FFN stack over pp (each pipeline
    position holds stages/pp of the FFN stages), the top-1 MoE over ep,
    the tp-split output projection, mean cross-entropy.

    The MoE's capacity counts each dp position's own tokens, so a mesh
    with dp=2 drops other tokens than one position routing the whole
    batch.  ``moe_shards`` > 1 routes that many slices of the batch
    apart, one after another: on one position, the function a mesh with
    dp = ``moe_shards`` computes."""
    import torch
    par = mx.parallel
    dp, pp = mesh.shape["dp"], mesh.shape["pp"]
    per = cfg["stages"] // pp

    def moe(x, params):
        return par.moe_ffn(x, params["gate_w"], params["moe_w1"],
                           params["moe_w2"], mesh=mesh,
                           capacity_factor=cfg["capacity"], batch_axis="dp")

    def loss_fn(params, b):
        x = params["embed"][b["tokens"]]                  # [b, s, d]
        x = x + par.ring_self_attention(
            x, params["wq"], params["wk"], params["wv"], params["wo"],
            num_heads=cfg["heads"], mesh=mesh, causal=True, batch_axis="dp")
        stacked = tuple(params[k].reshape((pp, per) + params[k].shape[1:])
                        for k in ("stage_w1", "stage_w2"))
        x = par.pipeline_stages(
            stacked, x, _ffn_stages(per), n_micro=2 * dp, mesh=mesh,
            params_spec=(par.P("pp"), par.P("pp")), batch_axis="dp",
            tail_spec=("sp", None))
        x = x + torch.cat([moe(part, params)
                           for part in x.chunk(moe_shards, dim=0)])
        return _nll(x, params["w_out"], b["targets"], cfg["vocab"])
    return loss_fn


def mesh_lm_step(mx, mesh, params, loss_fn, cfg=MESH_LM):
    par = mx.parallel
    return par.ShardedTrainStep(
        loss_fn, params, mesh, lr=cfg["lr"], momentum=cfg["momentum"],
        param_sharding={k: par.NamedSharding(mesh, par.P(*s))
                        for k, s in MESH_LM_SPEC.items()},
        batch_spec={k: par.NamedSharding(mesh, par.P("dp", "sp"))
                    for k in ("tokens", "targets")})


def _global_params(step):
    return {k: v.global_tensor().detach().clone()
            for k, v in step.params.items()}


def _update_gap(got, want, start):
    """Relative L2 of each parameter's update: |got - want| / |want -
    start| (the weights themselves hide any update under the start)."""
    import torch
    out = {}
    for k in want:
        moved = float(torch.linalg.vector_norm(
            want[k].double() - start[k].to(want[k].device).double()))
        out[k] = float(torch.linalg.vector_norm(
            got[k].to(want[k].device).double() - want[k].double())) \
            / max(moved, 1e-30)
    return out


def _dropped_tokens(mx, fn):
    """``fn()``, and the tokens the MoE's capacity dropped in it, summed
    over the positions' routings (each read back: a host sync a
    position)."""
    moe = mx.parallel.moe
    real, dropped = moe._route, []

    def route(*args):
        buf, kept = real(*args)
        dropped.append(int((~kept[2]).sum()))
        return buf, kept
    moe._route = route
    try:
        return fn(), sum(dropped)
    finally:
        moe._route = real


def _steps(mx, step, batch, n):
    """(losses, ms per step, snapshots of the global weights after each of
    the first MESH_LM_CHECKED steps, tokens the MoE dropped in the first
    step, whose time counts no further)."""
    import torch
    losses, ms, snaps, dropped = [], [], [], None
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            loss, dropped = _dropped_tokens(mx, lambda: step(batch))
        else:
            loss = step(batch)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i < MESH_LM_CHECKED:
            snaps.append(_global_params(step))
    return losses, ms, snaps, dropped


def mesh_lm_reference(mx, seed, params, batch):
    """The LM on a one-position mesh over [gpu(0)], its MoE routed per
    half batch as the meshes' dp=2 positions route it: MESH_LM_CHECKED
    steps, then again with the embedding moved by a relative 1e-7 (the
    floor); the first step on the host's one position.  Returns (start,
    losses, snapshots, floors {step: {name: gap}}, loss floors)."""
    import torch
    par = mx.parallel
    one = par.create_mesh(devices=[mx.gpu(0)])
    start = {k: torch.from_numpy(v).cuda() for k, v in params.items()}
    ref = mesh_lm_step(mx, one, params, mesh_lm_loss(mx, one, MESH_DP))
    losses, ms, snaps, dropped = _steps(mx, ref, batch, MESH_LM_CHECKED)
    del ref
    rng = np.random.default_rng(seed + 161)
    nudged = dict(params, embed=(params["embed"] * (1 + 1e-7 * rng.
                  standard_normal(params["embed"].shape))).astype(np.float32))
    alt = mesh_lm_step(mx, one, nudged, mesh_lm_loss(mx, one, MESH_DP))
    alt_losses, _, alt_snaps, _ = _steps(mx, alt, batch, MESH_LM_CHECKED)
    del alt
    floors = [_update_gap(a, s, start) for a, s in zip(alt_snaps, snaps)]
    loss_floor = [abs(a - b) / abs(b) for a, b in zip(alt_losses, losses)]
    print("mesh lm: one position over gpu(0): losses %s, ms per step %s, "
          "tokens the MoE dropped in step 1: %d; the floor (embedding moved "
          "by 1e-7): largest update gap %s, loss %s"
          % (", ".join("%.6f" % v for v in losses),
             ", ".join("%.1f" % v for v in ms), dropped,
             ", ".join("%.3g" % max(f.values()) for f in floors),
             ", ".join("%.3g" % v for v in loss_floor)))
    torch.cuda.empty_cache()
    # the host's one position, one step
    t0 = time.perf_counter()
    host = par.create_mesh(devices=[mx.cpu()])
    hstep = mesh_lm_step(mx, host, params, mesh_lm_loss(mx, host, MESH_DP))
    host_loss = float(hstep(batch))
    host_params = {k: v.global_tensor() for k, v in hstep.params.items()}
    del hstep
    limit = max(MESH_LM_REL, 4.0 * max(floors[0].values()))
    gap = _update_gap(snaps[0], host_params, {k: torch.from_numpy(v)
                                              for k, v in params.items()})
    loss_gap = abs(losses[0] - host_loss) / abs(host_loss)
    worst = max(gap, key=gap.get)
    print("mesh lm: step 1 on gpu(0) against the host's one position "
          "(%.1f s on the host): loss %.6f / %.6f (relative %.3g), largest "
          "update gap %.3g (%s), limit %.3g"
          % (time.perf_counter() - t0, losses[0], host_loss, loss_gap,
             gap[worst], worst, limit))
    if gap[worst] > limit or loss_gap > max(MESH_LM_REL,
                                            4.0 * loss_floor[0]):
        raise AssertionError("the LM's first step on the card disagrees "
                             "with the host's")
    return start, losses, snaps, floors, loss_floor


def mesh_lm_run(mx, tag, sizes, params, batch, reference):
    """16a on one mesh of MESH_POSITIONS x gpu(0): MESH_LM_STEPS steps,
    the first MESH_LM_CHECKED against the one-position mesh; ms per step
    (median after the first), the collectives' count and span a step by
    kind, one profiled step's busy share, peak memory."""
    import torch
    par = mx.parallel
    start, ref_losses, ref_snaps, floors, loss_floor = reference
    mesh = par.create_mesh(par.MeshSpec(**sizes),
                           devices=[mx.gpu(0)] * MESH_POSITIONS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = mesh_lm_step(mx, mesh, params, mesh_lm_loss(mx, mesh))
    losses, ms, snaps, dropped = _steps(mx, step, batch, MESH_LM_STEPS - 1)
    with par.collectives.watch(timed=True) as w:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        ms.append((time.perf_counter() - t0) * 1e3)
    spans = w.spans_ms()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i in range(MESH_LM_CHECKED):
        limit = max(MESH_LM_REL, 4.0 * max(floors[i].values()))
        gap = _update_gap(snaps[i], ref_snaps[i], start)
        worst = max(gap, key=gap.get)
        loss_gap = abs(losses[i] - ref_losses[i]) / abs(ref_losses[i])
        print("%s: step %d against the one-position mesh: loss %.6f / %.6f "
              "(relative %.3g), largest update gap %.3g (%s), median %.3g, "
              "limit %.3g; tokens the MoE dropped in step 1, summed over "
              "the positions' routings: %d"
              % (tag, i + 1, losses[i], ref_losses[i], loss_gap, gap[worst],
                 worst, float(np.median(list(gap.values()))), limit,
                 dropped))
        if gap[worst] > limit or loss_gap > max(MESH_LM_REL,
                                                4.0 * loss_floor[i]):
            raise AssertionError("%s disagrees with the one-position mesh"
                                 % tag)
    if not all(np.isfinite(losses)):
        raise AssertionError("%s: a loss is not finite" % tag)
    table = profile_run(lambda: step(batch), tag)
    print("%s: mesh %s over %d x gpu(0), %d steps: losses %s; ms per step "
          "%s, median after the first %.2f (%.0f tokens/s); collectives a "
          "step %s, their span %s ms; peak memory %.2f GB; %s; card %s"
          % (tag, dict(mesh.shape), MESH_POSITIONS, MESH_LM_STEPS,
             ", ".join("%.6f" % v for v in losses),
             ", ".join("%.1f" % v for v in ms), float(np.median(ms[1:])),
             MESH_LM["batch"] * MESH_LM["seq"] * 1e3
             / float(np.median(ms[1:])),
             {k: v for k, v in w.counts.items() if v},
             {k: round(v, 3) for k, v in spans.items() if w.counts[k]},
             peak, "busy not measured" if table is None else table.share(),
             card_line()))
    if w.counts != step.collectives:
        raise AssertionError("%s: the step's record %s, the watch %s"
                             % (tag, step.collectives, w.counts))


def ring_against_flash(mx, seed):
    """16b: causal ring attention over sp=RING_SP positions of gpu(0)
    against the port's flash kernel on the same q/k/v, both against the
    plain attention, at phase 2's limits; both timed."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    g = torch.Generator(device="cuda").manual_seed(seed + 162)
    q, k, v = (torch.randn(RING_SHAPE, generator=g, device="cuda")
               for _ in range(3))
    mesh = mx.parallel.create_mesh(sp=RING_SP, devices=[mx.gpu(0)] * RING_SP)
    scale = 1.0 / RING_SHAPE[-1] ** 0.5

    def ring():
        return mx.parallel.ring_attention(q, k, v, mesh=mesh, causal=True)

    def flash():
        return K.flash_attention(q, k, v, causal=True)

    def plain():
        return K._reference_attention(q, k, v, True, scale)
    want = plain()
    errs = {}
    for name, got in (("ring", ring()), ("flash", flash())):
        errs[name] = _agree(got, want, F32_TOL)
    errs["ring vs flash"] = _agree(ring(), flash(), F32_TOL)
    times = {name: time_ms(fn, reps=10) for name, fn in
             (("ring", ring), ("flash", flash), ("plain", plain))}
    bound, _ = flash_bound(q, RING_SHAPE[1], True, None)
    print("ring: causal ring_attention %s over sp=%d x gpu(0) against "
          "flash_attention and the plain attention: max_abs_err %s "
          "(atol %g rtol %g); one call: ring %.3f ms, flash %.4f ms, plain "
          "%.3f ms; the flash bound %.4f ms (%s); card %s"
          % (RING_SHAPE, RING_SP,
             ", ".join("%s %.3g" % (k, e) for k, (e, _) in errs.items()),
             F32_TOL["atol"], F32_TOL["rtol"], times["ring"],
             times["flash"], times["plain"], bound[0], bound[1],
             card_line()))
    if not all(ok for _, ok in errs.values()):
        raise AssertionError("ring attention disagrees with the flash "
                             "kernel or the plain attention")


def _causal_attention(q, k, v):
    import torch
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    n = q.shape[1]
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _dense_moe(x, gate_w, w1, w2):
    """Top-1 MoE with no capacity limit: each token's output is its
    expert's FFN times its gate, whatever the other tokens do."""
    import torch
    t = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(t @ gate_w, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])
    out = torch.zeros_like(t)
    for i in range(w1.shape[0]):
        (idx,) = (expert == i).nonzero(as_tuple=True)
        out = out.index_put((idx,), torch.relu(t[idx] @ w1[i]) @ w2[i])
    return (out * gate).reshape(x.shape)


def dp4_loss(cfg=MESH_LM):
    """16c's LM without the pp/ep/sp primitives: plain causal attention,
    the FFN stages in sequence, a top-1 MoE with no capacity limit (so a
    shard's loss is the mean of its tokens' and the overlap path's mean
    of the shards' is the global mean), the output projection."""
    heads = cfg["heads"]

    def loss_fn(params, b):
        x = params["embed"][b["tokens"]]
        bsz, s, d = x.shape

        def proj(w):
            return (x @ w).reshape(bsz, s, heads, d // heads)
        o = _causal_attention(proj(params["wq"]), proj(params["wk"]),
                              proj(params["wv"]))
        x = x + o.reshape(bsz, s, d) @ params["wo"]
        x = _ffn_stages(cfg["stages"])(
            (params["stage_w1"], params["stage_w2"]), x)
        x = x + _dense_moe(x, params["gate_w"], params["moe_w1"],
                           params["moe_w2"])
        return _nll(x, params["w_out"], b["targets"], cfg["vocab"])
    return loss_fn


@contextlib.contextmanager
def _env(env, keys):
    """The environment ``env`` for a block, every other one of ``keys``
    unset; restored afterwards."""
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _with_env(env, fn):
    with _env(env, COMM_ENV):
        return fn()


def dp4_run(mx, tag, params, batch, env, steps):
    """One ShardedTrainStep over DP4 x gpu(0) under the comm ``env``:
    (step, losses, global weights after the last step, collectives a
    step); prints ms per step, the collectives' span and the span of
    ``comm.reduce_buckets`` whole (CUDA events around each call: the
    flattening, a 2-bit bucket's quantizing and dequantizing, the
    collectives and the scatter back)."""
    import torch
    par = mx.parallel
    mesh = par.create_mesh(dp=DP4, devices=[mx.gpu(0)] * DP4)

    def build():
        return par.ShardedTrainStep(
            dp4_loss(), params, mesh, lr=MESH_LM["lr"],
            momentum=MESH_LM["momentum"],
            batch_spec={k: par.NamedSharding(mesh, par.P("dp"))
                        for k in ("tokens", "targets")})
    step = _with_env(env, build)
    losses, ms, spans, reduce_ms, counts = [], [], [], [], []
    timer, real = EventTimer(), par.comm.reduce_buckets
    par.comm.reduce_buckets = timer.wrap(real)
    try:
        for _ in range(steps):
            with par.collectives.watch(timed=True) as w:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(step(batch)))
                ms.append((time.perf_counter() - t0) * 1e3)
            spans.append(sum(w.spans_ms().values()))
            reduce_ms.append(timer.take())
            counts.append(step.collectives)
    finally:
        par.comm.reduce_buckets = real
    print("%s: %s; losses %s; ms per step %s (median after the first "
          "%.2f); collectives a step %s, their span %s ms; reduce_buckets "
          "span %s ms; card %s"
          % (tag, "buckets %d (%s)" % (step.comm_plan.n_buckets,
                                       step.comm_plan.compress or "psum")
             if step.comm_plan else "monolithic",
             ", ".join("%.6f" % v for v in losses),
             ", ".join("%.1f" % v for v in ms), float(np.median(ms[1:])),
             {k: v for k, v in counts[-1].items() if v},
             ", ".join("%.3f" % v for v in spans),
             ", ".join("%.3f" % v for v in reduce_ms), card_line()))
    return step, losses, _global_params(step), counts


def dp4_two_bit(mx, params, batch, threshold):
    """16c's 2-bit run at ``threshold`` for DP4_2BIT_STEPS: the first
    bucket's codes of step 1 on every position against the host
    quantizer's of the same carry, byte for byte; every loss finite.
    Returns the first bucket's carries of step 1."""
    import torch
    from mxnet_tpu_torch.kvstore import gradient_compression as gc
    par = mx.parallel
    seen, real = [], par.comm.quantize_flat

    def recording(flat, residual, t):
        codes, res = real(flat, residual, t)
        if len(seen) < DP4:
            seen.append((flat.detach().cpu(), codes.cpu()))
        return codes, res
    par.comm.quantize_flat = recording
    try:
        step, losses, _, counts = dp4_run(
            mx, "dp4 2bit at %s" % threshold, params, batch,
            {"MXNET_TPU_COMM_BUCKET_MB": DP4_BUCKET_MB,
             "MXNET_TPU_GRAD_COMPRESS": "2bit",
             "MXNET_TPU_GRAD_COMPRESS_THRESHOLD": threshold},
            DP4_2BIT_STEPS)
    finally:
        par.comm.quantize_flat = real
    same = sum(torch.equal(codes, gc.quantize_flat(
        carry, torch.zeros_like(carry), float(threshold))[0])
        for carry, codes in seen)
    values = sum(c.numel() for c, _ in seen)
    nonzero = sum(int((c.abs() >= float(threshold)).sum()) for c, _ in seen)
    print("dp4 2bit at %s: the first bucket's codes on %d positions (%d "
          "bytes each; %d of %d values at or past the threshold): bit for "
          "bit the host quantizer's in %d; all-gathers a step %s for %d "
          "buckets; wire %d bytes a position against %d f32"
          % (threshold, len(seen), seen[0][1].numel(), nonzero, values,
             same, [c["all-gather"] for c in counts],
             step.comm_plan.n_buckets, step.comm_plan.wire_bytes,
             step.comm_plan.grad_f32_bytes))
    if len(seen) != DP4 or same != DP4:
        raise AssertionError("dp4 2bit: the card's codes differ from the "
                             "host quantizer's")
    if not all(np.isfinite(losses)):
        raise AssertionError("dp4 2bit: a loss is not finite")
    return [c for c, _ in seen]


def dp4_overlap(mx, seed, params, batch):
    """16c: the monolithic path and the bucketed overlap path from one
    state, DP4_STEPS steps each, by phase 4's rule (the floor: the
    monolithic run with the embedding moved by 1e-7); the overlap path's
    one reduction a bucket; then 2-bit at DP4_THRESHOLD, and again at
    the threshold about a tenth of that run's first carries reach (at
    0.5 no value of these gradients does, so every code is 0)."""
    import torch
    start = {k: torch.from_numpy(v).cuda() for k, v in params.items()}
    rng = np.random.default_rng(seed + 163)
    nudged = dict(params, embed=(params["embed"] * (1 + 1e-7 * rng.
                  standard_normal(params["embed"].shape))).astype(np.float32))
    _, mono_losses, mono, _ = dp4_run(
        mx, "dp4 monolithic", params, batch, {}, DP4_STEPS)
    _, alt_losses, alt, _ = dp4_run(
        mx, "dp4 monolithic (embedding moved by 1e-7)", nudged, batch, {},
        DP4_STEPS)
    torch.cuda.empty_cache()
    step, over_losses, over, counts = dp4_run(
        mx, "dp4 overlap", params, batch,
        {"MXNET_TPU_COMM_BUCKET_MB": DP4_BUCKET_MB}, DP4_STEPS)
    buckets = step.comm_plan.n_buckets
    del step
    torch.cuda.empty_cache()
    floor = _update_gap(alt, mono, start)
    gap = _update_gap(over, mono, start)
    limit = max(MESH_LM_REL, 4.0 * max(floor.values()))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(over_losses,
                                                        mono_losses))
    loss_floor = max(abs(a - b) / abs(b) for a, b in zip(alt_losses,
                                                          mono_losses))
    worst = max(gap, key=gap.get)
    print("dp4: overlap against monolithic after %d steps: largest update "
          "gap %.3g (%s), floor %.3g, limit %.3g; losses relative %.3g "
          "(floor %.3g); all-reduces a step %s for %d buckets (+1: the "
          "loss's pmean)" % (DP4_STEPS, gap[worst], worst,
                             max(floor.values()), limit, loss_gap,
                             loss_floor, [c["all-reduce"] for c in counts],
                             buckets))
    if gap[worst] > limit or loss_gap > max(MESH_LM_REL, 4.0 * loss_floor):
        raise AssertionError("dp4: the overlap path disagrees with the "
                             "monolithic one")
    if buckets < 2 or any(c["all-reduce"] != buckets + 1 for c in counts):
        raise AssertionError("dp4: not one reduction a bucket")
    carries = dp4_two_bit(mx, params, batch, DP4_THRESHOLD)
    torch.cuda.empty_cache()
    # every 97th value: the quantile of a sample, not of 154M values
    tenth = float(np.quantile(np.abs(torch.cat(carries).numpy()[::97]),
                              0.9))
    dp4_two_bit(mx, params, batch, repr(tenth))


def train_mesh_layer(mx, seed):
    """Phase 16.  Returns {path: launches}."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    clock = time.perf_counter()
    params, batch = mesh_lm_data(seed)
    print("mesh lm: the multichip LM at GPT-2 small's widths %s, %.1fM "
          "parameters, f32, TF32 off, dry-run param_spec; card %s"
          % (MESH_LM, sum(v.size for v in params.values()) / 1e6,
             card_line()))
    reference = mesh_lm_reference(mx, seed, params, batch)
    paths = {}
    for tag, sizes in MESH_LM_MESHES:
        K.reset_launch_counts()
        mesh_lm_run(mx, tag, sizes, params, batch, reference)
        paths[tag] = K.launch_counts()
        torch.cuda.empty_cache()
    del reference
    torch.cuda.empty_cache()
    lap = time.perf_counter()
    ring_against_flash(mx, seed)
    print("ring: 16b in %.1f s" % (time.perf_counter() - lap))
    K.reset_launch_counts()
    dp4_overlap(mx, seed, params, batch)
    paths["parallel_dp4_overlap"] = K.launch_counts()
    torch.cuda.empty_cache()
    print("phase 16 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths


# -- phase 17: the mesh Modules on one card: BASELINE config 5's ResNet-50
# through ShardedModule at dp=2, tp=2, and GPT-2-small blocks through
# PipelineModule at dp=2, pp=2, each over 4 positions of gpu(0) ------------

SHARD_SIZES = dict(dp=2, tp=2)
SHARD_BATCH = 32              # the single-context paths' batch
SHARD_STEPS = 5               # the first is warm-up for the medians
SHARD_CHECKED = 2             # steps held to the plain Module
MODULE_REL = 1e-3             # phase 4's rule: max(1e-3, 4 x the floor)
# GPT-2 small's published widths (GPT2S) as pipeline stages: 6 of the LM's
# 12 blocks (the depth cut to keep the script's time), each a stage; batch
# 8 as phase 5; SGD as phase 16
PIPE_GPT = dict(vocab=50257, d_model=768, heads=12, seq=1024, ffn=3072,
                stages=6, batch=8, lr=0.01, momentum=0.9)
PIPE_SIZES = dict(dp=2, pp=2)
PIPE_STEPS = 4
PIPE_CHECKED = 2
MESH_MODULE_POSITIONS = 4


# parameters whose gradient is 0 in exact arithmetic: softmax over the
# keys ignores a constant added to every key's score, and a key bias adds
# q.b to all of them.  Their updates are rounding noise, which a relative
# update gap would divide by; they are held to their own size instead.
ZERO_GRAD_SUFFIXES = ("attn_key_bias",)


def _np_gaps(got, want, start):
    """{name: gap} over {name: numpy array} snapshots: ``_update_gap``'s
    relative L2 of each update (f32 norms, multithreaded); for the
    ZERO_GRAD_SUFFIXES parameters |got - want| / |start|."""
    import torch
    out = {}
    for k in got:
        g, w, s0 = (torch.from_numpy(np.ascontiguousarray(t[k]))
                    for t in (got, want, start))
        den = s0 if k.endswith(ZERO_GRAD_SUFFIXES) else w - s0
        out[k] = float(torch.linalg.vector_norm(g - w)) \
            / max(float(torch.linalg.vector_norm(den)), 1e-30)
    return out


def _held(tag, what, gap, loss, ref_loss, floor, loss_floor):
    """Phase 4's rule on one step: every update gap within max(1e-3, 4 x
    the floor's largest), the loss within max(1e-3, 4 x its floor); the
    ZERO_GRAD_SUFFIXES parameters (gaps relative to their size) within
    1e-3 and outside the floor's largest."""
    normal = [v for k, v in floor.items()
              if not k.endswith(ZERO_GRAD_SUFFIXES)]
    limit = max(MODULE_REL, 4.0 * max(normal))
    limits = {k: MODULE_REL if k.endswith(ZERO_GRAD_SUFFIXES) else limit
              for k in gap}
    worst = max(gap, key=lambda k: gap[k] / limits[k])
    loss_gap = abs(loss - ref_loss) / abs(ref_loss)
    print("%s: %s: loss %.6f / %.6f (relative %.3g), largest update gap "
          "%.3g (%s, limit %.3g), median %.3g, limit %.3g"
          % (tag, what, loss, ref_loss, loss_gap, gap[worst], worst,
             limits[worst], float(np.median(list(gap.values()))), limit))
    if gap[worst] > limits[worst] or \
            loss_gap > max(MODULE_REL, 4.0 * loss_floor):
        raise AssertionError("%s disagrees with %s" % (tag, what))


def _snapshot(mod):
    arg, aux = mod.get_params()
    out = {k: v.asnumpy().copy() for k, v in arg.items()}
    out.update(("aux:" + k, v.asnumpy().copy()) for k, v in aux.items())
    return out


def _ce(mod, labels):
    """The mean cross-entropy of the last outputs at ``labels``, on the
    outputs' device."""
    import torch
    prob = mod.get_outputs()[0].tensor
    lab = torch.as_tensor(np.asarray(labels).astype(np.int64),
                          device=prob.device)
    picked = torch.gather(prob, -1, lab[..., None])
    return float(-torch.log(torch.clamp(picked, 1e-30, 1.0)).mean())


def _module_steps(mx, mod, batches, keep):
    """forward_backward + update over ``batches`` ((data, label) numpy
    pairs): (losses, ms per step (synchronized host clock), launches per
    step, snapshots after the first ``keep`` steps)."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    losses, ms, launches, snaps = [], [], [], []
    for i, (x, y) in enumerate(batches):
        batch = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                                [mx.nd.array(y, ctx=mx.cpu())])
        torch.cuda.synchronize()
        before, t0 = K.launch_counts(), time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        after = K.launch_counts()
        launches.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
        losses.append(_ce(mod, y))
        if i < keep:
            snaps.append(_snapshot(mod))
    return losses, ms, launches, snaps


def _bind_module(mx, mod, data_shape, label_shape, arg0, aux0, opt,
                 kvstore="local"):
    mod.bind([("data", data_shape)], [("softmax_label", label_shape)])
    mod.init_params(initializer=None, arg_params=_host_arrays(mx, arg0),
                    aux_params=_host_arrays(mx, aux0))
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=dict(opt))
    return mod


def _floor(runs, start):
    """(per checked step {name: gap}, per step loss gap) of the plain
    run against itself with its inputs moved by 1e-7."""
    (losses, snaps), (alt_losses, alt_snaps) = runs
    return ([_np_gaps(a, s, start) for a, s in zip(alt_snaps, snaps)],
            [abs(a - b) / abs(b) for a, b in zip(alt_losses, losses)])


class _SplitSpans:
    """The span of the BatchNorm psums apart from the step's other
    all-reduces: a timed watch active only inside ``_spmd._group_sum``."""

    def __init__(self, mx):
        from mxnet_tpu_torch.module import _spmd
        from mxnet_tpu_torch.parallel import collectives
        self.spmd, self.collectives = _spmd, collectives
        self.watch = collectives.Watch(timed=True)
        self.real = _spmd._group_sum

    def __enter__(self):
        def timed(blocks, mesh):
            self.collectives._WATCHES.append(self.watch)
            try:
                return self.real(blocks, mesh)
            finally:
                self.collectives._WATCHES.remove(self.watch)
        self.spmd._group_sum = timed
        return self.watch

    def __exit__(self, *exc):
        self.spmd._group_sum = self.real


def sharded_resnet50(mx, seed):
    """17a.  Returns the sharded fit's launches."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    par = mx.parallel
    symbol = dp_symbol()
    single = expected_train_launches(symbol)
    per_step = {k: v * SHARD_SIZES["dp"] for k, v in single.items() if v}
    n_bn = single["bn_channel_sums"] // 2
    rng = np.random.default_rng(seed + 170)
    shape = (SHARD_BATCH,) + REC_SHAPE
    batches = [(rng.random(shape, dtype=np.float32),
                rng.integers(0, REC_CLASSES, SHARD_BATCH).astype(np.float32))
               for _ in range(SHARD_STEPS)]
    arg0, aux0 = dp_init(mx, symbol, seed)
    start = dict(arg0, **{"aux:" + k: v for k, v in aux0.items()})
    checked = batches[:SHARD_CHECKED]
    print("sharded resnet50: ResNet-50 v2 (models/resnet.py, %d classes, "
          "%s) at batch %d through ShardedModule on %s over %d x gpu(0), "
          "SGD %s, f32, TF32 off; expected launches a step %s (the "
          "single-context path's %s, once a dp group); card %s"
          % (REC_CLASSES, "x".join(map(str, REC_SHAPE)), SHARD_BATCH,
             SHARD_SIZES, MESH_MODULE_POSITIONS, REC_SGD, per_step, single,
             card_line()))
    # the plain Module on gpu(0), then again with the images moved by 1e-7
    runs = []
    for nudge in (0.0, 1e-7):
        moved = [((x * (1 + nudge * rng.standard_normal(x.shape)))
                  .astype(np.float32), y) for x, y in checked] \
            if nudge else checked
        mod = _bind_module(mx, mx.mod.Module(symbol, context=mx.gpu(0)),
                           shape, (SHARD_BATCH,), arg0, aux0, REC_SGD)
        losses, ms, _, snaps = _module_steps(mx, mod, moved, SHARD_CHECKED)
        runs.append((losses, snaps))
        del mod
        torch.cuda.empty_cache()
    floors, loss_floors = _floor(runs, start)
    ref_losses, ref_snaps = runs[0]
    print("sharded resnet50: plain Module on gpu(0): losses %s, ms per step "
          "%s; the floor (images moved by 1e-7): largest update gap %s, "
          "loss %s" % (", ".join("%.6f" % v for v in ref_losses),
                       ", ".join("%.1f" % v for v in ms),
                       ", ".join("%.3g" % max(f.values()) for f in floors),
                       ", ".join("%.3g" % v for v in loss_floors)))
    one = _bind_module(mx, mx.mod.ShardedModule(
        symbol, mesh=par.create_mesh(devices=[mx.gpu(0)])), shape,
        (SHARD_BATCH,), arg0, aux0, REC_SGD)
    one_losses, _, _, one_snaps = _module_steps(mx, one, checked,
                                                SHARD_CHECKED)
    del one
    torch.cuda.empty_cache()

    mesh = par.create_mesh(par.MeshSpec(**SHARD_SIZES),
                           devices=[mx.gpu(0)] * MESH_MODULE_POSITIONS)
    torch.cuda.reset_peak_memory_stats()
    mod = _bind_module(mx, mx.mod.ShardedModule(symbol, mesh=mesh), shape,
                       (SHARD_BATCH,), arg0, aux0, REC_SGD)
    if mod.dp_mode != "split":
        raise AssertionError("sharded resnet50: dp_mode %r (%s)"
                             % (mod.dp_mode, mod.dp_mode_reason))
    K.reset_launch_counts()
    losses, ms, launches, snaps = _module_steps(
        mx, mod, batches[:-1], SHARD_CHECKED)
    with _SplitSpans(mx) as bn_watch, \
            par.collectives.watch(timed=True) as w:
        more = _module_steps(mx, mod, batches[-1:], 0)
    path = K.launch_counts()
    losses += more[0]
    ms += more[1]
    launches += more[2]
    spans, bn_span = w.spans_ms(), bn_watch.spans_ms()["all-reduce"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i in range(SHARD_CHECKED):
        gap = _np_gaps(snaps[i], ref_snaps[i], start)
        _held("sharded resnet50", "step %d against the plain Module on "
              "gpu(0)" % (i + 1), gap, losses[i], ref_losses[i], floors[i],
              loss_floors[i])
        gap = _np_gaps(snaps[i], one_snaps[i], start)
        _held("sharded resnet50", "step %d against ShardedModule on one "
              "position" % (i + 1), gap, losses[i], one_losses[i],
              floors[i], loss_floors[i])
    if any(l != per_step for l in launches):
        raise AssertionError("sharded resnet50: launches a step %s, "
                             "expected %s" % (launches, per_step))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("sharded resnet50: a loss is not finite")
    counts = mod.collectives
    n_params = len(mod._param_names)
    if counts["all-reduce"] != 2 * n_bn + n_params or \
            counts != {k: v for k, v in w.counts.items()}:
        raise AssertionError("sharded resnet50: collectives %s, the watch "
                             "%s, expected %d all-reduces" % (
                                 counts, w.counts, 2 * n_bn + n_params))
    last = mx.io.DataBatch([mx.nd.array(batches[-1][0], ctx=mx.cpu())],
                           [mx.nd.array(batches[-1][1], ctx=mx.cpu())])
    table = profile_run(lambda: mod.forward_backward(last),
                        "sharded resnet50")
    print("sharded resnet50: dp_mode %r, %d steps: losses %s; ms per step "
          "%s, median after the first %.2f (%.1f images/s); launches a "
          "step %s; collectives a step %s: %d BatchNorm psums (span %.3f "
          "ms), %d gradient psums (span %.3f ms), %d tp all-gathers (span "
          "%.3f ms); peak memory %.2f GB; %s; card %s"
          % (mod.dp_mode, len(losses), ", ".join("%.6f" % v for v in losses),
             ", ".join("%.1f" % v for v in ms), float(np.median(ms[1:])),
             SHARD_BATCH * 1e3 / float(np.median(ms[1:])), launches[-1],
             {k: v for k, v in counts.items() if v}, 2 * n_bn, bn_span,
             n_params, spans["all-reduce"] - bn_span, counts["all-gather"],
             spans["all-gather"], peak,
             "busy not measured" if table is None else table.share(),
             card_line()))
    del mod
    torch.cuda.empty_cache()
    # the host's one position, one step
    t0 = time.perf_counter()
    host = _bind_module(mx, mx.mod.ShardedModule(
        symbol, mesh=par.create_mesh(devices=[mx.cpu()])), shape,
        (SHARD_BATCH,), arg0, aux0, REC_SGD)
    host_losses, _, _, host_snaps = _module_steps(mx, host, checked[:1], 1)
    print("sharded resnet50: the host's one position, one step in %.1f s"
          % (time.perf_counter() - t0))
    _held("sharded resnet50", "step 1 against the host's one position",
          _np_gaps(snaps[0], host_snaps[0], start), losses[0],
          host_losses[0], floors[0], loss_floors[0])
    return path


def gpt_block(S, x, prefix, cfg=PIPE_GPT):
    """One pre-LN GPT-2 block as ``transformer_lm_symbol`` writes it: LN,
    causal multi-head attention, +x, LN, exact-GELU FFN, +x; its
    parameters named ``prefix`` + ``ln1_gamma`` etc."""
    d = cfg["d_model"]

    def ln(h, tag):
        return S.LayerNorm(h, S.var(prefix + tag + "_gamma"),
                           S.var(prefix + tag + "_beta"), axis=-1,
                           eps=1e-5)

    def dense(h, tag, units):
        return S.FullyConnected(h, S.var(prefix + tag + "_weight"),
                                S.var(prefix + tag + "_bias"),
                                num_hidden=units, flatten=False)
    h = ln(x, "ln1")
    proj = [S.var(prefix + "attn_%s_%s" % (side, kind))
            for side in ("query", "key", "value", "out")
            for kind in ("weight", "bias")]
    h = x + S.multi_head_attention(h, h, h, *proj, num_heads=cfg["heads"],
                                   causal=True)
    f = S.LeakyReLU(dense(ln(h, "ln2"), "ffn1", cfg["ffn"]),
                    act_type="gelu")
    return h + dense(f, "ffn2", d)


def gpt_stem(S, cfg=PIPE_GPT):
    tokens = S.Embedding(S.var("data"), S.var("embed_weight"),
                         input_dim=cfg["vocab"], output_dim=cfg["d_model"])
    pos = S.var("pos_weight", shape=(cfg["seq"], cfg["d_model"]))
    return S.broadcast_add(tokens, S.expand_dims(pos, axis=0))


def gpt_head(S, x, cfg=PIPE_GPT):
    h = S.LayerNorm(x, S.var("lnf_gamma"), S.var("lnf_beta"), axis=-1,
                    eps=1e-5)
    h = S.FullyConnected(h, S.var("vocab_weight"), S.var("vocab_bias"),
                         num_hidden=cfg["vocab"], flatten=False)
    return S.SoftmaxOutput(h, preserve_shape=True, name="softmax")


def pipeline_data(mx, seed, cfg=PIPE_GPT):
    """The flattened model's parameters ({name: f32 numpy}: weights 0.02
    * standard normal, LayerNorm gammas about 1) and one batch of token
    ids and targets, from ``seed``."""
    S = mx.sym
    flat = gpt_head(S, _gpt_stack(S, cfg), cfg)
    shapes, _, _ = flat.infer_shape(data=(cfg["batch"], cfg["seq"]),
                                    softmax_label=(cfg["batch"], cfg["seq"]))
    rng = np.random.default_rng(seed + 171)
    params = {}
    for n, shp in zip(flat.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        v = rng.standard_normal(shp, dtype=np.float32)
        params[n] = 1 + 0.1 * v if n.endswith("_gamma") else 0.02 * v
    tokens, targets = (rng.integers(0, cfg["vocab"], (cfg["batch"],
                                                      cfg["seq"]))
                       .astype(np.float32) for _ in range(2))
    return flat, params, (tokens, targets)


def _gpt_stack(S, cfg):
    x = gpt_stem(S, cfg)
    for s in range(cfg["stages"]):
        x = gpt_block(S, x, "stage%d_" % s, cfg)
    return x


def _lse_per_step(mod, cfg):
    """The flash LSE launches a pipelined step implies: ticks x stages a
    position x positions (``pipeline_stages``' schedule and layout)."""
    mesh = mod.mesh
    dp, pp = mesh.shape["dp"], mesh.shape["pp"]
    n = mod._n_micro
    local = n // dp if n % dp == 0 and (pp == 1 or n // dp >= 2) else n
    return (local + pp - 1) * (cfg["stages"] // pp) * mesh.size


def pipeline_gpt2s(mx, seed, cfg=PIPE_GPT):
    """17b.  Returns the pipelined fit's launches."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    par, S = mx.parallel, mx.sym
    flat, params, (tokens, targets) = pipeline_data(mx, seed, cfg)
    shape = (cfg["batch"], cfg["seq"])
    opt = {"learning_rate": cfg["lr"], "momentum": cfg["momentum"],
           "rescale_grad": 1.0 / cfg["batch"]}
    batches = [(tokens, targets)] * PIPE_STEPS
    print("pipeline gpt2s: %d GPT-2-small blocks %s as PipelineModule "
          "stages on %s over %d x gpu(0), batch %d x %d tokens, %.1fM "
          "parameters, SGD lr %g momentum %g, f32, TF32 off; card %s"
          % (cfg["stages"], cfg, PIPE_SIZES, MESH_MODULE_POSITIONS,
             cfg["batch"], cfg["seq"],
             sum(v.size for v in params.values()) / 1e6, cfg["lr"],
             cfg["momentum"], card_line()))
    # the oracle: a plain Module over the flattened graph on gpu(0), then
    # again with the embedding moved by 1e-7
    rng = np.random.default_rng(seed + 172)
    runs = []
    for nudge in (0.0, 1e-7):
        start = dict(params)
        if nudge:
            e = params["embed_weight"]
            start["embed_weight"] = (e * (1 + nudge * rng.standard_normal(
                e.shape))).astype(np.float32)
        mod = _bind_module(mx, mx.mod.Module(flat, context=mx.gpu(0)),
                           shape, shape, start, {}, opt)
        losses, ms, _, snaps = _module_steps(mx, mod,
                                             batches[:PIPE_CHECKED],
                                             PIPE_CHECKED)
        runs.append((losses, snaps))
        del mod
        torch.cuda.empty_cache()
    floors, loss_floors = _floor(runs, params)
    ref_losses, ref_snaps = runs[0]
    print("pipeline gpt2s: plain Module over the flattened graph on gpu(0): "
          "losses %s, ms per step %s; the floor (embedding moved by 1e-7): "
          "largest update gap %s, of the key biases (relative to their "
          "size) %s, loss %s"
          % (", ".join("%.6f" % v for v in ref_losses),
             ", ".join("%.1f" % v for v in ms),
             ", ".join("%.3g" % max(v for k, v in f.items()
                                    if not k.endswith(ZERO_GRAD_SUFFIXES))
                       for f in floors),
             ", ".join("%.3g" % max(v for k, v in f.items()
                                    if k.endswith(ZERO_GRAD_SUFFIXES))
                       for f in floors),
             ", ".join("%.3g" % v for v in loss_floors)))

    def pipeline_module(mesh):
        stem = gpt_stem(S, cfg)
        body = gpt_block(S, S.var("x"), "", cfg)
        head = gpt_head(S, S.var("x"), cfg)
        mod = mx.mod.PipelineModule(body, cfg["stages"], head, stem=stem,
                                    mesh=mesh)
        return _bind_module(mx, mod, shape, shape, params, {}, opt)

    mesh = par.create_mesh(par.MeshSpec(**PIPE_SIZES),
                           devices=[mx.gpu(0)] * MESH_MODULE_POSITIONS)
    torch.cuda.reset_peak_memory_stats()
    mod = pipeline_module(mesh)
    want_lse = _lse_per_step(mod, cfg)
    K.reset_launch_counts()
    losses, ms, launches, snaps = _module_steps(mx, mod, batches[:-1],
                                                PIPE_CHECKED)
    with par.collectives.watch(timed=True) as w:
        more = _module_steps(mx, mod, batches[-1:], 0)
    path = K.launch_counts()
    losses += more[0]
    ms += more[1]
    launches += more[2]
    spans = w.spans_ms()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i in range(PIPE_CHECKED):
        _held("pipeline gpt2s", "step %d against the flattened Module on "
              "gpu(0)" % (i + 1), _np_gaps(snaps[i], ref_snaps[i], params),
              losses[i], ref_losses[i], floors[i], loss_floors[i])
    if abs(mod.loss - losses[-1]) > 1e-5 * abs(losses[-1]):
        raise AssertionError("pipeline gpt2s: mod.loss %r, the outputs' "
                             "%r" % (mod.loss, losses[-1]))
    if any(l.get("flash_attn_fwd_lse", 0) != want_lse for l in launches):
        raise AssertionError("pipeline gpt2s: LSE launches a step %s, the "
                             "schedule implies %d" % (launches, want_lse))
    if not np.all(np.isfinite(losses)):
        raise AssertionError("pipeline gpt2s: a loss is not finite")
    if mod.collectives != w.counts:
        raise AssertionError("pipeline gpt2s: the step's record %s, the "
                             "watch %s" % (mod.collectives, w.counts))
    last = mx.io.DataBatch([mx.nd.array(tokens, ctx=mx.cpu())],
                           [mx.nd.array(targets, ctx=mx.cpu())])
    table = profile_run(lambda: mod.forward_backward(last),
                        "pipeline gpt2s")
    print("pipeline gpt2s: n_micro %d, %d steps: losses %s; ms per step %s, "
          "median after the first %.2f (%.0f tokens/s); flash LSE launches "
          "a step %d (ticks x stages a position x positions: %d); "
          "collectives a step %s, their span %s ms; peak memory %.2f GB; "
          "%s; card %s"
          % (mod._n_micro, len(losses), ", ".join("%.6f" % v for v in losses),
             ", ".join("%.1f" % v for v in ms), float(np.median(ms[1:])),
             cfg["batch"] * cfg["seq"] * 1e3 / float(np.median(ms[1:])),
             launches[-1].get("flash_attn_fwd_lse", 0), want_lse,
             {k: v for k, v in w.counts.items() if v},
             {k: round(v, 3) for k, v in spans.items() if w.counts[k]},
             peak, "busy not measured" if table is None else table.share(),
             card_line()))
    del mod
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = pipeline_module(par.create_mesh(devices=[mx.cpu()]))
    host_losses, _, _, host_snaps = _module_steps(mx, host, batches[:1], 1)
    del host
    print("pipeline gpt2s: the host's one position, one step in %.1f s"
          % (time.perf_counter() - t0))
    _held("pipeline gpt2s", "step 1 against the host's one position",
          _np_gaps(snaps[0], host_snaps[0], params), losses[0],
          host_losses[0], floors[0], loss_floors[0])
    return path


def train_mesh_modules(mx, seed):
    """Phase 17.  Returns {path: launches}."""
    import torch
    clock = time.perf_counter()
    paths = {"sharded_resnet50_dp2_tp2": sharded_resnet50(mx, seed)}
    torch.cuda.empty_cache()
    print("sharded resnet50: 17a in %.1f s" % (time.perf_counter() - clock))
    lap = time.perf_counter()
    paths["pipeline_gpt2s_dp2_pp2"] = pipeline_gpt2s(mx, seed)
    torch.cuda.empty_cache()
    print("pipeline gpt2s: 17b in %.1f s" % (time.perf_counter() - lap))
    print("phase 17 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths


# -- phase 18: the fused data-parallel Module step and group2ctx -------------

# 18a: BASELINE config 5 (15a's ResNet-50 v2 and SGD) through the fused
# data-parallel step over [gpu(0)] * 2 at batch 64
FUSED_DP_BATCH = 64           # 32 a position
FUSED_DP_STEPS = 8
FUSED_DP_CHECKED = 2          # steps held to one context at batch 64
FUSED_DP_EAGER = 3            # steps of the same module with no graph
FUSED_DP_BF16_STEPS = 4
# 18b: the zoo TransformerLM at GPT-2 small's widths (GPT2S), dropout 0,
# batch 8 x 1024 over [gpu(0)] * 2, SGD lr 0.01 momentum 0.9
OVERLAP_BATCH = 8
OVERLAP_STEPS = 3
OVERLAP_BUCKET_MB = "25"
OVERLAP_THRESHOLD = "0.5"
OVERLAP_SGD = {"learning_rate": 0.01, "momentum": 0.9}
# 18c: MXNet 1.0's example/model-parallel/lstm/lstm.py layout at Zaremba
# et al.'s medium widths (LM above): an embedding, 2 unrolled LSTMCell
# layers and the decoder, each in its own ctx_group
G2C_STEPS = 4
G2C_SGD = {"learning_rate": 1.0, "clip_gradient": 5.0}
G2C_CONTEXTS = {"embed": "cpu", "layer0": "gpu", "layer1": "gpu",
                "decode": "gpu"}    # each device 0


def _release():
    """Free the card's memory of the modules deleted before: a Module and
    its fused step refer to each other, so the step's CUDA graph and its
    memory pool go only at a collection."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _dp_fused_check(tag, mod, rows, per_step, n_coll, steps):
    """The fused dp step engaged over two positions of one card and
    replayed from its second step; every step's launches and collectives
    as expected and the replicas bit for bit."""
    fs = mod._fused_step
    if fs is None or fs.n_dev != 2 or fs.dp_mode != "split":
        from mxnet_tpu_torch.module.fused_step import FusedTrainStep
        raise AssertionError("%s: the fused dp step did not engage (%s)"
                             % (tag, FusedTrainStep.refusal(mod)
                                if fs is None else fs.dp_mode_reason))
    if fs.captures != 1 or fs.replays != steps - 1:
        raise AssertionError("%s: %d captures, %d replays in %d steps"
                             % (tag, fs.captures, fs.replays, steps))
    for i, r in enumerate(rows):
        if r["launches"] != per_step:
            raise AssertionError("%s: step %d launched %s, expected %s"
                                 % (tag, i + 1, r["launches"], per_step))
        if r["collectives"].get("all-reduce") != n_coll:
            raise AssertionError("%s: step %d issued %s, expected %d "
                                 "all-reduces" % (tag, i + 1,
                                                  r["collectives"], n_coll))
        if not r["replicas"]:
            raise AssertionError("%s: the replicas differ after step %d"
                                 % (tag, i + 1))
        if not np.isfinite(r["loss"]):
            raise AssertionError("%s: the loss of step %d is not finite"
                                 % (tag, i + 1))


def fused_dp_fit(mx, symbol, batches, arg0, aux0, opt, keep, per_step):
    """``Module(context=[gpu(0)] * 2).fit(kvstore='tpu_ici')`` over
    ``batches``: per step the ms (synchronized host clock), the kernel
    launches, the step's collectives, the replicas bit for bit and the
    loss; (snapshot, optimizer states) after each of the first ``keep``
    steps.  Returns (module, rows, snapshots)."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    images = np.concatenate([b[0] for b in batches])
    labels = np.concatenate([b[1] for b in batches])
    it = mx.io.NDArrayIter(images, labels, batch_size=len(batches[0][1]))
    mod = mx.mod.Module(symbol, context=[mx.gpu(0)] * 2)
    rows, snaps, marks = [], [], {}

    def on_batch(param):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), K.launch_counts()
        group = mod._exec_group
        rows.append({
            "ms": (now - marks["t"]) * 1e3,
            "launches": {k: counts[k] - marks["counts"][k] for k in counts
                         if counts[k] != marks["counts"][k]},
            "collectives": {k: v for k, v in
                            mod._fused_step.collectives.items() if v},
            "replicas": replicas_equal(group.param_arrays)
            and replicas_equal(group.aux_arrays),
            "loss": _ce(mod, param.locals["batch"].label[0].asnumpy())})
        if len(snaps) < keep:
            snaps.append((_snapshot(mod),
                          mod._fused_step.export_states()))
        torch.cuda.synchronize()
        marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()

    torch.cuda.synchronize()
    marks["t"], marks["counts"] = time.perf_counter(), K.launch_counts()
    mod.fit(it, num_epoch=1, kvstore="tpu_ici", optimizer="sgd",
            optimizer_params=dict(opt), eval_metric="acc",
            arg_params=_host_arrays(mx, arg0),
            aux_params=_host_arrays(mx, aux0), batch_end_callback=on_batch)
    torch.cuda.synchronize()
    return mod, rows, snaps


def fused_dp_resnet50(mx, seed):
    """18a.  Returns the dp fit's launches."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    symbol = dp_symbol()
    single = expected_train_launches(symbol)
    per_step = {k: v * 2 for k, v in single.items() if v}
    n_bn = single["bn_channel_sums"] // 2
    n_params = len([a for a in symbol.list_arguments()
                    if a not in ("data", "softmax_label")])
    n_coll = 2 * n_bn + n_params
    rng = np.random.default_rng(seed + 180)
    shape = (FUSED_DP_BATCH,) + REC_SHAPE
    batches = [(rng.random(shape, dtype=np.float32),
                rng.integers(0, REC_CLASSES, FUSED_DP_BATCH)
                .astype(np.float32)) for _ in range(FUSED_DP_STEPS)]
    arg0, aux0 = dp_init(mx, symbol, seed)
    start = dict(arg0, **{"aux:" + k: v for k, v in aux0.items()})
    print("fused dp resnet50: ResNet-50 v2 (models/resnet.py, %d classes, "
          "%s) through Module(context=[gpu(0)] * 2).fit(kvstore='tpu_ici') "
          "at batch %d (%d a position), SGD %s, f32, TF32 off; expected a "
          "step: launches %s (the single-context path's %s, once a "
          "position), %d all-reduces (%d BatchNorms' forward and backward "
          "sums, %d gradients); card %s"
          % (REC_CLASSES, "x".join(map(str, REC_SHAPE)), FUSED_DP_BATCH,
             FUSED_DP_BATCH // 2, REC_SGD, per_step, single, n_coll, n_bn,
             n_params, card_line()))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    mod, rows, kept = fused_dp_fit(mx, symbol, batches, arg0, aux0,
                                   REC_SGD, FUSED_DP_CHECKED, per_step)
    path = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    _dp_fused_check("fused dp resnet50", mod, rows, per_step, n_coll,
                    FUSED_DP_STEPS)
    fs = mod._fused_step
    snaps = [k[0] for k in kept]

    def one_context(ctxs, state, moms, batch, nudge=0.0):
        """One step of a module over ``ctxs`` at batch 64 from ``state``
        (parameters, moving statistics) and ``moms`` (its fused step's
        optimizer states, None at the start), on ``batch`` with the images
        moved by ``nudge``: (loss, snapshot)."""
        x, y = batch
        if nudge:
            x = (x * (1 + nudge * rng.standard_normal(x.shape))).astype(
                np.float32)
        ref = _bind_module(
            mx, mx.mod.Module(symbol, context=ctxs), shape,
            (FUSED_DP_BATCH,), {k: v for k, v in state.items()
                                if not k.startswith("aux:")},
            {k[4:]: v for k, v in state.items() if k.startswith("aux:")},
            REC_SGD, kvstore="tpu_ici" if isinstance(ctxs, list)
            else "local")
        if moms is not None:
            ref._fused_step.load_states(moms)
        losses, _, _, got = _module_steps(mx, ref, [(x, y)], 1)
        del ref
        _release()
        return losses[0], got[0]

    # each checked step from the dp run's state before it (teacher
    # forced: chained steps of a BatchNorm net at lr 0.1 diverge past any
    # floor), against one context at batch 64 (the same global-batch
    # math), and the floor: that step with the images moved by 1e-7
    for i in range(FUSED_DP_CHECKED):
        state, moms = (start, None) if i == 0 else kept[i - 1]
        ref_loss, ref_snap = one_context(mx.gpu(0), state, moms, batches[i])
        alt_loss, alt_snap = one_context(mx.gpu(0), state, moms, batches[i],
                                         1e-7)
        floor = _np_gaps(alt_snap, ref_snap, state)
        loss_floor = abs(alt_loss - ref_loss) / abs(ref_loss)
        _held("fused dp resnet50", "step %d against one context at batch "
              "%d from the same state" % (i + 1, FUSED_DP_BATCH),
              _np_gaps(snaps[i], ref_snap, state), rows[i]["loss"],
              ref_loss, floor, loss_floor)
        if i == 0:
            first = (floor, loss_floor)
    last = mx.io.DataBatch([mx.nd.array(batches[-1][0], ctx=mx.cpu())],
                           [mx.nd.array(batches[-1][1], ctx=mx.cpu())])
    table = profile_run(lambda: mod.forward_backward(last),
                        "fused dp resnet50")
    ms = [r["ms"] for r in rows]
    print("fused dp resnet50: dp_mode %r, %d steps (the first eager, the "
          "second captured, then replays: %d captures, %d replays): losses "
          "%s; ms per step %s, replay median %.2f (%.1f images/s); capture "
          "%.1f ms; launches a step %s; collectives a step %s; replicas "
          "bit for bit after every step; peak memory %.2f GB; %s; card %s"
          % (fs.dp_mode, len(rows), fs.captures, fs.replays,
             ", ".join("%.6f" % r["loss"] for r in rows),
             ", ".join("%.1f" % v for v in ms), float(np.median(ms[2:])),
             FUSED_DP_BATCH * 1e3 / float(np.median(ms[2:])),
             fs.capture_seconds * 1e3, rows[-1]["launches"],
             rows[-1]["collectives"], peak,
             "busy not measured" if table is None else table.share(),
             card_line()))
    del mod, fs
    _release()
    # the same step with no graph: every step eager on the default stream
    eager = _bind_module(mx, mx.mod.Module(symbol, context=[mx.gpu(0)] * 2),
                         shape, (FUSED_DP_BATCH,), arg0, aux0, REC_SGD,
                         kvstore="tpu_ici")
    eager._fused_step._graphable = False
    e_losses, e_ms, _, e_snaps = _module_steps(
        mx, eager, batches[:FUSED_DP_EAGER], FUSED_DP_CHECKED)
    gap = _np_gaps(e_snaps[-1], snaps[FUSED_DP_CHECKED - 1], start)
    print("fused dp resnet50: the same step eager (no graph): ms per step "
          "%s, median after the first %.2f; its state after step %d "
          "against the graph run's: largest update gap %.3g, losses %s"
          % (", ".join("%.1f" % v for v in e_ms), float(np.median(e_ms[1:])),
             FUSED_DP_CHECKED, max(gap.values()),
             ", ".join("%.6f" % v for v in e_losses)))
    if not np.all(np.isfinite(e_losses)):
        raise AssertionError("fused dp resnet50: an eager loss is not "
                             "finite")
    del eager
    _release()
    # the host's two positions, one step from the start
    t0 = time.perf_counter()
    host_loss, host_snap = one_context([mx.cpu(0), mx.cpu(1)], start, None,
                                       batches[0])
    print("fused dp resnet50: the host's [cpu(0), cpu(1)], one step in "
          "%.1f s" % (time.perf_counter() - t0))
    _held("fused dp resnet50", "step 1 against the host's [cpu(0), cpu(1)]",
          _np_gaps(snaps[0], host_snap, start), rows[0]["loss"], host_loss,
          first[0], first[1])
    return path


def fused_dp_bf16(mx, seed):
    """18a's bf16 run: the same fit in bf16 with f32 masters (phase 8's
    settings) for FUSED_DP_BF16_STEPS, held after every step to the bf16
    single-context fused step at batch 64 by phase 8's rule (the masters'
    and momenta's relative L2 within 1e-3 or 4x that run's own gap when
    16 pixels an image move by one bf16 ulp).  Returns the fit's
    launches."""
    import torch
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import kernels as K
    symbol = resnet.get_symbol(dtype="bfloat16", **RESNET)
    single = expected_train_launches(symbol)
    per_step = {k: v * 2 for k, v in single.items() if v}
    n_bn = single["bn_channel_sums"] // 2
    n_params = len([a for a in symbol.list_arguments()
                    if a not in ("data", "softmax_label")])
    rng = np.random.default_rng(seed + 181)
    shape = (FUSED_DP_BATCH,) + REC_SHAPE
    batches = [(rng.random(shape, dtype=np.float32),
                rng.integers(0, REC_CLASSES, FUSED_DP_BATCH)
                .astype(np.float32)) for _ in range(FUSED_DP_BF16_STEPS)]
    arg0, aux0 = dp_init(mx, dp_symbol(), seed)
    opt = dict(FUSED_SGD)

    def states(ctx, data):
        mod = mx.mod.Module(symbol, context=ctx)
        mod.bind([("data", shape)], [("softmax_label", (FUSED_DP_BATCH,))])
        types = dict(zip(symbol.list_arguments(),
                         symbol.infer_type(data="float32")[0]))
        mod.init_params(arg_params={
            k: mx.nd.array(v, ctx=mx.cpu()).astype(
                mx.base.dtype_name(types[k])) for k, v in arg0.items()},
            aux_params=_host_arrays(mx, aux0))
        mod.init_optimizer(kvstore="tpu_ici" if isinstance(ctx, list)
                           else "local", optimizer="sgd",
                           optimizer_params=opt)
        out, ms, launches = [], [], []
        for x, y in data:
            batch = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                                    [mx.nd.array(y, ctx=mx.cpu())])
            torch.cuda.synchronize()
            before, t0 = K.launch_counts(), time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            after = K.launch_counts()
            launches.append({k: after[k] - before[k] for k in after
                             if after[k] != before[k]})
            out.append(fused_state(mod))
        return mod, out, ms, launches

    one, want, one_ms, _ = states(mx.gpu(0), batches)
    del one
    nudged = [(bf16_ulp_up(x, rng.choice(x[0].size, 16, replace=False)), y)
              for x, y in batches]
    alt, floor_states, _, _ = states(mx.gpu(0), nudged)
    del alt
    _release()
    K.reset_launch_counts()
    mod, got, ms, launches = states([mx.gpu(0)] * 2, batches)
    path = K.launch_counts()
    fs = mod._fused_step
    if fs is None or not any(fs.mixed) or fs.captures != 1:
        raise AssertionError("fused dp bf16: the fused dp step with f32 "
                             "masters did not engage and capture")
    if any(l != per_step for l in launches):
        raise AssertionError("fused dp bf16: launches %s, expected %s"
                             % (launches, per_step))
    if fs.collectives.get("all-reduce") != 2 * n_bn + n_params:
        raise AssertionError("fused dp bf16: collectives %s"
                             % fs.collectives)
    gaps = []
    for i, (g, w, f) in enumerate(zip(got, want, floor_states)):
        gm, gs, same = state_gap(g, w)
        fm, fsg, _ = state_gap(f, w)
        limit = max(FUSED_HOST_REL, 4.0 * max(fm, fsg))
        gaps.append((gm, gs, same, limit))
        if max(gm, gs) > limit:
            raise AssertionError("fused dp bf16: step %d's masters %.3g, "
                                 "momenta %.3g past %.3g" % (i + 1, gm, gs,
                                                             limit))
    print("fused dp bf16: ResNet-50 v2 in bf16 with f32 masters (FUSED_SGD "
          "%s) over [gpu(0)] * 2 at batch %d, %d steps: ms per step %s "
          "(one context at batch %d: %s); launches a step %s; collectives "
          "a step %s; masters / momenta relative L2 against one context "
          "per step %s (limits %s); replicas bit for bit: %s; card %s"
          % (opt, FUSED_DP_BATCH, len(ms), ", ".join("%.1f" % v for v in ms),
             FUSED_DP_BATCH, ", ".join("%.1f" % v for v in one_ms),
             launches[-1], {k: v for k, v in fs.collectives.items() if v},
             ", ".join("%.3g/%.3g" % g[:2] for g in gaps),
             ", ".join("%.3g" % g[3] for g in gaps),
             replicas_equal(mod._exec_group.param_arrays), card_line()))
    if not replicas_equal(mod._exec_group.param_arrays):
        raise AssertionError("fused dp bf16: the replicas differ")
    del mod, fs
    _release()
    return path


def overlap_lm(mx):
    """The zoo TransformerLM at GPT-2 small's widths with a per-token
    softmax head (``SoftmaxOutput(preserve_shape=True)``)."""
    from mxnet_tpu_torch.models import transformer_lm_symbol
    logits = transformer_lm_symbol(**GPT2S)
    return logits, mx.sym.SoftmaxOutput(logits, mx.sym.var("softmax_label"),
                                        preserve_shape=True, name="softmax")


def overlap_run(mx, tag, symbol, params, batch, env, steps):
    """The fused dp step over [gpu(0)] * 2 under the comm ``env``: (module,
    losses, weights after the last step, collectives and launches a
    step); prints ms per step and ``reduce_buckets``' span."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    shape = (OVERLAP_BATCH, GPT2S["seq_len"])
    opt = dict(OVERLAP_SGD, rescale_grad=1.0 / OVERLAP_BATCH)

    def build():
        return _bind_module(mx, mx.mod.Module(symbol,
                                              context=[mx.gpu(0)] * 2),
                            shape, shape, params, {}, opt,
                            kvstore="tpu_ici")
    mod = _with_env(env, build)
    timer, real = EventTimer(), mx.parallel.comm.reduce_buckets
    timed = timer.wrap(real)

    def eager_timed(*args, **kwargs):
        # no timed event can be recorded inside a graph's capture
        if torch.cuda.is_current_stream_capturing():
            return real(*args, **kwargs)
        return timed(*args, **kwargs)
    mx.parallel.comm.reduce_buckets = eager_timed
    try:
        losses, ms, launches, _ = _module_steps(mx, mod, [batch] * steps, 0)
    finally:
        mx.parallel.comm.reduce_buckets = real
    fs = mod._fused_step
    plan = fs._comm_plan
    print("%s: %s; losses %s; ms per step %s (the first eager, the second "
          "captured); reduce_buckets span (eager step) %.3f ms; "
          "collectives a step %s; flash LSE launches a step %s; card %s"
          % (tag, "buckets %d (%s)" % (plan.n_buckets, plan.compress
                                        or "psum")
             if plan else "monolithic" + (" (%s)" % fs.overlap_off_reason
                                          if fs.overlap_off_reason else ""),
             ", ".join("%.6f" % v for v in losses),
             ", ".join("%.1f" % v for v in ms), timer.take(),
             {k: v for k, v in fs.collectives.items() if v},
             [l.get("flash_attn_fwd_lse", 0) for l in launches],
             card_line()))
    if fs.captures != 1 or not np.all(np.isfinite(losses)):
        raise AssertionError("%s: %d captures, losses %s"
                             % (tag, fs.captures, losses))
    weights = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    return mod, losses, weights, launches


def fused_dp_overlap(mx, seed):
    """18b.  Returns the overlap run's launches."""
    import torch
    from mxnet_tpu_torch.kvstore import gradient_compression as gc
    from mxnet_tpu_torch.ops import kernels as K
    logits, symbol = overlap_lm(mx)
    params = gpt2s_params(logits, seed)
    rng = np.random.default_rng(seed + 182)
    shape = (OVERLAP_BATCH, GPT2S["seq_len"])
    tokens = rng.integers(0, GPT2S["vocab_size"], shape).astype(np.float32)
    targets = rng.integers(0, GPT2S["vocab_size"], shape).astype(np.float32)
    batch = (tokens, targets)
    want_lse = 2 * GPT2S["num_layers"]
    print("fused dp overlap: the zoo TransformerLM at GPT-2 small's widths "
          "%s, dropout 0, per-token softmax, batch %d x %d over "
          "[gpu(0)] * 2 (%d a position), SGD %s, f32, TF32 off; expected "
          "flash LSE launches a step %d; card %s"
          % (GPT2S, OVERLAP_BATCH, GPT2S["seq_len"], OVERLAP_BATCH // 2,
             OVERLAP_SGD, want_lse, card_line()))
    e = params["transformerlm0_embed_weight"]
    nudged = dict(params, transformerlm0_embed_weight=(e * (
        1 + 1e-7 * rng.standard_normal(e.shape))).astype(np.float32))
    mono, mono_losses, mono_w, _ = overlap_run(
        mx, "fused dp monolithic", symbol, params, batch, {}, OVERLAP_STEPS)
    n_params = len(mono._fused_step.param_names)
    del mono
    _release()
    alt, alt_losses, alt_w, _ = overlap_run(
        mx, "fused dp monolithic (embedding moved by 1e-7)", symbol, nudged,
        batch, {}, OVERLAP_STEPS)
    del alt
    _release()
    K.reset_launch_counts()
    over, over_losses, over_w, launches = overlap_run(
        mx, "fused dp overlap", symbol, params, batch,
        {"MXNET_TPU_COMM_BUCKET_MB": OVERLAP_BUCKET_MB}, OVERLAP_STEPS)
    path = K.launch_counts()
    plan, counts = over._fused_step._comm_plan, over._fused_step.collectives
    del over
    _release()
    floor = _np_gaps(alt_w, mono_w, params)
    gap = _np_gaps(over_w, mono_w, params)
    limit = max(MODULE_REL, 4.0 * max(floor.values()))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(over_losses,
                                                        mono_losses))
    loss_floor = max(abs(a - b) / abs(b) for a, b in zip(alt_losses,
                                                          mono_losses))
    worst = max(gap, key=gap.get)
    print("fused dp overlap: bucketed (%s MB) against monolithic after %d "
          "steps: largest update gap %.3g (%s), floor %.3g, limit %.3g; "
          "losses relative %.3g (floor %.3g); all-reduces a step %d for %d "
          "buckets (monolithic: one a parameter, %d)"
          % (OVERLAP_BUCKET_MB, OVERLAP_STEPS, gap[worst], worst,
             max(floor.values()), limit, loss_gap, loss_floor,
             counts.get("all-reduce", 0), plan.n_buckets, n_params))
    if gap[worst] > limit or loss_gap > max(MODULE_REL, 4.0 * loss_floor):
        raise AssertionError("fused dp overlap: the bucketed path disagrees "
                             "with the monolithic one")
    if plan is None or plan.n_buckets < 2 \
            or counts.get("all-reduce") != plan.n_buckets:
        raise AssertionError("fused dp overlap: not one reduction a bucket")
    if any(l.get("flash_attn_fwd_lse", 0) != want_lse for l in launches):
        raise AssertionError("fused dp overlap: LSE launches %s, expected "
                             "%d" % (launches, want_lse))

    def two_bit(threshold):
        seen, real = [], mx.parallel.comm.quantize_flat

        def recording(flat, residual, t):
            codes, res = real(flat, residual, t)
            if len(seen) < 2:  # the first bucket of the eager first step
                seen.append((flat.detach().cpu(), codes.cpu()))
            return codes, res
        mx.parallel.comm.quantize_flat = recording
        try:
            mod, losses, _, _ = overlap_run(
                mx, "fused dp 2bit at %s" % threshold, symbol, params, batch,
                {"MXNET_TPU_COMM_BUCKET_MB": OVERLAP_BUCKET_MB,
                 "MXNET_TPU_GRAD_COMPRESS": "2bit",
                 "MXNET_TPU_GRAD_COMPRESS_THRESHOLD": threshold},
                OVERLAP_STEPS)
        finally:
            mx.parallel.comm.quantize_flat = real
        fs = mod._fused_step
        same = sum(torch.equal(codes, gc.quantize_flat(
            carry, torch.zeros_like(carry), float(threshold))[0])
            for carry, codes in seen)
        nonzero = sum(int((c.abs() >= float(threshold)).sum())
                      for c, _ in seen)
        print("fused dp 2bit at %s: the first bucket's codes on 2 positions "
              "(%d bytes each; %d of %d values at or past the threshold): "
              "bit for bit the host quantizer's in %d; all-gathers a step "
              "%d for %d buckets; wire %d bytes a position against %d f32; "
              "residuals nonzero: %s"
              % (threshold, seen[0][1].numel(), nonzero,
                 sum(c.numel() for c, _ in seen), same,
                 fs.collectives.get("all-gather", 0),
                 fs._comm_plan.n_buckets, fs._comm_plan.wire_bytes,
                 fs._comm_plan.grad_f32_bytes,
                 any(float(np.abs(np.asarray(r)).sum()) > 0
                     for r in fs._residuals)))
        if len(seen) != 2 or same != 2:
            raise AssertionError("fused dp 2bit: the card's codes differ "
                                 "from the host quantizer's")
        if fs.collectives.get("all-gather") != fs._comm_plan.n_buckets:
            raise AssertionError("fused dp 2bit: not one all-gather a "
                                 "bucket")
        del mod, fs
        _release()
        return [c for c, _ in seen]

    carries = two_bit(OVERLAP_THRESHOLD)
    # every 97th value: the quantile of a sample
    tenth = float(np.quantile(np.abs(torch.cat(carries).numpy()[::97]),
                              0.9))
    two_bit(repr(tenth))
    return path


def g2c_lstm(mx):
    """MXNet 1.0's model-parallel LSTM LM: the embedding, each unrolled
    ``mx.rnn.LSTMCell`` layer and the decoder in their own ``ctx_group``
    (example/model-parallel/lstm/lstm.py's layout) at LM's widths."""
    S = mx.sym
    with mx.AttrScope(ctx_group="embed"):
        h = S.Embedding(S.var("data"), input_dim=LM["vocab"],
                        output_dim=LM["embed"], name="embed")
    for i in range(LM["layers"]):
        with mx.AttrScope(ctx_group="layer%d" % i):
            cell = mx.rnn.LSTMCell(LM["hidden"], prefix="lstm_l%d_" % i)
            h, _ = cell.unroll(LM["bptt"], h, layout="NTC",
                               merge_outputs=i == LM["layers"] - 1)
    with mx.AttrScope(ctx_group="decode"):
        pred = S.FullyConnected(S.Reshape(h, shape=(-1, LM["hidden"])),
                                num_hidden=LM["vocab"], name="pred")
        label = S.Reshape(S.var("softmax_label"), shape=(-1,))
        return S.SoftmaxOutput(pred, label, name="softmax")


def group2ctx_lstm(mx, seed):
    """18c.  Returns the group2ctx run's launches."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    symbol = g2c_lstm(mx)
    shape = (LM["batch"], LM["bptt"])
    rng = np.random.default_rng(seed + 183)
    arg_shapes, _, _ = symbol.infer_shape(data=shape, softmax_label=shape)
    names = [n for n in symbol.list_arguments()
             if n not in ("data", "softmax_label")]
    weights = {n: (rng.uniform(-0.05, 0.05, s)).astype(np.float32)
               for n, s in zip(symbol.list_arguments(), arg_shapes)
               if n in names}
    batches = [(rng.integers(0, LM["vocab"], shape).astype(np.float32),
                rng.integers(0, LM["vocab"], shape).astype(np.float32))
               for _ in range(G2C_STEPS)]
    group2ctx = {g: getattr(mx, kind)(0)
                 for g, kind in G2C_CONTEXTS.items()}
    print("group2ctx lstm: a %d-layer unrolled LSTMCell LM (vocab %d, "
          "hidden %d, %d steps, batch %d; %.1fM parameters), group2ctx %s "
          "bound on gpu(0), SGD %s through get_updater, %d steps; card %s"
          % (LM["layers"], LM["vocab"], LM["hidden"], LM["bptt"],
             LM["batch"], sum(v.size for v in weights.values()) / 1e6,
             {g: str(c) for g, c in group2ctx.items()}, G2C_SGD, G2C_STEPS,
             card_line()))

    def run(placed):
        exe = symbol.simple_bind(mx.gpu(0), data=shape, softmax_label=shape,
                                 group2ctx=group2ctx if placed else None)
        for n, v in weights.items():
            exe.arg_dict[n][:] = v
        updater = mx.optimizer.get_updater(mx.optimizer.create(
            "sgd", rescale_grad=1.0 / LM["batch"], **G2C_SGD))
        out, ms = [], []
        for x, y in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.forward(is_train=True, data=x, softmax_label=y)
            exe.backward()
            for i, n in enumerate(names):
                updater(i, exe.grad_dict[n], exe.arg_dict[n])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append((exe.outputs[0].asnumpy(),
                        {n: exe.arg_dict[n].asnumpy() for n in names}))
        return exe, out, ms

    K.reset_launch_counts()
    placed, got, ms = run(True)
    path = K.launch_counts()
    on_host = {n: (str(placed.arg_dict[n].context),
                   placed.grad_dict[n].tensor.device.type)
               for n in ("embed_weight",)}
    _, want, plain_ms = run(False)
    same = [bool(np.array_equal(g[0], w[0]) and all(
        np.array_equal(g[1][n], w[1][n]) for n in names))
        for g, w in zip(got, want)]
    print("group2ctx lstm: ms per step %s (median after the first %.2f), "
          "the plain gpu(0) bind %s (%.2f); every step's outputs and "
          "weights bit for bit the plain bind's: %s; the embedding's weight "
          "and gradient on %s; card %s"
          % (", ".join("%.1f" % v for v in ms), float(np.median(ms[1:])),
             ", ".join("%.1f" % v for v in plain_ms),
             float(np.median(plain_ms[1:])), same, on_host, card_line()))
    if on_host["embed_weight"] != ("cpu(0)", "cpu"):
        raise AssertionError("group2ctx lstm: the embedding left the host")
    if not all(same):
        raise AssertionError("group2ctx lstm: a step differs from the plain "
                             "bind")
    return path


def train_fused_dp(mx, seed):
    """Phase 18.  Returns {path: launches}."""
    _release()
    clock = time.perf_counter()
    paths = {"module_resnet50_dp2_fused": fused_dp_resnet50(mx, seed)}
    _release()
    print("fused dp: 18a f32 in %.1f s" % (time.perf_counter() - clock))
    lap = time.perf_counter()
    paths["module_resnet50_dp2_fused_bf16"] = fused_dp_bf16(mx, seed)
    _release()
    print("fused dp: 18a bf16 in %.1f s" % (time.perf_counter() - lap))
    lap = time.perf_counter()
    paths["module_gpt2s_dp2_overlap"] = fused_dp_overlap(mx, seed)
    _release()
    print("fused dp: 18b in %.1f s" % (time.perf_counter() - lap))
    lap = time.perf_counter()
    paths["lstm_group2ctx"] = group2ctx_lstm(mx, seed)
    _release()
    print("fused dp: 18c in %.1f s" % (time.perf_counter() - lap))
    print("phase 18 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths


# -- phase 19: the dense op surface: MXNet 1.0's LeNet-STN through
# Module.fit, SSD-300's MultiBox head on ImageDetIter batches, the other
# dense ops at published sizes ---------------------------------------------

# LeNet-STN: MXNet 1.0's example/image-classification/symbols/lenet.py with
# add_stn=True, at phase 11's settings (train_mnist.py's: batch 64, SGD lr
# 0.05 momentum 0.9 wd 1e-4, one epoch of phase 11's files), f32
STN_HOST_STEPS = 3
# the localisation net's pools at batch 64: (label, pool, input shape,
# kernel, stride); the global average pool's kernel is its plane
STN_POOLS = (("stn-loc-pool", "max", (64, 30, 12, 12), (2, 2), (2, 2)),
             ("stn-loc-global", "avg", (64, 60, 6, 6), (6, 6), (1, 1)))
# SSD-300's multibox head (VGG16-reduced at 300x300; MXNet 1.0's
# example/ssd/symbol/symbol_factory.py): per feature map its side, the
# channels feeding it, sizes, ratios and step
SSD_MAPS = ((38, 512, (0.1, 0.141), (1, 2, 0.5), 8 / 300),
            (19, 1024, (0.2, 0.272), (1, 2, 0.5, 3, 1 / 3), 16 / 300),
            (10, 512, (0.37, 0.447), (1, 2, 0.5, 3, 1 / 3), 32 / 300),
            (5, 256, (0.54, 0.619), (1, 2, 0.5, 3, 1 / 3), 64 / 300),
            (3, 256, (0.71, 0.79), (1, 2, 0.5), 100 / 300),
            (1, 256, (0.88, 0.961), (1, 2, 0.5), 300 / 300))
SSD_ANCHORS = 8732
SSD_CLASSES = 21                # VOC's 20 and the background
SSD_VARIANCES = (0.1, 0.1, 0.2, 0.2)
SSD_DETECTION = dict(nms_threshold=0.45, nms_topk=400, threshold=0.01)
SSD_HOST_PICTURES = 2           # pictures of the batch the host repeats
NMS_FLIP_EPS = 1e-5             # an IoU this near the threshold may flip
# 19c: published sizes.  FlowNet-C's correlation (Dosovitskiy et al. 2015)
CORR_SHAPE = (4, 256, 48, 64)
CORR_ATTRS = dict(pad_size=20, kernel_size=1, max_displacement=20,
                  stride1=1, stride2=2)
# Fast R-CNN VGG16's ROI pooling (Girshick 2015): conv5_3 of a 600x1000
# image, 128 ROIs a picture, 7x7, 1/16
ROI_SHAPE = (1, 512, 38, 63)
ROI_COUNT = 128
ROI_HOST = 16                   # of the ROIs, repeated on the host
LINALG_BATCH, LINALG_N = 16, 512
LINALG_HOST = 4                 # of the matrices, repeated on the host
FFT_SHAPE = (64, 4096)
DENSE_REL = 1e-4                # outputs, relative to their scale
DENSE_GRAD_REL = 1e-3           # gradients, relative to their scale


def stn_lenet_symbol(mx):
    """LeNet-STN from ``mx.sym`` ops: the localisation net (conv 30 5x5
    stride 2, relu, max pool 2x2/2, conv 60 3x3 pad 1, relu, global avg
    pool, flatten, FullyConnected 6 "stn_loc" at lr_mult 0.01) feeding
    ``SpatialTransformer(target_shape=(28, 28))``, then LeNet."""
    S = mx.sym
    data = S.var("data")
    loc = S.Convolution(data, num_filter=30, kernel=(5, 5), stride=(2, 2))
    loc = S.Activation(loc, act_type="relu")
    loc = S.Pooling(loc, kernel=(2, 2), stride=(2, 2), pool_type="max")
    loc = S.Convolution(loc, num_filter=60, kernel=(3, 3), pad=(1, 1))
    loc = S.Activation(loc, act_type="relu")
    loc = S.Pooling(loc, global_pool=True, kernel=(2, 2), pool_type="avg")
    loc = S.Flatten(loc)
    loc = S.FullyConnected(loc, num_hidden=6, name="stn_loc",
                           weight=S.var("stn_loc_weight", lr_mult=0.01),
                           bias=S.var("stn_loc_bias", lr_mult=0.01))
    x = S.SpatialTransformer(data=data, loc=loc, target_shape=(28, 28),
                             transform_type="affine", sampler_type="bilinear")
    x = S.Convolution(x, kernel=(5, 5), num_filter=20)
    x = S.Activation(x, act_type="tanh")
    x = S.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = S.Convolution(x, kernel=(5, 5), num_filter=50)
    x = S.Activation(x, act_type="tanh")
    x = S.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = S.Flatten(x)
    x = S.FullyConnected(x, num_hidden=500)
    x = S.Activation(x, act_type="tanh")
    x = S.FullyConnected(x, num_hidden=10)
    return S.SoftmaxOutput(x, name="softmax")


def stn_start():
    """``stn_loc`` starts at the identity transform (the initializers'
    legacy ``stn_loc`` rule): weight 0, bias (1, 0, 0, 0, 1, 0)."""
    return {"stn_loc_weight": np.zeros((6, 60), np.float32),
            "stn_loc_bias": np.array([1, 0, 0, 0, 1, 0], np.float32)}


def check_stn_pools(seed):
    """Phase 2e: the pooling backwards at the LeNet-STN localisation net's
    pools (phase 19a's main path; post-ReLU inputs, ties; f32) against
    their plain versions, bit for bit, timed beside their bytes bound and
    the aten backward.  Returns ([], [(kernel, instance)])."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    aten = torch.ops.aten
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 190)
    pads = ((0, 0), (0, 0))
    out = []
    for label, pool, shape, kernel, stride in STN_POOLS:
        x = torch.clamp_min(torch.randn(*shape, generator=gen, device=dev),
                            0.0)
        oshape = tuple((shape[2 + i] - kernel[i]) // stride[i] + 1
                       for i in range(2))
        dy = torch.randn(shape[:2] + oshape, generator=gen, device=dev)
        if pool == "max":
            name = "max_pool_backward"
            run = lambda: K.max_pool_backward(  # noqa: E731
                x, dy, kernel, stride, pads)
            plain = lambda: K._plain_max_pool_backward(  # noqa: E731
                x, dy, kernel, stride, pads)
            _, idx = aten.max_pool2d_with_indices(x, kernel, stride, (0, 0))
            lib = lambda: aten.max_pool2d_with_indices_backward(  # noqa: E731
                dy, x, kernel, stride, (0, 0), (1, 1), False, idx)
            nbytes = _nbytes(x, dy) + x.numel() * x.element_size()
        else:
            name = "avg_pool_backward"
            div = torch.full(oshape, 1.0 / (kernel[0] * kernel[1]),
                             device=dev)
            run = lambda: K.avg_pool_backward(  # noqa: E731
                dy, div, shape, kernel, stride, pads)
            plain = lambda: K._plain_avg_pool_backward(  # noqa: E731
                dy, div, shape, kernel, stride, pads, torch.float32)
            lib = lambda: aten.avg_pool2d_backward(  # noqa: E731
                dy, x, kernel, stride, (0, 0), False, True, None)
            nbytes = _nbytes(dy, div) + x.numel() * x.element_size()
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        exact = bool(torch.equal(got, want))
        print("kernel %s %s %s f32 %dx%d/s%d: max_abs_err %.3g (bit for bit: "
              "%s) %s" % (name, label, "x".join(map(str, shape)), kernel[0],
                          kernel[1], stride[0], err, exact,
                          "ok" if exact else "FAIL"))
        if not exact:
            raise AssertionError("%s disagrees with its plain version at %s"
                                 % (name, label))
        ms, plain_ms, lib_ms = time_ms(run), time_ms(plain), time_ms(lib)
        bound = bytes_bound(nbytes)
        _report("kernel %s %s" % (name, label), ms, plain_ms, lib_ms, bound)
        b2b = time_ms_back_to_back(run)
        print("kernel %s %s, 20 calls back to back: %.4f ms a call (%.1f%% of "
              "the bound), library %.4f ms; device only: kernel %s, library "
              "%s" % (name, label, b2b, 100.0 * bound[0] / b2b,
                      time_ms_back_to_back(lib),
                      _device_text(device_ms_per_call(run)),
                      _device_text(device_ms_per_call(lib))))
        out.append((name, _instance(label, err, ms, plain_ms, bound, lib_ms)))
    return [], out


def stn_host_check(mx, seed, paths, symbol, arg0):
    """19a's card-vs-host check: from the fit's initial weights (``stn_loc``
    at the identity, where every sample coordinate is within rounding of
    a pixel, so the side ``floor`` falls on decides which cell the grid's
    gradient goes through), the host trajectory through ``Module`` on the
    fit's first batches of 64; then each step by ``teacher_forced_steps``
    through bound executors on the card and on the host, in float64 where
    ReLU units flip.  Card and host build the same float64 grid, bit for
    bit; the sampler's backward scatters with atomics on the card."""
    it = mnist_iter(mx, paths, "train", False, seed)
    batches = []
    for _ in range(STN_HOST_STEPS):
        b = next(it)
        batches.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    mod = mx.mod.Module(symbol, context=mx.cpu())
    mod.bind([("data", (MNIST_BATCH, 1, 28, 28))],
             [("softmax_label", (MNIST_BATCH,))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in arg0.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(MNIST_SGD))
    states = []
    for x, y in batches:
        states.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                                             [mx.nd.array(y, ctx=mx.cpu())]))
        mod.update()
    exes = {}
    for dtype in ("float32", "float64"):
        for where, ctx in (("card", mx.gpu(0)), ("host", mx.cpu())):
            exes[where, dtype] = symbol.simple_bind(
                ctx, grad_req={k: "write" for k in arg0},
                type_dict={k: dtype for k in symbol.list_arguments()},
                data=(MNIST_BATCH, 1, 28, 28), softmax_label=(MNIST_BATCH,))

    def run(where, state, x, y, dtype="float32"):
        exe = exes[where, dtype]
        ctx = mx.gpu(0) if where == "card" else mx.cpu()
        exe.copy_params_from({k: mx.nd.array(v, ctx=ctx, dtype=dtype)
                              for k, v in state.items()})
        exe.forward(is_train=True, data=mx.nd.array(x, ctx=ctx, dtype=dtype),
                    softmax_label=mx.nd.array(y, ctx=ctx, dtype=dtype))
        exe.backward()
        return (exe.outputs[0].asnumpy().astype(np.float64),
                {k: exe.grad_dict[k].asnumpy().astype(np.float64)
                 for k in arg0})

    teacher_forced_steps(
        "lenet-stn", run, states, batches, seed,
        lambda state, x: relu_flips(mx, symbol, state, x),
        lambda where, state, x, y: run(where, state, x, y, "float64"))


def train_lenet_stn(mx, seed, root):
    """19a.  Returns the fit's kernel launches."""
    import torch
    t0 = time.perf_counter()
    files = write_mnist(root, seed, MNIST_SIZES)
    print("lenet-stn: phase 11's MNIST files written again in %.1f s"
          % (time.perf_counter() - t0))
    symbol = stn_lenet_symbol(mx)
    per_step = expected_train_launches(symbol)
    print("lenet-stn: the graph's launches per step %s (3 max pools: the "
          "localisation net's and LeNet's two; the global average pool)"
          % per_step)
    mod, launches, (arg0, _) = fit_mnist(mx, seed, files, symbol, False,
                                         "lenet-stn", start=stn_start())
    theta = mod.get_params()[0]["stn_loc_bias"].asnumpy()
    print("lenet-stn: after the epoch stn_loc_bias %s (started at the "
          "identity)" % np.array2string(theta, precision=4))
    del mod
    torch.cuda.empty_cache()
    stn_host_check(mx, seed, files, symbol, arg0)
    return launches


def ssd_anchors(mx, ctx):
    """The six maps' ``MultiBoxPrior`` outputs, concatenated: [1, 8732, 4]."""
    parts = []
    for side, channels, sizes, ratios, step in SSD_MAPS:
        feat = mx.nd.zeros((1, channels, side, side), ctx=ctx)
        parts.append(mx.nd.contrib.MultiBoxPrior(
            feat, sizes=sizes, ratios=ratios, steps=(step, step)))
    return mx.nd.concat(*parts, dim=1)


def nms_flips(card, host, raw, thresh):
    """Rows whose suppression differs between two detection outputs
    [P, A, 6] (-1 class rows suppressed or invalid), with the classes and
    IoUs of ``raw`` [P, A, 6] (the card's decoded rows before
    suppression).  A flip is explained when some box of its class has an
    IoU with it within NMS_FLIP_EPS of ``thresh``, or when a box of its
    class that itself flipped overlaps it past ``thresh`` (a cascade).
    Returns (flips, unexplained, closest IoUs)."""
    import torch
    from mxnet_tpu_torch.ops.kernels import pairwise_iou
    flips, bad, closest = 0, 0, []
    for p in range(card.shape[0]):
        diff = np.flatnonzero((card[p, :, 0] < 0) != (host[p, :, 0] < 0))
        flips += len(diff)
        if not len(diff):
            continue
        boxes = torch.tensor(raw[p, :, 2:], dtype=torch.float32)
        cls = raw[p, :, 0]
        iou = pairwise_iou(boxes[diff], boxes).numpy()
        for row, j in enumerate(diff):
            same = cls == cls[j]
            same[j] = False
            gap = np.abs(iou[row][same] - thresh)
            near = float(gap.min()) if gap.size else float("inf")
            cascade = bool(((iou[row] > thresh) & same
                            & np.isin(np.arange(len(cls)), diff)).any())
            closest.append(near)
            bad += not (near <= NMS_FLIP_EPS or cascade)
    return flips, bad, closest


def ssd_multibox_head(mx, seed, root):
    """19b.  Returns {kernel: launches} of the head's calls on the card and
    the box_nms kernel's record."""
    import random as _pyrandom
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    card, host = mx.gpu(0), mx.cpu()
    rec, idx = (os.path.join(root, "det.rec"), os.path.join(root, "det.idx"))
    _pyrandom.seed(seed)
    np.random.seed(seed)
    it = mx.image.ImageDetIter(
        batch_size=DET_BATCH, data_shape=DET_SHAPE, path_imgrec=rec,
        path_imgidx=idx, shuffle=True, rand_crop=0.5, rand_pad=0.5,
        rand_mirror=True, mean=True, std=True)
    label = it.next().label[0].asnumpy()[..., :5]
    n_boxes = int((label[..., 0] >= 0).sum())
    rng = np.random.default_rng(seed + 191)
    n = DET_BATCH
    cls_pred = rng.standard_normal((n, SSD_CLASSES, SSD_ANCHORS),
                                   dtype=np.float32)
    logits = rng.standard_normal((n, SSD_CLASSES, SSD_ANCHORS),
                                 dtype=np.float32) * 2
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    loc = (rng.standard_normal((n, SSD_ANCHORS * 4), dtype=np.float32)
           * 0.5).astype(np.float32)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    anchors = ssd_anchors(mx, card)
    arrays = {k: mx.nd.array(v, ctx=card) for k, v in
              (("label", label), ("cls_pred", cls_pred), ("prob", prob),
               ("loc", loc))}
    target = mx.nd.contrib.MultiBoxTarget(
        anchors, arrays["label"], arrays["cls_pred"], overlap_threshold=0.5,
        variances=SSD_VARIANCES)
    det = mx.nd.contrib.MultiBoxDetection(
        arrays["prob"], arrays["loc"], anchors, variances=SSD_VARIANCES,
        **SSD_DETECTION)
    # the decoded rows before suppression: nothing overlaps past 1
    raw = mx.nd.contrib.MultiBoxDetection(
        arrays["prob"], arrays["loc"], anchors, variances=SSD_VARIANCES,
        nms_threshold=1.0, threshold=SSD_DETECTION["threshold"])
    again = mx.nd.contrib.box_nms(
        raw, overlap_thresh=SSD_DETECTION["nms_threshold"],
        valid_thresh=SSD_DETECTION["threshold"],
        topk=SSD_DETECTION["nms_topk"], coord_start=2, score_index=1,
        id_index=0)
    gt = label[label[..., 0] >= 0][:, 1:5]
    iou = mx.nd.contrib.box_iou(anchors.reshape((-1, 4)),
                                mx.nd.array(gt, ctx=card))
    torch.cuda.synchronize()
    head_s = time.perf_counter() - t0
    launches = K.launch_counts()
    a = anchors.asnumpy()
    det_c, raw_c, again_c = det.asnumpy(), raw.asnumpy(), again.asnumpy()
    kept = int((det_c[..., 0] >= 0).sum())
    print("ssd300: ImageDetIter batch of %d at %s (%d ground-truth boxes); "
          "MultiBoxPrior over the six maps %s: %d anchors; MultiBoxTarget, "
          "MultiBoxDetection (nms %.2f, topk %d, threshold %.2f), box_nms "
          "and box_iou on the card in %.3f s (first calls); %d of %d rows "
          "kept, %.1f a picture; box_nms launches %d; card %s"
          % (n, DET_SHAPE, n_boxes, [m[0] for m in SSD_MAPS], a.shape[1],
             SSD_DETECTION["nms_threshold"], SSD_DETECTION["nms_topk"],
             SSD_DETECTION["threshold"], head_s, kept, det_c[..., 0].size,
             kept / n, launches["box_nms"], card_line()))
    if a.shape != (1, SSD_ANCHORS, 4) or not np.isfinite(a).all():
        raise AssertionError("ssd300: %s anchors" % (a.shape,))
    if not np.array_equal(again_c, det_c):
        raise AssertionError("ssd300: box_nms over the decoded rows differs "
                             "from MultiBoxDetection's suppression")
    if not 0 < kept <= n * SSD_DETECTION["nms_topk"]:
        raise AssertionError("ssd300: %d rows kept" % kept)
    # the host: anchors, targets and IoUs of the whole batch; the
    # detections of SSD_HOST_PICTURES pictures
    pics = slice(0, SSD_HOST_PICTURES)
    anchors_h = ssd_anchors(mx, host)
    target_h = mx.nd.contrib.MultiBoxTarget(
        anchors_h, mx.nd.array(label, ctx=host),
        mx.nd.array(cls_pred, ctx=host), overlap_threshold=0.5,
        variances=SSD_VARIANCES)
    det_h = mx.nd.contrib.MultiBoxDetection(
        mx.nd.array(prob[pics], ctx=host), mx.nd.array(loc[pics], ctx=host),
        anchors_h, variances=SSD_VARIANCES, **SSD_DETECTION).asnumpy()
    iou_h = mx.nd.contrib.box_iou(anchors_h.reshape((-1, 4)),
                                  mx.nd.array(gt, ctx=host)).asnumpy()
    same_anchors = np.array_equal(a, anchors_h.asnumpy())
    (lt, lm, ct), (lth, lmh, cth) = ([t.asnumpy() for t in r]
                                     for r in (target, target_h))
    matched = int(lm.sum() // 4)
    target_err = float(np.abs(lt - lth).max() / max(1.0, np.abs(lth).max()))
    same_match = np.array_equal(lm, lmh) and np.array_equal(ct, cth)
    iou_same = np.array_equal(iou.asnumpy(), iou_h)
    both = (det_c[pics][..., 0] >= 0) & (det_h[..., 0] >= 0)
    box_err = float(np.abs(det_c[pics][both][:, 1:]
                           - det_h[both][:, 1:]).max())
    flips, bad, closest = nms_flips(det_c[pics], det_h, raw_c[pics],
                                    SSD_DETECTION["nms_threshold"])
    print("ssd300: card vs host: anchors bit for bit %s; MultiBoxTarget "
          "matches and classes bit for bit %s (%d anchors matched), "
          "location targets within %.3g of their scale (limit %g); box_iou "
          "[%d x %d] bit for bit %s; scores and boxes of the rows both keep "
          "max_abs_err %.3g over %d pictures; NMS decisions that differ %d%s, "
          "unexplained %d; card %s"
          % (same_anchors, same_match, matched, target_err, DENSE_REL,
             SSD_ANCHORS, len(gt), iou_same, box_err, SSD_HOST_PICTURES,
             flips, "" if not flips else " (IoU to the threshold %s)"
             % ", ".join("%.3g" % c for c in closest), bad, card_line()))
    if not (same_anchors and same_match and target_err <= DENSE_REL
            and iou_same and box_err <= DENSE_REL and bad == 0):
        raise AssertionError("ssd300: the head on the card disagrees with "
                             "the host")
    record = box_nms_record(raw, launches["box_nms"])
    return launches, record


def box_nms_record(raw, launches):
    """The box_nms kernel against its plain version on the card, on the
    head's decoded rows [32, 8732, 6] at SSD-300's settings: the keep
    flags bit for bit; the kernel (the sort and gathers around it
    included) timed beside the plain version's M-step sweep, and the
    bound: 13 f32 operations per same-class pair i < j of these rows at
    the CUDA cores' rate, or the rows' bytes at the memory rate."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    rows = raw.tensor
    scores = rows[..., 1]
    valid = scores > SSD_DETECTION["threshold"]
    order, rank = K.nms_order(scores)
    boxes, cls = rows[..., 2:6].contiguous(), rows[..., 0].contiguous()
    thresh = SSD_DETECTION["nms_threshold"]
    run = lambda: K.box_nms_keep(boxes, cls, valid, order, rank,  # noqa: E731
                                 thresh, False)
    plain = lambda: K._plain_box_nms_keep(  # noqa: E731
        boxes, cls, valid, order, rank, thresh, False)
    got = run()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    want = plain()
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    exact = bool(torch.equal(got, want))
    err = float((got != want).sum())
    ms = time_ms(run, reps=10)
    pairs = 0
    for c in cls.cpu().numpy():
        k = np.unique(c, return_counts=True)[1].astype(np.int64)
        pairs += int((k * (k - 1) // 2).sum())
    nbytes = _nbytes(boxes, cls, valid) + valid.numel()
    bound = _bound(13 * pairs, nbytes, PEAK_F32_FLOPS)
    n_words = (rows.shape[1] + 63) // 64
    print("kernel box_nms %dx%d (SSD-300's decoded rows, nms %.2f): keep flags "
          "bit for bit the plain version's: %s (%d differ); kernel %.4f ms "
          "(sort, gathers and both launches: mask of %d x %d words a "
          "picture, sweep), plain %.1f ms (%d steps), bound %.4f ms (%s: %d "
          "same-class pairs), roofline share %.1f%%; card %s"
          % (rows.shape[0], rows.shape[1], thresh, exact, err, ms,
             rows.shape[1], n_words, plain_ms, rows.shape[1], bound[0],
             bound[1], pairs, 100.0 * bound[0] / ms, card_line()))
    if not exact:
        raise AssertionError("box_nms disagrees with its plain version")
    return {"name": "box_nms", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/box_nms.cu", "replaces": None,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def _dense_call(name, inputs, attrs, n_diff, device, cts=None, gen=None,
                to_host=True):
    """One forward and backward of registered op ``name`` on ``device``,
    the cotangents ``cts`` or, when None, standard normals from ``gen``:
    (outputs, gradients of the first ``n_diff`` inputs, cotangents), on
    the host (``to_host``; else where they were computed, as when timed:
    the copies to and from the host are not the op's time)."""
    import torch
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op(name)
    at = op.normalize_attrs(attrs)
    ts = []
    for i, x in enumerate(inputs):
        t = torch.as_tensor(x).to(device)
        ts.append(t.requires_grad_(i < n_diff and t.is_floating_point()))
    outs = op.impl(*ts, **at)
    outs = (outs if isinstance(outs, tuple) else (outs,))[:op.str_outputs(at)]
    if cts is None:
        cts = [torch.randn(o.shape, generator=gen) for o in outs]
    live = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
    grads = []
    if live:
        grads = torch.autograd.grad([o for o, _ in live], ts[:n_diff],
                                    [c.to(device) for _, c in live],
                                    allow_unused=True)
    if not to_host:
        return outs, grads, cts
    return ([o.detach().cpu() for o in outs],
            [None if g is None else g.cpu() for g in grads], cts)


def _scaled_gap(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _dense_case(label, name, inputs, attrs, n_diff, host_inputs=None,
                pick=None, exact=False, compare=None, check_grads=True):
    """19c's check of one op: forward and backward on the card (timed,
    median of 5), the same on the host for ``host_inputs`` (default: the
    same inputs) and the cotangents at ``pick`` (a slice of the leading
    axis of the outputs and of the inputs' gradients; default: all), the
    card's outputs and gradients there against the host's within
    DENSE_REL / DENSE_GRAD_REL of their scale, or bit for bit (``exact``).
    ``compare(card_outs, host_outs) -> (gap, ok)`` replaces the outputs'
    comparison (syevd's eigenvector signs); ``check_grads`` False leaves
    the gradients unread (where the host ran a part of the card's work).
    Returns the card's ms."""
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(sum(map(ord, label)))
    on_card = [torch.as_tensor(x).to(dev) for x in inputs]
    outs, grads, cts = _dense_call(name, on_card, attrs, n_diff, dev, gen=gen)
    cts_card = [c.to(dev) for c in cts]
    ms = time_ms(lambda: _dense_call(name, on_card, attrs, n_diff, dev,
                                     cts_card, to_host=False),
                 reps=5, warmup=1)
    sel = (lambda t: t) if pick is None else (lambda t: t[pick])
    host_outs, host_grads, _ = _dense_call(
        name, host_inputs or inputs, attrs, n_diff, torch.device("cpu"),
        [sel(c) for c in cts])
    outs, grads = [sel(o) for o in outs], [g if g is None else sel(g)
                                           for g in grads]
    if compare is not None:
        out_gap, ok = compare(outs, host_outs)
    else:
        out_gap = max(_scaled_gap(c, h) for c, h in zip(outs, host_outs))
        ok = all(torch.equal(c, h) for c, h in zip(outs, host_outs)) \
            if exact else out_gap <= DENSE_REL
    grad_gap = 0.0
    for c, h in zip(grads, host_grads) if check_grads else ():
        ok &= (c is None) == (h is None)
        if c is not None and h is not None:
            grad_gap = max(grad_gap, _scaled_gap(c, h))
    finite = all(bool(torch.isfinite(o.double()).all()) for o in outs)
    ok = ok and grad_gap <= DENSE_GRAD_REL and finite
    print("dense %-30s forward%s on the card %.3f ms; card vs host%s: "
          "outputs %s %.3g, gradients %s (limits %g, %g) %s; card %s"
          % (label, " and backward" if grads else "", ms,
             "" if pick is None else " on [%s:%s]" % (pick.start, pick.stop),
             "bit for bit:" if exact else "within", out_gap,
             "%.3g" % grad_gap if check_grads else "not compared", DENSE_REL, DENSE_GRAD_REL, "ok" if ok else "FAIL", card_line()))
    if not ok:
        raise AssertionError("19c: %s on the card disagrees with the host"
                             % label)
    return ms


def dense_ops_at_size(mx, seed):
    """19c.  The other dense ops at published sizes, forward and backward,
    card against host; TF32 off."""
    import torch
    rng = np.random.default_rng(seed + 192)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    # FlowNet-C's cost volume; the host repeats the first pair (the pairs
    # are independent)
    a, b = normal(*CORR_SHAPE), normal(*CORR_SHAPE)
    _dense_case("Correlation FlowNet-C", "Correlation", [a, b], CORR_ATTRS,
                2, host_inputs=[a[:1], b[:1]], pick=slice(0, 1))
    # Fast R-CNN's ROI pooling over post-ReLU features (ties); the host
    # repeats the first ROI_HOST ROIs, against the card's run of the same
    data = np.maximum(normal(*ROI_SHAPE), 0)
    h, w = ROI_SHAPE[2] * 16, ROI_SHAPE[3] * 16
    xy = rng.uniform(0, [w - 32, h - 32], (ROI_COUNT, 2))
    wh = rng.uniform(32, 500, (ROI_COUNT, 2))
    rois = np.concatenate([np.zeros((ROI_COUNT, 1)), xy,
                           np.minimum(xy + wh, [w - 1, h - 1])],
                          1).astype(np.float32)
    attrs = {"pooled_size": (7, 7), "spatial_scale": 1 / 16}
    _dense_case("ROIPooling Fast R-CNN, %d ROIs" % ROI_HOST, "ROIPooling",
                [data, rois[:ROI_HOST]], attrs, 1)
    _dense_case("ROIPooling Fast R-CNN, %d ROIs" % ROI_COUNT, "ROIPooling",
                [data, rois], attrs, 1, host_inputs=[data, rois[:ROI_HOST]],
                pick=slice(0, ROI_HOST), exact=True, check_grads=False)
    # the linalg ops on SPD 512x512 f32 matrices (gelqf on 256x512); the
    # host repeats the first LINALG_HOST
    n, k = LINALG_BATCH, LINALG_N
    m = rng.random((n, k, k), dtype=np.float32)
    spd = (m @ np.swapaxes(m, -1, -2) / k + np.eye(k, dtype=np.float32))
    chol = np.linalg.cholesky(spd.astype(np.float64)).astype(np.float32)
    rhs = normal(n, k, 64)
    hp = slice(0, LINALG_HOST)

    def syevd_compare(card, host):
        """Eigenvalues card vs host within DENSE_REL of their scale; the
        eigenvectors, unique only up to sign, through the card's own
        backward error (U^T diag(L) U against the matrix, relative
        Frobenius) and orthogonality, each within DENSE_REL."""
        (cu, cl), (_, hl) = card, host
        a = torch.as_tensor(spd[hp]).double()
        a = (a + a.transpose(-1, -2)) / 2
        cu, cl = cu.double(), cl.double()
        eye = torch.eye(cu.shape[-1], dtype=torch.float64)

        def errors(u, lam):
            recon = u.transpose(-1, -2) @ (lam[..., None] * u)
            return (float((recon - a).norm() / a.norm()),
                    float((u @ u.transpose(-1, -2) - eye).norm()
                          / eye.norm()))

        parts = (_scaled_gap(cl, hl),) + errors(cu, cl)
        # the library's float32 routine on the same matrices, for the
        # record: the port decomposes in float64 because of it
        w, v = torch.linalg.eigh(a.float().cuda())
        lib = errors(v.transpose(-1, -2).double().cpu(), w.double().cpu())
        print("dense linalg syevd: eigenvalues card vs host %.3g of their "
              "scale; the card's backward error %.3g, orthogonality %.3g "
              "(torch.linalg.eigh in float32 on the card: %.3g, %.3g)"
              % (parts + lib))
        return max(parts), max(parts) <= DENSE_REL

    for label, name, ins, attrs, nd, extra in (
            ("linalg gemm", "linalg_gemm", [spd, spd, spd],
             {"alpha": 0.5, "beta": 2.0}, 3, {}),
            ("linalg gemm2", "linalg_gemm2", [spd, rhs], {"transpose_a": True},
             2, {}),
            ("linalg potrf", "linalg_potrf", [spd], {}, 1, {}),
            ("linalg potri", "linalg_potri", [chol], {}, 1, {}),
            ("linalg trsm", "linalg_trsm", [chol, rhs], {"alpha": 2.0}, 2,
             {}),
            ("linalg trmm", "linalg_trmm", [chol, rhs], {}, 2, {}),
            ("linalg syrk", "linalg_syrk", [spd], {"alpha": 0.5}, 1, {}),
            ("linalg sumlogdiag", "linalg_sumlogdiag", [chol], {}, 1, {}),
            ("linalg gelqf 256x512", "linalg_gelqf", [normal(n, k // 2, k)],
             {}, 1, {}),
            ("linalg syevd", "linalg_syevd", [spd], {}, 0,
             {"compare": syevd_compare})):
        _dense_case(label, name, ins, attrs, nd,
                    host_inputs=[x[hp] for x in ins], pick=hp, **extra)
    x = normal(*FFT_SHAPE)
    _dense_case("fft 64x4096", "fft", [x], {}, 1)
    _dense_case("ifft 64x8192", "ifft", [normal(FFT_SHAPE[0],
                                                 2 * FFT_SHAPE[1])], {}, 1)
    lo, hi = np.array([-3.0], np.float32), np.array([3.0], np.float32)
    _dense_case("quantize int8 64x4096", "quantize", [x, lo, hi],
                {"out_type": "int8"}, 0, exact=True)
    codes = rng.integers(0, 256, FFT_SHAPE).astype(np.uint8)
    _dense_case("dequantize uint8 64x4096", "dequantize", [codes, lo, hi],
                {}, 0)
    _dense_case("depth_to_space 32x256x38x38", "depth_to_space",
                [normal(32, 256, 38, 38)], {"block_size": 2}, 1, exact=True)
    _dense_case("space_to_depth 32x64x76x76", "space_to_depth",
                [normal(32, 64, 76, 76)], {"block_size": 2}, 1, exact=True)
    _dense_case("Crop 32x64x112x112 to 100", "Crop",
                [normal(32, 64, 112, 112)],
                {"offset": (6, 6), "h_w": (100, 100)}, 1, exact=True)
    _dense_case("smooth_l1 32x34928", "smooth_l1",
                [normal(32, SSD_ANCHORS * 4)], {"scalar": 1.0}, 1)
    _dense_case("khatri_rao 512x64, 256x64", "khatri_rao",
                [normal(512, 64), normal(256, 64)], {}, 2, exact=True)
    torch.cuda.synchronize()


def train_dense_ops(mx, seed, root):
    """Phase 19 over phase 14's detection records under ``root``.  Returns
    ({path: launches}, the box_nms kernel's record)."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    clock = time.perf_counter()
    paths = {}
    K.reset_launch_counts()
    paths["module_lenet_stn"] = train_lenet_stn(mx, seed, root)
    lap = time.perf_counter()
    print("phase 19a in %.1f s" % (lap - clock))
    paths["ssd300_multibox"], record = ssd_multibox_head(mx, seed, root)
    print("phase 19b in %.1f s" % (time.perf_counter() - lap))
    lap = time.perf_counter()
    dense_ops_at_size(mx, seed)
    print("phase 19c in %.1f s" % (time.perf_counter() - lap))
    torch.cuda.synchronize()
    print("phase 19 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths, record


# -- phase 20: the detection ops and sparse storage -------------------------

# 20a: Faster R-CNN VGG16 (MXNet 1.0's example/rcnn symbol_vgg.py
# get_vgg_test at rcnn/config.py's TEST settings)
RCNN_SHAPE = (3, 600, 1000)
RCNN_PROPOSAL = dict(rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                     rpn_nms_thresh=0.7, rpn_min_size=16)
RCNN_ANCHORS = 9
RCNN_REPS = 5
# 20b: Deformable R-FCN (msracver/Deformable-ConvNets rfcn/symbols/
# resnet_v1_101_rfcn_dcn.py and resnet_v1_101_rfcn.py) at 1/16 of 600x1000
RFCN_RES5 = (1, 512, 38, 63)
DCN_PATH_FORWARDS = 3   # 20b's counted forwards and backwards
DCN_ATTRS = dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2), num_filter=512,
                 num_deformable_group=4, no_bias=True)
PSROI_MAPS = (("cls", 21), ("bbox", 8))     # output_dim; 49 x that channels
PSROI_ATTRS = dict(pooled_size=7, group_size=7, spatial_scale=0.0625)
DPSROI_ATTRS = dict(pooled_size=7, group_size=7, part_size=7,
                    sample_per_part=4, trans_std=0.1, spatial_scale=0.0625)
SKETCH = (25088, 512, 8192)     # compact bilinear pooling (Gao et al. 2016)
MATCH_SHAPE = (32, 50, 8732)
MATCH_HOST = 2
# 20c: example/sparse/linear_classification.py over avazu-app's width
AVAZU_FEATURES = 1000000
AVAZU_BATCH = 8192
AVAZU_BATCHES = 20
AVAZU_FIELDS = 15
AVAZU_HOST_STEPS = 3
SPARSE_REL = 1e-5


def rcnn_weights(mx, symbol, shapes, seed, ctx):
    """Seeded weights made on ``ctx``: He-scaled layers, the RPN's class
    head at 1/sqrt(fan_in) and its box head at std 0.01 (scores spread,
    deltas small, neither saturated), zero biases."""
    import torch
    dev = ctx.torch_device()
    g = torch.Generator(device=dev).manual_seed(seed)
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    params = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("bias"):
            t = torch.zeros(shape, device=dev)
        else:
            fan_in = int(np.prod(shape[1:]))
            std = {"rpn_cls_score_weight": (1.0 / fan_in) ** 0.5,
                   "rpn_bbox_pred_weight": 0.01}.get(name,
                                                     (2.0 / fan_in) ** 0.5)
            t = torch.randn(shape, generator=g, device=dev) * std
        params[name] = mx.nd.NDArray(t)
    return params


def rcnn_module(mx, batch, ctx, params=None, seed=0):
    """get_vgg_test at batch ``batch`` bound for inference on ``ctx``, its
    outputs followed by the RPN's scores and deltas; (module, params)."""
    from mxnet_tpu_torch.models import rcnn_vgg
    net = rcnn_vgg.get_vgg_test(batch_images=batch, **RCNN_PROPOSAL)
    inner = net.get_internals()
    probe = mx.sym.Group([net, inner["rpn_cls_prob_reshape_output"],
                          inner["rpn_bbox_pred_output"]])
    shapes = {"data": (batch,) + RCNN_SHAPE, "im_info": (batch, 3)}
    if params is None:
        params = rcnn_weights(mx, net, shapes, seed, ctx)
    mod = mx.mod.Module(probe, data_names=("data", "im_info"),
                        label_names=None, context=ctx)
    mod.bind(data_shapes=list(shapes.items()), for_training=False)
    mod.set_params(params, {})
    return mod, params


def rcnn_forward(mx, mod, data, info, ctx):
    import torch
    mod.forward(mx.io.DataBatch([mx.nd.array(data, ctx=ctx),
                                 mx.nd.array(info, ctx=ctx)]),
                is_train=False)
    outs = mod.get_outputs()
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()
    return outs


def proposal_slot_check(tag, card, host, thresh, rel):
    """Compare two runs' rois [P, 5] slot by slot; a first differing slot
    must be a suppression decision within NMS_FLIP_EPS of ``thresh``
    (either run's box at that slot overlaps a box kept before it that
    closely) or two near-equal scores swapped.  Returns the number of
    leading slots that agree."""
    import torch
    from mxnet_tpu_torch.ops.kernels import proposal_iou
    tol = rel * max(1.0, float(np.abs(host).max()))
    same = np.abs(card - host).max(1) <= tol
    if same.all():
        return len(same)
    s = int(np.flatnonzero(~same)[0])
    near = []
    for boxes in (card, host):
        if s:
            b = torch.tensor(boxes[:, 1:])
            iou = proposal_iou(b[s][None], b[None, :s])[0].numpy()
            near.append(float(np.abs(iou - thresh).min()))
    swap = s + 1 < len(same) and np.abs(card[s] - host[s + 1]).max() <= tol \
        and np.abs(card[s + 1] - host[s]).max() <= tol
    explained = swap or (near and min(near) <= NMS_FLIP_EPS)
    print("%s: rois differ from slot %d of %d (IoU to the threshold %s, a "
          "swap of near-equal scores %s): %s"
          % (tag, s, len(same), ", ".join("%.3g" % n for n in near), swap,
             "explained" if explained else "UNEXPLAINED"))
    if not explained:
        raise AssertionError("%s: an unexplained proposal differs" % tag)
    return s


def proposal_nms_record(mx, prob, deltas, info, launches):
    """The box_nms kernel in Proposal's mode against its plain version on
    the card, on 20a's 6,000 sorted boxes: keep flags bit for bit, one
    call and device ms beside the plain loop's ms and the bound (15 f32
    operations per pair i < j at the CUDA cores' rate, or the boxes' and
    flags' bytes)."""
    import torch
    from mxnet_tpu_torch.ops import detection_ops as D
    from mxnet_tpu_torch.ops import kernels as K
    anchors = D._gen_anchors(16, (8, 16, 32), (0.5, 1, 2))
    boxes, _ = D.proposal_candidates(
        prob[:, RCNN_ANCHORS:], deltas, info, anchors, 16.0,
        RCNN_PROPOSAL["rpn_pre_nms_top_n"],
        float(RCNN_PROPOSAL["rpn_min_size"]))
    boxes = boxes.contiguous()
    thresh = RCNN_PROPOSAL["rpn_nms_thresh"]
    run = lambda: K.proposal_nms_keep(boxes, thresh)  # noqa: E731
    got = run()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    want = K._plain_proposal_nms_keep(boxes, thresh)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    exact = bool(torch.equal(got, want))
    err = float((got != want).sum())
    ms = time_ms(run, reps=20)
    b2b = time_ms_back_to_back(run)
    dev = device_ms_per_call(run)
    m = boxes.shape[1]
    pairs = boxes.shape[0] * m * (m - 1) // 2
    bound = _bound(15 * pairs, _nbytes(boxes) + got.numel(), PEAK_F32_FLOPS)
    print("kernel box_nms, Proposal's mode, %d sorted boxes (threshold %.1f): "
          "keep flags bit for bit the plain loop's: %s (%d differ, %d kept); "
          "one call %.4f ms (the launches and their scratch), back to back "
          "%.4f, device %s, plain %.1f ms (%d steps), bound %.4f ms (%s: %d "
          "pairs x 15), roofline share %.2f%%; card %s"
          % (m, thresh, exact, err, int(got.sum()), ms, b2b, _device_text(dev),
             plain_ms, m, bound[0], bound[1], pairs, 100.0 * bound[0] / ms,
             card_line()))
    if not exact:
        raise AssertionError("box_nms in Proposal's mode disagrees with its "
                             "plain version")
    return {"instance": "proposal-6000", "launches": launches,
            "max_abs_err": err, "ms": ms, "b2b_ms": b2b,
            "device_ms": None if dev is None else dev[0],
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def faster_rcnn_serve(mx, seed):
    """20a.  Returns ({kernel: launches} of the served forwards, the
    Proposal instance's record, batch 1's rois as numpy)."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.ops.registry import get_op
    card, host = mx.gpu(0), mx.cpu()
    rng = np.random.default_rng(seed + 200)
    pics = rng.standard_normal((2,) + RCNN_SHAPE, dtype=np.float32)
    info = np.array([[RCNN_SHAPE[1], RCNN_SHAPE[2], 1.0]] * 2, np.float32)
    t0 = time.perf_counter()
    mod1, params = rcnn_module(mx, 1, card, seed=seed + 200)
    mod2, _ = rcnn_module(mx, 2, card, params=params)
    bind_s = time.perf_counter() - t0
    rcnn_forward(mx, mod1, pics[:1], info[:1], card)   # warm-up
    rcnn_forward(mx, mod2, pics, info, card)
    K.reset_launch_counts()
    times1, times2 = [], []
    for _ in range(RCNN_REPS):
        t = time.perf_counter()
        out1 = rcnn_forward(mx, mod1, pics[:1], info[:1], card)
        times1.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        out2 = rcnn_forward(mx, mod2, pics, info, card)
        times2.append((time.perf_counter() - t) * 1e3)
    launches = K.launch_counts()
    if launches["box_nms"] != 2 * RCNN_REPS:
        raise AssertionError("faster-rcnn: %d suppression launches in %d "
                             "forwards" % (launches["box_nms"], 2 * RCNN_REPS))
    c1 = [o.asnumpy() for o in out1]
    c2 = [o.asnumpy() for o in out2]
    prob, deltas = out1[3].tensor, out1[4].tensor
    prop = get_op("_contrib_Proposal")
    attrs = prop.normalize_attrs(dict(
        scales=(8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
        rpn_pre_nms_top_n=RCNN_PROPOSAL["rpn_pre_nms_top_n"],
        rpn_post_nms_top_n=RCNN_PROPOSAL["rpn_post_nms_top_n"],
        threshold=RCNN_PROPOSAL["rpn_nms_thresh"],
        rpn_min_size=RCNN_PROPOSAL["rpn_min_size"]))
    info_t = torch.tensor(info[:1], device=prob.device)
    with torch.no_grad():
        prop_ms = time_ms(lambda: prop.impl(prob, deltas, info_t, **attrs),
                          reps=10)
    # the host run of picture 0
    t = time.perf_counter()
    host_params = {k: v.copyto(host) for k, v in params.items()}
    modh, _ = rcnn_module(mx, 1, host, params=host_params)
    h1 = [o.asnumpy() for o in rcnn_forward(mx, modh, pics[:1], info[:1],
                                            host)]
    host_s = time.perf_counter() - t
    post = RCNN_PROPOSAL["rpn_post_nms_top_n"]
    agree = proposal_slot_check("faster-rcnn card vs host", c1[0], h1[0],
                                RCNN_PROPOSAL["rpn_nms_thresh"], DENSE_REL)
    gaps = [_scaled_gap(torch.tensor(c[0][:agree]), torch.tensor(h[0][:agree]))
            for c, h in zip(c1[1:3], h1[1:3])]
    agree2 = proposal_slot_check("faster-rcnn batch 2 picture 0 vs batch 1",
                                 c2[0][:post], c1[0],
                                 RCNN_PROPOSAL["rpn_nms_thresh"], DENSE_REL)
    gaps2 = [_scaled_gap(torch.tensor(c[0][:agree2]),
                         torch.tensor(h[0][:agree2]))
             for c, h in zip(c2[1:3], c1[1:3])]
    finite = all(np.isfinite(x).all() for x in c1 + c2)
    ids = np.repeat(np.arange(2), post)
    ok = (finite and max(gaps + gaps2) <= DENSE_REL and agree >= post // 2
          and agree2 >= post // 2 and np.array_equal(c2[0][:, 0], ids)
          and c1[0].shape == (post, 5) and c1[1].shape == (1, post, 21)
          and c1[2].shape == (1, post, 84))
    print("faster-rcnn vgg16 %s, %d proposals of %d: bind %.1f s; forward "
          "batch 1 (Proposal) %.2f ms (median of %d, %.2f-%.2f), batch 2 "
          "(MultiProposal) %.2f ms (%.2f-%.2f); Proposal alone %.3f ms (one "
          "call); suppression launches %d in %d forwards (one a forward, "
          "both pictures in one); card vs host (%.1f s): rois agree on %d "
          "slots, cls_prob and bbox_pred within %.3g, %.3g of scale; batch "
          "2's picture 0 vs batch 1: %d slots, %.3g, %.3g (limit %g): %s; "
          "card %s"
          % ("x".join(map(str, RCNN_SHAPE)), post,
             RCNN_PROPOSAL["rpn_pre_nms_top_n"], bind_s,
             float(np.median(times1)), RCNN_REPS, min(times1), max(times1),
             float(np.median(times2)), min(times2), max(times2), prop_ms,
             launches["box_nms"], 2 * RCNN_REPS, host_s, agree, gaps[0],
             gaps[1], agree2, gaps2[0], gaps2[1], DENSE_REL,
             "ok" if ok else "FAIL", card_line()))
    if not ok:
        raise AssertionError("faster-rcnn: the served network disagrees")
    record = proposal_nms_record(mx, prob, deltas, info_t, launches["box_nms"])
    return launches, record, c1[0]


def deformable_im2col_record(data, off, launches):
    """The im2col kernel against its plain version on the card at res5's
    branch2b: the column bit for bit; one call and device ms beside the
    plain version, the op's forward alone and the bound (the input and
    offsets read once and the column written once at the memory rate, or
    20 f32 operations an element)."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    geometry = (DCN_ATTRS["kernel"], (1, 1), DCN_ATTRS["pad"],
                DCN_ATTRS["dilate"], DCN_ATTRS["num_deformable_group"])
    run = lambda: K.deformable_im2col(data, off, *geometry)  # noqa: E731
    got = run()
    want = K._plain_deformable_im2col(data, off, *geometry)
    exact = bool(torch.equal(got, want))
    rel = float((got - want).abs().max()) / max(1.0,
                                                float(want.abs().max()))
    ms = time_ms(run, reps=20)
    b2b = time_ms_back_to_back(run)
    dev = device_ms_per_call(run)
    plain_ms = time_ms(lambda: K._plain_deformable_im2col(data, off,
                                                          *geometry), reps=5)
    library = _grid_sample_im2col(data, off, *geometry)
    lib_rel = _scaled_gap(library(), want)
    library_ms = time_ms(library, reps=20)
    bound = _bound(20 * got.numel(), _nbytes(data, off, got), PEAK_F32_FLOPS)
    print("kernel deformable_im2col %s -> %s (DCN res5 branch2b, 4 "
          "deformable groups): column bit for bit the plain version's: %s "
          "(max relative %.3g); one call %.4f ms, back to back %.4f, device "
          "%s, plain %.4f ms (four gathers and the weights in torch ops), "
          "grid_sample %.4f ms (within %.3g of scale of the plain column), "
          "bound %.4f ms (%s: %.1f MB), roofline share %.1f%%; card %s"
          % (tuple(data.shape), tuple(got.shape), exact, rel, ms, b2b,
             _device_text(dev), plain_ms, library_ms, lib_rel, bound[0],
             bound[1], _nbytes(data, off, got) / 1e6, 100.0 * bound[0] / ms,
             card_line()))
    if not (exact or rel <= 1e-6):
        raise AssertionError("deformable_im2col disagrees with its plain "
                             "version")
    if lib_rel > 1e-4:
        raise AssertionError("grid_sample does not compute the column "
                             "(%.3g of scale)" % lib_rel)
    return {"name": "deformable_im2col", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/deformable_im2col.cu",
            "replaces": None, "launches": launches, "max_abs_err": rel,
            "ms": ms, "b2b_ms": b2b,
            "device_ms": None if dev is None else dev[0],
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def _grid_sample_im2col(data, off, kernel, stride, pad, dilate, dg):
    """The column as one library call, timed beside the kernel: torch's
    ``grid_sample`` (bilinear, zeros outside, corners aligned) over the
    data as [N * DG, C / DG, H, W] at the taps' points as a
    [N * DG, kh * kw * Ho, Wo] grid, built here once.  A corner outside
    the map weighs zero, the JAX package's per-corner rule."""
    import torch
    N, C, H, W = data.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, pad, dilate
    Ho, Wo = off.shape[2], off.shape[3]
    dev = data.device
    by = (torch.arange(kh, device=dev) * dh)[:, None, None, None] \
        + (torch.arange(Ho, device=dev) * sh - ph)[None, None, :, None]
    bx = (torch.arange(kw, device=dev) * dw)[None, :, None, None] \
        + (torch.arange(Wo, device=dev) * sw - pw)[None, None, None, :]
    o = off.reshape(N, dg, kh, kw, 2, Ho, Wo)
    y = by.to(torch.float32) + o[:, :, :, :, 0]
    x = bx.to(torch.float32) + o[:, :, :, :, 1]
    grid = torch.stack([x * (2.0 / (W - 1)) - 1, y * (2.0 / (H - 1)) - 1],
                       -1).reshape(N * dg, kh * kw * Ho, Wo, 2)
    src = data.reshape(N * dg, C // dg, H, W)
    return lambda: torch.nn.functional.grid_sample(
        src, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True).reshape(N, C, kh, kw, Ho, Wo)


def rfcn_ops_at_size(mx, seed, rois):
    """20b.  Returns ({kernel: launches} of the ops' calls on the card, the
    im2col kernel's record)."""
    import torch
    from mxnet_tpu_torch.ops import kernels as K
    from mxnet_tpu_torch.ops.registry import get_op
    rng = np.random.default_rng(seed + 201)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    feat = np.maximum(normal(*RFCN_RES5), 0)
    c = RFCN_RES5[1]
    # the branch's offsets from a seeded 3x3 conv of its input (the DCN's
    # res5 offset conv: 72 channels, pad 2, dilate 2), a few pixels
    w_off = normal(72, c, 3, 3) * (2.0 / (c * 9)) ** 0.5
    off = torch.nn.functional.conv2d(
        torch.tensor(feat), torch.tensor(w_off), padding=2,
        dilation=2).numpy()
    weight = normal(c, c, 3, 3) * (2.0 / (c * 9)) ** 0.5
    dcn_ms = _dense_case("DeformableConvolution R-FCN res5b", 
                         "_contrib_DeformableConvolution",
                         [feat, off, weight], DCN_ATTRS, 3)
    op = get_op("_contrib_DeformableConvolution")
    at = op.normalize_attrs(DCN_ATTRS)
    ins = [torch.tensor(x).cuda() for x in (feat, off, weight)]
    with torch.no_grad():
        fwd_ms = time_ms(lambda: op.impl(*ins, **at), reps=5)
    print("dense DeformableConvolution R-FCN res5b: forward alone %.3f ms, "
          "the backward (the plain version recomputed under autograd) "
          "%.3f ms; card %s" % (fwd_ms, dcn_ms - fwd_ms, card_line()))
    for label, dim in PSROI_MAPS:
        data = normal(1, dim * 49, RFCN_RES5[2], RFCN_RES5[3])
        attrs = dict(PSROI_ATTRS, output_dim=dim)
        _dense_case("PSROIPooling %s %dx%d, %d ROIs" % (label, dim * 49, dim,
                                                        len(rois)),
                    "_contrib_PSROIPooling", [data, rois], attrs, 1)
        trans = normal(len(rois), 2, 7, 7)
        dattrs = dict(DPSROI_ATTRS, output_dim=dim)
        _dense_case("DeformablePSROIPooling %s offsets" % label,
                    "_contrib_DeformablePSROIPooling", [data, rois, trans],
                    dattrs, 3)
        _dense_case("DeformablePSROIPooling %s no_trans" % label,
                    "_contrib_DeformablePSROIPooling", [data, rois],
                    dict(dattrs, no_trans=True), 1)
    n, d, out = SKETCH
    _dense_case("count_sketch %dx%d -> %d" % (n, d, out),
                "_contrib_count_sketch",
                [normal(n, d), rng.integers(0, out, d).astype(np.float32),
                 rng.choice([-1.0, 1.0], d).astype(np.float32)],
                {"out_dim": out}, 1)
    score = rng.random(MATCH_SHAPE, dtype=np.float32)
    _dense_case("bipartite_matching %s" % "x".join(map(str, MATCH_SHAPE)),
                "_contrib_bipartite_matching", [score],
                {"threshold": 0.1}, 0, host_inputs=[score[:MATCH_HOST]],
                pick=slice(0, MATCH_HOST), exact=True)
    # the path: DCN_PATH_FORWARDS forwards and backwards through the
    # user's entry point, the counts from 0 just before; one launch a
    # forward, none from the backward (it recomputes the plain version)
    ctx = mx.gpu(0)
    nds = [mx.nd.array(x, ctx=ctx) for x in (feat, off, weight)]
    for a in nds:
        a.attach_grad()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for _ in range(DCN_PATH_FORWARDS):
        with mx.autograd.record():
            y = mx.nd.contrib.DeformableConvolution(
                data=nds[0], offset=nds[1], weight=nds[2], **DCN_ATTRS)
        y.backward()
    torch.cuda.synchronize()
    launches = K.launch_counts()
    others = sum(n for k, n in launches.items() if k != "deformable_im2col")
    print("dense DeformableConvolution R-FCN res5b through "
          "mx.nd.contrib: %d im2col launches in %d forwards and backwards "
          "(one a forward), %d of other kernels"
          % (launches["deformable_im2col"], DCN_PATH_FORWARDS, others))
    if launches["deformable_im2col"] != DCN_PATH_FORWARDS or others:
        raise AssertionError("20b: DeformableConvolution launched %s, want "
                             "one im2col a forward" % launches)
    record = deformable_im2col_record(ins[0], ins[1],
                                      launches["deformable_im2col"])
    return launches, record


def write_avazu(path, seed):
    """A LibSVM file of AVAZU_BATCHES x AVAZU_BATCH rows at avazu-app's
    width: one one-valued feature in each of AVAZU_FIELDS fields (disjoint
    id ranges, ids skewed towards each range's start), labels from a
    seeded hidden weight (about a fifth positive)."""
    rng = np.random.default_rng(seed + 202)
    rows = AVAZU_BATCHES * AVAZU_BATCH
    span = AVAZU_FEATURES // AVAZU_FIELDS
    u = rng.random((rows, AVAZU_FIELDS))
    cols = (np.arange(AVAZU_FIELDS) * span
            + np.floor(span * u ** 3)).astype(np.int64)
    hidden = rng.standard_normal(AVAZU_FEATURES).astype(np.float32)
    score = hidden[cols].sum(1) + rng.standard_normal(rows)
    labels = (score > np.quantile(score, 0.8)).astype(int)
    with open(path, "w") as f:
        f.write("\n".join("%d %s" % (y, " ".join("%d:1" % c for c in r))
                          for y, r in zip(labels, cols.tolist())))
        f.write("\n")
    return cols


def avazu_steps(mx, ctx, make_opt, batches, w0, sync_check=False):
    """The linear model's loop over ``batches`` [(csr, label)] on ``ctx``:
    weight and bias in a 'local' store, ``row_sparse_pull`` of the batch's
    columns, ``sparse.dot`` forward, the mean log loss, the transposed
    dot, the gradient retained to the pulled columns and pushed.  Returns
    (final weight as numpy, losses, {span: [ms]} on a card)."""
    import torch
    on_card = ctx.device_type == "gpu"
    kv = mx.kv.create("local")
    kv.init("w", mx.nd.array(w0, ctx=ctx))
    kv.init("b", mx.nd.zeros((1,), ctx=ctx))
    kv.set_optimizer(make_opt())
    w = mx.nd.sparse.zeros("row_sparse", (AVAZU_FEATURES, 1), ctx=ctx)
    b = mx.nd.zeros((1,), ctx=ctx)
    every = mx.nd.arange(0, AVAZU_FEATURES, ctx=ctx, dtype="int64")
    losses, marks = [], []
    guard = (lambda: _sync_guard()) if sync_check and on_card \
        else contextlib.nullcontext
    for x, y in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
            if on_card else None
        if ev:
            ev[0].record()
        with guard():
            kv.row_sparse_pull("w", out=w, row_ids=x.indices)
        kv.pull("b", out=b)
        if ev:
            ev[1].record()
        p = mx.nd.sigmoid(mx.nd.sparse.dot(x, w.todense()) + b)
        yb = y.reshape((-1, 1))
        losses.append(-mx.nd.mean(yb * mx.nd.log(p + 1e-12)
                                  + (1 - yb) * mx.nd.log(1 - p + 1e-12)))
        err = (p - yb) / x.shape[0]
        g = mx.nd.sparse.dot(x, err, transpose_a=True)
        if ev:
            ev[2].record()
        with guard():
            grad = mx.nd.sparse.RowSparseNDArray(
                g, every, (AVAZU_FEATURES, 1)).retain(w.indices)
            kv.push("w", grad)
        kv.push("b", mx.nd.sum(err).reshape((1,)))
        if ev:
            ev[3].record()
            marks.append(ev)
    w_out = mx.nd.zeros((AVAZU_FEATURES, 1), ctx=ctx)
    kv.pull("w", out=w_out)
    spans = {}
    if on_card:
        torch.cuda.synchronize()
        for name, (a, z) in (("pull", (0, 1)), ("dot", (1, 2)),
                             ("push", (2, 3)), ("step", (0, 3))):
            spans[name] = [e[a].elapsed_time(e[z]) for e in marks]
    return w_out.asnumpy(), [float(v.asscalar()) for v in losses], spans


@contextlib.contextmanager
def _sync_guard():
    """Any host sync inside the block raises (torch's sync debug mode)."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def sparse_linear_avazu(mx, seed, root):
    """20c.  Returns {} (no hand kernel on this path) after its checks."""
    import torch
    card, host = mx.gpu(0), mx.cpu()
    path = os.path.join(root, "avazu.libsvm")
    t0 = time.perf_counter()
    cols = write_avazu(path, seed)
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(AVAZU_FEATURES,),
                          batch_size=AVAZU_BATCH)
    host_batches = [(b.data[0], b.label[0]) for b in it]
    batches = [(x.as_in_context(card), y.as_in_context(card))
               for x, y in host_batches]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 203)
    w0 = (rng.standard_normal((AVAZU_FEATURES, 1)) * 0.01).astype(np.float32)
    touched = np.zeros(AVAZU_FEATURES, bool)
    touched[cols] = True
    opts = (("sgd", lambda: mx.optimizer.SGD(learning_rate=0.5,
                                             momentum=0.9)),
            ("adam", lambda: mx.optimizer.Adam(learning_rate=0.01)))
    ok = True
    for name, make in opts:
        k = AVAZU_HOST_STEPS
        wc, _, _ = avazu_steps(mx, card, make, batches[:k], w0)
        wh, _, _ = avazu_steps(mx, host, make, host_batches[:k], w0)
        gap = float(np.abs(wc - wh).max()) / max(1.0, float(np.abs(wh).max()))
        w, losses, spans = avazu_steps(mx, card, make, batches, w0,
                                       sync_check=True)
        kept = bool(np.array_equal(w[~touched], w0[~touched]))
        falls = np.mean(losses[-3:]) < np.mean(losses[:3])
        med = {k2: float(np.median(v[1:])) for k2, v in spans.items()}
        part_ok = gap <= SPARSE_REL and kept and falls \
            and np.isfinite(w).all()
        ok &= part_ok
        print("sparse-linear avazu %s: %d features, %d batches of %d (15 "
              "one-valued features a row, %d rows touched): log loss %.4f "
              "-> %.4f; ms a step %.3f (median after the first; pull %.3f, "
              "forward and transposed dot %.3f, retain and push %.3f); the "
              "pull, retain and push under set_sync_debug_mode('error'): no "
              "host sync; untouched rows bit for bit: %s; first %d steps "
              "card vs host within %.3g of scale (limit %g): %s; card %s"
              % (name, AVAZU_FEATURES, AVAZU_BATCHES, AVAZU_BATCH,
                 int(touched.sum()), losses[0], losses[-1], med["step"],
                 med["pull"], med["dot"], med["push"], kept, k, gap,
                 SPARSE_REL, "ok" if part_ok else "FAIL", card_line()))
    print("sparse-linear avazu: file and batches set up in %.1f s"
          % setup_s)
    if not ok:
        raise AssertionError("sparse-linear: a check failed")
    return {}


def train_detection_sparse(mx, seed, root):
    """Phase 20.  Returns ({path: launches}, the box_nms Proposal
    instance's record, the im2col kernel's record)."""
    import torch
    clock = time.perf_counter()
    paths = {}
    paths["faster_rcnn_vgg16"], prop_rec, rois = faster_rcnn_serve(mx, seed)
    lap = time.perf_counter()
    print("phase 20a in %.1f s" % (lap - clock))
    paths["rfcn_dcn_ops"], im2col_rec = rfcn_ops_at_size(mx, seed, rois)
    print("phase 20b in %.1f s" % (time.perf_counter() - lap))
    lap = time.perf_counter()
    from mxnet_tpu_torch.ops import kernels as K
    K.reset_launch_counts()
    sparse_linear_avazu(mx, seed, root)
    paths["sparse_linear_avazu"] = K.launch_counts()
    print("phase 20c in %.1f s" % (time.perf_counter() - lap))
    torch.cuda.synchronize()
    print("phase 20 parts done in %.1f s" % (time.perf_counter() - clock))
    return paths, prop_rec, im2col_rec


# -- phase 21: Custom, rtc, the profiler and telemetry -----------------------

# MXNet 1.0's example/numpy-ops/custom_softmax.py: the MLP 784-128-64-10,
# batch 100, SGD at lr 0.1, momentum 0.9, wd 1e-5; one epoch here
CUSTOM_MLP = (128, 64, 10)
CUSTOM_BATCH = 100
CUSTOM_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.00001}
CUSTOM_CHECKED = 3     # steps held to the built-in SoftmaxOutput's
CUSTOM_REL = 1e-5
RTC_N = 1 << 26        # f32 elements of MXNet 1.0's test_cuda_rtc axpy
RTC_ROWS = (4096, 4096)
RTC_THREADS = 256
RTC_SUM_REL = 1e-5
PROFILE_GENERAL_STEPS = 5
PROFILE_FUSED_STEPS = 5
PROFILE_FIT_STEPS = 10
LENET_REQUESTS = 8
# the metric names GET /metrics must carry after served requests (the
# JAX package's, serving/metrics.py)
SERVING_METRICS = ("serving.requests_total", "serving.request_latency_ms",
                   "serving.queue_ms", "serving.dispatch_ms",
                   "serving.batch_size", "serving.batches",
                   "serving.padded_rows_total", "serving.request_rows",
                   "serving.queue_depth")

RTC_CUDA = r'''
extern "C" __global__ void axpy(const float *x, float *y, float alpha,
                                long long n) {
    long long i = threadIdx.x + (long long)blockIdx.x * blockDim.x;
    if (i < n) y[i] += alpha * x[i];
}

extern "C" __global__ void row_sum(const float *x, float *out, int cols) {
    extern __shared__ float part[];
    const float *row = x + (long long)blockIdx.x * cols;
    float acc = 0.f;
    for (int j = threadIdx.x; j < cols; j += blockDim.x) acc += row[j];
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

template <typename T>
__global__ void scale(const T *x, T *y, T a, long long n) {
    long long i = threadIdx.x + (long long)blockIdx.x * blockDim.x;
    if (i < n) y[i] = a * x[i];
}
'''


def register_custom_softmax(mx):
    """The example's ``Softmax`` op and ``SoftmaxProp`` under op_type
    'softmax', with the two changes the JAX package's contract forces
    (ROADMAP R17): ``np.asarray(in_data[i])`` for ``in_data[i].asnumpy()``
    (the user's code gets numpy arrays), and ``astype(int)`` for numpy's
    removed ``np.int``.  The third, an explicit ``softmax_label`` input,
    is in ``custom_mlp``."""

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = np.asarray(in_data[0])
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = np.asarray(in_data[1]).ravel().astype(int)
            y = np.array(out_data[0])
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @mx.operator.register("softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super(SoftmaxProp, self).__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            data_shape = in_shape[0]
            label_shape = (in_shape[0][0],)
            output_shape = in_shape[0]
            return [data_shape, label_shape], [output_shape], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def custom_mlp(mx, head):
    """The example's net; ``head`` 'custom' (``Custom(op_type='softmax')``
    with the label passed explicitly: the JAX package creates no input
    the prop's ``list_arguments`` names beyond those given) or
    'builtin' (``SoftmaxOutput``)."""
    h = mx.sym.Variable("data")
    for i, n in enumerate(CUSTOM_MLP):
        h = mx.sym.FullyConnected(data=h, name="fc%d" % (i + 1),
                                  num_hidden=n)
        if i < len(CUSTOM_MLP) - 1:
            h = mx.sym.Activation(data=h, name="relu%d" % (i + 1),
                                  act_type="relu")
    label = mx.sym.Variable("softmax_label")
    if head == "custom":
        return mx.sym.Custom(data=h, label=label, name="softmax",
                             op_type="softmax")
    return mx.sym.SoftmaxOutput(data=h, label=label, name="softmax")


def custom_softmax_mlp(mx, seed, root):
    """21a.  The example's MLP with its Custom softmax through
    ``Module.fit`` over phase 19's MNIST files (``MNISTIter(flat=True)``),
    beside the same MLP with ``SoftmaxOutput`` from the same initial
    parameters; the first steps of both held together."""
    import torch
    from mxnet_tpu_torch.module.fused_step import FusedTrainStep
    register_custom_softmax(mx)
    files = {split: (os.path.join(root, "%s-images-idx3-ubyte" % split),
                     os.path.join(root, "%s-labels-idx1-ubyte" % split))
             for split in MNIST_SIZES}
    if not all(os.path.exists(p) for pair in files.values() for p in pair):
        files = write_mnist(root, seed, MNIST_SIZES)

    def it(shuffle=False):
        image, label = files["train"]
        return mx.io.MNISTIter(image=image, label=label,
                               batch_size=CUSTOM_BATCH, shuffle=shuffle,
                               flat=True, seed=seed)

    first = it()
    init = mx.mod.Module(custom_mlp(mx, "builtin"), context=mx.gpu(0))
    init.bind(first.provide_data, first.provide_label)
    mx.random.seed(seed)
    init.init_params(mx.initializer.Xavier(magnitude=2))
    arg0 = {k: v.asnumpy().copy() for k, v in init.get_params()[0].items()}

    def module(head):
        mod = mx.mod.Module(custom_mlp(mx, head), context=mx.gpu(0))
        mod.bind(first.provide_data, first.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v) for k, v in
                                    arg0.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=CUSTOM_SGD)
        return mod

    # the first steps of both heads from one state on the same batches
    batches = []
    first.reset()
    for b in first:
        batches.append(b)
        if len(batches) == CUSTOM_CHECKED:
            break
    runs = {}
    for head in ("custom", "builtin"):
        mod = module(head)
        for b in batches:
            mod.forward_backward(b)
            mod.update()
        torch.cuda.synchronize()
        runs[head] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        if head == "custom":
            why = FusedTrainStep.refusal(mod)
            if mod._fused_step is not None or why is None \
                    or "Custom" not in why:
                raise AssertionError("the fused step took a Custom graph "
                                     "on the card (%s)" % why)
            print("custom-softmax: fused step refused: %s; Module trains "
                  "through the general path" % why)
    gap = max(float(np.abs(runs["custom"][k] - runs["builtin"][k]).max()
                    / max(np.abs(runs["builtin"][k]).max(), 1e-30))
              for k in arg0)
    moved = max(float(np.abs(runs["custom"][k] - arg0[k]).max())
                for k in arg0)
    print("custom-softmax: after %d SGD steps the parameters are within "
          "%.3e of the SoftmaxOutput run's (limit %.0e, relative to each "
          "parameter's largest magnitude); largest move %.3e"
          % (CUSTOM_CHECKED, gap, CUSTOM_REL, moved))
    if not gap <= CUSTOM_REL or moved == 0.0:
        raise AssertionError("Custom softmax: %.3e from SoftmaxOutput "
                             "after %d steps" % (gap, CUSTOM_CHECKED))

    def ce(mod, batch):
        mod.forward(batch, is_train=False)
        p = mod.get_outputs()[0].asnumpy()
        lab = batch.label[0].asnumpy().astype(np.int64)
        return float(-np.log(p[np.arange(len(lab)), lab] + 1e-12).mean())

    results = {}
    for head in ("custom", "builtin"):
        probe = batches[0]
        loss0 = ce(module(head), probe)
        mod = mx.mod.Module(custom_mlp(mx, head), context=mx.gpu(0))
        times = []
        marks = {"t": None}

        def on_batch(param):
            torch.cuda.synchronize()
            now = time.perf_counter()
            if marks["t"] is not None:
                times.append((now - marks["t"]) * 1e3)
            marks["t"] = now

        train = it(shuffle=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(train, num_epoch=1, optimizer="sgd",
                optimizer_params=CUSTOM_SGD, eval_metric="ce",
                arg_params={k: mx.nd.array(v) for k, v in arg0.items()},
                batch_end_callback=on_batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loss1 = ce(mod, probe)
        steps = len(times) + 1
        results[head] = (loss0, loss1, float(np.median(times)), wall, steps,
                         mod._fused_step is not None)
        if not (np.isfinite(loss1) and loss1 < loss0):
            raise AssertionError("%s head: the loss did not fall (%.4f -> "
                                 "%.4f)" % (head, loss0, loss1))
    for head, (l0, l1, ms, wall, steps, fused) in results.items():
        print("custom-softmax: %s head (%s): one epoch of %d steps in %.2f "
              "s, %.3f ms a step (median, synchronized); cross-entropy on "
              "the first batch %.4f -> %.4f; card %s"
              % (head, "fused step, one CUDA graph a step" if fused
                 else "general path", steps, wall, ms, l0, l1, card_line()))
    print("custom-softmax: the host round trip costs %.3f ms a step "
          "(Custom %.3f against SoftmaxOutput %.3f)"
          % (results["custom"][2] - results["builtin"][2],
             results["custom"][2], results["builtin"][2]))


def rtc_cuda(mx, seed):
    """21b.  ``mx.rtc`` with CUDA C: axpy at 2^26 f32 elements, a
    templated kernel through ``exports``, a shared-memory row sum."""
    import torch
    from mxnet_tpu_torch import rtc
    card = torch.device("cuda", 0)
    g = torch.Generator(device=card).manual_seed(seed + 70)
    t0 = time.perf_counter()
    mod = mx.rtc.CudaModule(RTC_CUDA, options=("--fmad=false",),
                            exports=("scale<float>", "scale<double>"))
    cold = mod.compile()
    again = mx.rtc.CudaModule(RTC_CUDA, options=("--fmad=false",),
                              exports=("scale<float>", "scale<double>"))
    cached = again.compile()
    if mod.compile_cached or not again.compile_cached:
        raise AssertionError("rtc: the cubin cache did not act")
    print("rtc: NVRTC compile for %s cold %.3f s, cached %.4f s (the cubin "
          "under _build/, keyed by source, options and exports); lowered "
          "%s" % (rtc.ARCH, cold, cached, mod.lowered_names))

    # MXNet 1.0's test_cuda_rtc axpy at 2^26 elements; --fmad=false keeps
    # alpha * x and the sum rounded apart, as torch's mul then add do
    n = RTC_N
    axpy = mod.get_kernel("axpy", "const float *x, float *y, float alpha, "
                                  "int64_t n")
    x = torch.randn(n, generator=g, device=card)
    y0 = torch.randn(n, generator=g, device=card)
    alpha = 1.7
    y = y0.clone()
    grid = ((n + RTC_THREADS - 1) // RTC_THREADS, 1, 1)
    axpy.launch([mx.nd.NDArray(x), mx.nd.NDArray(y), alpha, n], mx.gpu(0),
                grid, (RTC_THREADS, 1, 1))
    plain = y0 + torch.tensor(alpha, device=card) * x
    torch.cuda.synchronize()
    exact = torch.equal(y, plain)
    # timed on one buffer: each launch adds into y
    xs, ys = mx.nd.NDArray(x), mx.nd.NDArray(y)

    def kernel():
        axpy.launch([xs, ys, alpha, n], mx.gpu(0), grid, (RTC_THREADS, 1, 1))

    def library():
        torch.add(y0, x, alpha=alpha)

    def b2b(fn, reps=20):
        fn()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    bound = 3 * 4 * n / 3.35e12 * 1e3
    print("rtc: axpy (MXNet 1.0's test_cuda_rtc kernel) at %d f32 elements, "
          "grid %s block (%d, 1, 1): bit for bit y0 + alpha * x "
          "(--fmad=false: no contraction into an FMA): %s; one call %.4f "
          "ms, back to back %.4f ms; torch.add(alpha=) one call %.4f ms, "
          "back to back %.4f ms; bound %.4f ms (bytes: x, y read, y "
          "written at 3.35 TB/s); launches %d; card %s"
          % (n, grid, RTC_THREADS, exact, time_ms(kernel), b2b(kernel),
             time_ms(library), b2b(library), bound, axpy.launches,
             card_line()))
    if not exact:
        raise AssertionError("rtc axpy differs from its plain version")

    for dt, tdt in (("float", torch.float32), ("double", torch.float64)):
        k = mod.get_kernel("scale<%s>" % dt, "const %s *x, %s *y, %s a, "
                           "int64_t n" % (dt, dt, dt))
        xs_ = torch.randn(1 << 20, generator=g, device=card).to(tdt)
        out = torch.empty_like(xs_)
        k.launch([mx.nd.NDArray(xs_), mx.nd.NDArray(out), 0.5, xs_.numel()],
                 mx.gpu(0), ((xs_.numel() + 255) // 256, 1, 1), (256, 1, 1))
        if not torch.equal(out, xs_ * 0.5):
            raise AssertionError("rtc scale<%s> differs" % dt)
    print("rtc: scale<float> and scale<double> through exports (%s) bit "
          "for bit x * 0.5 at 2^20 elements"
          % ", ".join(mod.lowered_names.values()))

    rows, cols = RTC_ROWS
    xm = torch.rand(rows, cols, generator=g, device=card)
    out = torch.empty(rows, device=card)
    k = mod.get_kernel("row_sum", "const float *x, float *out, int cols")

    def row_sum():
        k.launch([mx.nd.NDArray(xm), mx.nd.NDArray(out), cols], mx.gpu(0),
                 (rows, 1, 1), (RTC_THREADS, 1, 1),
                 shared_mem=RTC_THREADS * 4)

    row_sum()
    want = torch.sum(xm, 1)
    rel = float(((out - want).abs() / want.abs()).max())
    print("rtc: row_sum over (%d, %d) f32 with %d bytes of extern "
          "__shared__ memory a block: within %.2e of torch.sum (limit "
          "%.0e); one call %.4f ms, torch.sum %.4f ms, bound %.4f ms "
          "(bytes)" % (rows, cols, RTC_THREADS * 4, rel, RTC_SUM_REL,
                       time_ms(row_sum), time_ms(lambda: torch.sum(xm, 1)),
                       rows * cols * 4 / 3.35e12 * 1e3))
    if not rel <= RTC_SUM_REL:
        raise AssertionError("rtc row_sum off by %.2e" % rel)
    try:
        mx.rtc.CudaModule('extern "C" __global__ void bad(float *x) '
                          '{ x[0] = undeclared; }').compile()
    except mx.MXNetError as e:
        if "undeclared" not in str(e):
            raise AssertionError("the compile error lost the log: %s" % e)
        print("rtc: a compile error raises MXNetError with NVRTC's log (%d "
              "characters)" % len(str(e)))
    else:
        raise AssertionError("a bad source compiled")
    try:
        mod.get_kernel("axpy", "const float *x, float *y, float alpha, "
                               "int64_t n").launch(
            [mx.nd.zeros((4,), ctx=mx.cpu()), mx.nd.zeros((4,),
                                                          ctx=mx.cpu()),
             1.0, 4], mx.cpu(), (1, 1, 1), (4, 1, 1))
    except mx.MXNetError:
        pass
    else:
        raise AssertionError("CUDA C launched on a host context")
    print("rtc: CUDA C on a host context raises MXNetError; 21b in %.1f s"
          % (time.perf_counter() - t0))


def _events_of(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _step_coverage(events):
    """[(step span, covered share)] of StepTracker's step spans."""
    kids = {}
    for e in events:
        if e["name"].startswith("step:"):
            kids.setdefault(e["args"]["parent_id"], []).append(e)
    out = []
    for s in (e for e in events if e["name"] == "step"):
        parts = kids.get(s["args"]["span_id"], [])
        out.append((s, {p["name"] for p in parts},
                    sum(p["dur"] for p in parts) / max(s["dur"], 1e-9)))
    return out


def profile_resnet50(mx, seed, root):
    """21c.  Phase 4's ResNet-50 v2 Module at batch 32 under the profiler
    and the registry: general-path steps in 'all' mode, fused steps in
    'symbolic' mode, a fit with the step tracker and the Speedometer; a
    served LeNet's /metrics; a torch.profiler device trace."""
    import torch
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.ops import kernels as K
    prof, tel = mx.profiler, mx.observability.telemetry
    symbol = resnet.get_symbol(**RESNET)
    per_step = expected_train_launches(symbol)
    rng = np.random.default_rng(seed + 71)
    steps = max(PROFILE_FIT_STEPS, PROFILE_FUSED_STEPS,
                PROFILE_GENERAL_STEPS)
    shape = tuple(int(d) for d in RESNET["image_shape"].split(","))
    images = rng.random((TRAIN_BATCH * steps,) + shape, dtype=np.float32)
    labels = rng.integers(0, RESNET["num_classes"],
                          TRAIN_BATCH * steps).astype(np.float32)

    xavier = mx.initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2)

    def module(bound=True):
        it = mx.io.NDArrayIter(images, labels, batch_size=TRAIN_BATCH)
        mod = mx.mod.Module(symbol, context=mx.gpu(0))
        mx.random.seed(seed)
        if bound:
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(xavier)
            mod.init_optimizer(optimizer_params=SGD)
        return mod, it

    # general path, 'all' mode: an operator span for each op, waited for
    mod, it = module()
    mod._fused_step = None
    batches = list(it)
    path = os.path.join(root, "profile_all.json")
    prof.profiler_set_config("all", path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.profiler_set_state("run")
    try:
        for b in batches[:PROFILE_GENERAL_STEPS]:
            mod.forward_backward(b)
            mod.update()
        torch.cuda.synchronize()
    finally:
        prof.profiler_set_state("stop")
    wall = (time.perf_counter() - t0) * 1e3 / PROFILE_GENERAL_STEPS
    events = _events_of(path)
    spans = {e["args"]["span_id"]: e for e in events
             if e.get("args", {}).get("span_id")}
    ops = [e for e in events if e["cat"] == "operator"]
    outside = 0
    for e in ops:
        parent = spans.get(e.get("args", {}).get("parent_id"))
        if parent is None or parent["name"] != "executor_forward" \
                or e["ts"] < parent["ts"] \
                or e["ts"] + e["dur"] > parent["ts"] + parent["dur"] + 1.0:
            outside += 1
    n_nodes = sum(1 for n in symbol._topo() if not n.is_var)
    agg = prof.aggregate_stats(events)
    top = sorted(agg.get("operator", {}).items(),
                 key=lambda kv: -kv[1]["total_ms"])[:4]
    print("profile: %d general-path steps in 'all' mode, %.1f ms a step "
          "(each op waited for); %d operator spans (%d a step, the graph "
          "has %d op nodes), %d outside an executor_forward span; the "
          "dump (%d events, %.1f MB) loads; by total ms %s; card %s"
          % (PROFILE_GENERAL_STEPS, wall, len(ops),
             len(ops) // PROFILE_GENERAL_STEPS, n_nodes, outside,
             len(events), os.path.getsize(path) / 1e6,
             ", ".join("%s %.2f" % (k, v["total_ms"]) for k, v in top),
             card_line()))
    if outside or len(ops) != PROFILE_GENERAL_STEPS * n_nodes:
        raise AssertionError("operator spans: %d outside, %d recorded"
                             % (outside, len(ops)))

    # fused steps, 'symbolic' mode: the capture stays whole
    mod, it = module()
    batches = list(it)
    path = os.path.join(root, "profile_symbolic.json")
    prof.profiler_set_config("symbolic", path)
    step_launches = []
    prof.profiler_set_state("run")
    try:
        for b in batches[:PROFILE_FUSED_STEPS]:
            before = K.launch_counts()
            mod.forward_backward(b)
            mod.update()
            torch.cuda.synchronize()
            after = K.launch_counts()
            step_launches.append({k: after[k] - before[k] for k in per_step})
        on_ms = time_steps(mod, batches[0])
    finally:
        prof.profiler_set_state("stop")
    off_ms = time_steps(mod, batches[0])
    fs = mod._fused_step
    spans = [e for e in _events_of(path) if e["name"] == "fused_train_step"]
    print("profile: %d fused steps in 'symbolic' mode: captures %d, replays "
          "%d, launches a step %s; %d fused_train_step spans; the replay "
          "%.2f ms a step with the profiler on, %.2f off (medians of %d, "
          "synchronized); card %s"
          % (PROFILE_FUSED_STEPS, fs.captures, fs.replays, step_launches,
             len(spans), on_ms, off_ms, TIMED_STEPS, card_line()))
    if fs is None or fs.captures != 1 or fs.graph_launches != per_step \
            or any(d != per_step for d in step_launches):
        raise AssertionError("the profiled fused step lost its capture")

    # fit with the step tracker and the Speedometer mirrored
    tel.reset()
    mod, it = module(bound=False)
    path = os.path.join(root, "profile_fit.json")
    prof.profiler_set_config("symbolic", path)
    speed = mx.callback.Speedometer(TRAIN_BATCH, frequent=5, telemetry=True)
    prof.profiler_set_state("run")
    try:
        mod.fit(it, num_epoch=1, optimizer_params=SGD, eval_metric="ce",
                initializer=xavier, batch_end_callback=speed)
        torch.cuda.synchronize()
    finally:
        prof.profiler_set_state("stop")
    cover = _step_coverage(_events_of(path))
    snap = tel.snapshot()
    worst = min(c for _, _, c in cover) if cover else 0.0
    best = max(c for _, _, c in cover) if cover else 0.0
    names_ok = all(n >= {"step:data_wait", "step:fwd_bwd_dispatch",
                         "step:update", "step:metric", "step:sync"}
                   for _, n, _ in cover)
    live = registry_value(snap, "device.live_bytes")
    peak = registry_value(snap, "device.peak_bytes")
    rate = registry_value(snap, "speedometer.samples_per_sec")
    print("profile: fit of %d steps: %d step spans, the five components "
          "cover %.1f-%.1f%% of each; module.step.total_ms mean %.2f ms; "
          "device.live_bytes %d, device.peak_bytes %d (torch.cuda); "
          "speedometer.samples_per_sec %.1f; card %s"
          % (PROFILE_FIT_STEPS, len(cover), 100 * worst, 100 * best,
             snap["module.step.total_ms"]["sum"]
             / max(snap["module.step.total_ms"]["count"], 1),
             live, peak, rate, card_line()))
    if len(cover) != PROFILE_FIT_STEPS or not names_ok \
            or not 0.8 <= worst <= best <= 1.001 or live <= 0 \
            or peak < live or rate <= 0:
        raise AssertionError("the step tracker or the gauges failed")
    del mod
    torch.cuda.empty_cache()

    lenet_metrics(mx, seed, root)
    device_trace_apart(seed, root)


def lenet_metrics(mx, seed, root):
    """21c.  The symbol zoo's LeNet behind ``Server(serve_http=True)``:
    ``LENET_REQUESTS`` POSTs, then ``GET /metrics``."""
    import urllib.request as urlreq
    from mxnet_tpu_torch.models import lenet
    tel = mx.observability.telemetry
    symbol = lenet.get_symbol(10)
    init = mx.mod.Module(symbol, context=mx.gpu(0))
    init.bind([("data", (1, 1, 28, 28))], [("softmax_label", (1,))],
              for_training=False)
    mx.random.seed(seed)
    init.init_params(mx.initializer.Xavier())
    args, _ = init.get_params()
    rng = np.random.default_rng(seed + 72)
    tel.reset()
    server = mx.serving.Server(max_batch_size=4, serve_http=True)
    try:
        server.add_model("lenet", symbol, args,
                         input_shapes={"data": (1, 28, 28)})
        server.warmup()
        base = "http://%s:%d" % server.http_address
        t0 = time.perf_counter()
        for _ in range(LENET_REQUESTS):
            x = rng.random((1, 1, 28, 28), dtype=np.float32)
            body = json.dumps({"inputs": {"data": x.tolist()}}).encode()
            req = urlreq.Request(base + "/predict/lenet", data=body, headers={
                "Content-Type": "application/json"})
            with urlreq.urlopen(req, timeout=120) as r:
                out = np.asarray(json.loads(r.read())["outputs"][0])
            if out.shape != (1, 10) or not np.isfinite(out).all():
                raise AssertionError("LeNet response %s" % (out.shape,))
        wall = time.perf_counter() - t0
        with urlreq.urlopen(base + "/metrics", timeout=30) as r:
            prom = r.read().decode()
    finally:
        server.close()
    missing = [n for n in SERVING_METRICS
               if "mxnet_tpu_" + n.replace(".", "_") not in prom]
    print("profile: LeNet served %d HTTP requests in %.3f s; GET /metrics: "
          "%d lines, the JAX package's serving names %s, "
          "mxnet_tpu_serving_requests_total %s"
          % (LENET_REQUESTS, wall, len(prom.splitlines()),
             "all present" if not missing else "missing %s" % missing,
             LENET_REQUESTS if "mxnet_tpu_serving_requests_total %d\n"
             % LENET_REQUESTS in prom else "wrong"))
    if missing or "mxnet_tpu_serving_requests_total %d\n" \
            % LENET_REQUESTS not in prom:
        raise AssertionError("/metrics lacks the JAX package's names")


TRACE_STEPS = 2


def device_trace_apart(seed, root):
    """Runs ``device_trace_child`` in a process of its own (late in this
    process torch.profiler loses kernel records) and passes its lines
    on; raises when it fails."""
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--device-trace", root], capture_output=True, text=True,
        timeout=600)
    sys.stdout.write(child.stdout)
    if child.returncode != 0:
        sys.stdout.write(child.stderr[-4000:])
        raise AssertionError("the device trace failed (exit %d)"
                             % child.returncode)


def device_trace_child(mx, seed, root):
    """``--device-trace ROOT``: ``profiler.start_jax_trace`` /
    ``stop_jax_trace`` around general-path steps of a BatchNorm and
    pooling net on the card; the torch.profiler trace written under
    ``ROOT`` must hold the device events of the hand kernels behind the
    ``mxtt_*`` entry points (``channel_sums_kernel``, the pooling
    backwards: ``HAND_KERNELS``)."""
    import torch
    s = mx.sym
    net = s.Variable("data")
    net = s.Convolution(net, num_filter=64, kernel=(3, 3), pad=(1, 1),
                        name="conv")
    net = s.BatchNorm(net, fix_gamma=False, name="bn")
    net = s.Activation(net, act_type="relu")
    net = s.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    net = s.Pooling(net, global_pool=True, kernel=(1, 1), pool_type="avg")
    net = s.SoftmaxOutput(s.FullyConnected(s.Flatten(net), num_hidden=10),
                          name="softmax")
    rng = np.random.default_rng(seed + 73)
    it = mx.io.NDArrayIter(rng.random((32, 3, 56, 56), dtype=np.float32),
                           rng.integers(0, 10, 32).astype(np.float32),
                           batch_size=16)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer_params=SGD)
    mod._fused_step = None
    batch = next(it)
    mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    from mxnet_tpu_torch.ops import kernels as K
    K.reset_launch_counts()
    logdir = mx.profiler.start_jax_trace(os.path.join(root, "device_trace"))
    for _ in range(TRACE_STEPS):
        mod.forward_backward(batch)
        mod.update()
    torch.cuda.synchronize()
    path = mx.profiler.stop_jax_trace()
    events = _events_of(path)
    names = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        hit = next((k for k in HAND_KERNELS if k in e["name"]), None)
        if hit is not None:
            names[hit] = names.get(hit, 0) + 1
    launched = {k: v for k, v in K.launch_counts().items() if v}
    print("device-trace: start_jax_trace/stop_jax_trace wrote %s (%d "
          "events, under %s); hand-kernel device events %s over %d steps, "
          "the wrappers' launches %s"
          % (os.path.basename(path), len(events), os.path.basename(logdir),
             names, TRACE_STEPS, launched))
    if not names:
        raise AssertionError("the device trace holds no hand kernel")
    return 0


def train_custom_rtc_profile(mx, seed, root):
    """Phase 21.  Returns nothing: its launches are not on the ``kernels``
    line (Custom's MLP runs none of the hand kernels; rtc kernels are the
    user's)."""
    import torch
    clock = time.perf_counter()
    custom_softmax_mlp(mx, seed, root)
    lap = time.perf_counter()
    print("phase 21a in %.1f s" % (lap - clock))
    rtc_cuda(mx, seed)
    print("phase 21b in %.1f s" % (time.perf_counter() - lap))
    lap = time.perf_counter()
    profile_resnet50(mx, seed, root)
    torch.cuda.synchronize()
    print("phase 21c in %.1f s" % (time.perf_counter() - lap))
    print("phase 21 parts done in %.1f s" % (time.perf_counter() - clock))


# -- phase 22: the health sentinel, the flight recorder and memprof -----------

HEALTH_NAN_BATCH = 3      # 22a: the batch whose first image is NaN
HEALTH_REL = 1e-5         # 22a: the in-graph vector against its recomputation
HEALTH_DP_BATCH = 2       # 22a: the general path over [gpu(0)] * 2
HEALTH_TIMED = 5          # steps timed with the sentinel on and off
TAPS_STEPS = 4            # 22b: GPT-2-small Module LM steps under the taps
TAPS_TIMED = 3
TAP_REL = 1e-5
OOM_MIN_BATCH = 1024      # 22c: at least this many images
POISONED_REQUESTS = 4     # 22d: requests to the model with an inf planted
HEALTH_DECODE_PROMPT = (17, 48)   # 22d: the 8 streams' prompt tokens
HEALTH_DECODE_NEW = 8
HEALTH_ENV = ("MXNET_TPU_HEALTH", "MXNET_TPU_MEMPROF",
              "MXNET_TPU_FLIGHT_PATH")


def health_env(health=None, memprof=None, flight_path=None):
    """The sentinel's environment for a block (``HEALTH_ENV``: each set
    from its argument, or unset when it is None)."""
    values = (health, memprof, flight_path)
    return _env({k: str(v) for k, v in zip(HEALTH_ENV, values)
                 if v is not None}, HEALTH_ENV)


def plain_health(layout, outs, params, grads, new=None):
    """The packed health vector recomputed eagerly on the card in float64,
    slot by slot as ``health.pack_summary`` defines it, from the step's
    outputs, parameters (before the update), gradients and, for the exact
    update ratio, the parameters after it (else the slot is -1)."""
    import torch

    def l2(ts):
        return float(torch.stack([t.double().square().sum()
                                  for t in ts]).sum().sqrt())
    mask = sum(float(1 << i) for i, o in enumerate(outs[:layout.n_outputs])
               if bool(torch.isfinite(o).all()))
    pn = l2(params)
    ratio = -1.0 if new is None else \
        l2([a.double() - b.double() for a, b in zip(new, params)]) \
        / max(pn, 1e-12)
    maxes = [float(torch.stack([g.double().abs().max()
                                for g in grads[a:b]]).max())
             for _, a, b in layout.groups]
    return np.array([mask, float(outs[0].double().mean()), l2(grads), pn,
                     ratio] + maxes)


def vector_gap(got, want):
    """Largest relative gap over the slots; NaN in both is agreement, NaN
    in one of them is an infinite gap."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    both = np.isnan(got) & np.isnan(want)
    gap = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    gap[both] = 0.0
    gap[np.isnan(gap)] = np.inf
    return float(gap.max())


def _count_dumps(recorder):
    """Wrap ``recorder.dump``: the returned list collects each dump's
    reason."""
    reasons, real = [], recorder.dump

    def dump(path=None, reason="on_demand", sections=None):
        reasons.append(reason)
        return real(path=path, reason=reason, sections=sections)
    recorder.dump = dump
    return reasons


def _pool_segments(pool):
    """Reserved bytes of the allocator's segments in a CUDA graph's pool
    (``torch.cuda.memory_snapshot``)."""
    import torch
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def health_resnet50(mx, seed, root):
    """22a.  Returns (the sentinel's fit's launches, ResNet-50's peak bytes
    at batch 32)."""
    import torch
    from mxnet_tpu_torch import executor_cache
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.observability import (flight_recorder, health,
                                               memprof, telemetry)
    from mxnet_tpu_torch.ops import kernels as K

    symbol = resnet.get_symbol(**RESNET)
    per_step = expected_train_launches(symbol)
    rng = np.random.default_rng(seed + 220)
    n = TRAIN_BATCH * TRAIN_BATCHES
    shape = tuple(int(d) for d in RESNET["image_shape"].split(","))
    images = rng.random((n,) + shape, dtype=np.float32)
    labels = rng.integers(0, RESNET["num_classes"], n).astype(np.float32)
    poisoned = images.copy()
    poisoned[HEALTH_NAN_BATCH * TRAIN_BATCH] = np.nan

    # the flag off: the parent's graph, nothing of the sentinel
    clock = time.perf_counter()
    with health_env():
        telemetry.reset()
        torch.cuda.reset_peak_memory_stats()
        mod_off = mx.mod.Module(symbol, context=mx.gpu(0))
        it = mx.io.NDArrayIter(images[:2 * TRAIN_BATCH],
                               labels[:2 * TRAIN_BATCH],
                               batch_size=TRAIN_BATCH)
        mod_off.bind(it.provide_data, it.provide_label)
        mx.random.seed(seed)
        mod_off.init_params(mx.initializer.Xavier(
            rnd_type="gaussian", factor_type="in", magnitude=2))
        arg0, aux0 = ({k: v.asnumpy().copy() for k, v in t.items()}
                      for t in mod_off.get_params())
        mod_off.fit(it, num_epoch=1, optimizer_params=SGD, eval_metric="ce")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        fs_off = mod_off._fused_step
        series = [k for k in telemetry.snapshot() if k.startswith("health.")]
        if fs_off is None or fs_off.captures != 1 \
                or fs_off.graph_launches != per_step or series \
                or fs_off.last_health is not None:
            raise AssertionError(
                "health off: the graph's launches %s (the parent's %s), "
                "health series %s" % (fs_off and fs_off.graph_launches,
                                      per_step, series))
        it.reset()
        batch = next(it)
        step_off = time_steps(mod_off, batch, steps=HEALTH_TIMED)
        replay_off = time_ms(fs_off.graph.replay, reps=HEALTH_TIMED)
        dev_off = device_ms_per_call(fs_off.graph.replay, calls=2)
    del mod_off, fs_off
    _release()
    parts = {"off": time.perf_counter() - clock}

    # the flag on, memprof on: batch HEALTH_NAN_BATCH holds a NaN image
    dump_path = os.path.join(root, "health_flight.json")
    arg_nd, _ = mx.convert.params_from_numpy(arg0, mx.cpu())
    aux_nd, _ = mx.convert.params_from_numpy(aux0, mx.cpu())
    gaps, raised = [], None
    with health_env(health=1, memprof=1, flight_path=dump_path):
        flight_recorder.reset()
        memprof.reset()
        dumps = _count_dumps(flight_recorder.get_recorder())
        misses0 = executor_cache.stats()["misses"]
        mod_on = mx.mod.Module(symbol, context=mx.gpu(0))
        it = mx.io.NDArrayIter(poisoned, labels, batch_size=TRAIN_BATCH)

        def check(param):
            step, summary = mod_on._last_health_summary
            fs = mod_on._fused_step
            grads, old = fs.health_inputs
            want = plain_health(fs.health_layout,
                                [o.tensor for o in mod_on.get_outputs()],
                                old, grads, new=fs._masters)
            got = [summary[s] for s in fs.health_layout.slots]
            gaps.append((step, vector_gap(got, want), got[0], got[2]))

        K.reset_launch_counts()
        try:
            mod_on.fit(it, num_epoch=1, arg_params=arg_nd,
                       aux_params=aux_nd, optimizer_params=SGD,
                       eval_metric="ce", batch_end_callback=check)
        except health.TrainingDivergedError as exc:
            raised = exc
        torch.cuda.synchronize()
        launches = K.launch_counts()
        fs_on = mod_on._fused_step
        records = memprof.program_records()
        misses = executor_cache.stats()["misses"] - misses0
        pool_bytes = _pool_segments(fs_on.graph.pool())
        mod_on.set_params(arg_nd, aux_nd)
        step_on = time_steps(mod_on, batch, steps=HEALTH_TIMED)
        replay_on = time_ms(fs_on.graph.replay, reps=HEALTH_TIMED)
        dev_on = device_ms_per_call(fs_on.graph.replay, calls=2)
    print("health resnet50: the in-graph vector of each step against its "
          "plain recomputation on the card: %s (largest relative gap; "
          "finite_mask, grad_norm); card %s"
          % ("; ".join("step %d %.3g (%g, %.6g)" % g for g in gaps),
             card_line()))
    if raised is None or raised.step != HEALTH_NAN_BATCH \
            or raised.dump_path != dump_path:
        raise AssertionError("health resnet50: the NaN batch %d raised %r"
                             % (HEALTH_NAN_BATCH, raised))
    if [g[0] for g in gaps] != list(range(HEALTH_NAN_BATCH + 1)) \
            or max(g[1] for g in gaps) > HEALTH_REL:
        raise AssertionError("health resnet50: steps %s, gaps over %g"
                             % (gaps, HEALTH_REL))
    doc = json.load(open(dump_path))
    if dumps != ["anomaly_nonfinite"] \
            or doc["first_anomaly_step"] != HEALTH_NAN_BATCH \
            or [s["step"] for s in doc["steps"]] \
            != list(range(HEALTH_NAN_BATCH + 1)):
        raise AssertionError(
            "health resnet50: dumps %s, first anomaly %s, steps %s"
            % (dumps, doc["first_anomaly_step"],
               [s["step"] for s in doc["steps"]]))
    want_launches = {k: v * (HEALTH_NAN_BATCH + 1) for k, v in per_step.items()}
    if {k: launches[k] for k in per_step} != want_launches \
            or fs_on.graph_launches != per_step or fs_on.captures != 1:
        raise AssertionError("health resnet50: launches %s, graph %s"
                             % (launches, fs_on.graph_launches))
    kinds = [r["kind"] for r in records]
    cap = [r for r in records if r["kind"] == "fused_step"]
    if misses != 1 or kinds != ["fwd_bwd", "fused_step"] \
            or cap[0]["memory"]["graph_pool_bytes"] != pool_bytes \
            or not cap[0]["memory"]["warmup_peak_bytes"]:
        raise AssertionError(
            "health resnet50: %d plan builds, records %s, graph pool %s "
            "against the allocator's %d"
            % (misses, kinds, cap and cap[0]["memory"], pool_bytes))
    mem = cap[0]["memory"]
    print("health resnet50: NaN in batch %d raised TrainingDivergedError at "
          "step %d after %s; the dump's steps %s, first anomaly %d; %d plan "
          "build and %d capture with the flag on (records %s); capture "
          "%.1f ms, graph pool %.1f MB (the allocator's segments of the "
          "pool %.1f MB), warm-up step's peak %.1f MB, arguments %.1f MB"
          % (HEALTH_NAN_BATCH, raised.step, dumps,
             [s["step"] for s in doc["steps"]], doc["first_anomaly_step"],
             misses, fs_on.captures, kinds, cap[0]["compile_ms"],
             mem["graph_pool_bytes"] / 1e6, pool_bytes / 1e6,
             mem["warmup_peak_bytes"] / 1e6, mem["argument_bytes"] / 1e6))
    print("health resnet50: replay ms (CUDA events, one replay) off %.3f, on "
          "%.3f (+%.3f); step ms (synchronized, median of %d) off %.2f, on "
          "%.2f; device kernels a replay off %s, on %s; device ms a replay "
          "off %s, on %s; hand-kernel launches a step %s either way; peak "
          "memory at batch %d %.2f GB; card %s"
          % (replay_off, replay_on, replay_on - replay_off, HEALTH_TIMED,
             step_off, step_on,
             "not measured" if dev_off is None else "%.0f" % dev_off[1],
             "not measured" if dev_on is None else "%.0f" % dev_on[1],
             "not measured" if dev_off is None else "%.3f" % dev_off[0],
             "not measured" if dev_on is None else "%.3f" % dev_on[0],
             per_step, TRAIN_BATCH, peak / 1e9, card_line()))
    del mod_on, fs_on
    _release()
    parts["on"] = time.perf_counter() - clock - parts["off"]

    # the general path over [gpu(0)] * 2: each executor's vector against
    # its recomputation, the module's against combine over the two
    with health_env(health=1):
        mod = mx.mod.Module(symbol, context=[mx.gpu(0), mx.gpu(0)])
        mod.bind([("data", (HEALTH_DP_BATCH,) + shape)],
                 [("softmax_label", (HEALTH_DP_BATCH,))])
        mod.init_params(arg_params=arg_nd, aux_params=aux_nd)
        mod.init_optimizer(kvstore="local", optimizer="sgd",
                           optimizer_params=SGD)
        if mod._fused_step is not None:
            raise AssertionError("health resnet50: [gpu(0)] * 2 under "
                                 "'local' took the fused step")
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(images[:HEALTH_DP_BATCH], ctx=mx.cpu())],
            [mx.nd.array(labels[:HEALTH_DP_BATCH], ctx=mx.cpu())]))
        vecs, gaps = [], []
        for exe in mod._exec_group.execs:
            vec = exe._last_health.cpu().numpy()
            names = exe._grad_names
            want = plain_health(
                exe.health_layout, [o.tensor for o in exe.outputs],
                [exe.arg_dict[k].tensor for k in names],
                [exe.grad_dict[k].tensor for k in names])
            gaps.append(vector_gap(vec, want))
            vecs.append(vec)
        combined, layout = mod._take_health_vector()
        mod.update()
    want = health.combine(vecs, layout)
    print("health resnet50: general path over [gpu(0)] * 2 at batch %d: "
          "each executor's vector against its recomputation %s; the "
          "module's combined vector %s combine() of the two"
          % (HEALTH_DP_BATCH, ", ".join("%.3g" % g for g in gaps),
             "equals" if np.array_equal(combined, want) else "DIFFERS from"))
    if max(gaps) > HEALTH_REL or not np.array_equal(combined, want):
        raise AssertionError("health resnet50: the general path's vectors")
    del mod
    _release()
    parts["general"] = time.perf_counter() - clock - sum(parts.values())
    print("health resnet50: s of the flag-off run %.1f, the flag-on run "
          "%.1f, the general path %.1f" % (parts["off"], parts["on"],
                                          parts["general"]))
    return launches, peak


def _logit_bounds(query, key, wq, bq, wk, bk, heads):
    """scale * max_row ||q|| * max_row ||k|| of one attention node, in
    float64 from its inputs."""
    b, s, e = query.shape
    d = e // heads
    q = (query.double() @ wq.double().t() + bq.double()).reshape(b, s,
                                                                 heads, d)
    k = (key.double() @ wk.double().t() + bk.double()).reshape(b, s,
                                                               heads, d)
    return float(q.norm(dim=-1).max() * k.norm(dim=-1).max()) / d ** 0.5


def health_lm_taps(mx, seed):
    """22b.  Returns the taps' fit's launches and the GPT-2-small weights
    (numpy, from ``seed``)."""
    import torch
    from mxnet_tpu_torch.observability import health
    from mxnet_tpu_torch.ops import kernels as K

    class Tokens(mx.metric.EvalMetric):
        """Counts the label tokens: a metric that copies no [8, 1024,
        50257] output to the host."""

        def __init__(self):
            super().__init__("tokens")

        def update(self, labels, preds):
            self.sum_metric += sum(int(l.size) for l in labels)
            self.num_inst += 1

    logits, symbol = overlap_lm(mx)
    arrays = gpt2s_params(logits, seed)
    rng = np.random.default_rng(seed + 221)
    seq, vocab = GPT2S["seq_len"], GPT2S["vocab_size"]
    n = OVERLAP_BATCH * TAPS_STEPS
    tokens = rng.integers(0, vocab, (n, seq)).astype(np.float32)
    targets = rng.integers(0, vocab, (n, seq)).astype(np.float32)
    arg_nd, _ = mx.convert.params_from_numpy(arrays, mx.cpu())

    def fitted(steps):
        it = mx.io.NDArrayIter(tokens[:OVERLAP_BATCH * steps],
                               targets[:OVERLAP_BATCH * steps],
                               batch_size=OVERLAP_BATCH)
        mod = mx.mod.Module(symbol, context=mx.gpu(0))
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params=arg_nd)
        return mod, it

    with health_env():
        mod, it = fitted(2)
        mod.fit(it, num_epoch=1, optimizer_params=OVERLAP_SGD,
                eval_metric=Tokens())
        it.reset()
        batch = next(it)
        ms_off = time_steps(mod, batch, steps=TAPS_TIMED, warmup=1)
    del mod
    _release()
    with health_env(health=1):
        mod, it = fitted(TAPS_STEPS)
        exe = mod._exec_group.execs[0]
        snaps = [{k: v.tensor.clone() for k, v in exe.arg_dict.items()
                  if k in arrays}]
        vectors = []
        take = mod._take_health_vector

        def take_raw():
            got = take()
            vectors.append(np.array(got[0]))
            return got
        mod._take_health_vector = take_raw

        def snapshot(param):
            snaps.append({k: v.tensor.clone()
                          for k, v in exe.arg_dict.items() if k in arrays})
        K.reset_launch_counts()
        mod.fit(it, num_epoch=1, optimizer_params=OVERLAP_SGD,
                eval_metric=Tokens(), batch_end_callback=snapshot)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        layout = mod._fused_step.health_layout
        it.reset()
        batch = next(it)
        ms_on = time_steps(mod, batch, steps=TAPS_TIMED, warmup=1)
    del mod, exe
    _release()
    taps = [s for s in layout.slots if s.startswith("max_abs_attn_logit/")]
    if len(taps) != health.MAX_TAPS or len(vectors) != TAPS_STEPS:
        raise AssertionError("lm taps: %d tap slots, %d vectors"
                             % (len(taps), len(vectors)))
    # each step's bounds, recomputed from the attention nodes' inputs
    check = logits.simple_bind(mx.gpu(0), grad_req="null",
                               data=(OVERLAP_BATCH, seq))
    seen = {}

    def grab(name, arr):
        if name.startswith("attn_"):
            seen.setdefault(name[len("attn_"):], []).append(arr.tensor)
    check.set_monitor_callback(grab, monitor_all=True)
    gaps = []
    for s in range(TAPS_STEPS):
        seen.clear()
        with torch.no_grad():
            for k, v in snaps[s].items():
                check.arg_dict[k].tensor.copy_(v)
        check.forward(is_train=False, data=mx.nd.array(
            tokens[s * OVERLAP_BATCH:(s + 1) * OVERLAP_BATCH], ctx=mx.cpu()))
        want = [_logit_bounds(*(seen[k][i] for k in (
            "query", "key", "query_weight", "query_bias", "key_weight",
            "key_bias")), GPT2S["num_heads"])
            for i in range(health.MAX_TAPS)]
        got = vectors[s][-health.MAX_TAPS:]
        gaps.append(vector_gap(got, want))
        if s == 0:
            first = (got, want)
    del check, snaps
    _release()
    lse = launches.get("flash_attn_fwd_lse", 0)
    print("lm taps: GPT-2-small Module LM, batch %d x %d, %d steps under the "
          "sentinel: the %d attention taps of each step against scale * "
          "max||q|| * max||k|| recomputed in float64 from the nodes' inputs: "
          "largest relative gap %s (step 0: %s against %s); flash LSE "
          "launches %d (%d a step); ms a step (median of %d) taps off %.2f, "
          "on %.2f; card %s"
          % (OVERLAP_BATCH, seq, TAPS_STEPS, len(taps),
             ", ".join("%.3g" % g for g in gaps),
             ", ".join("%.4f" % v for v in first[0][:3]),
             ", ".join("%.4f" % v for v in first[1][:3]), lse,
             lse // TAPS_STEPS, TAPS_TIMED, ms_off, ms_on, card_line()))
    if max(gaps) > TAP_REL or lse != GPT2S["num_layers"] * TAPS_STEPS:
        raise AssertionError("lm taps: gaps %s, LSE launches %d"
                             % (gaps, lse))
    return launches, arrays


def oom_child(mx, seed, batch):
    """22c's child: ResNet-50's general-path step at ``batch`` images must
    run out of the card's memory; checks the black box and prints its
    findings as one JSON line.  Exit code 0 only when all hold."""
    import torch
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.observability import flight_recorder

    symbol = resnet.get_symbol(**RESNET)
    shape = tuple(int(d) for d in RESNET["image_shape"].split(","))
    recorder = flight_recorder.get_recorder()
    dumps = _count_dumps(recorder)
    caught = []
    exe = symbol.simple_bind(mx.gpu(0), grad_req="write",
                             data=(batch,) + shape, softmax_label=(batch,))
    for _ in range(2):
        try:
            exe.forward_backward(is_train=True)
            torch.cuda.synchronize()
            caught.append(None)
        except Exception as exc:  # noqa: BLE001 -- its type is the check
            caught.append((type(exc).__name__, "CUDA out of memory"
                           in str(exc), getattr(exc, "_mxtpu_oom_recorded",
                                                False)))
    del exe
    torch.cuda.empty_cache()
    after_two = list(dumps)
    # the fit loop's hook under the sentinel: no second dump over the first
    rng = np.random.default_rng(seed + 222)
    it = mx.io.NDArrayIter(
        np.zeros((batch,) + shape, np.float32),
        rng.integers(0, 1000, batch).astype(np.float32), batch_size=batch)
    fit_exc = None
    try:
        mx.mod.Module(symbol, context=mx.gpu(0)).fit(
            it, num_epoch=1, optimizer_params=SGD)
    except Exception as exc:  # noqa: BLE001 -- its type is the check
        fit_exc = type(exc).__name__
    out = {"batch": batch, "caught": caught, "dumps_after_two": after_two,
           "dumps": dumps, "fit_exception": fit_exc,
           "oom_anomalies": recorder.anomaly_count("oom"),
           "card_total": torch.cuda.mem_get_info()[1]}
    print("oom child: %s" % json.dumps(out))
    ok = (all(c is not None and c[0] == "OutOfMemoryError" and c[1] and c[2]
              for c in caught) and after_two == ["oom"] and dumps == ["oom"]
          and fit_exc == "OutOfMemoryError" and out["oom_anomalies"] == 3)
    return 0 if ok else 1


def oom_blackbox_start(seed, root):
    """22c's child, started while 22a-b run: it imports torch and the
    package (the few seconds a process takes to start) and then waits for
    its batch on stdin before it touches the card, so that this process's
    allocator is untouched."""
    env = dict(os.environ, MXNET_TPU_FLIGHT_PATH=os.path.join(
        root, "oom_flight.json"), MXNET_TPU_MEMPROF="1", MXNET_TPU_HEALTH="1")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--oom-child",
         "--seed", str(seed)], env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def oom_blackbox_finish(child, root, peak):
    """22c: hand the started child its batch, twice what the card holds at
    ResNet-50's measured peak an image (at least OOM_MIN_BATCH), and check
    what it and its dump say."""
    import torch
    total = torch.cuda.mem_get_info()[1]
    batch = max(OOM_MIN_BATCH, TRAIN_BATCH * int(np.ceil(
        2.0 * total / peak)))
    dump_path = os.path.join(root, "oom_flight.json")
    t0 = time.perf_counter()
    try:
        out, err = child.communicate("%d\n" % batch, timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    wall = time.perf_counter() - t0
    lines = [l for l in out.splitlines() if l.startswith("oom child: ")]
    if child.returncode != 0 or not lines:
        raise AssertionError("oom child failed (rc %d): %s\n%s"
                             % (child.returncode, out[-3000:], err[-3000:]))
    found = json.loads(lines[-1][len("oom child: "):])
    doc = json.load(open(dump_path))
    mem = doc.get("memory") or {}
    census = mem.get("census") or {}
    devices = mem.get("device_memory") or []
    oom = [a for a in doc["anomalies"] if a["rule"] == "oom"]
    if doc["reason"] != "oom" or not mem.get("programs") \
            or not census.get("groups") \
            or devices[0]["bytes_limit"] != total \
            or oom[0]["context"] != "executor_forward":
        raise AssertionError("oom dump: reason %s, %d program records, "
                             "census %s, devices %s, anomalies %s"
                             % (doc["reason"], len(mem.get("programs", [])),
                                census.get("group_count"), devices, oom))
    top = census["groups"][0]
    print("oom blackbox: ResNet-50's general-path step at batch %d (%.1f GB "
          "peak at batch %d) in a child (%.1f s once given its batch): %s; "
          "one dump (%s), "
          "reason %s, context %s; memory section: %d program records, "
          "census %d tensors in %d groups, %.2f GB, the largest %s %s x%d "
          "%.2f GB; device_memory bytes_limit %d (the card's total %d), in "
          "use %d, peak %d; card %s"
          % (batch, peak / 1e9, TRAIN_BATCH, wall, found["caught"],
             found["dumps"], doc["reason"], oom[0]["context"],
             len(mem["programs"]), census["array_count"],
             census["group_count"], census["total_bytes"] / 1e9,
             top["shape"], top["dtype"], top["count"],
             top["total_bytes"] / 1e9, devices[0]["bytes_limit"], total,
             devices[0]["bytes_in_use"], devices[0]["peak_bytes_in_use"],
             card_line()))


def health_serving(mx, seed, arrays):
    """22d, over 22b's GPT-2-small weights.  Returns the serving path's
    launches."""
    import torch
    from mxnet_tpu_torch import executor_cache, threads
    from mxnet_tpu_torch.models import mlp, transformer_lm_symbol
    from mxnet_tpu_torch.observability import (flight_recorder, memprof,
                                               telemetry)
    from mxnet_tpu_torch.ops import kernels as K

    clock = time.perf_counter()
    symbol = transformer_lm_symbol(**GPT2S)
    arg_params, _ = mx.convert.params_from_numpy(arrays, mx.cpu())
    seq = GPT2S["seq_len"]
    rng = np.random.default_rng(seed + 223)
    requests = [rng.integers(0, GPT2S["vocab_size"], (r, seq)).astype(
        np.float32) for r in REQUEST_ROWS]
    small = mlp.get_symbol(num_classes=10)
    shapes, _, _ = small.infer_shape(data=(1, 784))
    bad = {k: rng.standard_normal(s).astype(np.float32) * 0.05
           for k, s in zip(small.list_arguments(), shapes)
           if k not in ("data", "softmax_label")}
    bad["fc3_weight"][3, 7] = np.inf  # the output projection
    bad_params, _ = mx.convert.params_from_numpy(bad, mx.cpu())
    with health_env(health=1, memprof=1):
        executor_cache.clear()
        memprof.reset()
        telemetry.reset()
        flight_recorder.reset()
        server = mx.serving.Server(max_batch_size=MAX_BATCH)
        try:
            server.add_model("gpt2s", symbol, arg_params,
                             input_shapes={"data": (seq,)})
            server.add_model("poisoned", small, bad_params,
                             input_shapes={"data": (784,)})
            report = server.warmup()
            mem = report["memory"]
            K.reset_launch_counts()
            futs = [server.submit_async("gpt2s", {"data": x})
                    for x in requests]
            outs = [f.result(timeout=600)[0] for f in futs]
            launches = K.launch_counts()
            counted = registry_value(telemetry.snapshot(),
                                     "serving.nonfinite_responses")
            bad_outs = [server.submit(
                "poisoned", {"data": rng.random((1, 784), np.float32)},
                timeout=60)[0] for _ in range(POISONED_REQUESTS)]
            after = registry_value(telemetry.snapshot(),
                                   "serving.nonfinite_responses")
        finally:
            server.close()
        notes = [e for e in flight_recorder.get_recorder()._events
                 if e["kind"] == "serving_nonfinite"]
    if threads.live_package_threads():
        raise AssertionError("server threads survived close()")
    total = torch.cuda.mem_get_info()[1]
    print("health serving: warmup's memory section: per-model buckets %s, "
          "footprint %.3f GB, device_limit_bytes %s (the card's total %d), "
          "headroom %.4f; card %s"
          % ({m: sorted(v) for m, v in mem["per_model"].items()},
             mem["footprint_bytes"] / 1e9, mem["device_limit_bytes"], total,
             mem["headroom_frac"], card_line()))
    if mem["device_limit_bytes"] != total or set(mem["per_model"]) \
            != {"gpt2s", "poisoned"} or mem["headroom_frac"] is None:
        raise AssertionError("health serving: the memory section %s" % mem)
    if not all(np.isfinite(o).all() for o in outs) or counted != 0:
        raise AssertionError("health serving: GPT-2-small's responses "
                             "counted %s non-finite" % counted)
    if any(np.isfinite(o).all() for o in bad_outs) \
            or after != POISONED_REQUESTS \
            or len(notes) != POISONED_REQUESTS \
            or any(n["payload"]["model"] != "poisoned" for n in notes):
        raise AssertionError(
            "health serving: %d poisoned responses, counter %s, %d notes"
            % (len(bad_outs), after, len(notes)))
    print("health serving: %d GPT-2-small requests finite (flash launches "
          "%d); %d responses of the model with an inf in fc3_weight shipped "
          "non-finite: serving.nonfinite_responses %d, serving_nonfinite "
          "notes %d" % (len(outs), launches["flash_attn_fwd"],
                        len(bad_outs), after, len(notes)))

    served = time.perf_counter() - clock

    # the paged decoder's pool in the memory report, at 8 streams
    net = gluon_net(mx, GPT2S["num_layers"], arrays, mx.gpu(0))
    params, config = net.decode_param_arrays(), net.config
    del net
    pool = mx.serving.KVBlockPool(
        config["num_layers"], config["num_heads"],
        config["embed_dim"] // config["num_heads"], num_pages=DECODE_PAGES,
        page_size=DECODE_PAGE, name="kv_health", ctx=mx.gpu(0))
    dec = mx.serving.PagedTransformerDecoder(
        params, config, slot_count=DECODE_SLOTS, pool=pool)
    try:
        dec.warmup()
        streams = [dec.submit(rng.integers(0, GPT2S["vocab_size"],
                                           int(rng.integers(
                                               *HEALTH_DECODE_PROMPT))),
                              max_new_tokens=HEALTH_DECODE_NEW)
                   for _ in range(DECODE_SLOTS)]
        dec.step()
        row = [r for r in memprof.pool_records() if r["name"] == "kv_health"]
        used, active = pool.pages_used(), sum(
            1 for s in streams if s.pages)
        dec.drain()
    finally:
        dec.close()
        pool.close()
    print("health serving: paged decoder's pool row %s at %d streams "
          "(the pool's count %d); s of the server %.1f, the decoder %.1f"
          % (row, active, used, served,
             time.perf_counter() - clock - served))
    if len(row) != 1 or row[0]["pages_used"] != used or active \
            != DECODE_SLOTS or row[0]["bytes_used"] != used * pool.page_bytes:
        raise AssertionError("health serving: the pool row %s, the pool's "
                             "%d pages at %d streams" % (row, used, active))
    if [r for r in memprof.pool_records() if r["name"] == "kv_health"]:
        raise AssertionError("health serving: the closed pool's row stayed")
    del dec, pool, params
    _release()
    return launches


def train_health(mx, seed, root):
    """Phase 22.  Returns {path: launches}."""
    clock = time.perf_counter()
    paths = {}
    child = oom_blackbox_start(seed, root)
    try:
        paths["module_fit_health"], peak = health_resnet50(mx, seed, root)
        lap = time.perf_counter()
        print("health: 22a in %.1f s" % (lap - clock))
        paths["module_lm_taps"], arrays = health_lm_taps(mx, seed)
        print("health: 22b in %.1f s" % (time.perf_counter() - lap))
        lap = time.perf_counter()
        oom_blackbox_finish(child, root, peak)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    print("health: 22c in %.1f s" % (time.perf_counter() - lap))
    lap = time.perf_counter()
    paths["serve_health"] = health_serving(mx, seed, arrays)
    print("health: 22d in %.1f s" % (time.perf_counter() - lap))
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
    parser.add_argument("--file-profiles", metavar="ROOT",
                        help=argparse.SUPPRESS)  # file_profiles_apart
    parser.add_argument("--dist-child", metavar="ROOT",
                        help=argparse.SUPPRESS)  # dist_launch
    parser.add_argument("--device-trace", metavar="ROOT",
                        help=argparse.SUPPRESS)  # device_trace_apart
    parser.add_argument("--oom-child", action="store_true",
                        help=argparse.SUPPRESS)  # oom_blackbox_start
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
    if args.file_profiles:
        return file_profiles_child(mx, args.seed, args.file_profiles)
    if args.dist_child:
        return dist_child(mx, args.seed, args.dist_child)
    if args.device_trace:
        return device_trace_child(mx, args.seed, args.device_trace)
    if args.oom_child:
        # started ahead of its turn: the batch arrives on stdin
        return oom_child(mx, args.seed, int(sys.stdin.readline()))
    print("card: %s" % card_line())
    print("torch %s, CUDA %s, %d device(s)"
          % (torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    t0 = time.perf_counter()
    _build.build_all(["flash_attn_fwd", "bn_channel_sums", "pool_bwd",
                      "box_nms", "deformable_im2col"])
    print("kernels built in %.1f s" % (time.perf_counter() - t0))
    from mxnet_tpu_torch import io_native
    from mxnet_tpu_torch.image import codec
    t0 = time.perf_counter()
    native = io_native.get_lib() is not None
    print("native record reader and engine (g++ of src/recordio.cc and "
          "src/engine.cc) built: %s, decode chain (src/image_decode.cc, "
          "needs OpenCV's headers) built: %s, in %.1f s; image codec %s "
          "(available: %s)" % (native, io_native.get_imgdec_lib() is not None,
                               time.perf_counter() - t0, codec.backend(),
                               ", ".join(codec.available())))
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
                  check_pool_bwd, check_lenet_pools, check_dcgan_bn,
                  check_resnet18_kernels, check_stn_pools):
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
    import tempfile
    with tempfile.TemporaryDirectory(dir=HERE) as root:
        paths.update(train_from_files(mx, args.seed, root))
        lap("13 (ResNet-50 from a .rec through ImageIter and "
            "ImageRecordIter, the image ops, Gluon ResNet-18 on CIFAR-10 "
            "files)")
        paths.update(train_from_pipeline(mx, args.seed, root))
        lap("14 (ResNet-50 from an io_pipeline Pipeline in thread and "
            "process mode, ImageDetIter at SSD-300's input, a mem:// "
            "checkpoint)")
        paths.update(train_data_parallel(mx, args.seed, root))
        lap("15 (ResNet-50 over two contexts with kvstore 'tpu_ici' (the "
            "general path: an SGD without a fused update of its own) and "
            "'device', with dist_sync across two processes, Gluon "
            "ResNet-18 through Trainer(kvstore='device'))")
        paths.update(train_mesh_layer(mx, args.seed))
        lap("16 (the multichip LM at GPT-2 small's widths through "
            "ShardedTrainStep over 8 positions of gpu(0), ring attention "
            "against the flash kernel, the dp=4 overlap and 2-bit paths)")
        paths.update(train_mesh_modules(mx, args.seed))
        lap("17 (ResNet-50 through ShardedModule at dp=2, tp=2 and "
            "GPT-2-small blocks through PipelineModule at dp=2, pp=2, over 4 "
            "positions of gpu(0))")
        paths.update(train_fused_dp(mx, args.seed))
        lap("18 (ResNet-50 through the fused data-parallel step over "
            "[gpu(0)] * 2 in f32 and bf16, the GPT-2-small TransformerLM's "
            "bucketed and 2-bit overlap, a group2ctx LSTM LM)")
        dense_paths, nms_record = train_dense_ops(mx, args.seed, root)
        paths.update(dense_paths)
        lap("19 (LeNet-STN through Module.fit on MNIST files, SSD-300's "
            "MultiBox head on ImageDetIter batches, the dense ops at "
            "published sizes)")
        det_paths, prop_rec, im2col_rec = train_detection_sparse(
            mx, args.seed, root)
        paths.update(det_paths)
        lap("20 (Faster R-CNN VGG16 served with Proposal and MultiProposal, "
            "Deformable R-FCN's ops at published sizes, a lazy sparse "
            "linear model at Avazu's width)")
        train_custom_rtc_profile(mx, args.seed, root)
        lap("21 (MXNet 1.0's Custom-softmax MLP through Module.fit, user "
            "CUDA C through mx.rtc, ResNet-50 under the profiler and the "
            "registry, a served LeNet's /metrics, a device trace)")
        paths.update(train_health(mx, args.seed, root))
        lap("22 (ResNet-50 under the health sentinel and memprof, the "
            "GPT-2-small Module LM's attention taps, the OOM black box in a "
            "child, serving under the sentinel)")
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
    # the hand kernels with no TPU counterpart, on a line of their own
    nms_record["instances"] = [prop_rec]
    for rec in (nms_record, im2col_rec):
        rec["launches_by_path"] = {p: c.get(rec["name"], 0)
                                   for p, c in paths.items()}
    if nms_record["launches"] == 0 or prop_rec["launches"] == 0 \
            or im2col_rec["launches"] == 0:
        raise AssertionError("a hand kernel was not launched on its path")
    print("hand kernels without a TPU counterpart: %s"
          % json.dumps({"kernels": [nms_record, im2col_rec]}))
    print(card_line())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
