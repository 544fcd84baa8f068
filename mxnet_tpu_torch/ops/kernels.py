"""Hand-written CUDA kernels for hot ops, each beside its plain version.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``, one CUDA source per
Pallas kernel:

- ``flash_attention``: ``csrc/flash_attn_fwd.cu``, the forward of the
  Pallas kernel of ``pallas_kernels.py:63/338``, with its per-row
  log-sum-exp output when ``with_lse`` (the differentiated forward);
  :class:`_FlashAttnFn` pairs that forward with the blockwise backward of
  ``pallas_kernels.py:240-302`` (torch ops: the JAX package computes it
  in XLA, not in Pallas);
- ``bn_channel_sums``: ``csrc/bn_channel_sums.cu``, the per-channel
  ``(sum a, sum a*b)`` of ``pallas_kernels.py:643/699``;
- ``max_pool_backward`` and ``avg_pool_backward``: the two entries of
  ``csrc/pool_bwd.cu``, the pooling input gradients of
  ``pallas_kernels.py:515/544/580``.

Dispatch follows the tensor, never a flag: a CUDA tensor launches the
kernel (or raises when the kernel cannot take it), and a CPU tensor runs
the plain PyTorch version of the same function.  Each launch adds one to
the kernel's count in :data:`LAUNCHES`, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import struct

import torch

from ..base import MXNetError
from . import _build

_NEG_INF = -1e30

LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_fwd_lse": 0,
            "bn_channel_sums": 0, "max_pool_backward": 0,
            "avg_pool_backward": 0}

FLASH_HEAD_DIMS = (32, 64, 128)
FLASH_DTYPES = (torch.float32, torch.bfloat16)
# query rows per step of the flash backward (the JAX package's block_q)
FLASH_BWD_BLOCK_Q = 128


def launch_counts():
    return dict(LAUNCHES)


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Around the capture of a CUDA graph, which calls the wrappers but
    launches nothing: yields a dict that holds, once the block ends
    without error, the wrapper calls made inside it (the graph's launches
    at each replay), and sets the counts back to what they were before the
    block in any case."""
    before = dict(LAUNCHES)
    recorded = {}
    try:
        yield recorded
        recorded.update((k, n - before[k]) for k, n in LAUNCHES.items()
                        if n != before[k])
    finally:
        LAUNCHES.update(before)


def add_launch_counts(counts):
    """Count the launches of one replay of a captured CUDA graph: the
    wrapper calls ``captured_launches`` recorded."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def _acc_dtype(dtype):
    """The type the plain versions compute in: f64 for f64 inputs, else
    f32 (the kernels' accumulator)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _reference_attention_lse(q, k, v, causal, scale, kv_lens=None):
    """[B, S, H, D] exact attention, in f32 (f64 for f64 inputs) — the
    plain version of the flash kernel — and the [B, H, Sq] log-sum-exp
    of each row's valid scores, the kernel's LSE output.  ``kv_lens``:
    optional (B,) valid KV length per sequence.  A row with no valid key
    gives 0 and an LSE of -1e30, as the kernel does (the JAX package's
    reference would give the mean of v there; its flash kernel gives 0
    and m + log(1) = -1e30)."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    n_q, n_k = q.shape[1], k.shape[1]
    valid = torch.ones((n_q, n_k), dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid)
    valid = valid[None, None]
    if kv_lens is not None:
        cols = torch.arange(n_k, device=q.device)
        valid = valid & (cols[None, :] < kv_lens.to(torch.int64)[:, None]
                         )[:, None, None, :]
    s = s.masked_fill(~valid, _NEG_INF)
    lse = torch.where(valid.any(dim=-1), torch.logsumexp(s, dim=-1),
                      torch.full((), _NEG_INF, device=q.device))
    p = torch.exp(s - lse[..., None]) * valid
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(acc)).to(q.dtype)
    return out, lse


def _reference_attention(q, k, v, causal, scale, kv_lens=None):
    """The plain version of the LSE-less forward: the output alone."""
    return _reference_attention_lse(q, k, v, causal, scale, kv_lens)[0]


def _check_flash_args(q, k, v, kv_lens):
    """The arguments' agreement with each other, for every device."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise MXNetError("flash_attention takes [batch, seq, heads, "
                         "head_dim] tensors, got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise MXNetError("flash_attention: q %s, k %s and v %s disagree"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not q.is_floating_point() or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError("flash_attention: q, k, v take one floating dtype, "
                         "got %s, %s, %s" % (q.dtype, k.dtype, v.dtype))
    if not (q.device == k.device == v.device):
        raise MXNetError("flash_attention: q, k, v on different devices")
    if kv_lens is not None and (kv_lens.dtype != torch.int32
                                or tuple(kv_lens.shape) != (b,)
                                or kv_lens.device != q.device):
        raise MXNetError("flash_attention: kv_lens must be an int32 (batch,) "
                         "tensor on q's device, got %s %s on %s"
                         % (kv_lens.dtype, tuple(kv_lens.shape),
                            kv_lens.device))


def _check_flash_kernel_args(q, k, v):
    """What the CUDA kernel takes beyond :func:`_check_flash_args`."""
    d = q.shape[-1]
    if d not in FLASH_HEAD_DIMS:
        raise MXNetError("flash_attention: head_dim %d unsupported on the "
                         "card (the kernel takes %s)" % (d, FLASH_HEAD_DIMS))
    if q.dtype not in FLASH_DTYPES:
        raise MXNetError("flash_attention: dtype %s unsupported on the card "
                         "(the kernel takes %s)" % (q.dtype, FLASH_DTYPES))
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise MXNetError("flash_attention: the head_dim axis must be "
                         "contiguous")


_FNS = {}  # C entry name -> its ctypes function, argtypes set


def _lib_fn(source, symbol, argtypes):
    """The ctypes function ``symbol`` of ``csrc/<source>.cu``: built, loaded
    and given its argtypes on first use, then a dict lookup (no lock)."""
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def _on_device(dev):
    """A context in which ``dev`` is the CUDA runtime's current device (a
    launch goes to the current device): nothing to do when it already is."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


# the current stream's handle without building a torch.cuda.Stream
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev):
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(name, fn, *args):
    """Call C entry ``fn``, raise on the CUDA error it returns, count the
    launch under ``name``."""
    err = fn(*args)
    if err != 0:
        raise MXNetError("%s launch failed: CUDA error %d" % (name, err))
    LAUNCHES[name] += 1


_SMS = {}  # device index -> streaming multiprocessors


def _sm_count(dev):
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _SMS[dev.index] = sms
    return sms


_FLASH_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


def _flash_lib():
    return _lib_fn("flash_attn_fwd", "mxtt_flash_attn_fwd", _FLASH_ARGTYPES)


def flash_attention(q, k, v, causal=False, scale=None, kv_lens=None,
                    with_lse=False):
    """Flash-attention forward.  q: [batch, seq_q, heads, head_dim], k and
    v: [batch, seq_k, heads, head_dim], one floating dtype (accumulated
    in f32, output in the input dtype); ``kv_lens`` an
    optional int32 (batch,) tensor of valid KV lengths.  With
    ``with_lse`` returns ``(out, lse)``, ``lse`` the f32 [batch, heads,
    seq_q] row log-sum-exp the backward needs.  CUDA tensors run the
    hand-written kernel, which takes head_dim 32, 64 or 128 and float32
    or bfloat16 (anything else raises); CPU tensors run its plain
    version, for every head_dim and floating dtype."""
    _check_flash_args(q, k, v, kv_lens)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / d ** 0.5
    if q.device.type == "cpu":
        if with_lse:
            return _reference_attention_lse(q, k, v, causal, scale, kv_lens)
        return _reference_attention(q, k, v, causal, scale, kv_lens)
    if q.device.type != "cuda":
        raise MXNetError("flash_attention: no kernel for device %s"
                         % q.device)
    _check_flash_kernel_args(q, k, v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    with _on_device(q.device):
        _launch("flash_attn_fwd_lse" if with_lse else "flash_attn_fwd",
                _flash_lib(),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if kv_lens is None else kv_lens.data_ptr(),
                None if lse is None else lse.data_ptr(),
                b, sq, sk, h, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3],
                float(scale), int(bool(causal)),
                int(q.dtype == torch.bfloat16), _stream(q.device))
    return (out, lse) if with_lse else out


def _flash_backward(q, k, v, out, lse, d_out, causal, scale, kv_lens=None):
    """(dq, dk, dv) of flash attention from the forward's output and row
    log-sum-exp: the blockwise backward of ``_flash_bwd_jitted``
    (``pallas_kernels.py:240-302``), the same code for CPU and CUDA
    tensors.  Blockwise over ``FLASH_BWD_BLOCK_Q`` query rows, so it holds
    O(block * seq_k) scores per (batch, head) and never the seq_q x
    seq_k matrix; under ``causal`` a block reads only the keys up to its
    last row (the rest carry zero weight).  All arithmetic is f32 (f64
    for f64 inputs), ``D = rowsum(dO * O)`` in particular, which enters
    ``ds`` by cancellation; gradients return in the inputs' dtypes."""
    sq, sk = q.shape[1], k.shape[1]

    acc = _acc_dtype(q.dtype)

    def heads_first(t):  # [B, S, H, D] -> contiguous [B, H, S, D]
        return t.to(acc).transpose(1, 2).contiguous()

    qf, kf, vf, dof = (heads_first(t) for t in (q, k, v, d_out))
    delta = (d_out.to(acc) * out.to(acc)).sum(-1).transpose(1, 2)  # [B,H,Sq]
    kv_len = torch.full((q.shape[0],), sk, device=q.device) \
        if kv_lens is None else kv_lens.to(torch.int64).clamp(0, sk)
    cols = torch.arange(sk, device=q.device)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for s0 in range(0, sq, FLASH_BWD_BLOCK_Q):
        s1 = min(s0 + FLASH_BWD_BLOCK_Q, sq)
        kend = min(sk, s1) if causal else sk
        qb, dob = qf[:, :, s0:s1], dof[:, :, s0:s1]
        kb, vb = kf[:, :, :kend], vf[:, :, :kend]
        valid = (cols[:kend][None, :] < kv_len[:, None])[:, None, None, :]
        if causal:
            rows = torch.arange(s0, s1, device=q.device)
            valid = valid & (rows[:, None] >= cols[None, :kend])[None, None]
        sij = torch.matmul(qb, kb.transpose(-1, -2)) * scale
        # explicit re-mask: a row with no valid key has lse -1e30, and
        # exp(s - lse) would resurrect every masked column
        p = torch.where(valid, torch.exp(sij - lse[:, :, s0:s1, None]),
                        torch.zeros((), dtype=acc, device=q.device))
        dp = torch.matmul(dob, vb.transpose(-1, -2))
        ds = p * (dp - delta[:, :, s0:s1, None])
        dq[:, :, s0:s1] = torch.matmul(ds, kb) * scale
        dk[:, :, :kend] += torch.matmul(ds.transpose(-1, -2), qb) * scale
        dv[:, :, :kend] += torch.matmul(p.transpose(-1, -2), dob)
    return tuple(g.transpose(1, 2).to(t.dtype)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


class _FlashAttnFn(torch.autograd.Function):
    """Differentiable flash attention (``_flash_vjp_wrapped`` of the JAX
    package): the forward is the kernel's LSE variant (its plain version
    on CPU tensors), the backward :func:`_flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal, scale):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_lens=kv_lens, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse, kv_lens = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, d_out, ctx.causal,
                                     ctx.scale, kv_lens)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# BatchNorm channel sums
# ---------------------------------------------------------------------------

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
# the element-type codes of the training kernels' C entries (`DType` of
# csrc/bn_channel_sums.cu and csrc/pool_bwd.cu)
_DTYPE_CODES = dict(zip(KERNEL_DTYPES, range(len(KERNEL_DTYPES))))
# blocks the channel-sums grid aims at, per SM (8 blocks of 256 threads
# fill one)
_BN_BLOCKS_PER_SM = 8
_BN_MIN_BLOCK = 4096  # fewest elements one block sums, where it can
_BN_MIN_COUNTERS = 4096  # arrival counters a stream's buffer holds at least


def _plain_channel_sums(a, b=None):
    """The plain version of ``bn_channel_sums``: f32 ``(sum a, sum a*b)``
    over every axis but 1."""
    a32 = a.float()
    b32 = a32 if b is None else b.float()
    return a32.sum(dim=(0, 2, 3)), (a32 * b32).sum(dim=(0, 2, 3))


def _check_kernel_device(name, tensors):
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise MXNetError("%s: inputs on different devices" % name)
    if dev.type == "cuda" and tensors[0].dtype not in KERNEL_DTYPES:
        raise MXNetError("%s: dtype %s unsupported on the card (one of %s)"
                         % (name, tensors[0].dtype, KERNEL_DTYPES))
    if dev.type not in ("cpu", "cuda"):
        raise MXNetError("%s: no kernel for device %s" % (name, dev))
    return dev


def _fast_divider(d):
    """(magic, shift) with ``x // d == (umulhi(x, magic) + x) >> shift`` for
    every 0 <= x < 2**31 (the multiply-high division of PyTorch's
    IntDivider): shift is the least s with 2**s >= d."""
    shift = (d - 1).bit_length()
    return (1 << 32) * ((1 << shift) - d) // d + 1, shift


@functools.lru_cache(maxsize=256)
def _bn_plan(n, c, h, w, vec, sms):
    """How ``csrc/bn_channel_sums.cu`` cuts an (n, c, h, w) input: returns
    ``(splits, group, chunk, magic, shift)``.  Each block sums about
    ``n*c*h*w / (_BN_BLOCKS_PER_SM * sms)`` elements, and at least
    ``_BN_MIN_BLOCK`` where the input allows: a channel larger than that
    is cut into ``splits`` chunks of ``chunk`` units (``vec`` elements
    each) of its flat (n, h*w) range, combined by the last block to
    arrive; smaller channels go ``group`` whole ones to a block.  ``magic``
    and ``shift`` divide a unit index by the units of one plane."""
    per_channel = n * h * w
    target = max(_BN_MIN_BLOCK,
                 -(-c * per_channel // (_BN_BLOCKS_PER_SM * sms)))
    if per_channel > target:
        chunk = -(-per_channel // -(-per_channel // target))
        chunk = -(-chunk // vec) * vec
        splits, group = -(-per_channel // chunk), 1
    else:
        chunk, splits = per_channel, 1
        group = max(1, min(c, target // max(per_channel, 1)))
    magic, shift = _fast_divider(max(h * w // vec, 1))
    return splits, group, chunk // vec, magic, shift


@functools.lru_cache(maxsize=256)
def _bn_layout(h, w, vec, strides):
    """``(vec, flat)`` for views of these strides whose bases are 16-byte
    aligned (see :func:`_bn_vec`)."""
    if h * w % vec == 0 and all(
            sw == 1 and sh == w and sc % vec == 0 and sn % vec == 0
            for sn, sc, sh, sw in strides):
        return vec, True
    return 1, all(sh == w * sw for _, _, sh, sw in strides)


def _bn_vec(tensors, h, w):
    """``(vec, flat)``: the elements of one load, 16 bytes where every view
    is contiguous along its planes and every plane, stride and base is a
    multiple of them, else 1; and whether every plane is contiguous in
    (h, w) order (``stride(2) == w * stride(3)``)."""
    vec, flat = _bn_layout(h, w, 16 // tensors[0].element_size(),
                           tuple(map(torch.Tensor.stride, tensors)))
    if vec > 1:
        for t in tensors:
            if t.data_ptr() % 16:
                return 1, flat
    return vec, flat


# (device index, stream handle) -> int32 arrival counters, all 0 between
# launches.  One buffer per stream: two calls in flight on two streams
# would count their blocks on one counter and combine each other's
# partial sums (csrc/bn_channel_sums.cu).
_BN_COUNTERS = {}


def _bn_counters(dev, stream, c):
    buf = _BN_COUNTERS.get((dev.index, stream))
    if buf is None or buf.numel() < c:
        buf = torch.zeros(max(c, _BN_MIN_COUNTERS), dtype=torch.int32,
                          device=dev)
        _BN_COUNTERS[(dev.index, stream)] = buf
    return buf


# The C entries that run on the main path take their arguments packed as
# int64s (one ctypes argument: converting twenty-odd costs more host time
# than the launch): `BnArgs` of csrc/bn_channel_sums.cu, `AvgArgs` of
# csrc/pool_bwd.cu, field for field.
_BN_ARGS = struct.Struct("<26q")
_PACKED_ARGTYPES = [ctypes.c_char_p]


def bn_channel_sums(a, b=None):
    """Per-channel f32 ``(sum a, sum a*b)`` of an NCHW tensor, with
    ``b = a`` when ``b`` is None: BatchNorm's forward statistics (sum and
    sum of squares), or with ``(dy, x)`` its backward pair.  Floating
    inputs of one dtype and shape (float64 elements are summed in f32).
    CUDA tensors run the hand-written kernel (one launch), CPU tensors its
    plain version."""
    ins = (a,) if b is None else (a, b)
    if a.ndim != 4 or (b is not None and b.shape != a.shape):
        raise MXNetError("bn_channel_sums takes NCHW tensors of one shape, "
                         "got %s" % [tuple(t.shape) for t in ins])
    if not a.is_floating_point() or any(t.dtype != a.dtype for t in ins):
        raise MXNetError("bn_channel_sums takes floating inputs of one "
                         "dtype, got %s" % [t.dtype for t in ins])
    dev = _check_kernel_device("bn_channel_sums", ins)
    if dev.type == "cpu":
        return _plain_channel_sums(a, b)
    n, c, h, w = a.shape
    if n * h * w >= 2 ** 31:
        raise MXNetError("bn_channel_sums: %d elements a channel, the kernel "
                         "takes fewer than 2**31" % (n * h * w))
    vec, flat = _bn_vec(ins, h, w)
    splits, group, chunk, magic, shift = _bn_plan(n, c, h, w, vec,
                                                  _sm_count(dev))
    # the two outputs, then the split channels' partial sums
    out = torch.empty(2 * c * (1 + (splits if splits > 1 else 0)),
                      dtype=torch.float32, device=dev)
    fn = _lib_fn("bn_channel_sums", "mxtt_bn_channel_sums", _PACKED_ARGTYPES)
    with _on_device(dev):
        stream = _stream(dev)
        base = out.data_ptr()
        _launch("bn_channel_sums", fn, _BN_ARGS.pack(
            a.data_ptr(), 0 if b is None else b.data_ptr(), base + 8 * c,
            _bn_counters(dev, stream, c).data_ptr(), base, n, c, h, w,
            *a.stride(), *(a if b is None else b).stride(), vec, flat,
            splits, group, chunk, magic, shift, _DTYPE_CODES[a.dtype],
            stream))
    return out[:c], out[c:2 * c]


# ---------------------------------------------------------------------------
# Pooling backward
# ---------------------------------------------------------------------------

MAX_POOL_TAPS = 64  # the reference's eligibility bound (ops/nn.py)


def _pool_taps(kernel):
    """Window taps (i, j) in row-major order: the tie-break order of the
    recomputed argmax, and the order every pixel's sum is formed in."""
    return [(i, j) for i in range(kernel[0]) for j in range(kernel[1])]


def _padded_extent(size, lo, hi, out, k, s):
    return max(size + lo + hi, (out - 1) * s + k)


def _tap_view(t, out_shape, stride, i, j):
    """The (N, C, OH, OW) strided view of padded tensor ``t`` that tap
    (i, j) of every window reads."""
    oh, ow = out_shape
    sh, sw = stride
    return t[:, :, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]


def _padded(x, pads, out_shape, kernel, stride, fill):
    """x padded with ``fill``, in the type it is computed in."""
    n, c, h, w = x.shape
    (pt, pb), (pl, pr) = pads
    hp = _padded_extent(h, pt, pb, out_shape[0], kernel[0], stride[0])
    wp = _padded_extent(w, pl, pr, out_shape[1], kernel[1], stride[1])
    acc = _acc_dtype(x.dtype)
    out = torch.full((n, c, hp, wp), fill, dtype=acc, device=x.device)
    out[:, :, pt:pt + h, pl:pl + w] = x.to(acc)
    return out


def _plain_max_pool_backward(x, dy, kernel, stride, pads):
    """The plain version of ``max_pool_backward``: each window's first
    maximal tap in row-major order (padding is -inf) takes the window's
    cotangent; the comparisons and the sums, in tap order, run in f32 (f64
    for f64 inputs), and the sums are cast once."""
    out_shape = tuple(dy.shape[2:])
    xp = _padded(x, pads, out_shape, kernel, stride, float("-inf"))
    taps = [_tap_view(xp, out_shape, stride, i, j)
            for i, j in _pool_taps(kernel)]
    m = taps[0]
    for v in taps[1:]:
        m = torch.maximum(m, v)
    n_taps = len(taps)
    am = torch.full(m.shape, n_taps, dtype=torch.int32, device=x.device)
    for t, v in enumerate(taps):
        am = torch.where((v == m) & (am == n_taps), t, am)
    dyf = dy.to(xp.dtype)
    zero = torch.zeros((), dtype=xp.dtype, device=x.device)
    dxp = torch.zeros_like(xp)
    for t, (i, j) in enumerate(_pool_taps(kernel)):
        _tap_view(dxp, out_shape, stride, i, j).add_(
            torch.where(am == t, dyf, zero))
    (pt, _), (pl, _) = pads
    h, w = x.shape[2:]
    return dxp[:, :, pt:pt + h, pl:pl + w].to(x.dtype)


def _plain_avg_pool_backward(dy, div, x_shape, kernel, stride, pads, dtype):
    """The plain version of ``avg_pool_backward``: every tap of a window
    takes ``dy * div``, summed in f32 (f64 for f64 dy) in tap order."""
    out_shape = tuple(dy.shape[2:])
    acc = _acc_dtype(dy.dtype)
    contrib = dy.to(acc) * div.to(acc)
    n, c, h, w = x_shape
    (pt, pb), (pl, pr) = pads
    hp = _padded_extent(h, pt, pb, out_shape[0], kernel[0], stride[0])
    wp = _padded_extent(w, pl, pr, out_shape[1], kernel[1], stride[1])
    dxp = torch.zeros((n, c, hp, wp), dtype=acc, device=dy.device)
    for i, j in _pool_taps(kernel):
        _tap_view(dxp, out_shape, stride, i, j).add_(contrib)
    return dxp[:, :, pt:pt + h, pl:pl + w].to(dtype)


def _check_pool_args(name, x_shape, dy, kernel, stride, pads):
    if len(x_shape) != 4 or dy.ndim != 4 or tuple(dy.shape[:2]) != \
            tuple(x_shape[:2]):
        raise MXNetError("%s takes NCHW x and dy of one (N, C), got %s and "
                         "%s" % (name, tuple(x_shape), tuple(dy.shape)))
    if len(kernel) != 2 or len(stride) != 2 or len(pads) != 2:
        raise MXNetError("%s: a 2-D window, got kernel %s stride %s pads %s"
                         % (name, kernel, stride, pads))
    if math.prod(kernel) > MAX_POOL_TAPS:
        raise MXNetError("%s: %d taps, the kernel takes at most %d"
                         % (name, math.prod(kernel), MAX_POOL_TAPS))
    if not dy.is_floating_point():
        raise MXNetError("%s: floating dy, got %s" % (name, dy.dtype))


_POOL_GEOMETRY_ARGTYPES = [ctypes.c_int] * 12
_MAX_POOL_ARGTYPES = ([ctypes.c_void_p] * 3 + _POOL_GEOMETRY_ARGTYPES
                      + [ctypes.c_longlong] * 8
                      + [ctypes.c_int, ctypes.c_void_p])
_AVG_POOL_ARGS = struct.Struct("<22q")  # `AvgArgs` of csrc/pool_bwd.cu


def _geometry(x_shape, dy, kernel, stride, pads):
    (pt, _), (pl, _) = pads
    return (*x_shape, *dy.shape[2:], *kernel, *stride, pt, pl)


def max_pool_backward(x, dy, kernel, stride, pads):
    """Input gradient of 2-D max pooling.  x: (N, C, H, W); dy: (N, C, OH,
    OW); ``pads`` the ((top, bottom), (left, right)) padding the forward
    used.  Ties go to the first tap in row-major window order; padding
    never wins.  Returns dx shaped and typed like x.  CUDA tensors run the
    hand-written kernel, CPU tensors its plain version."""
    kernel, stride = tuple(kernel), tuple(stride)
    _check_pool_args("max_pool_backward", x.shape, dy, kernel, stride, pads)
    if dy.dtype != x.dtype:
        raise MXNetError("max_pool_backward: x %s and dy %s differ in dtype"
                         % (x.dtype, dy.dtype))
    dev = _check_kernel_device("max_pool_backward", (x, dy))
    if dev.type == "cpu":
        return _plain_max_pool_backward(x, dy, kernel, stride, pads)
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    with _on_device(dev):
        _launch("max_pool_backward",
                _lib_fn("pool_bwd", "mxtt_max_pool_bwd", _MAX_POOL_ARGTYPES),
                x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                *_geometry(x.shape, dy, kernel, stride, pads),
                *x.stride(), *dy.stride(),
                _DTYPE_CODES[x.dtype], _stream(dev))
    return dx


def avg_pool_backward(dy, div, x_shape, kernel, stride, pads, dtype=None):
    """Input gradient of 2-D avg/sum pooling: ``div`` is the (OH, OW)
    map each cotangent is multiplied by — 1 for sum pooling,
    1/prod(kernel) for avg, 1/valid-count under count_include_pad=False —
    in float32, or float64 for float64 dy.
    Never reads x.  Returns dx of ``x_shape`` in ``dtype`` (default dy's).
    CUDA tensors run the hand-written kernel, CPU tensors its plain
    version."""
    kernel, stride = tuple(kernel), tuple(stride)
    dtype = dy.dtype if dtype is None else dtype
    _check_pool_args("avg_pool_backward", x_shape, dy, kernel, stride, pads)
    if div.dtype != _acc_dtype(dy.dtype) \
            or tuple(div.shape) != tuple(dy.shape[2:]):
        raise MXNetError("avg_pool_backward: div must be a %s (OH, OW) map "
                         "for %s dy, got %s %s"
                         % (_acc_dtype(dy.dtype), dy.dtype, div.dtype,
                            tuple(div.shape)))
    dev = _check_kernel_device("avg_pool_backward", (dy, div))
    if dev.type == "cpu":
        return _plain_avg_pool_backward(dy, div, x_shape, kernel, stride,
                                        pads, dtype)
    if dtype != dy.dtype:
        raise MXNetError("avg_pool_backward: the kernel writes dx in dy's "
                         "dtype %s, asked for %s" % (dy.dtype, dtype))
    if not div.is_contiguous():
        div = div.contiguous()
    dx = torch.empty(tuple(x_shape), dtype=dtype, device=dev)
    fn = _lib_fn("pool_bwd", "mxtt_avg_pool_bwd", _PACKED_ARGTYPES)
    with _on_device(dev):
        _launch("avg_pool_backward", fn, _AVG_POOL_ARGS.pack(
            dy.data_ptr(), div.data_ptr(), dx.data_ptr(),
            *_geometry(x_shape, dy, kernel, stride, pads), *dy.stride(),
            _sm_count(dev), _DTYPE_CODES[dy.dtype], _stream(dev)))
    return dx


KERNEL_FAMILIES = ("attn", "bn", "pool")


def kernel_mode(kind, device):
    """How kernel family ``kind`` runs for tensors on ``device``:
    ``'cuda'`` (the hand-written kernel) or ``'plain'`` (its PyTorch
    version, for CPU tensors only)."""
    if kind not in KERNEL_FAMILIES:
        raise MXNetError("unknown kernel family %r" % kind)
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def kernel_signature(device):
    """The resolved mode of every kernel family on ``device``, as a
    hashable tuple — a component of the executor-cache key."""
    return tuple((k, kernel_mode(k, device)) for k in KERNEL_FAMILIES)


def attention(q, k, v, causal=False, scale=None, kv_lens=None):
    """The attention ops' entry to the ``attn`` kernel family.
    q/k/v: [batch, seq, heads, head_dim]; ``kv_lens`` may be any numeric
    (batch,) tensor and is truncated to int32 here.  Under grad mode with
    any of q, k, v requiring grad the call is differentiable
    (:class:`_FlashAttnFn`, the kernel's LSE variant); otherwise it is the
    LSE-less forward, as the JAX package's undifferentiated primal is."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if kv_lens is not None:
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttnFn.apply(q, k, v, kv_lens, bool(causal),
                                  float(scale))
    return flash_attention(q, k, v, causal=causal, scale=float(scale),
                           kv_lens=kv_lens)
