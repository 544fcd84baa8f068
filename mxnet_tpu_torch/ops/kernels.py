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

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build

_NEG_INF = -1e30

LAUNCHES = {"flash_attn_fwd": 0, "flash_attn_fwd_lse": 0,
            "bn_channel_sums": 0, "max_pool_backward": 0,
            "avg_pool_backward": 0}

FLASH_HEAD_DIMS = (64, 128)
FLASH_DTYPES = (torch.float32, torch.bfloat16)
# query rows per step of the flash backward (the JAX package's block_q)
FLASH_BWD_BLOCK_Q = 128


def launch_counts():
    return dict(LAUNCHES)


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _reference_attention_lse(q, k, v, causal, scale, kv_lens=None):
    """[B, S, H, D] exact attention, in f32 — the plain version of the
    flash kernel — and the f32 [B, H, Sq] log-sum-exp of each row's
    valid scores, the kernel's LSE output.  ``kv_lens``: optional (B,)
    valid KV length per sequence.  A row with no valid key gives 0 and
    an LSE of -1e30, as the kernel does (the JAX package's reference
    would give the mean of v there; its flash kernel gives 0 and
    m + log(1) = -1e30)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
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
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse


def _reference_attention(q, k, v, causal, scale, kv_lens=None):
    """The plain version of the LSE-less forward: the output alone."""
    return _reference_attention_lse(q, k, v, causal, scale, kv_lens)[0]


def _check_flash_args(q, k, v, kv_lens):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise MXNetError("flash_attention takes [batch, seq, heads, "
                         "head_dim] tensors, got %s, %s, %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise MXNetError("flash_attention: q %s, k %s and v %s disagree"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if d not in FLASH_HEAD_DIMS:
        raise MXNetError("flash_attention: head_dim %d unsupported (the "
                         "kernel takes %s)" % (d, FLASH_HEAD_DIMS))
    if q.dtype not in FLASH_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError("flash_attention: dtypes %s, %s, %s unsupported "
                         "(one of %s for all three)"
                         % (q.dtype, k.dtype, v.dtype, FLASH_DTYPES))
    if not (q.device == k.device == v.device):
        raise MXNetError("flash_attention: q, k, v on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise MXNetError("flash_attention: the head_dim axis must be "
                         "contiguous")
    if kv_lens is not None and (kv_lens.dtype != torch.int32
                                or tuple(kv_lens.shape) != (b,)
                                or kv_lens.device != q.device):
        raise MXNetError("flash_attention: kv_lens must be an int32 (batch,) "
                         "tensor on q's device, got %s %s on %s"
                         % (kv_lens.dtype, tuple(kv_lens.shape),
                            kv_lens.device))


_FLASH_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


def _flash_lib():
    return _lib_fn("flash_attn_fwd", "mxtt_flash_attn_fwd", _FLASH_ARGTYPES)


def flash_attention(q, k, v, causal=False, scale=None, kv_lens=None,
                    with_lse=False):
    """Flash-attention forward.  q: [batch, seq_q, heads, head_dim], k and
    v: [batch, seq_k, heads, head_dim]; head_dim 64 or 128; float32 or
    bfloat16 (f32 accumulate, output in the input dtype); ``kv_lens`` an
    optional int32 (batch,) tensor of valid KV lengths.  With
    ``with_lse`` returns ``(out, lse)``, ``lse`` the f32 [batch, heads,
    seq_q] row log-sum-exp the backward needs.  CUDA tensors run the
    hand-written kernel, CPU tensors its plain version."""
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
    fn = _flash_lib()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if kv_lens is None else kv_lens.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, sq, sk, h, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3],
                 float(scale), int(bool(causal)),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise MXNetError("flash_attn_fwd launch failed: CUDA error %d" % err)
    if with_lse:
        LAUNCHES["flash_attn_fwd_lse"] += 1
        return out, lse
    LAUNCHES["flash_attn_fwd"] += 1
    return out


def _flash_backward(q, k, v, out, lse, d_out, causal, scale, kv_lens=None):
    """(dq, dk, dv) of flash attention from the forward's output and row
    log-sum-exp: the blockwise backward of ``_flash_bwd_jitted``
    (``pallas_kernels.py:240-302``), the same code for CPU and CUDA
    tensors.  Blockwise over ``FLASH_BWD_BLOCK_Q`` query rows, so it holds
    O(block * seq_k) scores per (batch, head) and never the seq_q x
    seq_k matrix; under ``causal`` a block reads only the keys up to its
    last row (the rest carry zero weight).  All arithmetic is f32
    (``D = rowsum(dO * O)`` in particular, which enters ``ds`` by
    cancellation); gradients return in the inputs' dtypes."""
    sq, sk = q.shape[1], k.shape[1]

    def heads_first(t):  # [B, S, H, D] -> contiguous f32 [B, H, S, D]
        return t.float().transpose(1, 2).contiguous()

    qf, kf, vf, dof = (heads_first(t) for t in (q, k, v, d_out))
    delta = (d_out.float() * out.float()).sum(-1).transpose(1, 2)  # [B,H,Sq]
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
                        torch.zeros((), device=q.device))
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

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# blocks the channel-sums grid aims at, per SM (a few waves of 256 threads)
_BN_BLOCKS_PER_SM = 8
_BN_MIN_CHUNK = 2048  # fewest elements one block sums


def _plain_channel_sums(a, b=None):
    """The plain version of ``bn_channel_sums``: f32 ``(sum a, sum a*b)``
    over every axis but 1."""
    a32 = a.float()
    b32 = a32 if b is None else b.float()
    return a32.sum(dim=(0, 2, 3)), (a32 * b32).sum(dim=(0, 2, 3))


def _check_kernel_device(name, tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise MXNetError("%s: inputs on different devices" % name)
    if dev.type == "cuda" and tensors[0].dtype not in KERNEL_DTYPES:
        raise MXNetError("%s: dtype %s unsupported on the card (one of %s)"
                         % (name, tensors[0].dtype, KERNEL_DTYPES))
    if dev.type not in ("cpu", "cuda"):
        raise MXNetError("%s: no kernel for device %s" % (name, dev))
    return dev


def _bn_splits(nhw, c, device):
    """How many blocks share one channel's N*H*W elements: enough for a
    few waves of blocks on the card, none summing fewer than
    ``_BN_MIN_CHUNK`` elements."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-_BN_BLOCKS_PER_SM * sms // max(c, 1))
    return max(1, min(want, -(-nhw // _BN_MIN_CHUNK)))


_BN_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 2
                + [ctypes.c_void_p])


def _lib_fn(source, symbol, argtypes):
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def bn_channel_sums(a, b=None):
    """Per-channel f32 ``(sum a, sum a*b)`` of an NCHW tensor, with
    ``b = a`` when ``b`` is None: BatchNorm's forward statistics (sum and
    sum of squares), or with ``(dy, x)`` its backward pair.  float32 or
    bfloat16 inputs of one dtype and shape.  CUDA tensors run the
    hand-written kernel (one launch, both passes), CPU tensors its plain
    version."""
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
    splits = _bn_splits(n * h * w, c, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    partial = torch.empty(2 * c * splits, **f32)
    out1, out2 = torch.empty(c, **f32), torch.empty(c, **f32)
    bb = a if b is None else b
    fn = _lib_fn("bn_channel_sums", "mxtt_bn_channel_sums", _BN_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), None if b is None else b.data_ptr(),
                 partial.data_ptr(), out1.data_ptr(), out2.data_ptr(),
                 n, c, h, w, *a.stride(), *bb.stride(), splits,
                 int(a.dtype == torch.bfloat16), stream)
    if err != 0:
        raise MXNetError("bn_channel_sums launch failed: CUDA error %d"
                         % err)
    LAUNCHES["bn_channel_sums"] += 1
    return out1, out2


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
    n, c, h, w = x.shape
    (pt, pb), (pl, pr) = pads
    hp = _padded_extent(h, pt, pb, out_shape[0], kernel[0], stride[0])
    wp = _padded_extent(w, pl, pr, out_shape[1], kernel[1], stride[1])
    out = torch.full((n, c, hp, wp), fill, dtype=torch.float32,
                     device=x.device)
    out[:, :, pt:pt + h, pl:pl + w] = x.float()
    return out


def _plain_max_pool_backward(x, dy, kernel, stride, pads):
    """The plain version of ``max_pool_backward``: each window's first
    maximal tap in row-major order (padding is -inf) takes the window's
    cotangent; the sums run in f32 in tap order and cast once."""
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
    dyf = dy.float()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    dxp = torch.zeros_like(xp)
    for t, (i, j) in enumerate(_pool_taps(kernel)):
        _tap_view(dxp, out_shape, stride, i, j).add_(
            torch.where(am == t, dyf, zero))
    (pt, _), (pl, _) = pads
    h, w = x.shape[2:]
    return dxp[:, :, pt:pt + h, pl:pl + w].to(x.dtype)


def _plain_avg_pool_backward(dy, div, x_shape, kernel, stride, pads, dtype):
    """The plain version of ``avg_pool_backward``: every tap of a window
    takes ``dy * div``, summed in f32 in tap order."""
    out_shape = tuple(dy.shape[2:])
    contrib = dy.float() * div
    n, c, h, w = x_shape
    (pt, pb), (pl, pr) = pads
    hp = _padded_extent(h, pt, pb, out_shape[0], kernel[0], stride[0])
    wp = _padded_extent(w, pl, pr, out_shape[1], kernel[1], stride[1])
    dxp = torch.zeros((n, c, hp, wp), dtype=torch.float32, device=dy.device)
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
_AVG_POOL_ARGTYPES = ([ctypes.c_void_p] * 3 + _POOL_GEOMETRY_ARGTYPES
                      + [ctypes.c_longlong] * 4
                      + [ctypes.c_int, ctypes.c_void_p])


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
    fn = _lib_fn("pool_bwd", "mxtt_max_pool_bwd", _MAX_POOL_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 *_geometry(x.shape, dy, kernel, stride, pads),
                 *x.stride(), *dy.stride(),
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise MXNetError("max_pool_backward launch failed: CUDA error %d"
                         % err)
    LAUNCHES["max_pool_backward"] += 1
    return dx


def avg_pool_backward(dy, div, x_shape, kernel, stride, pads, dtype=None):
    """Input gradient of 2-D avg/sum pooling: ``div`` is the (OH, OW)
    float32 map each cotangent is multiplied by — 1 for sum pooling,
    1/prod(kernel) for avg, 1/valid-count under count_include_pad=False.
    Never reads x.  Returns dx of ``x_shape`` in ``dtype`` (default dy's).
    CUDA tensors run the hand-written kernel, CPU tensors its plain
    version."""
    kernel, stride = tuple(kernel), tuple(stride)
    dtype = dy.dtype if dtype is None else dtype
    _check_pool_args("avg_pool_backward", x_shape, dy, kernel, stride, pads)
    if div.dtype != torch.float32 or tuple(div.shape) != tuple(dy.shape[2:]):
        raise MXNetError("avg_pool_backward: div must be a float32 (OH, OW) "
                         "map, got %s %s" % (div.dtype, tuple(div.shape)))
    dev = _check_kernel_device("avg_pool_backward", (dy, div))
    if dev.type == "cpu":
        return _plain_avg_pool_backward(dy, div, x_shape, kernel, stride,
                                        pads, dtype)
    if dtype != dy.dtype:
        raise MXNetError("avg_pool_backward: the kernel writes dx in dy's "
                         "dtype %s, asked for %s" % (dy.dtype, dtype))
    div = div.contiguous()
    dx = torch.empty(tuple(x_shape), dtype=dtype, device=dev)
    fn = _lib_fn("pool_bwd", "mxtt_avg_pool_bwd", _AVG_POOL_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(dy.data_ptr(), div.data_ptr(), dx.data_ptr(),
                 *_geometry(x_shape, dy, kernel, stride, pads),
                 *dy.stride(), int(dy.dtype == torch.bfloat16), stream)
    if err != 0:
        raise MXNetError("avg_pool_backward launch failed: CUDA error %d"
                         % err)
    LAUNCHES["avg_pool_backward"] += 1
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
