"""Hand-written CUDA kernels for hot ops, each beside its plain version.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``.  First kernel:
flash-attention forward (``csrc/flash_attn_fwd.cu``), which replaces the
Pallas kernel of ``pallas_kernels.py:63/338``.

Dispatch follows the tensor, never a flag: a CUDA tensor launches the
kernel (or raises when the kernel cannot take it), and a CPU tensor runs
the plain PyTorch version of the same function.  Each launch adds one to
the kernel's count in :data:`LAUNCHES`, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

_NEG_INF = -1e30

LAUNCHES = {"flash_attn_fwd": 0}

FLASH_HEAD_DIMS = (64, 128)
FLASH_DTYPES = (torch.float32, torch.bfloat16)


def launch_counts():
    return dict(LAUNCHES)


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _reference_attention(q, k, v, causal, scale, kv_lens=None):
    """[B, S, H, D] exact attention, in f32 — the plain version of the
    flash kernel.  ``kv_lens``: optional (B,) valid KV length per
    sequence.  A row with no valid key gives 0, as the kernel does (the
    JAX package's reference would give the mean of v there; its flash
    kernel gives 0)."""
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
    p = torch.softmax(s, dim=-1) * valid.any(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


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


_FLASH_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])


def _flash_lib():
    lib = _build.load("flash_attn_fwd")
    fn = lib.mxtt_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = _FLASH_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, causal=False, scale=None, kv_lens=None):
    """Flash-attention forward.  q: [batch, seq_q, heads, head_dim], k and
    v: [batch, seq_k, heads, head_dim]; head_dim 64 or 128; float32 or
    bfloat16 (f32 accumulate, output in the input dtype); ``kv_lens`` an
    optional int32 (batch,) tensor of valid KV lengths.  CUDA tensors run
    the hand-written kernel, CPU tensors its plain version."""
    _check_flash_args(q, k, v, kv_lens)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / d ** 0.5
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, causal, scale, kv_lens)
    if q.device.type != "cuda":
        raise MXNetError("flash_attention: no kernel for device %s"
                         % q.device)
    fn = _flash_lib()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if kv_lens is None else kv_lens.data_ptr(),
                 b, sq, sk, h, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3],
                 float(scale), int(bool(causal)),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise MXNetError("flash_attn_fwd launch failed: CUDA error %d" % err)
    LAUNCHES["flash_attn_fwd"] += 1
    return out


KERNEL_FAMILIES = ("attn",)


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
    (batch,) tensor and is truncated to int32 here."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if kv_lens is not None:
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32)
    return flash_attention(q, k, v, causal=causal, scale=float(scale),
                           kv_lens=kv_lens)
