"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

The TPU kernel (``repro/kernels/flash_attention/kernel.py``) takes
``(B*Hq, S, D)`` views padded to block multiples, with K and V gathered to
the query heads by ``ops.py``. The CUDA kernel needs neither: it reads q,
k and v in place through their (batch, head, row) strides, finds the kv
head of each query head by index arithmetic, and masks ragged tails
itself. So a ``(B, S, H, D)`` activation transposed to ``(B, H, S, D)``
goes in without a copy, and the output is allocated with q's strides.

K and V tiles go into shared memory by ``cp.async``: 16-byte copies where
every k and v row starts 16-byte aligned, else 4-byte copies (the launcher
decides from the pointers and strides; ``_rows_aligned`` is its check). A
bf16 or fp16 k or v whose rows are not even 4-byte aligned is copied to a
fresh tensor first. The kernel launches on the current stream and does not
synchronise; ``launches`` counts its launches, and ``last_launch`` holds the
last launch's shape, with the CTAs the device holds per SM asked once per
(dtype, head dim, device). :func:`smem_bytes` is the pure-Python twin of
the kernel's shared-memory size, so its budget (four CTAs per H100 SM at
d = 64 fp32) is checked on the CPU too.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

# kernel launches since import (or since the caller last reset it)
launches = 0
# the shape of the last launch: CTAs, threads, bytes of dynamic shared
# memory, how many CTAs one SM holds at once, and whether K and V came by
# 16-byte copies
last_launch: dict = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128)
BLOCK_Q = 64    # query rows per CTA, 16 per warp (kBQ in the source)
BLOCK_K = 32    # kv rows per tile (kBK)
THREADS = 128   # threads per CTA (kThreads)
STAGES = 2      # K/V tiles in flight (kStages)


def smem_bytes(d: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA at head dim ``d`` for elements of
    ``itemsize`` bytes: the fp32 q block (rows padded to d + 4), then
    ``STAGES`` K and V tiles whose rows are padded by 16 bytes. The twin
    of ``smem_bytes`` in ``csrc/flash_attention.cu``."""
    return 4 * BLOCK_Q * (d + 4) + STAGES * 2 * BLOCK_K * (d * itemsize + 16)


def _launcher():
    fn = _build.library("flash_attention").occam_flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
                       i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _head_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _rows_aligned(t: torch.Tensor, nbytes: int) -> bool:
    """Whether every (B, H, S, D) row of ``t`` starts on a multiple of
    ``nbytes``: its pointer and each stride over more than one entry. The
    launcher's check (``rows_aligned`` in the source) for k and v."""
    return t.data_ptr() % nbytes == 0 and all(
        size < 2 or stride * t.element_size() % nbytes == 0
        for size, stride in zip(t.shape[:3], t.stride()[:3]))


@functools.cache
def _occupancy(dtype: int, d: int, device: torch.device) -> tuple[int, int]:
    """(dynamic shared memory, CTAs one SM holds at once) of the kernel's
    instantiation for ``dtype`` and head dim ``d``, from the device; asked
    once per (dtype, d, device)."""
    fn = _build.library("flash_attention").occam_flash_attention_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        fn.restype = i
    smem, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(dtype, d, ctypes.byref(smem), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"flash-attention occupancy query failed: CUDA "
                           f"error {rc}")
    itemsize = 4 if dtype == 0 else 2
    if smem.value != smem_bytes(d, itemsize):
        raise RuntimeError(f"flash-attention shared memory {smem.value} B "
                           f"at d={d} differs from smem_bytes "
                           f"{smem_bytes(d, itemsize)} B")
    return smem.value, per_sm.value


def flash_attention_cuda_call(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              seq_q_valid: int | None = None,
                              seq_k_valid: int | None = None
                              ) -> torch.Tensor:
    """softmax(q kᵀ / √d) v under one launch of the CUDA kernel.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) on one CUDA device, one
    dtype (float32, bfloat16 or float16), D in ``HEAD_DIMS``, any strides
    whose last one is 1 (others are made contiguous first). Query head h
    reads kv head ``h // (Hq // Hkv)``. kv rows at or past ``seq_k_valid``
    are masked; the causal mask is bottom-aligned with offset
    ``max(seq_k_valid - seq_q_valid, 0)``. Returns (B, Hq, Sq, D) in q's
    dtype. Raises on a CPU tensor, a shape or dtype the kernel does not
    take, or a failed build or launch.
    """
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda_call takes CUDA tensors on "
                         f"one device; got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash-attention kernel takes one dtype of "
                         f"{list(_DTYPE_CODES)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D) "
                         f"expected; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash-attention kernel takes head dims "
                         f"{HEAD_DIMS}; got {d}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "the CUDA flash-attention kernel has no backward: run it "
            "under torch.no_grad(); training uses attn_impl=\"chunked\" "
            "(ROADMAP Queue A 3.2)")
    sq_valid = sq if seq_q_valid is None else seq_q_valid
    sk_valid = sk if seq_k_valid is None else seq_k_valid
    if not 0 <= sk_valid <= sk:
        raise ValueError(f"seq_k_valid={sk_valid} outside [0, {sk}]")
    q, k, v = (_head_contiguous(t) for t in (q, k, v))
    if q.element_size() == 2:
        # 4-byte copies need 4-byte rows: a 16-bit k or v off by one
        # element goes to a fresh (aligned) tensor
        k, v = (t if _rows_aligned(t, 4) else t.clone(
            memory_format=torch.contiguous_format) for t in (k, v))
    o = torch.empty_like(q)  # q's strides when q is dense, else contiguous
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *[s for t in (q, k, v, o) for s in t.stride()[:3]])
    launch = _launcher()
    smem, per_sm = _occupancy(_DTYPE_CODES[q.dtype], d, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), strides, b, hq, hkv, sq,
                    sk_valid, d, int(causal), max(sk_valid - sq_valid, 0),
                    1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    last_launch.clear()
    last_launch.update(ctas=b * hq * -(-sq // BLOCK_Q), threads=THREADS,
                       smem=smem, ctas_per_sm=per_sm,
                       copies16=_rows_aligned(k, 16) and _rows_aligned(v, 16))
    return o
