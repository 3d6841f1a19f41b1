"""Wrapper of the Hopper SSD-scan kernel (``csrc/ssd_scan.cu``).

The TPU kernel (``repro/kernels/ssd_scan/kernel.py``) takes ``(B*H, T, P)``
views padded to a chunk multiple, with B and C gathered to the heads by
``ops.py``. The CUDA kernel needs neither: it reads the model's
``(B, T, H, P)`` / ``(B, T, G, N)`` activations in place through their
(batch, time, head) strides, finds head h's group by index arithmetic, and
masks the ragged tail itself. It also takes the state in and gives the
state out that the model's prefill carries into decode.

The kernel walks the sequence in chunks of its own (``CHUNK`` rows), not
the caller's: the result does not depend on the chunk beyond rounding.
It launches on the current stream and does not synchronise; ``launches``
counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

# kernel launches since import (or since the caller last reset it)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CHUNK = 64       # the kernel's own chunk (kQ in the source)
MAX_STATE = 128  # largest state size N the kernel takes (kMaxN)


def _launcher():
    fn = _build.library("ssd_scan").occam_ssd_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p,
                       ctypes.POINTER(ctypes.c_longlong),
                       i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_scan_cuda_call(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, *, state0: torch.Tensor | None = None,
                       return_state: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The multi-head SSD scan under one launch of the CUDA kernel.

    x: (B, T, H, P); a: (B, T, H) log decay; b, c: (B, T, G, N) with
    H % G == 0 and N <= ``MAX_STATE``; all on one CUDA device in one dtype
    (float32, bfloat16 or float16), any strides (a tensor whose last
    stride is not 1 is made contiguous first). Head h reads group
    ``h // (H // G)``. ``state0``: optional float32 (B, H, N, P) state
    before the first token (zeros when None). Returns ``(y, state)``: y
    (B, T, H, P) in x's dtype, and the float32 (B, H, N, P) state after
    the last token when ``return_state``, else None. Raises on a CPU
    tensor, a shape or dtype the kernel does not take, autograd, or a
    failed build or launch.
    """
    global launches
    tensors = (x, a, b, c) + (() if state0 is None else (state0,))
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("ssd_scan_cuda_call takes CUDA tensors on one "
                         f"device; got {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype
                                          for t in (a, b, c)):
        raise ValueError(f"SSD-scan kernel takes one dtype of "
                         f"{list(_DTYPE_CODES)}; got {x.dtype}, {a.dtype}, "
                         f"{b.dtype}, {c.dtype}")
    if x.ndim != 4 or a.ndim != 3 or b.ndim != 4 or c.shape != b.shape \
            or a.shape != x.shape[:3] or b.shape[:2] != x.shape[:2]:
        raise ValueError(f"x (B, T, H, P), a (B, T, H) and b, c "
                         f"(B, T, G, N) expected; got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if h % g:
        raise ValueError(f"H={h} not a multiple of G={g}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"SSD-scan kernel takes state sizes 1..{MAX_STATE};"
                         f" got N={n}")
    if state0 is not None and (state0.dtype != torch.float32
                               or state0.shape != (bsz, h, n, p)):
        raise ValueError(f"state0 must be float32 {(bsz, h, n, p)}; got "
                         f"{state0.dtype} {tuple(state0.shape)}")
    if torch.is_grad_enabled() and any(tn.requires_grad for tn in tensors):
        raise NotImplementedError(
            "the CUDA SSD-scan kernel has no backward yet (ROADMAP Queue A "
            "10); run it under torch.no_grad()")
    x, b, c = (_last_contiguous(tn) for tn in (x, b, c))
    state_in = None if state0 is None else state0.contiguous()
    y = torch.empty((bsz, t, h, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((bsz, h, n, p), dtype=torch.float32,
                         device=x.device) if return_state else None)
    if y.numel() == 0:  # no token (or no head): nothing to launch
        if state is not None:
            state.copy_(state_in if state_in is not None else 0.0)
        return y, state
    strides = (ctypes.c_longlong * 15)(
        *[s for tn in (x, a, b, c, y) for s in tn.stride()[:3]])
    launch = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(_DTYPE_CODES[x.dtype], x.data_ptr(), a.data_ptr(),
                    b.data_ptr(), c.data_ptr(), y.data_ptr(),
                    None if state_in is None else state_in.data_ptr(),
                    None if state is None else state.data_ptr(), strides,
                    bsz, t, h, g, p, n, stream)
    if rc != 0:
        raise RuntimeError(f"SSD-scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return y, state
