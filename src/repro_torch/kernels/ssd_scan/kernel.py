"""Wrapper of the Hopper SSD-scan kernels (``csrc/ssd_scan.cu``).

The TPU kernel (``repro/kernels/ssd_scan/kernel.py``) takes ``(B*H, T, P)``
views padded to a chunk multiple, with B and C gathered to the heads by
``ops.py``. The CUDA kernel needs neither: it reads the model's
``(B, T, H, P)`` / ``(B, T, G, N)`` activations in place through their
(batch, time, head) strides, finds head h's group by index arithmetic, and
masks the ragged tail itself. It also takes the state in and gives the
state out that the model's prefill carries into decode.

One call launches two kernels on the current stream and does not
synchronise: a pre-pass that writes each chunk's C Bᵀ once per (batch,
group) into a float32 workspace allocated here (``ssd_chunk_cb_cuda_call``
runs it alone), then the scan, whose CTAs, one per (batch, head, P tile),
read it. The scan walks the sequence in chunks of its own (``CHUNK``
rows), not the caller's: the result does not depend on the chunk beyond
rounding. fp32 rows that start 16-byte aligned (``_vec``) are staged by
asynchronous copies in the pre-pass, and in the scan at N = ``MAX_STATE``
(Mamba2's case, an instantiation of its own); every other scan stages
its rows through registers. ``launches`` counts calls; ``last_launch``
holds the last call's launch shape, with the CTAs the device holds per SM
asked once per (dtype, N, staging, device). :func:`smem_bytes` is the pure-Python twin
of the scan's shared-memory size, so its budget (two CTAs per H100 SM)
is checked on the CPU too.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

# calls of ssd_scan_cuda_call since import (or since the caller last reset
# it); each call launches two kernels, the C B^T pre-pass and the scan
launches = 0
# launches of the pre-pass on its own, through ssd_chunk_cb_cuda_call
cb_launches = 0
# the shape of the last scan launch: CTAs, threads, bytes of dynamic shared
# memory, how many CTAs one SM holds at once, whether the scan staged its
# rows by 16-byte asynchronous copies, and the pre-pass's CTAs
last_launch: dict = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CHUNK = 64       # the kernel's own chunk (kQ in the source)
MAX_STATE = 128  # largest state size N the kernel takes (kMaxN)
THREADS = 256    # threads per CTA of either kernel (kThreads)
P_TILE = 64      # columns of P per scan CTA (kPT)
_SCORE_ROW = CHUNK + 4  # padded row of the score tile (kPS)


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def smem_bytes(n: int) -> int:
    """Dynamic shared memory of one scan CTA at state size ``n``: the
    B/C buffer (rows padded to pad4(n) + 4), the x chunk, the state
    (pad4(n) rows), the score tile and three vectors of decays. The twin
    of ``smem_bytes`` in ``csrc/ssd_scan.cu``."""
    np_ = _pad4(n)
    return 4 * (CHUNK * (np_ + 4) + CHUNK * P_TILE + np_ * P_TILE
                + CHUNK * _SCORE_ROW + 3 * CHUNK)


def _launcher():
    fn = _build.library("ssd_scan").occam_ssd_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p,
                       ctypes.POINTER(ctypes.c_longlong),
                       i, i, i, i, i, i, i, p]
        fn.restype = i
    return fn


def _cb_launcher():
    fn = _build.library("ssd_scan").occam_ssd_chunk_cb_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, ctypes.POINTER(ctypes.c_longlong),
                       i, i, i, i, i, p]
        fn.restype = i
    return fn


def _vec(*tensors) -> bool:
    """Whether these tensors' rows (their last dimension) may be staged
    by 16-byte asynchronous copies: fp32, and every row starts 16-byte
    aligned. None stands for an absent state."""
    return all(t.dtype == torch.float32 and t.data_ptr() % 16 == 0
               and t.shape[-1] % 4 == 0
               and all(s % 4 == 0 for s in t.stride()[:-1])
               for t in tensors if t is not None)


@functools.cache
def _occupancy(dtype: int, n: int, vec: bool,
               device: torch.device) -> tuple[int, int]:
    """(dynamic shared memory, scan CTAs one SM holds at once) at state
    size ``n`` for the instantiation ``vec`` picks, from the device; asked
    once per (dtype, n, vec, device)."""
    fn = _build.library("ssd_scan").occam_ssd_scan_occupancy
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        fn.restype = i
    smem, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(dtype, n, int(vec), ctypes.byref(smem), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"SSD-scan occupancy query failed: CUDA error "
                           f"{rc}")
    if smem.value != smem_bytes(n):
        raise RuntimeError(f"SSD-scan shared memory {smem.value} B at N={n}"
                           f" differs from smem_bytes {smem_bytes(n)} B")
    return smem.value, per_sm.value


def _cb_workspace(b: torch.Tensor) -> torch.Tensor:
    """The pre-pass's output: float32 (B, G, ceil(T / CHUNK), CHUNK,
    CHUNK), filled by the kernel."""
    bsz, t, g, _ = b.shape
    return torch.empty((bsz, g, -(-t // CHUNK), CHUNK, CHUNK),
                       dtype=torch.float32, device=b.device)


def ssd_chunk_cb_cuda_call(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The scan's first kernel on its own: every chunk's C Bᵀ.

    b, c: (B, T, G, N) on one CUDA device in one dtype of the scan's,
    N <= ``MAX_STATE``, T >= 1. Returns the float32 (B, G, ceil(T / CHUNK),
    CHUNK, CHUNK) tiles, entry [i, j] = C[t0 + i] . B[t0 + j], zero where
    a row is at or past T (``ref.ssd_chunk_cb_plain`` at ``chunk=CHUNK``).
    ``ssd_scan_cuda_call`` launches the same kernel itself; this wrapper
    lets the kernel be held against its plain version, and counts in
    ``cb_launches``.
    """
    global cb_launches
    if not (b.is_cuda and c.device == b.device):
        raise ValueError("ssd_chunk_cb_cuda_call takes CUDA tensors on one "
                         f"device; got {b.device}, {c.device}")
    if b.dtype not in _DTYPE_CODES or c.dtype != b.dtype:
        raise ValueError(f"C B^T kernel takes one dtype of "
                         f"{list(_DTYPE_CODES)}; got {b.dtype}, {c.dtype}")
    if b.ndim != 4 or c.shape != b.shape or not 1 <= b.shape[3] <= MAX_STATE \
            or b.shape[1] < 1:
        raise ValueError(f"b, c (B, T >= 1, G, N <= {MAX_STATE}) expected; "
                         f"got {tuple(b.shape)}, {tuple(c.shape)}")
    b, c = _last_contiguous(b), _last_contiguous(c)
    bsz, t, g, n = b.shape
    cb = _cb_workspace(b)
    strides = (ctypes.c_longlong * 6)(
        *[s for tn in (b, c) for s in tn.stride()[:3]])
    launch = _cb_launcher()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        rc = launch(_DTYPE_CODES[b.dtype], b.data_ptr(), c.data_ptr(),
                    cb.data_ptr(), strides, bsz, t, g, n,
                    int(_vec(b, c)), stream)
    if rc != 0:
        raise RuntimeError(f"C B^T kernel launch failed: CUDA error {rc}")
    cb_launches += 1
    return cb


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_scan_cuda_call(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, *, state0: torch.Tensor | None = None,
                       return_state: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The multi-head SSD scan under the CUDA kernels: each chunk's C Bᵀ
    once per group into a float32 workspace, then the scan.

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
            "the CUDA SSD-scan kernel has no backward: run it under "
            "torch.no_grad(); training uses ssd_impl=\"chunked\" (ROADMAP "
            "Queue A 3.2)")
    x, b, c = (_last_contiguous(tn) for tn in (x, b, c))
    state_in = None if state0 is None else state0.contiguous()
    y = torch.empty((bsz, t, h, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((bsz, h, n, p), dtype=torch.float32,
                         device=x.device) if return_state else None)
    if y.numel() == 0:  # no token (or no head): nothing to launch
        if state is not None:
            state.copy_(state_in if state_in is not None else 0.0)
        return y, state
    cb = _cb_workspace(b)
    strides = (ctypes.c_longlong * 15)(
        *[s for tn in (x, a, b, c, y) for s in tn.stride()[:3]])
    launch = _launcher()
    vec = _vec(x, b, c, y, state_in, state)
    smem, per_sm = _occupancy(_DTYPE_CODES[x.dtype], n, vec, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(_DTYPE_CODES[x.dtype], x.data_ptr(), a.data_ptr(),
                    b.data_ptr(), c.data_ptr(), y.data_ptr(),
                    None if state_in is None else state_in.data_ptr(),
                    None if state is None else state.data_ptr(),
                    cb.data_ptr(), strides,
                    bsz, t, h, g, p, n, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"SSD-scan kernel launch failed: CUDA error {rc}")
    launches += 1
    last_launch.clear()
    last_launch.update(ctas=bsz * h * -(-p // P_TILE), threads=THREADS,
                       smem=smem, ctas_per_sm=per_sm,
                       async_copies=vec and n == MAX_STATE,
                       cb_ctas=bsz * g * cb.shape[2])
    return y, state
