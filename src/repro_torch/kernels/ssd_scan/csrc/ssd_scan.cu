// Mamba-2 SSD chunked scan for Hopper (sm_90a): the recurrence
//   S_t = exp(a_t) S_{t-1} + B_t (x) x_t,   y_t = C_t^T S_t
// computed a chunk at a time in its "state-space duality" form.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_call through pl.pallas_call; group
// broadcast and padding in ops.py::ssd_scan). It computes what that kernel
// computes, per chunk of Q rows with inclusive log-decay cumsum A:
//   L[i, j]   = exp(A[i] - A[j]) for i >= j, else 0   (segment form, <= 0)
//   y_i       = sum_j ((C B^T) * L)[i, j] x_j  +  exp(A[i]) C_i S_in
//   S_out     = exp(A[Q-1]) S_in + sum_j exp(A[Q-1] - A[j]) B_j (x) x_j
// with all products and the carried (N x P) state in fp32, and y written in
// x's dtype. Beyond the TPU kernel it takes an optional state in (read at
// the first chunk in place of the zero reset) and writes an optional state
// out (the state after the last valid token), which the model's prefill
// keeps for decode. Unlike the TPU path it needs no padding and no gathered
// copy of B and C: rows at or past `seq` load as x = 0, a = 0 (decay 1),
// B = C = 0, so they change neither y nor the state, and head h reads group
// h / (H / G) in place through the strides.
//
// The kernel's chunk is its own: Q = 64 rows, whatever chunk the model's
// config names (256 for Mamba2-1.3B). One (Q x Q) fp32 tile at Q = 256
// would be 256 KB, over the 227 KB a block may use, and the result does not
// depend on the chunk beyond rounding (the duality).
//
// What bounds it on this card. The recurrence needs 2 * N * P multiply-adds
// per token and head (the state update and the read-out): Mamba2-1.3B's
// 4 x 1024-token prefill is 8.59 GFLOP per layer against 148 MB of x, y,
// a, B, C and state, so it is bound by operations. The chunked form does
// more of them; all run as fp32 FMAs on the CUDA cores (67 TFLOP/s peak),
// not on the tensor cores.
//
// What the design does about it. Two kernels, launched back to back by one
// call:
// 1. ssd_chunk_cb: one CTA per (batch, group, chunk) computes the chunk's
//    C B^T (Q x Q, fp32) once and writes it to a workspace that stays in
//    L2; every head of the group reads it. At G = 1 that removes the
//    Q N = 8,192 multiply-adds per token and head that each of the 64
//    heads used to repeat.
// 2. ssd_kernel: one CTA of 256 threads per (batch, head, 64-column tile
//    of P) walks the chunks of that head in a loop with the (N x 64) state
//    S in shared memory (the TPU's sequential grid becomes the loop;
//    columns of P are independent, so tiles run in parallel). Per chunk:
//    (a) stage C and x; (b) y = exp(A) C S_in, then the C B^T tile times
//    the decay for j <= i; (c) y += ((C B^T) * L) x, skipping the upper
//    triangle a warp at a time, while B is staged over C; (d) S =
//    exp(A[Q-1]) S + B^T x with B scaled by exp(A[Q-1] - A[j]). Each
//    thread holds a 4 x 4 block of y and an 8 x 4 block of S in
//    registers; operands come from shared memory as 16-byte vectors, with
//    rows padded so that a warp's loads hit distinct banks. B and C share
//    one buffer, which keeps a CTA at 101,120 bytes of shared memory at
//    N = 128 and, with at most 128 registers (__launch_bounds__(256, 2)),
//    two CTAs on an SM: 16 warps hide shared-memory and L2 latency, and
//    the 256 CTAs of Mamba2-1.3B's prefill run in one wave. Mamba2's case
//    (fp32, N = 128, rows 16-byte aligned) has an instantiation of its own
//    with N fixed at compile time that stages rows by cp.async, straight
//    into shared memory: the C B^T tile lands under (b)'s read-out and B
//    under (c)'s product, and no staged data sits in registers, which
//    keeps it within 128 registers. Every other case (bf16, fp16, another
//    N, unaligned fp32) runs the generic instantiation, which stages rows
//    through registers. The pre-pass stages aligned fp32 rows by cp.async
//    and others through registers, chosen at run time.
//    A second stage of copies for the next chunk does not fit: the layout
//    leaves 14,592 of the 115,712 bytes two CTAs may each use, less than
//    one chunk of x.
// Per token and head the scan then does N P (the read-out of S_in) + N P
// (the update) + 36 P (the masked product as run, against Q P / 2 + P / 2
// for the exact triangle) multiply-adds, and the pre-pass Q N / (H / G):
// 18,816 at Q = 64, N = 128, P = 64, H / G = 64, against the recurrence's
// 16,384. Tensor cores (wgmma) and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kQ = 64;              // rows per chunk (the kernel's own)
constexpr int kPT = 64;             // columns of P per CTA
constexpr int kMaxN = 128;          // largest state size N
constexpr int kTX = 16;             // threads across columns
constexpr int kTY = 16;             // threads across rows
constexpr int kThreads = kTX * kTY; // 256
constexpr int kPS = kQ + 4;         // padded row of the score tile
constexpr int kSR = kMaxN / kTY;    // state rows per thread (8)
constexpr int kTileIt = kQ * kQ / 4 / kThreads;  // float4 of a 64 x 64 tile

struct Strides {  // in elements; the last dimension is contiguous
  long long b, t, h;
};

struct Args {
  const void* x;          // (batch, seq, heads, p)
  const void* a;          // (batch, seq, heads)
  const void* b;          // (batch, seq, groups, n)
  const void* c;          // (batch, seq, groups, n)
  void* y;                // (batch, seq, heads, p)
  const float* state_in;  // (batch, heads, n, p) contiguous, or null
  float* state_out;       // (batch, heads, n, p) contiguous, or null
  float* cb;              // (batch, groups, n_chunks, kQ, kQ): C B^T
  Strides sx, sa, sb, sc, sy;
  int heads, groups, seq, n, p;
  int vec;  // pre-pass: 1 for fp32 rows, 16-byte aligned: cp.async staging
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Elements p[0 .. valid) as fp32, zeros after them: one 16-byte load when
// `vec` and all four are valid (p is then 16-byte aligned), else one by one.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int valid, bool vec) {
  if constexpr (std::is_same_v<T, float>) {
    if (vec && valid >= 4) return *reinterpret_cast<const float4*>(p);
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = to_f(p[0]);
  if (valid > 1) v.y = to_f(p[1]);
  if (valid > 2) v.z = to_f(p[2]);
  if (valid > 3) v.w = to_f(p[3]);
  return v;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float4& v, int valid,
                                       bool vec) {
  if constexpr (std::is_same_v<T, float>) {
    if (vec && valid >= 4) {
      *reinterpret_cast<float4*>(p) = v;
      return;
    }
  }
  for (int i = 0; i < valid && i < 4; ++i) p[i] = from_f<T>(get(v, i));
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// Shared memory of the scan kernel for state size n: the B/C buffer (rows
// padded to pad4(n) + 4), the x chunk, the state (pad4(n) rows), the score
// tile and the chunk's decays (A, exp(A), exp(A[Q-1] - A)). Mirrored by
// kernel.py::smem_bytes.
int smem_bytes(int n) {
  const int np = (n + 3) & ~3;
  return (kQ * (np + 4) + kQ * kPT + np * kPT + kQ * kPS + 3 * kQ) *
         static_cast<int>(sizeof(float));
}

int cb_smem_bytes(int n) {  // B and C chunks, rows padded to pad4(n) + 4
  return 2 * kQ * (((n + 3) & ~3) + 4) * static_cast<int>(sizeof(float));
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async, cached in L2 only); valid == false writes 16 zero bytes.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups of copies
// are in flight; its own copies are then visible to it.
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

constexpr int kStageIt = kQ * (kMaxN / 4) / kThreads;  // float4 per thread

// Rows t0 .. t0 + kQ, columns [0, width) of a (seq, cols) operand into dst,
// rows padded to ld, as fp32; zeros at or past seq and at or past cols.
// width is a multiple of 4, at most kMaxN. With `vec` (fp32, 16-byte
// aligned rows, cols a multiple of 4) by asynchronous copies that the
// caller commits and waits for, then scales with scale_rows if it must;
// else through registers, all of a thread's loads in flight at once, each
// row r scaled by scale[r] on the way when scale is given.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long stride_t, int t0, int seq,
                                      int width, int cols, bool vec,
                                      const float* scale) {
  const int w4 = width / 4;
  if constexpr (std::is_same_v<T, float>) {
    if (vec) {
      for (int e = threadIdx.x; e < kQ * w4; e += kThreads) {
        const int r = e / w4, k = (e % w4) * 4;
        const bool in = t0 + r < seq && k < cols;
        copy16(dst + r * ld + k, in ? src + (t0 + r) * stride_t + k : src,
               in);
      }
      return;
    }
  }
  float4 v[kStageIt];
#pragma unroll
  for (int it = 0; it < kStageIt; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / w4, k = (e % w4) * 4;
    v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < kQ * w4 && t0 + r < seq) {
      v[it] = load4(src + (t0 + r) * stride_t + k, cols - k, vec);
    }
  }
#pragma unroll
  for (int it = 0; it < kStageIt; ++it) {
    const int e = threadIdx.x + it * kThreads;
    if (e < kQ * w4) {
      const int r = e / w4, k = (e % w4) * 4;
      float4 w = v[it];
      if (scale != nullptr) {
        const float f = scale[r];
        w.x *= f;
        w.y *= f;
        w.z *= f;
        w.w *= f;
      }
      *reinterpret_cast<float4*>(dst + r * ld + k) = w;
    }
  }
}

// Row r of dst times scale[r], over the elements this thread staged by
// asynchronous copies (the same mapping as stage), after it waited for them.
__device__ __forceinline__ void scale_rows(float* dst, int ld, int width,
                                           const float* scale) {
  const int w4 = width / 4;
  for (int e = threadIdx.x; e < kQ * w4; e += kThreads) {
    const int r = e / w4, k = (e % w4) * 4;
    float4* p = reinterpret_cast<float4*>(dst + r * ld + k);
    float4 v = *p;
    const float f = scale[r];
    v.x *= f;
    v.y *= f;
    v.z *= f;
    v.w *= f;
    *p = v;
  }
}

// C B^T of one (batch, group, chunk): a (kQ x kQ) fp32 tile, written once
// and read by every head of the group. Rows past seq load as zeros, so
// their rows and columns of the tile are zero. Thread (tx, ty) owns rows
// ty + 16 r and columns tx + 16 q, reading both operands 4 k at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_cb(const __grid_constant__ Args a) {
  const int ns = pad4(a.n) + 4;
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);
  float* sC = sB + kQ * ns;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int ic = blockIdx.x;
  const int g = blockIdx.y;
  const int bi = blockIdx.z;
  const int t0 = ic * kQ;
  const bool vec = a.vec != 0;
  const int np = pad4(a.n);
  stage(sB, ns, static_cast<const T*>(a.b) + bi * a.sb.b + g * a.sb.h,
        a.sb.t, t0, a.seq, np, a.n, vec, nullptr);
  stage(sC, ns, static_cast<const T*>(a.c) + bi * a.sc.b + g * a.sc.h,
        a.sc.t, t0, a.seq, np, a.n, vec, nullptr);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  float acc[4][4] = {};
#pragma unroll 2
  for (int k = 0; k < np; k += 4) {
    float4 cr[4], bc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cr[r] = lds4(sC + (ty + kTY * r) * ns + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) bc[q] = lds4(sB + (tx + kTX * q) * ns + k);
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = fmaf(get(cr[r], v), get(bc[q], v), acc[r][q]);
  }
  float* out = a.cb + ((static_cast<long long>(bi) * a.groups + g) *
                           gridDim.x + ic) * (kQ * kQ);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[(ty + kTY * r) * kQ + tx + kTX * q] = acc[r][q];
}

// kN > 0: Mamba2's case, fp32 with 16-byte aligned rows and the state
// size kN fixed at compile time, so that every loop bound and shared-memory
// offset is a constant; its rows are staged by asynchronous copies. kN == 0
// reads the state size from the arguments and stages rows through
// registers.
template <typename T, int kN>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_kernel(const __grid_constant__ Args a) {
  static_assert(kN == 0 || std::is_same_v<T, float>, "kN > 0 is fp32");
  const int n_state = kN > 0 ? kN : a.n;
  const int np = pad4(n_state);  // state rows, padded with zero rows
  const int ns = np + 4;         // padded row of the B/C buffer
  extern __shared__ float4 smem4[];
  float* sBC = reinterpret_cast<float*>(smem4);  // kQ x ns: C, then B
  float* sX = sBC + kQ * ns;     // kQ x kPT
  float* sS = sX + kQ * kPT;     // np x kPT, the carried state
  float* sP = sS + np * kPT;     // kQ x kPS, (C B^T) * L
  float* sA = sP + kQ * kPS;     // kQ: inclusive cumsum of the decays
  float* sEA = sA + kQ;          // kQ: exp(A[i])
  float* sDR = sEA + kQ;         // kQ: exp(A[Q-1] - A[i])

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int bh = blockIdx.x;
  const int bi = bh / a.heads;
  const int h = bh % a.heads;
  const int g = h / (a.heads / a.groups);
  const int p0 = blockIdx.y * kPT;
  constexpr bool vec = kN > 0;            // 16-byte rows, cp.async staging
  const int pc = 4 * tx;                  // this thread's 4 columns of P
  const int p_valid = a.p - p0 - pc;      // how many of them exist

  const T* xg = static_cast<const T*>(a.x) + bi * a.sx.b + h * a.sx.h + p0;
  const T* ag = static_cast<const T*>(a.a) + bi * a.sa.b + h * a.sa.h;
  const T* bg = static_cast<const T*>(a.b) + bi * a.sb.b + g * a.sb.h;
  const T* cg = static_cast<const T*>(a.c) + bi * a.sc.b + g * a.sc.h;
  T* yg = static_cast<T*>(a.y) + bi * a.sy.b + h * a.sy.h + p0;
  const long long state_off =
      (static_cast<long long>(bi) * a.heads + h) * n_state * a.p + p0;
  const int n_chunks = (a.seq + kQ - 1) / kQ;
  const float* cb_head = a.cb + (static_cast<long long>(bi) * a.groups + g) *
                                    n_chunks * (kQ * kQ);

  // the state: read from state_in, or the TPU kernel's zero reset
  for (int e = tid; e < np * (kPT / 4); e += kThreads) {
    const int r = e / (kPT / 4), col = (e % (kPT / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a.state_in != nullptr && r < n_state) {
      v = load4(a.state_in + state_off + static_cast<long long>(r) * a.p +
                    col,
                a.p - p0 - col, vec);
    }
    *reinterpret_cast<float4*>(sS + r * kPT + col) = v;
  }

  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * kQ;
    // ---- (a) stage C and x, copy the group's C B^T tile into the score
    // tile (asynchronously, for (b)); warp 0 scans the decays
    stage(sBC, ns, cg, a.sc.t, t0, a.seq, np, n_state, vec, nullptr);
    stage(sX, kPT, xg, a.sx.t, t0, a.seq, kPT, a.p - p0, vec, nullptr);
    copy_commit();
    {
      const float* cbt = cb_head + static_cast<long long>(ic) * (kQ * kQ);
#pragma unroll
      for (int it = 0; it < kTileIt; ++it) {
        const int e = (tid + it * kThreads) * 4;
        copy16(sP + (e / kQ) * kPS + e % kQ, cbt + e, true);
      }
    }
    copy_commit();
    if (tid < 32) {  // warp 0: inclusive scan of the chunk's 64 decays
      const int r0 = t0 + 2 * tid;
      const float a0 = r0 < a.seq ? to_f(ag[r0 * a.sa.t]) : 0.f;
      const float a1 = r0 + 1 < a.seq ? to_f(ag[(r0 + 1) * a.sa.t]) : 0.f;
      float s = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += o;
      }
      const float excl = s - (a0 + a1);
      const float tot = __shfl_sync(0xffffffffu, s, 31);
      const float c0 = excl + a0;
      sA[2 * tid] = c0;
      sA[2 * tid + 1] = s;
      sEA[2 * tid] = expf(c0);
      sEA[2 * tid + 1] = expf(s);
      sDR[2 * tid] = expf(tot - c0);
      sDR[2 * tid + 1] = expf(tot - s);
    }
    copy_wait<1>();   // C and x have landed (the C B^T tile may not have)
    __syncthreads();

    // ---- (b) y = exp(A[i]) C_i S_in on rows i = 4 ty + r, columns pc + q,
    // while the C B^T tile lands; then scores = (C B^T)[i, j] *
    // exp(A[i] - A[j]) for j <= i, else 0, in place on this thread's part
    float acc[4][4] = {};
    if (ic > 0 || a.state_in != nullptr) {
#pragma unroll 2
      for (int k = 0; k < np; k += 4) {
        float4 cr[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = lds4(sBC + (4 * ty + r) * ns + k);
#pragma unroll
        for (int v = 0; v < 4; ++v) sv[v] = lds4(sS + (k + v) * kPT + pc);
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float cv = get(cr[r], v);
            acc[r][0] = fmaf(cv, sv[v].x, acc[r][0]);
            acc[r][1] = fmaf(cv, sv[v].y, acc[r][1]);
            acc[r][2] = fmaf(cv, sv[v].z, acc[r][2]);
            acc[r][3] = fmaf(cv, sv[v].w, acc[r][3]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = sEA[4 * ty + r];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }
    }
    copy_wait<0>();
#pragma unroll
    for (int it = 0; it < kTileIt; ++it) {
      const int e = (tid + it * kThreads) * 4;
      const int i = e / kQ, j = e % kQ;
      const float ai = sA[i];
      float4* pp = reinterpret_cast<float4*>(sP + i * kPS + j);
      float4 v = *pp;
      v.x = j <= i ? v.x * expf(ai - sA[j]) : 0.f;
      v.y = j + 1 <= i ? v.y * expf(ai - sA[j + 1]) : 0.f;
      v.z = j + 2 <= i ? v.z * expf(ai - sA[j + 2]) : 0.f;
      v.w = j + 3 <= i ? v.w * expf(ai - sA[j + 3]) : 0.f;
      *pp = v;
    }
    __syncthreads();  // the score tile is whole; every read of C is done

    // ---- (c) stage B over C, scaled by exp(A[Q-1] - A[j]) (asynchronous
    // copies land under the masked product and are scaled after it); y +=
    // scores x over j < 8 w + 8, the last row of warp w
    stage(sBC, ns, bg, a.sb.t, t0, a.seq, np, n_state, vec, sDR);
    copy_commit();
    {
      const int j_end = 8 * (ty / 2) + 8;
#pragma unroll 2
      for (int j = 0; j < j_end; j += 4) {
        float4 pr[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pr[r] = lds4(sP + (4 * ty + r) * kPS + j);
#pragma unroll
        for (int v = 0; v < 4; ++v) xv[v] = lds4(sX + (j + v) * kPT + pc);
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pv = get(pr[r], v);
            acc[r][0] = fmaf(pv, xv[v].x, acc[r][0]);
            acc[r][1] = fmaf(pv, xv[v].y, acc[r][1]);
            acc[r][2] = fmaf(pv, xv[v].z, acc[r][2]);
            acc[r][3] = fmaf(pv, xv[v].w, acc[r][3]);
          }
      }
    }
    if constexpr (vec) {
      copy_wait<0>();
      scale_rows(sBC, ns, np, sDR);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long t = t0 + 4 * ty + r;
      if (t < a.seq) {
        store4(yg + t * a.sy.t + pc,
               make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]),
               p_valid, vec);
      }
    }
    __syncthreads();  // B is staged

    // ---- (d) S = exp(A[Q-1]) S + (scaled B)^T x on rows 8 ty + r; each
    // thread reads and writes only its own elements of S
    if (8 * ty < np) {
      float upd[kSR][4] = {};
#pragma unroll 2
      for (int j = 0; j < kQ; ++j) {
        const float4 b0 = lds4(sBC + j * ns + 8 * ty);
        const float4 b1 = lds4(sBC + j * ns + 8 * ty + 4);
        const float4 xv = lds4(sX + j * kPT + pc);
#pragma unroll
        for (int r = 0; r < kSR; ++r) {
          const float bv = r < 4 ? get(b0, r) : get(b1, r - 4);
          upd[r][0] = fmaf(bv, xv.x, upd[r][0]);
          upd[r][1] = fmaf(bv, xv.y, upd[r][1]);
          upd[r][2] = fmaf(bv, xv.z, upd[r][2]);
          upd[r][3] = fmaf(bv, xv.w, upd[r][3]);
        }
      }
      const float e_tot = sEA[kQ - 1];
      const bool last = ic == n_chunks - 1 && a.state_out != nullptr;
#pragma unroll
      for (int r = 0; r < kSR; ++r) {
        const int k = 8 * ty + r;
        if (k >= np) continue;
        float4 s = lds4(sS + k * kPT + pc);
        s.x = fmaf(e_tot, s.x, upd[r][0]);
        s.y = fmaf(e_tot, s.y, upd[r][1]);
        s.z = fmaf(e_tot, s.z, upd[r][2]);
        s.w = fmaf(e_tot, s.w, upd[r][3]);
        *reinterpret_cast<float4*>(sS + k * kPT + pc) = s;
        if (last && k < n_state) {
          store4(a.state_out + state_off + static_cast<long long>(k) * a.p +
                     pc,
                 s, p_valid, vec);
        }
      }
    }
    __syncthreads();  // every read of B, x and S of this chunk is done
  }
}

template <typename T>
int launch_cb(const Args& a, int batch, cudaStream_t s) {
  const int bytes = cb_smem_bytes(a.n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_cb<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.seq + kQ - 1) / kQ, a.groups, batch);
  ssd_chunk_cb<T><<<grid, kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

using ScanKernel = void (*)(const Args);

// The scan's instantiation for state size n, with `vec` for 16-byte aligned
// fp32 rows, its shared memory set.
template <typename T>
ScanKernel scan_kernel(int n, bool vec, int* err) {
  ScanKernel k = ssd_kernel<T, 0>;
  if constexpr (std::is_same_v<T, float>) {
    if (n == kMaxN && vec) k = ssd_kernel<float, kMaxN>;
  }
  *err = static_cast<int>(cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(n)));
  return k;
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t s) {
  int err = launch_cb<T>(a, batch, s);
  if (err != 0) return err;
  const ScanKernel k = scan_kernel<T>(a.n, a.vec != 0, &err);
  if (err != 0) return err;
  const dim3 grid(batch * a.heads, (a.p + kPT - 1) / kPT);
  k<<<grid, kThreads, smem_bytes(a.n), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int n, bool vec, int* ctas_per_sm) {
  int err = 0;
  const ScanKernel k = scan_kernel<T>(n, vec, &err);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, k, kThreads, smem_bytes(n)));
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (x, a, b, c and y alike). x and
// y: (batch, seq, heads, p); a: (batch, seq, heads); b and c: (batch, seq,
// groups, n); each given by its (batch, seq, head-or-group) strides in
// elements, in the order x, a, b, c, y, with the last dimension contiguous
// (a has none). state_in and state_out: float32 (batch, heads, n, p),
// contiguous, each may be null. cb: a float32 workspace of (batch, groups,
// ceil(seq / 64), 64, 64) elements, 16-byte aligned, that the first kernel
// fills with each chunk's C B^T and the second reads. seq >= 1;
// 1 <= n <= 128; heads % groups == 0. vec: 1 when the rows of x, b, c, y
// and the states are fp32 and start 16-byte aligned (every pointer
// 16-byte aligned; n, p and the strides multiples of 4): the pre-pass then
// stages them by 16-byte asynchronous copies, and so does the scan at
// n = 128.
// Launches both kernels on `stream`, does not synchronise, and returns
// the first nonzero cudaGetLastError() after a launch (0 if none).
extern "C" int occam_ssd_scan_launch(
    int dtype, const void* x, const void* a, const void* b, const void* c,
    void* y, const float* state_in, float* state_out, float* cb,
    const long long* strides, int batch, int seq, int heads, int groups,
    int p, int n, int vec, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || groups < 1 || heads % groups ||
      p < 1 || n < 1 || n > kMaxN ||
      static_cast<long long>(batch) * heads > 2147483647LL ||
      (p + kPT - 1) / kPT > 65535 || batch > 65535 || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args = {};
  args.x = x;
  args.a = a;
  args.b = b;
  args.c = c;
  args.y = y;
  args.state_in = state_in;
  args.state_out = state_out;
  args.cb = cb;
  args.sx = {strides[0], strides[1], strides[2]};
  args.sa = {strides[3], strides[4], strides[5]};
  args.sb = {strides[6], strides[7], strides[8]};
  args.sc = {strides[9], strides[10], strides[11]};
  args.sy = {strides[12], strides[13], strides[14]};
  args.heads = heads;
  args.groups = groups;
  args.seq = seq;
  args.n = n;
  args.p = p;
  args.vec = dtype == 0 && vec != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(args, batch, s);
    case 1: return launch<__nv_bfloat16>(args, batch, s);
    case 2: return launch<__half>(args, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The first kernel alone: each chunk's C B^T into cb (as above). b and c:
// (batch, seq, groups, n) in one dtype, strides (batch, seq, group) in
// elements in the order b, c; vec as above for b and c. Launches on
// `stream` and returns cudaGetLastError() of the launch.
extern "C" int occam_ssd_chunk_cb_launch(int dtype, const void* b,
                                         const void* c, float* cb,
                                         const long long* strides, int batch,
                                         int seq, int groups, int n, int vec,
                                         void* stream) {
  if (batch < 1 || seq < 1 || groups < 1 || n < 1 || n > kMaxN ||
      batch > 65535 || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args = {};
  args.b = b;
  args.c = c;
  args.cb = cb;
  args.sb = {strides[0], strides[1], strides[2]};
  args.sc = {strides[3], strides[4], strides[5]};
  args.groups = groups;
  args.seq = seq;
  args.n = n;
  args.vec = dtype == 0 && vec != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_cb<float>(args, batch, s);
    case 1: return launch_cb<__nv_bfloat16>(args, batch, s);
    case 2: return launch_cb<__half>(args, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The scan kernel's dynamic shared memory for state size n, and how many of
// its CTAs (256 threads) one SM holds at once, into *ctas_per_sm, for the
// instantiation a launch with 16-byte aligned fp32 rows (vec != 0) or
// without them takes; returns the CUDA error of the query.
extern "C" int occam_ssd_scan_occupancy(int dtype, int n, int vec, int* smem,
                                        int* ctas_per_sm) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(n);
  switch (dtype) {
    case 0: return occupancy<float>(n, vec != 0, ctas_per_sm);
    case 1: return occupancy<__nv_bfloat16>(n, false, ctas_per_sm);
    case 2: return occupancy<__half>(n, false, ctas_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
