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
// more of them, (Q N + Q P / 2 + 2 N P) per token and head (C B^T, the
// masked intra-chunk product, C S_in, the state update), 1.6x the
// recurrence at Q = 64, N = 128, P = 64, in exchange for dense products.
// This first version runs them as fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores.
//
// What the design does about it. The TPU walked the chunks in order on one
// core with S in VMEM scratch. Here one CTA of 256 threads owns one
// (batch, head, 64-column tile of P) and walks all chunks of that head in
// a loop with S in shared memory: columns of P are independent, so the
// tiles run in parallel. Per chunk, B, C and x are staged in shared memory
// (rows padded so that every warp's loads hit distinct banks); warp 0 scans
// the chunk's decays with shuffles; each thread then computes a 4 x 4
// block of C B^T * L, a 4 x 4 block of y and an 8 x 4 block of the new
// state in registers. The state update accumulates before the barrier that
// ends the read-out and is written after it, so a chunk takes three
// barriers. C B^T is recomputed by every head of a group (64 times at
// G = 1); sharing it, wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 64;              // rows per chunk (the kernel's own)
constexpr int kPT = 64;             // columns of P per CTA
constexpr int kMaxN = 128;          // largest state size N
constexpr int kTX = 16;             // threads across columns
constexpr int kTY = 16;             // threads across rows
constexpr int kThreads = kTX * kTY; // 256
constexpr int kPS = kQ + 16;        // padded row of the score tile
constexpr int kSR = kMaxN / kTY;    // state rows per thread (8)

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
  Strides sx, sa, sb, sc, sy;
  int heads, groups, seq, n, p;
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

int smem_bytes(int n) {
  // B and C chunks padded to n + 1, x chunk, state, score tile, and the
  // chunk's cumulative decays with exp(A) and exp(A[Q-1] - A)
  return (2 * kQ * (n + 1) + kQ * kPT + n * kPT + kQ * kPS + 3 * kQ) *
         static_cast<int>(sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const __grid_constant__ Args a) {
  const int n_state = a.n;
  const int ns = n_state + 1;    // padded row of the B and C chunks
  extern __shared__ float smem[];
  float* sB = smem;              // kQ x ns
  float* sC = sB + kQ * ns;      // kQ x ns
  float* sX = sC + kQ * ns;      // kQ x kPT
  float* sS = sX + kQ * kPT;     // n x kPT, the carried state
  float* sP = sS + n_state * kPT;  // kQ x kPS, (C B^T) * L
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

  const T* xg = static_cast<const T*>(a.x) + bi * a.sx.b + h * a.sx.h + p0;
  const T* ag = static_cast<const T*>(a.a) + bi * a.sa.b + h * a.sa.h;
  const T* bg = static_cast<const T*>(a.b) + bi * a.sb.b + g * a.sb.h;
  const T* cg = static_cast<const T*>(a.c) + bi * a.sc.b + g * a.sc.h;
  T* yg = static_cast<T*>(a.y) + bi * a.sy.b + h * a.sy.h + p0;
  const long long state_off =
      (static_cast<long long>(bi) * a.heads + h) * n_state * a.p + p0;

  // the state: read from state_in, or the TPU kernel's zero reset
  for (int i = tid; i < n_state * kPT; i += kThreads) {
    const int r = i / kPT, col = i % kPT;
    sS[i] = (a.state_in != nullptr && p0 + col < a.p)
                ? a.state_in[state_off + static_cast<long long>(r) * a.p + col]
                : 0.f;
  }

  const int n_chunks = (a.seq + kQ - 1) / kQ;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * kQ;
    // ---- stage the chunk; rows past seq load as zeros (a = 0: decay 1)
    for (int i = tid; i < kQ * n_state; i += kThreads) {
      const int r = i / n_state, k = i % n_state;
      const long long t = t0 + r;
      const bool in = t < a.seq;
      sB[r * ns + k] = in ? to_f(bg[t * a.sb.t + k]) : 0.f;
      sC[r * ns + k] = in ? to_f(cg[t * a.sc.t + k]) : 0.f;
    }
    for (int i = tid; i < kQ * kPT; i += kThreads) {
      const int r = i / kPT, col = i % kPT;
      const long long t = t0 + r;
      sX[i] = (t < a.seq && p0 + col < a.p) ? to_f(xg[t * a.sx.t + col])
                                            : 0.f;
    }
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
    __syncthreads();

    // ---- scores: (C B^T)[i, j] * exp(A[i] - A[j]) below the diagonal
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 8
      for (int k = 0; k < n_state; ++k) {
        float cr[4], bc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = sC[(ty + kTY * r) * ns + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) bc[q] = sB[(tx + kTX * q) * ns + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cr[r], bc[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + kTY * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tx + kTX * q;
          sP[i * kPS + j] = j <= i ? acc[r][q] * expf(sA[i] - sA[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = exp(A) * (C S_in) + ((C B^T) * L) x, rows i, columns p
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      if (ic > 0 || a.state_in != nullptr) {
#pragma unroll 8
        for (int k = 0; k < n_state; ++k) {
          float cr[4], sv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cr[r] = sC[(ty + kTY * r) * ns + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) sv[q] = sS[k * kPT + tx + kTX * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cr[r], sv[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = sEA[ty + kTY * r];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] *= e;
        }
      }
#pragma unroll 8
      for (int j = 0; j < kQ; ++j) {
        float pr[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pr[r] = sP[(ty + kTY * r) * kPS + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = sX[j * kPT + tx + kTX * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(pr[r], xv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long t = t0 + ty + kTY * r;
        if (t >= a.seq) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = tx + kTX * q;
          if (p0 + col < a.p) yg[t * a.sy.t + col] = from_f<T>(acc[r][q]);
        }
      }
    }

    // ---- state update, accumulated before the barrier that ends the
    // read-out of S_in and written after it; thread rows n = ty + 16 r
    float upd[kSR][4];
#pragma unroll
    for (int r = 0; r < kSR; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) upd[r][q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kQ; ++j) {
      const float dr = sDR[j];
      float bv[kSR], xv[4];
#pragma unroll
      for (int r = 0; r < kSR; ++r) {
        const int k = ty + kTY * r;
        bv[r] = k < n_state ? sB[j * ns + k] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = sX[j * kPT + tx + kTX * q] * dr;
#pragma unroll
      for (int r = 0; r < kSR; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) upd[r][q] = fmaf(bv[r], xv[q], upd[r][q]);
    }
    const float e_tot = expf(sA[kQ - 1]);
    __syncthreads();  // every read of sS, sB, sC, sX of this chunk is done
    const bool last = ic == n_chunks - 1;
#pragma unroll
    for (int r = 0; r < kSR; ++r) {
      const int k = ty + kTY * r;
      if (k >= n_state) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = tx + kTX * q;
        const float s = fmaf(e_tot, sS[k * kPT + col], upd[r][q]);
        sS[k * kPT + col] = s;
        if (last && a.state_out != nullptr && p0 + col < a.p) {
          a.state_out[state_off + static_cast<long long>(k) * a.p + col] = s;
        }
      }
    }
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t s) {
  const int bytes = smem_bytes(a.n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * a.heads, (a.p + kPT - 1) / kPT);
  ssd_kernel<T><<<grid, kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (x, a, b, c and y alike). x and
// y: (batch, seq, heads, p); a: (batch, seq, heads); b and c: (batch, seq,
// groups, n); each given by its (batch, seq, head-or-group) strides in
// elements, in the order x, a, b, c, y, with the last dimension contiguous
// (a has none). state_in and state_out: float32 (batch, heads, n, p),
// contiguous, each may be null. seq >= 1; 1 <= n <= 128; heads % groups
// == 0.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int occam_ssd_scan_launch(
    int dtype, const void* x, const void* a, const void* b, const void* c,
    void* y, const float* state_in, float* state_out,
    const long long* strides, int batch, int seq, int heads, int groups,
    int p, int n, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || groups < 1 || heads % groups ||
      p < 1 || n < 1 || n > kMaxN ||
      static_cast<long long>(batch) * heads > 2147483647LL ||
      (p + kPT - 1) / kPT > 65535) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(args, batch, s);
    case 1: return launch<__nv_bfloat16>(args, batch, s);
    case 2: return launch<__half>(args, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
