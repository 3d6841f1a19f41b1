// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T / sqrt(d)) V
// with an online (running max, running sum) softmax, GQA and a
// bottom-aligned causal mask.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_call through pl.pallas_call;
// GQA gather and padding in ops.py). It computes what that kernel
// computes: scores in fp32 from q pre-scaled by 1/sqrt(d); kv rows at or
// past seq_k_valid masked; under `causal`, query row r sees kv rows
// <= r + causal_offset, where the caller passes
// causal_offset = max(seq_k_valid - seq_q_valid, 0); masked scores are
// -1e30; running max m, running sum l and the output accumulator in fp32;
// kv tiles strictly above the causal diagonal are skipped; a row with
// l == 0 gives 0. Unlike the TPU kernel it needs no padding and no
// gathered copy of K/V: the ragged tails are masked here, and the kv head
// of query head h is h / (Hq / Hkv), read in place through the strides.
//
// What bounds it on this card. Per (query, key) pair in range the work is
// 2*d multiply-adds (Q K^T and P V), so at prefill lengths the kernel is
// bound by operations: Llama-3.2-1B's 1024-token prefill at batch 4 is
// 17.2 GFLOP per layer against 2 MB of q, k, v and o per head group. This
// first version runs them as fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores.
//
// What the design does about it. One CTA of 128 threads owns 64 query
// rows of one (batch, query head); the q block, pre-scaled, stays in
// shared memory while 64-row K and V tiles stream through it once. Each
// thread holds a 4 x 8 block of the score tile and a 4 x (d/8) block of
// the output accumulator in registers, so a shared-memory load feeds 2.7
// (Q K^T) to 2.9 (P V, d = 64) FMAs; the 8 threads that share a query row
// are neighbouring lanes and reduce its max and sum with shuffles. Rows
// of shared memory are padded so that every warp's loads hit distinct
// banks. CTAs of the last (most expensive, under the causal mask) query
// blocks are scheduled first. wgmma, TMA, bf16 tensor cores and a
// producer/consumer pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                // query rows per CTA
constexpr int kBK = 64;                // kv rows per tile
constexpr int kTX = 8;                 // threads across a tile's kv columns
constexpr int kTY = 16;                // threads across its query rows
constexpr int kThreads = kTX * kTY;    // 128
constexpr int kRows = kBQ / kTY;       // query rows per thread
constexpr int kCols = kBK / kTX;       // kv columns per thread
constexpr int kPS = kBK + 2;           // padded row of the P tile
constexpr float kNegInf = -1e30f;

struct Strides {  // in elements; the head dimension is contiguous
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int hq, hkv;
  int seq_q;          // query rows of the tensor
  int seq_k;          // kv rows that may be attended (seq_k_valid)
  int causal;
  int causal_offset;  // max(seq_k_valid - seq_q_valid, 0)
  float scale;        // 1 / sqrt(d)
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

template <int D>
constexpr int smem_bytes() {
  // q block and K tile padded to D + 1, V tile, P tile
  return (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kPS) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const __grid_constant__ Args a) {
  static_assert(D % kTX == 0, "head dim must be a multiple of 8");
  constexpr int kDP = D + 1;     // padded q/K row: conflict-free columns
  constexpr int kDC = D / kTX;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // kBQ x kDP, pre-scaled
  float* sK = sQ + kBQ * kDP;    // kBK x kDP
  float* sV = sK + kBK * kDP;    // kBK x D
  float* sP = sV + kBK * D;      // kBQ x kPS

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int n = blockIdx.x;                      // flattened (b, h)
  const int b = n / a.hq;
  const int h = n % a.hq;
  const int kvh = h / (a.hq / a.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  T* o = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    sQ[r * kDP + c] = qi < a.seq_q ? to_f(q[qi * a.sq.s + c]) * a.scale
                                   : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // kv rows any valid query row of this block may see; tiles at or past
  // k_end lie strictly above the causal diagonal (or past seq_k) and are
  // skipped
  int k_end = a.seq_k;
  if (a.causal) {
    const int last_q = min(q0 + kBQ, a.seq_q) - 1;
    k_end = min(k_end, last_q + a.causal_offset + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      const bool in = kj < k_end;
      sK[r * kDP + c] = in ? to_f(k[kj * a.sk.s + c]) : 0.f;
      sV[r * D + c] = in ? to_f(v[kj * a.sv.s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qr[kRows], kc[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qr[i] = sQ[(ty * kRows + i) * kDP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kc[j] = sK[(tx + kTX * j) * kDP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      const int limit = a.causal ? qi + a.causal_offset : a.seq_k - 1;
      unsigned ok = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kTX * j;
        if (kj < a.seq_k && kj <= limit) {
          ok |= 1u << j;
        } else {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * kRows + i) * kPS + tx + kTX * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the whole P tile is written

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[kRows], vc[kDC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = sP[(ty * kRows + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kDC; ++c) vc[c] = sV[kk * D + tx + kTX * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(pr[i], vc[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi >= a.seq_q) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully masked row -> 0
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      o[qi * a.so.s + tx + kTX * c] = from_f<T>(acc[i][c] / li);
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int bh, cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (a.seq_q + kBQ - 1) / kBQ);
  flash_kernel<T, D><<<grid, kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& a, int d, int bh, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(a, bh, s);
    case 32: return launch<T, 32>(a, bh, s);
    case 64: return launch<T, 64>(a, bh, s);
    case 128: return launch<T, 128>(a, bh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and o alike); d: 16,
// 32, 64 or 128. q: (batch, hq, seq_q, d), k and v: (batch, hkv, *, d),
// o: (batch, hq, seq_q, d), each given by its (batch, head, row) strides
// in elements with the head dimension contiguous. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() of the launch.
extern "C" int occam_flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    const long long* strides, int batch, int hq, int hkv, int seq_q,
    int seq_k_valid, int d, int causal, int causal_offset, float scale,
    void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || seq_q < 1 ||
      seq_k_valid < 0 || causal_offset < 0 ||
      static_cast<long long>(batch) * hq > 2147483647LL ||
      (seq_q + kBQ - 1) / kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.so = {strides[9], strides[10], strides[11]};
  a.hq = hq;
  a.hkv = hkv;
  a.seq_q = seq_q;
  a.seq_k = seq_k_valid;
  a.causal = causal;
  a.causal_offset = causal_offset;
  a.scale = scale;
  const int bh = batch * hq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(a, d, bh, s);
    case 1: return launch_d<__nv_bfloat16>(a, d, bh, s);
    case 2: return launch_d<__half>(a, d, bh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
