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
// 2*d multiply-adds (Q K^T and P V): Llama-3.2-1B's 1024-token prefill at
// batch 4 is 17.2 GFLOP per layer against 84 MB of q, k, v and o, so the
// kernel is bound by operations. On the CUDA cores (67 TFLOP/s fp32) that
// is 0.257 ms. The tensor cores take TF32 at 495 TFLOP/s, but one TF32
// pass keeps 11 significant bits, which breaks the fp32 band (2e-5) that
// Llama-3.2-1B serves under; three passes (below) make the bound
// 3 x 17.2 GFLOP / 495 TFLOP/s = 0.104 ms. What holds the kernel short of
// that is mma.sync's own TF32 rate, below wgmma's: halving the shared
// loads and splits per query row (two 16-row tiles a warp) barely moved
// its time.
//
// What the design does about it.
// - Tensor cores, fp32-accurate (3xTF32). Both products run as
//   mma.sync.m16n8k8 TF32 with fp32 sums. An fp32 operand x is split into
//   big = x rounded to TF32 and small = x - big, of which the tensor core
//   reads the top 19 bits; a b ~ big_a big_b + big_a small_b + small_a
//   big_b, the dropped terms below 2^-21 |a b|. The rounding is two
//   integer operations (cvt.rna.tf32.f32 adds checks for NaN). bf16 and
//   fp16 take one TF32 pass: their K and V are exact in TF32, and
//   rounding the pre-scaled q and the probabilities P to TF32 (2^-11
//   relative) stays far inside their 5e-2 band.
// - Each of the 4 warps of a CTA owns 16 query rows (64 a CTA). The q
//   block, pre-scaled by log2(e) / sqrt(d), stays in shared memory and is
//   split as its A-fragments are read: held in registers, its 64 split
//   fragments (d = 64) cost more occupancy than the splits cost time. The
//   score tile lives in the accumulator fragments: a row of an m16n8
//   fragment lies in one quad of 4 lanes, so its max takes two shuffles,
//   and each lane keeps a partial row sum that the quad adds once, at the
//   end. The softmax runs in base 2 on the special-function unit
//   (ex2.approx). P goes back into the tensor cores without leaving
//   registers: a lane holds kv columns 2t and 2t + 1 of its rows, which
//   are the A-fragment's k = t and k = t + 4 once P V's sum over kv runs in
//   the order 0, 2, 4, 6, 1, 3, 5, 7 of each group of 8; V's B-fragment is
//   read in the same order.
// - A two-stage ring of 32-row K and V tiles in shared memory, filled by
//   cp.async straight from device memory (16-byte copies; a 4-byte path
//   where k or v rows are not 16-byte aligned, chosen by the launcher from
//   the pointers and strides). Rows at or past seq_k_valid are zero-filled
//   by the copy's source size. Tile j + 1 loads while tile j is
//   multiplied, with one barrier a tile. Tile rows are padded by 16 bytes,
//   so every fragment load of a warp hits 32 distinct banks. Each thread
//   steps one source pointer down its rows: addresses computed per copy
//   and kept across the tile loop spilled registers.
// - 52,224 bytes of shared memory and at most 128 registers a thread at
//   d <= 64 (__launch_bounds__(128, 4)): four CTAs, 16 warps, on an SM, so
//   one warp's softmax runs under another's products. 32-row tiles also
//   let the warps whose rows end before a diagonal tile's second half skip
//   it. CTAs of the last (most expensive, under the causal mask) query
//   blocks are scheduled first.
// Later work: wgmma (V transposed in shared memory: TF32 wgmma takes only
// K-major operands), TMA with mbarriers and a producer warp, and one CTA
// for the query heads of a GQA group, so a K/V tile is staged once for
// all of them.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kBQ = 16 * kWarps;       // query rows per CTA, 16 per warp
constexpr int kBK = 32;                // kv rows per tile
constexpr int kStages = 2;             // K/V tiles in flight
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
  int vec;            // 1: k and v rows 16-byte aligned (16-byte copies)
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

template <typename T>
__host__ __device__ constexpr int passes() {
  // tensor-core products per operand pair
  return std::is_same<T, float>::value ? 3 : 1;
}

template <typename T, int D>
__host__ __device__ constexpr int tile_ld() {
  // padded row of a K/V tile, in elements
  return D + 16 / static_cast<int>(sizeof(T));
}

template <int D>
__host__ __device__ constexpr int q_bytes() {
  // the q block, fp32, rows padded to D + 4
  return kBQ * (D + 4) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__host__ __device__ constexpr int smem_bytes() {
  // q block, then kStages x (K tile, V tile)
  return q_bytes<D>() +
         kStages * 2 * kBK * tile_ld<T, D>() * static_cast<int>(sizeof(T));
}

// x rounded to TF32 (to nearest, ties away from zero), as the bits of an
// fp32: what cvt.rna.tf32.f32 gives for a finite x, in two integer
// operations where cvt also checks for NaN and infinity.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An fp32 value as tensor-core operands: big, and with three passes the
// rest, small = x - big (the tensor core reads its top 19 bits).
template <int kPasses>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  if constexpr (kPasses == 3) {
    small = __float_as_uint(x - __uint_as_float(big));
  }
}

// A K or V element as a B operand: fp32 is split; bf16 and fp16 values
// are exact in TF32 and go in as they are.
template <typename T>
__device__ __forceinline__ void operand(T x, uint32_t& big,
                                        uint32_t& small) {
  if constexpr (std::is_same<T, float>::value) {
    split<3>(x, big, small);
  } else {
    big = __float_as_uint(to_f(x));
  }
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32
// operands, fp32 sums. Fragments, with g = lane / 4 and t = lane % 4:
// a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g];
// c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b to fp32 accuracy: the small terms first, then big x big.
template <int kPasses>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  if constexpr (kPasses == 3) {
    mma(c, as, bb);
    mma(c, ab, bs);
  }
  mma(c, ab, bb);
}

// `bytes` (16 or 4) from global to shared memory without passing through
// registers; valid == false writes zeros and reads nothing.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until none of this thread's committed copies is in flight.
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows k0 .. k0 + kBK of one head's (seq, D) operand into dst, rows
// padded to tile_ld, in copies of kBytes; rows at or past seq are zeros.
// Each thread keeps one source pointer and steps it down the rows, so no
// per-copy address is held across the tile loop.
template <typename T, int D, int kBytes>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long stride, int k0, int seq,
                                           int tid) {
  constexpr int kLd = tile_ld<T, D>();
  constexpr int kPer = kBytes / static_cast<int>(sizeof(T));
  constexpr int kRow = D / kPer;          // copies per row
  constexpr int kStep = kThreads / kRow;  // rows one pass of the CTA copies
  static_assert(kThreads % kRow == 0, "whole rows a pass");
  const int r = tid / kRow, c = tid % kRow * kPer;
  T* d = dst + r * kLd + c;
  const T* from = src + (k0 + r) * stride + c;
#pragma unroll
  for (int i = 0; i < (kBK + kStep - 1) / kStep; ++i) {
    if (kBK % kStep != 0 && r + i * kStep >= kBK) break;
    const bool valid = k0 + r + i * kStep < seq;
    copy_async<kBytes>(d + i * kStep * kLd, valid ? from : src, valid);
    from += kStep * stride;
  }
}

// The K and V tiles of kv rows k0 .. k0 + kBK into one stage of the ring.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* sK, const T* k, const T* v,
                                           const Args& a, int k0, int tid) {
  constexpr int kTile = kBK * tile_ld<T, D>();
  if (a.vec) {
    stage_rows<T, D, 16>(sK, k, a.sk.s, k0, a.seq_k, tid);
    stage_rows<T, D, 16>(sK + kTile, v, a.sv.s, k0, a.seq_k, tid);
  } else {
    stage_rows<T, D, 4>(sK, k, a.sk.s, k0, a.seq_k, tid);
    stage_rows<T, D, 4>(sK + kTile, v, a.sv.s, k0, a.seq_k, tid);
  }
}

// CTAs an SM should hold at once: 4 at d <= 64 (at most 128 registers a
// thread), 2 at d = 128, whose accumulator alone takes 64
template <int D>
__host__ __device__ constexpr int min_ctas() {
  return D <= 64 ? 4 : 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_ctas<D>())
    flash_kernel(const __grid_constant__ Args a) {
  static_assert(D % 16 == 0 && D <= 128, "head dim 16, 32, 64 or 128");
  constexpr int kPasses = passes<T>();
  constexpr int kLd = tile_ld<T, D>();
  constexpr int kQd = D + 4;         // padded row of the q block
  constexpr int kTile = kBK * kLd;   // elements of one K or V tile
  constexpr int kKS = D / 8;         // k-steps of Q K^T, n-tiles of P V
  constexpr int kNT = kBK / 8;       // n-tiles of Q K^T, k-steps of P V

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);              // kBQ x kQd
  T* sKV = reinterpret_cast<T*>(smem + q_bytes<D>());      // the ring

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // fragment row (and B column)
  const int t = tid & 3;          // fragment column pair
  const int n = blockIdx.x;       // flattened (b, h)
  const int b = n / a.hq;
  const int h = n % a.hq;
  const int kvh = h / (a.hq / a.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  T* o = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;

  // kv rows any valid query row of this block may see; tiles at or past
  // k_end lie strictly above the causal diagonal (or past seq_k) and are
  // skipped
  int k_end = a.seq_k;
  if (a.causal) {
    const int last_q = min(q0 + kBQ, a.seq_q) - 1;
    k_end = min(k_end, last_q + a.causal_offset + 1);
  }
  const int n_tiles = k_end > 0 ? (k_end + kBK - 1) / kBK : 0;
  if (n_tiles > 0) stage_tile<T, D>(sKV, k, v, a, 0, tid);
  copy_commit();

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    sQ[r * kQd + c] =
        qi < a.seq_q ? to_f(q[qi * a.sq.s + c]) * (a.scale * kLog2e) : 0.f;
  }
  __syncthreads();

  // this warp's rows; the kv rows any of them may see (0: none is valid)
  const int w0 = q0 + 16 * warp;
  const int rows[2] = {w0 + g, w0 + g + 8};
  int warp_end = w0 < a.seq_q ? a.seq_k : 0;
  if (a.causal && w0 < a.seq_q) {
    warp_end = min(warp_end, min(w0 + 15, a.seq_q - 1) + a.causal_offset + 1);
  }
  int lim[2];  // last kv row each of this lane's two rows sees
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lim[i] = a.causal ? min(rows[i] + a.causal_offset, a.seq_k - 1)
                      : a.seq_k - 1;
  }

  // this warp's rows of q: A-fragment element e of k-step kk is
  // q[16 warp + g + 8 (e & 1)][8 kk + t + 4 (e >> 1)]
  const float* qw = sQ + (16 * warp + g) * kQd + t;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's part of each row's sum
  float acc[kKS][4];
#pragma unroll
  for (int j = 0; j < kKS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    copy_wait_all();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    if (it + 1 < n_tiles) {
      stage_tile<T, D>(sKV + ((it + 1) % kStages) * 2 * kTile, k, v, a,
                       k0 + kBK, tid);
    }
    copy_commit();
    if (k0 >= warp_end) continue;  // the whole tile is masked for this warp
    const T* sK = sKV + (it % kStages) * 2 * kTile;
    const T* sV = sK + kTile;

    // S = q K^T: a 16 x kBK tile a warp, as kNT fragments of 16 x 8
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split<kPasses>(qw[(e & 1) * 8 * kQd + 8 * kk + (e >> 1) * 4], ab[e],
                       as[e]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const T* kp = sK + (8 * j + g) * kLd + 8 * kk + t;  // K[8j+g][8kk+t]
        uint32_t bb[2], bs[2];
        operand(kp[0], bb[0], bs[0]);
        operand(kp[4], bb[1], bs[1]);
        mma3<kPasses>(s[j], ab, as, bb, bs);
      }
    }

    // mask: kv rows past seq_k, and past each row's causal limit. Tile 0
    // holds kv row 0, which every valid row sees, so from there on each
    // valid row's running max m is a real score, and a masked score's
    // 2^(s - m) is exactly 0
    if (k0 + kBK > a.seq_k ||
        (a.causal && k0 + kBK - 1 > w0 + a.causal_offset)) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + 8 * j + 2 * t + (e & 1) > lim[e >> 1]) s[j][e] = kNegInf;
        }
    }

    // online softmax on the fragments, in base 2 (q carries log2(e)): row
    // g in e = 0, 1; row g + 8 in e = 2, 3; a row's kBK scores lie in the
    // 4 lanes of one quad
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = exp2_approx(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int j = 0; j < kKS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // acc += P V. k-step j sums kv rows 8j .. 8j + 7 in the order 0, 2,
    // 4, 6, 1, 3, 5, 7: the A-fragment's k = t is kv 8j + 2t (s[j][0],
    // s[j][2]) and k = t + 4 is kv 8j + 2t + 1 (s[j][1], s[j][3]), so
    // the B-fragment reads V rows 8j + 2t and 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t pb[4], ps[4];
      split<kPasses>(s[j][0], pb[0], ps[0]);
      split<kPasses>(s[j][2], pb[1], ps[1]);
      split<kPasses>(s[j][1], pb[2], ps[2]);
      split<kPasses>(s[j][3], pb[3], ps[3]);
      const T* vp = sV + (8 * j + 2 * t) * kLd + g;
#pragma unroll
      for (int nd = 0; nd < kKS; ++nd) {
        uint32_t bb[2], bs[2];
        operand(vp[8 * nd], bb[0], bs[0]);
        operand(vp[kLd + 8 * nd], bb[1], bs[1]);
        mma3<kPasses>(acc[nd], pb, ps, bb, bs);
      }
    }
  }
  copy_wait_all();  // no copy is left in flight at exit

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = rows[i];
    if (qi >= a.seq_q) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];  // fully masked row -> 0
    T* orow = o + qi * a.so.s + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kKS; ++nd) {
      orow[8 * nd] = from_f<T>(acc[nd][2 * i] / li);
      orow[8 * nd + 1] = from_f<T>(acc[nd][2 * i + 1] / li);
    }
  }
}

template <typename T, int D>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T, D>()));
}

template <typename T, int D>
int launch(const Args& a, int bh, cudaStream_t s) {
  const int err = set_smem<T, D>();
  if (err != 0) return err;
  const dim3 grid(bh, (a.seq_q + kBQ - 1) / kBQ);
  flash_kernel<T, D><<<grid, kThreads, smem_bytes<T, D>(), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int occupancy(int* smem, int* ctas_per_sm) {
  *smem = smem_bytes<T, D>();
  const int err = set_smem<T, D>();
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, flash_kernel<T, D>, kThreads, *smem));
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

template <typename T>
int occupancy_d(int d, int* smem, int* ctas_per_sm) {
  switch (d) {
    case 16: return occupancy<T, 16>(smem, ctas_per_sm);
    case 32: return occupancy<T, 32>(smem, ctas_per_sm);
    case 64: return occupancy<T, 64>(smem, ctas_per_sm);
    case 128: return occupancy<T, 128>(smem, ctas_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Whether every row a launch reads of a (batch, head, row) operand starts
// on a multiple of `bytes`: the pointer, and each stride whose dimension
// has more than one entry.
bool rows_aligned(const void* p, const long long* st, int batch, int heads,
                  int seq, int esize, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0 &&
         (batch < 2 || st[0] * esize % bytes == 0) &&
         (heads < 2 || st[1] * esize % bytes == 0) &&
         (seq < 2 || st[2] * esize % bytes == 0);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and o alike); d: 16,
// 32, 64 or 128. q: (batch, hq, seq_q, d), k and v: (batch, hkv, *, d),
// o: (batch, hq, seq_q, d), each given by its (batch, head, row) strides
// in elements with the head dimension contiguous. k and v rows are copied
// by 16-byte cp.async where every row starts 16-byte aligned, else by
// 4-byte copies, which need rows 4-byte aligned (cudaErrorMisalignedAddress
// otherwise: a bf16 or fp16 row that starts on an odd element). Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() of the
// launch.
extern "C" int occam_flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o,
    const long long* strides, int batch, int hq, int hkv, int seq_q,
    int seq_k_valid, int d, int causal, int causal_offset, float scale,
    void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || seq_q < 1 ||
      seq_k_valid < 0 || causal_offset < 0 || dtype < 0 || dtype > 2 ||
      static_cast<long long>(batch) * hq > 2147483647LL ||
      (seq_q + kBQ - 1) / kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int esize = dtype == 0 ? 4 : 2;
  if (!rows_aligned(k, strides + 3, batch, hkv, seq_k_valid, esize, 4) ||
      !rows_aligned(v, strides + 6, batch, hkv, seq_k_valid, esize, 4)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
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
  a.vec = rows_aligned(k, strides + 3, batch, hkv, seq_k_valid, esize, 16) &&
          rows_aligned(v, strides + 6, batch, hkv, seq_k_valid, esize, 16);
  const int bh = batch * hq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(a, d, bh, s);
    case 1: return launch_d<__nv_bfloat16>(a, d, bh, s);
    default: return launch_d<__half>(a, d, bh, s);
  }
}

// The kernel's dynamic shared memory at head dim d, and how many of its
// CTAs (128 threads) one SM holds at once, into *ctas_per_sm; returns the
// CUDA error of the query.
extern "C" int occam_flash_attention_occupancy(int dtype, int d, int* smem,
                                               int* ctas_per_sm) {
  switch (dtype) {
    case 0: return occupancy_d<float>(d, smem, ctas_per_sm);
    case 1: return occupancy_d<__nv_bfloat16>(d, smem, ctas_per_sm);
    case 2: return occupancy_d<__half>(d, smem, ctas_per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
