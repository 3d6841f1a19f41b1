// Occam fused-span kernel for Hopper (sm_90a): one DP span (a, b) of a
// conv/pool NetSpec streamed row by row through closure-sized rings.
//
// Replaces the TPU kernel src/repro/kernels/fused_span/kernel.py
// (_span_kernel, generated per span and launched by _span_pallas through
// pl.pallas_call; row math in rowops.py). It computes what that kernel
// computes: per schedule step, the step's input block arrives into ring 0;
// the scheduled rows of maps a+1 .. b are produced in map order (conv rows
// as k*k*C_in fp32 dot products per output element, +bias, ReLU; pool rows
// as running maxima padded with -1e30); residual adds use the option-A
// projection from a ring or a device-memory source map; spilled interior
// maps and the output map are written row by row.
//
// What bounds it on this card. The span's arithmetic (1.79 GMAC per image
// for ResNet-18) runs on the fp32 CUDA cores, with one weight load and one
// activation load per multiply-add, so it is bound by load-issue rate and
// fp32 FMA throughput rather than by device-memory bytes: the only
// device-memory traffic the algorithm needs is the span's input, its
// output, its spills and its weights. The rings of a full-width span
// (several MB per image) do not fit the 227 KB of shared memory, so they
// live in a device-memory workspace of batch x closure elements that is
// meant to stay resident in the 50 MB L2. The TPU kept the filters
// VMEM-resident across the batch; here every CTA reads them through L2.
//
// What the design does about it. One generic compiled kernel serves every
// span: the per-span facts (map geometry, ring caps and offsets, residual
// table, spill list, the schedule's slot table and arrivals) come from a
// descriptor built once per schedule by kernel.py, so no per-span nvcc
// run is needed. One CTA runs one image; inside it the schedule's steps
// run in order (the TPU's sequential grid axis), with __syncthreads()
// between dependent rows. Threads cover out_w x C_out of a row, neighbours
// on neighbouring output channels, so weight reads coalesce and the
// activation read is a warp broadcast. Accumulation is fp32 for every
// activation type. With batch <= 8 most of the 132 SMs are idle; spreading
// a row over several CTAs, shared-memory rings and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxConv = 128;
constexpr int kMaxSrc = 8;
constexpr int kMaxSpill = 8;
constexpr float kNegInf = -1e30f;

// Descriptor layout (int32), written by kernel.py::_descriptor.
enum Header {
  H_NMAPS, H_INROWS, H_NSTEPS, H_TOTSLOTS, H_NRES,
  H_MAPS, H_RES, H_SLOTS, H_ARRIVALS, H_TABLE, H_LEN
};
// One record per map a .. b (record 0 is the span input).
enum MapField {
  M_KIND, M_K, M_STRIDE, M_PAD, M_H, M_W, M_C, M_CAP, M_RING,
  M_RES0, M_NRES, M_SPILL, M_CONV, M_LEN
};
// One record per residual edge ending in the span, in net order.
// R_SRC_KIND 0: the source is ring R_SRC; 1: it is srcs operand R_SRC.
enum ResField { R_SRC_KIND, R_SRC, R_H, R_W, R_C, R_LEN };

struct SpanPtrs {
  const void* x;
  void* out;
  void* ws;
  long long ws_per_image;
  const float* w[kMaxConv];
  const float* bias[kMaxConv];
  const void* src[kMaxSrc];
  void* spill[kMaxSpill];
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
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// Produce row r of map `off` (record mm) from its input map (record mp).
template <typename T>
__device__ __forceinline__ void produce_row(const int* __restrict__ maps,
                            const int* __restrict__ res, const int off,
                            const int n_maps, const int r, const int n,
                            T* ws, T* out, const SpanPtrs& p) {
  const int* mm = maps + off * M_LEN;
  const int* mp = maps + (off - 1) * M_LEN;
  const int kind = mm[M_KIND], k = mm[M_K];
  const int stride = mm[M_STRIDE], pad = mm[M_PAD];
  const int h_in = mp[M_H], w_in = mp[M_W], c_in = mp[M_C];
  const int cap_in = mp[M_CAP];
  const int h_out = mm[M_H], w_out = mm[M_W], c_out = mm[M_C];
  const int n_out = w_out * c_out;
  const T* ring_in = ws + mp[M_RING];
  const float* wt = kind == 0 ? p.w[mm[M_CONV]] : nullptr;
  const float* bias = kind == 0 ? p.bias[mm[M_CONV]] : nullptr;
  T* dst = off < n_maps - 1
               ? ws + mm[M_RING] + (long long)(r % mm[M_CAP]) * n_out
               : out + (long long)r * n_out;
  T* spill_dst = nullptr;
  if (mm[M_SPILL] >= 0) {
    spill_dst = static_cast<T*>(p.spill[mm[M_SPILL]]) +
                ((long long)n * h_out + r) * n_out;
  }
  for (int idx = threadIdx.x; idx < n_out; idx += blockDim.x) {
    const int xo = idx / c_out;
    const int co = idx - xo * c_out;
    float v;
    if (kind == 0) {
      float acc = 0.f;
      for (int dy = 0; dy < k; ++dy) {
        const int rr = r * stride - pad + dy;
        if (rr < 0 || rr >= h_in) continue;  // zero padding row
        const T* row = ring_in + (long long)(rr % cap_in) * w_in * c_in;
        const float* wrow = wt + (long long)dy * k * c_in * c_out + co;
        for (int dx = 0; dx < k; ++dx) {
          const int col = xo * stride - pad + dx;
          if (col < 0 || col >= w_in) continue;  // zero padding column
          const T* xin = row + (long long)col * c_in;
          const float* wk = wrow + (long long)dx * c_in * c_out;
          for (int ci = 0; ci < c_in; ++ci) {
            acc = fmaf(to_f(xin[ci]), __ldg(wk + (long long)ci * c_out), acc);
          }
        }
      }
      v = fmaxf(acc + __ldg(bias + co), 0.f);
    } else {
      float m = kNegInf;  // padding rows and columns read as -1e30
      for (int dy = 0; dy < k; ++dy) {
        const int rr = r * stride - pad + dy;
        if (rr < 0 || rr >= h_in) continue;
        const T* row = ring_in + (long long)(rr % cap_in) * w_in * c_in;
        for (int dx = 0; dx < k; ++dx) {
          const int col = xo * stride - pad + dx;
          if (col < 0 || col >= w_in) continue;
          m = fmaxf(m, to_f(row[(long long)col * c_in + co]));
        }
      }
      v = m;
    }
    // Residual adds in fp32 before the cast, option-A projection:
    // strided rows and columns, channel zero-pad or trim.
    for (int e = 0; e < mm[M_NRES]; ++e) {
      const int* rs = res + (mm[M_RES0] + e) * R_LEN;
      const int h_s = rs[R_H], w_s = rs[R_W], c_s = rs[R_C];
      const int sh = max(h_s / h_out, 1), sw = max(w_s / w_out, 1);
      const int src_abs = min(r * sh, h_s - 1);
      const int xs = xo * sw;
      if (co >= c_s || xs >= w_s) continue;
      const T* srow;
      if (rs[R_SRC_KIND] == 0) {
        const int* ms = maps + rs[R_SRC] * M_LEN;
        srow = ws + ms[M_RING] + (long long)(src_abs % ms[M_CAP]) * w_s * c_s;
      } else {
        srow = static_cast<const T*>(p.src[rs[R_SRC]]) +
               ((long long)n * h_s + src_abs) * w_s * c_s;
      }
      v += to_f(srow[(long long)xs * c_s + co]);
    }
    const T o = from_f<T>(v);
    dst[idx] = o;
    if (spill_dst != nullptr) spill_dst[idx] = o;
  }
}

// __grid_constant__: p stays in the parameter space when produce_row
// indexes its pointer tables, instead of being copied per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_span_kernel(const int* __restrict__ desc,
                      const __grid_constant__ SpanPtrs p) {
  const int n = blockIdx.x;  // one CTA per image
  const int n_maps = desc[H_NMAPS], in_rows = desc[H_INROWS];
  const int n_steps = desc[H_NSTEPS], total_slots = desc[H_TOTSLOTS];
  const int* maps = desc + desc[H_MAPS];
  const int* res = desc + desc[H_RES];
  const int* slots = desc + desc[H_SLOTS];
  const int* arrivals = desc + desc[H_ARRIVALS];
  const int* table = desc + desc[H_TABLE];
  const int* m0 = maps;
  const int* mb = maps + (n_maps - 1) * M_LEN;
  const int in_elems = m0[M_W] * m0[M_C];
  T* ws = static_cast<T*>(p.ws) + (long long)n * p.ws_per_image;
  const T* x = static_cast<const T*>(p.x) + (long long)n * m0[M_H] * in_elems;
  T* out = static_cast<T*>(p.out) +
           (long long)n * mb[M_H] * mb[M_W] * mb[M_C];
  T* ring0 = ws + m0[M_RING];

  for (int t = 0; t < n_steps; ++t) {
    const int blk = arrivals[t];
    if (blk >= 0) {  // the step's input block joins ring 0
      for (int ii = 0; ii < in_rows; ++ii) {
        const int g = blk * in_rows + ii;
        if (g >= m0[M_H]) break;
        T* dst = ring0 + (long long)(g % m0[M_CAP]) * in_elems;
        const T* src = x + (long long)g * in_elems;
        for (int e = threadIdx.x; e < in_elems; e += blockDim.x) {
          dst[e] = src[e];
        }
      }
      __syncthreads();
    }
    int slot = 0;
    for (int off = 1; off < n_maps; ++off) {
      for (int u = 0; u < slots[off - 1]; ++u, ++slot) {
        const int r = table[(long long)t * total_slots + slot];
        if (r < 0) continue;  // uniform across the CTA
        produce_row<T>(maps, res, off, n_maps, r, n, ws, out, p);
        __syncthreads();
      }
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (activations; weights and biases
// are float32). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int occam_fused_span_launch(
    int dtype, const void* desc, const void* x, void* out, void* ws,
    long long ws_per_image, const void* const* w, const void* const* bias,
    int n_conv, const void* const* src, int n_src, void* const* spill,
    int n_spill, int batch, void* stream) {
  if (n_conv > kMaxConv || n_src > kMaxSrc || n_spill > kMaxSpill ||
      batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SpanPtrs p = {};
  p.x = x;
  p.out = out;
  p.ws = ws;
  p.ws_per_image = ws_per_image;
  for (int i = 0; i < n_conv; ++i) {
    p.w[i] = static_cast<const float*>(w[i]);
    p.bias[i] = static_cast<const float*>(bias[i]);
  }
  for (int i = 0; i < n_src; ++i) p.src[i] = src[i];
  for (int i = 0; i < n_spill; ++i) p.spill[i] = spill[i];
  const int* d = static_cast<const int*>(desc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      fused_span_kernel<float><<<batch, kThreads, 0, s>>>(d, p);
      break;
    case 1:
      fused_span_kernel<__nv_bfloat16><<<batch, kThreads, 0, s>>>(d, p);
      break;
    case 2:
      fused_span_kernel<__half><<<batch, kThreads, 0, s>>>(d, p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
