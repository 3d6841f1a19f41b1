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
// What bounds it on this card. The schedule is a chain of dependent rows
// (532 per image for ResNet-18's span (0, 12)), each too small to fill an
// SM, and batches are small (1-8 images). The arithmetic (1.11 GMAC per
// image for ResNet-18's five spans) runs on the fp32 CUDA cores; the
// device-memory traffic the algorithm needs is only the span's input,
// output, spills and weights. The rings of a full-width span (several MB
// per image) do not fit the 227 KB of shared memory, so they live in a
// device-memory workspace of batch x closure elements that stays in the
// 50 MB L2. So the time goes to latency: cluster barriers, the L2 round
// trip for rows just written, weights streamed from L2 at about 27 B/clk
// per SM, then the FMAs. One CTA per image, scalar FMAs with two loads
// each, would leave 124 of 132 SMs idle at batch 8.
//
// What the design does about it.
// - A thread-block cluster of 16 CTAs (8 where the device cannot place 16)
//   works on one image; all CTAs walk the schedule's steps in order. Each
//   CTA owns a fixed tile (columns x channels) of every map's W_out x
//   C_out row, chosen per map by kernel.py and read from the descriptor;
//   the tiles of a row cover it once. The input-block copy into ring 0,
//   pool rows, residual adds and spills are split over the same tiles.
//   Ring and source reads bypass L1 (ld.global.cg, cp.async.cg): L1 is
//   not coherent across the SMs. At most 128 registers and half an SM's
//   shared memory per CTA let two CTAs share an SM, so 14 clusters of 16
//   are resident and a batch of 8 runs in one wave.
// - One cluster barrier (arrive.release / wait.acquire) ends every
//   arrival and every (step, map) group: the step's rows of one map (2-36
//   of them in ResNet-18's and AlexNet's first spans), produced back to
//   back. That is enough. A group's rows read only earlier maps (the
//   map before and residual sources), written behind an earlier barrier,
//   and nothing in the group reads the map it writes. Every ring slot a
//   group rewrites was last read by the map's readers (the next map and
//   its residual consumers) in earlier steps, behind an earlier barrier,
//   as the schedule's rings retain every row still to be read. ResNet-18
//   takes 229 barriers an image instead of one a row and arrival (630).
// - A conv row is an implicit GEMM, A[W tile, K = k*k*C_in] times B[K,
//   C_out tile] (the HWIO weights are B in K-major order), in K-chunks
//   staged in shared memory two to four chunks deep; the chunks of a
//   group's rows are one stream, so the next row's first chunks load while
//   a row's last is multiplied and its tile finished. A is staged by
//   cp.async as the CTA's input window (k rows x the tile's columns x a
//   chunk of input channels, each value once, a tap table giving each K
//   index's offset) where C_in is a multiple of 4, else as im2col rows
//   through registers (converted to fp32, padding taps zeroed). Each
//   thread keeps a 4-column x 4-channel fp32 tile in registers, so four
//   16-byte loads of A and four of B feed 64 FMAs; when the CTA's tile
//   has fewer than 16 x 256 outputs the threads split K into groups and
//   add the groups' tiles through shared memory at the row's end. Bias,
//   ReLU, residual adds (fp32, before the cast) and the stores run in
//   that epilogue.
// - B, most of a chunk's bytes past the stems, arrives by the Tensor
//   Memory Accelerator: one thread issues one tensor copy a chunk (a box
//   of tc outputs x bk rows, x k*k taps in window mode, of the weights
//   seen as a (k*k, C_in, C_out) or (K, C_out) tensor; a box edge is at
//   most 256, so a 512-deep chunk takes two copies, or two a tap), which
//   lands exactly as B[kk][tc] and completes on the stage's mbarrier. The
//   copy engine forms the addresses and zero-fills K past C_in (or K) and
//   channels past C_out, so no thread spends instructions or load slots
//   on B. Every conv's B goes this way: kernel.py pads the weights of a
//   conv whose C_out is not a multiple of 4 to rows of a multiple of 16
//   bytes (a row stride TMA takes), and keeps every tile within one box
//   edge (256 channels). The tensor maps are encoded on the host
//   (kernel.py caches them by the weights' addresses) and travel as
//   __grid_constant__ kernel parameters. A stage's mbarrier sits in static
//   shared memory, initialised once a CTA, and everything else the copy
//   needs is formed where it is issued: at 128 registers, values kept
//   live across the chunk loop spill (barriers placed after each map's
//   stages and set up per group lost the gain at one image).
// - A CTA reads only its own C_out slice of each layer's weights, through
//   shared memory in K-chunks; every row of every image reads it again
//   from L2. The TPU kept the filters VMEM-resident across the batch.
//   Weights resident across images, tensor cores (wgmma), A's window by
//   TMA (it needs a swizzled layout in place of its padded rows), its
//   multicast to the CTAs that share its columns, and rings in shared or
//   distributed shared memory are later work.
#include <cuda.h>  // CUtensorMap and the encoder's types; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 128;  // largest k * k of a window-staged conv
constexpr int kMaxConv = 128;
constexpr int kMaxSrc = 8;
constexpr int kMaxSpill = 8;
constexpr float kNegInf = -1e30f;
constexpr int kMaxStages = 4;  // K-chunks held in shared memory at once
constexpr int kBoxMax = 256;  // longest edge of a TMA box
constexpr int kAlign = 32;    // floats: TMA lands B 128-byte aligned

// Descriptor layout (int32), written by kernel.py::_descriptor.
// Dynamic shared memory holds, in order: a copy of the descriptor up to
// its slot table (ints), the current step's row of the slot table at int
// offset H_ROW, a conv tile's biases at float offset H_BIAS, and from
// float offset H_STAGE (128-byte aligned) the K-chunks of conv_group.
enum Header {
  H_NMAPS, H_INROWS, H_NSTEPS, H_TOTSLOTS, H_NRES, H_CLUSTER,
  H_ROW, H_BIAS, H_STAGE, H_MAPS, H_RES, H_SLOTS, H_ARRIVALS, H_TABLE, H_LEN
};
// One record per map a .. b (record 0 is the span input). M_TW x M_TC is a
// CTA's tile of the row (columns x channels), M_NCT the channel tiles per
// row; for a conv row, M_MODE how A is staged (0 im2col, 1 window), M_BK
// the K indices (im2col) or input channels (window) of a chunk, a power of
// two >= 4, M_KS the K-split groups and M_STAGES the chunks held in shared
// memory (2-4); M_CONV indexes the conv's SpanPtrs::b_map and bias.
enum MapField {
  M_KIND, M_K, M_STRIDE, M_PAD, M_H, M_W, M_C, M_CAP, M_RING,
  M_RES0, M_NRES, M_SPILL, M_CONV, M_TW, M_TC, M_NCT, M_BK, M_KS,
  M_STAGES, M_MODE, M_LEN
};
// One record per residual edge ending in the span, in net order.
// R_SRC_KIND 0: the source is ring R_SRC; 1: it is srcs operand R_SRC.
enum ResField { R_SRC_KIND, R_SRC, R_H, R_W, R_C, R_LEN };

struct SpanPtrs {
  CUtensorMap b_map[kMaxConv];  // conv i's weights
  unsigned long long* tma_tally;  // bytes staged by TMA, summed over CTAs
  const void* x;
  void* out;
  void* ws;
  long long ws_per_image;
  const float* bias[kMaxConv];
  const void* src[kMaxSrc];
  void* spill[kMaxSpill];
};

// Loads of rings and sources, through L2 only (written by other CTAs).
__device__ __forceinline__ float ld_act(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_act(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float ld_act(const __half* p) {
  return __half2float(
      __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

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

// cp.async of 16 or 4 bytes; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers in shared memory (shared-window addresses), one arrival a phase
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
// the one arrival of the phase, which then also waits for `bytes`
__device__ __forceinline__ void mbar_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// orders the generic-proxy shared-memory writes before it (this thread's,
// and other threads' behind a barrier) before this thread's later TMA
// (async-proxy) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// TMA tile copies of a box at coordinates (x, y[, z]) (innermost first) of
// `map` into shared memory at dst; completes on mbarrier bar
__device__ __forceinline__ void tma_load2(float* dst, const CUtensorMap* map,
                                          unsigned bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(static_cast<unsigned>(
          __cvta_generic_to_shared(dst))),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(x),
      "r"(y)
      : "memory");
}
__device__ __forceinline__ void tma_load3(float* dst, const CUtensorMap* map,
                                          unsigned bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(static_cast<unsigned>(
          __cvta_generic_to_shared(dst))),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(x),
      "r"(y), "r"(z)
      : "memory");
}

// Every thread of every CTA of the cluster; writes before it are visible
// to loads after it anywhere in the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_reg(int which) {
  unsigned v;
  if (which == 0) {
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  } else {
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(v));
  }
  return v;
}

// Finish this CTA's tile of row r of map `off` (record mm) from its input
// map (record mp): for a conv, the sums of its `groups` K-split groups, left
// in shared memory at red[(g * twp + m) * tc + n]; for a pool, the window
// maxima. Bias and ReLU, residual adds, the ring (or output) store and the
// spill.
template <typename T, bool kConv>
__device__ __forceinline__ void finish_row(
    const int* __restrict__ maps, const int* __restrict__ res, const int off,
    const int n_maps, const int r, const int n, const int x0, const int nx,
    const int c0, const int nc, T* ws, T* out, const SpanPtrs& p,
    const float* sbias, const float* red, const int groups) {
  const int* mm = maps + off * M_LEN;
  const int* mp = maps + (off - 1) * M_LEN;
  const int k = mm[M_K], stride = mm[M_STRIDE], pad = mm[M_PAD];
  const int h_in = mp[M_H], w_in = mp[M_W], c_in = mp[M_C];
  const int cap_in = mp[M_CAP];
  const int h_out = mm[M_H], w_out = mm[M_W], c_out = mm[M_C];
  const int n_out = w_out * c_out;
  const int tc = mm[M_TC];
  const T* ring_in = ws + mp[M_RING];
  T* dst = off < n_maps - 1
               ? ws + mm[M_RING] + (long long)(r % mm[M_CAP]) * n_out
               : out + (long long)r * n_out;
  T* spill_dst = nullptr;
  if (mm[M_SPILL] >= 0) {
    spill_dst = static_cast<T*>(p.spill[mm[M_SPILL]]) +
                ((long long)n * h_out + r) * n_out;
  }
  // Residual edge e's value at (xo, co), option-A projection: strided rows
  // and columns, channel zero-pad or trim. False where it adds nothing.
  auto residual = [&](int e, int xo, int co, float* val) {
    const int* rs = res + (mm[M_RES0] + e) * R_LEN;
    const int h_s = rs[R_H], w_s = rs[R_W], c_s = rs[R_C];
    const int sh = max(h_s / h_out, 1), sw = max(w_s / w_out, 1);
    const int src_abs = min(r * sh, h_s - 1);
    const int xs = xo * sw;
    if (co >= c_s || xs >= w_s) return false;
    const T* srow;
    if (rs[R_SRC_KIND] == 0) {
      const int* ms = maps + rs[R_SRC] * M_LEN;
      srow = ws + ms[M_RING] + (long long)(src_abs % ms[M_CAP]) * w_s * c_s;
    } else {
      srow = static_cast<const T*>(p.src[rs[R_SRC]]) +
             ((long long)n * h_s + src_abs) * w_s * c_s;
    }
    *val = ld_act(srow + (long long)xs * c_s + co);
    return true;
  };
  const int twp = (mm[M_TW] + 3) & ~3;
  for (int o = threadIdx.x; o < nx * nc; o += blockDim.x) {
    const int m = o / nc, nn = o - m * nc;
    const int xo = x0 + m, co = c0 + nn;
    // the first residual's load flies while the row value is formed
    float r0 = 0.f;
    const bool has_r0 = mm[M_NRES] > 0 && residual(0, xo, co, &r0);
    float v;
    if (kConv) {
      float s0 = 0.f, s1 = 0.f;  // two independent partial sums
      int gg = 0;
      for (; gg + 1 < groups; gg += 2) {
        s0 += red[(gg * twp + m) * tc + nn];
        s1 += red[((gg + 1) * twp + m) * tc + nn];
      }
      if (gg < groups) s0 += red[(gg * twp + m) * tc + nn];
      v = fmaxf(s0 + s1 + sbias[nn], 0.f);
    } else {
      float mx = kNegInf;  // padding rows and columns read as -1e30
      for (int t0 = 0; t0 < k * k; t0 += 16) {  // 16 taps' loads in flight
        float tv[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int tap = t0 + u, dy = tap / k, dx = tap - dy * k;
          const int rr = r * stride - pad + dy;
          const int col = xo * stride - pad + dx;
          tv[u] = tap < k * k && rr >= 0 && rr < h_in && col >= 0 &&
                          col < w_in
                      ? ld_act(ring_in +
                               ((long long)(rr % cap_in) * w_in + col) * c_in +
                               co)
                      : kNegInf;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) mx = fmaxf(mx, tv[u]);
      }
      v = mx;
    }
    // residual adds in fp32 before the cast, in net order
    if (has_r0) v += r0;
    for (int e = 1; e < mm[M_NRES]; ++e) {
      float re;
      if (residual(e, xo, co, &re)) v += re;
    }
    const T o_v = from_f<T>(v);
    const long long idx = (long long)xo * c_out + co;
    dst[idx] = o_v;
    if (spill_dst != nullptr) spill_dst[idx] = o_v;
  }
}

// This CTA's tile (columns x0 .. x0+nx-1, channels c0 .. c0+nc-1) of the
// n_rows conv rows rows[0 .. n_rows) of map `off`: one group, whose rows
// read only maps finished behind an earlier cluster barrier.
//
// Each row's K = k*k*C_in is walked in chunks, and the group's rows are
// one stream of chunks: shared memory holds M_STAGES of them, each an A
// part padded to 128 bytes then B[kc][tc] (kc K indices of the chunk),
// the stage padded to 128 bytes, and M_STAGES - 1 chunks are in flight
// while one is multiplied, the next row's first chunks while a row's last
// is multiplied and its tile finished. B arrives by one TMA copy (two, or
// two a tap, for a 512-deep chunk) on the stage's mbarrier, bars[s]; bit
// s of `phase` is the parity of its next completion. A is staged by
// cp.async one of two ways (M_MODE):
// - im2col: a chunk is M_BK consecutive K indices, A[twp][M_BK + 4];
// - window: a chunk is every tap over M_BK input channels, and A is the
//   CTA's input window W[k][(twp - 1) * stride + k][M_BK + 4], each input
//   value staged once instead of once per tap; a tap table gives a K
//   index's window offset.
// A row's K-split sums go to the stage of its last chunk (after the
// stages, where they do not fit one) for finish_row. The issuing thread
// adds the in-range bytes of its TMA copies to *tma_sum. The stream keeps
// its row, chunk and stage as counters, so a chunk costs no division or
// modulo: on the H100 that made ResNet-18's last spans, 16 small chunks a
// row, 7% faster at one image. Every value only B's staging needs is
// formed where it is used: at 128 registers a value kept live across the
// chunk loop spills.
template <typename T>
__device__ __forceinline__ void conv_group(
    const int* __restrict__ maps, const int* __restrict__ res, const int off,
    const int n_maps, const int* rows, const int n_rows, const int n,
    const int x0, const int nx, const int c0, const int nc, T* ws, T* out,
    const SpanPtrs& p, float* sbias, float* sm, int* tapoff,
    unsigned long long* tma_sum, unsigned long long* bars, unsigned& phase) {
  const int* mm = maps + off * M_LEN;
  const int* mp = maps + (off - 1) * M_LEN;
  const int k = mm[M_K], stride = mm[M_STRIDE], pad = mm[M_PAD];
  const int h_in = mp[M_H], w_in = mp[M_W], c_in = mp[M_C];
  const int cap_in = mp[M_CAP];
  const int tc = mm[M_TC], twp = (mm[M_TW] + 3) & ~3;
  const int bk = mm[M_BK], ks = mm[M_KS], stages = mm[M_STAGES];
  const bool window = mm[M_MODE] == 1;
  const T* ring_in = ws + mp[M_RING];
  const int lg_bk = __ffs(bk) - 1;
  const int cstr = bk + 4;  // row stride of A (both modes)
  const int wcols = (twp - 1) * stride + k;
  const int a_size =
      ((window ? k * wcols * cstr : twp * cstr) + kAlign - 1) & -kAlign;
  const int kc = window ? k * k * bk : bk;  // K indices per chunk
  const int st_size = (a_size + kc * tc + kAlign - 1) & -kAlign;
  const int kdim = k * k * c_in;
  const int n_chunks = window ? (c_in + bk - 1) / bk : (kdim + bk - 1) / bk;
  const bool red_in_stage = ks * twp * tc <= st_size;
  const int tid = threadIdx.x;
  auto bar = [&](int s) {
    return static_cast<unsigned>(__cvta_generic_to_shared(bars + s));
  };
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
        reinterpret_cast<unsigned long long>(&p.b_map[mm[M_CONV]])));
    // the previous group's generic writes to these bytes are ordered
    // before this group's TMA copies (behind the cluster barrier)
    fence_proxy_async();
  }
  if (window) {  // read after chunk 0's __syncthreads
    for (int t = tid; t < k * k; t += kThreads) {
      const int dy = t / k;
      tapoff[t] = (dy * wcols + t - dy * k) * cstr;
    }
  }
  // element offset of row r's input row dy in its ring, -1 in the padding
  auto row_base = [&](int r, int dy) -> long long {
    const int rr = r * stride - pad + dy;
    return rr >= 0 && rr < h_in ? (long long)(rr % cap_in) * w_in * c_in
                                : -1;
  };
  const int col_base = x0 * stride - pad;
  // 16-byte copies of 4 fp32 channels need C_in % 4 == 0 and an aligned
  // ring; otherwise A goes through registers (converted, zero-padded).
  const bool vec_a = sizeof(T) == 4 && (c_in & 3) == 0 &&
                     (reinterpret_cast<unsigned long long>(ring_in) & 15) == 0;

  // im2col: A[m][kk] = ring row (r*stride - pad + dy), column (x0+m)*stride
  // - pad + dx, channel ci, where k0 + kk = (dy * k + dx) * C_in + ci. K
  // positions (groups of 4 when vectorised) over `lanes` threads, columns
  // over the rest; a position's (dy, dx, ci) is split once.
  auto load_im2col = [&](int r, int k0, float* as) {
    const int kpos = vec_a ? bk >> 2 : bk;
    const int lanes = min(kpos, kThreads);  // powers of 2
    const int lg_l = __ffs(lanes) - 1;
    const int m_first = tid >> lg_l, m_step = kThreads >> lg_l;
    const int kend = min(bk, kdim - k0);
    for (int kp = tid & (lanes - 1); kp < kpos; kp += lanes) {
      const int kk = vec_a ? kp << 2 : kp;
      long long rb = -1;
      int col0 = 0;
      if (kk < kend) {
        const int kg = k0 + kk;
        const int tap = kg / c_in, ci = kg - tap * c_in;
        const int dy = tap / k, dx = tap - dy * k;
        rb = row_base(r, dy);
        col0 = col_base + dx;
        rb = rb < 0 ? -1 : rb + ci;
      }
      if (vec_a) {
        const float* ring = reinterpret_cast<const float*>(ring_in);
        for (int m = m_first; m < twp; m += m_step) {
          const int col = col0 + m * stride;
          const bool ok = rb >= 0 && m < nx && col >= 0 && col < w_in;
          cp_async16(as + m * cstr + kk,
                     ok ? ring + rb + (long long)col * c_in : ring,
                     ok ? 16 : 0);
        }
      } else {  // eight loads in flight per thread
        for (int m0 = m_first; m0 < twp; m0 += 8 * m_step) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int m = m0 + u * m_step;
            const int col = col0 + m * stride;
            v[u] = rb >= 0 && m < nx && col >= 0 && col < w_in
                       ? ld_act(ring_in + rb + (long long)col * c_in)
                       : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int m = m0 + u * m_step;
            if (m < twp) as[m * cstr + kk] = v[u];
          }
        }
      }
    }
  };
  // window: W[dy][col][ci - ci0] = ring row (r*stride - pad + dy), column
  // x0*stride - pad + col, channel ci, for ci in [ci0, ci0 + bk)
  auto load_window = [&](int r, int ci0, float* ws_) {
    const int q_lg = vec_a ? lg_bk - 2 : lg_bk;  // channels (or 4s) per col
    const int n_e = wcols << q_lg;
    for (int dy = 0; dy < k; ++dy) {
      const long long rb = row_base(r, dy);
      float* wrow = ws_ + dy * wcols * cstr;
      if (vec_a) {
        const float* ring = reinterpret_cast<const float*>(ring_in);
        for (int e = tid; e < n_e; e += kThreads) {
          const int col = e >> q_lg, ci = (e & ((1 << q_lg) - 1)) << 2;
          const int gcol = col_base + col;
          const bool ok = rb >= 0 && gcol >= 0 && gcol < w_in &&
                          ci0 + ci < c_in;
          cp_async16(wrow + col * cstr + ci,
                     ok ? ring + rb + (long long)gcol * c_in + ci0 + ci : ring,
                     ok ? 16 : 0);
        }
      } else {  // eight loads in flight per thread
        for (int e0 = tid; e0 < n_e; e0 += 8 * kThreads) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * kThreads;
            const int col = e >> q_lg, ci = e & (bk - 1);
            const int gcol = col_base + col;
            v[u] = e < n_e && rb >= 0 && gcol >= 0 && gcol < w_in &&
                           ci0 + ci < c_in
                       ? ld_act(ring_in + rb + (long long)gcol * c_in + ci0 +
                                ci)
                       : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int e = e0 + u * kThreads;
            if (e < n_e) wrow[(e >> q_lg) * cstr + (e & (bk - 1))] = v[u];
          }
        }
      }
    }
  };
  // B[kk][n] = the weight row of the chunk's kk-th K index, columns c0 + n,
  // by TMA, issued by one thread, on mbarrier bar: boxes of tc channels x
  // bk rows (x k*k taps) of the map's tensor, 256 rows at most (so one box
  // a tap for a 512-deep window chunk). The copy engine zero fills past
  // C_in or K and past C_out (the tile's nc), and the barrier counts every
  // byte of the boxes. kernel.py's launch_counts models the in-range bytes
  // (weight_bytes): a change here changes it
  auto load_b_tma = [&](int c, float* bs, unsigned b) {
    const CUtensorMap* map = &p.b_map[mm[M_CONV]];
    const int k0 = c * bk, bkb = min(bk, kBoxMax);
    int rows_in = 0;  // in-range K rows copied
    mbar_expect(b, kc * tc * 4);
    if (!window) {
      for (int h = 0; h < bk; h += kBoxMax) {
        tma_load2(bs + h * tc, map, b, c0, k0 + h);
        rows_in += max(0, min(bkb, kdim - k0 - h));
      }
    } else if (bk <= kBoxMax) {
      tma_load3(bs, map, b, c0, k0, 0);
      rows_in = max(0, min(bk, c_in - k0)) * k * k;
    } else {
      for (int t = 0; t < k * k; ++t) {
        for (int h = 0; h < bk; h += kBoxMax) {
          tma_load3(bs + (t * bk + h) * tc, map, b, c0, k0 + h, t);
          rows_in += max(0, min(kBoxMax, c_in - k0 - h));
        }
      }
    }
    *tma_sum += 4ull * rows_in * nc;
  };
  // chunk c of row j into stage s: B's TMA copy on the stage's barrier
  // first, then A's cp.async group, maybe empty
  auto fetch = [&](int j, int c, int s) {
    if (j < n_rows) {
      float* as = sm + s * st_size;
      if (tid == 0) load_b_tma(c, as + a_size, bar(s));
      if (window) {
        load_window(rows[j], c * bk, as);
      } else {
        load_im2col(rows[j], c * bk, as);
      }
    }
    cp_async_commit();
  };

  // compute: group g of ks walks the chunk's K four at a time; the thread
  // holds columns tm + i * ntm (i < 4, interleaved so the threads' 16-byte
  // reads of A spread over the banks) x channels 4 tn .. 4 tn + 3
  const int ntn = tc >> 2, ntm = twp >> 2, grp = ntm * ntn;
  const int g = tid / grp, l = tid - g * grp;
  const int tn = l % ntn, tm = l / ntn;
  const bool active = g < ks;
  const int mstr = window ? stride * cstr : cstr;  // A: next column
  float acc[4][4];
  const float* __restrict__ bias = p.bias[mm[M_CONV]];
  for (int i = tid; i < nc; i += kThreads) {  // lands with chunk 0
    cp_async4(sbias + i, bias + c0 + i, 4);
  }
  for (int i = 0; i < stages - 1; ++i) fetch(i / n_chunks, i % n_chunks, i);
  int row = 0, c = 0, s = 0;  // the row and chunk multiplied, their stage
  while (row < n_rows) {
    if (stages == 2) {
      cp_async_wait<0>();
    } else if (stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<2>();
    }
    mbar_wait(bar(s), (phase >> s) & 1);  // the chunk's B
    phase ^= 1u << s;
    __syncthreads();  // the chunk is in; the last one's stage is free
    {  // the chunk stages - 1 ahead, into that stage
      int fr = row, fc = c + stages - 1;
      while (fc >= n_chunks) {
        fc -= n_chunks;
        ++fr;
      }
      fetch(fr, fc, s == 0 ? stages - 1 : s - 1);
    }
    float* st = sm + s * st_size;
    if (++s == stages) s = 0;
    if (c == 0) {  // a row's first chunk
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
    }
    if (active) {
      const float* ap = st + tm * mstr;
      const float* bp = st + a_size + 4 * tn;
      const int kend = window ? kc : min(bk, kdim - c * bk);
      // A offset of K index kk, looked up one step ahead in window mode
      auto a_off = [&](int kk) {
        return window ? tapoff[kk >> lg_bk] + (kk & (bk - 1)) : kk;
      };
      int ak = a_off(min(4 * g, kc - 4));
      for (int kk = 4 * g; kk < kend; kk += 4 * ks) {
        const int ak_next = a_off(min(kk + 4 * ks, kc - 4));
        float4 a4[4], b4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a4[i] = *reinterpret_cast<const float4*>(ap + i * ntm * mstr + ak);
          b4[i] = *reinterpret_cast<const float4*>(bp + (kk + i) * tc);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a_v[4] = {a4[i].x, a4[i].y, a4[i].z, a4[i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][0] = fmaf(a_v[j], b4[j].x, acc[i][0]);
            acc[i][1] = fmaf(a_v[j], b4[j].y, acc[i][1]);
            acc[i][2] = fmaf(a_v[j], b4[j].z, acc[i][2]);
            acc[i][3] = fmaf(a_v[j], b4[j].w, acc[i][3]);
          }
        }
        ak = ak_next;
      }
    }
    if (++c < n_chunks) continue;
    // the row's sums are complete; the next row's chunks are in flight
    float* red = red_in_stage ? st : sm + stages * st_size;
    __syncthreads();  // every group has multiplied the chunk
    if (active) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(red + (g * twp + tm + i * ntm) * tc +
                                   4 * tn) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();
    // the sums' generic writes are ordered before the TMA copy that next
    // overwrites this stage, issued by this thread
    if (red_in_stage && tid == 0) fence_proxy_async();
    // the next chunk's __syncthreads frees `red` before a fetch rewrites it
    finish_row<T, true>(maps, res, off, n_maps, rows[row], n, x0, nx, c0, nc,
                        ws, out, p, sbias, red, ks);
    c = 0;
    ++row;
  }
  cp_async_wait<0>();  // the stream's trailing empty groups
}

// This CTA's tile of the n_rows rows rows[0 .. n_rows) of map `off`, one
// (step, map) group. Uniform over the CTA.
template <typename T>
__device__ __forceinline__ void produce_group(
    const int* __restrict__ maps, const int* __restrict__ res, const int off,
    const int n_maps, const int* rows, const int n_rows, const int n,
    const int rank, T* ws, T* out, const SpanPtrs& p, float* sbias,
    float* sm, int* tapoff, unsigned long long* tma_sum,
    unsigned long long* bars, unsigned& phase) {
  const int* mm = maps + off * M_LEN;
  const int w_out = mm[M_W], c_out = mm[M_C];
  const int nct = mm[M_NCT], tw = mm[M_TW], tc = mm[M_TC];
  const int x0 = (rank / nct) * tw, c0 = (rank % nct) * tc;
  const int nx = min(tw, w_out - x0), nc = min(tc, c_out - c0);
  if (nx <= 0 || nc <= 0) return;  // a CTA with no tile in this map
  if (mm[M_KIND] == 0) {
    conv_group<T>(maps, res, off, n_maps, rows, n_rows, n, x0, nx, c0, nc,
                  ws, out, p, sbias, sm, tapoff, tma_sum, bars, phase);
  } else {
    for (int j = 0; j < n_rows; ++j) {
      finish_row<T, false>(maps, res, off, n_maps, rows[j], n, x0, nx, c0,
                           nc, ws, out, p, sbias, nullptr, 0);
    }
  }
}

// One cluster per image, two CTAs per SM at most (128 registers, at most
// half the SM's shared memory each); __grid_constant__ keeps p in the
// parameter space when finish_row and conv_group index its pointer tables.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fused_span_kernel(const int* __restrict__ desc,
                      const __grid_constant__ SpanPtrs p) {
  extern __shared__ __align__(128) float4 smem4[];
  __shared__ int tapoff[kMaxTaps];
  __shared__ unsigned long long tma_sum;  // thread 0's TMA bytes
  // K-chunk stage s's mbarrier, for every group: initialised once, at
  // fixed addresses, and with `phase` carried from group to group (every
  // copy a group issues, it consumes)
  __shared__ unsigned long long bars[kMaxStages];
  unsigned phase = 0;
  int* sd = reinterpret_cast<int*>(smem4);
  if (threadIdx.x == 0) {
    tma_sum = 0;
    for (int i = 0; i < kMaxStages; ++i) {
      mbar_init(static_cast<unsigned>(__cvta_generic_to_shared(bars + i)));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the descriptor up to its slot table, read once into shared memory: the
  // rows read it again and again
  for (int i = threadIdx.x; i < desc[H_TABLE]; i += blockDim.x) {
    sd[i] = desc[i];
  }
  __syncthreads();
  const int cluster = sd[H_CLUSTER];
  if (static_cast<int>(cluster_reg(1)) != cluster) __trap();
  const int rank = static_cast<int>(cluster_reg(0));
  const int n = blockIdx.x / cluster;  // the cluster's image
  const int n_maps = sd[H_NMAPS], in_rows = sd[H_INROWS];
  const int n_steps = sd[H_NSTEPS], total_slots = sd[H_TOTSLOTS];
  const int* maps = sd + sd[H_MAPS];
  const int* res = sd + sd[H_RES];
  const int* slots = sd + sd[H_SLOTS];
  const int* arrivals = sd + sd[H_ARRIVALS];
  const int* table = desc + sd[H_TABLE];
  int* srow = sd + sd[H_ROW];
  float* sbias = reinterpret_cast<float*>(smem4) + sd[H_BIAS];
  float* sm = reinterpret_cast<float*>(smem4) + sd[H_STAGE];
  // TMA lands B 128-byte aligned: the K-chunks' base must be
  if (static_cast<unsigned>(__cvta_generic_to_shared(sm)) & 127) __trap();
  const int* m0 = maps;
  const int* mb = maps + (n_maps - 1) * M_LEN;
  const int in_elems = m0[M_W] * m0[M_C];
  T* ws = static_cast<T*>(p.ws) + (long long)n * p.ws_per_image;
  const T* x = static_cast<const T*>(p.x) + (long long)n * m0[M_H] * in_elems;
  T* out = static_cast<T*>(p.out) +
           (long long)n * mb[M_H] * mb[M_W] * mb[M_C];
  T* ring0 = ws + m0[M_RING];
  // the CTA's share of an input row
  const int share = (in_elems + cluster - 1) / cluster;
  const int e0 = rank * share, e1 = min(e0 + share, in_elems);

  for (int t = 0; t < n_steps; ++t) {
    __syncthreads();  // the previous step's table row is read
    for (int i = threadIdx.x; i < total_slots; i += blockDim.x) {
      srow[i] = table[(long long)t * total_slots + i];
    }
    const int blk = arrivals[t];
    if (blk >= 0) {  // the step's input block joins ring 0
      // this CTA's share of each row of the block, four loads in flight
      const int rows = min(in_rows, m0[M_H] - blk * in_rows);
      const int len = max(e1 - e0, 0), n_e = rows * len;
      for (int i0 = threadIdx.x; i0 < n_e; i0 += 4 * blockDim.x) {
        T v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * blockDim.x;
          const int g = blk * in_rows + i / max(len, 1);
          if (i < n_e) v[u] = x[(long long)g * in_elems + e0 + i % len];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * blockDim.x;
          const int g = blk * in_rows + i / max(len, 1);
          if (i < n_e) {
            ring0[(long long)(g % m0[M_CAP]) * in_elems + e0 + i % len] = v[u];
          }
        }
      }
      cluster_sync();
    } else {
      __syncthreads();
    }
    int slot = 0;
    for (int off = 1; off < n_maps; ++off) {
      // the step's rows of map `off` lead its slots, -1 after them
      int n_rows = 0;
      while (n_rows < slots[off - 1] && srow[slot + n_rows] >= 0) ++n_rows;
      if (n_rows > 0) {  // uniform across the cluster
        produce_group<T>(maps, res, off, n_maps, srow + slot, n_rows, n, rank,
                         ws, out, p, sbias, sm, tapoff, &tma_sum, bars,
                         phase);
        cluster_sync();
      }
      slot += slots[off - 1];
    }
  }
  if (threadIdx.x == 0 && tma_sum != 0) atomicAdd(p.tma_tally, tma_sum);
}

template <typename T>
cudaError_t set_attributes(int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_span_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fused_span_kernel<T>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

void config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int grid,
            int cluster, int smem, cudaStream_t s) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename T>
int max_clusters(int cluster, int smem, int* count) {
  cudaError_t e = set_attributes<T>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(&cfg, &attr, cluster, cluster, smem, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, fused_span_kernel<T>, &cfg));
}

template <typename T>
int launch(const int* d, const SpanPtrs& p, int batch, int cluster,
           int smem, cudaStream_t s) {
  cudaError_t e = set_attributes<T>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(&cfg, &attr, batch * cluster, cluster, smem, s);
  e = cudaLaunchKernelEx(&cfg, fused_span_kernel<T>, d, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many clusters of `cluster` CTAs with `smem` bytes of dynamic shared
// memory the device holds at once, into *count; returns the CUDA error.
extern "C" int occam_fused_span_max_clusters(int dtype, int cluster,
                                             int smem, int* count) {
  switch (dtype) {
    case 0: return max_clusters<float>(cluster, smem, count);
    case 1: return max_clusters<__nv_bfloat16>(cluster, smem, count);
    case 2: return max_clusters<__half>(cluster, smem, count);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Encodes into `map` (128 bytes, 64-byte aligned) the TMA tensor map of
// one conv's fp32 HWIO weights `w` as its B operand: in window mode the
// (k*k, C_in, C_out) tensor with a box of (tc, min(bk, 256), k*k taps, or
// 1 where bk > 256), else the (K, C_out) matrix with a box of (tc,
// min(bk, 256)); extents are the tensor's, so the copy engine zero-fills
// past them. `w`'s rows hold C_out rounded up to a multiple of 4 floats
// (16 bytes, the row stride TMA takes; the channels past C_out are never
// read); tc <= 256 and a 16-byte-aligned `w` are the caller's. libcuda's
// cuTensorMapEncodeTiled is found through the runtime's entry-point
// query, so nothing links libcuda. Returns the CUresult, or -1 where the
// encoder is not found.
extern "C" int occam_fused_span_encode_b_map(void* map, const void* w,
                                             int window, int k, int c_in,
                                             int c_out, int tc, int bk) {
  typedef CUresult (*Encode)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
      const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
      CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      fn = nullptr;
    }
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return -1;
  const cuuint64_t row = static_cast<cuuint64_t>((c_out + 3) & ~3) * 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c_out),
                              static_cast<cuuint64_t>(window ? c_in
                                                             : k * k * c_in),
                              static_cast<cuuint64_t>(k * k)};
  const cuuint64_t strides[2] = {row, row * c_in};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(tc),
                             static_cast<cuuint32_t>(bk < kBoxMax ? bk
                                                                  : kBoxMax),
                             static_cast<cuuint32_t>(bk <= kBoxMax ? k * k
                                                                   : 1)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return static_cast<int>(encode(
      static_cast<CUtensorMap*>(map), CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      window ? 3 : 2, const_cast<void*>(w), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (activations; weights and biases
// are float32). One cluster of `cluster` CTAs per image, `smem` bytes of
// dynamic shared memory each; the descriptor's tiles must be those of
// this cluster size. `b_maps` holds the n_conv convs' encoded tensor maps
// of their weights, 128 bytes each, and the CTAs add the bytes they stage
// by TMA to *tma_tally. Launches on `stream`, does not synchronise, and
// returns the launch's CUDA error.
extern "C" int occam_fused_span_launch(
    int dtype, const void* desc, const void* x, void* out, void* ws,
    long long ws_per_image, const void* const* bias, const void* b_maps,
    int n_conv, const void* const* src, int n_src,
    void* const* spill, int n_spill, void* tma_tally, int batch,
    int cluster, int smem, void* stream) {
  if (n_conv > kMaxConv || n_src > kMaxSrc || n_spill > kMaxSpill ||
      batch < 1 || cluster < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SpanPtrs p = {};
  memcpy(p.b_map, b_maps, sizeof(CUtensorMap) * n_conv);
  p.tma_tally = static_cast<unsigned long long*>(tma_tally);
  p.x = x;
  p.out = out;
  p.ws = ws;
  p.ws_per_image = ws_per_image;
  for (int i = 0; i < n_conv; ++i) {
    p.bias[i] = static_cast<const float*>(bias[i]);
  }
  for (int i = 0; i < n_src; ++i) p.src[i] = src[i];
  for (int i = 0; i < n_spill; ++i) p.spill[i] = spill[i];
  const int* d = static_cast<const int*>(desc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(d, p, batch, cluster, smem, s);
    case 1: return launch<__nv_bfloat16>(d, p, batch, cluster, smem, s);
    case 2: return launch<__half>(d, p, batch, cluster, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
