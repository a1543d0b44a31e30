// Depthwise causal width-W convolution + bias + SiLU, forward and backward,
// fp32 and bf16 activations (x, y, g, dx); the weight, the bias, every sum
// and dw/db are fp32 in both.
//
// Forward (K1): replaces the TPU kernel `_fwd_kernel` behind
// `causal_conv1d_silu_pallas` (si_mamba_tpu/ops/pallas/causal_conv_kernel.py),
// which holds a whole (L, block_d) slab in VMEM and builds the time shifts by
// concatenation.
//
// Bound on the H100: bytes. Every output reads W inputs that its neighbours
// in time also read, so the least traffic is one read of x and one write of
// y (2 x 50.3 MB per layer at B=32, L=512, D=768, about 30 us at 3.35 TB/s);
// the 2W+5 operations per output are two orders of magnitude below the fp32
// rate.
//
// Design: one thread per channel d, 128 channels per block, so that each
// warp's loads and stores of one time row are 128 contiguous bytes. A block
// walks a tile of kTimeTile steps; each thread keeps the W-1 previous inputs
// of its channel in registers, so every input is read from device memory
// once (plus W-1 halo rows per tile). x may be a column slice of a wider
// buffer (the mixer's xz): the kernel takes x's batch and row strides and
// needs unit stride only along channels. No padding of L or D: the ragged
// edges are masked.
//
// bf16 forward (the TPU kernel at a bf16 activation dtype: x and y bf16, w
// and b read as fp32, the sum in fp32, y rounded once): bound by bytes, half
// of fp32's (2 x 25.2 MB per layer at B=32, L=512, D=768, about 15 us). A
// thread owns kV16 = 8 neighbouring channels and moves them as one 16-byte
// vector when x's address and strides allow (the Mamba-1 view: row stride
// 1536), else one channel; a warp's access to one row is then 512
// contiguous bytes. A block is kFwdWarps warps on consecutive time tiles of
// kFwdTile16 steps of the same 256 channels, so the grid fills the card at
// D = 768 (3 x 32 x 16 blocks at B=32, L=512).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no fast math: expf keeps parity with the
//        reference implementations).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "elem.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTimeTile = 64;

template <int W>
__global__ void __launch_bounds__(kThreads)
causal_conv1d_silu_fwd_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ bias,
                              float* __restrict__ y, int L, int D,
                              long long x_sb, long long x_sr) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const int b = blockIdx.y;
  const int t0 = blockIdx.z * kTimeTile;
  const int t_end = min(t0 + kTimeTile, L);

  const float* xb = x + static_cast<long long>(b) * x_sb + d;
  float* yb = y + static_cast<long long>(b) * L * D + d;

  float wk[W];
#pragma unroll
  for (int k = 0; k < W; ++k) wk[k] = w[d * W + k];
  const float bd = bias[d];

  // win[k] holds x[t - (W-1) + k]; win[W-1] is loaded each step.
  float win[W];
#pragma unroll
  for (int k = 0; k < W - 1; ++k) {
    const int t = t0 - (W - 1) + k;
    win[k] = t >= 0 ? xb[static_cast<long long>(t) * x_sr] : 0.f;
  }

#pragma unroll 4
  for (int t = t0; t < t_end; ++t) {
    win[W - 1] = xb[static_cast<long long>(t) * x_sr];
    // same summation order as the TPU kernel: bias, then taps oldest first
    float s = bd;
#pragma unroll
    for (int k = 0; k < W; ++k) s += wk[k] * win[k];
    yb[static_cast<long long>(t) * D] = s / (1.f + expf(-s));
#pragma unroll
    for (int k = 0; k < W - 1; ++k) win[k] = win[k + 1];
  }
}

constexpr int kV16 = 8;          // bf16 channels a thread moves as one 16-byte vector
constexpr int kFwdWarps = 4;     // warps (time tiles) a block of the bf16 forward
constexpr int kFwdTile16 = 32;   // steps of a warp's time tile, bf16 forward

// One row of V bf16 channels at p to fp32: one 16-byte load for V = 8.
template <int V>
__device__ __forceinline__ void load_bf16(const bf16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_lo(w[i]);
      v[2 * i + 1] = bf16_hi(w[i]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = to_f(p[c]);
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(bf16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) p[c] = from_f<bf16>(v[c]);
  }
}

// bf16 forward: lane l of warp w owns channels d0 = (32 blockIdx.x + l) V ..
// d0 + V - 1 over the time tile blockIdx.z * kFwdWarps + w. V = 8 needs D a
// multiple of 8 and x 16-byte aligned with strides that are multiples of 8
// (the C entry point checks); V = 1 serves any other x.
template <int V>
__global__ void __launch_bounds__(32 * kFwdWarps)
causal_conv1d_silu_fwd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                                   const float* __restrict__ bias, bf16* __restrict__ y,
                                   int L, int D, long long x_sb, long long x_sr) {
  constexpr int W = 4;
  const int lane = threadIdx.x & 31;
  const int d0 = (blockIdx.x * 32 + lane) * V;
  const int t0 = (blockIdx.z * kFwdWarps + (threadIdx.x >> 5)) * kFwdTile16;
  if (d0 >= D || t0 >= L) return;
  const int t_end = min(t0 + kFwdTile16, L);
  const bf16* xb = x + static_cast<long long>(blockIdx.y) * x_sb + d0;
  bf16* yb = y + static_cast<long long>(blockIdx.y) * L * D + d0;

  float wk[W][V], bd[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
#pragma unroll
    for (int k = 0; k < W; ++k) wk[k][c] = w[(d0 + c) * W + k];
    bd[c] = bias[d0 + c];
  }
  float win[W - 1][V];  // x[t-3], x[t-2], x[t-1]
#pragma unroll
  for (int k = 0; k < W - 1; ++k) {
    const int t = t0 - (W - 1) + k;
    if (t >= 0) {
      load_bf16<V>(xb + t * x_sr, win[k]);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) win[k][c] = 0.f;
    }
  }
#pragma unroll 4
  for (int t = t0; t < t_end; ++t) {
    float xt[V], out[V];
    load_bf16<V>(xb + t * x_sr, xt);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      // the fp32 kernel's summation order: bias, then taps oldest first
      float s = bd[c];
#pragma unroll
      for (int k = 0; k < W - 1; ++k) s += wk[k][c] * win[k][c];
      s += wk[W - 1][c] * xt[c];
      out[c] = s / (1.f + expf(-s));
#pragma unroll
      for (int k = 0; k < W - 2; ++k) win[k][c] = win[k + 1][c];
      win[W - 2][c] = xt[c];
    }
    store_bf16<V>(yb + static_cast<long long>(t) * D, out);
  }
}

// Backward (K5): replaces the TPU kernel `_bwd_kernel` behind `_cc_bwd`
// (si_mamba_tpu/ops/pallas/causal_conv_kernel.py). With
// s = b + sum_k w[k] x[t-W+1+k] and y = silu(s):
//
//   ds[t]  = g[t] * sig(s[t]) * (1 + s[t] * (1 - sig(s[t])))
//   dx[t]  = sum_k w[k] ds[t+W-1-k]
//   dw[k]  = sum_{b,t} ds[t] x[t-W+1+k],   db = sum_{b,t} ds[t]
//
// Bound on the H100: bytes. One read of x and g and one write of dx (3 x
// 50.3 MB per layer at B=32, L=512, D=768, 45 us at 3.35 TB/s). The 6W+11
// operations per element (an expf and a full-precision division among them)
// take about half that time in instruction slots, so the loads must stay in
// flight while the arithmetic runs.
//
// Design (W = 4 only):
// - A thread owns kV = 4 neighbouring channels and walks one time tile of T
//   steps (T from the wrapper's plan, a multiple of kU, at least 2 kU). Each
//   of x, g and dx is moved kV floats a thread at a time, as one 16-byte, two
//   8-byte or four 4-byte accesses (template arguments VX for x, VG for g and
//   dx). Three variants are built: (4, 4) for the Mamba-1 view and the
//   contiguous tensor-parallel operands, (2, 4) for the SSD view (rows 8-byte
//   aligned) and (1, 1) for any other alignment. The C entry point refuses a
//   width that an operand's alignment does not allow, and any other pair. A
//   warp's access to one row is then 512 contiguous bytes.
// - Loads in flight: a ring of kU rows of x and g in registers. Each step
//   consumes the oldest row and starts the load of the row kU steps ahead
//   before the next step's arithmetic, so kU rows (4 KB a warp) are always in
//   flight. The tile's first chunk of kU steps (which emits no dx for its
//   first W-1 steps) and its last chunk (whose refills are the look-ahead
//   rows, within L only) are peeled, and so are the W-1 look-ahead steps, so
//   the steady loop over the middle chunks has no branch.
// - dx[t] needs ds up to t+W-1: a thread keeps the last W-1 values of ds and
//   the last W-1 rows of x in registers and emits dx W-1 steps late, so each
//   tile re-reads W-1 rows of x before it and W-1 rows of x and g after it
//   (3/T of the tile's traffic; the neighbouring tile reads the same rows at
//   about the same time, so they come mostly from L2).
// - A block is kWarps warps on the same 128 channels and batch row, each on
//   the next time tile; the grid is (ceil(D/128), B, ceil(ceil(L/T)/kWarps)).
// - dw and db: summed in registers over a thread's tile, then over the
//   block's warps in warp order through shared memory, and written as one
//   (W+1, D) partial per block; a second small kernel sums the partials in a
//   fixed order and writes dw (D, W) and db (D). No atomics: two runs on the
//   same inputs are bitwise equal.
// - A thread whose four channels pass D (D % 4 != 0), or whose tile passes L
//   (L % T != 0, the last tile only), takes a plain per-channel path with
//   per-step guards (tile_masked), out of line.
// - bf16 (template type T): x, g and dx are bf16, the widths count elements,
//   so the (4, 4) variant moves 8 bytes a thread (a warp's row access 256
//   contiguous bytes); each value is widened to fp32 as it is loaded and dx
//   rounded once as it is stored. Everything else, the dw/db partials and
//   their fixed-order finish included, is the fp32 body's.
constexpr int kW = 4;                      // the conv width this body serves
constexpr int kV = 4;                      // channels a thread
constexpr int kU = 4;                      // rows of x and g in flight a thread
constexpr int kWarps = 4;                  // warps (time tiles) a block
constexpr int kBwdThreads = 32 * kWarps;
constexpr int kBwdChannels = 32 * kV;      // channels a block
constexpr int kFinishRows = 8;             // partial rows summed in parallel

template <typename T, int V>
__device__ __forceinline__ void load_row(const T* p, float (&v)[kV]) {
  if constexpr (std::is_same_v<T, bf16>) {
    if constexpr (V == 4) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x); v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
    } else if constexpr (V == 2) {
      const unsigned int a = __ldg(reinterpret_cast<const unsigned int*>(p));
      const unsigned int b = __ldg(reinterpret_cast<const unsigned int*>(p + 2));
      v[0] = bf16_lo(a); v[1] = bf16_hi(a); v[2] = bf16_lo(b); v[3] = bf16_hi(b);
    } else {
#pragma unroll
      for (int c = 0; c < kV; ++c) v[c] = to_f(p[c]);
    }
  } else if constexpr (V == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    const float2 b = __ldg(reinterpret_cast<const float2*>(p + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int c = 0; c < kV; ++c) v[c] = __ldg(p + c);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(T* p, const float (&v)[kV]) {
  if constexpr (std::is_same_v<T, bf16>) {
    if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    } else if constexpr (V == 2) {
      reinterpret_cast<unsigned int*>(p)[0] = pack_bf16(v[0], v[1]);
      reinterpret_cast<unsigned int*>(p)[1] = pack_bf16(v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < kV; ++c) p[c] = from_f<bf16>(v[c]);
    }
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    reinterpret_cast<float2*>(p)[0] = make_float2(v[0], v[1]);
    reinterpret_cast<float2*>(p)[1] = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kV; ++c) p[c] = v[c];
  }
}

// One thread's registers over its tile: the taps, the windows of x and ds,
// the dw and db sums.
struct BwdState {
  float w[kW][kV], bias[kV];
  float win[kW - 1][kV];  // x[t-3], x[t-2], x[t-1]
  float dsw[kW - 1][kV];  // ds[t-3], ds[t-2], ds[t-1]
  float dw[kW][kV], db[kV];

  // Step t on x[t] and g[t]: ds[t] (0 when !valid, past L), into the sums
  // when kAcc; dxo = dx[t-3].
  template <bool kAcc>
  __device__ __forceinline__ void step(const float (&xt)[kV], const float (&gt)[kV],
                                       bool valid, float (&dxo)[kV]) {
#pragma unroll
    for (int c = 0; c < kV; ++c) {
      // the forward's summation order: bias, then taps oldest first
      float s = bias[c];
#pragma unroll
      for (int k = 0; k < kW - 1; ++k) s += w[k][c] * win[k][c];
      s += w[kW - 1][c] * xt[c];
      const float sig = 1.f / (1.f + expf(-s));
      const float ds = valid ? gt[c] * sig * (1.f + s * (1.f - sig)) : 0.f;
      if (kAcc) {
#pragma unroll
        for (int k = 0; k < kW - 1; ++k) dw[k][c] += ds * win[k][c];
        dw[kW - 1][c] += ds * xt[c];
        db[c] += ds;
      }
      // dx[t-3] = sum_k w[k] ds[t-k]
      float acc = 0.f;
      acc += w[0][c] * ds;
#pragma unroll
      for (int k = 1; k < kW; ++k) acc += w[k][c] * dsw[kW - 1 - k][c];
      dxo[c] = acc;
#pragma unroll
      for (int k = 0; k < kW - 2; ++k) {
        dsw[k][c] = dsw[k + 1][c];
        win[k][c] = win[k + 1][c];
      }
      dsw[kW - 2][c] = ds;
      win[kW - 2][c] = xt[c];
    }
  }
};

// A full tile [t0, t0 + T) of four in-range channels. xp, gp, op point at
// (b, t = 0, d0) of x, g and dx.
template <typename T, int VX, int VG>
__device__ __forceinline__ void tile_full(BwdState& st, const T* __restrict__ xp,
                                          const T* __restrict__ gp, T* __restrict__ op,
                                          int x_sr, int g_sr, int o_sr,
                                          int t0, int tile, int L) {
  const int ahead = L - t0 - tile;  // rows past the tile within L
#pragma unroll
  for (int k = 0; k < kW - 1; ++k) {
    const int t = t0 - (kW - 1) + k;
    if (t >= 0) {
      load_row<T, VX>(xp + static_cast<long long>(t) * x_sr, st.win[k]);
    } else {
#pragma unroll
      for (int c = 0; c < kV; ++c) st.win[k][c] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kW - 1; ++k)
#pragma unroll
    for (int c = 0; c < kV; ++c) st.dsw[k][c] = 0.f;

  // the ring: xr[u], gr[u] hold the row of the step that is u mod kU
  float xr[kU][kV], gr[kU][kV], dxo[kV];
  const T* xq = xp + static_cast<long long>(t0) * x_sr;  // next row to load
  const T* gq = gp + static_cast<long long>(t0) * g_sr;
  T* oq = op + static_cast<long long>(t0) * o_sr;        // next dx row
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    load_row<T, VX>(xq, xr[u]);
    load_row<T, VG>(gq, gr[u]);
    xq += x_sr;
    gq += g_sr;
  }

  // first chunk: dx from its (W-1)-th step on
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    st.step<true>(xr[u], gr[u], true, dxo);
    load_row<T, VX>(xq, xr[u]);
    load_row<T, VG>(gq, gr[u]);
    xq += x_sr;
    gq += g_sr;
    if (u >= kW - 1) {
      store_row<T, VG>(oq, dxo);
      oq += o_sr;
    }
  }
  // the steady chunks: no branch
  const int chunks = tile / kU;
  for (int ch = 1; ch < chunks - 1; ++ch) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      st.step<true>(xr[u], gr[u], true, dxo);
      load_row<T, VX>(xq, xr[u]);
      load_row<T, VG>(gq, gr[u]);
      xq += x_sr;
      gq += g_sr;
      store_row<T, VG>(oq, dxo);
      oq += o_sr;
    }
  }
  // last chunk: its refills are the W-1 look-ahead rows, within L
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    st.step<true>(xr[u], gr[u], true, dxo);
    if (u < kW - 1 && u < ahead) {
      load_row<T, VX>(xq, xr[u]);
      load_row<T, VG>(gq, gr[u]);
    }
    xq += x_sr;
    gq += g_sr;
    store_row<T, VG>(oq, dxo);
    oq += o_sr;
  }
  // the look-ahead steps: ds past L is 0; no sums
#pragma unroll
  for (int u = 0; u < kW - 1; ++u) {
    st.step<false>(xr[u], gr[u], u < ahead, dxo);
    store_row<T, VG>(oq, dxo);
    oq += o_sr;
  }
}

// The edge: channels d0 .. d0 + nvalid - 1 (nvalid <= kV) over steps
// [t0, t1), scalar, with per-step guards; the dw/db sums go to red[k *
// kBwdChannels + c] (zeros for the channels past D).
template <typename T>
__device__ __noinline__ void tile_masked(const T* __restrict__ x, const float* __restrict__ w,
                                         const float* __restrict__ bias,
                                         const T* __restrict__ g, T* __restrict__ dx,
                                         float* red, int b, int d0, int nvalid, int t0, int t1,
                                         int L, int D, long long x_sb, long long x_sr,
                                         long long g_sb, long long g_sr) {
  const int t_last = min(t1 + kW - 1, L);  // ds is needed up to t1+W-2
  for (int c = 0; c < kV; ++c) {
    float dwk[kW] = {0.f, 0.f, 0.f, 0.f};
    float dbv = 0.f;
    if (c < nvalid) {
      const int d = d0 + c;
      const T* xb = x + static_cast<long long>(b) * x_sb + d;
      const T* gb = g + static_cast<long long>(b) * g_sb + d;
      T* dxb = dx + static_cast<long long>(b) * L * D + d;
      float wk[kW];
      for (int k = 0; k < kW; ++k) wk[k] = w[d * kW + k];
      const float bd = bias[d];
      float win[kW];  // win[k] = x[t - (W-1) + k]
      for (int k = 0; k < kW - 1; ++k) {
        const int t = t0 - (kW - 1) + k;
        win[k] = t >= 0 ? to_f(xb[static_cast<long long>(t) * x_sr]) : 0.f;
      }
      float dsw[kW] = {0.f, 0.f, 0.f, 0.f};  // dsw[j] = ds[t - (W-1) + j]
      for (int t = t0; t < t1 + kW - 1; ++t) {
        float ds = 0.f;  // ds[t] = 0 past the end of the sequence
        if (t < t_last) {
          win[kW - 1] = to_f(xb[static_cast<long long>(t) * x_sr]);
          float s = bd;
          for (int k = 0; k < kW; ++k) s += wk[k] * win[k];
          const float sig = 1.f / (1.f + expf(-s));
          ds = to_f(gb[static_cast<long long>(t) * g_sr]) * sig * (1.f + s * (1.f - sig));
          if (t < t1) {
            for (int k = 0; k < kW; ++k) dwk[k] += ds * win[k];
            dbv += ds;
          }
          for (int k = 0; k < kW - 1; ++k) win[k] = win[k + 1];
        }
        for (int j = 0; j < kW - 1; ++j) dsw[j] = dsw[j + 1];
        dsw[kW - 1] = ds;
        const int te = t - (kW - 1);
        if (te >= t0) {
          float acc = 0.f;
          for (int k = 0; k < kW; ++k) acc += wk[k] * dsw[kW - 1 - k];
          dxb[static_cast<long long>(te) * D] = from_f<T>(acc);
        }
      }
    }
    for (int k = 0; k < kW; ++k) red[k * kBwdChannels + c] = dwk[k];
    red[kW * kBwdChannels + c] = dbv;
  }
}

template <typename T, int VX, int VG>
__global__ void __launch_bounds__(kBwdThreads, 4)
causal_conv1d_silu_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ bias, const T* __restrict__ g,
                              T* __restrict__ dx, float* __restrict__ part, int L, int D,
                              int tile, long long x_sb, long long x_sr, long long g_sb,
                              long long g_sr) {
  __shared__ __align__(16) float red[kWarps][kW + 1][kBwdChannels];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kBwdChannels + lane * kV;
  const int t0 = (blockIdx.z * kWarps + warp) * tile;
  float* slot = &red[warp][0][lane * kV];

  if (d0 + kV <= D && t0 + tile <= L) {
    BwdState st;
#pragma unroll
    for (int c = 0; c < kV; ++c) {
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        st.w[k][c] = w[(d0 + c) * kW + k];
        st.dw[k][c] = 0.f;
      }
      st.bias[c] = bias[d0 + c];
      st.db[c] = 0.f;
    }
    tile_full<T, VX, VG>(st, x + b * x_sb + d0, g + b * g_sb + d0,
                          dx + static_cast<long long>(b) * L * D + d0, static_cast<int>(x_sr),
                          static_cast<int>(g_sr), D, t0, tile, L);
#pragma unroll
    for (int k = 0; k < kW; ++k)
      *reinterpret_cast<float4*>(slot + k * kBwdChannels) =
          make_float4(st.dw[k][0], st.dw[k][1], st.dw[k][2], st.dw[k][3]);
    *reinterpret_cast<float4*>(slot + kW * kBwdChannels) =
        make_float4(st.db[0], st.db[1], st.db[2], st.db[3]);
  } else if (d0 < D && t0 < L) {
    tile_masked(x, w, bias, g, dx, slot, b, d0, min(kV, D - d0), t0, min(t0 + tile, L), L, D,
                x_sb, x_sr, g_sb, g_sr);
  } else {
#pragma unroll
    for (int k = 0; k <= kW; ++k)
      *reinterpret_cast<float4*>(slot + k * kBwdChannels) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the block's partial: its warps' sums in warp order, one channel a thread
  const int d = blockIdx.x * kBwdChannels + threadIdx.x;
  if (d < D) {
    const long long row = static_cast<long long>(b) * gridDim.z + blockIdx.z;
#pragma unroll
    for (int k = 0; k <= kW; ++k) {
      float s = red[0][k][threadIdx.x];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) s += red[i][k][threadIdx.x];
      part[(row * (kW + 1) + k) * D + d] = s;
    }
  }
}

// dw (D, W) and db (D) from the (P, W+1, D) partials: column j of the
// flattened (W+1, D) is summed by 32 lanes' worth of columns a block, rows
// split over kFinishRows warps (row r to warp r % kFinishRows, in row order),
// then the warps' sums in warp order.
__global__ void __launch_bounds__(32 * kFinishRows)
causal_conv1d_silu_bwd_finish(const float* __restrict__ part, float* __restrict__ dw,
                              float* __restrict__ db, int P, int D) {
  __shared__ float red[kFinishRows][32];
  const long long cols = static_cast<long long>(kW + 1) * D;
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (j < cols) {
    for (int r = threadIdx.y; r < P; r += kFinishRows) s += part[r * cols + j];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < cols) {
    float t = red[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kFinishRows; ++i) t += red[i][threadIdx.x];
    const int k = j / D, d = j - k * D;
    if (k < kW) {
      dw[d * kW + k] = t;
    } else {
      db[d] = t;
    }
  }
}

template <int W>
cudaError_t launch(const float* x, const float* w, const float* bias, float* y,
                   int B, int L, int D, long long x_sb, long long x_sr,
                   cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B,
                  (L + kTimeTile - 1) / kTimeTile);
  causal_conv1d_silu_fwd_kernel<W>
      <<<grid, kThreads, 0, stream>>>(x, w, bias, y, L, D, x_sb, x_sr);
  return cudaGetLastError();
}

template <typename T>
struct BwdArgs {
  const T* x;
  const float *w, *bias;
  const T* g;
  T* dx;
  float *dw, *db, *part;
  int B, L, D, tile;
  long long x_sb, x_sr, g_sb, g_sr;
  cudaStream_t stream;
};

inline int time_blocks(int L, int tile) {
  return ((L + tile - 1) / tile + kWarps - 1) / kWarps;
}

template <typename T, int VX, int VG>
cudaError_t launch_bwd(const BwdArgs<T>& a) {
  const int nbt = time_blocks(a.L, a.tile);
  const dim3 grid((a.D + kBwdChannels - 1) / kBwdChannels, a.B, nbt);
  causal_conv1d_silu_bwd_kernel<T, VX, VG><<<grid, kBwdThreads, 0, a.stream>>>(
      a.x, a.w, a.bias, a.g, a.dx, a.part, a.L, a.D, a.tile, a.x_sb, a.x_sr, a.g_sb, a.g_sr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cols = (kW + 1) * a.D;
  causal_conv1d_silu_bwd_finish<<<(cols + 31) / 32, dim3(32, kFinishRows), 0, a.stream>>>(
      a.part, a.dw, a.db, a.B * nbt, a.D);
  return cudaGetLastError();
}

// Whether rows of an operand at p with strides (sb, sr) over n_b batches and
// n_r rows can be moved v elements of `size` bytes at a time: v is 1, 2, 4
// or 8, the base address is (size v)-byte aligned and the strides that are
// used are multiples of v.
bool width_allowed(const void* p, int v, int n_b, long long sb, int n_r, long long sr,
                   unsigned size) {
  if (v != 1 && v != 2 && v != 4 && v != 8) return false;
  if (reinterpret_cast<std::uintptr_t>(p) % (size * v) != 0) return false;
  if (n_b > 1 && sb % v != 0) return false;
  if (n_r > 1 && sr % v != 0) return false;
  return true;
}

template <typename T>
int bwd_entry(const void* x, const void* w, const void* bias, const void* g, void* dx, void* dw,
              void* db, void* part, long long part_numel, int B, int L, int D, int W,
              long long x_sb, long long x_sr, long long g_sb, long long g_sr, int vx, int vg,
              int tile, void* stream) {
  constexpr unsigned size = sizeof(T);
  if (W != kW || B < 1 || L < 1 || D < 1) return cudaErrorInvalidValue;
  if (tile < 2 * kU || tile % kU != 0) return cudaErrorInvalidValue;
  // the tile loop steps by row strides held in 32 bits
  if (x_sr > INT_MAX || g_sr > INT_MAX || x_sr < 0 || g_sr < 0) return cudaErrorInvalidValue;
  if (!width_allowed(x, vx, B, x_sb, L, x_sr, size) ||
      !width_allowed(g, vg, B, g_sb, L, g_sr, size) ||
      !width_allowed(dx, vg, B, static_cast<long long>(L) * D, L, D, size))
    return cudaErrorInvalidValue;
  if (part_numel != static_cast<long long>(B) * time_blocks(L, tile) * (kW + 1) * D)
    return cudaErrorInvalidValue;
  const BwdArgs<T> a{static_cast<const T*>(x), static_cast<const float*>(w),
                     static_cast<const float*>(bias), static_cast<const T*>(g),
                     static_cast<T*>(dx), static_cast<float*>(dw),
                     static_cast<float*>(db), static_cast<float*>(part),
                     B, L, D, tile, x_sb, x_sr, g_sb, g_sr,
                     static_cast<cudaStream_t>(stream)};
  if (vx == 4 && vg == 4) return launch_bwd<T, 4, 4>(a);
  if (vx == 2 && vg == 4) return launch_bwd<T, 2, 4>(a);
  if (vx == 1 && vg == 1) return launch_bwd<T, 1, 1>(a);
  return cudaErrorInvalidValue;  // a pair that is not built
}

}  // namespace

extern "C" {

// x: (B, L, D) fp32 with strides (x_sb, x_sr, 1); w: (D, W) contiguous;
// bias: (D,); y: (B, L, D) contiguous. Returns a cudaError_t code
// (cudaErrorInvalidValue for a W other than 4).
int causal_conv1d_silu_fwd(const void* x, const void* w, const void* bias,
                           void* y, int B, int L, int D, int W, long long x_sb,
                           long long x_sr, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  // width 4 (d_conv) is the only one a ported model uses
  if (W != 4) return cudaErrorInvalidValue;
  return launch<4>(xf, wf, bf, yf, B, L, D, x_sb, x_sr, s);
}

// Backward: two launches, the tiles then the finish of dw and db. x, g:
// (B, L, D) fp32 with strides (x_sb, x_sr, 1) and (g_sb, g_sr, 1); w: (D, W);
// bias: (D,); dx: (B, L, D) contiguous; dw: (D, W) and db: (D,) contiguous;
// part: the (B * time_blocks, W+1, D) partials, part_numel floats, where
// time_blocks = ceil(ceil(L/tile)/4). vx: floats moved at a time from x;
// vg: from g and to dx; (vx, vg) is (4, 4), (2, 4) or (1, 1). tile: the time
// tile, a multiple of 4 and at least 8. Returns a cudaError_t code:
// cudaErrorInvalidValue for a W other than 4, a width that an operand's
// alignment does not allow, another pair of widths, a bad tile, a row stride
// outside 0 .. INT_MAX or partials of another size.
int causal_conv1d_silu_bwd(const void* x, const void* w, const void* bias,
                           const void* g, void* dx, void* dw, void* db, void* part,
                           long long part_numel, int B, int L, int D, int W,
                           long long x_sb, long long x_sr, long long g_sb,
                           long long g_sr, int vx, int vg, int tile, void* stream) {
  return bwd_entry<float>(x, w, bias, g, dx, dw, db, part, part_numel, B, L, D, W, x_sb, x_sr,
                          g_sb, g_sr, vx, vg, tile, stream);
}

// bf16 forward: x (B, L, D) bf16 with strides (x_sb, x_sr, 1), w (D, W) and
// bias (D,) fp32, y (B, L, D) bf16 contiguous. vec: 8 (channels moved as one
// 16-byte vector; needs D % 8 == 0, x 16-byte aligned and x_sb, x_sr
// multiples of 8) or 1. Returns a cudaError_t code (cudaErrorInvalidValue
// for a W other than 4 or a vec that x does not allow).
int causal_conv1d_silu_fwd_bf16(const void* x, const void* w, const void* bias, void* y,
                                int B, int L, int D, int W, long long x_sb, long long x_sr,
                                int vec, void* stream) {
  if (W != 4 || B < 1 || L < 1 || D < 1) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* yb = static_cast<bf16*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const int time_blocks = ((L + kFwdTile16 - 1) / kFwdTile16 + kFwdWarps - 1) / kFwdWarps;
  if (vec == kV16) {
    if (D % kV16 != 0 || !width_allowed(x, kV16, B, x_sb, L, x_sr, 2))
      return cudaErrorInvalidValue;
    const dim3 grid((D / kV16 + 31) / 32, B, time_blocks);
    causal_conv1d_silu_fwd_bf16_kernel<kV16>
        <<<grid, 32 * kFwdWarps, 0, s>>>(xb, wf, bf, yb, L, D, x_sb, x_sr);
  } else if (vec == 1) {
    const dim3 grid((D + 31) / 32, B, time_blocks);
    causal_conv1d_silu_fwd_bf16_kernel<1>
        <<<grid, 32 * kFwdWarps, 0, s>>>(xb, wf, bf, yb, L, D, x_sb, x_sr);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// bf16 backward: causal_conv1d_silu_bwd's arguments with x, g and dx bf16
// (w, bias, dw, db and part fp32); vx and vg count bf16 elements, so (4, 4)
// moves 8 bytes a thread.
int causal_conv1d_silu_bwd_bf16(const void* x, const void* w, const void* bias,
                                const void* g, void* dx, void* dw, void* db, void* part,
                                long long part_numel, int B, int L, int D, int W,
                                long long x_sb, long long x_sr, long long g_sb,
                                long long g_sr, int vx, int vg, int tile, void* stream) {
  return bwd_entry<bf16>(x, w, bias, g, dx, dw, db, part, part_numel, B, L, D, W, x_sb, x_sr,
                         g_sb, g_sr, vx, vg, tile, stream);
}

const char* causal_conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
