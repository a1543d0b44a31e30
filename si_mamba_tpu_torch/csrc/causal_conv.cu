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
// y: 2 x 50.3 MB per layer at B=32, L=512, D=768 in fp32 (about 30 us at
// 3.35 TB/s), half that in bf16 (about 15 us). The 2W+5 operations per
// output take a third of the fp32 byte time in instruction slots and most
// of the bf16 one, so the loads have to be in flight while others compute.
//
// Design (W = 4 only; one template over the element type T of x and y and
// the vector width V):
// - A thread owns V neighbouring channels and one time tile of kTile = 8 or
//   4 steps, from the wrapper's plan. It moves its V elements of x and y as
//   one access of 8 or 4 bytes (V = 2 or 1 at fp32, 4 or 2 at bf16), or one
//   bf16 element where x allows nothing wider: the plan takes the widest that
//   x's address and strides and D allow, and the C entry point refuses a
//   wider one. So the SSD view (row stride 1798, column 768) moves two bf16
//   channels a thread, not one. 16-byte accesses were slower at every path
//   shape (eight bf16 channels a thread held twice the registers and took
//   1.35x the time of four at the Mamba-1 view; four fp32 channels 2-4 %
//   more than two), so 8 bytes is the widest built.
// - Loads in flight: the thread issues the loads of all kTile + W - 1 rows
//   of its tile (the W - 1 halo rows before it included) into registers
//   before its first multiply-add, so a tile's whole input is in flight at
//   once; bf16 rows stay packed until used. Neighbouring tiles read the same
//   halo rows at about the same time, so those come mostly from L2.
// - Parallelism from the SM count: the threads of one batch row are the
//   (channel vector, tile) pairs, channel vector fastest, so a warp's access
//   to a row is contiguous whatever D is; the grid is (ceil(pairs / block),
//   B). The plan takes the longest tile that still gives the card enough
//   warps, and blocks of 1, 2 or 4 warps so that one cloud still spreads
//   over every SM.
// - The sum is the TPU kernel's: bias, then the taps oldest first, in fp32;
//   y is rounded once to T. fp32 keeps expf and the IEEE division (no fast
//   math, parity with the reference implementations); bf16 takes
//   __fdividef(s, 1 + __expf(-s)) (a fast exp, an approximate reciprocal and
//   a multiply: a few fp32 ulps, far below the bf16 rounding of y; 0 where
//   1 + exp(-s) passes 2^126, where silu is below 1e-36), which took 0.76-0.86x
//   the time of an IEEE reciprocal at the bf16 path shapes.
// - x may be a column slice of a wider buffer (the mixers' xz and in_proj
//   output): the kernel takes x's batch and row strides and needs unit stride
//   only along channels. No padding of L: the ragged tile is masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no fast math).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "elem.cuh"

namespace {

constexpr int kW = 4;             // the conv width both directions serve
constexpr int kFwdMaxWarps = 4;   // warps a forward block, at most

// V elements of T in 32-bit words, as one access of V * sizeof(T) bytes
// (bf16 V = 1: the low 16 bits of one word), at most 16 bytes. Loaded
// packed; element c is widened to fp32 when it is read.
template <typename T, int V>
struct Vec {
  static constexpr int kBytes = V * static_cast<int>(sizeof(T));
  static constexpr int kWords = (kBytes + 3) / 4;
  unsigned int w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    } else if constexpr (kBytes == 8) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = a.x; w[1] = a.y;
    } else if constexpr (kBytes == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }

  __device__ __forceinline__ float get(int c) const {
    if constexpr (std::is_same_v<T, float>) {
      return __uint_as_float(w[c]);
    } else if constexpr (V == 1) {
      return bf16_lo(w[0]);
    } else {
      return (c & 1) ? bf16_hi(w[c >> 1]) : bf16_lo(w[c >> 1]);
    }
  }
};

// V values rounded to T and stored as one access of at most 8 bytes.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *p = v[0];
    }
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<unsigned int*>(p) = pack_bf16(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <typename T>
__device__ __forceinline__ float silu(float s) {
  if constexpr (std::is_same_v<T, float>) {
    return s / (1.f + expf(-s));
  } else {
    return __fdividef(s, 1.f + __expf(-s));
  }
}

// Thread i of batch row blockIdx.y owns channels d0 = (i % nv) V .. d0 + V - 1
// over the time tile i / nv; nv = D / V, and V divides D and x's used strides
// (the C entry point checks).
template <typename T, int V, int kTile>
__global__ void __launch_bounds__(32 * kFwdMaxWarps)
causal_conv1d_silu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ bias, T* __restrict__ y, int L, int D,
                              int nv, int pairs, long long x_sb, long long x_sr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const int tile = i / nv;
  const int d0 = (i - tile * nv) * V;
  const int t0 = tile * kTile;
  const T* xp = x + blockIdx.y * x_sb + d0;
  T* yp = y + (static_cast<long long>(blockIdx.y) * L + t0) * D + d0;

  // rows[j] = x[t0 - (W-1) + j], zero before the sequence and past its end
  Vec<T, V> rows[kTile + kW - 1];
#pragma unroll
  for (int j = 0; j < kTile + kW - 1; ++j) {
    const int t = t0 - (kW - 1) + j;
    if (t >= 0 && t < L) {
      rows[j].load(xp + t * x_sr);
    } else {
      rows[j].zero();
    }
  }
  // the taps: one 16-byte load a channel (w is (D, W) with W = 4, 16-byte
  // aligned); the biases as one access of V floats
  float wk[kW][V], bd[V];
  Vec<float, V> bv;
  bv.load(bias + d0);
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(w) + d0 + c);
    wk[0][c] = t.x;
    wk[1][c] = t.y;
    wk[2][c] = t.z;
    wk[3][c] = t.w;
    bd[c] = bv.get(c);
  }
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (t0 + j < L) {
      float out[V];
#pragma unroll
      for (int c = 0; c < V; ++c) {
        // the TPU kernel's summation order: bias, then taps oldest first
        float s = bd[c];
#pragma unroll
        for (int k = 0; k < kW; ++k) s += wk[k][c] * rows[j + k].get(c);
        out[c] = silu<T>(s);
      }
      store_vec<T, V>(yp + static_cast<long long>(j) * D, out);
    }
  }
}

template <typename T, int V>
cudaError_t launch_fwd(const T* x, const float* w, const float* bias, T* y, int B, int L, int D,
                       long long x_sb, long long x_sr, int tile, int warps, cudaStream_t s) {
  const int nv = D / V;
  const int pairs = nv * ((L + tile - 1) / tile);
  const int threads = 32 * warps;
  const dim3 grid((pairs + threads - 1) / threads, B);
  if (tile == 8) {
    causal_conv1d_silu_fwd_kernel<T, V, 8>
        <<<grid, threads, 0, s>>>(x, w, bias, y, L, D, nv, pairs, x_sb, x_sr);
  } else {
    causal_conv1d_silu_fwd_kernel<T, V, 4>
        <<<grid, threads, 0, s>>>(x, w, bias, y, L, D, nv, pairs, x_sb, x_sr);
  }
  return cudaGetLastError();
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
int fwd_entry(const void* x, const void* w, const void* bias, void* y, int B, int L, int D, int W,
              long long x_sb, long long x_sr, int vec, int tile, int warps, void* stream) {
  constexpr unsigned size = sizeof(T);
  if (W != kW || B < 1 || B > 65535 || L < 1 || D < 1) return cudaErrorInvalidValue;
  if (tile != 4 && tile != 8) return cudaErrorInvalidValue;
  if (warps != 1 && warps != 2 && warps != 4) return cudaErrorInvalidValue;
  // w and bias are read 16 bytes at a time at most
  if (reinterpret_cast<std::uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(bias) % 16 != 0)
    return cudaErrorInvalidValue;
  // one access is 8 bytes at most; V divides D, and x's and y's used strides
  if (!width_allowed(x, vec, B, x_sb, L, x_sr, size) || vec * size > 8 || D % vec != 0 ||
      !width_allowed(y, vec, B, static_cast<long long>(L) * D, L, D, size))
    return cudaErrorInvalidValue;
  if (static_cast<long long>(D / vec) * ((L + tile - 1) / tile) > INT_MAX - 32 * kFwdMaxWarps)
    return cudaErrorInvalidValue;
  const auto* xt = static_cast<const T*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* yt = static_cast<T*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (size == 2) {
    if (vec == 4) return launch_fwd<T, 4>(xt, wf, bf, yt, B, L, D, x_sb, x_sr, tile, warps, s);
  }
  if (vec == 2) return launch_fwd<T, 2>(xt, wf, bf, yt, B, L, D, x_sb, x_sr, tile, warps, s);
  return launch_fwd<T, 1>(xt, wf, bf, yt, B, L, D, x_sb, x_sr, tile, warps, s);
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

// Forward: x (B, L, D) fp32 with strides (x_sb, x_sr, 1); w (D, W) and
// bias (D,) fp32 contiguous and 16-byte aligned; y (B, L, D) contiguous. The
// plan: vec channels a thread, moved as one access (2 or 1; x's and y's
// address and used strides and D multiples of it), a time tile of 8 or 4
// steps, blocks of 4, 2 or 1 warps. Returns a cudaError_t code: cudaErrorInvalidValue for
// a W other than 4, B above 65535, or a plan that is not built or that the
// operands' alignment does not allow.
int causal_conv1d_silu_fwd(const void* x, const void* w, const void* bias, void* y, int B,
                           int L, int D, int W, long long x_sb, long long x_sr, int vec,
                           int tile, int warps, void* stream) {
  return fwd_entry<float>(x, w, bias, y, B, L, D, W, x_sb, x_sr, vec, tile, warps, stream);
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

// bf16 forward: causal_conv1d_silu_fwd's arguments with x and y bf16 (w and
// bias fp32); vec counts bf16 elements: 4, 2 or 1.
int causal_conv1d_silu_fwd_bf16(const void* x, const void* w, const void* bias, void* y, int B,
                                int L, int D, int W, long long x_sb, long long x_sr, int vec,
                                int tile, int warps, void* stream) {
  return fwd_entry<bf16>(x, w, bias, y, B, L, D, W, x_sb, x_sr, vec, tile, warps, stream);
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
