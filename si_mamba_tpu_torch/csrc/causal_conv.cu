// Depthwise causal width-W convolution + bias + SiLU, forward and backward,
// fp32.
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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (no fast math: expf keeps parity with the
//        reference implementations).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

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
constexpr int kW = 4;                      // the conv width this body serves
constexpr int kV = 4;                      // channels a thread
constexpr int kU = 4;                      // rows of x and g in flight a thread
constexpr int kWarps = 4;                  // warps (time tiles) a block
constexpr int kBwdThreads = 32 * kWarps;
constexpr int kBwdChannels = 32 * kV;      // channels a block
constexpr int kFinishRows = 8;             // partial rows summed in parallel

template <int V>
__device__ __forceinline__ void load_row(const float* p, float (&v)[kV]) {
  if constexpr (V == 4) {
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

template <int V>
__device__ __forceinline__ void store_row(float* p, const float (&v)[kV]) {
  if constexpr (V == 4) {
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
template <int VX, int VG>
__device__ __forceinline__ void tile_full(BwdState& st, const float* __restrict__ xp,
                                          const float* __restrict__ gp, float* __restrict__ op,
                                          int x_sr, int g_sr, int o_sr,
                                          int t0, int T, int L) {
  const int ahead = L - t0 - T;  // rows past the tile within L
#pragma unroll
  for (int k = 0; k < kW - 1; ++k) {
    const int t = t0 - (kW - 1) + k;
    if (t >= 0) {
      load_row<VX>(xp + static_cast<long long>(t) * x_sr, st.win[k]);
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
  const float* xq = xp + static_cast<long long>(t0) * x_sr;  // next row to load
  const float* gq = gp + static_cast<long long>(t0) * g_sr;
  float* oq = op + static_cast<long long>(t0) * o_sr;        // next dx row
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    load_row<VX>(xq, xr[u]);
    load_row<VG>(gq, gr[u]);
    xq += x_sr;
    gq += g_sr;
  }

  // first chunk: dx from its (W-1)-th step on
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    st.step<true>(xr[u], gr[u], true, dxo);
    load_row<VX>(xq, xr[u]);
    load_row<VG>(gq, gr[u]);
    xq += x_sr;
    gq += g_sr;
    if (u >= kW - 1) {
      store_row<VG>(oq, dxo);
      oq += o_sr;
    }
  }
  // the steady chunks: no branch
  const int chunks = T / kU;
  for (int ch = 1; ch < chunks - 1; ++ch) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      st.step<true>(xr[u], gr[u], true, dxo);
      load_row<VX>(xq, xr[u]);
      load_row<VG>(gq, gr[u]);
      xq += x_sr;
      gq += g_sr;
      store_row<VG>(oq, dxo);
      oq += o_sr;
    }
  }
  // last chunk: its refills are the W-1 look-ahead rows, within L
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    st.step<true>(xr[u], gr[u], true, dxo);
    if (u < kW - 1 && u < ahead) {
      load_row<VX>(xq, xr[u]);
      load_row<VG>(gq, gr[u]);
    }
    xq += x_sr;
    gq += g_sr;
    store_row<VG>(oq, dxo);
    oq += o_sr;
  }
  // the look-ahead steps: ds past L is 0; no sums
#pragma unroll
  for (int u = 0; u < kW - 1; ++u) {
    st.step<false>(xr[u], gr[u], u < ahead, dxo);
    store_row<VG>(oq, dxo);
    oq += o_sr;
  }
}

// The edge: channels d0 .. d0 + nvalid - 1 (nvalid <= kV) over steps
// [t0, t1), scalar, with per-step guards; the dw/db sums go to red[k *
// kBwdChannels + c] (zeros for the channels past D).
__device__ __noinline__ void tile_masked(const float* __restrict__ x, const float* __restrict__ w,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ g, float* __restrict__ dx,
                                         float* red, int b, int d0, int nvalid, int t0, int t1,
                                         int L, int D, long long x_sb, long long x_sr,
                                         long long g_sb, long long g_sr) {
  const int t_last = min(t1 + kW - 1, L);  // ds is needed up to t1+W-2
  for (int c = 0; c < kV; ++c) {
    float dwk[kW] = {0.f, 0.f, 0.f, 0.f};
    float dbv = 0.f;
    if (c < nvalid) {
      const int d = d0 + c;
      const float* xb = x + static_cast<long long>(b) * x_sb + d;
      const float* gb = g + static_cast<long long>(b) * g_sb + d;
      float* dxb = dx + static_cast<long long>(b) * L * D + d;
      float wk[kW];
      for (int k = 0; k < kW; ++k) wk[k] = w[d * kW + k];
      const float bd = bias[d];
      float win[kW];  // win[k] = x[t - (W-1) + k]
      for (int k = 0; k < kW - 1; ++k) {
        const int t = t0 - (kW - 1) + k;
        win[k] = t >= 0 ? xb[static_cast<long long>(t) * x_sr] : 0.f;
      }
      float dsw[kW] = {0.f, 0.f, 0.f, 0.f};  // dsw[j] = ds[t - (W-1) + j]
      for (int t = t0; t < t1 + kW - 1; ++t) {
        float ds = 0.f;  // ds[t] = 0 past the end of the sequence
        if (t < t_last) {
          win[kW - 1] = xb[static_cast<long long>(t) * x_sr];
          float s = bd;
          for (int k = 0; k < kW; ++k) s += wk[k] * win[k];
          const float sig = 1.f / (1.f + expf(-s));
          ds = gb[static_cast<long long>(t) * g_sr] * sig * (1.f + s * (1.f - sig));
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
          dxb[static_cast<long long>(te) * D] = acc;
        }
      }
    }
    for (int k = 0; k < kW; ++k) red[k * kBwdChannels + c] = dwk[k];
    red[kW * kBwdChannels + c] = dbv;
  }
}

template <int VX, int VG>
__global__ void __launch_bounds__(kBwdThreads, 4)
causal_conv1d_silu_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ bias, const float* __restrict__ g,
                              float* __restrict__ dx, float* __restrict__ part, int L, int D,
                              int T, long long x_sb, long long x_sr, long long g_sb,
                              long long g_sr) {
  __shared__ __align__(16) float red[kWarps][kW + 1][kBwdChannels];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kBwdChannels + lane * kV;
  const int t0 = (blockIdx.z * kWarps + warp) * T;
  float* slot = &red[warp][0][lane * kV];

  if (d0 + kV <= D && t0 + T <= L) {
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
    tile_full<VX, VG>(st, x + b * x_sb + d0, g + b * g_sb + d0,
                          dx + static_cast<long long>(b) * L * D + d0, static_cast<int>(x_sr),
                          static_cast<int>(g_sr), D, t0, T, L);
#pragma unroll
    for (int k = 0; k < kW; ++k)
      *reinterpret_cast<float4*>(slot + k * kBwdChannels) =
          make_float4(st.dw[k][0], st.dw[k][1], st.dw[k][2], st.dw[k][3]);
    *reinterpret_cast<float4*>(slot + kW * kBwdChannels) =
        make_float4(st.db[0], st.db[1], st.db[2], st.db[3]);
  } else if (d0 < D && t0 < L) {
    tile_masked(x, w, bias, g, dx, slot, b, d0, min(kV, D - d0), t0, min(t0 + T, L), L, D,
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

struct BwdArgs {
  const float *x, *w, *bias, *g;
  float *dx, *dw, *db, *part;
  int B, L, D, T;
  long long x_sb, x_sr, g_sb, g_sr;
  cudaStream_t stream;
};

inline int time_blocks(int L, int T) { return ((L + T - 1) / T + kWarps - 1) / kWarps; }

template <int VX, int VG>
cudaError_t launch_bwd(const BwdArgs& a) {
  const int nbt = time_blocks(a.L, a.T);
  const dim3 grid((a.D + kBwdChannels - 1) / kBwdChannels, a.B, nbt);
  causal_conv1d_silu_bwd_kernel<VX, VG><<<grid, kBwdThreads, 0, a.stream>>>(
      a.x, a.w, a.bias, a.g, a.dx, a.part, a.L, a.D, a.T, a.x_sb, a.x_sr, a.g_sb, a.g_sr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cols = (kW + 1) * a.D;
  causal_conv1d_silu_bwd_finish<<<(cols + 31) / 32, dim3(32, kFinishRows), 0, a.stream>>>(
      a.part, a.dw, a.db, a.B * nbt, a.D);
  return cudaGetLastError();
}

// Whether kV-float rows of an operand at p with strides (sb, sr) over n_b
// batches and n_r rows can be moved v floats at a time: v is 1, 2 or 4, the
// base address is 4v-byte aligned and the strides that are used are
// multiples of v.
bool width_allowed(const void* p, int v, int n_b, long long sb, int n_r, long long sr) {
  if (v != 1 && v != 2 && v != 4) return false;
  if (reinterpret_cast<std::uintptr_t>(p) % (4u * v) != 0) return false;
  if (n_b > 1 && sb % v != 0) return false;
  if (n_r > 1 && sr % v != 0) return false;
  return true;
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
  if (W != kW || B < 1 || L < 1 || D < 1) return cudaErrorInvalidValue;
  if (tile < 2 * kU || tile % kU != 0) return cudaErrorInvalidValue;
  // the tile loop steps by row strides held in 32 bits
  if (x_sr > INT_MAX || g_sr > INT_MAX || x_sr < 0 || g_sr < 0) return cudaErrorInvalidValue;
  if (!width_allowed(x, vx, B, x_sb, L, x_sr) || !width_allowed(g, vg, B, g_sb, L, g_sr) ||
      !width_allowed(dx, vg, B, static_cast<long long>(L) * D, L, D))
    return cudaErrorInvalidValue;
  if (part_numel != static_cast<long long>(B) * time_blocks(L, tile) * (kW + 1) * D)
    return cudaErrorInvalidValue;
  const BwdArgs a{static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(bias), static_cast<const float*>(g),
                  static_cast<float*>(dx), static_cast<float*>(dw),
                  static_cast<float*>(db), static_cast<float*>(part),
                  B, L, D, tile, x_sb, x_sr, g_sb, g_sr,
                  static_cast<cudaStream_t>(stream)};
  if (vx == 4 && vg == 4) return launch_bwd<4, 4>(a);
  if (vx == 2 && vg == 4) return launch_bwd<2, 4>(a);
  if (vx == 1 && vg == 1) return launch_bwd<1, 1>(a);
  return cudaErrorInvalidValue;  // a pair that is not built
}

const char* causal_conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
