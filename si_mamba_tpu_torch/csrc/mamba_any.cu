// The Mamba-1 kernels at the shapes the tuned ones are not built for, fp32 or
// bf16: the causal conv + SiLU at any width W (K1, K5), the selective scan at
// any d_state N (K2, K3, K4), and the whole mixer interior (K10, K11) at any
// d_inner that is a multiple of 128, any d_state up to 32, any conv width
// and any x_proj width. The tuned kernels (causal_conv.cu at W = 4,
// selective_scan_{fwd,bwd}.cu at N = 16, fused_mixer_{fwd,bwd}.cu at N = 16,
// W = 4, d_inner <= 1024 and dt_rank + 2N <= 64) keep their shapes; the
// wrappers pick these variants by shape, before the launch.
//
// Replaces, at those shapes, the same TPU kernels as the tuned ones:
// `_fwd_kernel` and `_bwd_kernel` of si_mamba_tpu/ops/pallas/
// causal_conv_kernel.py (any W: `_conv_s`, `Wp`), `_fwd_kernel` and
// `_bwd_kernel` of selective_scan_kernel.py (any n), and `_fwd_kernel` and
// `_bwd_kernel` of fused_mixer_kernel.py (d_inner % 128 == 0, d_state <= 32,
// any W and x_proj width).
//
// Bounds on the H100, as the tuned kernels': bytes for the conv (one read of
// x, one write of y; x, g and dx for the backward), instruction throughput
// for the scan (B L d n decays and their fmas), operations for the mixer's
// projections. These variants are built to be right for every shape first;
// each is simple:
//
// Conv (any W). Forward: a thread owns one channel and a tile of 16 steps and
// sums bias, then the W taps oldest first (the tuned kernel's order), reading
// x through L1. Backward, three launches: ds = g silu'(s) into an fp32
// scratch (B, L, D); then a thread owns a channel and a tile of 64 steps,
// writes dx[t] = sum_k w[k] ds[t + W - 1 - k] (k ascending, as the tuned
// kernel) and its tile's partial of dw and db, (W + 1, D) a tile, no padding
// of W; a third launch sums the partials in a fixed order. No atomics.
// The weight is addressed with a channel and a tap stride, so the mixer's
// (W, d) layout and the conv's (d, W) one both serve.
//
// Scan (any N). One warp a block, one channel a lane, grid (B, ceil(d/32)).
// The states, the decay rates A log2 e and each 16-step tile's B and C live
// in shared memory (384 N bytes a block forward, 768 N backward), so N is a
// runtime count; above kMaxState, where the backward's would pass the 227 KB
// a block can have, the same arrays live in a per-block slice of a global
// workspace that the caller gives (scan_any_workspace_floats), with the same
// arithmetic in the same order. The forward walks the tiles in order, writes y and, for
// training, the state entering every tile, h_entries (B, ceil(L/16), N, d),
// the tuned kernels' layout. The backward walks the tiles in reverse: it
// rebuilds the tile's 16 states of each channel from h_entries into a
// per-block global scratch (B, ceil(d/32), 16, N, 32), a lane reading back
// only what it wrote, then steps back with dh and dA in shared memory. Each
// step's dB_t and dC_t terms (2N a lane) go through shared memory and are
// summed over the warp's 32 channels in lane order, into per-block partials
// (B, ceil(d/32), L, N) that the wrapper sums. The arithmetic is the tuned
// kernels': softplus v > 20 ? v : log1pf(expf(v)), the decay
// ex2.approx.ftz(delta A log2 e), dz from y_pre rounded to the activation
// type. Every sum runs in a fixed order: two runs are bitwise equal.
//
// Mixer (any shape). The interior through global memory, in one C call a
// direction: xi = silu(conv(x)) (the conv above, fp32 out), x_dbl = xi x_proj
// and dt_raw = dt_low dt_proj by a tiled fp32 product kernel (32 x 32 tiles,
// k ascending), then the scan above with u = xi, the B and C columns of
// x_dbl and z of xz. The backward recomputes the three, runs the scan
// backward (dz straight into dxz), sums dB and dC over the channel blocks
// into [d_dtlow | dB | dC], forms d_dtlow = ddt_raw dt_proj^T and dxi = du +
// [..] x_proj^T with the product kernel, runs the conv backward (dx straight
// into dxz) and the two weight products d x_proj = xi^T [..] and d dt_proj =
// dt_low^T ddt_raw. x_dbl is reduced over channels through global memory,
// where the tuned kernels exchange partials in a thread-block cluster (at
// most 8 blocks, d_inner 1024). The dA, dD and ddt_b partials are summed by
// the wrapper. At bf16 xz, g, y and dxz are bf16 and everything else fp32,
// as the tuned kernels keep them (no rounding of xi, x_dbl or y_pre).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_runtime.h>

#include <type_traits>

#include "elem.cuh"

namespace {

constexpr int kConvTile = 16;       // steps a forward thread
constexpr int kConvBwdTile = 64;    // steps a backward thread (a dw/db partial row)
constexpr int kConvThreads = 128;   // channels a conv block
constexpr int kChunk = 16;          // steps a scan tile; h_entries has one state a tile
constexpr int kLanes = 32;          // channels a scan block
constexpr int kMaxState = 256;      // the largest N whose scan arrays sit in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// silu(s): the IEEE division, or at the bf16 conv a fast exp and an
// approximate division, as causal_conv.cu's K1 takes them
template <bool kFast>
__device__ __forceinline__ float silu(float s) {
  if constexpr (kFast) {
    return __fdividef(s, 1.f + __expf(-s));
  } else {
    return s / (1.f + expf(-s));
  }
}

__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// the conv at any width
// ---------------------------------------------------------------------------

struct ConvGeom {
  int B, L, D, W;
  long long x_sb, x_sr;  // x's batch and row strides (unit along channels)
  long long w_sd, w_sk;  // the weight's channel and tap strides
};

template <typename TX, typename TY, bool kFast>
__global__ void __launch_bounds__(kConvThreads)
conv_any_fwd(const TX* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, TY* __restrict__ y, ConvGeom g, long long y_sb,
             long long y_sr) {
  const int d = blockIdx.x * kConvThreads + threadIdx.x;
  if (d >= g.D) return;
  const int b = blockIdx.z, t0 = blockIdx.y * kConvTile;
  const TX* xp = x + b * g.x_sb + d;
  const float* wd = w + d * g.w_sd;
  const float bd = bias[d];
  for (int j = 0; j < kConvTile; ++j) {
    const int t = t0 + j;
    if (t >= g.L) break;
    float s = bd;  // bias, then the taps oldest first
    for (int k = 0; k < g.W; ++k) {
      const int tt = t - (g.W - 1) + k;
      if (tt >= 0) s += wd[k * g.w_sk] * to_f(xp[tt * g.x_sr]);
    }
    y[b * y_sb + t * y_sr + d] = from_f<TY>(silu<kFast>(s));
  }
}

// ds = g * silu'(s) into the fp32 scratch (B, L, D)
template <typename TX, typename TG>
__global__ void __launch_bounds__(kConvThreads)
conv_any_ds(const TX* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, const TG* __restrict__ gr, float* __restrict__ ds,
            ConvGeom g, long long g_sb, long long g_sr) {
  const int d = blockIdx.x * kConvThreads + threadIdx.x;
  if (d >= g.D) return;
  const int b = blockIdx.z, t0 = blockIdx.y * kConvTile;
  const TX* xp = x + b * g.x_sb + d;
  const float* wd = w + d * g.w_sd;
  const float bd = bias[d];
  for (int j = 0; j < kConvTile; ++j) {
    const int t = t0 + j;
    if (t >= g.L) break;
    float s = bd;
    for (int k = 0; k < g.W; ++k) {
      const int tt = t - (g.W - 1) + k;
      if (tt >= 0) s += wd[k * g.w_sk] * to_f(xp[tt * g.x_sr]);
    }
    const float sig = 1.f / (1.f + expf(-s));
    ds[(static_cast<long long>(b) * g.L + t) * g.D + d] =
        to_f(gr[b * g_sb + t * g_sr + d]) * sig * (1.f + s * (1.f - sig));
  }
}

// dx of a thread's tile and its partial row (W + 1, D) of dw and db
template <typename TX, typename TD>
__global__ void __launch_bounds__(kConvThreads)
conv_any_dx(const TX* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ ds, TD* __restrict__ dx, float* __restrict__ part,
            ConvGeom g, long long dx_sb, long long dx_sr) {
  const int d = blockIdx.x * kConvThreads + threadIdx.x;
  if (d >= g.D) return;
  const int b = blockIdx.z, tile = blockIdx.y, t0 = tile * kConvBwdTile;
  const int t1 = min(t0 + kConvBwdTile, g.L);
  const float* dsb = ds + static_cast<long long>(b) * g.L * g.D + d;
  const float* wd = w + d * g.w_sd;
  const TX* xp = x + b * g.x_sb + d;
  for (int t = t0; t < t1; ++t) {
    float acc = 0.f;  // dx[t] = sum_k w[k] ds[t + W - 1 - k], k ascending
    for (int k = 0; k < g.W; ++k) {
      const int tt = t + g.W - 1 - k;
      if (tt < g.L) acc += wd[k * g.w_sk] * dsb[static_cast<long long>(tt) * g.D];
    }
    dx[b * dx_sb + t * dx_sr + d] = from_f<TD>(acc);
  }
  float* row = part + (static_cast<long long>(b) * gridDim.y + tile) * (g.W + 1) * g.D + d;
  for (int k = 0; k < g.W; ++k) {
    float s = 0.f;
    for (int t = t0; t < t1; ++t) {
      const int tt = t - (g.W - 1) + k;
      if (tt >= 0) s += dsb[static_cast<long long>(t) * g.D] * to_f(xp[tt * g.x_sr]);
    }
    row[static_cast<long long>(k) * g.D] = s;
  }
  float s = 0.f;
  for (int t = t0; t < t1; ++t) s += dsb[static_cast<long long>(t) * g.D];
  row[static_cast<long long>(g.W) * g.D] = s;
}

// dw (addressed by the weight's strides) and db from the (P, W + 1, D)
// partials, each element's rows summed in order
__global__ void __launch_bounds__(256)
conv_any_finish(const float* __restrict__ part, float* __restrict__ dw, float* __restrict__ db,
                int P, ConvGeom g) {
  const long long cols = static_cast<long long>(g.W + 1) * g.D;
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float s = 0.f;
  for (int r = 0; r < P; ++r) s += part[r * cols + j];
  const int k = static_cast<int>(j / g.D), d = static_cast<int>(j % g.D);
  if (k < g.W) {
    dw[d * g.w_sd + k * g.w_sk] = s;
  } else {
    db[d] = s;
  }
}

template <typename TX, typename TY, bool kFast>
cudaError_t conv_fwd(const TX* x, const float* w, const float* bias, TY* y, const ConvGeom& g,
                     long long y_sb, long long y_sr, cudaStream_t s) {
  const dim3 grid((g.D + kConvThreads - 1) / kConvThreads, (g.L + kConvTile - 1) / kConvTile,
                  g.B);
  conv_any_fwd<TX, TY, kFast><<<grid, kConvThreads, 0, s>>>(x, w, bias, y, g, y_sb, y_sr);
  return cudaGetLastError();
}

long long conv_part_floats(const ConvGeom& g) {
  return static_cast<long long>(g.B) * ((g.L + kConvBwdTile - 1) / kConvBwdTile) * (g.W + 1) *
         g.D;
}

// ds, dx + partials, finish: three launches; ds (B, L, D) and part
// (conv_part_floats) are fp32 scratch
template <typename TX, typename TG, typename TD>
cudaError_t conv_bwd(const TX* x, const float* w, const float* bias, const TG* gr, TD* dx,
                     float* dw, float* db, float* ds, float* part, const ConvGeom& g,
                     long long g_sb, long long g_sr, long long dx_sb, long long dx_sr,
                     cudaStream_t s) {
  const int cb = (g.D + kConvThreads - 1) / kConvThreads;
  conv_any_ds<TX, TG><<<dim3(cb, (g.L + kConvTile - 1) / kConvTile, g.B), kConvThreads, 0, s>>>(
      x, w, bias, gr, ds, g, g_sb, g_sr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (g.L + kConvBwdTile - 1) / kConvBwdTile;
  conv_any_dx<TX, TD><<<dim3(cb, tiles, g.B), kConvThreads, 0, s>>>(x, w, ds, dx, part, g,
                                                                    dx_sb, dx_sr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long cols = static_cast<long long>(g.W + 1) * g.D;
  conv_any_finish<<<static_cast<unsigned>((cols + 255) / 256), 256, 0, s>>>(part, dw, db,
                                                                            g.B * tiles, g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the scan at any d_state
// ---------------------------------------------------------------------------

// TA: u, dt, B, C, du, ddt; TZ: z, y, g, dz. A is given transposed, at (N, D).
template <typename TA, typename TZ>
struct ScanArgs {
  const TA *u, *dt;
  const float* at;
  const TA *Bm, *Cm;
  const float* Dp;
  const TZ* z;
  const float* dtb;
  TZ* y;             // (B, L, D) contiguous
  float* h_entries;  // (B, ceil(L/16), N, D), or null
  const TZ* g;
  TA *du, *ddt;      // (B, L, D) contiguous
  TZ* dz;
  float *dB_part, *dC_part, *dA_part, *dD_part, *ddtb_part, *st;
  float* ws;  // the per-block arrays above kMaxState (else null: shared memory)
  int L, D, N;
  long long u_sb, u_sr, dt_sb, dt_sr, B_sb, B_sr, C_sb, C_sr, z_sb, z_sr, g_sb, g_sr, dz_sb,
      dz_sr;
};

// floats of a block's arrays: states, A log2 e, the tile's B and C (forward);
// A log2 e, dh, dA, B, C and the step's dB | dC terms (backward)
__host__ __device__ inline long long scan_fwd_floats(int N) {
  return 2LL * N * kLanes + 2LL * kChunk * N;
}
__host__ __device__ inline long long scan_bwd_floats(int N) {
  return 3LL * N * kLanes + 2LL * kChunk * N + 2LL * N * kLanes;
}

// this block's arrays: dynamic shared memory, or (kGlobal, its own
// instantiation, so that the shared one keeps shared-memory addressing) its
// slice of the workspace
template <bool kGlobal>
__device__ __forceinline__ float* block_arrays(float* smem, float* ws, long long floats) {
  if constexpr (kGlobal) {
    return ws + (static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y) * floats;
  } else {
    return smem;
  }
}

// the tile's B and C, [16][N] each, zeros past L
template <typename TA, typename TZ>
__device__ __forceinline__ void stage_bc(const ScanArgs<TA, TZ>& p, int b, int t0, float* sB,
                                        float* sC) {
  const int N = p.N;
  for (int i = threadIdx.x; i < kChunk * N; i += kLanes) {
    const int r = i / N, n = i - r * N, t = t0 + r;
    const bool ok = t < p.L;
    sB[i] = ok ? to_f(p.Bm[b * p.B_sb + t * p.B_sr + n]) : 0.f;
    sC[i] = ok ? to_f(p.Cm[b * p.C_sb + t * p.C_sr + n]) : 0.f;
  }
}

template <typename TA, typename TZ, bool kStates, bool kGlobal>
__global__ void __launch_bounds__(kLanes) scan_any_fwd(const ScanArgs<TA, TZ> p) {
  extern __shared__ float smem[];
  const int N = p.N;
  float* sh = block_arrays<kGlobal>(smem, p.ws, scan_fwd_floats(N));  // [N][32] the states
  float* sa = sh + N * kLanes;     // [N][32] A log2 e
  float* sB = sa + N * kLanes;     // [16][N]
  float* sC = sB + kChunk * N;     // [16][N]
  const int lane = threadIdx.x, b = blockIdx.x;
  const int d = blockIdx.y * kLanes + lane;
  const bool active = d < p.D;
  const int dd = active ? d : 0;
  const int nc = (p.L + kChunk - 1) / kChunk;
  for (int n = 0; n < N; ++n) {
    sh[n * kLanes + lane] = 0.f;
    sa[n * kLanes + lane] = active ? p.at[static_cast<long long>(n) * p.D + dd] * kLog2e : 0.f;
  }
  const float skip = active ? p.Dp[dd] : 0.f, bias = active ? p.dtb[dd] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk, steps = min(kChunk, p.L - t0);
    __syncwarp();
    stage_bc(p, b, t0, sB, sC);
    if (kStates && active) {
      float* he = p.h_entries + (static_cast<long long>(b) * nc + c) * N * p.D + dd;
      for (int n = 0; n < N; ++n) he[static_cast<long long>(n) * p.D] = sh[n * kLanes + lane];
    }
    __syncwarp();
    for (int r = 0; r < steps; ++r) {
      const int t = t0 + r;
      float u = 0.f, v = 0.f, z = 0.f;
      if (active) {
        u = to_f(p.u[b * p.u_sb + t * p.u_sr + dd]);
        v = to_f(p.dt[b * p.dt_sb + t * p.dt_sr + dd]);
        z = to_f(p.z[b * p.z_sb + t * p.z_sr + dd]);
      }
      const float delta = softplus(v + bias), du = delta * u;
      float acc = 0.f;
      for (int n = 0; n < N; ++n) {
        float h = sh[n * kLanes + lane];
        h = fmaf(exp2_sfu(delta * sa[n * kLanes + lane]), h, du * sB[r * N + n]);
        sh[n * kLanes + lane] = h;
        acc = fmaf(sC[r * N + n], h, acc);
      }
      if (active) {
        const float gate = z / (1.f + expf(-z));
        p.y[(static_cast<long long>(b) * p.L + t) * p.D + dd] = from_f<TZ>((acc + skip * u) * gate);
      }
    }
  }
}

template <typename TA, typename TZ, bool kGlobal>
__global__ void __launch_bounds__(kLanes) scan_any_bwd(const ScanArgs<TA, TZ> p) {
  extern __shared__ float smem[];
  const int N = p.N;
  float* sa = block_arrays<kGlobal>(smem, p.ws, scan_bwd_floats(N));  // [N][32] A log2 e
  float* sdh = sa + N * kLanes;    // [N][32] a_{t+1} dh_{t+1}
  float* sdA = sdh + N * kLanes;   // [N][32]
  float* sB = sdA + N * kLanes;    // [16][N]
  float* sC = sB + kChunk * N;     // [16][N]
  float* red = sC + kChunk * N;    // [2N][32] a step's dB | dC terms
  const int lane = threadIdx.x, b = blockIdx.x, blk = blockIdx.y, nblk = gridDim.y;
  const int d = blk * kLanes + lane;
  const bool active = d < p.D;
  const int dd = active ? d : 0;
  const int L = p.L, D = p.D;
  const int nc = (L + kChunk - 1) / kChunk;
  // the tile's rebuilt states, [16][N][32], this block's slot of the scratch
  float* st = p.st + (static_cast<long long>(b) * nblk + blk) * kChunk * N * kLanes;
  for (int n = 0; n < N; ++n) {
    sa[n * kLanes + lane] = active ? p.at[static_cast<long long>(n) * D + dd] * kLog2e : 0.f;
    sdh[n * kLanes + lane] = 0.f;
    sdA[n * kLanes + lane] = 0.f;
  }
  const float skip = active ? p.Dp[dd] : 0.f, bias = active ? p.dtb[dd] : 0.f;
  float dD = 0.f, ddtb = 0.f;
  const long long part0 = (static_cast<long long>(b) * nblk + blk) * L;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, steps = min(kChunk, L - t0);
    __syncwarp();
    stage_bc(p, b, t0, sB, sC);
    float own_u[kChunk], own_v[kChunk], own_delta[kChunk], own_du[kChunk], own_gy[kChunk],
        own_gz[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const int t = t0 + r;
      const bool ok = active && r < steps;
      const float u = ok ? to_f(p.u[b * p.u_sb + t * p.u_sr + dd]) : 0.f;
      const float v = (ok ? to_f(p.dt[b * p.dt_sb + t * p.dt_sr + dd]) : 0.f) + bias;
      const float z = ok ? to_f(p.z[b * p.z_sb + t * p.z_sr + dd]) : 0.f;
      const float gg = ok ? to_f(p.g[b * p.g_sb + t * p.g_sr + dd]) : 0.f;
      const float sz = sigmoid(z);
      own_u[r] = u;
      own_v[r] = v;
      own_delta[r] = softplus(v);
      own_du[r] = own_delta[r] * u;
      own_gy[r] = gg * (z * sz);
      own_gz[r] = gg * (sz * (1.f + z * (1.f - sz)));
    }
    __syncwarp();
    // rebuild the states before each step of the tile (the forward's arithmetic)
    const float* he = p.h_entries + (static_cast<long long>(b) * nc + c) * N * D + dd;
    for (int n = 0; n < N; ++n) {
      const float a2 = sa[n * kLanes + lane];
      float h = active ? he[static_cast<long long>(n) * D] : 0.f;
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        st[(r * N + n) * kLanes + lane] = h;
        if (r < steps) h = fmaf(exp2_sfu(own_delta[r] * a2), h, own_du[r] * sB[r * N + n]);
      }
    }
    // step back through the tile
#pragma unroll
    for (int r = kChunk - 1; r >= 0; --r) {
      if (r < steps) {
        const int t = t0 + r;
        const float delta = own_delta[r], du = own_du[r], gy = own_gy[r];
        float y_pre = 0.f, dhb = 0.f, dda = 0.f;
        for (int n = 0; n < N; ++n) {
          const float a2 = sa[n * kLanes + lane];
          const float an = exp2_sfu(delta * a2);
          const float hp = st[(r * N + n) * kLanes + lane];
          const float Bn = sB[r * N + n], Cn = sC[r * N + n];
          const float ht = fmaf(an, hp, du * Bn);
          y_pre = fmaf(Cn, ht, y_pre);
          const float dhn = fmaf(gy, Cn, sdh[n * kLanes + lane]);
          const float dh = an * dhn;
          sdh[n * kLanes + lane] = dh;
          const float daa = dh * hp;
          sdA[n * kLanes + lane] = fmaf(daa, delta, sdA[n * kLanes + lane]);
          dda = fmaf(daa, a2, dda);
          dhb = fmaf(dhn, Bn, dhb);
          red[n * kLanes + lane] = dhn * du;         // dB_t, this channel's term
          red[(N + n) * kLanes + lane] = ht * gy;    // dC_t, this channel's term
        }
        __syncwarp();
        for (int j = lane; j < 2 * N; j += kLanes) {  // the warp's sums, in lane order
          float s = 0.f;
          for (int l = 0; l < kLanes; ++l) s += red[j * kLanes + l];
          (j < N ? p.dB_part : p.dC_part)[(part0 + t) * N + (j < N ? j : j - N)] = s;
        }
        __syncwarp();
        if (active) {
          const float ddt = fmaf(dda, kLn2, dhb * own_u[r]) * sigmoid(own_v[r]);
          dD = fmaf(gy, own_u[r], dD);
          ddtb += ddt;
          const long long o = (static_cast<long long>(b) * L + t) * D + dd;
          p.du[o] = from_f<TA>(fmaf(delta, dhb, gy * skip));
          p.ddt[o] = from_f<TA>(ddt);
          p.dz[b * p.dz_sb + t * p.dz_sr + dd] =
              from_f<TZ>(own_gz[r] * round_to<TA>(fmaf(skip, own_u[r], y_pre)));
        }
      }
    }
  }
  if (active) {
    const long long o = static_cast<long long>(b) * D + d;
    for (int n = 0; n < N; ++n) p.dA_part[o * N + n] = sdA[n * kLanes + lane];
    p.dD_part[o] = dD;
    p.ddtb_part[o] = ddtb;
  }
}

template <class K>
cudaError_t allow(K* kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

long long scan_state_floats(int Bsz, int D, int N) {
  return static_cast<long long>(Bsz) * ((D + kLanes - 1) / kLanes) * kChunk * N * kLanes;
}

// the global workspace's floats (0: the arrays fit in shared memory)
long long scan_workspace_floats(int Bsz, int D, int N, bool backward) {
  if (N <= kMaxState) return 0;
  return static_cast<long long>(Bsz) * ((D + kLanes - 1) / kLanes) *
         (backward ? scan_bwd_floats(N) : scan_fwd_floats(N));
}

template <typename TA, typename TZ>
cudaError_t scan_fwd(const ScanArgs<TA, TZ>& p, int Bsz, cudaStream_t s) {
  if (p.N < 1 || (p.N > kMaxState) != (p.ws != nullptr)) return cudaErrorInvalidValue;
  const dim3 grid(Bsz, (p.D + kLanes - 1) / kLanes);
  if (p.ws != nullptr) {
    if (p.h_entries != nullptr) {
      scan_any_fwd<TA, TZ, true, true><<<grid, kLanes, 0, s>>>(p);
    } else {
      scan_any_fwd<TA, TZ, false, true><<<grid, kLanes, 0, s>>>(p);
    }
    return cudaGetLastError();
  }
  const int smem = static_cast<int>(scan_fwd_floats(p.N) * 4);
  cudaError_t err;
  if (p.h_entries != nullptr) {
    if ((err = allow(scan_any_fwd<TA, TZ, true, false>, smem)) != cudaSuccess) return err;
    scan_any_fwd<TA, TZ, true, false><<<grid, kLanes, smem, s>>>(p);
  } else {
    if ((err = allow(scan_any_fwd<TA, TZ, false, false>, smem)) != cudaSuccess) return err;
    scan_any_fwd<TA, TZ, false, false><<<grid, kLanes, smem, s>>>(p);
  }
  return cudaGetLastError();
}

template <typename TA, typename TZ>
cudaError_t scan_bwd(const ScanArgs<TA, TZ>& p, int Bsz, cudaStream_t s) {
  if (p.N < 1 || (p.N > kMaxState) != (p.ws != nullptr)) return cudaErrorInvalidValue;
  const dim3 grid(Bsz, (p.D + kLanes - 1) / kLanes);
  if (p.ws != nullptr) {
    scan_any_bwd<TA, TZ, true><<<grid, kLanes, 0, s>>>(p);
    return cudaGetLastError();
  }
  const int smem = static_cast<int>(scan_bwd_floats(p.N) * 4);
  cudaError_t err = allow(scan_any_bwd<TA, TZ, false>, smem);
  if (err != cudaSuccess) return err;
  scan_any_bwd<TA, TZ, false><<<grid, kLanes, smem, s>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tiled fp32 product of the mixer
// ---------------------------------------------------------------------------

// C (M x N) = A (M x K) B (K x N) [+ C], each operand addressed by its two
// strides; 32 x 32 output tiles, 256 threads, k ascending (deterministic).
// The loads walk the operand's unit-stride axis across the threads.
__global__ void __launch_bounds__(256)
gemm_f32(const float* __restrict__ A, const float* __restrict__ Bm, float* C, int M, int N,
         int K, long long sam, long long sak, long long sbk, long long sbn, long long scm,
         long long scn, int accumulate) {
  __shared__ float As[32][33];  // [m][k]
  __shared__ float Bs[32][33];  // [k][n]
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int m0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const bool a_k_fast = sak == 1, b_n_fast = sbn == 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + 256 * i;
      const int hi = e >> 5, lo = e & 31;
      {
        const int m = a_k_fast ? hi : lo, k = a_k_fast ? lo : hi;
        As[m][k] = (m0 + m < M && k0 + k < K) ? A[(m0 + m) * sam + (k0 + k) * sak] : 0.f;
      }
      {
        const int k = b_n_fast ? hi : lo, n = b_n_fast ? lo : hi;
        Bs[k][n] = (k0 + k < K && n0 + n < N) ? Bm[(k0 + k) * sbk + (n0 + n) * sbn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < 32; ++kk) {
      const float bv = Bs[kk][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(As[ty + 8 * i][kk], bv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 8 * i, n = n0 + tx;
    if (m < M && n < N) {
      float* c = C + m * scm + n * scn;
      *c = accumulate ? *c + acc[i] : acc[i];
    }
  }
}

cudaError_t gemm(const float* A, const float* Bm, float* C, int M, int N, int K, long long sam,
                 long long sak, long long sbk, long long sbn, long long scm, long long scn,
                 bool accumulate, cudaStream_t s) {
  if ((M + 31) / 32 > 65535) return cudaErrorInvalidValue;
  gemm_f32<<<dim3((N + 31) / 32, (M + 31) / 32), 256, 0, s>>>(A, Bm, C, M, N, K, sam, sak, sbk,
                                                             sbn, scm, scn, accumulate ? 1 : 0);
  return cudaGetLastError();
}

// out[(m, n)] = sum_p in[((b, p, l, n))] over p in order, m = b L + l:
// the scan's dB / dC partials (B, P, L, N) into columns of [.. | dB | dC]
__global__ void __launch_bounds__(256)
sum_parts(const float* __restrict__ in, float* __restrict__ out, int Bsz, int P, int L, int N,
          long long out_sm) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(Bsz) * L * N) return;
  const int n = static_cast<int>(i % N);
  const long long m = i / N;
  const int b = static_cast<int>(m / L), l = static_cast<int>(m % L);
  const float* src = in + (static_cast<long long>(b) * P * L + l) * N + n;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += src[static_cast<long long>(p) * L * N];
  out[m * out_sm + n] = s;
}

// ---------------------------------------------------------------------------
// the mixer interior through global memory
// ---------------------------------------------------------------------------

struct MixerGeom {
  int B, L, DI, N, R, W;
  int XW() const { return R + 2 * N; }
  long long M() const { return static_cast<long long>(B) * L; }
};

// xi, x_dbl, dt_raw (fp32 scratch) from xz
template <typename T>
cudaError_t mixer_interior(const T* xz, const float* conv_wt, const float* conv_b,
                           const float* x_proj, const float* dt_proj, float* xi, float* xdbl,
                           float* raw, const MixerGeom& m, cudaStream_t s) {
  const ConvGeom cg{m.B, m.L, m.DI, m.W, static_cast<long long>(m.L) * 2 * m.DI, 2LL * m.DI, 1,
                    m.DI};
  cudaError_t err = conv_fwd<T, float, false>(xz, conv_wt, conv_b, xi, cg,
                                              static_cast<long long>(m.L) * m.DI, m.DI, s);
  if (err != cudaSuccess) return err;
  const int M = static_cast<int>(m.M()), XW = m.XW();
  if ((err = gemm(xi, x_proj, xdbl, M, XW, m.DI, m.DI, 1, XW, 1, XW, 1, false, s)) != cudaSuccess)
    return err;
  return gemm(xdbl, dt_proj, raw, M, m.DI, m.R, XW, 1, m.DI, 1, m.DI, 1, false, s);
}

template <typename T>
ScanArgs<float, T> mixer_scan_args(const T* xz, const float* at, const float* d,
                                   const float* dtb, const float* xi, const float* xdbl,
                                   const float* raw, const MixerGeom& m) {
  ScanArgs<float, T> p{};
  const long long row = static_cast<long long>(m.L);
  p.u = xi;
  p.dt = raw;
  p.at = at;
  p.Bm = xdbl + m.R;
  p.Cm = xdbl + m.R + m.N;
  p.Dp = d;
  p.z = xz + m.DI;
  p.dtb = dtb;
  p.L = m.L;
  p.D = m.DI;
  p.N = m.N;
  p.u_sb = p.dt_sb = row * m.DI;
  p.u_sr = p.dt_sr = m.DI;
  p.B_sb = p.C_sb = row * m.XW();
  p.B_sr = p.C_sr = m.XW();
  p.z_sb = p.g_sb = p.dz_sb = row * 2 * m.DI;
  p.z_sr = p.dz_sr = 2LL * m.DI;
  p.g_sb = row * m.DI;
  p.g_sr = m.DI;
  return p;
}

bool mixer_ok(const MixerGeom& m) {
  return m.B >= 1 && m.B <= 65535 && m.L >= 1 && m.DI >= 1 && m.DI % 128 == 0 && m.N >= 1 &&
         m.N <= 32 && m.R >= 1 && m.W >= 1 && m.M() < (1LL << 31);
}

// ins: xz, conv_wt (W, DI), conv_b, x_proj (DI, XW), dt_proj (R, DI), dtb, at (N, DI), d;
// scratch: xi, x_dbl, dt_raw
template <typename T>
int mixer_fwd(const void* const* ins, void* y, void* h_entries, void* const* scratch,
              const MixerGeom& m, cudaStream_t s) {
  if (!mixer_ok(m)) return cudaErrorInvalidValue;
  const auto f = [&](int i) { return static_cast<const float*>(ins[i]); };
  const T* xz = static_cast<const T*>(ins[0]);
  auto* xi = static_cast<float*>(scratch[0]);
  auto* xdbl = static_cast<float*>(scratch[1]);
  auto* raw = static_cast<float*>(scratch[2]);
  cudaError_t err = mixer_interior<T>(xz, f(1), f(2), f(3), f(4), xi, xdbl, raw, m, s);
  if (err != cudaSuccess) return err;
  ScanArgs<float, T> p = mixer_scan_args<T>(xz, f(6), f(7), f(5), xi, xdbl, raw, m);
  p.y = static_cast<T*>(y);
  p.h_entries = static_cast<float*>(h_entries);
  return scan_fwd(p, m.B, s);
}

// ins: the forward's 8, then h_entries, g (B, L, DI). outs: dxz, dconv_wt (W, DI),
// dconv_b, dx_proj (DI, XW), ddt_proj (R, DI), and the (B, DI, N) dA, (B, DI) dD and
// ddt_b partials. scratch: xi, x_dbl, dt_raw, du, ddt (B, L, DI), dxdbl (B, L, XW),
// dB_part, dC_part (B, ceil(DI/32), L, N), the scan's states, the conv's ds (B, L, DI)
// and partials.
template <typename T>
int mixer_bwd(const void* const* ins, void* const* outs, void* const* scratch,
              const MixerGeom& m, cudaStream_t s) {
  if (!mixer_ok(m)) return cudaErrorInvalidValue;
  const auto f = [&](int i) { return static_cast<const float*>(ins[i]); };
  const auto sc = [&](int i) { return static_cast<float*>(scratch[i]); };
  const auto o = [&](int i) { return static_cast<float*>(outs[i]); };
  const T* xz = static_cast<const T*>(ins[0]);
  T* dxz = static_cast<T*>(outs[0]);
  float *xi = sc(0), *xdbl = sc(1), *raw = sc(2), *du = sc(3), *ddt = sc(4), *dxdbl = sc(5);
  cudaError_t err = mixer_interior<T>(xz, f(1), f(2), f(3), f(4), xi, xdbl, raw, m, s);
  if (err != cudaSuccess) return err;
  ScanArgs<float, T> p = mixer_scan_args<T>(xz, f(6), f(7), f(5), xi, xdbl, raw, m);
  p.h_entries = const_cast<float*>(f(8));
  p.g = static_cast<const T*>(ins[9]);
  p.du = du;
  p.ddt = ddt;
  p.dz = dxz + m.DI;
  p.dB_part = sc(6);
  p.dC_part = sc(7);
  p.st = sc(8);
  p.dA_part = o(5);
  p.dD_part = o(6);
  p.ddtb_part = o(7);
  if ((err = scan_bwd(p, m.B, s)) != cudaSuccess) return err;
  // [d_dtlow | dB | dC]
  const int M = static_cast<int>(m.M()), XW = m.XW(), P = (m.DI + kLanes - 1) / kLanes;
  const long long elems = m.M() * m.N;
  const unsigned blocks = static_cast<unsigned>((elems + 255) / 256);
  sum_parts<<<blocks, 256, 0, s>>>(sc(6), dxdbl + m.R, m.B, P, m.L, m.N, XW);
  sum_parts<<<blocks, 256, 0, s>>>(sc(7), dxdbl + m.R + m.N, m.B, P, m.L, m.N, XW);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = gemm(ddt, f(4), dxdbl, M, m.R, m.DI, m.DI, 1, 1, m.DI, XW, 1, false, s)) !=
      cudaSuccess)
    return err;
  // dxi = du + [..] x_proj^T, in du
  if ((err = gemm(dxdbl, f(3), du, M, m.DI, XW, XW, 1, 1, XW, m.DI, 1, true, s)) != cudaSuccess)
    return err;
  // the conv backward: dx into dxz's x columns, dconv_wt (W, DI) and dconv_b
  const ConvGeom cg{m.B, m.L, m.DI, m.W, static_cast<long long>(m.L) * 2 * m.DI, 2LL * m.DI, 1,
                    m.DI};
  if ((err = conv_bwd<T, float, T>(xz, f(1), f(2), du, dxz, o(1), o(2), sc(9), sc(10), cg,
                                   static_cast<long long>(m.L) * m.DI, m.DI,
                                   static_cast<long long>(m.L) * 2 * m.DI, 2LL * m.DI, s)) !=
      cudaSuccess)
    return err;
  // d x_proj = xi^T [..], d dt_proj = dt_low^T ddt_raw
  if ((err = gemm(xi, dxdbl, o(3), m.DI, XW, M, 1, m.DI, XW, 1, XW, 1, false, s)) != cudaSuccess)
    return err;
  return gemm(xdbl, ddt, o(4), m.R, m.DI, M, 1, XW, m.DI, 1, m.DI, 1, false, s);
}

template <typename T>
ScanArgs<T, T> scan_args(const void* const* in, int L, int D, int N, const long long* s) {
  ScanArgs<T, T> p{};
  p.u = static_cast<const T*>(in[0]);
  p.dt = static_cast<const T*>(in[1]);
  p.at = static_cast<const float*>(in[2]);
  p.Bm = static_cast<const T*>(in[3]);
  p.Cm = static_cast<const T*>(in[4]);
  p.Dp = static_cast<const float*>(in[5]);
  p.z = static_cast<const T*>(in[6]);
  p.dtb = static_cast<const float*>(in[7]);
  p.L = L;
  p.D = D;
  p.N = N;
  p.u_sb = s[0];
  p.u_sr = s[1];
  p.dt_sb = s[2];
  p.dt_sr = s[3];
  p.B_sb = s[4];
  p.B_sr = s[5];
  p.C_sb = s[6];
  p.C_sr = s[7];
  p.z_sb = s[8];
  p.z_sr = s[9];
  return p;
}

template <typename T>
int scan_fwd_entry(const void* const* in, void* y, void* h_entries, int Bsz, int L, int D, int N,
                   const long long* strides, void* stream) {
  if (Bsz < 1 || Bsz > 65535 || L < 1 || D < 1) return cudaErrorInvalidValue;
  ScanArgs<T, T> p = scan_args<T>(in, L, D, N, strides);
  p.y = static_cast<T*>(y);
  p.h_entries = static_cast<float*>(h_entries);
  p.ws = static_cast<float*>(const_cast<void*>(in[8]));
  return scan_fwd(p, Bsz, static_cast<cudaStream_t>(stream));
}

template <typename T>
int scan_bwd_entry(const void* const* in, void* const* out, long long st_floats, int Bsz, int L,
                   int D, int N, const long long* strides, void* stream) {
  if (Bsz < 1 || Bsz > 65535 || L < 1 || D < 1) return cudaErrorInvalidValue;
  if (st_floats != scan_state_floats(Bsz, D, N)) return cudaErrorInvalidValue;
  ScanArgs<T, T> p = scan_args<T>(in, L, D, N, strides);
  p.g = static_cast<const T*>(in[8]);
  p.h_entries = static_cast<float*>(const_cast<void*>(in[9]));
  p.g_sb = strides[10];
  p.g_sr = strides[11];
  p.du = static_cast<T*>(out[0]);
  p.ddt = static_cast<T*>(out[1]);
  p.dz = static_cast<T*>(out[2]);
  p.dz_sb = static_cast<long long>(L) * D;
  p.dz_sr = D;
  p.dB_part = static_cast<float*>(out[3]);
  p.dC_part = static_cast<float*>(out[4]);
  p.dA_part = static_cast<float*>(out[5]);
  p.dD_part = static_cast<float*>(out[6]);
  p.ddtb_part = static_cast<float*>(out[7]);
  p.st = static_cast<float*>(out[8]);
  p.ws = static_cast<float*>(out[9]);
  return scan_bwd(p, Bsz, static_cast<cudaStream_t>(stream));
}

template <typename T>
int conv_fwd_entry(const void* x, const void* w, const void* bias, void* y, int B, int L, int D,
                   int W, long long x_sb, long long x_sr, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || D < 1 || W < 1) return cudaErrorInvalidValue;
  const ConvGeom g{B, L, D, W, x_sb, x_sr, W, 1};
  return conv_fwd<T, T, std::is_same_v<T, bf16>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<T*>(y), g, static_cast<long long>(L) * D, D, static_cast<cudaStream_t>(stream));
}

template <typename T>
int conv_bwd_entry(const void* x, const void* w, const void* bias, const void* gr, void* dx,
                   void* dw, void* db, void* ds, void* part, long long part_floats, int B, int L,
                   int D, int W, long long x_sb, long long x_sr, long long g_sb, long long g_sr,
                   void* stream) {
  if (B < 1 || B > 65535 || L < 1 || D < 1 || W < 1) return cudaErrorInvalidValue;
  const ConvGeom g{B, L, D, W, x_sb, x_sr, W, 1};
  if (part_floats != conv_part_floats(g)) return cudaErrorInvalidValue;
  return conv_bwd<T, T, T>(static_cast<const T*>(x), static_cast<const float*>(w),
                           static_cast<const float*>(bias), static_cast<const T*>(gr),
                           static_cast<T*>(dx), static_cast<float*>(dw), static_cast<float*>(db),
                           static_cast<float*>(ds), static_cast<float*>(part), g, g_sb, g_sr,
                           static_cast<long long>(L) * D, D, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// K1 at any width. x (B, L, D) with strides (x_sb, x_sr, 1); w (D, W), bias (D,)
// fp32 contiguous; y (B, L, D) contiguous, x's dtype. Returns a cudaError_t code.
int conv_any_fwd_f32(const void* x, const void* w, const void* bias, void* y, int B, int L,
                     int D, int W, long long x_sb, long long x_sr, void* stream) {
  return conv_fwd_entry<float>(x, w, bias, y, B, L, D, W, x_sb, x_sr, stream);
}
int conv_any_fwd_bf16(const void* x, const void* w, const void* bias, void* y, int B, int L,
                      int D, int W, long long x_sb, long long x_sr, void* stream) {
  return conv_fwd_entry<bf16>(x, w, bias, y, B, L, D, W, x_sb, x_sr, stream);
}

// K5 at any width: three launches. g (B, L, D) with strides (g_sb, g_sr, 1); dx
// (B, L, D) contiguous; dw (D, W), db (D,) fp32; ds (B, L, D) fp32 and part
// (conv_any_part_floats) fp32 scratch.
int conv_any_bwd_f32(const void* x, const void* w, const void* bias, const void* g, void* dx,
                     void* dw, void* db, void* ds, void* part, long long part_floats, int B,
                     int L, int D, int W, long long x_sb, long long x_sr, long long g_sb,
                     long long g_sr, void* stream) {
  return conv_bwd_entry<float>(x, w, bias, g, dx, dw, db, ds, part, part_floats, B, L, D, W,
                               x_sb, x_sr, g_sb, g_sr, stream);
}
int conv_any_bwd_bf16(const void* x, const void* w, const void* bias, const void* g, void* dx,
                      void* dw, void* db, void* ds, void* part, long long part_floats, int B,
                      int L, int D, int W, long long x_sb, long long x_sr, long long g_sb,
                      long long g_sr, void* stream) {
  return conv_bwd_entry<bf16>(x, w, bias, g, dx, dw, db, ds, part, part_floats, B, L, D, W,
                              x_sb, x_sr, g_sb, g_sr, stream);
}
long long conv_any_part_floats(int B, int L, int D, int W) {
  return conv_part_floats(ConvGeom{B, L, D, W, 0, 0, 0, 0});
}

// K2 / K3 at any d_state: in = u, dt, at (N, D), B, C, D, z, dt_bias and the
// workspace (scan_any_workspace_floats, null when that is 0); strides the
// (batch, row) pairs of u, dt, B, C, z; y contiguous; h_entries (B, ceil(L/16), N,
// D) fp32 for K3, null for K2.
int scan_any_fwd_f32(const void* const* in, void* y, void* h_entries, int Bsz, int L, int D,
                     int N, const long long* strides, void* stream) {
  return scan_fwd_entry<float>(in, y, h_entries, Bsz, L, D, N, strides, stream);
}
int scan_any_fwd_bf16(const void* const* in, void* y, void* h_entries, int Bsz, int L, int D,
                      int N, const long long* strides, void* stream) {
  return scan_fwd_entry<bf16>(in, y, h_entries, Bsz, L, D, N, strides, stream);
}

// K4 at any d_state: in = the forward's 8, g, h_entries; strides the forward's 10
// and g's 2; out = du, ddt, dz (B, L, D) contiguous, dB_part, dC_part
// (B, ceil(D/32), L, N), dA_part (B, D, N), dD_part, ddtb_part (B, D), the
// states' scratch of st_floats (scan_any_state_floats) and the workspace
// (scan_any_workspace_floats, null when that is 0).
int scan_any_bwd_f32(const void* const* in, void* const* out, long long st_floats, int Bsz,
                     int L, int D, int N, const long long* strides, void* stream) {
  return scan_bwd_entry<float>(in, out, st_floats, Bsz, L, D, N, strides, stream);
}
int scan_any_bwd_bf16(const void* const* in, void* const* out, long long st_floats, int Bsz,
                      int L, int D, int N, const long long* strides, void* stream) {
  return scan_bwd_entry<bf16>(in, out, st_floats, Bsz, L, D, N, strides, stream);
}
long long scan_any_state_floats(int Bsz, int D, int N) { return scan_state_floats(Bsz, D, N); }
long long scan_any_workspace_floats(int Bsz, int D, int N, int backward) {
  return scan_workspace_floats(Bsz, D, N, backward != 0);
}
int scan_any_block_channels() { return kLanes; }
int scan_any_chunk_len() { return kChunk; }
int scan_any_max_shared_state() { return kMaxState; }

// K10 at any shape (mixer_fwd's layouts); h_entries null for the lean forward.
int mixer_any_fwd_f32(const void* const* ins, void* y, void* h_entries, void* const* scratch,
                      int B, int L, int DI, int N, int R, int W, void* stream) {
  return mixer_fwd<float>(ins, y, h_entries, scratch, MixerGeom{B, L, DI, N, R, W},
                          static_cast<cudaStream_t>(stream));
}
int mixer_any_fwd_bf16(const void* const* ins, void* y, void* h_entries, void* const* scratch,
                       int B, int L, int DI, int N, int R, int W, void* stream) {
  return mixer_fwd<bf16>(ins, y, h_entries, scratch, MixerGeom{B, L, DI, N, R, W},
                         static_cast<cudaStream_t>(stream));
}

// K11 at any shape (mixer_bwd's layouts).
int mixer_any_bwd_f32(const void* const* ins, void* const* outs, void* const* scratch, int B,
                      int L, int DI, int N, int R, int W, void* stream) {
  return mixer_bwd<float>(ins, outs, scratch, MixerGeom{B, L, DI, N, R, W},
                          static_cast<cudaStream_t>(stream));
}
int mixer_any_bwd_bf16(const void* const* ins, void* const* outs, void* const* scratch, int B,
                       int L, int DI, int N, int R, int W, void* stream) {
  return mixer_bwd<bf16>(ins, outs, scratch, MixerGeom{B, L, DI, N, R, W},
                         static_cast<cudaStream_t>(stream));
}

const char* mamba_any_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
