// Fused Mamba-1 mixer interior, backward (K11), fp32 or bf16. For the forward of
// fused_mixer_fwd.cu and an output gradient g (B, L, DI), it writes
// dxz = [dx | dz] (B, L, 2 DI) and per-batch-row partials of the seven
// weight gradients: d x_proj (DI, R + 2N), d dt_proj (R, DI), dconv_wt
// (W, DI), dconv_b, dA^T (N, DI), dD and ddt_b. The wrapper's torch.sum over
// the batch finishes them, in a fixed order, so the gradients are the same
// from run to run (no floating-point atomics).
//
// Replaces the TPU kernel `_bwd_kernel` behind `_fused_bwd_call`
// (si_mamba_tpu/ops/pallas/fused_mixer_kernel.py). That kernel walks the
// chunks of a row in reverse on a sequential grid, takes the folded
// W_dt = x_proj[:, :R] @ dt_proj (DI x DI) and accumulates the weight
// gradients in VMEM blocks resident across the grid. Here the chunk loop
// runs inside the block, the two rank-R products stay apart, and every
// weight-gradient partial of a block stays on chip for the whole row.
//
// Bound on the H100. At B=32, L=512, DI=768, N=16, R=24 the function needs
// the forward's recompute (3.71 GFLOP), the four products of the backward
// through the pair, 2 (2 DI (R + 2N) + 2 R DI) a token, and the scan and
// conv backward, DI (20 N + 20 + 6 W + 11) a token: 12.46 GFLOP, 0.186 ms at
// 67 TFLOP/s. Its bytes (xz, g, h_entries read, dxz written, the weights and
// their gradients) take 0.107 ms. Operations, then, and in practice the
// instructions around them and the latency of the chunk loop.
//
// Design. The couplings across channels go through x_dbl = [dt_low | B | C]
// (R + 2N <= 64 columns), so a thread-block cluster of P = DI / 128 blocks
// (6 at DI = 768) owns one batch row, block r its channels r*128 ..
// r*128+127, 512 threads, one block an SM (204 KB of shared memory). The
// block's rows of x_proj and columns of dt_proj are loaded once. Chunks of
// kT = 16 tokens run right to left; per chunk:
//  1. x of the own channels for the chunk and the kW - 1 rows to its left,
//     the conv + SiLU, the block's partial of x_dbl; a cluster barrier; the
//     P partials summed in rank order through distributed shared memory (as
//     K10, so the recompute matches its arithmetic);
//  2. the owner lane of each step computes dt_raw from dt_low and its column
//     of dt_proj, softplus, delta*xi, the gate terms of z and g (K4's
//     layout: four lanes a channel, four states a lane, steps q, q+4, ...);
//  3. the scan backward of K4 (selective_scan_bwd.cu) over two halves of
//     8 steps, last first: the half's states rebuilt from the chunk's entry
//     state (h_entries) into a [8][128][16] shared array, each lane its own
//     slot, then the reverse recurrence dh_t = gy_t C_t + a_{t+1} dh_{t+1}
//     with dh carried in registers across chunks; the per-step channel sums
//     by shuffle reduce-scatters, dB_t and dC_t over the warp's channels
//     parked in the slots just read and summed over the 16 warps;
//  4. the block's partial of [d_dtlow | dB | dC] (16 x 64), d_dtlow =
//     ddt_raw dt_proj^T over its channels; a cluster barrier, whose latency
//     the d dt_proj update hides; the P partials summed in rank order: one
//     16 x 64 exchange a chunk;
//  5. dxi of the own channels = du + [d_dtlow | dB | dC] x_proj[rows]^T, times
//     silu' of the recomputed conv output; the conv backward, with the
//     kW - 1 rows of dxi_lin to the right carried from the chunk before.
// d x_proj[rows] (128 x 64) accumulates in shared memory, d dt_proj[:, cols],
// dconv, dA, dD and ddt_b in registers; each is written once per block at
// the end. CUDA cores, fp32: after the rank-R cut the products are about a
// third of the operations, below the scan, so tensor cores are not used.
// softplus and the sigmoids take the accurate expf and log1pf; the decay is
// ex2.approx.ftz(delta * A log2 e), as in K2/K4. A ragged L is masked: rows
// t >= L read x = z = g = 0, their steps are skipped and every cotangent
// there is exactly 0.
//
// bf16 (the `_bf16` entry point): xz (the chunk and its left context) and g
// arrive in bf16 and dxz leaves in bf16, as the TPU kernel reads them at bf16
// activations and its fp32 dxz is cast to xz's dtype. Every load widens to
// fp32 (csrc/elem.cuh), the recompute, the scan backward and every sum run
// in fp32 as at fp32, and each dxz value is rounded once to the nearest even
// as it is stored. The weights, h_entries and the weight-gradient partials
// stay fp32 and deterministic. Each element type is its own instantiation;
// the fp32 one is unchanged.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "elem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;             // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kT = 16;                    // tokens a chunk: the forward's h_entries stride
constexpr int kHalfT = kT / 2;            // steps whose states are rebuilt at once
constexpr int kTile = 128;                // channels a block
constexpr int kN = 16;                    // d_state
constexpr int kW = 4;                     // conv width
constexpr int kXW = 64;                   // x_dbl columns held (R + 2N at most)
constexpr int kMaxR = kXW - 2 * kN;       // 32
constexpr int kLanes = 4;                 // lanes a channel in the scan
constexpr int kPerLane = kN / kLanes;     // 4 states a lane
constexpr int kGroups = 32 / kLanes;      // channels a warp
constexpr int kOwned = kT / kLanes;       // steps whose scalars a lane computes
constexpr int kRows = kT + kW - 1;        // a chunk's rows with the conv's context
constexpr int kXiStride = kT + 4;         // xi of a channel: 16 tokens, padded (banks)
constexpr int kXpStride = kXW + 1;
constexpr int kDtpStride = kMaxR + 1;
constexpr int kDxpStride = kXW + 4;
constexpr int kMaxCluster = 8;            // the portable cluster size: DI <= 1024
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kThreads == 4 * kTile, "four threads a channel");
static_assert(kPerLane == 4, "a lane's states, B and C values move as one float4");
static_assert(2 * kPerLane == kGroups, "the dB/dC reduce-scatter leaves one sum a lane");
static_assert(kThreads * 2 == kT * kXW, "one float2 of an exchange a thread");

// shared memory, in floats
constexpr int kPartFloats = kT * kXW;
constexpr int kStateFloats = kHalfT * kTile * kN;
constexpr int kSmemFloats = kRows * kTile + kTile * kXiStride + 2 * kPartFloats + kMaxR * kT +
                            2 * kT * kN + kStateFloats + kT * kTile + kRows * kTile +
                            2 * kT * kXW + kTile * kXpStride + kTile * kDtpStride +
                            kTile * kDxpStride;
constexpr int kSmemBytes = kSmemFloats * 4;

template <typename T>
struct BwdArgs {
  const T* xz;             // (B, L, 2 DI)
  const float* conv_wt;    // (W, DI)
  const float* conv_b;     // (DI,)
  const float* x_proj;     // (DI, R + 2N)
  const float* dt_proj;    // (R, DI)
  const float* dtb;        // (DI,)
  const float* at;         // (N, DI)
  const float* d;          // (DI,)
  const float* h_entries;  // (B, nc, N, DI)
  const T* g;              // (B, L, DI)
  T* dxz;                  // (B, L, 2 DI)
  float* dxp;              // (B, DI, R + 2N) partials
  float* ddtp;             // (B, R, DI)
  float* dconv_wt;         // (B, W, DI)
  float* dconv_b;          // (B, DI)
  float* dat;              // (B, N, DI)
  float* dd;               // (B, DI)
  float* ddtb;             // (B, DI)
  int L, DI, R;
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// K4's reduce-scatters. On entry every lane holds v[0..7], its channel's
// terms; on exit v[0] on lane l is the sum over the warp's 8 channels of
// v[l / kLanes] of the lanes with the same l % kLanes.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[2 * kPerLane], int lane) {
#pragma unroll
  for (int m = kPerLane, off = 16; m >= 1; m >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = upper ? v[i] : v[i + m];
      const float keep = upper ? v[i + m] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

// On entry every lane of a group holds v[3 j + k] for j < kLanes, k < 3; on
// exit v[0..2] on lane q of the group are the group's sums of v[3 q + k].
__device__ __forceinline__ void group_reduce_scatter(float (&v)[kLanes * 3], int q) {
#pragma unroll
  for (int m = 2 * 3, off = kLanes / 2; off >= 1; m /= 2, off >>= 1) {
    const bool upper = q & off;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = upper ? v[i] : v[i + m];
      const float keep = upper ? v[i + m] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Column of sDtl (dt_low, [k][16]) that holds step r: lane q's steps q, q+4,
// q+8, q+12 sit together as one float4.
__device__ __forceinline__ int step_slot(int r) { return (r % kLanes) * kOwned + r / kLanes; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_mixer_bwd_kernel(const BwdArgs<T> p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = static_cast<int>(cluster.num_blocks());
  const int L = p.L, DI = p.DI, R = p.R, XW = R + 2 * kN;

  extern __shared__ __align__(16) float smem[];
  float* sXin = smem;                          // [kRows][kTile]: x from row t0 - 3
  float* sXi = sXin + kRows * kTile;           // [kTile][kXiStride]: xi, channel-major
  float* sPart = sXi + kTile * kXiStride;      // [2][kT][kXW]: the two exchanges' partials
  float* sDtl = sPart + 2 * kPartFloats;       // [kMaxR][kT]: dt_low, steps by step_slot
  float* sBv = sDtl + kMaxR * kT;              // [kT][kN]: B
  float* sCv = sBv + kT * kN;                  // [kT][kN]: C
  float* st = sCv + kT * kN;                   // [kHalfT][kTile][kN]: rebuilt states
  float* sDdt = st + kStateFloats;             // [kT][kTile]: ddt_raw
  float* sDxl = sDdt + kT * kTile;             // [kRows][kTile]: du, then dxi_lin; 3 carried
  float* sDxdR = sDxl + kRows * kTile;         // [kT][kXW]: [d_dtlow | dB | dC]
  float* sDxdJ = sDxdR + kT * kXW;             // [kXW][kT]: the same, transposed
  float* sXp = sDxdJ + kT * kXW;               // [kTile][kXpStride]: own rows of x_proj
  float* sDtp = sXp + kTile * kXpStride;       // [kTile][kDtpStride]: own columns of dt_proj
  float* sDxp = sDtp + kTile * kDtpStride;     // [kTile][kDxpStride]: d x_proj of own rows

  const int b = blockIdx.y, c0 = rank * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = lane & (kLanes - 1), group = lane & ~(kLanes - 1);
  const int ch = tid / kLanes, c = c0 + ch;           // scan: channel, states q * 4 ...
  const int cc = tid & (kTile - 1), rq = tid / kTile;  // row-wise phases: channel, quarter
  const long long row2 = 2LL * DI;
  const T* xzb = p.xz + static_cast<long long>(b) * L * row2;
  const T* gb = p.g + static_cast<long long>(b) * L * DI;
  T* dxzb = p.dxz + static_cast<long long>(b) * L * row2;
  const int nc = (L + kT - 1) / kT;

  for (int i = tid; i < kTile * kXW; i += kThreads) {
    const int k = i / kXW, j = i % kXW;
    sXp[k * kXpStride + j] = j < XW ? p.x_proj[static_cast<long long>(c0 + k) * XW + j] : 0.f;
    sDxp[k * kDxpStride + j] = 0.f;
  }
  for (int i = tid; i < kMaxR * kTile; i += kThreads) {
    const int k = i / kTile, j = i % kTile;
    sDtp[j * kDtpStride + k] = k < R ? p.dt_proj[static_cast<long long>(k) * DI + c0 + j] : 0.f;
  }
  for (int i = tid; i < (kW - 1) * kTile; i += kThreads) sDxl[kT * kTile + i] = 0.f;

  float a2[kPerLane], dh[kPerLane], dA[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    a2[i] = p.at[(q * kPerLane + i) * DI + c] * kLog2e;
    dh[i] = 0.f;  // a_{t+1} dh_{t+1}, carried backwards
    dA[i] = 0.f;
  }
  const float skip = p.d[c], bias = p.dtb[c];
  float dD = 0.f, ddtb = 0.f;
  float wc[kW], dcw[kW] = {}, dcb = 0.f;
#pragma unroll
  for (int i = 0; i < kW; ++i) wc[i] = p.conv_wt[i * DI + c0 + cc];
  const float cb = p.conv_b[c0 + cc];
  float ddtp[kMaxR / 4] = {};  // d dt_proj[rq + 4 m][cc]

  const float4* sB4 = reinterpret_cast<const float4*>(sBv);
  const float4* sC4 = reinterpret_cast<const float4*>(sCv);
  float4* st4 = reinterpret_cast<float4*>(st);

  // the conv output of rows 4 rq .. 4 rq + 3 of channel cc, from sXin
  auto conv_rows = [&](float (&xl)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float acc = cb;
#pragma unroll
      for (int i = 0; i < kW; ++i) acc = fmaf(sXin[(rq * 4 + r + i) * kTile + cc], wc[i], acc);
      xl[r] = acc;
    }
  };
  // the cluster's partials in sPart[buf], summed in rank order: this
  // thread's two elements e and e + 1 of the 16 x 64 block
  auto exchange = [&](int buf) {
    float2 v = make_float2(0.f, 0.f);
    for (int r = 0; r < P; ++r) {
      const float2 pv = reinterpret_cast<const float2*>(
          cluster.map_shared_rank(sPart + buf * kPartFloats, r))[tid];
      v.x += pv.x;
      v.y += pv.y;
    }
    return v;
  };

  __syncthreads();
  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * kT;

    // 1. x, the conv + SiLU and the block's partial of x_dbl
    for (int i = tid; i < kRows * kTile; i += kThreads) {
      const int t = t0 - (kW - 1) + i / kTile;
      sXin[i] = (t >= 0 && t < L) ? to_f(xzb[t * row2 + c0 + (i % kTile)]) : 0.f;
    }
    // this lane's owned steps' z and g, and its states of the chunk's entry state
    float own_z[kOwned], own_g[kOwned], h0[kPerLane];
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      const int t = t0 + j * kLanes + q;
      own_z[j] = t < L ? to_f(xzb[t * row2 + DI + c]) : 0.f;
      own_g[j] = t < L ? to_f(gb[static_cast<long long>(t) * DI + c]) : 0.f;
    }
    {
      const float* he = p.h_entries + ((static_cast<long long>(b) * nc + ci) * kN +
                                       q * kPerLane) * DI + c;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) h0[i] = he[i * DI];
    }
    __syncthreads();
    {
      float xl[4];
      conv_rows(xl);
      *reinterpret_cast<float4*>(sXi + cc * kXiStride + rq * 4) =
          make_float4(xl[0] / (1.f + expf(-xl[0])), xl[1] / (1.f + expf(-xl[1])),
                      xl[2] / (1.f + expf(-xl[2])), xl[3] / (1.f + expf(-xl[3])));
    }
    __syncthreads();
    {  // thread (column j, rows 2 rp, 2 rp + 1)
      const int j = tid % kXW, rp = tid / kXW;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) {
        const float w = sXp[k * kXpStride + j];
        const float2 xv = *reinterpret_cast<const float2*>(sXi + k * kXiStride + rp * 2);
        acc0 = fmaf(xv.x, w, acc0);
        acc1 = fmaf(xv.y, w, acc1);
      }
      sPart[(rp * 2) * kXW + j] = acc0;
      sPart[(rp * 2 + 1) * kXW + j] = acc1;
    }
    cluster_arrive();
    cluster_wait();
    {
      const float2 v = exchange(0);
      const float vs[2] = {v.x, v.y};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid * 2 + i, r = e / kXW, j = e % kXW;
        if (j < R) sDtl[j * kT + step_slot(r)] = vs[i];
        else if (j < R + kN) sBv[r * kN + j - R] = vs[i];
        else if (j < XW) sCv[r * kN + j - R - kN] = vs[i];
      }
    }
    __syncthreads();

    // 2. the owned steps' scalars
    float own_raw[kOwned], own_delta[kOwned], own_du[kOwned], own_u[kOwned], own_gy[kOwned],
        own_gz[kOwned];
    {
#pragma unroll
      for (int j = 0; j < kOwned; ++j) own_raw[j] = bias;
      for (int k = 0; k < R; ++k) {
        const float w = sDtp[ch * kDtpStride + k];
        const float4 dv = *reinterpret_cast<const float4*>(sDtl + k * kT + q * kOwned);
        own_raw[0] = fmaf(dv.x, w, own_raw[0]);
        own_raw[1] = fmaf(dv.y, w, own_raw[1]);
        own_raw[2] = fmaf(dv.z, w, own_raw[2]);
        own_raw[3] = fmaf(dv.w, w, own_raw[3]);
      }
#pragma unroll
      for (int j = 0; j < kOwned; ++j) {
        const float zz = own_z[j], sz = sigmoid(zz);
        own_u[j] = sXi[ch * kXiStride + j * kLanes + q];
        own_delta[j] = softplus(own_raw[j]);
        own_du[j] = own_delta[j] * own_u[j];
        own_gy[j] = own_g[j] * (zz * sz);
        own_gz[j] = own_g[j] * (sz * (1.f + zz * (1.f - sz)));
      }
    }

    // 3. the scan backward, the later half of the chunk first
    float s_y[kOwned], s_dhb[kOwned], s_dda[kOwned];
    // one half of the chunk: steps r0 .. r0 + 7, r0 a compile-time constant
    auto run_half = [&](auto half) {
      constexpr int r0 = decltype(half)::value * kHalfT;
      auto sweep = [&](auto full) {
        constexpr bool kFull = decltype(full)::value;
        float h[kPerLane] = {h0[0], h0[1], h0[2], h0[3]};
        // rebuild: the states before each step of the half (the forward's
        // arithmetic), into the lane's own slots
#pragma unroll
        for (int r = 0; r < r0 + kHalfT; ++r) {
          if (r >= r0)
            st4[((r - r0) * kTile + ch) * kLanes + q] = make_float4(h[0], h[1], h[2], h[3]);
          if (kFull || t0 + r < L) {
            const int src = group | (r % kLanes);
            const float delta = __shfl_sync(0xffffffffu, own_delta[r / kLanes], src);
            const float du = __shfl_sync(0xffffffffu, own_du[r / kLanes], src);
            const float4 Bv = sB4[r * kLanes + q];
            const float Bs[kPerLane] = {Bv.x, Bv.y, Bv.z, Bv.w};
#pragma unroll
            for (int i = 0; i < kPerLane; ++i)
              h[i] = fmaf(exp2_sfu(delta * a2[i]), h[i], du * Bs[i]);
          }
        }
        // step back through the half
        float sums[kLanes * 3];
#pragma unroll
        for (int rr = kHalfT - 1; rr >= 0; --rr) {
          const int r = r0 + rr, j = r % kLanes;
          if (kFull || t0 + r < L) {  // the same for every thread of the block
            const int src = group | j;
            const float delta = __shfl_sync(0xffffffffu, own_delta[r / kLanes], src);
            const float du = __shfl_sync(0xffffffffu, own_du[r / kLanes], src);
            const float gy = __shfl_sync(0xffffffffu, own_gy[r / kLanes], src);
            const float4 hv = st4[(rr * kTile + ch) * kLanes + q];
            const float4 Bv = sB4[r * kLanes + q];
            const float4 Cv = sC4[r * kLanes + q];
            const float hp[kPerLane] = {hv.x, hv.y, hv.z, hv.w};
            const float Bs[kPerLane] = {Bv.x, Bv.y, Bv.z, Bv.w};
            const float Cs[kPerLane] = {Cv.x, Cv.y, Cv.z, Cv.w};
            float vals[2 * kPerLane];
            float y_pre = 0.f, dhb = 0.f, dda = 0.f;
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
              const float an = exp2_sfu(delta * a2[i]);
              const float ht = fmaf(an, hp[i], du * Bs[i]);
              y_pre = fmaf(Cs[i], ht, y_pre);
              const float dhn = fmaf(gy, Cs[i], dh[i]);
              dh[i] = an * dhn;
              const float daa = dh[i] * hp[i];
              dA[i] = fmaf(daa, delta, dA[i]);
              dda = fmaf(daa, a2[i], dda);
              dhb = fmaf(dhn, Bs[i], dhb);
              vals[i] = dhn * du;             // dB_t, this channel's term
              vals[kPerLane + i] = ht * gy;  // dC_t, this channel's term
            }
            sums[j * 3] = y_pre;
            sums[j * 3 + 1] = dhb;
            sums[j * 3 + 2] = dda;
            const float part = warp_reduce_scatter(vals, lane);
            __syncwarp();  // every lane of the warp has read its states of step r
            st[(rr * kTile + warp * kGroups) * kN + lane] = part;
          } else {
            sums[j * 3] = sums[j * 3 + 1] = sums[j * 3 + 2] = 0.f;
          }
          if (j == 0) {
            group_reduce_scatter(sums, q);
            s_y[r / kLanes] = sums[0];
            s_dhb[r / kLanes] = sums[1];
            s_dda[r / kLanes] = sums[2];
          }
        }
      };
      if (t0 + kT <= L) {
        sweep(std::true_type{});
      } else {
        sweep(std::false_type{});
      }
      __syncthreads();  // every warp's dB/dC sums of the half are parked in st
      // the 16 warps' sums: lane l of warp w holds, for state group l % 4,
      // the dB (l < 16) or dC sum of state 4 (l % 4) + (l / 4) % 4
      if (tid < kHalfT * 32) {
        const int rr = tid / 32, l = tid % 32, r = r0 + rr;
        float s = 0.f;
        if (t0 + r < L) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += st[(rr * kTile + w * kGroups) * kN + l];
        }
        const int n = (l % kLanes) * kPerLane + (l / kLanes) % kPerLane;
        sPart[kPartFloats + r * kXW + R + (l / (kLanes * kPerLane)) * kN + n] = s;
      }
      __syncthreads();  // st is free again
    };
    run_half(std::integral_constant<int, 1>{});
    run_half(std::integral_constant<int, 0>{});

    // du, ddt, dz of the owned steps
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      const int r = j * kLanes + q, t = t0 + r;
      float ddt = 0.f, du = 0.f;
      if (t < L) {
        ddt = fmaf(s_dda[j], kLn2, s_dhb[j] * own_u[j]) * sigmoid(own_raw[j]);
        du = fmaf(own_delta[j], s_dhb[j], own_gy[j] * skip);
        dD = fmaf(own_gy[j], own_u[j], dD);
        ddtb += ddt;
        dxzb[t * row2 + DI + c] = from_f<T>(own_gz[j] * fmaf(skip, own_u[j], s_y[j]));
      }
      sDdt[r * kTile + ch] = ddt;
      sDxl[r * kTile + ch] = du;
    }
    __syncthreads();

    // 4. d_dtlow = ddt_raw dt_proj^T over the own channels: thread (row
    // tid / 32, column tid % 32)
    {
      const int r = tid / 32, k = tid % 32;
      if (k < R) {
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) acc = fmaf(sDdt[r * kTile + j], sDtp[j * kDtpStride + k], acc);
        sPart[kPartFloats + r * kXW + k] = acc;
      }
    }
    cluster_arrive();
    {  // d dt_proj[k][cc] += sum_r dt_low[r][k] ddt_raw[r][cc], k = rq + 4 m
      float dv[kT];
#pragma unroll
      for (int r = 0; r < kT; ++r) dv[r] = sDdt[r * kTile + cc];
#pragma unroll
      for (int m = 0; m < kMaxR / 4; ++m) {
        const int k = rq + 4 * m;
        if (k < R) {
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < kT; ++r) acc = fmaf(sDtl[k * kT + step_slot(r)], dv[r], acc);
          ddtp[m] += acc;
        }
      }
    }
    cluster_wait();
    {
      const float2 v = exchange(1);
      const float vs[2] = {v.x, v.y};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid * 2 + i, r = e / kXW, j = e % kXW;
        const float val = j < XW ? vs[i] : 0.f;
        sDxdR[r * kXW + j] = val;
        sDxdJ[j * kT + r] = val;
      }
    }
    __syncthreads();

    // 5. dxi_lin of rows 4 rq .. 4 rq + 3 of channel cc, then d x_proj
    {
      float acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = sDxl[(rq * 4 + r) * kTile + cc];
      for (int j = 0; j < XW; ++j) {
        const float w = sXp[cc * kXpStride + j];
        const float4 dv = *reinterpret_cast<const float4*>(sDxdJ + j * kT + rq * 4);
        acc[0] = fmaf(dv.x, w, acc[0]);
        acc[1] = fmaf(dv.y, w, acc[1]);
        acc[2] = fmaf(dv.z, w, acc[2]);
        acc[3] = fmaf(dv.w, w, acc[3]);
      }
      float xl[4];
      conv_rows(xl);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float sg = sigmoid(xl[r]);
        sDxl[(rq * 4 + r) * kTile + cc] = acc[r] * (sg * (1.f + xl[r] * (1.f - sg)));
      }
    }
    {  // d x_proj[cc][16 rq .. 16 rq + 15] += sum_r xi[r][cc] dxd[r][.]
      float xv[kT];
#pragma unroll
      for (int r4 = 0; r4 < kT / 4; ++r4) {
        const float4 v = *reinterpret_cast<const float4*>(sXi + cc * kXiStride + r4 * 4);
        xv[r4 * 4] = v.x;
        xv[r4 * 4 + 1] = v.y;
        xv[r4 * 4 + 2] = v.z;
        xv[r4 * 4 + 3] = v.w;
      }
      if (rq * 16 < XW) {
        float acc[16] = {};
#pragma unroll
        for (int r = 0; r < kT; ++r) {
          const float4* d4 = reinterpret_cast<const float4*>(sDxdR + r * kXW + rq * 16);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float4 dv = d4[v];
            acc[v * 4] = fmaf(xv[r], dv.x, acc[v * 4]);
            acc[v * 4 + 1] = fmaf(xv[r], dv.y, acc[v * 4 + 1]);
            acc[v * 4 + 2] = fmaf(xv[r], dv.z, acc[v * 4 + 2]);
            acc[v * 4 + 3] = fmaf(xv[r], dv.w, acc[v * 4 + 3]);
          }
        }
        float4* out = reinterpret_cast<float4*>(sDxp + cc * kDxpStride + rq * 16);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float4 o = out[v];
          o.x += acc[v * 4];
          o.y += acc[v * 4 + 1];
          o.z += acc[v * 4 + 2];
          o.w += acc[v * 4 + 3];
          out[v] = o;
        }
      }
    }
    __syncthreads();

    // the conv backward of rows 4 rq .. 4 rq + 3: dx[t] = sum_i w[i] dxl[t + 3 - i]
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = rq * 4 + rr, t = t0 + r;
      const float dxl = sDxl[r * kTile + cc];
      float dx = dxl * wc[kW - 1];
#pragma unroll
      for (int i = 0; i < kW - 1; ++i) dx = fmaf(sDxl[(r + kW - 1 - i) * kTile + cc], wc[i], dx);
      if (t < L) dxzb[t * row2 + c0 + cc] = from_f<T>(dx);
#pragma unroll
      for (int i = 0; i < kW; ++i) dcw[i] = fmaf(sXin[(r + i) * kTile + cc], dxl, dcw[i]);
      dcb += dxl;
    }
    __syncthreads();
    // the first kW - 1 rows of dxi_lin are the right context of the next chunk
    for (int i = tid; i < (kW - 1) * kTile; i += kThreads) sDxl[kT * kTile + i] = sDxl[i];
    __syncthreads();
  }
  cluster_arrive();  // no block leaves while a peer may still read its partials
  cluster_wait();

  // the block's partials of the weight gradients
  const long long bo = static_cast<long long>(b) * DI;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) p.dat[(static_cast<long long>(b) * kN + q * kPerLane + i) * DI + c] = dA[i];
  dD = group_sum(dD);
  ddtb = group_sum(ddtb);
  if (q == 0) {
    p.dd[bo + c] = dD;
    p.ddtb[bo + c] = ddtb;
  }
#pragma unroll
  for (int m = 0; m < kMaxR / 4; ++m) {
    const int k = rq + 4 * m;
    if (k < R) p.ddtp[(static_cast<long long>(b) * R + k) * DI + c0 + cc] = ddtp[m];
  }
  for (int i = tid; i < kTile * XW; i += kThreads) {
    const int k = i / XW, j = i % XW;
    p.dxp[(bo + c0 + k) * XW + j] = sDxp[k * kDxpStride + j];
  }
  // the conv's: the four row quarters summed in order through shared memory
#pragma unroll
  for (int i = 0; i < kW; ++i) st[(rq * (kW + 1) + i) * kTile + cc] = dcw[i];
  st[(rq * (kW + 1) + kW) * kTile + cc] = dcb;
  __syncthreads();
  if (rq == 0) {
#pragma unroll
    for (int i = 0; i <= kW; ++i) {
      float s = 0.f;
#pragma unroll
      for (int qq = 0; qq < kThreads / kTile; ++qq) s += st[(qq * (kW + 1) + i) * kTile + cc];
      if (i < kW) p.dconv_wt[(static_cast<long long>(b) * kW + i) * DI + c0 + cc] = s;
      else p.dconv_b[bo + c0 + cc] = s;
    }
  }
}

// The launch of a grid of Bsz clusters of DI / 128 blocks; attr is the
// cluster-dimension attribute the configuration points to.
cudaLaunchConfig_t launch_config(int Bsz, int DI, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DI / kTile, Bsz, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = DI / kTile;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool shape_ok(int DI) { return DI % kTile == 0 && DI >= kTile && DI <= kMaxCluster * kTile; }

template <typename T>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(fused_mixer_bwd_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
}

template <typename T>
int bwd(const void* const* ins, void* const* outs, int Bsz, int L, int DI, int N, int R, int W,
        void* stream) {
  if (N != kN || W != kW || !shape_ok(DI) || R < 1 || R > kMaxR) return cudaErrorInvalidValue;
  const auto f = [&](int i) { return static_cast<const float*>(ins[i]); };
  const auto o = [&](int i) { return static_cast<float*>(outs[i]); };
  const BwdArgs<T> args{static_cast<const T*>(ins[0]), f(1), f(2), f(3), f(4), f(5), f(6),
                        f(7), f(8), static_cast<const T*>(ins[9]), static_cast<T*>(outs[0]),
                        o(1), o(2), o(3), o(4), o(5), o(6), o(7), L, DI, R};
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(Bsz, DI, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, fused_mixer_bwd_kernel<T>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ins: xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d, h_entries, g (10
// pointers); outs: dxz, dx_proj, ddt_proj, dconv_wt, dconv_b, dat, dd, ddtb
// (8 pointers, the weight gradients as (B, ...) partials). Shapes as in
// BwdArgs; all float32 and contiguous. Returns a cudaError_t code
// (cudaErrorInvalidValue for N other than 16, W other than 4, DI not a
// multiple of 128 up to 1024, or R + 2N above 64).
int fused_mixer_bwd(const void* const* ins, void* const* outs, int Bsz, int L, int DI, int N,
                    int R, int W, void* stream) {
  return bwd<float>(ins, outs, Bsz, L, DI, N, R, W, stream);
}

// K11 at bf16: xz, g and dxz bf16, every other argument as fused_mixer_bwd's
// (the weights, h_entries and the weight-gradient partials fp32).
int fused_mixer_bwd_bf16(const void* const* ins, void* const* outs, int Bsz, int L, int DI,
                         int N, int R, int W, void* stream) {
  return bwd<bf16>(ins, outs, Bsz, L, DI, N, R, W, stream);
}

// How many clusters (batch rows) at width DI the current card holds at once,
// by the occupancy calculator; a batch of Bsz rows runs in
// ceil(Bsz / count) waves. A negative cudaError_t code on failure.
int fused_mixer_bwd_max_active_clusters(int DI) {
  if (!shape_ok(DI)) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<float>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, DI, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fused_mixer_bwd_kernel<float>, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

int fused_mixer_bwd_chunk_len() { return kT; }

const char* fused_mixer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
