// Fused Mamba-1 mixer interior, backward (K11), fp32. For the forward of
// fused_mixer_fwd.cu and an output gradient g (B, L, DI), it writes
// dxz = [dx | dz] (B, L, 2 DI) and per-batch-row partials of the seven
// weight gradients: dW_dt (DI, DI), dW_bc (DI, 2N), dconv_wt (W, DI),
// dconv_b, dA^T (N, DI), dD and ddt_b. The wrapper's torch.sum over the batch
// finishes them, in a fixed order, so the gradients are the same from run to
// run (no floating-point atomics).
//
// Replaces the TPU kernel `_bwd_kernel` behind `_fused_bwd_call`
// (si_mamba_tpu/ops/pallas/fused_mixer_kernel.py). That kernel walks the
// chunks of a row in reverse on a sequential grid and accumulates the weight
// gradients in VMEM blocks that stay resident across the whole grid; here the
// chunk loop runs inside the block and the partials are per batch row.
//
// Bound on the H100: fp32 operations. At B=32, L=512, DI=768, N=16 the
// function needs the recompute of the forward (21.8 G), ddt_raw @ W_dt^T and
// xi^T @ ddt_raw (19.3 G each), the two W_bc products (1.6 G) and the scan
// and conv backward: 66.8 GFLOP, 1.0 ms at 67 TFLOP/s. Its bytes are xz, g
// and h_entries read, dxz written, the weights read and their gradients
// written: 307 MB, 0.09 ms (chip_smoke.py computes both). The design adds
// traffic: the dW_dt partial of a row (DI x DI, 2.36 MB) does not fit on
// chip, so each block adds its chunk's part to its 128 columns in device
// memory once per chunk: 2 x 393 KB a chunk and block, 4.8 GB per launch at
// that shape (mostly in the 50 MB L2), and the (B, DI, DI) partials are
// 75.5 MB.
//
// Design: the couplings across channels. dxi of a channel needs ddt_raw of
// all DI channels (through W_dt) and the dB | dC sums over all channels
// (through W_bc). So a thread-block cluster of DI / 128 blocks (6 at
// DI = 768, within the portable 8) owns one batch row, block r its channels
// r*128 .. r*128+127; grid (DI / 128, B). Each block walks the chunks of
// kT = 16 tokens right to left and, per chunk:
//   1. recomputes xi of every channel (conv + SiLU from x and the kW - 1 rows
//      to its left, read again from xz), keeping its own channels' conv
//      output and x in shared memory;
//   2. recomputes its 128 columns of dt_raw = xi @ W_dt + dt_b and B | C;
//   3. re-runs the scan of its channels from the state the forward saved at
//      the chunk's entry, two threads a channel with N/2 states each: a
//      forward pass that writes dz and keeps the state at every kSub-step
//      sub-block entry in registers, then, sub-block by sub-block from the
//      end, a rebuild of the sub-block's states and the reverse recurrence
//      dh_t = gy_t C_t + a_{t+1} dh_{t+1} (dh carried in registers across
//      chunks). It writes ddt_raw and du of its channels to shared memory,
//      accumulates dA, dD and ddt_b in registers, and sums dB and dC over
//      its warps' channels with a butterfly of shuffles;
//   4. sums dB | dC over its warps in a fixed order;
//   5. cluster barrier; each block copies every peer's ddt_raw tile into a
//      (kT x DI) buffer and sums the peers' dB | dC in rank order through
//      distributed shared memory; cluster barrier;
//   6. dxi = du + ddt_raw @ W_dt^T + (dB | dC) @ W_bc^T for its channels,
//      times silu' of the conv output;
//   7. the conv backward: dx needs the kW - 1 rows of dxi_lin to its right,
//      carried from the chunk processed before; dconv_wt and dconv_b in
//      registers; dW_dt's partial updated in device memory; dW_bc in
//      registers.
// xi, dt, B, C and the cotangents between them never reach device memory.
// CUDA cores, fp32, the accurate expf/log1pf. A ragged L is masked: rows
// t >= L read x = z = g = 0, so every cotangent there is exactly 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kT = 16;             // tokens a chunk: the forward's h_entries stride
constexpr int kTile = 128;         // channels a block
constexpr int kN = 16;             // d_state
constexpr int kW = 4;              // conv width
constexpr int kKT = 32;            // rows of a weight tile staged in shared memory
constexpr int kRows = kT / 8;      // output rows a thread holds in the block products
constexpr int kHalf = kN / 2;      // states a scan thread holds
constexpr int kSub = 4;            // steps of a sub-block of the reverse sweep
constexpr int kMaxCluster = 8;     // the portable cluster size: DI <= 1024

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }
__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

// acc[r][j] += sum_{k < K} sA[(ty + 8 r) * lda + k] * Bm[k][tx + 32 j], where
// Bm (K x 32 NJ) is read from device memory at gB with row stride ldb and
// staged through sB in kKT-row tiles. The next tile's loads are issued into
// registers before the current tile is multiplied, so their latency hides
// behind the FMAs. K is a multiple of kKT. Every thread of the block calls
// it; it starts with a barrier, so sA may be written just before the call.
template <int NJ>
__device__ __forceinline__ void block_product(const float* sA, int lda,
                                              const float* __restrict__ gB,
                                              long long ldb, int K, float* sB,
                                              float (&acc)[kRows][NJ]) {
  constexpr int N = 32 * NJ;
  constexpr int kPer = kKT * N / kThreads;  // tile elements a thread stages
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  // element e of the thread's share: row kk0 + e * kThreads / N, column col
  const int kk0 = threadIdx.x / N, col = threadIdx.x % N;
  float pre[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) pre[e] = gB[(kk0 + e * (kThreads / N)) * ldb + col];
  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) sB[threadIdx.x + e * kThreads] = pre[e];
    __syncthreads();
    if (k0 + kKT < K) {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        pre[e] = gB[(k0 + kKT + kk0 + e * (kThreads / N)) * ldb + col];
    }
#pragma unroll 8
    for (int kk = 0; kk < kKT; ++kk) {
      float bv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bv[j] = sB[kk * N + tx + 32 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float a = sA[(ty + 8 * r) * lda + k0 + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[r][j] = fmaf(a, bv[j], acc[r][j]);
      }
    }
  }
}

// Sum v[0..kHalf) over the 16 lanes of the warp whose lane bit 0 equals this
// lane's (the 16 channels of the warp, one half of the states each), as a
// reduce-scatter: after it, the lane holds the sum for state k = 4 b4 + 2 b3
// + b2 of its half, where b4 b3 b2 are bits 4..2 of its lane (lanes that
// differ in bit 1 hold the same sum). 8 shuffles instead of 32.
__device__ __forceinline__ float warp_channel_sum(float (&v)[kHalf], int lane) {
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4;
  float v4[4], v2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = u4 ? v[i] : v[i + 4];
    v4[i] = (u4 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = u3 ? v4[i] : v4[i + 2];
    v2[i] = (u3 ? v4[i + 2] : v4[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = u2 ? v2[0] : v2[1];
  float s = (u2 ? v2[1] : v2[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

struct BwdArgs {
  const float* xz;       // (B, L, 2 DI)
  const float* g;        // (B, L, DI)
  const float* conv_wt;  // (W, DI)
  const float* conv_b;   // (DI,)
  const float* wdt;      // (DI, DI)
  const float* wdt_t;    // (DI, DI), W_dt^T
  const float* dtb;      // (DI,)
  const float* wbc;      // (DI, 2N)
  const float* wbc_t;    // (2N, DI), W_bc^T
  const float* at;       // (N, DI)
  const float* d;        // (DI,)
  const float* h_entries;  // (B, nc, N, DI)
  float* dxz;            // (B, L, 2 DI)
  float* dwdt;           // (B, DI, DI) partials
  float* dwbc;           // (B, DI, 2N)
  float* dconv_wt;       // (B, W, DI)
  float* dconv_b;        // (B, DI)
  float* dat;            // (B, N, DI)
  float* dd;             // (B, DI)
  float* ddtb;           // (B, DI)
  int L, DI;
};

__global__ void __launch_bounds__(kThreads, 1) fused_mixer_bwd_kernel(const BwdArgs p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int R = static_cast<int>(cluster.num_blocks());
  const int L = p.L, DI = p.DI;

  extern __shared__ float smem[];
  float* sXi = smem;                          // kT x DI: xi of every channel
  float* sDdtAll = sXi + kT * DI;             // kT x DI: ddt_raw of the cluster
  float* sB = sDdtAll + kT * DI;              // kKT x kTile: a staged weight tile
  float* sDt = sB + kKT * kTile;              // kT x kTile: dt_raw (own channels)
  float* sXl = sDt + kT * kTile;              // kT x kTile: conv output before SiLU
  float* sX = sXl + kT * kTile;               // (kT + kW - 1) x kTile: x from row t0 - 3
  float* sDdt = sX + (kT + kW - 1) * kTile;   // kT x kTile: ddt_raw, read by the peers
  float* sDu = sDdt + kT * kTile;             // kT x kTile: du (scan + D skip)
  float* sDxl = sDu + kT * kTile;             // (kT + kW - 1) x kTile: dxi_lin from row t0
  float* sBC = sDxl + (kT + kW - 1) * kTile;  // kT x 2N: B | C
  float* sRed = sBC + kT * 2 * kN;            // kWarps x kT x 2N: dB | dC by warp
  float* sDbc = sRed + kWarps * kT * 2 * kN;  // kT x 2N: dB | dC of the block, read by peers
  float* sDbcAll = sDbc + kT * 2 * kN;        // kT x 2N: dB | dC of the row

  const int b = blockIdx.y, c0 = rank * kTile;
  const int tid = threadIdx.x, lane = tid & 31, tx = lane, ty = tid >> 5;
  const int ch = tid >> 1, half = tid & 1;  // scan: channel c0 + ch, states half * kHalf + k
  const int c = c0 + ch;
  const int cc_own = tid & (kTile - 1), rh = tid >> 7;  // conv backward: channel, row half
  const long long row = 2LL * DI;
  const float* xzb = p.xz + static_cast<long long>(b) * L * row;
  const float* gb = p.g + static_cast<long long>(b) * L * DI;
  float* dxzb = p.dxz + static_cast<long long>(b) * L * row;
  const int nc = (L + kT - 1) / kT;

  float a[kHalf], dh[kHalf], dat[kHalf];
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    a[k] = p.at[(half * kHalf + k) * DI + c];
    dh[k] = 0.f;
    dat[k] = 0.f;
  }
  const float dsk = p.d[c];
  float dd_acc = 0.f, ddtb_acc = 0.f;
  float dwbc_acc[kTile / 8] = {};  // rows ty + 8 i, column tx
  float wc[kW], dcw[kW] = {}, dcb = 0.f;
#pragma unroll
  for (int i = 0; i < kW; ++i) wc[i] = p.conv_wt[i * DI + c0 + cc_own];

  for (int i = tid; i < (kW - 1) * kTile; i += kThreads) sDxl[kT * kTile + i] = 0.f;

  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * kT;

    // 1. xi of every channel; the own channels' conv output and x
    for (int cc = tid; cc < DI; cc += kThreads) {
      const bool own = cc >= c0 && cc < c0 + kTile;
      float w[kW], win[kW - 1];
#pragma unroll
      for (int i = 0; i < kW; ++i) w[i] = p.conv_wt[i * DI + cc];
      const float bias = p.conv_b[cc];
#pragma unroll
      for (int i = 0; i < kW - 1; ++i) {
        const int t = t0 - (kW - 1) + i;
        win[i] = (t >= 0 && t < L) ? xzb[t * row + cc] : 0.f;
        if (own) sX[i * kTile + cc - c0] = win[i];
      }
#pragma unroll
      for (int r = 0; r < kT; ++r) {  // all kT loads in flight
        const int t = t0 + r;
        const float xv = t < L ? xzb[t * row + cc] : 0.f;
        float acc = bias + xv * w[kW - 1];
#pragma unroll
        for (int i = 0; i < kW - 1; ++i) acc += win[i] * w[i];
        sXi[r * DI + cc] = silu(acc);
        if (own) {
          sXl[r * kTile + cc - c0] = acc;
          sX[(r + kW - 1) * kTile + cc - c0] = xv;
        }
#pragma unroll
        for (int i = 0; i < kW - 2; ++i) win[i] = win[i + 1];
        win[kW - 2] = xv;
      }
    }

    // 2. dt_raw of the own channels and B | C
    {
      float acc[kRows][4] = {};
      block_product<4>(sXi, DI, p.wdt + c0, DI, DI, sB, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sDt[(ty + 8 * r) * kTile + tx + 32 * j] = acc[r][j] + p.dtb[c0 + tx + 32 * j];
      float bc[kRows][1] = {};
      block_product<1>(sXi, DI, p.wbc, 2 * kN, DI, sB, bc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) sBC[(ty + 8 * r) * 2 * kN + tx] = bc[r][0];
    }
    __syncthreads();

    // 3. the scan backward of the own channels
    {
      float hsub[kT / kSub][kHalf], gy[kT], h[kHalf];
      const float* he = p.h_entries +
                        (static_cast<long long>(b * nc + ci) * kN + half * kHalf) * DI + c;
#pragma unroll
      for (int k = 0; k < kHalf; ++k) h[k] = he[static_cast<long long>(k) * DI];
      // forward pass: y0 for dz, the states at the sub-block entries
#pragma unroll
      for (int r = 0; r < kT; ++r) {
        const int t = t0 + r;
        if (r % kSub == 0) {
#pragma unroll
          for (int k = 0; k < kHalf; ++k) hsub[r / kSub][k] = h[k];
        }
        const float delta = softplus(sDt[r * kTile + ch]);
        const float xi = sXi[r * DI + c];
        const float du = delta * xi;
        const float* Bt = sBC + r * 2 * kN + half * kHalf;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kHalf; ++k) {
          h[k] = expf(delta * a[k]) * h[k] + du * Bt[k];
          acc += Bt[kN + k] * h[k];
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        const float y0 = acc + dsk * xi;
        const float z = t < L ? xzb[t * row + DI + c] : 0.f;
        const float gg = t < L ? gb[static_cast<long long>(t) * DI + c] : 0.f;
        const float sz = sigmoid(z);
        gy[r] = gg * (z * sz);
        if (half == 0 && t < L) dxzb[t * row + DI + c] = gg * y0 * (sz * (1.f + z * (1.f - sz)));
      }
      // reverse sweep, sub-block by sub-block from the end
#pragma unroll
      for (int sb = kT / kSub - 1; sb >= 0; --sb) {
        float hh[kSub][kHalf];  // the state after each step of the sub-block
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int r = sb * kSub + j;
          const float delta = softplus(sDt[r * kTile + ch]);
          const float du = delta * sXi[r * DI + c];
          const float* Bt = sBC + r * 2 * kN + half * kHalf;
#pragma unroll
          for (int k = 0; k < kHalf; ++k)
            hh[j][k] = expf(delta * a[k]) * (j > 0 ? hh[j - 1][k] : hsub[sb][k]) + du * Bt[k];
        }
#pragma unroll
        for (int j = kSub - 1; j >= 0; --j) {
          const int r = sb * kSub + j;
          const float raw = sDt[r * kTile + ch];
          const float delta = softplus(raw);
          const float xi = sXi[r * DI + c];
          const float* Bt = sBC + r * 2 * kN + half * kHalf;
          float dhb = 0.f, dda = 0.f, pb[kHalf], pc[kHalf];
#pragma unroll
          for (int k = 0; k < kHalf; ++k) {
            dh[k] += gy[r] * Bt[kN + k];
            const float ea = expf(delta * a[k]);
            const float daa = dh[k] * (j > 0 ? hh[j - 1][k] : hsub[sb][k]) * ea;
            dat[k] += daa * delta;
            dhb += dh[k] * Bt[k];
            dda += daa * a[k];
            pb[k] = dh[k] * (delta * xi);
            pc[k] = hh[j][k] * gy[r];
            dh[k] *= ea;
          }
          dhb += __shfl_xor_sync(0xffffffffu, dhb, 1);
          dda += __shfl_xor_sync(0xffffffffu, dda, 1);
          const float ddt = (dda + dhb * xi) * sigmoid(raw);
          if (half == 0) {
            sDdt[r * kTile + ch] = ddt;
            sDu[r * kTile + ch] = delta * dhb + gy[r] * dsk;
            dd_acc += gy[r] * xi;
            ddtb_acc += ddt;
          }
          const float sb_b = warp_channel_sum(pb, lane);
          const float sb_c = warp_channel_sum(pc, lane);
          if ((lane & 2) == 0) {
            const int s = half * kHalf + ((lane >> 2) & 7);
            sRed[(ty * kT + r) * 2 * kN + s] = sb_b;
            sRed[(ty * kT + r) * 2 * kN + kN + s] = sb_c;
          }
        }
      }
    }
    __syncthreads();

    // 4. dB | dC of the block: the warps' sums in a fixed order
    for (int i = tid; i < kT * 2 * kN; i += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += sRed[w * kT * 2 * kN + i];
      sDbc[i] = s;
    }

    // 5. exchange across the cluster
    cluster.sync();
    for (int q = 0; q < R; ++q) {
      const float* peer = cluster.map_shared_rank(sDdt, q);
      float v[kT * kTile / kThreads];  // all of a peer's loads in flight at once
#pragma unroll
      for (int e = 0; e < kT * kTile / kThreads; ++e) v[e] = peer[tid + e * kThreads];
#pragma unroll
      for (int e = 0; e < kT * kTile / kThreads; ++e) {
        const int i = tid + e * kThreads;
        sDdtAll[(i / kTile) * DI + q * kTile + (i % kTile)] = v[e];
      }
    }
    for (int i = tid; i < kT * 2 * kN; i += kThreads) {
      float s = 0.f;
      for (int q = 0; q < R; ++q) s += cluster.map_shared_rank(sDbc, q)[i];
      sDbcAll[i] = s;
    }
    cluster.sync();

    // 6. dxi_lin of the own channels
    {
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = sDu[(ty + 8 * r) * kTile + tx + 32 * j];
      block_product<4>(sDdtAll, DI, p.wdt_t + c0, DI, DI, sB, acc);
      block_product<4>(sDbcAll, 2 * kN, p.wbc_t + c0, DI, 2 * kN, sB, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int idx = (ty + 8 * r) * kTile + tx + 32 * j;
          const float xl = sXl[idx], sg = sigmoid(xl);
          sDxl[idx] = acc[r][j] * (sg * (1.f + xl * (1.f - sg)));
        }
    }
    __syncthreads();

    // 7. conv backward, dW_dt's partial, dW_bc
#pragma unroll
    for (int rr = 0; rr < kT / 2; ++rr) {
      const int r = rh * (kT / 2) + rr, t = t0 + r;
      const float dxl = sDxl[r * kTile + cc_own];
      float dx = dxl * wc[kW - 1];
#pragma unroll
      for (int i = 0; i < kW - 1; ++i) dx += sDxl[(r + kW - 1 - i) * kTile + cc_own] * wc[i];
      if (t < L) dxzb[t * row + c0 + cc_own] = dx;
#pragma unroll
      for (int i = 0; i < kW; ++i) dcw[i] += sX[(r + i) * kTile + cc_own] * dxl;
      dcb += dxl;
    }
    {  // rows rb + ty + 8 i, columns tx + 32 j: 16 partial sums, their loads issued first
      const bool first = ci == nc - 1;
      for (int rb = 0; rb < DI; rb += 32) {
        float* out = p.dwdt + (static_cast<long long>(b) * DI + rb + ty) * DI + c0 + tx;
        float prev[4][4], part[4][4] = {};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) prev[i][j] = first ? 0.f : out[8 * i * DI + 32 * j];
#pragma unroll
        for (int r = 0; r < kT; ++r) {
          float dv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) dv[j] = sDdt[r * kTile + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xv = sXi[r * DI + rb + ty + 8 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) part[i][j] = fmaf(xv, dv[j], part[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) out[8 * i * DI + 32 * j] = prev[i][j] + part[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < kT; ++r) part += sXi[r * DI + c0 + ty + 8 * i] * sDbcAll[r * 2 * kN + tx];
      dwbc_acc[i] += part;
    }
    __syncthreads();
    // the first kW - 1 rows of dxi_lin are the right context of the next chunk
    for (int i = tid; i < (kW - 1) * kTile; i += kThreads) sDxl[kT * kTile + i] = sDxl[i];
    __syncthreads();
  }

  // the block's partials of the weight gradients
#pragma unroll
  for (int k = 0; k < kHalf; ++k)
    p.dat[(static_cast<long long>(b) * kN + half * kHalf + k) * DI + c] = dat[k];
  if (half == 0) {
    p.dd[static_cast<long long>(b) * DI + c] = dd_acc;
    p.ddtb[static_cast<long long>(b) * DI + c] = ddtb_acc;
  }
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i)
    p.dwbc[(static_cast<long long>(b) * DI + c0 + ty + 8 * i) * 2 * kN + tx] = dwbc_acc[i];
  // the conv's: the two row halves summed through shared memory
  if (rh == 1) {
#pragma unroll
    for (int i = 0; i < kW; ++i) sB[i * kTile + cc_own] = dcw[i];
    sB[kW * kTile + cc_own] = dcb;
  }
  __syncthreads();
  if (rh == 0) {
#pragma unroll
    for (int i = 0; i < kW; ++i)
      p.dconv_wt[(static_cast<long long>(b) * kW + i) * DI + c0 + cc_own] =
          dcw[i] + sB[i * kTile + cc_own];
    p.dconv_b[static_cast<long long>(b) * DI + c0 + cc_own] = dcb + sB[kW * kTile + cc_own];
  }
}

size_t smem_bytes(int DI) {
  return sizeof(float) * (2 * static_cast<size_t>(kT) * DI + kKT * kTile + 4 * kT * kTile +
                          2 * (kT + kW - 1) * kTile + kT * 2 * kN * (kWarps + 3));
}

}  // namespace

extern "C" {

// ins: xz, g, conv_wt, conv_b, wdt, wdt_t, dtb, wbc, wbc_t, at, d, h_entries
// (12 pointers); outs: dxz, dwdt, dwbc, dconv_wt, dconv_b, dat, dd, ddtb
// (8 pointers, the weight gradients as (B, ...) partials). Shapes as in
// BwdArgs; all float32 and contiguous. Returns a cudaError_t code
// (cudaErrorInvalidValue for N other than 16, W other than 4, or DI not a
// multiple of 128 up to 1024).
int fused_mixer_bwd(const void* const* ins, void* const* outs, int Bsz, int L, int DI, int N,
                    int W, void* stream) {
  if (N != kN || W != kW || DI % kTile != 0 || DI > kMaxCluster * kTile)
    return cudaErrorInvalidValue;
  const auto f = [&](int i) { return static_cast<const float*>(ins[i]); };
  const auto o = [&](int i) { return static_cast<float*>(outs[i]); };
  const BwdArgs args{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7), f(8), f(9), f(10), f(11),
                     o(0), o(1), o(2), o(3), o(4), o(5), o(6), o(7), L, DI};
  const size_t smem = smem_bytes(DI);
  cudaError_t err = cudaFuncSetAttribute(fused_mixer_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DI / kTile, Bsz, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DI / kTile;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_mixer_bwd_kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int fused_mixer_bwd_chunk_len() { return kT; }

const char* fused_mixer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
