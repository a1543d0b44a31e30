// Fused Mamba-1 mixer interior, forward (K10), fp32. From xz = x @ in_proj
// (B, L, 2 DI), columns [x | z]:
//
//   xi             = silu(causal_conv(x) + conv_b)          (width kW)
//   dt_low | B | C = xi @ x_proj                             (R + 2N columns)
//   dt_raw         = dt_low @ dt_proj + dt_b                 (the rank-R pair)
//   h_t            = exp(softplus(dt_raw_t) A) h_{t-1} + softplus(dt_raw_t) xi_t B_t
//   y_t            = (C_t . h_t + D xi_t) * silu(z_t)
//
// Replaces the TPU kernel `_fwd_kernel` behind `_fused_fwd_call`
// (si_mamba_tpu/ops/pallas/fused_mixer_kernel.py), reached from
// `fused_mamba_mixer` and `mamba_mixer_apply(impl='fused')`, in two
// variants: the lean forward (serving) and, with the template flag kStates,
// the training forward that also writes the (N, DI) state entering every
// kT-token chunk, h_entries (B, ceil(L / kT), N, DI), from which the backward
// (fused_mixer_bwd.cu) restarts each chunk. The TPU kernel folds
// W_dt = x_proj[:, :R] @ dt_proj into one (DI, DI) matrix to suit its
// 128 x 128 matrix unit; that costs 2 DI^2 operations a token against
// 4 R DI for the pair, so here the two rank-R products stay apart.
//
// Bound on the H100. At B=32, L=512, DI=768, N=16, R=24 the function needs,
// per (b, t), 2 DI (R + 2N) + 2 R DI operations for the two products and
// DI (2 kW + 15 + 7 N) for the conv, SiLU, softplus, scan and gate: 3.71
// GFLOP, 0.055 ms at 67 TFLOP/s; its bytes (xz read, y written, the weights;
// h_entries written with states) take 0.046 / 0.060 ms: operations bind the
// lean forward and bytes the one with states, both by a small margin; in
// practice the instructions around the operations do (shared-memory reads
// feeding the FMAs, shuffles) and the latency of the chunk loop's phases.
//
// Design. A thread-block cluster of P = DI / kTile blocks (6 at DI = 768,
// within the portable 8) owns one batch row (and one segment of L, below);
// block r owns channels r*128 .. r*128+127. Its rows of x_proj (128 x R+2N)
// and columns of dt_proj (R x 128), about 50 KB, are loaded into shared
// memory once per kernel. Per chunk of kT = 16 tokens:
//  1. conv + SiLU of its own channels only (x and the kW - 1 rows to the
//     left read from xz), xi kept in shared memory, double-buffered;
//  2. the block's partial of x_dbl = xi @ x_proj (16 x 64, columns past
//     R + 2N zero), into one of two exchange buffers;
//  3. after a cluster barrier each block sums the P partials through
//     distributed shared memory in rank order, so every block holds the same
//     x_dbl, deterministically;
//  4. the scan of its 128 channels as K2 (selective_scan_fwd.cu) runs it:
//     the 16 states of a channel split over kLanes = 2 lanes, 8 each; the
//     lane that owns a step (8 contiguous steps a lane) computes dt_raw from
//     dt_low and its column of dt_proj, the softplus and delta*xi once and
//     shuffles them to its partner; B_t and C_t are read as float4s;
//     ex2.approx for the decay (2 ulp, below 2^-126 it is 0); a chunk wholly
//     inside its segment takes a copy of the step loop without bound tests.
// The cluster barrier is split (arrive after step 2 of chunk i + 1, wait
// before step 3 of chunk i + 1), and chunk i + 1's conv and partial are
// computed between the wait and the scan of chunk i, so a block scans while
// its peers reach the barrier. 256 threads a block, 81 KB of shared memory,
// two blocks an SM: the 192 blocks of B=32 fit in one wave.
//
// Small batch: while twice the grid still fits one block an SM (6 blocks at
// one cloud), L is cut into segments (whole chunks, up to 16 of them, at
// least two chunks each), as K2 does: a first pass scans every segment but the last from a
// zero state and writes its end state and per-channel sum of delta; the
// second pass composes each segment's entry state as
// h <- exp(A sum delta_k) h + h_end_k and scans again, writing y (and
// h_entries). fused_mixer_fwd_segments picks the count from the shape, and
// both variants take the same count, so their y agree bit for bit.
//
// softplus is v > 20 ? v : log1pf(expf(v)) and silu v / (1 + expf(-v)),
// with the accurate expf/log1pf. A ragged L is masked: rows t >= L read
// x = z = 0 and write nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kT = 16;                    // tokens a chunk; also the h_entries stride
constexpr int kTile = 128;                // channels a block
constexpr int kN = 16;                    // d_state
constexpr int kW = 4;                     // conv width
constexpr int kXW = 64;                   // x_dbl columns held (R + 2N at most)
constexpr int kMaxR = kXW - 2 * kN;       // 32
constexpr int kLanes = 2;                 // lanes a channel in the scan
constexpr int kPerLane = kN / kLanes;     // 8 states a lane
constexpr int kOwned = kT / kLanes;       // 8 steps whose scalars a lane computes
constexpr int kXiStride = kT + 4;         // xi of a channel: 16 tokens, padded (banks)
constexpr int kXpStride = kXW + 1;        // a row of x_proj in shared memory
constexpr int kDtpStride = kMaxR + 1;     // a column of dt_proj in shared memory
constexpr int kMaxCluster = 8;            // the portable cluster size: DI <= 1024
constexpr int kMaxSegments = 16;
constexpr int kMinSegmentChunks = 2;
constexpr int kSplitBelow = 132;          // segments x blocks stay within one an SM
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * kTile, "two threads a channel");
static_assert(kThreads * 4 == kT * kXW, "one float4 of the exchange a thread");

// shared memory, in floats
constexpr int kXiFloats = kTile * kXiStride;
constexpr int kPartFloats = kT * kXW;
constexpr int kSmemFloats = 2 * kXiFloats + 2 * kPartFloats + kMaxR * kT + 2 * kT * kN +
                            kTile * kXpStride + kTile * kDtpStride;
constexpr int kSmemBytes = kSmemFloats * 4;

struct FwdArgs {
  const float* xz;       // (B, L, 2 DI)
  const float* conv_wt;  // (W, DI)
  const float* conv_b;   // (DI,)
  const float* x_proj;   // (DI, R + 2N)
  const float* dt_proj;  // (R, DI)
  const float* dtb;      // (DI,)
  const float* at;       // (N, DI)
  const float* d;        // (DI,)
  float* y;              // (B, L, DI)
  float* h_entries;      // (B, ceil(L / kT), N, DI), or null
  float* h_end;          // (B, segments - 1, N, DI)
  float* dsum;           // (B, segments - 1, DI)
  int L, DI, R, seg_len, segments;
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }
__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

// 2^x on the special-function unit alone (MUFU.EX2, 2 ulp), as in K2.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The two halves of a cluster barrier. Every thread of every block of the
// cluster calls both, in turn; memory written before arrive is visible to
// the cluster after wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kEnds: the first pass of the segmented scan (end states and delta sums,
// no y). Otherwise the scan that writes y, and h_entries if kStates.
template <bool kStates, bool kEnds>
__global__ void __launch_bounds__(kThreads, 2) fused_mixer_fwd_kernel(const FwdArgs p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = static_cast<int>(cluster.num_blocks());
  const int L = p.L, DI = p.DI, R = p.R, XW = R + 2 * kN;

  extern __shared__ __align__(16) float smem[];
  float* sXi = smem;                          // [2][kTile][kXiStride]: xi, channel-major
  float* sPart = sXi + 2 * kXiFloats;         // [2][kT][kXW]: this block's x_dbl partial
  float* sDtl = sPart + 2 * kPartFloats;      // [kMaxR][kT]: dt_low of the chunk
  float* sBv = sDtl + kMaxR * kT;             // [kT][kN]: B
  float* sCv = sBv + kT * kN;                 // [kT][kN]: C
  float* sXp = sCv + kT * kN;                 // [kTile][kXpStride]: own rows of x_proj
  float* sDtp = sXp + kTile * kXpStride;      // [kTile][kDtpStride]: own columns of dt_proj

  const int b = blockIdx.y, seg = blockIdx.z, c0 = rank * kTile;
  const int tid = threadIdx.x, lane = tid & 31;
  const int q = lane & (kLanes - 1), group = lane & ~(kLanes - 1);
  const int ch = tid / kLanes, c = c0 + ch;  // scan: channel, states q * kPerLane ...
  const int cc = tid & (kTile - 1), hh = tid / kTile;  // conv: channel, token half
  const int t_begin = seg * p.seg_len;
  const int t_end = min(t_begin + p.seg_len, L);
  const int nchunks = (t_end - t_begin + kT - 1) / kT;
  const int nc = (L + kT - 1) / kT;
  const float* xzb = p.xz + static_cast<long long>(b) * L * 2 * DI;

  // the resident weights
  for (int i = tid; i < kTile * kXW; i += kThreads) {
    const int k = i / kXW, j = i % kXW;
    sXp[k * kXpStride + j] = j < XW ? p.x_proj[static_cast<long long>(c0 + k) * XW + j] : 0.f;
  }
  for (int i = tid; i < kMaxR * kTile; i += kThreads) {
    const int k = i / kTile, j = i % kTile;
    sDtp[j * kDtpStride + k] = k < R ? p.dt_proj[static_cast<long long>(k) * DI + c0 + j] : 0.f;
  }
  float a2[kPerLane], h[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    a2[i] = p.at[(q * kPerLane + i) * DI + c] * kLog2e;
    h[i] = 0.f;
  }
  const float skip = p.d[c], bias = p.dtb[c];
  float wc[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) wc[i] = p.conv_wt[i * DI + c0 + cc];
  const float cb = p.conv_b[c0 + cc];

  if (!kEnds && seg > 0) {
    // the entry state, composed from the end states of the segments before
    const long long s0 = static_cast<long long>(b) * (p.segments - 1);
    for (int k = 0; k < seg; ++k) {
      const float sd = p.dsum[(s0 + k) * DI + c];
      const float* he = p.h_end + ((s0 + k) * kN + q * kPerLane) * DI + c;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) h[i] = fmaf(exp2_sfu(sd * a2[i]), h[i], he[i * DI]);
    }
  }

  // 1. conv + SiLU of the own channels for the chunk at t0, into sXi[buf]
  auto conv_chunk = [&](int t0, int buf) {
    const int tr = t0 + hh * kOwned;  // this thread's first row
    float win[kW - 1 + kOwned];
#pragma unroll
    for (int i = 0; i < kW - 1 + kOwned; ++i) {
      const int t = tr - (kW - 1) + i;
      win[i] = (t >= 0 && t < L) ? xzb[static_cast<long long>(t) * 2 * DI + c0 + cc] : 0.f;
    }
    float xi[kOwned];
#pragma unroll
    for (int r = 0; r < kOwned; ++r) {
      float acc = cb;
#pragma unroll
      for (int i = 0; i < kW; ++i) acc = fmaf(win[r + i], wc[i], acc);
      xi[r] = silu(acc);
    }
    float4* dst = reinterpret_cast<float4*>(sXi + buf * kXiFloats + cc * kXiStride + hh * kOwned);
    dst[0] = make_float4(xi[0], xi[1], xi[2], xi[3]);
    dst[1] = make_float4(xi[4], xi[5], xi[6], xi[7]);
  };
  // 2. the block's partial of x_dbl from sXi[buf], into sPart[buf]: thread
  // (column j, rows 4 rg .. 4 rg + 3)
  auto partial = [&](int buf) {
    const int j = tid % kXW, rg = tid / kXW;
    const float* xi = sXi + buf * kXiFloats + rg * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const float w = sXp[k * kXpStride + j];
      const float4 xv = *reinterpret_cast<const float4*>(xi + k * kXiStride);
      acc[0] = fmaf(xv.x, w, acc[0]);
      acc[1] = fmaf(xv.y, w, acc[1]);
      acc[2] = fmaf(xv.z, w, acc[2]);
      acc[3] = fmaf(xv.w, w, acc[3]);
    }
    float* out = sPart + buf * kPartFloats + rg * 4 * kXW + j;
#pragma unroll
    for (int r = 0; r < 4; ++r) out[r * kXW] = acc[r];
  };

  __syncthreads();  // the resident weights
  conv_chunk(t_begin, 0);
  __syncthreads();
  partial(0);
  cluster_arrive();

  float* hres = kStates ? p.h_entries + ((static_cast<long long>(b) * nc + t_begin / kT) * kN +
                                         q * kPerLane) * DI + c
                        : nullptr;
  float dsum = 0.f;
  for (int m = 0; m < nchunks; ++m) {
    const int t0 = t_begin + m * kT, cur = m & 1;
    float own_z[kOwned];
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      const int t = t0 + q * kOwned + j;
      own_z[j] = !kEnds && t < t_end ? xzb[static_cast<long long>(t) * 2 * DI + DI + c] : 0.f;
    }
    cluster_wait();
    {  // 3. x_dbl of the chunk: the cluster's partials summed in rank order
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < P; ++r) {
        const float4 pv = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(sPart + cur * kPartFloats, r))[tid];
        v.x += pv.x;
        v.y += pv.y;
        v.z += pv.z;
        v.w += pv.w;
      }
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid * 4 + i, r = e / kXW, j = e % kXW;
        if (j < R) sDtl[j * kT + r] = vs[i];
        else if (j < R + kN) sBv[r * kN + j - R] = vs[i];
        else if (j < XW) sCv[r * kN + j - R - kN] = vs[i];
      }
    }
    __syncthreads();
    if (m + 1 < nchunks) {  // the next chunk's conv and partial, while peers catch up
      conv_chunk(t0 + kT, cur ^ 1);
      __syncthreads();
      partial(cur ^ 1);
    }
    cluster_arrive();

    // 4. the scan of the own channels over the chunk
    const float* xic = sXi + cur * kXiFloats + ch * kXiStride + q * kOwned;
    float own_delta[kOwned], own_du[kOwned], own_u[kOwned];
    {
      float raw[kOwned];
#pragma unroll
      for (int j = 0; j < kOwned; ++j) raw[j] = 0.f;
      for (int k = 0; k < R; ++k) {
        const float w = sDtp[ch * kDtpStride + k];
        const float4 d0 = *reinterpret_cast<const float4*>(sDtl + k * kT + q * kOwned);
        const float4 d1 = *reinterpret_cast<const float4*>(sDtl + k * kT + q * kOwned + 4);
        raw[0] = fmaf(d0.x, w, raw[0]);
        raw[1] = fmaf(d0.y, w, raw[1]);
        raw[2] = fmaf(d0.z, w, raw[2]);
        raw[3] = fmaf(d0.w, w, raw[3]);
        raw[4] = fmaf(d1.x, w, raw[4]);
        raw[5] = fmaf(d1.y, w, raw[5]);
        raw[6] = fmaf(d1.z, w, raw[6]);
        raw[7] = fmaf(d1.w, w, raw[7]);
      }
#pragma unroll
      for (int j = 0; j < kOwned; ++j) {
        own_u[j] = xic[j];
        own_delta[j] = softplus(raw[j] + bias);
        own_du[j] = own_delta[j] * own_u[j];
        if (kEnds && t0 + q * kOwned + j < t_end) dsum += own_delta[j];
      }
    }
    if (kStates) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) hres[i * DI] = h[i];
      hres += kN * DI;
    }
    float ysel[kOwned];
    auto scan_chunk = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int r = 0; r < kT; ++r) {
        if (kFull || t0 + r < t_end) {  // the same for every thread of the block
          const int src = group | (r / kOwned);
          const float delta = __shfl_sync(0xffffffffu, own_delta[r % kOwned], src);
          const float du = __shfl_sync(0xffffffffu, own_du[r % kOwned], src);
          const float4* b4 = reinterpret_cast<const float4*>(sBv + r * kN + q * kPerLane);
          const float4 b0 = b4[0], b1 = b4[1];
          const float Bs[kPerLane] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          if (kEnds) {
#pragma unroll
            for (int i = 0; i < kPerLane; ++i)
              h[i] = fmaf(exp2_sfu(delta * a2[i]), h[i], du * Bs[i]);
          } else {
            const float4* c4 = reinterpret_cast<const float4*>(sCv + r * kN + q * kPerLane);
            const float4 e0 = c4[0], e1 = c4[1];
            const float Cs[kPerLane] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
              h[i] = fmaf(exp2_sfu(delta * a2[i]), h[i], du * Bs[i]);
              acc = fmaf(Cs[i], h[i], acc);
            }
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            if (q == r / kOwned) ysel[r % kOwned] = acc;
          }
        }
      }
    };
    if (t0 + kT <= t_end) {
      scan_chunk(std::true_type{});
    } else {
      scan_chunk(std::false_type{});
    }
    if (!kEnds) {
      float* yp = p.y + (static_cast<long long>(b) * L + t0 + q * kOwned) * DI + c;
#pragma unroll
      for (int j = 0; j < kOwned; ++j) {
        if (t0 + q * kOwned + j < t_end)
          yp[static_cast<long long>(j) * DI] = fmaf(skip, own_u[j], ysel[j]) * silu(own_z[j]);
      }
    }
    __syncthreads();  // the next chunk overwrites sDtl, sBv, sCv and, after it, sXi[cur]
  }
  cluster_wait();  // no block leaves while a peer may still read its partials

  if (kEnds) {
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    const long long s = static_cast<long long>(b) * (p.segments - 1) + seg;
    float* he = p.h_end + (s * kN + q * kPerLane) * DI + c;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) he[i * DI] = h[i];
    if (q == 0) p.dsum[s * DI + c] = dsum;
  }
}

// Segments of L for a batch of Bsz rows at width DI: the largest power of two
// (at most kMaxSegments, each segment at least kMinSegmentChunks chunks long)
// that keeps the grid within one block an SM; 1 once the one-pass grid has
// more than half a block an SM.
int choose_segments(int Bsz, int L, int DI) {
  const long long blocks = static_cast<long long>(Bsz) * (DI / kTile);
  const int chunks = (L + kT - 1) / kT;
  int s = 1;
  while (s * 2 <= kMaxSegments && s * 2 * kMinSegmentChunks <= chunks &&
         blocks * s * 2 <= kSplitBelow)
    s *= 2;
  return s;
}

template <bool kStates, bool kEnds>
cudaError_t launch_pass(const FwdArgs& p, int Bsz, int grid_z, cudaStream_t stream) {
  const auto kernel = fused_mixer_fwd_kernel<kStates, kEnds>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.DI / kTile, Bsz, grid_z);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.DI / kTile;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kStates>
cudaError_t launch(FwdArgs p, int Bsz, int requested, cudaStream_t stream) {
  const int chunks = (p.L + kT - 1) / kT;
  const int s = requested;
  if (s < 1 || s > kMaxSegments) return cudaErrorInvalidValue;
  p.seg_len = ((chunks + s - 1) / s) * kT;
  p.segments = (p.L + p.seg_len - 1) / p.seg_len;  // at most s
  if (p.segments > 1) {
    cudaError_t err = launch_pass<false, true>(p, Bsz, p.segments - 1, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_pass<kStates, false>(p, Bsz, p.segments, stream);
}

}  // namespace

extern "C" {

// ins: xz, conv_wt, conv_b, x_proj, dt_proj, dtb, at, d (8 pointers): xz
// (B, L, 2 DI); conv_wt (W, DI); conv_b, dtb, d (DI,); x_proj (DI, R + 2N);
// dt_proj (R, DI); at (N, DI) = A^T. y (B, L, DI); h_entries (B, ceil(L /
// kT), N, DI) or null for the lean forward; with more than one segment,
// h_end (B, segments - 1, N, DI) and dsum (B, segments - 1, DI) are scratch.
// All float32 and contiguous. `segments` is the number of segments of L
// (fused_mixer_fwd_segments gives the kernel's choice); the scratch is sized
// for it. Returns a cudaError_t code (cudaErrorInvalidValue for N other than
// 16, W other than 4, DI not a multiple of 128 up to 1024, R + 2N above 64,
// or a segment count outside 1..16).
int fused_mixer_fwd(const void* const* ins, void* y, void* h_entries, void* h_end, void* dsum,
                    int Bsz, int L, int DI, int N, int R, int W, int segments, void* stream) {
  if (N != kN || W != kW || DI % kTile != 0 || DI > kMaxCluster * kTile || R < 1 ||
      R > kMaxR)
    return cudaErrorInvalidValue;
  const auto f = [&](int i) { return static_cast<const float*>(ins[i]); };
  const FwdArgs p{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7),
                  static_cast<float*>(y), static_cast<float*>(h_entries),
                  static_cast<float*>(h_end), static_cast<float*>(dsum), L, DI, R, 0, 1};
  auto s = static_cast<cudaStream_t>(stream);
  if (h_entries == nullptr) return launch<false>(p, Bsz, segments, s);
  return launch<true>(p, Bsz, segments, s);
}

// The segment count the kernel chooses for the shape.
int fused_mixer_fwd_segments(int Bsz, int L, int DI) { return choose_segments(Bsz, L, DI); }

int fused_mixer_chunk_len() { return kT; }

const char* fused_mixer_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
