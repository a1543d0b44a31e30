// Mamba-1 selective scan at bf16 activations on Hopper, d_state 16: the lean
// forward (K2), the training forward that also writes the fp32 state entering
// every kHTile-step tile (K3), and the backward (K4), for
//
//   delta_t = softplus(dt_t + dt_bias)
//   h_t     = a_t h_{t-1} + (delta_t u_t) B_t,   a_t = exp(delta_t A)   (fp32 state)
//   y_t     = (C_t . h_t + D u_t) silu(z_t)
//   dh_t    = gy_t C_t + a_{t+1} dh_{t+1},      gy_t = g_t silu(z_t)
//
// They replace, at bf16 and d_state 16 (cfgs/finetune_modelnet_perf.yaml and
// every bf16 Mamba-1 model), the TPU kernels `_fwd_kernel`
// (si_mamba_tpu/ops/pallas/selective_scan_kernel.py:115, `pallas_call` at :176,
// K3 through `_vjp_fwd` :407) and `_bwd_kernel` (:211, `pallas_call` at :294);
// the fp32 scan keeps csrc/selective_scan_fwd.cu and csrc/selective_scan_bwd.cu,
// any other d_state csrc/mamba_any.cu (ops/kernels/selective_scan.py picks the
// body before the launch). u, dt, z, B, C, g, y, du, ddt, dz are bf16; A, D,
// dt_bias, the state, h_entries and every sum fp32; y is rounded once; K4
// recomputes y_pre = C.h + D u in fp32 and rounds it to bf16 before dz = g
// dsilu(z) y_pre, as the TPU kernel reads the y_pre its forward stored in the
// activation dtype; du, ddt, dz are rounded once. softplus, the sigmoids and
// silu are branch-free fp32 functions within 4 ulps (below), the decay
// ex2.approx.ftz(delta * (A log2 e)).
//
// Bound on the H100 at B=32, L=512, d=768 (the perf preset's train step):
// bytes. K2 moves about 102 MB (u, dt, z, B, C read, y written; 0.030 ms at
// 3.35 TB/s), K3 also its 101 MB of h_entries, K4 reads u, dt, z, g, B, C and
// h_entries and writes du, ddt, dz and the dB/dC partials (about 276 MB). The
// work is 201 M state elements: one MUFU ex2 each (16 a cycle an SM: about
// 0.05 ms) and 4 other fp32 operations in the forward, about 12 in the
// backward, so instruction issue sets the pace before bytes, with the
// reduce-scatters' shuffles and selects beside the arithmetic
// (scripts/torch_scan_phase_trace.py splits a tile's time by phase).
//
// What held the earlier bf16 variants back (the fp32 bodies of
// csrc/selective_scan_fwd.cu and csrc/selective_scan_bwd.cu with each value
// widened as it loads), and what this body does about it:
//  1. Loads of one 2-byte value a lane, each lane's own, with their latency
//     covered by registers (the forward) or not at all (the backward). Here
//     every tile lands by the tensor memory accelerator (csrc/tma.cuh) into
//     unswizzled shared-memory rows (64 channels of u, dt, z, g are 128 bytes;
//     B and C 32; an h_entries slab two 32-float boxes), its arrival counted
//     on an mbarrier, in rings of kFwdStages / kBwdStages tiles issued that
//     far ahead. Lane 0 of each warp arms the stage's barrier with its share
//     of the bytes and issues that share (a request's issue takes a few
//     hundred cycles, which one warp alone would carry into every block
//     barrier). The block barrier that publishes a tile's scalars also frees
//     its stage: no other barrier and no producer warp.
//  2. Per-step channel scalars (softplus, delta u, the gates) computed by the
//     owner lane of each step and handed on by 2-3 shuffles a step. Here the
//     block computes them once a tile, one (step, channel) a thread at a
//     time, into fp32 shared arrays; a lane reads its two channels' values of
//     a step as one 16-byte load. B and C of the tile are widened once the
//     same way. The functions are branch-free, and each pass loads every raw
//     value before it stores anything; the arrays the step loops read are
//     static shared arrays of their own and the loops store nothing the
//     compiler cannot tell apart from them. (Branches, and stores that might
//     alias a later load, had made each (step, channel) item and each step a
//     serial chain of its own.)
//  3. One channel's four states a lane, so every channel sum took a shuffle
//     per state lane and every dB/dC term a 7-shuffle reduce-scatter per four
//     state elements. Here a lane carries two channels x four states (a warp 16
//     channels, a block 64 over 4 warps): the two channels' dB and dC terms
//     and the four states' channel terms are summed in the lane's FMAs first;
//     the three per-channel sums of the backward (y_pre, dh . B, the
//     A-weighted decay terms) of two steps are reduce-scattered over the four
//     state lanes at once (9 shuffles for 12 values, 0.56 a state element),
//     the forward's y of two steps likewise (3 for 4); dB/dC of a step over the
//     warp's 8 channel pairs in 7 shuffles (0.88 a state element), then over
//     the 4 warps through shared memory, summed and stored with the tile's
//     du, ddt, dz by the next tile's scalar pass (its loads before its stores).
//  4. Two ex2 a state element in the backward (one to rebuild the tile's
//     states, one to step back), 136 B of spills under an 80-register cap, a
//     64 KB shared array of states. Here the tile is kHTile = 8 steps, so a
//     thread keeps the tile's 9 states of its 8 elements in registers (72)
//     and writes the rebuild's decays to its own 16-byte slots of a 32 KB
//     shared array, read back as the tile steps back: one ex2 a state element,
//     168 registers and no spills. That is why K3 writes h_entries every 8
//     steps (twice the fp32 route's) and why the plain versions take the tile
//     as an argument; the fp32 route keeps 16.
// Grid (B, ceil(d/64)[, segments]) of 128 threads, three blocks an SM (at
// most 168 registers a thread): 384 blocks at B=32, d=768, one wave on 132
// SMs; 240 at B=20 (one wave, two blocks on most SMs); 768 at B=64 in two.
// A tile's steps past L and channels past d are given delta = delta u = gy =
// 0 (their decays are 1, their terms 0), so no step loop tests a bound; only
// the stores do. At small batch the forward cuts L into segments, as
// csrc/selective_scan_fwd.cu does (choose_segments with the same rule, K3 the
// same count as K2, so the two give the same y bit for bit; 16 segments, 192
// blocks, at one cloud): a first kernel scans each segment but the last from
// 0 and writes its end state and delta sum, the second scans each from its
// entry state, composed as h <- exp(A sum delta) h + h_end. K4 writes
// per-(batch, channel block) partials of dB | dC and per-(batch, channel)
// ones of dA | dD | ddt_bias, which the wrapper finishes with two torch.sum;
// every sum runs in a fixed order, no atomics: two runs are bitwise equal.
//
// Tensor maps: u, dt, z, g, B and C are (B, L, w) bf16 views with unit
// stride along w, h_entries (B, ceil(L/8), 16, d) fp32 rows; each start and
// batch and row stride 16-byte aligned (the wrapper copies a view that is
// not, into rows padded to 16 bytes).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Phase stamps (scripts/torch_scan_phase_trace.py): a build with
// -DSCAN_PHASE_TRACE records %globaltimer at each SCAN_STAMP(slot) for lanes 0
// of warps 0 and 2 of one block (batch row 3, channel block 2, segment 0) and
// gains the entry point scan_phase_trace_read; otherwise SCAN_STAMP is empty.
#ifdef SCAN_PHASE_TRACE
constexpr int kStampSlots = 4096;  // a traced lane's
__device__ unsigned long long g_stamp[2 * kStampSlots];
__device__ __forceinline__ void scan_stamp(int slot) {
  if (blockIdx.x == 3 && blockIdx.y == 2 && blockIdx.z == 0 &&
      (threadIdx.x == 0 || threadIdx.x == 64)) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[(threadIdx.x ? kStampSlots : 0) + slot] = t;
  }
}
#define SCAN_STAMP(slot) scan_stamp(slot)
#else
#define SCAN_STAMP(slot) ((void)0)
#endif

constexpr int kState = 16;      // d_state
constexpr int kChannels = 64;   // channels a block
constexpr int kThreads = 128;   // 4 warps; a lane: 2 channels x 4 states
constexpr int kFwdTile = 16;    // steps a forward tile (the segments' unit)
constexpr int kHTile = 8;       // steps between h_entries: the backward's tile
constexpr int kFwdStages = 3;
constexpr int kBwdStages = 2;
constexpr int kMinBlocks = 3;   // blocks an SM
constexpr int kMaxSegments = 16;
constexpr int kMinSegmentTiles = 2;  // a segment spans at least this many forward tiles
constexpr int kSplitBelow = 132;     // L is cut when the one-pass grid has fewer blocks
constexpr int kTargetBlocks = 384;   // and cut further up to this many blocks
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kThreads == 2 * kChannels, "the scalar passes take two steps a channel at once");
static_assert(kFwdTile % kHTile == 0, "a forward tile holds whole h_entries tiles");

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
// The per-(step, channel) functions, branch-free so that a thread's items of
// a tile interleave (log1pf and the accurate expf and division branch to
// their special cases, which kept each item a serial chain of its own):
// softplus(v) = max(v, 0) + log1p(e^-|v|), with log1p(x) on [0, 1] as
// 2 atanh(s), s = x / (2 + x) <= 1/3, by its series to s^13 (the next term
// under 1e-8 of the result): within 4 fp32 ulps of the exact value, as
// log1pf(expf(v)) is within 3. __expf is 2 ulp + 1.16 |x| ulp, __fdividef 2
// ulp (a sigmoid whose 1 + e^-v passes 2^126 is 0, its limit).
__device__ __forceinline__ float softplus(float v) {
  const float x = __expf(-fabsf(v));
  const float s = __fdividef(x, 2.f + x), s2 = s * s;
  float p = fmaf(s2, 1.f / 13, 1.f / 11);
  p = fmaf(s2, p, 1.f / 9);
  p = fmaf(s2, p, 1.f / 7);
  p = fmaf(s2, p, 1.f / 5);
  p = fmaf(s2, p, 1.f / 3);
  p = fmaf(s2, p, 1.f);
  return fmaxf(v, 0.f) + 2.f * s * p;
}
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

// 2^x on the special-function unit alone (MUFU.EX2, 2 ulp); a result below
// 2^-126 is 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The block's dynamic shared memory from its first 128-byte boundary (each
// kernel asks for 128 bytes more), where the tiles the copies write start.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return smem_raw + ((128 - (tma::smem(smem_raw) & 127)) & 127);
}

// The barriers of n stages, each armed by one thread of every warp (lane 0,
// which issues that warp's share of the stage's copies), visible to the
// copies and to every thread.
__device__ __forceinline__ void init_bars(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) tma::init(bars + i, kThreads / 32);
    tma::fence_init();
  }
  __syncthreads();
}

// The generic proxy's reads of a stage are ordered before the copy that
// refills it (the issuing thread, after the block barrier that frees it).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// On entry the 4 lanes of a channel pair (q = lane % 4) hold v[2 s + c], the
// sum of step s's channel c over their states; on exit lane q holds the sum
// over the 4 lanes of v[q]: step q / 2, channel q % 2.
__device__ __forceinline__ float rs4(const float (&v)[4], int q) {
  const bool hi = q & 2, odd = q & 1;
  const float a0 = (hi ? v[2] : v[0]) + __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  const float a1 = (hi ? v[3] : v[1]) + __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  return (odd ? a1 : a0) + __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
}

// As rs4 for three sums each: v[6 s + 3 c + k]; lane q ends with the three
// sums of step q / 2, channel q % 2 in v[0..2].
__device__ __forceinline__ void rs12(float (&v)[12], int q) {
#pragma unroll
  for (int m = 6, off = 2; off >= 1; m /= 2, off >>= 1) {
    const bool up = q & off;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = up ? v[i] : v[i + m];
      const float keep = up ? v[i + m] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
}

// On entry every lane holds v[0..7] (dB of its 4 states, then dC); on exit
// lane l holds the sum over the warp's 8 channel pairs (the lanes with the
// same l % 4) of v[l / 4]: dB (l / 4 < 4) or dC of state 4 (l % 4) + l / 4 % 4.
__device__ __forceinline__ float rs8(float (&v)[8], int lane) {
#pragma unroll
  for (int m = 4, off = 16; m >= 1; m >>= 1, off >>= 1) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = up ? v[i] : v[i + m];
      const float keep = up ? v[i + m] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

// ---------------------------------------------------------------------------
// forward

// The maps of u, dt, z (64 x kFwdTile boxes), B and C (16 x kFwdTile); A
// (D, 16), Dp and dt_bias (D,) fp32; y (B, L, D) bf16 contiguous; h_entries
// (B, ceil(L / kHTile), 16, D) fp32 contiguous, or null; the segments'
// scratch h_end (B, segments - 1, 16, D) and dsum (B, segments - 1, D).
struct Fwd {
  CUtensorMap mu, mdt, mz, mB, mC;
  const float* A;
  const float* Dp;
  const float* bias;
  bf16* y;
  float* h_entries;
  float* h_end;
  float* dsum;
  int L, D, seg_len, segments;
};

struct FwdStage {  // one tile as it lands: [step][channel] and [step][state]
  bf16 u[kFwdTile * kChannels], dt[kFwdTile * kChannels], z[kFwdTile * kChannels];
  bf16 B[kFwdTile * kState], C[kFwdTile * kState];
};
constexpr int kFwdTileFloats = kFwdTile * kChannels;
// the stages are the dynamic shared memory (128 bytes more for the alignment)
constexpr int kFwdSmem = kFwdStages * static_cast<int>(sizeof(FwdStage)) + 128;
static_assert(sizeof(FwdStage) % 128 == 0, "every stage starts 128-byte aligned");

// kEnds: the first of the two segmented kernels (segment end states and
// delta sums, no y). Otherwise the scan that writes y, and h_entries if
// kRes. The arrays the step loop reads are static shared arrays of their
// own and the loop stores nothing (y and the entry states leave after it),
// so the compiler may hoist any step's loads: no store can alias them.
template <bool kRes, bool kEnds>
__global__ void __launch_bounds__(kThreads, kMinBlocks) scan_fwd(const __grid_constant__ Fwd p) {
  __shared__ __align__(8) uint64_t full[kFwdStages];
  // the tile's (delta, delta u) and (u, silu z) [2 tiles][step][channel], B | C [2 tiles][step][32]
  __shared__ __align__(16) float2 SD[2 * kFwdTileFloats], EP[2 * kFwdTileFloats];
  __shared__ __align__(16) float BC[2 * kFwdTile * 2 * kState];
  FwdStage* st = reinterpret_cast<FwdStage*>(smem_base());

  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
  const int cl = (tid >> 5) * 16 + 2 * (lane >> 2);  // the lane's first channel in the block
  const int b = blockIdx.x, d0 = blockIdx.y * kChannels, seg = blockIdx.z;
  const int L = p.L, D = p.D;
  const int t_begin = seg * p.seg_len, t_end = min(t_begin + p.seg_len, L);
  const int tiles = (t_end - t_begin + kFwdTile - 1) / kFwdTile;

  float a2[2][4], h[2][4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = d0 + cl + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a2[c][i] = d < D ? p.A[d * kState + 4 * q + i] * kLog2e : 0.f;
      h[c][i] = 0.f;
    }
  }
  // the scalar pass's channel (two steps of it at once: tid / 64 picks the parity)
  const int k = tid & (kChannels - 1), kd = d0 + k, parity = tid >> 6;
  const float bias = kd < D ? p.bias[kd] : 0.f;
  // the channel whose y this lane writes
  const int ce = d0 + cl + (q & 1);
  const float skip = ce < D ? p.Dp[ce] : 0.f;

  if (!kEnds && seg > 0) {
    // the entry state, composed from the end states of the segments before
    const long long s0 = static_cast<long long>(b) * (p.segments - 1);
    for (int s = 0; s < seg; ++s) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = d0 + cl + c;
        if (d < D) {
          const float sd = p.dsum[(s0 + s) * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            h[c][i] = fmaf(ex2(sd * a2[c][i]), h[c][i],
                           p.h_end[((s0 + s) * kState + 4 * q + i) * D + d]);
        }
      }
    }
  }

  init_bars(full, kFwdStages);
  constexpr uint32_t kRows = kFwdTile * kChannels * 2, kBC = kFwdTile * kState * 2;
  // tile i of the segment into stage i % kFwdStages: each warp's lane 0 arms
  // the barrier with its share and issues it (u; dt; z and C; B), so that no
  // one warp carries the requests' issue time into the next block barrier
  const int warp = tid >> 5;
  auto issue = [&](int i) {
    FwdStage& s = st[i % kFwdStages];
    uint64_t* bar = &full[i % kFwdStages];
    const int t0 = t_begin + i * kFwdTile;
    if (warp == 0) {
      tma::expect(bar, kRows);
      tma::load(s.u, &p.mu, bar, d0, t0, b);
    } else if (warp == 1) {
      tma::expect(bar, kRows);
      tma::load(s.dt, &p.mdt, bar, d0, t0, b);
    } else if (warp == 2) {
      tma::expect(bar, kEnds ? 0 : kRows + kBC);
      if (!kEnds) {
        tma::load(s.z, &p.mz, bar, d0, t0, b);
        tma::load(s.C, &p.mC, bar, 0, t0, b);
      }
    } else {
      tma::expect(bar, kBC);
      tma::load(s.B, &p.mB, bar, 0, t0, b);
    }
  };
  if (lane == 0)
    for (int i = 0; i < min(kFwdStages, tiles); ++i) issue(i);

  const int nh = (L + kHTile - 1) / kHTile;
  // the lane's h_entries slots of the batch row, and its y column
  float* const hbase = kRes ? p.h_entries + (static_cast<long long>(b) * nh * kState + 4 * q) * D +
                                  d0 + cl
                            : nullptr;
  bf16* const ybase = p.y + static_cast<long long>(b) * L * D + ce;
  // stores the lane's 8 states of the state entering step t (its h_entries slot)
  auto store_entry = [&](const float (&hv)[2][4], int t) {
    float* he = hbase + static_cast<long long>(t / kHTile) * kState * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((D & 1) == 0) {
        if (d0 + cl < D) *reinterpret_cast<float2*>(he + i * D) = make_float2(hv[0][i], hv[1][i]);
      } else {
        if (d0 + cl < D) he[i * D] = hv[0][i];
        if (d0 + cl + 1 < D) he[i * D + 1] = hv[1][i];
      }
    }
  };
  float dsum[2] = {0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    const int t0 = t_begin + i * kFwdTile, buf = i & 1;
    const FwdStage& sg = st[i % kFwdStages];
    SCAN_STAMP(8 * i);
    tma::wait(&full[i % kFwdStages], (i / kFwdStages) & 1);
    SCAN_STAMP(8 * i + 1);
    float2* sd = SD + buf * kFwdTileFloats;
    float2* ep = EP + buf * kFwdTileFloats;
    float* bc = BC + buf * kFwdTile * 2 * kState;
    // the tile's (step, channel) scalars, once; steps past the segment and
    // channels past D get delta = 0 (decay 1, no input). Every raw value is
    // loaded before anything is stored, so the items' chains interleave.
    constexpr int kItems = kFwdTile / 2, kBCItems = kFwdTile * 2 * kState / kThreads;
    float ru[kItems], rdt[kItems], rz[kItems], rbc[kBCItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = (2 * j + parity) * kChannels + k;
      ru[j] = f(sg.u[e]);
      rdt[j] = f(sg.dt[e]);
      rz[j] = kEnds ? 0.f : f(sg.z[e]);
    }
#pragma unroll
    for (int j = 0; j < kBCItems; ++j) {
      const int e = tid + j * kThreads, r = e / (2 * kState), m = e % (2 * kState);
      rbc[j] = m < kState ? f(sg.B[r * kState + m]) : (kEnds ? 0.f : f(sg.C[r * kState + m - kState]));
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int r = 2 * j + parity, e = r * kChannels + k;
      const float sp = softplus(rdt[j] + bias);
      const float delta = kd < D && t0 + r < t_end ? sp : 0.f;
      sd[e] = make_float2(delta, delta * ru[j]);
      if (!kEnds) ep[e] = make_float2(ru[j], rz[j] * sigmoid(rz[j]));
    }
#pragma unroll
    for (int j = 0; j < kBCItems; ++j) bc[tid + j * kThreads] = rbc[j];
    SCAN_STAMP(8 * i + 2);
    __syncthreads();  // the scalars are in place; the stage and the last tile's arrays are free
    SCAN_STAMP(8 * i + 3);
    if (lane == 0 && i + kFwdStages < tiles) {
      fence_async();
      issue(i + kFwdStages);
    }
    SCAN_STAMP(8 * i + 4);

    float yv[4], ys[kFwdTile / 2], hmid[2][4];
    if (kRes && t0 < L) store_entry(h, t0);
#pragma unroll
    for (int r = 0; r < kFwdTile; ++r) {
      if (kRes && r == kHTile) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4) hmid[c][i4] = h[c][i4];
      }
      const float4 dd = *reinterpret_cast<const float4*>(sd + r * kChannels + cl);
      const float4 Bv = *reinterpret_cast<const float4*>(bc + r * 2 * kState + 4 * q);
      const float Bs[4] = {Bv.x, Bv.y, Bv.z, Bv.w};
      const float delta[2] = {dd.x, dd.z}, du[2] = {dd.y, dd.w};
      if (kEnds) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4)
            h[c][i4] = fmaf(ex2(delta[c] * a2[c][i4]), h[c][i4], du[c] * Bs[i4]);
          dsum[c] += delta[c];
        }
      } else {
        const float4 Cv = *reinterpret_cast<const float4*>(bc + r * 2 * kState + kState + 4 * q);
        const float Cs[4] = {Cv.x, Cv.y, Cv.z, Cv.w};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float acc = 0.f;
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4) {
            h[c][i4] = fmaf(ex2(delta[c] * a2[c][i4]), h[c][i4], du[c] * Bs[i4]);
            acc = fmaf(Cs[i4], h[c][i4], acc);
          }
          yv[(r & 1) * 2 + c] = acc;
        }
        if (r & 1) {  // y of steps r - 1 and r, one (step, channel) a lane
          const float2 e = ep[(r - 1 + (q >> 1)) * kChannels + cl + (q & 1)];
          ys[r / 2] = fmaf(skip, e.x, rs4(yv, q)) * e.y;
        }
      }
    }
    if (kRes && t0 + kHTile < L) store_entry(hmid, t0 + kHTile);
    if (!kEnds && ce < D) {
      bf16* yp = ybase + static_cast<long long>(t0 + (q >> 1)) * D;
      if (t0 + kFwdTile <= t_end) {  // the same for every thread of the block
#pragma unroll
        for (int j = 0; j < kFwdTile / 2; ++j, yp += 2 * D) *yp = __float2bfloat16_rn(ys[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kFwdTile / 2; ++j, yp += 2 * D)
          if (t0 + 2 * j + (q >> 1) < t_end) *yp = __float2bfloat16_rn(ys[j]);
      }
    }
  }

  if (kEnds) {
    const long long s = static_cast<long long>(b) * (p.segments - 1) + seg;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = d0 + cl + c;
      if (d < D) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p.h_end[(s * kState + 4 * q + i) * D + d] = h[c][i];
        if (q == 0) p.dsum[s * D + d] = dsum[c];
      }
    }
  }
}

// Segments of L for a launch of Bsz x D channels: 1 while the one-pass grid
// has a block for every SM, else the power of two (at most kMaxSegments, each
// segment at least kMinSegmentTiles tiles long) that brings the grid to
// kTargetBlocks.
int choose_segments(int Bsz, int L, int D) {
  const long long blocks = static_cast<long long>(Bsz) * ((D + kChannels - 1) / kChannels);
  const int tiles = (L + kFwdTile - 1) / kFwdTile;
  int s = 1;
  if (blocks >= kSplitBelow) return s;
  while (s * 2 <= kMaxSegments && s * 2 * kMinSegmentTiles <= tiles && blocks * s < kTargetBlocks)
    s *= 2;
  return s;
}

// ---------------------------------------------------------------------------
// backward

// The maps of u, dt, z, g (64 x kHTile boxes), B and C (16 x kHTile), and
// h_entries' rows (32 x 16 boxes); A, Dp, dt_bias as the forward's; du, ddt,
// dz (B, L, D) bf16 contiguous; the partials dBC_part (B, ceil(D / 64), L,
// 32: dB | dC) and dADb_part (B, D, 20: dA | dD | ddt_bias | 0 | 0) fp32.
struct Bwd {
  CUtensorMap mu, mdt, mz, mg, mB, mC, mh;
  const float* A;
  const float* Dp;
  const float* bias;
  bf16* du;
  bf16* ddt;
  bf16* dz;
  float* dBC_part;
  float* dADb_part;
  int L, D;
};

struct BwdStage {
  bf16 u[kHTile * kChannels], dt[kHTile * kChannels], z[kHTile * kChannels], g[kHTile * kChannels];
  bf16 B[kHTile * kState], C[kHTile * kState];
  float H[2][kState * 32];  // the tile's entry state: [channel half][state][32 channels]
};
constexpr int kBwdTileFloats = kHTile * kChannels;
constexpr int kWarps = kThreads / 32;
// the dynamic shared memory: the stages, the warps' dB | dC sums
// [step][warp][32] fp32 and the tile's du, ddt, dz [3][step][channel] bf16
constexpr int kBwdSmem = kBwdStages * static_cast<int>(sizeof(BwdStage)) +
                         kHTile * kWarps * 32 * 4 + 3 * kBwdTileFloats * 2 + 128;
static_assert(sizeof(BwdStage) % 128 == 0, "every stage starts 128-byte aligned");

// The arrays the rebuild and the step back read are static shared arrays of
// their own and the loops store only to others (the decays to DEC, which the
// step back reads, before it; the sums and outputs to dynamic shared memory),
// so the compiler may hoist any step's loads.
__global__ void __launch_bounds__(kThreads, kMinBlocks) scan_bwd(const __grid_constant__ Bwd p) {
  __shared__ __align__(8) uint64_t full[kBwdStages];
  // (delta, delta u), (sigmoid(dt + bias), dz's gate), gy, u: [step][channel]
  __shared__ __align__(16) float2 SA[kBwdTileFloats], SY[kBwdTileFloats];
  __shared__ __align__(16) float SG[kBwdTileFloats], SU[kBwdTileFloats];
  __shared__ __align__(16) float BC[kHTile * 2 * kState];  // B | C [step][32]
  __shared__ float4 DEC[kHTile * 2 * kThreads];  // the rebuild's decays [step][2][thread]
  unsigned char* base = smem_base();
  BwdStage* st = reinterpret_cast<BwdStage*>(base);
  float* PB = reinterpret_cast<float*>(base + kBwdStages * sizeof(BwdStage));
  bf16* OUT = reinterpret_cast<bf16*>(PB + kHTile * kWarps * 32);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, q = lane & 3;
  const int cl = warp * 16 + 2 * (lane >> 2);
  const int b = blockIdx.x, d0 = blockIdx.y * kChannels;
  const int L = p.L, D = p.D, nt = (L + kHTile - 1) / kHTile;

  float a2[2][4], dh[2][4], dA[2][4];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = d0 + cl + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a2[c][i] = d < D ? p.A[d * kState + 4 * q + i] * kLog2e : 0.f;
      dh[c][i] = 0.f;  // a_{t+1} dh_{t+1}, carried backwards
      dA[c][i] = 0.f;
    }
  }
  const int k = tid & (kChannels - 1), kd = d0 + k, parity = tid >> 6;
  const float bias = kd < D ? p.bias[kd] : 0.f;
  const int ce = d0 + cl + (q & 1);  // the channel whose du, ddt, dz this lane computes
  const float skip = ce < D ? p.Dp[ce] : 0.f;
  float dD = 0.f, ddtb = 0.f;

  init_bars(full, kBwdStages);
  constexpr uint32_t kRows = kHTile * kChannels * 2, kBC = kHTile * kState * 2;
  constexpr uint32_t kH = kState * 32 * 4;
  // the i-th tile from the last into stage i % kBwdStages, a share a warp
  // (u, dt; z, g; B, C; the entry state's two boxes), as in the forward
  auto issue = [&](int i) {
    BwdStage& s = st[i % kBwdStages];
    uint64_t* bar = &full[i % kBwdStages];
    const int c = nt - 1 - i, t0 = c * kHTile;
    if (warp == 0) {
      tma::expect(bar, 2 * kRows);
      tma::load(s.u, &p.mu, bar, d0, t0, b);
      tma::load(s.dt, &p.mdt, bar, d0, t0, b);
    } else if (warp == 1) {
      tma::expect(bar, 2 * kRows);
      tma::load(s.z, &p.mz, bar, d0, t0, b);
      tma::load(s.g, &p.mg, bar, d0, t0, b);
    } else if (warp == 2) {
      tma::expect(bar, 2 * kBC);
      tma::load(s.B, &p.mB, bar, 0, t0, b);
      tma::load(s.C, &p.mC, bar, 0, t0, b);
    } else {
      const int row = (b * nt + c) * kState;
      tma::expect(bar, 2 * kH);
      tma::load(s.H[0], &p.mh, bar, d0, row);
      tma::load(s.H[1], &p.mh, bar, d0 + 32, row);
    }
  };
  if (lane == 0)
    for (int i = 0; i < min(kBwdStages, nt); ++i) issue(i);

  // A tile's block-wide outputs, from PB and OUT after the barrier that ends
  // its step back: the warps' dB | dC sums added in a fixed order (two
  // (step, column) outputs a thread: step warp + 4 j, column lane, which is
  // dB (lane / 4 < 4) or dC of state 4 (lane % 4) + lane / 4 % 4) and du,
  // ddt, dz (4 channels, 8 bytes, of step tid / 16 a thread where rows allow).
  // Split into its loads and its stores, so that the next tile's scalar pass
  // can put all its loads before all its stores.
  const int pv = lane / 4, pcol = (pv / 4) * kState + 4 * (lane % 4) + pv % 4;
  float* const dbc = p.dBC_part +
                     (static_cast<long long>(b) * gridDim.y + blockIdx.y) * L * 2 * kState + pcol;
  const int orow = tid / (kChannels / 4), ocol = 4 * (tid % (kChannels / 4));
  const bool ovec = (D & 3) == 0;
  struct Pass {
    float s[kHTile * 32 / kThreads];
    uint2 o[3];
  };
  auto pass_load = [&](Pass& w) {
#pragma unroll
    for (int j = 0; j < kHTile * 32 / kThreads; ++j) {
      const int r = warp + 4 * j;
      float s = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < kWarps; ++w2) s += PB[(r * kWarps + w2) * 32 + lane];
      w.s[j] = s;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
      w.o[a] = *reinterpret_cast<const uint2*>(OUT + a * kBwdTileFloats + orow * kChannels + ocol);
  };
  auto pass_store = [&](const Pass& w, int t0, bool live) {
#pragma unroll
    for (int j = 0; j < kHTile * 32 / kThreads; ++j) {
      const int t = t0 + warp + 4 * j;
      if (live && t < L) dbc[static_cast<long long>(t) * 2 * kState] = w.s[j];
    }
    const int t = t0 + orow, d = d0 + ocol;
    if (live && ovec && t < L && d < D) {
      const long long o = (static_cast<long long>(b) * L + t) * D + d;
      *reinterpret_cast<uint2*>(p.du + o) = w.o[0];
      *reinterpret_cast<uint2*>(p.ddt + o) = w.o[1];
      *reinterpret_cast<uint2*>(p.dz + o) = w.o[2];
    }
  };
  // the same outputs where D % 4 != 0 (after the barrier, element by element)
  auto pass_ragged = [&](int t0) {
    for (int e = tid; e < kBwdTileFloats; e += kThreads) {
      const int t = t0 + e / kChannels, d = d0 + e % kChannels;
      if (t < L && d < D) {
        const long long o = (static_cast<long long>(b) * L + t) * D + d;
        p.du[o] = OUT[e];
        p.ddt[o] = OUT[kBwdTileFloats + e];
        p.dz[o] = OUT[2 * kBwdTileFloats + e];
      }
    }
  };
  static_assert(kHTile * 32 % kThreads == 0 && kBwdTileFloats == 4 * kThreads,
                "the pass takes whole outputs a thread");

  for (int i = 0; i < nt; ++i) {
    const int t0 = (nt - 1 - i) * kHTile;
    const BwdStage& sg = st[i % kBwdStages];
    SCAN_STAMP(2048 + 8 * i);
    tma::wait(&full[i % kBwdStages], (i / kBwdStages) & 1);
    SCAN_STAMP(2048 + 8 * i + 1);
    // the tile's scalars, once; steps past L and channels past D get delta =
    // delta u = gy = 0; and the last tile's outputs (every value loaded
    // before anything is stored, as in the forward)
    Pass last;
    pass_load(last);
    constexpr int kItems = kHTile / 2, kBCItems = kHTile * 2 * kState / kThreads;
    float ru[kItems], rv[kItems], rz[kItems], rg[kItems], rbc[kBCItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = (2 * j + parity) * kChannels + k;
      ru[j] = f(sg.u[e]);
      rv[j] = f(sg.dt[e]) + bias;
      rz[j] = f(sg.z[e]);
      rg[j] = f(sg.g[e]);
    }
#pragma unroll
    for (int j = 0; j < kBCItems; ++j) {
      const int e = tid + j * kThreads, r = e / (2 * kState), m = e % (2 * kState);
      rbc[j] = m < kState ? f(sg.B[r * kState + m]) : f(sg.C[r * kState + m - kState]);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int r = 2 * j + parity, e = r * kChannels + k;
      const bool ok = kd < D && t0 + r < L;
      const float zz = rz[j], gg = rg[j], sz = sigmoid(zz), sp = softplus(rv[j]);
      const float delta = ok ? sp : 0.f;
      SA[e] = make_float2(delta, delta * ru[j]);
      SG[e] = ok ? gg * (zz * sz) : 0.f;
      SU[e] = ru[j];
      SY[e] = make_float2(sigmoid(rv[j]), gg * (sz * (1.f + zz * (1.f - sz))));
    }
#pragma unroll
    for (int j = 0; j < kBCItems; ++j) BC[tid + j * kThreads] = rbc[j];
    pass_store(last, t0 + kHTile, i > 0);
    // the state entering the tile, this lane's 8 elements
    float hs[kHTile + 1][2][4];  // hs[r]: the state before step r; hs[kHTile] after the tile
    {
      const float* H = sg.H[cl >> 5];
#pragma unroll
      for (int i4 = 0; i4 < 4; ++i4) {
        const float2 v = *reinterpret_cast<const float2*>(H + (4 * q + i4) * 32 + (cl & 31));
        hs[0][0][i4] = v.x;
        hs[0][1][i4] = v.y;
      }
    }
    SCAN_STAMP(2048 + 8 * i + 2);
    __syncthreads();  // the scalars are in place; the stage is free
    SCAN_STAMP(2048 + 8 * i + 3);
    if (lane == 0 && i + kBwdStages < nt) {
      fence_async();
      issue(i + kBwdStages);
    }
    SCAN_STAMP(2048 + 8 * i + 4);

    // rebuild the tile's states (the forward's arithmetic), keeping the
    // decays; each step's operands are loaded before the step before it
    // stores its decays
    float4 dd_next = *reinterpret_cast<const float4*>(SA + cl);
    float4 B_next = *reinterpret_cast<const float4*>(BC + 4 * q);
#pragma unroll
    for (int r = 0; r < kHTile; ++r) {
      const float4 dd = dd_next, Bv = B_next;
      if (r + 1 < kHTile) {
        dd_next = *reinterpret_cast<const float4*>(SA + (r + 1) * kChannels + cl);
        B_next = *reinterpret_cast<const float4*>(BC + (r + 1) * 2 * kState + 4 * q);
      }
      const float Bs[4] = {Bv.x, Bv.y, Bv.z, Bv.w};
      const float delta[2] = {dd.x, dd.z}, du[2] = {dd.y, dd.w};
      float a[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          a[c][i4] = ex2(delta[c] * a2[c][i4]);
          hs[r + 1][c][i4] = fmaf(a[c][i4], hs[r][c][i4], du[c] * Bs[i4]);
        }
      DEC[(r * 2) * kThreads + tid] = make_float4(a[0][0], a[0][1], a[0][2], a[0][3]);
      DEC[(r * 2 + 1) * kThreads + tid] = make_float4(a[1][0], a[1][1], a[1][2], a[1][3]);
    }

    SCAN_STAMP(2048 + 8 * i + 5);
    // step back; the three channel sums of two steps are reduce-scattered
    // over the 4 state lanes at once, each landing on the lane that computes
    // that (step, channel)'s du, ddt and dz
    float sums[12];
#pragma unroll
    for (int r = kHTile - 1; r >= 0; --r) {
      const float4 dd = *reinterpret_cast<const float4*>(SA + r * kChannels + cl);
      const float2 gv = *reinterpret_cast<const float2*>(SG + r * kChannels + cl);
      const float4 Bv = *reinterpret_cast<const float4*>(BC + r * 2 * kState + 4 * q);
      const float4 Cv = *reinterpret_cast<const float4*>(BC + r * 2 * kState + kState + 4 * q);
      const float4 av[2] = {DEC[(r * 2) * kThreads + tid], DEC[(r * 2 + 1) * kThreads + tid]};
      const float Bs[4] = {Bv.x, Bv.y, Bv.z, Bv.w}, Cs[4] = {Cv.x, Cv.y, Cv.z, Cv.w};
      const float delta[2] = {dd.x, dd.z}, du[2] = {dd.y, dd.w}, gy[2] = {gv.x, gv.y};
      float terms[8];  // dB of the lane's 4 states, then dC, over its 2 channels
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float a[4] = {av[c].x, av[c].y, av[c].z, av[c].w};
        float y_pre = 0.f, dhb = 0.f, dda = 0.f;
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const float ht = hs[r + 1][c][i4];
          y_pre = fmaf(Cs[i4], ht, y_pre);
          const float dhn = fmaf(gy[c], Cs[i4], dh[c][i4]);
          dhb = fmaf(dhn, Bs[i4], dhb);
          terms[i4] = c == 0 ? dhn * du[0] : fmaf(dhn, du[1], terms[i4]);
          terms[4 + i4] = c == 0 ? ht * gy[0] : fmaf(ht, gy[1], terms[4 + i4]);
          dh[c][i4] = a[i4] * dhn;
          const float daa = dh[c][i4] * hs[r][c][i4];
          dA[c][i4] = fmaf(daa, delta[c], dA[c][i4]);
          dda = fmaf(daa, a2[c][i4], dda);
        }
        sums[(r & 1) * 6 + c * 3] = y_pre;
        sums[(r & 1) * 6 + c * 3 + 1] = dhb;
        sums[(r & 1) * 6 + c * 3 + 2] = dda;
      }
      PB[(r * kWarps + warp) * 32 + lane] = rs8(terms, lane);
      if ((r & 1) == 0) {  // du, ddt, dz of steps r and r + 1, one (step, channel) a lane
        rs12(sums, q);
        const int rr = r + (q >> 1), e = rr * kChannels + cl + (q & 1);
        const float uu = SU[e], gyv = SG[e], delta_e = SA[e].x;
        const float2 sy = SY[e];
        const float ddt = fmaf(sums[2], kLn2, sums[1] * uu) * sy.x;
        if (t0 + rr < L) {  // (channels past D have gy = 0 and u = 0: nothing to add)
          dD = fmaf(gyv, uu, dD);
          ddtb += ddt;
        }
        OUT[e] = __float2bfloat16_rn(fmaf(delta_e, sums[1], gyv * skip));
        OUT[kBwdTileFloats + e] = __float2bfloat16_rn(ddt);
        // y_pre as the forward stores it, in bf16
        OUT[2 * kBwdTileFloats + e] = __float2bfloat16_rn(sy.y * rbf(fmaf(skip, uu, sums[0])));
      }
    }
    SCAN_STAMP(2048 + 8 * i + 6);
    __syncthreads();  // every warp's dB/dC sums and the tile's outputs are in place
    SCAN_STAMP(2048 + 8 * i + 7);
    if (!ovec) pass_ragged(t0);
  }
  {  // the last tile's outputs
    Pass last;
    pass_load(last);
    pass_store(last, 0, nt > 0);
  }

  // dA of the lane's elements; dD and ddt_bias of a channel from its two
  // lanes; a row of dADb_part is 20 floats (80 bytes), so dA goes as float4s
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int d = d0 + cl + c;
    if (d < D)
      reinterpret_cast<float4*>(p.dADb_part)[(static_cast<long long>(b) * D + d) * 5 + q] =
          make_float4(dA[c][0], dA[c][1], dA[c][2], dA[c][3]);
  }
  dD += __shfl_xor_sync(0xffffffffu, dD, 2);
  ddtb += __shfl_xor_sync(0xffffffffu, ddtb, 2);
  if (q < 2 && ce < D)
    reinterpret_cast<float4*>(p.dADb_part)[(static_cast<long long>(b) * D + ce) * 5 + 4] =
        make_float4(dD, ddtb, 0.f, 0.f);
}

// ---------------------------------------------------------------------------
// launches

constexpr int kMaxDevices = 64;

// The kernel's dynamic shared memory allowed, once for each device (the
// attribute call costs host time on every launch otherwise); `done` is the
// kernel's own flags.
template <class K>
cudaError_t allow(K* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}
bool g_allowed_ends[kMaxDevices], g_allowed_res[kMaxDevices], g_allowed_lean[kMaxDevices],
    g_allowed_bwd[kMaxDevices];

// a bf16 (B, L, cols) view at ptr with batch and row strides sb, sr
// (elements), copied in cols_box x rows_box boxes
bool map_rows(CUtensorMap* m, const void* ptr, int cols, int L, int B, long long sb,
              long long sr, int cols_box, int rows_box) {
  const uint64_t dims[3] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(L),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[2] = {static_cast<uint64_t>(sr) * 2, static_cast<uint64_t>(sb) * 2};
  const uint32_t box[3] = {static_cast<uint32_t>(cols_box), static_cast<uint32_t>(rows_box), 1};
  return sr > 0 && sb > 0 && tma::encode(m, true, 3, ptr, dims, strides, box, false);
}

// the (batch, row) strides of u, dt, B, C, z[, g] in s, in that order
bool map_inputs(CUtensorMap* mu, CUtensorMap* mdt, CUtensorMap* mB, CUtensorMap* mC,
                CUtensorMap* mz, CUtensorMap* mg, const void* const* ptr, int B, int L, int D,
                const long long* s, int rows) {
  return map_rows(mu, ptr[0], D, L, B, s[0], s[1], kChannels, rows) &&
         map_rows(mdt, ptr[1], D, L, B, s[2], s[3], kChannels, rows) &&
         map_rows(mB, ptr[2], kState, L, B, s[4], s[5], kState, rows) &&
         map_rows(mC, ptr[3], kState, L, B, s[6], s[7], kState, rows) &&
         map_rows(mz, ptr[4], D, L, B, s[8], s[9], kChannels, rows) &&
         (mg == nullptr || map_rows(mg, ptr[5], D, L, B, s[10], s[11], kChannels, rows));
}

bool shape_ok(int B, int L, int D, int N) {
  // h_entries' rows are addressed with 32-bit map coordinates
  return N == kState && B > 0 && B <= 65535 && L > 0 && D > 0 &&
         static_cast<long long>(B) * ((L + kHTile - 1) / kHTile) * kState < (1ll << 31);
}

int fwd_entry(const void* u, const void* dt, const void* A, const void* Bm, const void* Cm,
              const void* Dp, const void* z, const void* dt_bias, void* y, void* h_entries,
              void* h_end, void* dsum, int Bsz, int L, int D, int N, int segments,
              const long long* strides, void* stream) {
  if (!shape_ok(Bsz, L, D, N)) return cudaErrorInvalidValue;
  const int tiles = (L + kFwdTile - 1) / kFwdTile;
  const int s = segments > 0 ? segments : choose_segments(Bsz, L, D);
  if (s > kMaxSegments) return cudaErrorInvalidValue;
  Fwd p{};
  const void* ptr[5] = {u, dt, Bm, Cm, z};
  if (!map_inputs(&p.mu, &p.mdt, &p.mB, &p.mC, &p.mz, nullptr, ptr, Bsz, L, D, strides, kFwdTile))
    return cudaErrorInvalidValue;
  p.A = static_cast<const float*>(A);
  p.Dp = static_cast<const float*>(Dp);
  p.bias = static_cast<const float*>(dt_bias);
  p.y = static_cast<bf16*>(y);
  p.h_entries = static_cast<float*>(h_entries);
  p.h_end = static_cast<float*>(h_end);
  p.dsum = static_cast<float*>(dsum);
  p.L = L;
  p.D = D;
  p.seg_len = ((tiles + s - 1) / s) * kFwdTile;
  p.segments = (L + p.seg_len - 1) / p.seg_len;  // at most s
  const int nblk = (D + kChannels - 1) / kChannels;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.segments > 1) {
    if (h_end == nullptr || dsum == nullptr) return cudaErrorInvalidValue;
    if ((err = allow(scan_fwd<false, true>, kFwdSmem, g_allowed_ends)) != cudaSuccess) return err;
    scan_fwd<false, true><<<dim3(Bsz, nblk, p.segments - 1), kThreads, kFwdSmem, st>>>(p);
  }
  if (h_entries != nullptr) {
    if ((err = allow(scan_fwd<true, false>, kFwdSmem, g_allowed_res)) != cudaSuccess) return err;
    scan_fwd<true, false><<<dim3(Bsz, nblk, p.segments), kThreads, kFwdSmem, st>>>(p);
  } else {
    if ((err = allow(scan_fwd<false, false>, kFwdSmem, g_allowed_lean)) != cudaSuccess) return err;
    scan_fwd<false, false><<<dim3(Bsz, nblk, p.segments), kThreads, kFwdSmem, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2. u, dt, z: (Bsz, L, D) bf16; Bm, Cm: (Bsz, L, N) bf16; each with unit
// stride along its last axis, its start and the (batch, row) strides given in
// `strides` in the order u, dt, B, C, z (10 values, elements) 16-byte
// aligned. A: (D, N), Dp, dt_bias: (D,) fp32 contiguous; y: (Bsz, L, D)
// bf16 contiguous. `segments` is the number of segments of L (0: the count
// scan_sm90_segments gives); with more than one, h_end (Bsz, segments - 1,
// N, D) and dsum (Bsz, segments - 1, D) are fp32 scratch. Returns a
// cudaError_t code (cudaErrorInvalidValue for an N other than 16, more than
// 16 segments, missing scratch, or a view the tensor maps cannot take).
int scan_sm90_fwd(const void* u, const void* dt, const void* A, const void* Bm, const void* Cm,
                  const void* Dp, const void* z, const void* dt_bias, void* y, void* h_end,
                  void* dsum, int Bsz, int L, int D, int N, int segments,
                  const long long* strides, void* stream) {
  return fwd_entry(u, dt, A, Bm, Cm, Dp, z, dt_bias, y, nullptr, h_end, dsum, Bsz, L, D, N,
                   segments, strides, stream);
}

// K3: as scan_sm90_fwd, and also writes h_entries (Bsz, ceil(L / 8), N, D)
// fp32 contiguous, the state before steps 0, 8, 16, ...
int scan_sm90_fwd_residuals(const void* u, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* Dp, const void* z, const void* dt_bias,
                            void* y, void* h_entries, void* h_end, void* dsum, int Bsz, int L,
                            int D, int N, int segments, const long long* strides, void* stream) {
  if (h_entries == nullptr) return cudaErrorInvalidValue;
  return fwd_entry(u, dt, A, Bm, Cm, Dp, z, dt_bias, y, h_entries, h_end, dsum, Bsz, L, D, N,
                   segments, strides, stream);
}

// K4. Inputs, in this order: u, dt, A, Bm, Cm, Dp, z, dt_bias, g, h_entries:
// u, dt, z, g, Bm, Cm as scan_sm90_fwd's, with the (batch, row) strides of u,
// dt, B, C, z, g in `strides` (12 values), then h_entries' row stride
// (floats): h_entries (Bsz, ceil(L / 8), N, D) fp32 with its rows (the
// states of one tile entry) that many floats apart, its start and row stride
// 16-byte aligned. Outputs, contiguous, in this order: du, ddt, dz (Bsz, L,
// D) bf16; dBC_part (Bsz, ceil(D / 64), L, 2N: dB | dC) and dADb_part (Bsz,
// D, N + 4: dA | dD | ddt_bias | 0 | 0) fp32, whose sums over the channel
// blocks and over Bsz are the gradients. Returns a cudaError_t code
// (cudaErrorInvalidValue as scan_sm90_fwd's).
int scan_sm90_bwd(const void* const* inputs, void* const* outputs, int Bsz, int L, int D, int N,
                  const long long* strides, void* stream) {
  if (!shape_ok(Bsz, L, D, N) || strides[12] < D) return cudaErrorInvalidValue;
  const void* const* in = inputs;
  Bwd p{};
  const void* ptr[6] = {in[0], in[1], in[3], in[4], in[6], in[8]};
  if (!map_inputs(&p.mu, &p.mdt, &p.mB, &p.mC, &p.mz, &p.mg, ptr, Bsz, L, D, strides, kHTile))
    return cudaErrorInvalidValue;
  const int nt = (L + kHTile - 1) / kHTile;
  const uint64_t hdims[2] = {static_cast<uint64_t>(D),
                             static_cast<uint64_t>(Bsz) * nt * kState};
  const uint64_t hstrides[1] = {static_cast<uint64_t>(strides[12]) * 4};
  const uint32_t hbox[2] = {32, kState};
  if (!tma::encode(&p.mh, false, 2, in[9], hdims, hstrides, hbox, false))
    return cudaErrorInvalidValue;
  p.A = static_cast<const float*>(in[2]);
  p.Dp = static_cast<const float*>(in[5]);
  p.bias = static_cast<const float*>(in[7]);
  p.du = static_cast<bf16*>(outputs[0]);
  p.ddt = static_cast<bf16*>(outputs[1]);
  p.dz = static_cast<bf16*>(outputs[2]);
  p.dBC_part = static_cast<float*>(outputs[3]);
  p.dADb_part = static_cast<float*>(outputs[4]);
  p.L = L;
  p.D = D;
  cudaError_t err = allow(scan_bwd, kBwdSmem, g_allowed_bwd);
  if (err != cudaSuccess) return err;
  scan_bwd<<<dim3(Bsz, (D + kChannels - 1) / kChannels), kThreads, kBwdSmem,
             static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The segment count the forward entry points take for segments = 0.
int scan_sm90_segments(int Bsz, int L, int D) { return choose_segments(Bsz, L, D); }

// The steps between h_entries (kHTile), and the channels of a block.
int scan_sm90_entry_tile() { return kHTile; }

int scan_sm90_block_channels() { return kChannels; }

const char* scan_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef SCAN_PHASE_TRACE
// Copies the stamps (2 x 4096 values, warp 0's then warp 2's) to h.
int scan_phase_trace_read(unsigned long long* h) {
  return cudaMemcpyFromSymbol(h, g_stamp, sizeof(g_stamp));
}
#endif

}  // extern "C"
