// Mamba-1 selective scan, forward, fp32 activations:
//
//   delta_t = softplus(dt_t + dt_bias)
//   h_t     = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) * B_t   (fp32 state)
//   y_t     = (C_t . h_t + D * u_t) * silu(z_t)
//
// Replaces the TPU kernel `_fwd_kernel` (the `pallas_call` of
// `_pallas_scan_fwd` in si_mamba_tpu/ops/pallas/selective_scan_kernel.py) in
// both of its variants: the lean inference forward (K2, `emit_residuals=False`,
// reached from `selective_scan_pallas`) and the training forward (K3,
// `emit_residuals=True`, reached through `_vjp_fwd`), which also writes the
// fp32 state at the entry of every kChunk-step tile, h_entries (B,
// ceil(L/kChunk), N, D): the anchors from which the backward
// (selective_scan_bwd.cu) rebuilds each tile's states. The TPU kernel scans
// (n, T, block_d) chunks with Hillis-Steele passes and pads L to a multiple of
// 128; none of that layout carries over.
//
// Bound on the H100: bytes. The least traffic at
// B=32, L=512, d=768 is one read of u, dt, z (3 x 50.3 MB) and of B and C
// (2 x 1 MB) and one write of y (50.3 MB), about 203 MB or 61 us at 3.35
// TB/s; K3 adds h_entries (50.3 MB). The work is B*L*d*n = 201 M decays (one
// MUFU ex2 each, at 16 a cycle an SM about 54 us) and about five other fp32
// operations per state element, plus a softplus, a sigmoid and the gate per
// (b, l, d); with the lanes' share of addressing, shuffles and shared-memory
// reads that is an estimated 0.1 ms of instructions at one a cycle per
// scheduler, so the kernel is held by instruction throughput before bytes.
//
// Design. Each channel's 16 states are split over a group of kLanes = 4
// lanes, four states a lane, so a warp scans 8 channels and a block of 256
// threads 64 channels. Grid (B, ceil(d/64), segments); 80 registers a thread
// (__launch_bounds__ with 3 blocks an SM: 24 warps), 4 KB of shared memory a
// block, no spills. At B=32, d=768 that is 384 blocks, one wave on 132 SMs.
// Per tile of kChunk = 16 steps:
//  - lane q of a group computes the channel's per-step scalars (softplus of
//    dt + dt_bias, delta*u, silu(z)) for steps q, q+4, q+8 and q+12 only, from
//    its own loads; at each step the owner lane hands delta and delta*u to the
//    other three with a shuffle, so no lane repeats the softplus;
//  - B_t and C_t of the tile (shared by all the block's channels) sit in shared
//    memory, double-buffered, one value of each a thread; each lane reads its
//    four states' values as one float4;
//  - each lane advances its four states (ex2 of delta * A*log2(e) on the
//    special-function unit, one fma), and the C.h sum is finished with two
//    xor-shuffles in the group; a tile wholly inside L takes a copy of the
//    step loop without the per-step bound test;
//  - the next tile's u, dt, z and B, C are loaded into registers before this
//    tile is computed, so their latency overlaps the arithmetic; offsets inside
//    a batch row are 32-bit and the pointers move a tile at a time;
//  - y of a lane's four owned steps is written at the tile's end; K3 writes
//    its four states of the tile-entry state, a warp's 8 channels filling one
//    32-byte sector per state.
// At small batch the one-pass grid leaves most SMs idle (12 blocks at one
// cloud), so while it has fewer blocks than the card has SMs, L is cut into
// segments (a multiple of kChunk steps each, up to 16 of them, about 384
// blocks in all) and the scan takes two kernels: the first scans every
// segment but the last from a zero state and writes its end state and the sum
// of its deltas; the second scans every segment again from its true entry
// state, which each block composes from the earlier segments' end states as
// h <- exp(A * sum delta_k) * h + h_end_k, and writes y (and K3's h_entries,
// each tile lying inside one segment). This doubles the arithmetic, which at
// small batch costs less than the idle SMs. `selective_scan_fwd_segments`
// picks the count from the shape, and K3 takes the same count as K2, so the two
// give the same y bit for bit.
//
// The inputs may be column slices of wider buffers (z of xz, B and C of
// x_dbl): each takes its own batch and row stride, and no view is copied. No
// padding of L or d: the ragged edges are masked. softplus is
// `v > 20 ? v : log1pf(expf(v))` and silu is z / (1 + expf(-z)), with the
// accurate expf/log1pf; the decay is ex2.approx.ftz(delta * (A log2 e)),
// within 2 ulp, a decay below 2^-126 being 0.
//
// Changed from the first design (one thread per channel carrying all 16
// states, grid (B, ceil(d/128)): 192 blocks at B=32, 1.45 waves, and 6 blocks
// at one cloud; accurate expf per decay; 64-bit offsets recomputed per load;
// a strided 16-value h_entries store a thread): the lane split, the
// shuffle-shared per-step scalars, the register prefetch of the next tile, the
// double-buffered B/C tile, the special-function-unit decay, the full-tile
// step loop and the segmented two-kernel scan at small batch.
//
// The element type T is fp32 here; the bf16 scan runs on its Hopper body,
// csrc/selective_scan_bf16_sm90.cu, which replaced this body's bf16
// instantiation.

#include <cuda_runtime.h>

#include <type_traits>

#include "elem.cuh"

namespace {

constexpr int kState = 16;                    // d_state, the only one a ported model uses
constexpr int kLanes = 4;                     // lanes per channel
constexpr int kPerLane = kState / kLanes;     // states a lane carries
constexpr int kChannels = 64;                 // channels per block
constexpr int kThreads = kChannels * kLanes;  // 256
constexpr int kChunk = 16;                    // steps per tile; h_entries has one state per tile
constexpr int kOwned = kChunk / kLanes;       // steps of a tile whose scalars a lane computes
constexpr int kTileFloats = 2 * kChunk * kState;  // B and C of one tile
constexpr int kMaxSegments = 16;
constexpr int kMinSegmentTiles = 2;           // a segment spans at least this many tiles
constexpr int kMinBlocks = 3;                 // blocks an SM: 24 warps
constexpr int kSplitBelow = 132;              // L is cut when the one-pass grid has fewer blocks
constexpr int kTargetBlocks = 384;            // and cut further up to this many blocks
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kPerLane == 4, "a lane's B and C values are read as one float4");
static_assert(kThreads == kChunk * kState, "each thread stages one B and one C value of a tile");

template <typename T>
struct FwdArgs {
  const T* u;
  const T* dt;
  const float* A;
  const T* Bm;
  const T* Cm;
  const float* Dp;
  const T* z;
  const float* dt_bias;
  T* y;
  float* h_entries;  // (Bsz, ceil(L/kChunk), kState, D), or null
  float* h_end;      // (Bsz, segments - 1, kState, D): each segment's end state from 0
  float* dsum;       // (Bsz, segments - 1, D): each segment's sum of delta
  int L, D, seg_len, segments;
  long long u_sb, dt_sb, B_sb, C_sb, z_sb;  // batch strides
  int u_sr, dt_sr, B_sr, C_sr, z_sr;        // row strides
};

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// 2^x on the special-function unit alone (MUFU.EX2, 2 ulp); a result below
// 2^-126 is 0, where exp2f would take extra instructions to keep it subnormal.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kEnds: the first of the two segmented kernels (segment end states and delta
// sums, no y). Otherwise the scan that writes y, and h_entries if kResiduals.
template <typename T, bool kResiduals, bool kEnds>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_fwd_kernel(const FwdArgs<T> p) {
  __shared__ __align__(16) float sBC[2][kTileFloats];  // [buffer][B | C][step][state]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = lane & (kLanes - 1);  // this lane's states: q*kPerLane ...
  const int group = lane & ~(kLanes - 1);
  const int d = blockIdx.y * kChannels + tid / kLanes;
  const bool active = d < p.D;
  const int dd = active ? d : 0;  // keeps masked-off lanes' addresses valid
  const int b = blockIdx.x;
  const int seg = blockIdx.z;
  const int t_begin = seg * p.seg_len;
  const int t_end = min(t_begin + p.seg_len, p.L);
  const int nc = (p.L + kChunk - 1) / kChunk;

  float a2[kPerLane], h[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    a2[i] = active ? p.A[dd * kState + q * kPerLane + i] * kLog2e : 0.f;
    h[i] = 0.f;
  }
  const float skip = active ? p.Dp[dd] : 0.f;
  const float bias = active ? p.dt_bias[dd] : 0.f;

  if (!kEnds && seg > 0) {
    // the entry state, composed from the end states of the segments before
    const long long s0 = static_cast<long long>(b) * (p.segments - 1);
#pragma unroll 4
    for (int k = 0; k < seg; ++k) {
      const float sd = active ? p.dsum[(s0 + k) * p.D + dd] : 0.f;
      const float* he = p.h_end + ((s0 + k) * kState + q * kPerLane) * p.D + dd;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        h[i] = fmaf(exp2_sfu(sd * a2[i]), h[i], active ? he[i * p.D] : 0.f);
    }
  }

  // Offsets inside one batch row are 32-bit (the wrapper checks that they
  // fit). Each lane's pointers sit at its first owned step of the tile, each
  // thread's B and C pointers at its element of the tile (row sr, state sn),
  // and move a tile at a time.
  const int sr = tid / kState, sn = tid % kState;
  const T* up = p.u + b * p.u_sb + (t_begin + q) * p.u_sr + dd;
  const T* dtp = p.dt + b * p.dt_sb + (t_begin + q) * p.dt_sr + dd;
  const T* zp = p.z + b * p.z_sb + (t_begin + q) * p.z_sr + dd;
  const T* Bp = p.Bm + b * p.B_sb + (t_begin + sr) * p.B_sr + sn;
  const T* Cp = p.Cm + b * p.C_sb + (t_begin + sr) * p.C_sr + sn;
  T* yp = p.y + static_cast<long long>(b) * p.L * p.D + (t_begin + q) * p.D + dd;
  float* hres = kResiduals ? p.h_entries + ((static_cast<long long>(b) * nc + t_begin / kChunk) *
                                                kState + q * kPerLane) * p.D + dd
                           : nullptr;

  // this lane's raw values of its owned steps, and this thread's B/C elements
  float nu[kOwned], nv[kOwned], nz[kOwned], nB, nC;
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      const bool ok = active && t0 + j * kLanes + q < t_end;
      nu[j] = ok ? to_f(up[j * kLanes * p.u_sr]) : 0.f;
      nv[j] = ok ? to_f(dtp[j * kLanes * p.dt_sr]) : 0.f;
      nz[j] = !kEnds && ok ? to_f(zp[j * kLanes * p.z_sr]) : 0.f;
    }
    const bool ok = t0 + sr < t_end;
    nB = ok ? to_f(*Bp) : 0.f;
    nC = ok ? to_f(*Cp) : 0.f;
    up += kChunk * p.u_sr;
    dtp += kChunk * p.dt_sr;
    zp += kChunk * p.z_sr;
    Bp += kChunk * p.B_sr;
    Cp += kChunk * p.C_sr;
  };
  auto stage_tile = [&](int buf) {
    sBC[buf][tid] = nB;
    sBC[buf][kThreads + tid] = nC;
  };

  load_tile(t_begin);
  stage_tile(0);
  __syncthreads();

  float dsum = 0.f;
  int buf = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += kChunk, buf ^= 1) {
    if (kResiduals) {
      if (active) {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) hres[i * p.D] = h[i];
      }
      hres += kState * p.D;
    }
    float own_delta[kOwned], own_du[kOwned], own_u[kOwned], own_z[kOwned];
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      own_u[j] = nu[j];
      own_z[j] = nz[j];
      own_delta[j] = softplus(nv[j] + bias);
      own_du[j] = own_delta[j] * nu[j];
      if (kEnds && t0 + j * kLanes + q < t_end) dsum += own_delta[j];
    }
    const bool more = t0 + kChunk < t_end;
    if (more) load_tile(t0 + kChunk);  // in flight while this tile computes

    const float4* sB = reinterpret_cast<const float4*>(sBC[buf]);
    const float4* sC = reinterpret_cast<const float4*>(sBC[buf] + kChunk * kState);
    float ysel[kOwned];
    // the tile's steps; kFull: all kChunk of them lie before t_end
    auto scan_tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        if (kFull || t0 + r < t_end) {  // the same for every thread of the block
          const int src = group | (r & (kLanes - 1));
          const float delta = __shfl_sync(0xffffffffu, own_delta[r / kLanes], src);
          const float du = __shfl_sync(0xffffffffu, own_du[r / kLanes], src);
          const float4 Bv = sB[r * kLanes + q];
          const float Bs[kPerLane] = {Bv.x, Bv.y, Bv.z, Bv.w};
          if (kEnds) {
#pragma unroll
            for (int i = 0; i < kPerLane; ++i)
              h[i] = fmaf(exp2_sfu(delta * a2[i]), h[i], du * Bs[i]);
          } else {
            const float4 Cv = sC[r * kLanes + q];
            const float Cs[kPerLane] = {Cv.x, Cv.y, Cv.z, Cv.w};
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
              h[i] = fmaf(exp2_sfu(delta * a2[i]), h[i], du * Bs[i]);
              acc = fmaf(Cs[i], h[i], acc);
            }
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            acc += __shfl_xor_sync(0xffffffffu, acc, 2);
            if (q == (r & (kLanes - 1))) ysel[r / kLanes] = acc;
          }
        }
      }
    };
    if (t0 + kChunk <= t_end) {
      scan_tile(std::true_type{});
    } else {
      scan_tile(std::false_type{});
    }

    if (!kEnds) {
      if (active) {
#pragma unroll
        for (int j = 0; j < kOwned; ++j) {
          if (t0 + j * kLanes + q < t_end) {
            const float gate = own_z[j] / (1.f + expf(-own_z[j]));
            yp[j * kLanes * p.D] = from_f<T>((ysel[j] + skip * own_u[j]) * gate);
          }
        }
      }
      yp += kChunk * p.D;
    }
    if (more) stage_tile(buf ^ 1);  // the buffer read in the tile before this one
    __syncthreads();
  }

  if (kEnds) {
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
    if (active) {
      const long long s = static_cast<long long>(b) * (p.segments - 1) + seg;
      float* he = p.h_end + (s * kState + q * kPerLane) * p.D + dd;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) he[i * p.D] = h[i];
      if (q == 0) p.dsum[s * p.D + dd] = dsum;
    }
  }
}

// Segments of L for a launch of Bsz x D channels: 1 while the one-pass grid
// has a block for every SM, else the power of two (at most kMaxSegments, each
// segment at least kMinSegmentTiles tiles long) that brings the grid to
// kTargetBlocks.
int choose_segments(int Bsz, int L, int D) {
  const long long blocks = static_cast<long long>(Bsz) * ((D + kChannels - 1) / kChannels);
  const int tiles = (L + kChunk - 1) / kChunk;
  int s = 1;
  if (blocks >= kSplitBelow) return s;
  while (s * 2 <= kMaxSegments && s * 2 * kMinSegmentTiles <= tiles && blocks * s < kTargetBlocks)
    s *= 2;
  return s;
}

template <typename T, bool kResiduals>
cudaError_t launch(FwdArgs<T> p, int Bsz, int requested, cudaStream_t stream) {
  const int tiles = (p.L + kChunk - 1) / kChunk;
  const int s = requested > 0 ? requested : choose_segments(Bsz, p.L, p.D);
  if (s > kMaxSegments) return cudaErrorInvalidValue;
  p.seg_len = ((tiles + s - 1) / s) * kChunk;
  p.segments = (p.L + p.seg_len - 1) / p.seg_len;  // at most s
  const int nblk = (p.D + kChannels - 1) / kChannels;
  if (p.segments > 1) {
    if (p.h_end == nullptr || p.dsum == nullptr) return cudaErrorInvalidValue;
    selective_scan_fwd_kernel<T, false, true>
        <<<dim3(Bsz, nblk, p.segments - 1), kThreads, 0, stream>>>(p);
  }
  selective_scan_fwd_kernel<T, kResiduals, false>
      <<<dim3(Bsz, nblk, p.segments), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
FwdArgs<T> make_args(const void* u, const void* dt, const void* A, const void* Bm,
                     const void* Cm, const void* Dp, const void* z, const void* dt_bias, void* y,
                     void* h_entries, void* h_end, void* dsum, int L, int D,
                     const long long* s) {
  return FwdArgs<T>{static_cast<const T*>(u), static_cast<const T*>(dt),
                 static_cast<const float*>(A), static_cast<const T*>(Bm),
                 static_cast<const T*>(Cm), static_cast<const float*>(Dp),
                 static_cast<const T*>(z), static_cast<const float*>(dt_bias),
                 static_cast<T*>(y), static_cast<float*>(h_entries),
                 static_cast<float*>(h_end), static_cast<float*>(dsum), L, D, 0, 1,
                 s[0], s[2], s[4], s[6], s[8],
                 static_cast<int>(s[1]), static_cast<int>(s[3]), static_cast<int>(s[5]),
                 static_cast<int>(s[7]), static_cast<int>(s[9])};
}

}  // namespace

extern "C" {

// u, dt, z: (B, L, D); Bm, Cm: (B, L, N); each with unit stride along its
// last axis and the (batch, row) strides given in `strides` in the order
// u, dt, B, C, z (10 values). A: (D, N) contiguous; Dp, dt_bias: (D,);
// y: (B, L, D) contiguous. `segments` is the number of segments of L (0: the
// count selective_scan_fwd_segments gives); with more than one, h_end
// (B, segments - 1, N, D) and dsum (B, segments - 1, D) are fp32 scratch.
// Returns a cudaError_t code (cudaErrorInvalidValue for an N other than 16,
// more than 16 segments, or missing scratch).
int selective_scan_fwd(const void* u, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* Dp, const void* z, const void* dt_bias,
                       void* y, void* h_end, void* dsum, int Bsz, int L, int D, int N,
                       int segments, const long long* strides, void* stream) {
  if (N != kState) return cudaErrorInvalidValue;
  return launch<float, false>(make_args<float>(u, dt, A, Bm, Cm, Dp, z, dt_bias, y, nullptr,
                                               h_end, dsum, L, D, strides),
                              Bsz, segments, static_cast<cudaStream_t>(stream));
}

// Training variant: as selective_scan_fwd, and also writes h_entries
// (Bsz, ceil(L / kChunk), N, D) fp32 contiguous, the state before each tile.
int selective_scan_fwd_residuals(const void* u, const void* dt, const void* A, const void* Bm,
                                 const void* Cm, const void* Dp, const void* z,
                                 const void* dt_bias, void* y, void* h_entries, void* h_end,
                                 void* dsum, int Bsz, int L, int D, int N, int segments,
                                 const long long* strides, void* stream) {
  if (N != kState) return cudaErrorInvalidValue;
  return launch<float, true>(make_args<float>(u, dt, A, Bm, Cm, Dp, z, dt_bias, y, h_entries,
                                              h_end, dsum, L, D, strides),
                             Bsz, segments, static_cast<cudaStream_t>(stream));
}

// The segment count both entry points take for segments = 0.
int selective_scan_fwd_segments(int Bsz, int L, int D) { return choose_segments(Bsz, L, D); }

int selective_scan_chunk_len() { return kChunk; }

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
