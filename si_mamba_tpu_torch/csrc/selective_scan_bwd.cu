// Mamba-1 selective scan, backward, fp32 activations. For the forward
//
//   delta_t = softplus(dt_t + dt_bias)
//   h_t     = a_t * h_{t-1} + (delta_t * u_t) * B_t,   a_t = exp(delta_t * A)
//   y_t     = (C_t . h_t + D * u_t) * silu(z_t)
//
// and the output gradient g, it computes du, ddt, dz (B, L, d) and partial
// sums of dA (B, d, n), dB and dC (B, ceil(d/64), L, n), dD and ddt_bias
// (B, d), through the reverse recurrence
//
//   dh_t = gy_t * C_t + a_{t+1} * dh_{t+1},   gy_t = g_t * silu(z_t).
//
// Replaces the TPU kernel `_bwd_kernel` (the `pallas_call` of
// `_pallas_scan_bwd`, reached through `_vjp_bwd` in
// si_mamba_tpu/ops/pallas/selective_scan_kernel.py). The TPU kernel walks a
// reversed grid axis and carries dh in VMEM from one grid step to the next;
// blocks on the H100 run in no order, so here one block owns a run of channels
// over all of L and walks the tiles in reverse inside the block: that loop
// takes the place of the reversed grid axis.
//
// Bound on the H100: bytes. The least traffic at B=32, L=512, d=768: reads
// of u, dt, z, g (4 x 50.3 MB), B and C (2 x 1 MB) and h_entries (50.3 MB);
// writes of du, ddt, dz (3 x 50.3 MB) and the partials (dB/dC 2 x 12.6 MB at
// 12 channel blocks, dA 1.6 MB): about 431 MB, 129 us at 3.35 TB/s. The work
// is two decays per state element (one to rebuild the tile's states, one to
// step back; MUFU ex2 at 16 a cycle an SM, about 0.11 ms) and about 17 other
// fp32 operations per state element; with the lanes' shuffles and
// shared-memory traffic that is an estimated 0.25 ms of instructions at one a
// cycle per scheduler: the kernel is held by instruction throughput and
// latency long before bytes.
//
// Design. Each channel's 16 states are split over a group of kLanes = 4 lanes,
// four states a lane; a warp takes 8 channels and a block of 256 threads 64
// channels. Grid (B, ceil(d/64)): 384 blocks at B=32, d=768, all resident at
// once at three blocks an SM (24 warps an SM), which caps a thread at 80
// registers (ptxas spills about 136 bytes a thread) and a block at 66 KB of
// dynamic shared memory. For each tile of kChunk = 16 steps, last tile first:
//  1. lane q of a group loads u, dt, z and g of the channel for steps q, q+4,
//     q+8, q+12 of the tile (its owned steps) and computes their per-channel
//     scalars (delta, delta*u, gy = g silu(z) and the dz gate) once; at each
//     step the owner hands delta, delta*u and gy to the other three lanes with
//     a shuffle. B_t and C_t of the tile sit in shared memory (shared by the
//     block's channels, one value of each a thread); a lane reads its four
//     states' values as one float4;
//  2. each lane rebuilds its four states before each step of the tile from the
//     tile's entry state (h_entries, written by the forward's training
//     variant), with the forward's arithmetic, into its own 16-byte slot of a
//     [kChunk][64 channels][16 states] shared array (64 KB): a lane reads back
//     only what it wrote, so no barrier guards it;
//  3. it steps back through the tile with dh (four registers) carried across
//     tiles. Of each step's three channel sums (y_pre = C_t . h_t, dh_t . B_t
//     and the A-weighted sum of the decay terms) a lane holds its four
//     states' share; those of four steps in a row are reduce-scattered over
//     the group at once (9 shuffles for 12 values), each landing on the lane
//     that owns its step, which writes du, ddt and dz of its four steps at the
//     tile's end. dA, dD and ddt_bias accumulate in registers over all of L;
//  4. dB_t and dC_t are sums over channels. A lane's 8 terms (4 states x 2)
//     are reduce-scattered over the warp's 8 channels in three xor-shuffle
//     levels (7 shuffles), leaving one of the warp's 32 sums on each lane; the
//     lane parks it in the step's shared-memory slot, which the step back has
//     just read, and after the tile one pass adds the 8 warps' values and
//     writes the per-(batch, channel block) partials.
// A tile wholly inside L takes a copy of the step loops without the per-step
// bound test; offsets inside a batch row are 32-bit and the pointers move a
// tile at a time. The wrapper's torch.sum finishes every partial, as XLA
// finishes the TPU kernel's; there are no atomics and every sum runs in a
// fixed order, so the kernel is bitwise deterministic. The inputs may be
// column slices of wider buffers (u and z of xz, B and C of x_dbl): each takes
// its own batch and row stride. softplus and the sigmoids use the accurate
// expf and log1pf; the decay is ex2.approx.ftz(delta * (A log2 e)), as in the
// forward.
//
// Changed from the first design (one thread per channel with all 16 states, 64
// threads a block, 70 KB of shared memory a block and so at most 6 warps an
// SM; two accurate expf per state element; z and g loaded one step at a time
// inside the reverse loop; a 31-shuffle reduce-scatter of 32 values a step):
// the lane split (4x the threads, each with a quarter of the chain), the
// shuffle-shared per-step scalars and grouped channel sums, the 7-shuffle
// reduce-scatter, the special-function-unit decay and the full-tile loops.
// The tile's operands are loaded at its start: holding the next tile's in
// registers while this one computes, as the forward does, needs more than the
// 80 registers that three blocks an SM leave a thread.
//
// The element type T is fp32 here; the bf16 backward runs on its Hopper body,
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
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 32 / kLanes;          // channels per warp
constexpr int kChunk = 16;  // the forward's tile: h_entries has one state per tile
constexpr int kOwned = kChunk / kLanes;       // steps of a tile whose scalars a lane computes
constexpr int kTileFloats = 2 * kChunk * kState;       // B and C of one tile
constexpr int kStateFloats = kChunk * kChannels * kState;  // the rebuilt states of a tile
constexpr int kSmemBytes = (kStateFloats + kTileFloats) * 4;
constexpr int kMinBlocks = 3;                 // blocks an SM: the whole grid in one wave
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kPerLane == 4, "a lane's states, B and C values move as one float4");
static_assert(2 * kPerLane == kGroups, "the dB/dC reduce-scatter leaves one sum a lane");
static_assert(kThreads == kChunk * kState, "each thread stages one B and one C value of a tile");
static_assert(kLanes == 4, "the owned steps' channel sums are reduce-scattered in two levels");

template <typename T>
struct BwdArgs {
  const T* u;
  const T* dt;
  const float* A;
  const T* Bm;
  const T* Cm;
  const float* Dp;
  const T* z;
  const float* dt_bias;
  const T* g;
  const float* h_entries;
  T* du;
  T* ddt;
  T* dz;
  float* dB_part;
  float* dC_part;
  float* dA_part;
  float* dD_part;
  float* ddtb_part;
  int L, D;
  long long u_sb, dt_sb, B_sb, C_sb, z_sb, g_sb;  // batch strides
  int u_sr, dt_sr, B_sr, C_sr, z_sr, g_sr;        // row strides
};

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// 2^x on the special-function unit alone (MUFU.EX2, 2 ulp), as in the forward.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// On entry every lane holds v[0..7], its channel's terms; on exit v[0] on lane
// l is the sum over the warp's 8 channels of v[l / kLanes] of the lanes with
// the same l % kLanes.
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

// On entry every lane of a group holds v[3 j + k] for j < kLanes, k < 3;
// on exit v[0..2] on lane q of the group are the group's sums of v[3 q + k].
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

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
selective_scan_bwd_kernel(const BwdArgs<T> p) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // [kChunk][kChannels][kState]
  float* sBC = st + kStateFloats;               // [B | C][kChunk][kState]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = lane & (kLanes - 1);  // this lane's states: q*kPerLane ...
  const int group = lane & ~(kLanes - 1);
  const int ch = tid / kLanes;
  const int d = blockIdx.y * kChannels + ch;
  const bool active = d < p.D;
  const int dd = active ? d : 0;  // keeps masked-off lanes' addresses valid
  const int b = blockIdx.x;
  const int L = p.L, D = p.D;
  const int nc = (L + kChunk - 1) / kChunk;

  float a2[kPerLane], dh[kPerLane], dA[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    a2[i] = active ? p.A[dd * kState + q * kPerLane + i] * kLog2e : 0.f;
    dh[i] = 0.f;  // a_{t+1} dh_{t+1}, carried backwards
    dA[i] = 0.f;
  }
  const float skip = active ? p.Dp[dd] : 0.f;
  const float bias = active ? p.dt_bias[dd] : 0.f;
  float dD = 0.f, ddtb = 0.f;

  // Offsets inside one batch row are 32-bit (the wrapper checks that they
  // fit). Each lane's pointers sit at its first owned step of the last tile,
  // each thread's B and C pointers at its element of that tile (row sr, state
  // sn), and move back a tile at a time.
  const int sr = tid / kState, sn = tid % kState;
  const int last = (nc - 1) * kChunk;
  const T* up = p.u + b * p.u_sb + (last + q) * p.u_sr + dd;
  const T* dtp = p.dt + b * p.dt_sb + (last + q) * p.dt_sr + dd;
  const T* zp = p.z + b * p.z_sb + (last + q) * p.z_sr + dd;
  const T* gp = p.g + b * p.g_sb + (last + q) * p.g_sr + dd;
  const T* Bp = p.Bm + b * p.B_sb + (last + sr) * p.B_sr + sn;
  const T* Cp = p.Cm + b * p.C_sb + (last + sr) * p.C_sr + sn;
  const float* hp_in = p.h_entries + (static_cast<long long>(b) * nc + nc - 1) * kState * D +
                       q * kPerLane * D + dd;
  const long long row_b = static_cast<long long>(b) * L * D;
  const long long part0 = (static_cast<long long>(b) * gridDim.y + blockIdx.y) * L;
  const float4* sB = reinterpret_cast<const float4*>(sBC);
  const float4* sC = reinterpret_cast<const float4*>(sBC + kChunk * kState);
  float4* st4 = reinterpret_cast<float4*>(st);

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    // this lane's raw values of its owned steps and its entry state, this
    // thread's B and C elements
    float own_u[kOwned], own_v[kOwned], nz[kOwned], ng[kOwned], h[kPerLane];
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      const bool ok = active && t0 + j * kLanes + q < L;
      own_u[j] = ok ? to_f(up[j * kLanes * p.u_sr]) : 0.f;
      own_v[j] = (ok ? to_f(dtp[j * kLanes * p.dt_sr]) : 0.f) + bias;
      nz[j] = ok ? to_f(zp[j * kLanes * p.z_sr]) : 0.f;
      ng[j] = ok ? to_f(gp[j * kLanes * p.g_sr]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) h[i] = active ? hp_in[i * D] : 0.f;
    const bool bc_ok = t0 + sr < L;
    sBC[tid] = bc_ok ? to_f(*Bp) : 0.f;
    sBC[kThreads + tid] = bc_ok ? to_f(*Cp) : 0.f;
    up -= kChunk * p.u_sr;
    dtp -= kChunk * p.dt_sr;
    zp -= kChunk * p.z_sr;
    gp -= kChunk * p.g_sr;
    Bp -= kChunk * p.B_sr;
    Cp -= kChunk * p.C_sr;
    hp_in -= kState * D;
    // the B/C tile is in place, and the last tile's partial pass has read st
    __syncthreads();

    float own_delta[kOwned], own_du[kOwned], own_gy[kOwned], own_gz[kOwned];
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      const float zz = nz[j], sig_z = sigmoid(zz);
      own_delta[j] = softplus(own_v[j]);
      own_du[j] = own_delta[j] * own_u[j];
      own_gy[j] = ng[j] * (zz * sig_z);
      own_gz[j] = ng[j] * (sig_z * (1.f + zz * (1.f - sig_z)));
    }

    // the channel sums of the owned steps: y_pre = C_t . h_t, dh_t . B_t and
    // the A-weighted sum of the decay terms
    float s_y[kOwned], s_dhb[kOwned], s_dda[kOwned];
    // the tile's steps; kFull: all kChunk of them lie before L
    auto scan_tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      // rebuild the states before each step of the tile (the forward's arithmetic)
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        st4[(r * kChannels + ch) * kLanes + q] = make_float4(h[0], h[1], h[2], h[3]);
        if (kFull || t0 + r < L) {  // the same for every thread of the block
          const int src = group | (r & (kLanes - 1));
          const float delta = __shfl_sync(0xffffffffu, own_delta[r / kLanes], src);
          const float du = __shfl_sync(0xffffffffu, own_du[r / kLanes], src);
          const float4 Bv = sB[r * kLanes + q];
          const float Bs[kPerLane] = {Bv.x, Bv.y, Bv.z, Bv.w};
#pragma unroll
          for (int i = 0; i < kPerLane; ++i)
            h[i] = fmaf(exp2_sfu(delta * a2[i]), h[i], du * Bs[i]);
        }
      }

      // step back through the tile; the three channel sums of four steps in a
      // row are reduce-scattered over the group at once, each landing on the
      // lane that owns its step
      float sums[kLanes * 3];
#pragma unroll
      for (int r = kChunk - 1; r >= 0; --r) {
        const int j = r & (kLanes - 1);
        if (kFull || t0 + r < L) {  // the same for every thread of the block
          const int src = group | j;
          const float delta = __shfl_sync(0xffffffffu, own_delta[r / kLanes], src);
          const float du = __shfl_sync(0xffffffffu, own_du[r / kLanes], src);
          const float gy = __shfl_sync(0xffffffffu, own_gy[r / kLanes], src);
          const float4 hv = st4[(r * kChannels + ch) * kLanes + q];
          const float4 Bv = sB[r * kLanes + q];
          const float4 Cv = sC[r * kLanes + q];
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
          st[(r * kChannels + warp * kGroups) * kState + lane] = part;
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
    if (t0 + kChunk <= L) {
      scan_tile(std::true_type{});
    } else {
      scan_tile(std::false_type{});
    }

    // du, ddt, dz of the owned steps
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      const int t = t0 + j * kLanes + q;
      if (t < L) {
        const float ddt = fmaf(s_dda[j], kLn2, s_dhb[j] * own_u[j]) * sigmoid(own_v[j]);
        dD = fmaf(own_gy[j], own_u[j], dD);
        ddtb += ddt;
        if (active) {
          const long long o = row_b + t * D + dd;
          p.du[o] = from_f<T>(fmaf(own_delta[j], s_dhb[j], own_gy[j] * skip));
          p.ddt[o] = from_f<T>(ddt);
          // y_pre as the forward stores it, in T (identity for fp32)
          p.dz[o] = from_f<T>(own_gz[j] * round_to<T>(fmaf(skip, own_u[j], s_y[j])));
        }
      }
    }
    __syncthreads();  // every warp's dB/dC sums of the tile are parked in st

    // add the warps' sums: lane l of warp w holds, for state group l % 4, the
    // dB (l / 4 < 4) or dC sum of state 4 (l % 4) + (l / 4) % 4
    for (int i = tid; i < kChunk * 32; i += kThreads) {
      const int r = i / 32, l = i % 32, t = t0 + r;
      if (t < L) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += st[(r * kChannels + w * kGroups) * kState + l];
        const int kind = l / kLanes / kPerLane;
        const int n = (l % kLanes) * kPerLane + (l / kLanes) % kPerLane;
        (kind == 0 ? p.dB_part : p.dC_part)[(part0 + t) * kState + n] = s;
      }
    }
  }

  dD = group_sum(dD);
  ddtb = group_sum(ddtb);
  if (active) {
    const long long o = static_cast<long long>(b) * D + d;
    reinterpret_cast<float4*>(p.dA_part)[o * kLanes + q] = make_float4(dA[0], dA[1], dA[2], dA[3]);
    if (q == 0) {
      p.dD_part[o] = dD;
      p.ddtb_part[o] = ddtb;
    }
  }
}

template <typename T>
int bwd_entry(const void* const* inputs, void* const* outputs, int Bsz, int L, int D, int N,
              const long long* strides, void* stream) {
  if (N != kState) return cudaErrorInvalidValue;
  const void* const* in = inputs;
  void* const* out = outputs;
  const long long* s = strides;
  const BwdArgs<T> p{static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
                     static_cast<const float*>(in[2]), static_cast<const T*>(in[3]),
                     static_cast<const T*>(in[4]), static_cast<const float*>(in[5]),
                     static_cast<const T*>(in[6]), static_cast<const float*>(in[7]),
                     static_cast<const T*>(in[8]), static_cast<const float*>(in[9]),
                     static_cast<T*>(out[0]), static_cast<T*>(out[1]), static_cast<T*>(out[2]),
                     static_cast<float*>(out[3]), static_cast<float*>(out[4]),
                     static_cast<float*>(out[5]), static_cast<float*>(out[6]),
                     static_cast<float*>(out[7]), L, D,
                     s[0], s[2], s[4], s[6], s[8], s[10],
                     static_cast<int>(s[1]), static_cast<int>(s[3]), static_cast<int>(s[5]),
                     static_cast<int>(s[7]), static_cast<int>(s[9]), static_cast<int>(s[11])};
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(Bsz, (D + kChannels - 1) / kChannels);
  selective_scan_bwd_kernel<T>
      <<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Inputs, in this order: u, dt, A, Bm, Cm, Dp, z, dt_bias, g, h_entries.
// u, dt, z, g: (Bsz, L, D); Bm, Cm: (Bsz, L, N); each with unit stride along
// its last axis and the (batch, row) strides given in `strides` in the order
// u, dt, B, C, z, g (12 values). A: (D, N), Dp, dt_bias: (D,), h_entries:
// (Bsz, ceil(L/16), N, D), all contiguous.
// Outputs, contiguous, in this order: du, ddt, dz (Bsz, L, D); dB_part,
// dC_part (Bsz, ceil(D/64), L, N); dA_part (Bsz, D, N); dD_part, ddtb_part
// (Bsz, D). Returns a cudaError_t code (cudaErrorInvalidValue for an N other
// than 16).
int selective_scan_bwd(const void* const* inputs, void* const* outputs, int Bsz, int L, int D,
                       int N, const long long* strides, void* stream) {
  return bwd_entry<float>(inputs, outputs, Bsz, L, D, N, strides, stream);
}

int selective_scan_bwd_chunk_len() { return kChunk; }

int selective_scan_bwd_block_channels() { return kChannels; }

const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
