// Mamba-1 selective scan, backward, fp32. For the forward
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
// Replaces the TPU kernel `_bwd_kernel` (`_pallas_scan_bwd`, reached through
// `_vjp_bwd` in si_mamba_tpu/ops/pallas/selective_scan_kernel.py). The TPU
// kernel walks a reversed grid axis and carries dh in VMEM from one grid step
// to the next; blocks on the H100 run in no order, so here one block owns a
// run of channels over all of L and walks the tiles in reverse inside the
// block: that loop takes the place of the reversed grid axis.
//
// Bound on the H100: bytes and exponentials close together. The least
// traffic at B=32, L=512, d=768: reads of u, dt, z, g (4 x 50.3 MB), B and C
// (2 x 1 MB) and h_entries (50.3 MB); writes of du, ddt, dz (3 x 50.3 MB)
// and the partials (dB/dC 2 x 12.6 MB at 12 channel blocks, dA 1.6 MB): about
// 431 MB, 129 us at 3.35 TB/s. The work is two exponentials per state element
// (the tile's states are rebuilt once, then each step's a_t is computed
// again) and about 20 other fp32 operations per state element.
//
// Design: grid (B, ceil(d/64)); one thread per channel, 64 channels (two
// warps) a block. For each tile of kChunk = 16 steps, last tile first:
//  1. B_t and C_t of the tile are staged in shared memory (shared by the
//     block's channels), u and dt in registers;
//  2. each thread rebuilds the states before each step of the tile from the
//     tile's entry state (h_entries, written by the forward's training
//     variant) into its own column of a [kChunk][n][64] shared array (64 KB:
//     dynamic shared memory, allowed past 48 KB by cudaFuncSetAttribute), with
//     the forward's arithmetic, so the states are the forward's;
//  3. it steps back through the tile with dh (n registers) carried across
//     tiles. y_pre = C_t . h_t + D u_t, which dz needs, is recomputed from the
//     state in hand (the TPU kernel saves it in the forward instead).
//     du, ddt and dz are written per step; dA, dD and ddt_bias accumulate in
//     registers over all of L and are written once as per-batch partials.
//  4. dB_t and dC_t are sums over channels: each warp reduces its 2n = 32
//     values with a 31-shuffle reduce-scatter (lane l ends with value l), the
//     two warps' sums meet in shared memory at the end of the tile, and one
//     pass writes the per-(batch, channel block) partials.
// The wrapper's torch.sum finishes every partial, as XLA finishes the TPU
// kernel's; there are no atomics, so the sums are deterministic. The inputs
// may be column slices of wider buffers (u and z of xz, B and C of x_dbl):
// each takes its own batch and row stride. No fast math: expf and log1pf,
// softplus as in the forward.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;  // the forward's tile: h_entries has one state per tile

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// On entry every lane holds v[0..31]; on exit v[0] on lane l is the sum of
// v[l] over the warp's lanes.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      const float send = upper ? v[i] : v[i + off];
      const float keep = upper ? v[i + off] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

template <int N>
constexpr int smem_floats() {
  return kChunk * N * kThreads + 2 * kChunk * N + kWarps * kChunk * 2 * N;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ u,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ Dp,
                          const float* __restrict__ z,
                          const float* __restrict__ dt_bias,
                          const float* __restrict__ g,
                          const float* __restrict__ h_entries,
                          float* __restrict__ du_out,
                          float* __restrict__ ddt_out,
                          float* __restrict__ dz_out,
                          float* __restrict__ dB_part,
                          float* __restrict__ dC_part,
                          float* __restrict__ dA_part,
                          float* __restrict__ dD_part,
                          float* __restrict__ ddtb_part, int L, int D,
                          long long u_sb, long long u_sr,
                          long long dt_sb, long long dt_sr,
                          long long B_sb, long long B_sr,
                          long long C_sb, long long C_sr,
                          long long z_sb, long long z_sr,
                          long long g_sb, long long g_sr) {
  static_assert(2 * N == 32, "the dB/dC reduce-scatter packs 2n values in a warp");
  extern __shared__ float smem[];
  float* st = smem;                        // [kChunk][N][kThreads]: h before step r
  float* sB = st + kChunk * N * kThreads;  // [kChunk][N]
  float* sC = sB + kChunk * N;             // [kChunk][N]
  float* red = sC + kChunk * N;            // [kWarps][kChunk][2N]

  const int b = blockIdx.x;
  const int blk = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = blk * kThreads + tid;
  const bool active = d < D;
  const int dd = active ? d : 0;  // keeps masked-off threads' addresses valid
  const int nc = (L + kChunk - 1) / kChunk;

  float a[N], dh[N], dA[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = active ? A[dd * N + n] : 0.f;
    dh[n] = 0.f;  // a_{t+1} dh_{t+1}, carried backwards
    dA[n] = 0.f;
  }
  const float skip = active ? Dp[dd] : 0.f;
  const float bias = active ? dt_bias[dd] : 0.f;
  float dD = 0.f, ddtb = 0.f;

  const float* ub = u + b * u_sb + dd;
  const float* dtb = dt + b * dt_sb + dd;
  const float* zb = z + b * z_sb + dd;
  const float* gb = g + b * g_sb + dd;
  const float* Bb = Bm + b * B_sb;
  const float* Cb = Cm + b * C_sb;
  const float* hb = h_entries + static_cast<long long>(b) * nc * N * D + dd;
  const long long row0 = static_cast<long long>(b) * L * D + dd;
  const long long part0 = (static_cast<long long>(b) * gridDim.y + blk) * L;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int r = i / N, n = i % N, t = t0 + r;
      sB[i] = t < L ? Bb[t * B_sr + n] : 0.f;
      sC[i] = t < L ? Cb[t * C_sr + n] : 0.f;
    }
    float uu[kChunk], vv[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) {
      const long long t = t0 + r;
      const bool ok = active && t < L;
      uu[r] = ok ? ub[t * u_sr] : 0.f;
      vv[r] = (ok ? dtb[t * dt_sr] : 0.f) + bias;
    }
    __syncthreads();

    // rebuild the states before each step of the tile (the forward's arithmetic)
    {
      float h[N];
#pragma unroll
      for (int n = 0; n < N; ++n)
        h[n] = active ? hb[(static_cast<long long>(c) * N + n) * D] : 0.f;
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
#pragma unroll
        for (int n = 0; n < N; ++n) st[(r * N + n) * kThreads + tid] = h[n];
        if (t0 + r < L) {
          const float delta = softplus(vv[r]);
          const float du = delta * uu[r];
#pragma unroll
          for (int n = 0; n < N; ++n)
            h[n] = expf(delta * a[n]) * h[n] + du * sB[r * N + n];
        }
      }
    }

    // step back through the tile
#pragma unroll
    for (int r = kChunk - 1; r >= 0; --r) {
      const int t = t0 + r;
      if (t >= L) continue;  // the same for every thread of the block
      const bool ok = active;
      const float zz = ok ? zb[static_cast<long long>(t) * z_sr] : 0.f;
      const float gg = ok ? gb[static_cast<long long>(t) * g_sr] : 0.f;
      const float delta = softplus(vv[r]);
      const float du = delta * uu[r];
      const float sig_z = sigmoid(zz);
      const float gy = gg * (zz * sig_z);
      float vals[2 * N];
      float y_pre = 0.f, dhb = 0.f, dda = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float hp = st[(r * N + n) * kThreads + tid];
        const float an = expf(delta * a[n]);
        const float ht = an * hp + du * sB[r * N + n];
        y_pre += sC[r * N + n] * ht;
        const float dhn = gy * sC[r * N + n] + dh[n];
        const float daa = dhn * hp * an;
        dA[n] += daa * delta;
        dda += daa * a[n];
        dhb += dhn * sB[r * N + n];
        vals[n] = dhn * du;     // dB_t, this channel's term
        vals[N + n] = ht * gy;  // dC_t, this channel's term
        dh[n] = an * dhn;
      }
      y_pre += skip * uu[r];
      const float ddt = (dda + dhb * uu[r]) * sigmoid(vv[r]);
      dD += gy * uu[r];
      ddtb += ddt;
      if (active) {
        const long long o = row0 + static_cast<long long>(t) * D;
        du_out[o] = delta * dhb + gy * skip;
        ddt_out[o] = ddt;
        dz_out[o] = gg * y_pre * (sig_z * (1.f + zz * (1.f - sig_z)));
      }
      red[(warp * kChunk + r) * 2 * N + lane] = warp_reduce_scatter(vals);
    }
    __syncthreads();

    for (int i = tid; i < kChunk * 2 * N; i += kThreads) {
      const int r = i / (2 * N), j = i % (2 * N), t = t0 + r;
      if (t < L) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[(w * kChunk + r) * 2 * N + j];
        float* out = j < N ? dB_part : dC_part;
        out[(part0 + t) * N + (j % N)] = s;
      }
    }
    __syncthreads();  // the next tile overwrites sB, sC and red
  }

  if (active) {
    const long long o = static_cast<long long>(b) * D + d;
#pragma unroll
    for (int n = 0; n < N; ++n) dA_part[o * N + n] = dA[n];
    dD_part[o] = dD;
    ddtb_part[o] = ddtb;
  }
}

template <int N>
cudaError_t launch(const float* const* in, float* const* out, int Bsz, int L,
                   int D, const long long* s, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<N>();
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Bsz, (D + kThreads - 1) / kThreads);
  selective_scan_bwd_kernel<N><<<grid, kThreads, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      out[0], out[1], out[2], out[3], out[4], out[5], out[6], out[7], L, D,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]);
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
int selective_scan_bwd(const void* const* inputs, void* const* outputs, int Bsz,
                       int L, int D, int N, const long long* strides,
                       void* stream) {
  if (N != 16) return cudaErrorInvalidValue;
  return launch<16>(reinterpret_cast<const float* const*>(inputs),
                    reinterpret_cast<float* const*>(outputs), Bsz, L, D,
                    strides, static_cast<cudaStream_t>(stream));
}

int selective_scan_bwd_chunk_len() { return kChunk; }

int selective_scan_bwd_block_channels() { return kThreads; }

const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
