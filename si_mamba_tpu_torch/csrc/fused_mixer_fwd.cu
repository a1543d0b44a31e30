// Fused Mamba-1 mixer interior, forward (K10), fp32. From xz = x @ in_proj
// (B, L, 2 DI), columns [x | z]:
//
//   xi      = silu(causal_conv(x) + conv_b)                 (width kW)
//   dt_raw  = xi @ W_dt + dt_b,  W_dt = x_proj[:, :R] @ dt_proj (folded outside)
//   B | C   = xi @ W_bc,         W_bc = x_proj[:, R:R + 2N]
//   h_t     = exp(softplus(dt_raw_t) A) h_{t-1} + softplus(dt_raw_t) xi_t B_t
//   y_t     = (C_t . h_t + D xi_t) * silu(z_t)
//
// Replaces the TPU kernel `_fwd_kernel` behind `_fused_fwd_call`
// (si_mamba_tpu/ops/pallas/fused_mixer_kernel.py), reached from
// `fused_mamba_mixer` and `mamba_mixer_apply(impl='fused')`, in two
// variants: the lean forward (serving) and, with the template flag kStates,
// the training forward that also writes the (N, DI) state entering every
// kT-token chunk, h_entries (B, ceil(L / kT), N, DI), from which the backward
// (fused_mixer_bwd.cu) restarts each chunk.
//
// Bound on the H100: fp32 operations. At B=32, L=512, DI=768, N=16 the
// products the function needs are 2 B L DI^2 (xi @ W_dt, 19.3 G) plus
// 2 B L DI 2N (B | C, 0.8 G), and the conv, SiLU, softplus, scan and gate add
// (2 kW + 15 + 7 N) operations per (b, t, channel): 21.8 GFLOP, 0.33 ms at
// 67 TFLOP/s without tensor cores. Its bytes are xz read once, y written once
// and the weights read once, 153.5 MB, 0.046 ms (chip_smoke.py computes both).
//
// Design: grid (DI / kTile, B); a block owns one batch row and kTile = 128
// channels and walks the chunks left to right with its channels' (N x 128)
// state in registers, two threads a channel with N/2 states each. Per chunk
// of kT = 16 tokens it
//   1. loads x of all DI channels for the chunk and the kW - 1 rows to its
//      left (zeros before t = 0) and writes xi = silu(conv) of every channel
//      to shared memory: dt_raw, B and C contract over all channels, so each
//      of the DI / 128 blocks of a row recomputes the conv (4 FMAs an element);
//   2. computes its 128 columns of xi @ W_dt and the 2N columns of xi @ W_bc,
//      streaming the weights through shared memory in kKT-row tiles, each
//      thread holding a (kT / 8) x 4 (or x 1) tile of the output;
//   3. runs the sequential scan of its 128 channels over the chunk, the
//      C-contraction summed across the two threads of a channel by a shuffle,
//      and writes y.
// xi, dt, B and C never reach device memory; no block exchanges data with
// another. Everything runs on CUDA cores in fp32 with the accurate expf and
// log1pf (no fast math): softplus is v > 20 ? v : log1pf(expf(v)), silu
// v / (1 + expf(-v)). Tensor cores (3xTF32), TMA and the rank-R dt product
// are later work. A ragged L is masked: rows t >= L read x = z = 0 and write
// nothing. W_dt is streamed from L2 once per chunk and block (393 KB at
// DI = 768): 16 operations a byte at kT = 16.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kT = 16;             // tokens a chunk; also the h_entries stride
constexpr int kTile = 128;         // channels a block
constexpr int kN = 16;             // d_state
constexpr int kW = 4;              // conv width
constexpr int kKT = 32;            // rows of a weight tile staged in shared memory
constexpr int kRows = kT / 8;      // output rows a thread holds in the block products
constexpr int kHalf = kN / 2;      // states a scan thread holds

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

template <bool kStates>
__global__ void __launch_bounds__(kThreads)
fused_mixer_fwd_kernel(const float* __restrict__ xz, const float* __restrict__ conv_wt,
                       const float* __restrict__ conv_b, const float* __restrict__ wdt,
                       const float* __restrict__ dtb, const float* __restrict__ wbc,
                       const float* __restrict__ at, const float* __restrict__ dskip,
                       float* __restrict__ y, float* __restrict__ h_entries, int L,
                       int DI) {
  extern __shared__ float smem[];
  float* sXi = smem;               // kT x DI: xi of every channel
  float* sB = sXi + kT * DI;       // kKT x kTile: a staged weight tile
  float* sDt = sB + kKT * kTile;   // kT x kTile: dt_raw of the block's channels
  float* sBC = sDt + kT * kTile;   // kT x 2N: B | C

  const int b = blockIdx.y, c0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int ch = tid >> 1, half = tid & 1;  // scan: channel c0 + ch, states half * kHalf + k
  const int c = c0 + ch;
  const long long row = 2LL * DI;  // xz's row stride
  const float* xzb = xz + static_cast<long long>(b) * L * row;
  const int nc = (L + kT - 1) / kT;

  float a[kHalf], h[kHalf];
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    a[k] = at[(half * kHalf + k) * DI + c];
    h[k] = 0.f;
  }
  const float dsk = dskip[c];

  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * kT;

    // 1. xi = silu(conv(x) + b) of every channel for the chunk's rows
    for (int cc = tid; cc < DI; cc += kThreads) {
      float w[kW], win[kW - 1];  // win[i] = x[t - (kW - 1) + i]
#pragma unroll
      for (int i = 0; i < kW; ++i) w[i] = conv_wt[i * DI + cc];
      const float bias = conv_b[cc];
#pragma unroll
      for (int i = 0; i < kW - 1; ++i) {
        const int t = t0 - (kW - 1) + i;
        win[i] = (t >= 0 && t < L) ? xzb[t * row + cc] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kT; ++r) {  // all kT loads in flight
        const int t = t0 + r;
        const float xv = t < L ? xzb[t * row + cc] : 0.f;
        float acc = bias + xv * w[kW - 1];
#pragma unroll
        for (int i = 0; i < kW - 1; ++i) acc += win[i] * w[i];
        sXi[r * DI + cc] = silu(acc);
#pragma unroll
        for (int i = 0; i < kW - 2; ++i) win[i] = win[i + 1];
        win[kW - 2] = xv;
      }
    }

    // 2. dt_raw of the block's channels and B | C of the row
    {
      float acc[kRows][4] = {};
      block_product<4>(sXi, DI, wdt + c0, DI, DI, sB, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sDt[(ty + 8 * r) * kTile + tx + 32 * j] = acc[r][j] + dtb[c0 + tx + 32 * j];
      float bc[kRows][1] = {};
      block_product<1>(sXi, DI, wbc, 2 * kN, DI, sB, bc);
#pragma unroll
      for (int r = 0; r < kRows; ++r) sBC[(ty + 8 * r) * 2 * kN + tx] = bc[r][0];
    }
    __syncthreads();

    // 3. the scan of the block's channels over the chunk
    if (kStates) {
      float* he = h_entries +
                  (static_cast<long long>(b * nc + ci) * kN + half * kHalf) * DI + c;
#pragma unroll
      for (int k = 0; k < kHalf; ++k) he[static_cast<long long>(k) * DI] = h[k];
    }
    float zz[kT];  // the gate's z, loaded before the scan so no step waits on it
#pragma unroll
    for (int r = 0; r < kT; ++r) zz[r] = t0 + r < L ? xzb[(t0 + r) * row + DI + c] : 0.f;
#pragma unroll
    for (int r = 0; r < kT; ++r) {
      const int t = t0 + r;
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
      if (half == 0 && t < L)
        y[(static_cast<long long>(b) * L + t) * DI + c] = (acc + dsk * xi) * silu(zz[r]);
    }
    __syncthreads();  // the next chunk overwrites sXi, sDt and sBC
  }
}

template <bool kStates>
cudaError_t launch(const float* xz, const float* conv_wt, const float* conv_b,
                   const float* wdt, const float* dtb, const float* wbc, const float* at,
                   const float* d, float* y, float* h_entries, int Bsz, int L, int DI,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kT) * DI + kKT * kTile +
                                       kT * kTile + kT * 2 * kN);
  cudaError_t err = cudaFuncSetAttribute(fused_mixer_fwd_kernel<kStates>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(DI / kTile, Bsz);
  fused_mixer_fwd_kernel<kStates><<<grid, kThreads, smem, stream>>>(
      xz, conv_wt, conv_b, wdt, dtb, wbc, at, d, y, h_entries, L, DI);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xz (B, L, 2 DI) contiguous; conv_wt (W, DI); conv_b, dtb, d (DI,);
// wdt (DI, DI); wbc (DI, 2N); at (N, DI) = A^T; y (B, L, DI); h_entries
// (B, ceil(L / kT), N, DI) or null for the lean forward. All float32 and
// contiguous. Returns a cudaError_t code (cudaErrorInvalidValue for N other
// than 16, W other than 4, or DI not a multiple of 128).
int fused_mixer_fwd(const void* xz, const void* conv_wt, const void* conv_b,
                    const void* wdt, const void* dtb, const void* wbc, const void* at,
                    const void* d, void* y, void* h_entries, int Bsz, int L, int DI,
                    int N, int W, void* stream) {
  if (N != kN || W != kW || DI % kTile != 0) return cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  if (h_entries == nullptr)
    return launch<false>(f(xz), f(conv_wt), f(conv_b), f(wdt), f(dtb), f(wbc), f(at), f(d),
                         static_cast<float*>(y), nullptr, Bsz, L, DI, s);
  return launch<true>(f(xz), f(conv_wt), f(conv_b), f(wdt), f(dtb), f(wbc), f(at), f(d),
                      static_cast<float*>(y), static_cast<float*>(h_entries), Bsz, L, DI, s);
}

int fused_mixer_chunk_len() { return kT; }

const char* fused_mixer_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
