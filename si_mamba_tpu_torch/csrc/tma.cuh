// Hopper's tensor memory accelerator (TMA, sm_90) for csrc/ssd_xbc_bf16_sm90.cu
// and csrc/selective_scan_bf16_sm90.cu: tiles copied from device memory into
// shared memory by one thread's request, their arrival counted on an mbarrier,
// and the 128-byte swizzled tile layouts that wgmma reads (csrc/wgmma.cuh
// reads the unswizzled ones).
//
// A tensor map (made on the host, encode()) names a tensor of rank 2 or 3,
// its strides, a box (the tile one request copies) and a swizzle. With
// CU_TENSOR_MAP_SWIZZLE_128B the box's inner extent is 128 bytes (64 bf16 or
// 32 floats) and it lands as rows of 128 bytes, the 16-byte chunk j of row r
// at chunk j ^ (r % 8): a swizzle atom is 8 such rows, 1024 bytes, and a tile
// starts 1024-byte aligned. wgmma reads such a tile K-major (the rows run
// along k: 64 bf16 or 32 tf32 of k a row, the k16 / k8 slab kk of the atom
// 32 kk bytes on, 8-row MN groups 1024 bytes apart) or, bf16 only, MN-major
// (the rows run along m or n: 64 of them at one k, the k16 slab kk 2048 kk
// bytes on, 64-wide MN atoms the descriptor's leading byte offset apart).
// A tile wider than one atom is several boxes, one atom after the other.
//
// The order: one thread arms the stage's barrier with the bytes it waits for
// (expect) and issues the copies; every thread that reads the stage waits on
// the barrier at the stage's parity. Before a stage is copied into again,
// every read of it is done (a block barrier) and the issuing thread fences
// the generic proxy's accesses against the copy (wg::fence_async).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <unordered_map>

namespace tma {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count) : "memory");
}
// the barriers' initialisation is visible to the copies
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the issuing thread's arrival, with the bytes the stage's copies bring
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem(bar)),
               "r"(bytes)
               : "memory");
}
// until the barrier's phase of that parity has completed
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

// The box of map at coordinates (c0 innermost, c1[, c2]) into dst, counted
// on bar.
__device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                     int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem(dst)),
      "l"(map), "r"(smem(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                     int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem(dst)),
      "l"(map), "r"(smem(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The wgmma descriptor of a 128-byte swizzled tile at p (1024-byte aligned
// atoms; p itself may sit a k slab on, 32 bytes a slab, within a K-major
// atom): lbo the bytes between MN atoms (MN-major; unused K-major), 1024
// between 8-row groups.
__device__ __forceinline__ uint64_t desc(const void* p, int lbo) {
  return static_cast<uint64_t>((smem(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// The descriptor of the k slab kk (k16 bf16 or k8 tf32) of a K-major tile of
// R rows at t (one atom of R x 128 bytes after the other along k), from row m0
// (a multiple of 8).
__device__ __forceinline__ uint64_t kdesc(const void* t, int R, int kk, int m0) {
  return desc(static_cast<const char*>(t) + (kk >> 2) * R * 128 + m0 * 128 + (kk & 3) * 32, 16);
}
// The descriptor of the k16 slab kk of an MN-major bf16 tile of K rows at t
// (64-wide MN atoms of K x 128 bytes one after the other).
__device__ __forceinline__ uint64_t mndesc(const void* t, int K, int kk) {
  return desc(static_cast<const char*>(t) + kk * 2048, K * 128);
}

// The byte offset of the 16-byte chunk holding element column c (of 64 bf16
// or 32 floats of an atom's rows, c8 = c / 8 or c / 4) in row r of an atom.
__host__ __device__ __forceinline__ int chunk(int r, int c8) { return r * 128 + ((c8 ^ (r & 7)) << 4); }
// The element offset of (r, c) in a bf16 tile of R rows that are 64-wide atoms
// one after the other along c, and in such an fp32 tile (32-wide atoms).
__host__ __device__ __forceinline__ int at16(int r, int c, int R) {
  return (c >> 6) * R * 64 + (chunk(r, (c & 63) >> 3) >> 1) + (c & 7);
}
__host__ __device__ __forceinline__ int at32(int r, int c, int R) {
  return (c >> 5) * R * 32 + (chunk(r, (c & 31) >> 2) >> 2) + (c & 3);
}

// ---------------------------------------------------------------------------
// host

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                            const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                            CUtensorMapFloatOOBfill);

inline Encode encoder() {
  static Encode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<Encode>(p);
  }();
  return fn;
}

// A map of the tensor at base with rank dims (innermost first, elements) and
// the byte strides of dims 1 .. rank - 1, copied in boxes of box (elements),
// 128-byte swizzled (swizzle) or not. False where the driver refuses it (an
// address or stride not 16-byte aligned, a box too large).
//
// A map depends on nothing but these arguments, so the maps encoded on a
// thread are kept by their arguments, and a call with the arguments of one
// copies it: an encode costs microseconds of host time, several a launch,
// which shows where the host paces the card (one cloud served). Past
// kMaxMaps the table starts again empty.
constexpr int kKeyWords = 9;
constexpr size_t kMaxMaps = 4096;

struct MapKey {
  uint64_t w[kKeyWords];
  bool operator==(const MapKey& o) const { return std::memcmp(w, o.w, sizeof w) == 0; }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = 1469598103934665603ull;  // FNV-1a over the words
    for (const uint64_t x : k.w) h = (h ^ x) * 1099511628211ull;
    return static_cast<size_t>(h ^ (h >> 32));
  }
};

inline bool encode(CUtensorMap* map, bool bf16, int rank, const void* base, const uint64_t* dims,
                   const uint64_t* strides, const uint32_t* box, bool swizzle) {
  if (rank < 2 || rank > 3) return false;
  const bool r3 = rank == 3;
  const MapKey key{{reinterpret_cast<uint64_t>(base), dims[0], dims[1], r3 ? dims[2] : 0,
                    strides[0], r3 ? strides[1] : 0, uint64_t{box[0]} << 32 | box[1],
                    r3 ? box[2] : 0u, uint64_t(rank) << 2 | uint64_t(bf16) << 1 | uint64_t(swizzle)}};
  thread_local std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const auto found = maps.find(key);
  if (found != maps.end()) {
    *map = found->second;
    return true;
  }
  const Encode fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  if (fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
         const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (maps.size() >= kMaxMaps) maps.clear();
  maps.emplace(key, *map);
  return true;
}

}  // namespace tma
