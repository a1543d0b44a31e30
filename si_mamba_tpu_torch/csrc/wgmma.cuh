// Hopper warpgroup tensor-core products (wgmma.mma_async, sm_90a only) and the
// shared-memory tile layouts they read, for csrc/ssd_xbc_bf16_sm90.cu.
//
// A warpgroup (4 warps, 128 threads) accumulates a 64 x N tile in fp32
// registers, N / 2 a thread: element r of thread (warp w, lane: g = lane / 4,
// t = lane % 4) is row 16 w + g + 8 ((r % 4) / 2), column 8 (r / 4) + 2 t +
// r % 2 (acc_row, acc_col). B always comes from shared memory; A from shared
// memory or from registers, where thread (w, g, t) holds, for a k16 bf16 slab
// starting at k0, the bf16 pairs (row 16 w + g [+ 8], columns k0 + 2 t [+ 8]
// and the next), and for a k8 tf32 slab (row 16 w + g [+ 8], column k0 + t
// [+ 4]) (frag_bf16, frag_tf32). So the accumulator of one product, rounded
// to bf16, is the register A of the next, as attention kernels feed P V.
//
// Tiles that the threads build (the tf32 ones, and the transposed operands
// of the 3xTF32 products) have no swizzle: the unit is a core matrix, 8 rows
// of 16 bytes, 128 contiguous bytes; a tf32 tile is K-major (4 k a row). A
// tile whose MN extent is R keeps its core matrices of one k group together,
// R / 8 of them 128 bytes apart (the descriptor's stride byte offset), and
// the k groups R * 16 bytes apart (its leading byte offset), so the next k8
// slab starts 32 R bytes on and the MN sub-range from row m0 16 m0 bytes on
// (tf32_at, desc). Tiles that land from device memory as they are have the
// 128-byte swizzle of csrc/tma.cuh and its descriptors.
//
// The order: data written to a tile by the threads is made visible
// to the tensor cores by fence_async() in each writing thread and a barrier;
// then fence(), the products, commit(), and wait<n>() before their
// accumulators are read or the tiles they read are written again.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wg {

template <int N>
struct Shape {};

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) before the async
// proxy (wgmma) reads them
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The element offset of (mn, k) in an unswizzled tf32 (K-major) tile.
__host__ __device__ __forceinline__ int tf32_at(int mn, int k, int R) {
  return (((k >> 2) * (R >> 3) + (mn >> 3)) << 5) + ((mn & 7) << 2) + (k & 3);
}

// The descriptor of the unswizzled tf32 tile at p (its MN extent R; 16-byte
// aligned), at the k8 slab `slab` and the MN sub-range from row m0: leading
// byte offset (between k groups) R * 16, stride byte offset (between 8-row MN
// groups) 128.
__device__ __forceinline__ uint64_t desc(const void* p, int R, int slab, int m0) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p)) + slab * R * 32 + m0 * 16;
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((R * 16) >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ int acc_row(int r) {
  return ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * ((r & 3) >> 1);
}
__device__ __forceinline__ int acc_col(int r) { return 8 * (r >> 2) + 2 * (threadIdx.x & 3) + (r & 1); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The register A of the k16 slab kk of a 64 x (>= 16 kk + 16) accumulator,
// each element rounded to bf16 (to nearest even).
template <int R>
__device__ __forceinline__ void frag_bf16(uint32_t (&a)[4], const float (&d)[R], int kk) {
  const int j = 8 * kk;  // the slab's first accumulator element: n8 block 2 kk
  a[0] = pack(d[j], d[j + 1]);
  a[1] = pack(d[j + 2], d[j + 3]);
  a[2] = pack(d[j + 4], d[j + 5]);
  a[3] = pack(d[j + 6], d[j + 7]);
}

// Where thread (w, g, t) reads its register A of a k8 tf32 slab from k0, and
// of a k16 bf16 slab: rows frag_row(0 / 1), columns k0 + t (+ 4) / k0 + 2 t
// (+ 8).
__device__ __forceinline__ int frag_row(int half) {
  return ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * half;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(v - __uint_as_float(h)));
  hi = h;
  lo = l;
}

template <int tA, int tB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc,
                                       Shape<64>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(tA), "n"(tB));
}

template <int tB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int acc, Shape<64>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(tB));
}

__device__ __forceinline__ void mma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc, Shape<64>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <int tA, int tB>
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc,
                                       Shape<128>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(tA), "n"(tB));
}

template <int tB>
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                       int acc, Shape<128>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(tB));
}

__device__ __forceinline__ void mma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc, Shape<128>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

}  // namespace wg
