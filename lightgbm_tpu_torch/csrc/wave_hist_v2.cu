// Wave histogram as a one-hot matrix product on the tensor cores,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/hist_pallas.py::_wave_hist_pallas_v2
// (body _kernel_v2, helpers _build_bmat/_pair_one_hot).  It computes the same
// function as csrc/wave_hist.cu:
//
//   out[(g*NB + b), k, w] = sum of ghk[r, k] over rows r with
//                           bins_t[g, r] == b and leaf_id[r] == pending[w]
//
// for bf16 stat columns only (as the TPU kernel), any wave width W,
// duplicate pending ids (each slot is its own column) and empty slots
// (pending < 0: the column stays zero).
//
// What it keeps from the TPU kernel: the formulation.  The histogram is the
// product out(G*NB, B) = onehot^T(G*NB, rows) @ bmat(rows, B), B = K*W
// columns (column kk*W + w holds stat kk of wave slot w).  bmat, the leaf
// mask times the stat columns, is built per chunk of rows in shared memory;
// the one-hot operand is built in registers from the bin codes and never
// written anywhere.
//
// What bounds it on this card: operations.  The dense product does
// 2 * n * G*NB * B flops, nearly all on zeros of the one-hot; at 2M rows,
// G=28, NB=256, W=128 (B=384) that is 11 TFLOP, 11.1 ms at the 989 TFLOP/s
// bf16 peak, against a bytes bound of ~24 us.  The formulation, not the
// code, keeps it far from the function's bound.
//
// The design (the earlier one rebuilt the stat tile in each of its
// 128-row x 64-column output tiles, staged synchronously and ran
// mma.sync.m16n8k16):
//   * a persistent grid, one CTA an SM (two for tiles of at most 32
//     columns, whose registers and shared memory allow it), walking work
//     items (row split, output-row block, column tile);
//   * a CTA holds NWG = 3 warpgroups, each owning 64 output rows (192 a
//     CTA) and one column tile of N <= 192 columns (B rounded up to a
//     multiple of 16 over as few tiles as keep N <= 192: W=4 computes 16
//     columns, W=128 two tiles of 192).  For every chunk of CH = 128 data
//     rows the CTA builds ONE bmat tile (128 rows x N bf16) in shared
//     memory, K-major in the 128-byte swizzle that wgmma reads for B, and
//     all three warpgroups read it: a data row's bmat entries are built
//     ceil(G*NB/192) * tiles times a launch, 76 at NB=256, W=128 (the
//     earlier kernel: 56 * 6 = 336, 4.4x more);
//   * the products are wgmma.mma_async.m64nNk16.f32.bf16.bf16 with A, the
//     one-hot, from registers (per warp the m16n8k16 A fragment layout, warp
//     i of the warpgroup on rows 16i..16i+15) and B from shared memory; the
//     f32 accumulators stay in registers for the whole work item;
//   * thread 0 keeps the leaf ids, stat columns and the block's bin codes
//     of the next chunks in flight with cp.async.bulk into a ring of 8
//     stages, completing on mbarriers (each stage is released by an
//     mbarrier arrival of every thread);
//   * a software pipeline with one CTA barrier a chunk: while the warps
//     build chunk j's bmat tile they issue chunk j-1's products, one k16
//     step per slice of the build, then build chunk j's one-hot fragments
//     in two halves, each once the products that read its registers are
//     done (bmat and the transposed stat columns are double-buffered).
//     The earlier two-barrier loop, which built a chunk's tile and then
//     issued its products, ran the build and the products one after the
//     other: 10% slower at NB=256, W=128 (PERF.md);
//   * no float atomics: each work item writes its partial tile, and a
//     second kernel adds the row splits' partials in a fixed order, so the
//     result is bit-identical from run to run.
// nvcc 12.8 (sm_90a) reports 129-168 registers a thread for N=48 to
// N=192 (N=192 spills 36 bytes) and 80 for N=16 and 32 (two CTAs an SM;
// 32-72 bytes of spills), and the kernel takes up to 131,712 B of dynamic
// shared memory a CTA (N=192).  No setmaxnreg: no warp is a dedicated
// producer, so there are no registers to hand over.
// What still holds it back: the bmat build (shared-memory loads, compares
// and stores in the warps that issue the products) still adds most of its
// time to the products' instead of hiding behind them
// (scripts/ablate_hist_v2.py); at narrow waves the wgmma count,
// (G*NB / 64) * (rows / 16) whatever the width, sets the pace; and the
// product itself is ~460x the function's bound at NB=256, W=128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWG = 3;               // warpgroups
constexpr int THREADS = NWG * 128;
constexpr int BM = NWG * 64;         // output rows per CTA
constexpr int CH = 128;              // data rows per chunk
constexpr int KSTEPS = CH / 16;
constexpr int STAGES = 8;
constexpr int MAX_K = 8;
// groups a CTA's BM output rows can span (NB is a multiple of 32)
constexpr int MAX_GROUPS = BM / 32 + 1;
// one stage: leaf ids, stat columns, bin codes of the CTA's groups
constexpr int ST_GHK = CH * 4;
constexpr int ST_BINS = ST_GHK + CH * MAX_K * 2;
constexpr int STAGE_BYTES = ST_BINS + MAX_GROUPS * CH;
static_assert(STAGE_BYTES % 16 == 0, "stages must stay 16-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Wait for the phase with `parity` to complete.  The loop stays inside the
// asm: a C++ spin loop is divergent control flow to ptxas, which then
// serializes the wgmma that follow.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// bulk copy global -> shared (16-byte aligned, size a multiple of 16),
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most `pending` committed groups of products are in flight
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending)
               : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: atoms of 8 rows (here bmat columns) x 128 bytes (64 K values),
// the 16-byte chunk j of row i stored at chunk j ^ (i % 8); 1024 bytes
// between 8-row atoms.  `p` is the atom's start plus 32 bytes per k16 step
// within it (the hardware swizzles the address it generates).
__device__ __forceinline__ uint64_t make_desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D(64 x N, f32) += A(64 x 16, bf16 registers) * B(16 x N, bf16 shared)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const unsigned (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                            const unsigned (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                            const unsigned (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                            const unsigned (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const unsigned (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                            const unsigned (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const unsigned (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                            const unsigned (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                            const unsigned (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// two bf16 one-hot entries of output row `bin`: 1.0 where the data row's
// bin code equals it (low half: the lower data row)
__device__ __forceinline__ unsigned one_hot2(unsigned bin, unsigned code_lo,
                                             unsigned code_hi) {
  return (code_lo == bin ? 0x3F80u : 0u) | (code_hi == bin ? 0x3F800000u : 0u);
}

struct V2Args {
  const uint8_t* bins_t;
  const int32_t* leaf_id;
  const __nv_bfloat16* ghk;
  const int32_t* pending;
  float* partial;
  long long n;
  int g, nb, k, w, b_pad, ctiles, mblocks, splits;
  long long rows_per_split;
};

// Work item -> (row split, output-row block, column tile); the split is
// outermost so that CTAs running at the same time read the same rows.
struct Item {
  int split, mb, ct;
  long long r_begin, r_end;
  __device__ Item(const V2Args& p, int item) {
    ct = item % p.ctiles;
    mb = (item / p.ctiles) % p.mblocks;
    split = item / (p.ctiles * p.mblocks);
    r_begin = (long long)split * p.rows_per_split;
    r_end = min(p.n, r_begin + p.rows_per_split);
  }
};

// Thread 0's bulk copies: the chunks in the order the CTA consumes them,
// each into the next ring stage once the consumers have released it.
struct Producer {
  int item;
  long long base;
  int stage = 0;
  unsigned phase = 0;

  __device__ void issue(const V2Args& p, int items, unsigned char* stages,
                        uint64_t* full, uint64_t* empty) {
    if (item >= items) return;
    const Item it(p, item);
    const int m0 = it.mb * BM;
    const int g_lo = m0 / p.nb;
    const int g_hi = min(p.g, (min(m0 + BM, p.g * p.nb) - 1) / p.nb + 1);
    // rows copied: the chunk's, rounded up to 16 (n is a multiple of 16)
    const int rows = (int)((min((long long)CH, it.r_end - base) + 15) & ~15);
    mbar_wait(&empty[stage], phase ^ 1);
    unsigned char* st = stages + stage * STAGE_BYTES;
    mbar_expect_tx(&full[stage],
                   rows * 4 + rows * p.k * 2 + (g_hi - g_lo) * rows);
    bulk_copy(st, p.leaf_id + base, rows * 4, &full[stage]);
    bulk_copy(st + ST_GHK, p.ghk + base * p.k, rows * p.k * 2, &full[stage]);
    for (int gi = g_lo; gi < g_hi; ++gi)
      bulk_copy(st + ST_BINS + (gi - g_lo) * CH,
                p.bins_t + (long long)gi * p.n + base, rows, &full[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    base += CH;
    if (base >= it.r_end) {
      item += gridDim.x;
      if (item < items) base = Item(p, item).r_begin;
    }
  }
};

// CTAs an SM holds: narrow column tiles need few accumulator registers and
// little shared memory, so two CTAs share an SM and hide each other's
// per-chunk barriers (ops/hist_cuda.py _v2_geometry sizes the grid to it)
template <int N>
constexpr int ctas_per_sm() {
  return N <= 32 ? 2 : 1;
}

template <int N>
__global__ void __launch_bounds__(THREADS, ctas_per_sm<N>())
wave_hist_v2_kernel(const V2Args p) {
  constexpr int BMAT_BYTES = CH * N * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* bmat = smem;  // [2][CH/16][N/8][2][8 cols][8 rows] bf16
  unsigned char* stages = smem + 2 * BMAT_BYTES;
  __nv_bfloat16* ghk_t =
      reinterpret_cast<__nv_bfloat16*>(stages + STAGES * STAGE_BYTES);
  int* col_leaf = reinterpret_cast<int*>(ghk_t + 2 * MAX_K * CH);
  int* col_stat = col_leaf + N;
  uint64_t* full = reinterpret_cast<uint64_t*>(col_stat + N);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int m_total = p.g * p.nb;
  const int kw = p.k * p.w;
  const int items = p.splits * p.mblocks * p.ctiles;
  Producer prod{(int)blockIdx.x, 0};
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (prod.item < items) prod.base = Item(p, prod.item).r_begin;
    for (int s = 0; s + 1 < STAGES; ++s)
      prod.issue(p, items, stages, full, empty);
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  // a thread builds the bmat pieces of one octet of data rows (8 rows) in
  // every CSTEP-th column from c0; a warpgroup's threads all take the same
  // number of columns
  constexpr int CSTEP = THREADS / 16;
  constexpr int BUILD_STEPS = (N + CSTEP - 1) / CSTEP;
  constexpr int STEPS = BUILD_STEPS > KSTEPS ? BUILD_STEPS : KSTEPS;
  const int oct = (tid >> 3) & (CH / 8 - 1);
  const int c0 = (tid / CH) * 8 + (tid & 7);
  int stage = 0;
  unsigned phase = 0;
  int buf = 0;
  float acc[N / 2];
  // one-hot fragments of the chunk whose products run next; every entry
  // is always 0 or 1.0 (finite), also before the first chunk
  unsigned a[KSTEPS][4] = {};
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it(p, item);
    const int m0 = it.mb * BM;
    const int g_lo = m0 / p.nb;
    // this warp's 16 output rows lie in one group (NB % 32 == 0)
    const int wrow = m0 + wg * 64 + (warp & 3) * 16;
    const bool warp_live = wrow < m_total;
    const int wgrp = warp_live ? wrow / p.nb - g_lo : 0;
    const unsigned bin = warp_live ? (unsigned)(wrow % p.nb) + gid : 0xFFFFu;

    __syncthreads();  // the previous item's last build and products are done
    for (int c = tid; c < N; c += THREADS) {
      const int col = it.ct * N + c;
      int leaf = -2, stat = 0;  // rows carry ids >= -1, so -2 matches none
      if (col < kw) {
        stat = col / p.w;
        const int pl = p.pending[col - stat * p.w];
        if (pl >= 0) leaf = pl;
      }
      col_leaf[c] = leaf;
      col_stat[c] = stat;
    }
    // the first step's products, which stand for the chunk before the
    // first, read a zero tile and add nothing
    for (int i = tid; i < BMAT_BYTES / 16; i += THREADS)
      reinterpret_cast<uint4*>(bmat + (buf ^ 1) * BMAT_BYTES)[i] =
          make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // Software pipeline with one CTA barrier a chunk.  Step j builds chunk
    // j's bmat tile while the warps issue chunk j-1's products, one k16
    // step per slice of the build, so that the tensor cores and the build
    // run together; then it builds chunk j's one-hot fragments.  Step nch
    // only issues the last chunk's products.  bmat and the transposed stat
    // columns are double-buffered: step j+1 overwrites what step j-1 read,
    // and every warp is past step j-1 (its build, and the wait for its
    // products) when any warp passes step j+1's barrier.
    const int nch = (int)((it.r_end - it.r_begin + CH - 1) / CH);
    for (int j = 0; j <= nch; ++j) {
      const bool build = j < nch;
      const unsigned char* st = stages + stage * STAGE_BYTES;
      __nv_bfloat16* gt = ghk_t + buf * (MAX_K * CH);
      int lf[8];
      if (build) {
        const int rows = (int)min((long long)CH,
                                  it.r_end - it.r_begin - (long long)j * CH);
        mbar_wait(&full[stage], phase);
        const int* leaf_s = reinterpret_cast<const int*>(st);
        const __nv_bfloat16* ghk_s =
            reinterpret_cast<const __nv_bfloat16*>(st + ST_GHK);
        // the stat columns transposed, gt[k][r], so that 8 rows of one
        // stat are one 16-byte load
        for (int i = tid; i < p.k * CH; i += THREADS) {
          const int kk = i / CH, r = i - kk * CH;
          gt[i] = ghk_s[r * p.k + kk];
        }
        const int4 l0 = *reinterpret_cast<const int4*>(leaf_s + oct * 8);
        const int4 l1 = *reinterpret_cast<const int4*>(leaf_s + oct * 8 + 4);
        lf[0] = l0.x; lf[1] = l0.y; lf[2] = l0.z; lf[3] = l0.w;
        lf[4] = l1.x; lf[5] = l1.y; lf[6] = l1.z; lf[7] = l1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (oct * 8 + i >= rows) lf[i] = -1;  // rows past the chunk's end
      }
      __syncthreads();
      // every thread has released the previous chunk's stage: refill it
      if (build && tid == 0) prod.issue(p, items, stages, full, empty);

      // bmat tile, K-major in the 128-byte swizzle: 64-row K blocks of N/8
      // atoms, each 8 columns x 64 rows.  A 16-byte piece holds one octet
      // of one column: the stat octet masked by leaf == the column's leaf.
      unsigned char* kblock =
          bmat + buf * BMAT_BYTES + (oct >> 3) * (N / 8) * 1024;
      const unsigned char* prev = bmat + (buf ^ 1) * BMAT_BYTES;
      // a[] was written after the last products were issued
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const int c = c0 + i * CSTEP;
        if (build && i < BUILD_STEPS && c < N) {
          const int cl = col_leaf[c];
          const uint4 v = *reinterpret_cast<const uint4*>(
              gt + col_stat[c] * CH + oct * 8);
          uint4 m;
          m.x = v.x & ((lf[0] == cl ? 0xFFFFu : 0u) |
                       (lf[1] == cl ? 0xFFFF0000u : 0u));
          m.y = v.y & ((lf[2] == cl ? 0xFFFFu : 0u) |
                       (lf[3] == cl ? 0xFFFF0000u : 0u));
          m.z = v.z & ((lf[4] == cl ? 0xFFFFu : 0u) |
                       (lf[5] == cl ? 0xFFFF0000u : 0u));
          m.w = v.w & ((lf[6] == cl ? 0xFFFFu : 0u) |
                       (lf[7] == cl ? 0xFFFF0000u : 0u));
          *reinterpret_cast<uint4*>(kblock + (c >> 3) * 1024 + (c & 7) * 128 +
                                    (((oct & 7) ^ (c & 7)) << 4)) = m;
        }
        // unconditional, so that no wgmma sits on a divergent path (which
        // makes ptxas serialize them): a warpgroup past the last output row
        // multiplies zero fragments and never stores its sums
        if (i < KSTEPS) {
          wgmma_rs<N>(acc, a[i], make_desc_sw128(prev + (i >> 2) * (N / 8) *
                                                            1024 +
                                                 (i & 3) * 32));
          if (i == KSTEPS / 2 - 1 || i == KSTEPS - 1) wgmma_commit();
        }
      }
      // make the build's generic-proxy stores visible to wgmma's async
      // proxy before the next step's barrier
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

      // chunk j's one-hot fragments of this warp's 16 bins, each half once
      // the products that read its registers are done.  a[s][0] holds rows
      // (bin, data rows 2tig, 2tig+1), [1] bin+8, [2] and [3] the same for
      // data rows 2tig+8, 2tig+9.  The last step reads codes from a buffer
      // no copy writes and builds fragments that no product uses.
      const uint8_t* codes = build
          ? st + ST_BINS + wgrp * CH
          : reinterpret_cast<const uint8_t*>(ghk_t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 0)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
#pragma unroll
        for (int s = h * KSTEPS / 2; s < (h + 1) * KSTEPS / 2; ++s) {
          const unsigned lo = *reinterpret_cast<const unsigned short*>(
              codes + s * 16 + tig * 2);
          const unsigned hi = *reinterpret_cast<const unsigned short*>(
              codes + s * 16 + tig * 2 + 8);
          const unsigned q0 = lo & 0xFFu, q1 = lo >> 8, q2 = hi & 0xFFu,
                         q3 = hi >> 8;
          a[s][0] = one_hot2(bin, q0, q1);
          a[s][1] = one_hot2(bin + 8, q0, q1);
          a[s][2] = one_hot2(bin, q2, q3);
          a[s][3] = one_hot2(bin + 8, q2, q3);
        }
      }
      if (build) {
        mbar_arrive(&empty[stage]);  // the stage is read
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      buf ^= 1;
    }
    wgmma_wait<0>();
    if (!warp_live) continue;
    // accumulator fragment: acc[4j + e] holds row gid (+8 for e >= 2),
    // column 8j + 2tig (+1 for odd e)
    float* dst = p.partial + ((long long)it.split * m_total + wrow + gid) *
                                 p.b_pad + it.ct * N + tig * 2;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      *reinterpret_cast<float2*>(dst + j * 8) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(dst + 8LL * p.b_pad + j * 8) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// out[m, c] = sum over the row splits, in split order, of partial[s, m, c]
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int splits,
                                    int m_total, int kw, int b_pad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)m_total * kw) return;
  const long long m = i / kw, c = i - m * kw;
  float s = 0.0f;
  for (int q = 0; q < splits; ++q)
    s += partial[((long long)q * m_total + m) * b_pad + c];
  out[i] = s;
}

template <int N>
cudaError_t launch_n(const V2Args& a, int grid, cudaStream_t st) {
  const size_t smem = 2 * CH * N * 2 + STAGES * STAGE_BYTES +
                      2 * MAX_K * CH * 2 + 2 * N * 4 + 2 * STAGES * 8;
  auto kern = wave_hist_v2_kernel<N>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `partial` is f32 scratch of
// splits * G*NB * b_pad cells, b_pad = ctiles * n_tile (n_tile one of 16,
// 32, 48, 64, 96, 128, 160, 192); `out` receives the (G*NB, K, W) f32
// histogram.  n must be a multiple of 16, NB a multiple of 32 up to 256, K
// at most 8, rows_per_split a multiple of 64; `grid` CTAs walk the
// splits * ceil(G*NB / 192) * ctiles work items.  Returns the CUDA error
// code of the launches (0 on success).
extern "C" int wave_hist_v2_launch(const void* bins_t, const void* leaf_id,
                                   const void* ghk, const void* pending,
                                   void* partial, void* out, long long n,
                                   int g, int nb, int k, int w, int n_tile,
                                   int ctiles, int splits,
                                   long long rows_per_split, int grid,
                                   void* stream) {
  if (nb % 32 != 0 || nb > 256 || k < 1 || k > MAX_K || n % 16 != 0 ||
      rows_per_split % CH != 0 || splits < 1 || ctiles < 1 || grid < 1 ||
      (long long)ctiles * n_tile < (long long)k * w)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int m_total = g * nb;
  V2Args a{(const uint8_t*)bins_t, (const int32_t*)leaf_id,
           (const __nv_bfloat16*)ghk, (const int32_t*)pending,
           (float*)partial, n, g, nb, k, w, ctiles * n_tile, ctiles,
           (m_total + BM - 1) / BM, splits, rows_per_split};
  cudaError_t e;
  switch (n_tile) {
    case 16: e = launch_n<16>(a, grid, st); break;
    case 32: e = launch_n<32>(a, grid, st); break;
    case 48: e = launch_n<48>(a, grid, st); break;
    case 64: e = launch_n<64>(a, grid, st); break;
    case 96: e = launch_n<96>(a, grid, st); break;
    case 128: e = launch_n<128>(a, grid, st); break;
    case 160: e = launch_n<160>(a, grid, st); break;
    case 192: e = launch_n<192>(a, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)m_total * k * w;
  const int tpb = 256;
  sum_partials_kernel<<<(unsigned)((total + tpb - 1) / tpb), tpb, 0, st>>>(
      (const float*)partial, (float*)out, splits, m_total, k * w,
      ctiles * n_tile);
  return (int)cudaGetLastError();
}
