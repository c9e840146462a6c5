// What the Hopper (sm_90a) kernels of this directory share: TMA tensor maps
// and copies, mbarriers, the wgmma bf16 and int8 products with their
// shared-memory descriptors, register moves between warpgroups
// (setmaxnreg), and the host state kept per device. Included by
// flash_attn_nhd.cu (K1, K4), flash_attn_nhd_bwd.cu (K3),
// cross_attn_nhd.cu (K2), probe_attn.cu (P2-P6) and, through the GEMM
// mainloop of sm90_gemm.cuh, geglu.cu (K5) and probe_mm.cu (P1);
// build.library_path hashes it with every source, so an edit here rebuilds
// them.
//
// Tiles in shared memory are "panels": up to 256 rows of 64 bf16 columns,
// 128 bytes a row, laid out as TMA writes them under
// CU_TENSOR_MAP_SWIZZLE_128B (16-byte chunk c of row r at chunk c ^ (r % 8))
// from a 1024-byte aligned base. A head of D columns is D/64 panels, the
// last one padded: a tensor map's first extent is D, so TMA fills the
// columns from D up to the panel's width with zeros when it loads and
// leaves them out when it stores. wgmma reads a panel either way:
//   * K-major (the contraction runs along the 64 columns), the descriptor of
//     desc_k: 8-row groups 1024 bytes apart; a 16-column step moves the start
//     address by 32 bytes inside the swizzle atom.
//   * MN-major (the contraction runs down the rows, the 64 columns are the
//     product's N), the descriptor of desc_mn: a 16-row step moves it by
//     2048 bytes.
// So a tile that one product needs transposed is read transposed by the
// tensor core from the same bytes; nothing is staged twice.

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's types; no -lcuda (see encode_fn)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int kPanelCols = 64;    // bf16 columns of a panel: one 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr int kSmemAlign = 1024;  // the 128-byte swizzle repeats every 8 rows

// Panels a head of D columns takes.
template <int D>
constexpr int kPanels = (D + kPanelCols - 1) / kPanelCols;

// 16-column contraction steps over a head of D columns (40 -> 3: the
// columns past D are zero in shared memory).
template <int D>
constexpr int kSteps = (D + 15) / 16;

// ---- shared memory and barriers --------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) of a panel, col < 64.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * kRowBytes + ((((col >> 3) ^ (row & 7))) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and announce `bytes` of copies that will complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// that lasts seconds can only be a fault (a copy that never lands, a count
// that never completes): it traps, so the launch fails instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory become visible to the async proxy
// (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A barrier among `threads` threads only (id 0 is __syncthreads').
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- registers per warpgroup -----------------------------------------------
//
// A warp-specialized block moves registers from its producer warpgroup to
// its consumers: every warp of a warpgroup runs the same one of these
// (.sync.aligned), N a multiple of 8 in [24, 256]. ptxas honours them only
// where it knows the count at entry (the block's __launch_bounds__) and the
// roles' paths never meet again; otherwise it ignores them with a warning
// ("setmaxnreg ignored"), which build.resource_usage reports.

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- TMA ---------------------------------------------------------------------

// A 4-D tensor map of one operand and where its sequence axis is: the map
// runs over (d, heads, seq, batch), or over (d, seq, heads, batch) when the
// head stride is the larger one (see make_map), so that every stride grows.
// An operand with a batch stride of 0 (expanded over the batch) is mapped as
// one batch, which every batch reads.
struct Map {
  CUtensorMap map;
  int seq_axis;   // 1 or 2
  int one_batch;  // 1: read batch 0 for every b
};

__device__ __forceinline__ void coords(const Map& m, int col, int h, int row, int b, int (&c)[4]) {
  c[0] = col;
  c[1] = m.seq_axis == 1 ? row : h;
  c[2] = m.seq_axis == 1 ? h : row;
  c[3] = m.one_batch ? 0 : b;
}

// TMA load of the box at (col, h, row, b) into shared memory; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const Map& m, uint64_t* bar, int col, int h,
                                         int row, int b) {
  int c[4];
  coords(m, col, h, row, b, c);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&m.map)), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]),
      "r"(smem_u32(bar))
      : "memory");
}

// TMA store of a box from shared memory; elements outside the tensor are
// not written.
__device__ __forceinline__ void tma_store(const Map& m, const void* src, int col, int h, int row,
                                          int b) {
  int c[4];
  coords(m, col, h, row, b, c);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(&m.map)),
      "r"(smem_u32(src)), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3])
      : "memory");
}

// Close the group of this thread's TMA stores issued since the last commit.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed store groups have not yet
// read their shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Wait until this thread's TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  tma_store_commit();
  tma_store_wait_read<0>();
}

// Plain bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; completes on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = smem_u32(p);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);  // 1 << 62: 128-byte swizzle
}

// K-major operand at p: the 64 rows from p, 16 columns from p's column
// (p = panel + 128 * row0 + 32 * step).
__device__ __forceinline__ uint64_t desc_k(const void* p) { return desc(p, 16, 1024); }

// MN-major operand at p: 16 rows (the contraction) from p, the panel's 64
// columns as N (p = panel + 2048 * step). Both offsets are the 8-row stride:
// with N = 64 the operand is one swizzle atom wide.
__device__ __forceinline__ uint64_t desc_mn(const void* p) { return desc(p, 1024, 1024); }

// MN-major operand wider than one panel: N = 64 * n columns from n panels
// `panel_bytes` apart, 16 rows from p (p = first panel + 2048 * step). The
// leading offset steps from one 64-column swizzle atom to the next, the
// stride offset from one 8-row group to the next.
__device__ __forceinline__ uint64_t desc_mn_panels(const void* p, uint32_t panel_bytes) {
  return desc(p, panel_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The same for A fragments in registers: a product in flight reads them
// until its wait, so they stay put until this fence after it.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SM90_D32(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define SM90_D32_LIST                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                          \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                     \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                   \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 fp32, accumulator layout) (+)= A . B over 16 columns, A and B
// both K-major in shared memory; accumulate = 0 overwrites d.
//
// Accumulator layout: thread t of the warpgroup holds, for each n in 0..7,
// d[4n + i] = element (16 (t / 32) + (t % 32) / 4 + 8 (i / 2),
// 8 n + 2 (t % 4) + i % 2): each warp holds 16 rows, each quad of threads
// two of them.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same product with 16 columns of B (N = 16: d[4n + i] for n in 0..1),
// for the short tail of a few keys.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

#define SM90_D64_LIST                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define SM90_D128_LIST                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "         \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "         \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "         \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "         \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "   \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "     \
  "%125, %126, %127}"

// The same product with 128 and with 256 columns of B (N = 128, 256; the
// layout above with n in 0..15, 0..31), K-major panels of N rows: the GEGLU
// kernel's [h | g] tile in one instruction.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64_LIST
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32(d), SM90_D32((d + 32))
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_D128_LIST
      ", %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32(d), SM90_D32((d + 32)), SM90_D32((d + 64)), SM90_D32((d + 96))
      : "l"(a), "l"(b), "r"(accumulate));
}

// The m64n128k16 and m64n256k16 products with B MN-major (the transpose
// bit of B set): B is 128 or 256 columns of bf16 in 64-column panels, read
// through desc_mn_panels. A K-major.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64_LIST
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : SM90_D32(d), SM90_D32((d + 32))
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[128], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_D128_LIST
      ", %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : SM90_D32(d), SM90_D32((d + 32)), SM90_D32((d + 64)), SM90_D32((d + 96))
      : "l"(a), "l"(b), "r"(accumulate));
}

#define SM90_R32(d)                                                                            \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),          \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),  \
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),            \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),            \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])

// d (64 x N int32, the accumulator layout above) (+)= A . B over 32 columns
// of int8, A and B both K-major in shared memory (the only layout the int8
// product reads: it has no transpose bit), N = 128 or 256; 32 int8 columns
// are 32 bytes, so the descriptors step as bf16's 16 columns do.
__device__ __forceinline__ void wgmma_ss_s8(int (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_D64_LIST
      ", %64, %65, p;\n"
      "}\n"
      : SM90_R32(d), SM90_R32((d + 32))
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_s8(int (&d)[128], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " SM90_D128_LIST
      ", %128, %129, p;\n"
      "}\n"
      : SM90_R32(d), SM90_R32((d + 32)), SM90_R32((d + 64)), SM90_R32((d + 96))
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef SM90_R32

// Wait until at most N of the warpgroup's committed product groups are
// still running.
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (64 x 64 fp32) += A . B over 16 rows of B, A (64 x 16 bf16) from
// registers in the warpgroup's A-fragment layout (what the accumulator
// layout packs to, see pack_a), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same product, accumulate = 0 overwriting d (a product group that
// writes its accumulator first, so no other instruction initialises it).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 8 fp32: d[i] = element (16 (t / 32) + (t % 32) / 4 + 8 (i / 2),
// 2 (t % 4) + i % 2)) += A . B over 16 rows of B, A from registers as for
// wgmma_rs, B K-major in shared memory (desc_k over 8 rows): the attention
// probe's ones column, whose product with the probabilities is the row sum.
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same, accumulate = 0 overwriting d.
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef SM90_D32
#undef SM90_D32_LIST
#undef SM90_D64_LIST
#undef SM90_D128_LIST

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of contraction step k (16 columns: 8-column blocks 2k and
// 2k + 1 of an accumulator of 2M columns), rounded to bf16.
template <int M>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[M], int k) {
  a[0] = pack_bf16x2(x[8 * k + 0], x[8 * k + 1]);
  a[1] = pack_bf16x2(x[8 * k + 2], x[8 * k + 3]);
  a[2] = pack_bf16x2(x[8 * k + 4], x[8 * k + 5]);
  a[3] = pack_bf16x2(x[8 * k + 6], x[8 * k + 7]);
}

// A warpgroup's 64 x 64 accumulator, row r of the thread's two (g and
// g + 8) times mul[r], stored as bf16 into rows row0 .. row0 + 63 of a panel.
__device__ __forceinline__ void store_acc(uint8_t* panel, const float (&x)[32], int row0,
                                          const float (&mul)[2]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  row0 += 16 * ((threadIdx.x / 32) % 4);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      *reinterpret_cast<uint32_t*>(panel + swz(row, 8 * n + 2 * t)) =
          pack_bf16x2(x[4 * n + 2 * r] * mul[r], x[4 * n + 2 * r + 1] * mul[r]);
    }
}

// ---- host: state kept per device ------------------------------------------------
//
// A kernel's shared-memory attribute lives in a device's context and a
// multiprocessor count is a device's: both are kept per device, indexed by
// cudaGetDevice (the wrappers make the operands' device current), never once
// per process, so a second card starts from its own state.

constexpr int kMaxDevices = 64;  // devices past this keep no state: every call asks

// One int per device, 0 until stored.
struct PerDevice {
  std::atomic<int> value[kMaxDevices] = {};
  // the device's value; 0 also for a device past kMaxDevices
  int get(int dev) const { return dev >= 0 && dev < kMaxDevices ? value[dev].load() : 0; }
  void put(int dev, int v) {
    if (dev >= 0 && dev < kMaxDevices) value[dev].store(v);
  }
};

inline int current_device() {
  int dev = -1;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device: cudaFuncSetAttribute the first time on each device (`done`, one
// per kernel and size, holds 1 for the devices done).
inline cudaError_t allow_smem(const void* kernel, int bytes, PerDevice& done) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (done.get(dev)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.put(dev, 1);
  return err;
}

// Multiprocessors of the current device (for the grid choices).
inline int sm_count() {
  static PerDevice counts;
  const int dev = current_device();
  int n = counts.get(dev);
  if (n == 0) {
    if (dev < 0 || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 132;
    }
    counts.put(dev, n);
  }
  return n;
}

// ---- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// libraries link against nothing but the runtime. One entry point serves
// every device.
inline EncodeTiled encode_fn() {
  static std::atomic<void*> fn{nullptr};
  void* p = fn.load();
  if (p == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn.store(p);
  }
  return reinterpret_cast<EncodeTiled>(p);
}

// The map of one bf16 operand of d columns per head, `heads` heads, `seq`
// rows and `batch` batches at `base`, element strides (batch, head, row),
// unit stride along d; boxes of 64 columns by `box_rows` rows of one head. A
// batch stride of 0 maps one batch (Map::one_batch). False where
// cuTensorMapEncodeTiled refuses it (a base or stride that is not a
// multiple of 16 bytes, a stride of 2^40 bytes or more).
// cuTensorMapEncodeTiled of a 4-D, 128-byte swizzled map (strides in
// bytes, of dims 1-3). The encoder needs a current context on this thread,
// and a thread that has only used PyTorch's allocator (autograd's backward
// thread) may have none yet: a runtime call makes the current device's
// primary context current, once per thread and device.
inline bool encode_4d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                      const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
                      const cuuint32_t (&box)[4]) {
  static thread_local uint64_t bound = 0;  // bit per device
  const int dev = current_device();
  if (dev < 0) return false;
  const uint64_t bit = dev < kMaxDevices ? 1ull << dev : 0;
  if (!(bound & bit)) {
    if (cudaFree(nullptr) != cudaSuccess) return false;
    bound |= bit;
  }
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool make_map(Map* m, const void* base, int d, int heads, int seq, int batch,
                     long long batch_stride, long long head_stride, long long row_stride,
                     int box_rows) {
  m->one_batch = batch_stride == 0;
  if (m->one_batch) batch = 1;
  const bool seq_inner = row_stride < head_stride;
  m->seq_axis = seq_inner ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)(seq_inner ? seq : heads),
                              (cuuint64_t)(seq_inner ? heads : seq), (cuuint64_t)batch};
  const cuuint64_t inner = 2 * (seq_inner ? row_stride : head_stride);
  const cuuint64_t outer = 2 * (seq_inner ? head_stride : row_stride);
  // one batch: its stride is never stepped, so any valid one will do
  const cuuint64_t strides[3] = {inner, outer,
                                 m->one_batch ? outer * dims[2] : 2 * batch_stride};
  const cuuint32_t box[4] = {(cuuint32_t)kPanelCols, (cuuint32_t)(seq_inner ? box_rows : 1),
                             (cuuint32_t)(seq_inner ? 1 : box_rows), 1u};
  return encode_4d(&m->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box);
}

// The map of a row-major matrix of `rows` x `cols` elements of `type`,
// `elem_bytes` each, with a row stride of ld elements (a multiple of 16
// bytes), in boxes of one 128-byte panel row (128 / elem_bytes columns) by
// box_rows rows; load and store it at (col, 0, row, 0). False where the
// encoder refuses it.
inline bool make_map_rows(Map* m, const void* base, CUtensorMapDataType type, int elem_bytes,
                          long long cols, long long rows, long long ld, int box_rows) {
  m->seq_axis = 1;
  m->one_batch = 0;
  const cuuint64_t row_bytes = (cuuint64_t)ld * elem_bytes;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, 1, 1};
  const cuuint64_t strides[3] = {row_bytes, row_bytes * rows, row_bytes * rows};
  const cuuint32_t box[4] = {(cuuint32_t)(kRowBytes / elem_bytes), (cuuint32_t)box_rows, 1u, 1u};
  return encode_4d(&m->map, type, base, dims, strides, box);
}

}  // namespace sm90
