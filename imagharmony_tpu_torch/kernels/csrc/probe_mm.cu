// P1: the plain matrix product of the matmul probe, out = x W, written for
// Hopper (sm_90a) on the GEMM mainloop of sm90_gemm.cuh, in two type pairs:
//
//   * bf16 x bf16 -> bf16, fp32 accumulation;
//   * int8 x int8 -> int32, int32 accumulation (exact).
//
// x is (M, K) and W (K, N), both row-major: the probe's layout, W not
// transposed. Replaces the TPU kernel `_mm_kernel` (tools/
// probe_pallas_matmul.py:34), reached through `pallas_mm` (:42, call :45),
// whose main() runs both pairs at the SDXL feed-forward shapes (:110-126).
//
// What bounds it on an H100: at (M, K, N) = (8192, 640, 5120) bf16 does
// 53.7 GFLOP (0.0543 ms at 989 TFLOP/s) against 101 MB (0.030 ms at
// 3.35 TB/s): operations. int8 does the same 53.7 GOP (0.0271 ms at 1979
// TOP/s) but writes an int32 output of 168 MB (0.0526 ms): bytes.
//
// Design (mm_wgmma_kernel<KIND, BN>, an Op of sm90_gemm.cuh): the
// mainloop's persistent, warp-specialized CTAs (a producer warp issues the
// TMA loads, two consumer warpgroups of 64 rows run the products, the K
// loop split across CTAs where whole tiles would leave the card's last wave
// part empty and K is long: of the probe's shapes, (2048, 5120, 1280)) over
// tiles of 128 rows by BN (128 or 256) columns of W.
//   * a stage holds one 128-byte panel of K: the x tile (K-major) and W's
//     tile of the same K rows as it lies in device memory, K rows by N
//     columns, i.e. MN-major for the product.
//   * bf16: wgmma reads W's tile MN-major through its descriptor (the
//     transpose bit of B; the BN/64 panels of 64 columns are one operand of
//     N = BN, desc_mn_panels), so no copy is made. 4 stages of 48 KB at
//     BN = 256, 6 of 32 KB at 128.
//   * int8: the int8 product has no transpose bit, it reads B K-major only.
//     So the 256 consumer threads transpose each W tile in shared memory
//     into a K-major 128-byte swizzled panel of BN rows (4 x 4 byte blocks,
//     32-bit loads and stores and byte permutes, conflict-free on both
//     sides), into one of two panels: the transpose of panel j + 1 runs
//     while the products of panel j are in flight (the mainloop's
//     transposing branch). 4 stages of 32 KB (int8 tiles are 128 columns
//     wide: at 256 the transposes and the accumulator spill).
//   * K past the tensor is zero-filled by TMA and adds zero; rows past M and
//     columns past N are left out of the stores.
//   * epilogue: the accumulator, rounded to bf16 or kept int32, into a
//     warpgroup's staging buffer beside the ring, then TMA stores left in
//     flight: bf16 through two 128-byte panels (two rounds at BN = 256),
//     int32 through four (its 64 x 128 int32 rows at once).
//   * BN and the cut into whole and split tiles by the mainloop's cost
//     (sm90::gemm::plan), weighing a panel of BN columns as BN + 32
//     (a narrower tile pays the same fixed cost a panel).

#include <type_traits>

#include "sm90_gemm.cuh"

namespace {

using sm90::kRowBytes;
using sm90::gemm::kBM;

enum Kind { kBf16 = 0, kInt8 = 1 };

struct MmParams {
  sm90::Map x, w, out;
  sm90::gemm::Sched sched;
  void* workspace;
  int* counters;
  int m, n;
};

template <int KIND, int BN>
struct MmOp {
  using Acc = typename std::conditional<KIND == kBf16, float, int>::type;
  using Params = MmParams;
  static constexpr int kAcc = BN / 2;
  static constexpr int kX = kBM * kRowBytes;
  // bf16: BN/64 panels of 64 K rows; int8: BN/128 boxes of 128 K rows
  static constexpr int kW = BN * kRowBytes;
  static constexpr int kStageBytes = kX + kW;
  static constexpr int kBox = 128 * kRowBytes;  // int8: a W box of 128 K rows by 128 N bytes
  static constexpr int kStages = KIND == kInt8 || BN == 256 ? 4 : 6;
  static constexpr int kTBytes = KIND == kInt8 ? BN * kRowBytes : 0;  // BN rows of 128 K bytes
  // a warpgroup's staging buffer: bf16 two panels (of BN/64), int8 its
  // whole int32 output (BN/32 panels)
  static constexpr int kOutBytes = (KIND == kBf16 ? 2 : BN / 32) * 64 * kRowBytes;
  static constexpr int kExtraBytes = 0;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;

  // TMA loads of K panel k of tile (tm, tn) into a stage (the producer).
  static __device__ __forceinline__ void load(const Params& p, uint8_t* st, uint64_t* full,
                                              int tm, int tn, int k) {
    const int m0 = tm * kBM, n0 = tn * BN;
    sm90::mbar_expect_tx(full, kStageBytes);
    if constexpr (KIND == kBf16) {
      sm90::tma_load(st, p.x, full, k * 64, 0, m0, 0);
#pragma unroll
      for (int q = 0; q < BN / 64; ++q) {
        sm90::tma_load(st + kX + q * 64 * kRowBytes, p.w, full, n0 + 64 * q, 0, k * 64, 0);
      }
    } else {
      sm90::tma_load(st, p.x, full, k * 128, 0, m0, 0);
#pragma unroll
      for (int q = 0; q < BN / 128; ++q) {
        sm90::tma_load(st + kX + q * kBox, p.w, full, n0 + 128 * q, 0, k * 128, 0);
      }
    }
  }

  // The warpgroup's products of one K panel: 4 steps of 16 bf16 or 32 int8.
  static __device__ __forceinline__ void mma(Acc (&acc)[kAcc], const uint8_t* st,
                                             const uint8_t* t, int wg, int accumulate) {
    const uint8_t* xs = st + wg * 64 * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (KIND == kBf16) {
        sm90::wgmma_ss_mn(acc, sm90::desc_k(xs + 32 * kk),
                          sm90::desc_mn_panels(st + kX + 2048 * kk, 64 * kRowBytes),
                          accumulate || kk > 0);
      } else {
        sm90::wgmma_ss_s8(acc, sm90::desc_k(xs + 32 * kk), sm90::desc_k(t + 32 * kk),
                          accumulate || kk > 0);
      }
    }
  }

  // The int8 W tile of a stage (BN/128 boxes of 128 K rows by 128 N bytes,
  // as TMA wrote them: byte n of row k at chunk (n / 16) ^ (k % 8)) into a
  // K-major panel of BN rows (byte k of row n at chunk (k / 16) ^ (n % 8)),
  // by the 256 consumer threads. A thread moves 4 x 4 byte blocks: four
  // 32-bit loads (4 K rows, 4 N bytes), byte permutes, four 32-bit stores
  // (4 N rows, 4 K bytes). Lane l of warp w takes N word l and K word
  // (l + it) % 32 for its it = 4w .. 4w + 3: the 32 lanes' loads and
  // stores land in 32 banks.
  static __device__ __forceinline__ void transpose(const uint8_t* st, uint8_t* t) {
    const uint8_t* raw = st + kX;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int box = 0; box < BN / 128; ++box) {
      const uint8_t* src = raw + box * kBox;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nw = lane;                        // N bytes 4 nw .. 4 nw + 3 of the box
        const int kq = (lane + 4 * warp + i) % 32;  // K rows 4 kq .. 4 kq + 3
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = 4 * kq + r;
          a[r] = *reinterpret_cast<const uint32_t*>(src + k * kRowBytes +
                                                    (((nw >> 2) ^ (k & 7)) << 4) + 4 * (nw & 3));
        }
        // b[c] byte r = a[r] byte c
        const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);
        const uint32_t t1 = __byte_perm(a[0], a[1], 0x7362);
        const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140);
        const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362);
        const uint32_t b[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = box * 128 + 4 * nw + c;
          *reinterpret_cast<uint32_t*>(t + n * kRowBytes + (((kq >> 2) ^ (n & 7)) << 4) +
                                       4 * (kq & 3)) = b[c];
        }
      }
    }
  }

  // The tile, rounded to bf16 or kept int32, through shared memory and TMA
  // stores.
  // (acc[4 c8 .. 4 c8 + 3]: the thread's column pair of 8-column group c8
  // in its upper row, then in the row 8 below)
  static __device__ __forceinline__ void epilogue(const Params& p, const Acc (&acc)[kAcc],
                                                  int tm, int tn, uint8_t* buf, uint8_t*) {
    using sm90::gemm::RowPairs;
    const int row0 = tm * kBM + 64 * (threadIdx.x / 128);
    if constexpr (KIND == kBf16) {
      sm90::gemm::store_tile<sm90::bf16, BN / 64, 2>(
          p.out, buf, row0, tn * BN, p.m, p.n, [&](int c8) {
            return RowPairs<sm90::bf16>{{sm90::pack_bf16x2(acc[4 * c8], acc[4 * c8 + 1]),
                                         sm90::pack_bf16x2(acc[4 * c8 + 2], acc[4 * c8 + 3])}};
          });
    } else {
      sm90::gemm::store_tile<int, BN / 32, BN / 32>(
          p.out, buf, row0, tn * BN, p.m, p.n, [&](int c8) {
            return RowPairs<int>{{make_int2(acc[4 * c8], acc[4 * c8 + 1]),
                                  make_int2(acc[4 * c8 + 2], acc[4 * c8 + 3])}};
          });
    }
  }
};

template <int KIND, int BN>
__global__ void __launch_bounds__(sm90::gemm::kThreads, 1)
mm_wgmma_kernel(const __grid_constant__ MmParams p) {
  sm90::gemm::run<MmOp<KIND, BN>>(p);
}

// K panels of a tile: 64 bf16 or 128 int8 columns of x.
int panels(int kind, int k) { return kind == kBf16 ? (k + 63) / 64 : (k + 127) / 128; }

// BN and the schedule: the cheaper, a panel of BN columns weighed BN + 32;
// int8 always 128 (at 256 its transposes and accumulator spill past the
// consumers' 240 registers).
sm90::gemm::Sched choose(int kind, int m, int k, int n, int* bn) {
  const int sms = sm90::sm_count();
  const int tiles_m = (m + kBM - 1) / kBM;
  double c128, c256;
  const sm90::gemm::Sched s128 = sm90::gemm::plan(tiles_m, (n + 127) / 128, panels(kind, k), sms,
                                                  &c128);
  const sm90::gemm::Sched s256 = sm90::gemm::plan(tiles_m, (n + 255) / 256, panels(kind, k), sms,
                                                  &c256);
  *bn = kind == kInt8 || c128 * (128 + 32) < c256 * (256 + 32) ? 128 : 256;
  return *bn == 128 ? s128 : s256;
}

template <int KIND, int BN>
int launch(MmParams& p, const void* x, const void* w, void* out, int m, int k, int n,
           long long ldx, long long ldw, cudaStream_t stream) {
  using Op = MmOp<KIND, BN>;
  const bool ok =
      KIND == kBf16
          ? sm90::make_map_rows(&p.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, m, ldx, kBM) &&
                sm90::make_map_rows(&p.w, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, k, ldw,
                                    64) &&
                sm90::make_map_rows(&p.out, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, m, n,
                                    64)
          : sm90::make_map_rows(&p.x, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, m, ldx, kBM) &&
                sm90::make_map_rows(&p.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, k, ldw, 128) &&
                sm90::make_map_rows(&p.out, out, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, n, m, n, 64);
  if (!ok) return (int)cudaErrorInvalidPitchValue;
  const void* kernel = reinterpret_cast<const void*>(mm_wgmma_kernel<KIND, BN>);
  constexpr int kBytes = sm90::gemm::Layout<Op>::kBytes;
  static sm90::PerDevice smem_set;
  const cudaError_t err = sm90::allow_smem(kernel, kBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  mm_wgmma_kernel<KIND, BN><<<p.sched.grid, sm90::gemm::kThreads, kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

bool valid(int kind, int m, int k, int n) {
  return m > 0 && k > 0 && n > 0 && (kind == kBf16 || kind == kInt8) &&
         (long long)((m + kBM - 1) / kBM) * ((n + 127) / 128) < (1ll << 31);
}

}  // namespace

// The schedule probe_mm launches at this shape on the current device: fills
// info with {BN, tiles_m, tiles_n, K panels, grid, whole tiles, split
// tiles, chunks a split tile} and returns the workspace bytes its split
// tiles take (0: none), or -1 for an empty shape or an unknown kind.
extern "C" long long probe_mm_plan(int kind, int m, int k, int n, long long* info) {
  if (!valid(kind, m, k, n)) return -1;
  int bn;
  const sm90::gemm::Sched s = choose(kind, m, k, n, &bn);
  sm90::gemm::describe(s, bn, info);
  return sm90::gemm::workspace_bytes(s, bn / 2);
}

// Plain C entry point (loaded with ctypes). x: (m, k) with row stride ldx;
// w: (k, n) with row stride ldw; both unit stride along their rows; out:
// (m, n) contiguous. kind 0: x, w and out bf16 (fp32 accumulation); kind 1:
// x and w int8, out int32. workspace: probe_mm_plan's bytes for this shape
// (any pointer where it gives 0), on the launch's stream; counters:
// sm90::gemm::kMaxCounters int32 zeros, which the kernel leaves zero (one
// buffer for the launches of one stream). Every base address and row stride
// must be a multiple of 16 bytes (the TMA's rule). Returns
// cudaGetLastError() after the launch (0 on success); an operand whose
// tensor map cuTensorMapEncodeTiled refuses returns
// cudaErrorInvalidPitchValue, an empty shape or an unknown kind
// cudaErrorInvalidValue, both without launching.
extern "C" int probe_mm(const void* x, const void* w, void* out, int kind, int m, int k, int n,
                        long long ldx, long long ldw, void* workspace, void* counters,
                        void* stream) {
  if (!valid(kind, m, k, n)) return (int)cudaErrorInvalidValue;
  MmParams p{};
  int bn;
  p.sched = choose(kind, m, k, n, &bn);
  p.workspace = workspace;
  p.counters = static_cast<int*>(counters);
  p.m = m;
  p.n = n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kBf16) {
    return bn == 128 ? launch<kBf16, 128>(p, x, w, out, m, k, n, ldx, ldw, s)
                     : launch<kBf16, 256>(p, x, w, out, m, k, n, ldx, ldw, s);
  }
  return launch<kInt8, 128>(p, x, w, out, m, k, n, ldx, ldw, s);
}
