// P1: the plain matrix product of the matmul probe, out = x W, written for
// Hopper (sm_90a) on the helpers of sm90_tiles.cuh, in two type pairs:
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
// Design (mm_wgmma_kernel<KIND, BN>), after K5's (geglu.cu) without its
// epilogue:
//   * one CTA per 128 rows of x and BN (128 or 256) columns of W: two
//     warpgroups of 64 rows, 256 threads, thread 0 issues the TMA loads (no
//     producer warp, so a thread may use up to 255 registers: the
//     accumulator is BN/2 of them).
//   * a stage of the mbarrier ring holds one 128-byte panel of K: the x tile
//     (K-major) and W's tile of the same K rows, which TMA brings as it lies
//     in device memory: K rows by N columns, i.e. MN-major for the product.
//   * bf16: wgmma reads W's tile MN-major through its descriptor (the
//     transpose bit of B; the BN/64 panels of 64 columns are one operand of
//     N = BN, desc_mn_panels), so no copy is made. The ring is K5's: each
//     stage is refilled as soon as both warpgroups' products on it are done
//     (one product group stays in flight).
//   * int8: the int8 product has no transpose bit, it reads B K-major only.
//     So the 256 threads transpose each W tile in shared memory into a
//     K-major 128-byte swizzled panel of BN rows (4 x 4 byte blocks, 32-bit
//     loads and stores and byte permutes, conflict-free on both sides),
//     into one of two panels: the transpose of panel j + 1 runs while the
//     products of panel j are in flight. One barrier of the 256 threads a
//     panel orders the two; the stage is refilled behind it.
//   * K past the tensor is zero-filled by TMA and adds zero; rows past M and
//     columns past N are left out by the TMA stores.
//   * epilogue: the accumulator, rounded to bf16 or kept int32, into
//     swizzled 128-byte panels of shared memory (the ring, free by then),
//     then TMA stores.
//   * BN by the round of CTAs over the SMs (choose_bn, K5's rule): 128 where
//     256 would leave a fuller round idle ((8192, 2560, 640): 320 CTAs of
//     128 columns against 192 of 256, a third of them half empty).

#include <algorithm>
#include <type_traits>

#include "sm90_tiles.cuh"

namespace {

using sm90::kRowBytes;

enum Kind { kBf16 = 0, kInt8 = 1 };

constexpr int kBM = 128;  // rows of x a CTA owns: two warpgroups of 64
constexpr int kThreads = 256;
constexpr int kBox = 128 * kRowBytes;  // an int8 W box: 128 K rows of 128 N bytes

// Shared memory of one CTA, in bytes from a 1024-aligned base: the stages
// (x panel, then W's tile), the two transposed W panels (int8), the
// barriers. The output tile is staged at offset 0 once the ring is done.
template <int KIND, int BN>
struct MmSmem {
  static constexpr int kX = kBM * kRowBytes;
  // bf16: BN/64 panels of 64 K rows; int8: BN/128 boxes of 128 K rows
  static constexpr int kW = BN * kRowBytes;
  static constexpr int kStage = kX + kW;
  static constexpr int kStages = KIND == kBf16 ? (BN == 256 ? 4 : 6) : (BN == 256 ? 3 : 5);
  static constexpr int kT = KIND == kInt8 ? BN * kRowBytes : 0;  // BN rows of 128 K bytes
  static constexpr int kTOff = kStages * kStage;
  static constexpr int kBars = kTOff + 2 * kT;
  // output panels of 64 rows by 128 bytes, BN * out bytes / 128 a warpgroup
  static constexpr int kOutPanels = KIND == kBf16 ? BN / 64 : BN / 32;
  static constexpr int kOut = 2 * kOutPanels * 64 * kRowBytes;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + sm90::kSmemAlign;
  static_assert(kOut <= kBars, "the output tile reuses the ring");
  static_assert(kBytes <= 232448, "more shared memory than a block may use");
};

struct MmMaps {
  sm90::Map x, w, out;
};

struct MmArgs {
  int m, n, k_panels;
};

// TMA loads of K panel j into its stage (thread 0 only).
template <int KIND, int BN>
__device__ __forceinline__ void load_panel(uint8_t* smem, uint64_t* full, const MmMaps& maps,
                                           int j, int m0, int n0) {
  using L = MmSmem<KIND, BN>;
  const int s = j % L::kStages;
  uint8_t* st = smem + s * L::kStage;
  sm90::mbar_expect_tx(&full[s], L::kStage);
  if constexpr (KIND == kBf16) {
    sm90::tma_load(st, maps.x, &full[s], j * 64, 0, m0, 0);
#pragma unroll
    for (int p = 0; p < BN / 64; ++p) {
      sm90::tma_load(st + L::kX + p * 64 * kRowBytes, maps.w, &full[s], n0 + 64 * p, 0, j * 64,
                     0);
    }
  } else {
    sm90::tma_load(st, maps.x, &full[s], j * 128, 0, m0, 0);
#pragma unroll
    for (int p = 0; p < BN / 128; ++p) {
      sm90::tma_load(st + L::kX + p * kBox, maps.w, &full[s], n0 + 128 * p, 0, j * 128, 0);
    }
  }
}

// The int8 W tile of a stage (BN/128 boxes of 128 K rows by 128 N bytes, as
// TMA wrote them: byte n of row k at chunk (n / 16) ^ (k % 8)) into a
// K-major panel of BN rows (byte k of row n at chunk (k / 16) ^ (n % 8)),
// by all 256 threads. A thread moves 4 x 4 byte blocks: four 32-bit loads
// (4 K rows, 4 N bytes), byte permutes, four 32-bit stores (4 N rows, 4 K
// bytes). Lane l of warp w takes N word l and K word (l + it) % 32 for its
// it = 4w .. 4w + 3: the 32 lanes' loads and stores land in 32 banks.
template <int BN>
__device__ __forceinline__ void transpose_w(const uint8_t* raw, uint8_t* t) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int box = 0; box < BN / 128; ++box) {
    const uint8_t* src = raw + box * kBox;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nw = lane;                       // N bytes 4 nw .. 4 nw + 3 of the box
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

template <int KIND, int BN>
__global__ void __launch_bounds__(kThreads, 1)
mm_wgmma_kernel(const __grid_constant__ MmMaps maps, const MmArgs a) {
  using L = MmSmem<KIND, BN>;
  constexpr int S = L::kStages;
  using Acc = typename std::conditional<KIND == kBf16, float, int>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (sm90::kSmemAlign - sm90::smem_u32(smem_raw) % sm90::kSmemAlign) %
                                 sm90::kSmemAlign;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + S;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * kBM;
  const int wg = threadIdx.x / 128;
  const int nk = a.k_panels;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kThreads);
    }
    sm90::fence_barrier_init();
    for (int j = 0; j < min(S, nk); ++j) load_panel<KIND, BN>(smem, full, maps, j, m0, n0);
  }
  __syncthreads();

  // written first by the products (scale-d 0 on the first step): no other
  // instruction may define it before the last wait, or ptxas serializes the
  // products
  Acc acc[BN / 2];
  if constexpr (KIND == kBf16) {
    for (int j = 0; j < nk; ++j) {
      const int s = j % S;
      sm90::mbar_wait(&full[s], (j / S) & 1);
      const uint8_t* st = smem + s * L::kStage;
      const uint8_t* xs = st + wg * 64 * kRowBytes;
      const uint8_t* ws = st + L::kX;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_ss_mn(acc, sm90::desc_k(xs + 32 * kk),
                          sm90::desc_mn_panels(ws + 2048 * kk, 64 * kRowBytes), j > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_n<1>();  // panel j - 1's products are done: its stage is free
      if (j > 0) {
        const int sp = (j - 1) % S;
        sm90::mbar_arrive(&empty[sp]);
        if (threadIdx.x == 0 && j - 1 + S < nk) {
          sm90::mbar_wait(&empty[sp], ((j - 1) / S) & 1);
          load_panel<KIND, BN>(smem, full, maps, j - 1 + S, m0, n0);
        }
        __syncwarp();
      }
    }
  } else {
    uint8_t* tp = smem + L::kTOff;  // the two transposed panels
    sm90::mbar_wait(&full[0], 0);
    transpose_w<BN>(smem + L::kX, tp);
    sm90::fence_async_shared();
    sm90::named_bar(1, kThreads);
    for (int j = 0; j < nk; ++j) {
      const int s = j % S;
      const uint8_t* xs = smem + s * L::kStage + wg * 64 * kRowBytes;
      const uint8_t* ws = tp + (j & 1) * L::kT;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_ss_s8(acc, sm90::desc_k(xs + 32 * kk), sm90::desc_k(ws + 32 * kk),
                          j > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      if (j + 1 < nk) {  // the next panel's transpose, under these products
        const int s1 = (j + 1) % S;
        sm90::mbar_wait(&full[s1], ((j + 1) / S) & 1);
        transpose_w<BN>(smem + s1 * L::kStage + L::kX, tp + ((j + 1) & 1) * L::kT);
      }
      sm90::wgmma_wait();
      sm90::fence_async_shared();
      // both warpgroups' products of panel j are done (its stage and its
      // transposed panel are free) and panel j + 1's transpose is written
      sm90::named_bar(1, kThreads);
      if (threadIdx.x == 0 && j + S < nk) load_panel<KIND, BN>(smem, full, maps, j + S, m0, n0);
    }
  }
  sm90::wgmma_wait();
  sm90::fence_regs(acc);
  sm90::named_bar(1, kThreads);  // every product has read the ring

  // ---- epilogue: the accumulator into 128-byte panels, TMA stores ----
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int t = lane % 4;
  constexpr int kPanel = 64 * kRowBytes;
  uint8_t* out = smem + wg * L::kOutPanels * kPanel;
#pragma unroll
  for (int nn = 0; nn < BN / 8; ++nn) {
    const int col = 8 * nn + 2 * t;  // and col + 1, of the tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if constexpr (KIND == kBf16) {
        *reinterpret_cast<uint32_t*>(out + (col / 64) * kPanel + sm90::swz(row, col % 64)) =
            sm90::pack_bf16x2(acc[4 * nn + 2 * r], acc[4 * nn + 2 * r + 1]);
      } else {
        const int c = col % 32;  // int32 column of the panel: 16-byte chunk c / 4
        *reinterpret_cast<int2*>(out + (col / 32) * kPanel + row * kRowBytes +
                                 (((c >> 2) ^ (row & 7)) << 4) + 4 * (c & 3)) =
            make_int2(acc[4 * nn + 2 * r], acc[4 * nn + 2 * r + 1]);
      }
    }
  }
  sm90::fence_async_shared();
  sm90::named_bar(2 + wg, 128);
  const int row0 = m0 + 64 * wg;
  constexpr int kCols = KIND == kBf16 ? 64 : 32;  // output columns of a panel
  if (tid == 0 && row0 < a.m) {
    for (int p = 0; p < L::kOutPanels; ++p) {
      if (n0 + p * kCols < a.n) {
        sm90::tma_store(maps.out, out + p * kPanel, n0 + p * kCols, 0, row0, 0);
      }
    }
    sm90::tma_store_wait();
  }
}

// Columns a CTA takes: the fewer rounds of CTAs on the card, each round's
// cost taken as its columns plus a fixed 32 for the ring's fill and the
// epilogue (K5's rule).
int choose_bn(int m, int n) {
  const long long sms = sm90::sm_count();
  const long long row_tiles = (m + kBM - 1) / kBM;
  auto cost = [&](int bn) {
    const long long ctas = row_tiles * ((n + bn - 1) / bn);
    return (ctas + sms - 1) / sms * (bn + 32);
  };
  return cost(128) < cost(256) ? 128 : 256;
}

template <int KIND, int BN>
int launch(const void* x, const void* w, void* out, int m, int k, int n, long long ldx,
           long long ldw, cudaStream_t stream) {
  using L = MmSmem<KIND, BN>;
  MmMaps maps{};
  const bool ok =
      KIND == kBf16
          ? sm90::make_map_rows(&maps.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, m, ldx, kBM) &&
                sm90::make_map_rows(&maps.w, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, k, ldw,
                                    64) &&
                sm90::make_map_rows(&maps.out, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, m, n,
                                    64)
          : sm90::make_map_rows(&maps.x, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, m, ldx, kBM) &&
                sm90::make_map_rows(&maps.w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, k, ldw,
                                    128) &&
                sm90::make_map_rows(&maps.out, out, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, n, m, n,
                                    64);
  if (!ok) return (int)cudaErrorInvalidPitchValue;
  const int kcols = KIND == kBf16 ? 64 : 128;
  const MmArgs a{m, n, (k + kcols - 1) / kcols};
  const void* kernel = reinterpret_cast<const void*>(mm_wgmma_kernel<KIND, BN>);
  static sm90::PerDevice smem_set;
  const cudaError_t err = sm90::allow_smem(kernel, L::kBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BN - 1) / BN, (m + kBM - 1) / kBM);
  mm_wgmma_kernel<KIND, BN><<<grid, kThreads, L::kBytes, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_kind(const void* x, const void* w, void* out, int m, int k, int n, long long ldx,
                long long ldw, cudaStream_t stream) {
  if (choose_bn(m, n) == 128) return launch<KIND, 128>(x, w, out, m, k, n, ldx, ldw, stream);
  return launch<KIND, 256>(x, w, out, m, k, n, ldx, ldw, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). x: (m, k) with row stride ldx;
// w: (k, n) with row stride ldw; both unit stride along their rows; out:
// (m, n) contiguous. kind 0: x, w and out bf16 (fp32 accumulation); kind 1:
// x and w int8, out int32. Every base address and row stride must be a
// multiple of 16 bytes (the TMA's rule). Returns cudaGetLastError() after
// the launch (0 on success); an operand whose tensor map
// cuTensorMapEncodeTiled refuses returns cudaErrorInvalidPitchValue, an
// empty shape or an unknown kind cudaErrorInvalidValue, both without
// launching.
extern "C" int probe_mm(const void* x, const void* w, void* out, int kind, int m, int k, int n,
                        long long ldx, long long ldw, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (m + kBM - 1) / kBM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kBf16: return launch_kind<kBf16>(x, w, out, m, k, n, ldx, ldw, s);
    case kInt8: return launch_kind<kInt8>(x, w, out, m, k, n, ldx, ldw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
