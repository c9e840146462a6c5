// K5: the GEGLU projection of the UNet's feed-forward, fused, bf16 in and
// out, fp32 accumulation, written for Hopper (sm_90a) on the helpers of
// sm90_tiles.cuh:
//
//   out[m, j] = (x Wh^T + bh)[m, j] * gelu((x Wg^T + bg)[m, j])
//
// with x (M, K), W = [Wh; Wg] diffusers' (2*inner, K) `net.0.proj.weight`
// (Wh its first `inner` rows, Wg the rest: chunk(2)'s order), the bias
// optional, and gelu the tanh approximation (the bf16 path's rule), the
// exact erf form, or none (h * g). Replaces the TPU kernels of the GEGLU
// probes: `_packed_kernel` (tools/probe_geglu_v2.py:36, reached through
// `geglu_packed` :43), `make_kernel` (tools/probe_geglu_epilogue.py:64,
// `geglu` :75), `_geglu_kernel` (tools/probe_geglu_tune.py:37,
// `pallas_geglu` :46) and `_geglu_kernel` (tools/probe_pallas_matmul.py:60,
// `pallas_geglu` :82). Their interleaved weight and grid order are TPU
// blocking choices; this kernel reads both halves of the diffusers weight
// in place, each through its own tensor map, so a tile past `inner` reads
// TMA's zeros and never the other half.
//
// What bounds it on an H100: operations. At SDXL's (M, K, inner) =
// (8192, 640, 2560) the products are 53.7 GFLOP (0.054 ms at 989 TFLOP/s)
// against 59 MB of x, W and the output (0.018 ms at 3.35 TB/s). The
// unfused chain (a GEMM to (M, 2*inner), then gelu and a multiply) writes
// the product to device memory and reads it back twice; here the product
// lives in registers and only the output leaves.
//
// Design (geglu_wgmma_kernel<BN, G>):
//   * one CTA per 128 rows of x and BN (128 or 64) output columns: two
//     warpgroups of 64 rows, 256 threads, no producer warp (a third, partial
//     warpgroup would cap a thread at 168 registers, and a warpgroup holds
//     BN accumulator registers a thread).
//   * a stage holds one 64-column panel of K: the x tile (128 rows), then
//     BN rows of Wh and BN rows of Wg, one after the other, so the stage's
//     W part is one K-major panel of 2*BN rows. Each warpgroup's product of
//     a panel is then 4 wgmma instructions of N = 2*BN (m64n256k16 at
//     BN = 128), one accumulator holding [h | g]: h of output column c and
//     g of the same column sit in the same thread, BN/2 registers apart.
//   * the stages form an mbarrier ring (4 of 48 KB at BN = 128, 6 of 32 KB
//     at 64): thread 0 issues the first stages' TMA loads, and each later
//     one as soon as both warpgroups have finished the products that read
//     the stage (one product group stays in flight: wgmma.wait_group 1).
//     K past the tensor (K = 320, 640, 1280 are whole panels; any other is
//     zero-filled by TMA) adds zero.
//   * epilogue in registers: bias, gelu (tanh.approx.f32 for the tanh form),
//     the product h * gelu(g), rounded to bf16 into swizzled panels of
//     shared memory, then TMA stores that leave out rows past M and
//     columns past `inner`.
//   * BN is chosen per call (choose_bn): 64 where it gives the card a
//     fuller last wave (SD1.5's (512, 1280, 5120): 320 CTAs of 64 against
//     160 of 128 on 132 SMs; the mid block's (128, 1280, 5120): 80 against
//     40).

#include <math.h>

#include <algorithm>

#include "sm90_tiles.cuh"

namespace {

using sm90::kPanelCols;
using sm90::kRowBytes;

enum Gelu { kNone = 0, kTanh = 1, kErf = 2 };

constexpr int kBM = 128;  // rows of x a CTA owns: two warpgroups of 64
constexpr int kThreads = 256;

template <int BN>
constexpr int kStages = BN == 128 ? 4 : 6;

// Shared memory of one CTA, in bytes from a 1024-aligned base: the stages
// (x panel, then the Wh and Wg rows), the output panels (BN/64 of 64 rows
// per warpgroup), the barriers.
template <int BN>
struct Smem {
  static constexpr int kX = kBM * kRowBytes;
  static constexpr int kW = 2 * BN * kRowBytes;
  static constexpr int kStage = kX + kW;
  static constexpr int kOutPanel = 64 * kRowBytes;
  static constexpr int kOut = kStages<BN> * kStage;
  static constexpr int kBars = kOut + 2 * (BN / 64) * kOutPanel;
  static constexpr int kBytes = kBars + 2 * kStages<BN> * 8 + sm90::kSmemAlign;
};

struct GegluMaps {
  sm90::Map x, wh, wg, out;
};

struct GegluArgs {
  const sm90::bf16* bias;  // null, or (2*inner): bh then bg
  int m, inner, k_panels;
};

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int G>
__device__ __forceinline__ float gelu(float g) {
  if constexpr (G == kTanh) {
    const float u = 0.7978845608028654f * (g + 0.044715f * g * g * g);
    return 0.5f * g * (1.f + tanh_approx(u));
  } else if constexpr (G == kErf) {
    return 0.5f * g * (1.f + erff(g * 0.7071067811865476f));
  } else {
    return g;
  }
}

// TMA loads of K panel j into its stage (thread 0 only).
template <int BN>
__device__ __forceinline__ void load_panel(uint8_t* smem, uint64_t* full, const GegluMaps& maps,
                                           int j, int m0, int n0) {
  using L = Smem<BN>;
  const int s = j % kStages<BN>;
  uint8_t* st = smem + s * L::kStage;
  sm90::mbar_expect_tx(&full[s], L::kStage);
  sm90::tma_load(st, maps.x, &full[s], j * kPanelCols, 0, m0, 0);
  sm90::tma_load(st + L::kX, maps.wh, &full[s], j * kPanelCols, 0, n0, 0);
  sm90::tma_load(st + L::kX + BN * kRowBytes, maps.wg, &full[s], j * kPanelCols, 0, n0, 0);
}

template <int BN, int G>
__global__ void __launch_bounds__(kThreads, 1)
geglu_wgmma_kernel(const __grid_constant__ GegluMaps maps, const GegluArgs a) {
  using L = Smem<BN>;
  constexpr int S = kStages<BN>;
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
    for (int j = 0; j < min(S, nk); ++j) load_panel<BN>(smem, full, maps, j, m0, n0);
  }
  __syncthreads();

  // ---- the products: acc = x [Wh; Wg]^T over K, one panel a stage ----
  // written first by the products (scale-d 0 on the first step): no other
  // instruction may define it before the last wait, or ptxas serializes the
  // products
  float acc[BN];
  for (int j = 0; j < nk; ++j) {
    const int s = j % S;
    sm90::mbar_wait(&full[s], (j / S) & 1);
    const uint8_t* st = smem + s * L::kStage;
    const uint8_t* xs = st + wg * 64 * kRowBytes;
    const uint8_t* ws = st + L::kX;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_ss(acc, sm90::desc_k(xs + 32 * kk), sm90::desc_k(ws + 32 * kk), j > 0 || kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_n<1>();  // panel j - 1's products are done: its stage is free
    if (j > 0) {
      const int sp = (j - 1) % S;
      sm90::mbar_arrive(&empty[sp]);
      if (threadIdx.x == 0 && j - 1 + S < nk) {
        sm90::mbar_wait(&empty[sp], ((j - 1) / S) & 1);
        load_panel<BN>(smem, full, maps, j - 1 + S, m0, n0);
      }
      __syncwarp();
    }
  }
  sm90::wgmma_wait();
  sm90::fence_regs(acc);

  // ---- epilogue: bias, h * gelu(g), bf16, through shared memory ----
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int t = lane % 4;
  uint8_t* out = smem + L::kOut + wg * (BN / 64) * L::kOutPanel;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int col = 8 * n + 2 * t;  // and col + 1, of the tile
    float bh[2] = {0.f, 0.f}, bg[2] = {0.f, 0.f};
    if (a.bias != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (n0 + col + i < a.inner) {
          bh[i] = __bfloat162float(a.bias[n0 + col + i]);
          bg[i] = __bfloat162float(a.bias[a.inner + n0 + col + i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float o[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float h = acc[4 * n + 2 * r + i] + bh[i];
        const float g = acc[BN / 2 + 4 * n + 2 * r + i] + bg[i];
        o[i] = h * gelu<G>(g);
      }
      *reinterpret_cast<uint32_t*>(out + (n / 8) * L::kOutPanel +
                                   sm90::swz(r0 + 8 * r, col % kPanelCols)) =
          sm90::pack_bf16x2(o[0], o[1]);
    }
  }
  sm90::fence_async_shared();
  sm90::named_bar(1 + wg, 128);
  const int row0 = m0 + 64 * wg;
  if (tid == 0 && row0 < a.m) {
    for (int p = 0; p < BN / 64; ++p) {
      if (n0 + p * kPanelCols < a.inner) {
        sm90::tma_store(maps.out, out + p * L::kOutPanel, n0 + p * kPanelCols, 0, row0, 0);
      }
    }
    sm90::tma_store_wait();
  }
}

// The map of a row-major bf16 matrix of `rows` x `cols` with row stride ld
// (elements), in boxes of 64 columns by box_rows rows.
bool map2d(sm90::Map* m, const void* base, int cols, int rows, long long ld, int box_rows) {
  return sm90::make_map_rows(m, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cols, rows, ld,
                             box_rows);
}

// Output columns a CTA takes: the fewer waves of CTAs on the card, each
// wave's cost taken as its columns plus a fixed 32 for the ring's fill and
// the epilogue.
int choose_bn(int m, int inner) {
  const long long sms = sm90::sm_count();
  const long long row_tiles = (m + kBM - 1) / kBM;
  auto cost = [&](int bn) {
    const long long ctas = row_tiles * ((inner + bn - 1) / bn);
    return (ctas + sms - 1) / sms * (bn + 32);
  };
  return cost(64) < cost(128) ? 64 : 128;
}

template <int BN, int G>
int launch(const void* x, const void* w, const void* bias, void* out, int m, int k, int inner,
           long long ldx, long long ldw, cudaStream_t stream) {
  GegluMaps maps{};
  if (!map2d(&maps.x, x, k, m, ldx, kBM) || !map2d(&maps.wh, w, k, inner, ldw, BN) ||
      !map2d(&maps.wg, static_cast<const sm90::bf16*>(w) + (long long)inner * ldw, k, inner, ldw,
             BN) ||
      !map2d(&maps.out, out, inner, m, inner, 64)) {
    return (int)cudaErrorInvalidPitchValue;
  }
  const GegluArgs a{static_cast<const sm90::bf16*>(bias), m, inner,
                    (k + kPanelCols - 1) / kPanelCols};
  const void* kernel = reinterpret_cast<const void*>(geglu_wgmma_kernel<BN, G>);
  static sm90::PerDevice smem_set;
  const cudaError_t err = sm90::allow_smem(kernel, Smem<BN>::kBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((inner + BN - 1) / BN, (m + kBM - 1) / kBM);
  geglu_wgmma_kernel<BN, G><<<grid, kThreads, Smem<BN>::kBytes, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

template <int G>
int launch_gelu(const void* x, const void* w, const void* bias, void* out, int m, int k,
                int inner, long long ldx, long long ldw, cudaStream_t stream) {
  if (choose_bn(m, inner) == 64) {
    return launch<64, G>(x, w, bias, out, m, k, inner, ldx, ldw, stream);
  }
  return launch<128, G>(x, w, bias, out, m, k, inner, ldx, ldw, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). x: (m, k) with row stride ldx;
// w: (2*inner, k) with row stride ldw, Wh its first inner rows; bias: null
// or (2*inner) contiguous; out: (m, inner) contiguous; all bf16, unit stride
// along k. gelu: 0 none (h * g), 1 tanh approximation, 2 exact erf. Every
// base address and row stride must be a multiple of 16 bytes (the TMA's
// rule). Returns cudaGetLastError() after the launch (0 on success); an
// operand whose tensor map cuTensorMapEncodeTiled refuses returns
// cudaErrorInvalidPitchValue, an empty shape or an unknown gelu
// cudaErrorInvalidValue, both without launching.
extern "C" int geglu_bf16(const void* x, const void* w, const void* bias, void* out, int m, int k,
                          int inner, long long ldx, long long ldw, int gelu, void* stream) {
  if (m <= 0 || k <= 0 || inner <= 0 || (m + kBM - 1) / kBM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gelu) {
    case kNone: return launch_gelu<kNone>(x, w, bias, out, m, k, inner, ldx, ldw, s);
    case kTanh: return launch_gelu<kTanh>(x, w, bias, out, m, k, inner, ldx, ldw, s);
    case kErf: return launch_gelu<kErf>(x, w, bias, out, m, k, inner, ldx, ldw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
