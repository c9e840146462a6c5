// K5: the GEGLU projection of the UNet's feed-forward, fused, bf16 in and
// out, fp32 accumulation, written for Hopper (sm_90a) on the GEMM mainloop
// of sm90_gemm.cuh:
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
// Design (geglu_wgmma_kernel<BN, G>, an Op of sm90_gemm.cuh): the
// mainloop's persistent, warp-specialized CTAs (a producer warp issues the
// TMA loads, two consumer warpgroups of 64 rows with 240 registers a thread
// run the products, the K loop split across CTAs where whole tiles would
// leave the card's last wave part empty) over tiles of 128 rows by BN (64
// or 128) output columns.
//   * a stage holds one 64-column panel of K: the x tile (128 rows), then
//     BN rows of Wh and BN rows of Wg, one after the other, so the stage's
//     W part is one K-major panel of 2*BN rows. Each warpgroup's product of
//     a panel is then 4 wgmma instructions of N = 2*BN (m64n256k16 at
//     BN = 128), one accumulator holding [h | g]: h of output column c and
//     g of the same column sit in the same thread, BN/2 registers apart.
//     4 stages of 48 KB at BN = 128, 6 of 32 KB at 64.
//   * a split tile's pieces sum [h | g] in fp32 before the epilogue (gelu is
//     not linear); the piece that sums runs it. No UNet shape is split: K is
//     5-20 panels there, too few to pay for the partials; a long K such as
//     (2048, 5120, 1280) is.
//   * K past the tensor (K = 320, 640, 1280 are whole panels; any other is
//     zero-filled by TMA) adds zero.
//   * epilogue in registers: bias, gelu (tanh.approx.f32 for the tanh form),
//     the product h * gelu(g), rounded to bf16 into the warpgroup's staging
//     buffer (BN/64 128-byte panels, beside the ring), then TMA stores, left
//     in flight, that leave out rows past M and columns past `inner`.
//   * BN and the cut into whole and split tiles by the mainloop's cost
//     (sm90::gemm::plan), weighing a panel of BN columns as BN + 32 (a
//     narrower tile pays the same fixed cost a panel).

#include <math.h>

#include "sm90_gemm.cuh"

namespace {

using sm90::kPanelCols;
using sm90::kRowBytes;
using sm90::gemm::kBM;

enum Gelu { kNone = 0, kTanh = 1, kErf = 2 };

struct GegluParams {
  sm90::Map x, wh, wg, out;
  sm90::gemm::Sched sched;
  const sm90::bf16* bias;  // null, or (2*inner): bh then bg
  void* workspace;
  int* counters;
  int m, inner;
};

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// h * gelu(g), as 0.5 h g (1 + tanh(u)) with u = g (c0 + c1 g^2) (c0 =
// sqrt(2/pi), c1 = 0.044715 c0), or 0.5 h g (1 + erf(g / sqrt(2))), or h g:
// one fma a term fewer than gelu then a product.
template <int G>
__device__ __forceinline__ float h_gelu(float h, float g) {
  if constexpr (G == kNone) {
    return h * g;
  } else {
    const float hg = 0.5f * h * g;
    const float t = G == kTanh ? tanh_approx(g * fmaf(0.035677408136300125f, g * g,
                                                      0.7978845608028654f))
                               : erff(g * 0.7071067811865476f);
    return fmaf(hg, t, hg);
  }
}

template <int BN, int G>
struct GegluOp {
  using Acc = float;
  using Params = GegluParams;
  // [h | g]: 2 * BN columns over a warpgroup's 4 x 32 lanes, 2 rows each
  static constexpr int kAcc = BN;
  static constexpr int kX = kBM * kRowBytes;
  static constexpr int kStageBytes = kX + 2 * BN * kRowBytes;
  static constexpr int kStages = BN == 128 ? 4 : 6;
  static constexpr int kTBytes = 0;
  static constexpr int kOutBytes = (BN / kPanelCols) * 64 * kRowBytes;
  static constexpr int kExtraBytes = 2 * BN * 2;  // the tile's bias, bh then bg
  // the epilogue beside a 128-register accumulator needs 240
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;

  static __device__ __forceinline__ void load(const Params& p, uint8_t* st, uint64_t* full,
                                              int tm, int tn, int k) {
    sm90::mbar_expect_tx(full, kStageBytes);
    sm90::tma_load(st, p.x, full, k * kPanelCols, 0, tm * kBM, 0);
    sm90::tma_load(st + kX, p.wh, full, k * kPanelCols, 0, tn * BN, 0);
    sm90::tma_load(st + kX + BN * kRowBytes, p.wg, full, k * kPanelCols, 0, tn * BN, 0);
  }

  static __device__ __forceinline__ void mma(float (&acc)[kAcc], const uint8_t* st,
                                             const uint8_t*, int wg, int accumulate) {
    const uint8_t* xs = st + wg * 64 * kRowBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_ss(acc, sm90::desc_k(xs + 32 * kk), sm90::desc_k(st + kX + 32 * kk),
                     accumulate || kk > 0);
    }
  }

  // bias, h * gelu(g), bf16, through the warpgroup's staging buffer. The
  // tile's bias goes to the warpgroup's shared memory first, so a thread
  // reads each of its column pairs as one 32-bit word.
  static __device__ __forceinline__ void epilogue(const Params& p, const float (&acc)[kAcc],
                                                  int tm, int tn, uint8_t* buf, uint8_t* extra) {
    sm90::bf16* bias = reinterpret_cast<sm90::bf16*>(extra);
    const int tid = threadIdx.x % 128;
#pragma unroll
    for (int i = tid; i < 2 * BN; i += 128) {
      const int col = tn * BN + i % BN;
      bias[i] = p.bias != nullptr && col < p.inner ? p.bias[(i < BN ? 0 : p.inner) + col]
                                                   : __float2bfloat16(0.f);
    }
    sm90::named_bar(2 + threadIdx.x / 128, 128);
    const int t2 = 2 * (threadIdx.x % 4);
    sm90::gemm::store_tile<sm90::bf16, BN / kPanelCols, BN / kPanelCols>(
        p.out, buf, tm * kBM + 64 * (threadIdx.x / 128), tn * BN, p.m, p.inner, [&](int c8) {
          // h and g of the thread's column pair, upper row then the row 8 below
          const int ih = 4 * c8, ig = BN / 2 + 4 * c8;
          const float2 bh = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * c8 + t2));
          const float2 bg = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias + BN + 8 * c8 + t2));
          return sm90::gemm::RowPairs<sm90::bf16>{
              {sm90::pack_bf16x2(h_gelu<G>(acc[ih] + bh.x, acc[ig] + bg.x),
                                 h_gelu<G>(acc[ih + 1] + bh.y, acc[ig + 1] + bg.y)),
               sm90::pack_bf16x2(h_gelu<G>(acc[ih + 2] + bh.x, acc[ig + 2] + bg.x),
                                 h_gelu<G>(acc[ih + 3] + bh.y, acc[ig + 3] + bg.y))}};
        });
  }
};

template <int BN, int G>
__global__ void __launch_bounds__(sm90::gemm::kThreads, 1)
geglu_wgmma_kernel(const __grid_constant__ GegluParams p) {
  sm90::gemm::run<GegluOp<BN, G>>(p);
}

// The map of a row-major bf16 matrix of `rows` x `cols` with row stride ld
// (elements), in boxes of 64 columns by box_rows rows.
bool map2d(sm90::Map* m, const void* base, int cols, int rows, long long ld, int box_rows) {
  return sm90::make_map_rows(m, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, cols, rows, ld,
                             box_rows);
}

// Output columns a tile takes (64 or 128) and the schedule: the cheaper, a
// panel of BN columns weighed BN + 32; the erf form always 64 (at 128 its
// epilogue spills past the consumers' 240 registers).
sm90::gemm::Sched choose(int m, int k, int inner, int gelu, int* bn) {
  const int sms = sm90::sm_count();
  const int tiles_m = (m + kBM - 1) / kBM, nk = (k + kPanelCols - 1) / kPanelCols;
  double c64, c128;
  const sm90::gemm::Sched s64 = sm90::gemm::plan(tiles_m, (inner + 63) / 64, nk, sms, &c64);
  const sm90::gemm::Sched s128 = sm90::gemm::plan(tiles_m, (inner + 127) / 128, nk, sms, &c128);
  *bn = gelu == kErf || c64 * (64 + 32) < c128 * (128 + 32) ? 64 : 128;
  return *bn == 64 ? s64 : s128;
}

template <int BN, int G>
int launch(GegluParams& p, const void* x, const void* w, void* out, int m, int k, int inner,
           long long ldx, long long ldw, cudaStream_t stream) {
  using Op = GegluOp<BN, G>;
  if (!map2d(&p.x, x, k, m, ldx, kBM) || !map2d(&p.wh, w, k, inner, ldw, BN) ||
      !map2d(&p.wg, static_cast<const sm90::bf16*>(w) + (long long)inner * ldw, k, inner, ldw,
             BN) ||
      !map2d(&p.out, out, inner, m, inner, 64)) {
    return (int)cudaErrorInvalidPitchValue;
  }
  const void* kernel = reinterpret_cast<const void*>(geglu_wgmma_kernel<BN, G>);
  constexpr int kBytes = sm90::gemm::Layout<Op>::kBytes;
  static sm90::PerDevice smem_set;
  const cudaError_t err = sm90::allow_smem(kernel, kBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  geglu_wgmma_kernel<BN, G><<<p.sched.grid, sm90::gemm::kThreads, kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int G>
int launch_bn(GegluParams& p, int bn, const void* x, const void* w, void* out, int m, int k,
              int inner, long long ldx, long long ldw, cudaStream_t stream) {
  if (G == kErf || bn == 64) return launch<64, G>(p, x, w, out, m, k, inner, ldx, ldw, stream);
  // the erf form's 128-column instance is never built
  return launch<G == kErf ? 64 : 128, G>(p, x, w, out, m, k, inner, ldx, ldw, stream);
}

bool valid(int m, int k, int inner) {
  return m > 0 && k > 0 && inner > 0 &&
         (long long)((m + kBM - 1) / kBM) * ((inner + 63) / 64) < (1ll << 31);
}

}  // namespace

// The schedule geglu_bf16 launches at this shape and gelu on the current
// device: fills info with {BN (the tile's output columns), tiles_m,
// tiles_n, K panels, grid, whole tiles, split tiles, chunks a split tile}
// and returns the workspace bytes its split tiles take (0: none), or -1 for
// an empty shape or an unknown gelu.
extern "C" long long geglu_plan(int m, int k, int inner, int gelu, long long* info) {
  if (!valid(m, k, inner) || gelu < kNone || gelu > kErf) return -1;
  int bn;
  const sm90::gemm::Sched s = choose(m, k, inner, gelu, &bn);
  sm90::gemm::describe(s, bn, info);
  return sm90::gemm::workspace_bytes(s, bn);
}

// Plain C entry point (loaded with ctypes). x: (m, k) with row stride ldx;
// w: (2*inner, k) with row stride ldw, Wh its first inner rows; bias: null
// or (2*inner) contiguous; out: (m, inner) contiguous; all bf16, unit stride
// along k. gelu: 0 none (h * g), 1 tanh approximation, 2 exact erf.
// workspace: geglu_plan's bytes for this shape (any pointer where it gives
// 0), on the launch's stream; counters: sm90::gemm::kMaxCounters int32
// zeros, which the kernel leaves zero (one buffer for the launches of one
// stream). Every base address and row stride must be a multiple of 16
// bytes (the TMA's rule). Returns cudaGetLastError() after the launch (0 on
// success); an operand whose tensor map cuTensorMapEncodeTiled refuses
// returns cudaErrorInvalidPitchValue, an empty shape or an unknown gelu
// cudaErrorInvalidValue, both without launching.
extern "C" int geglu_bf16(const void* x, const void* w, const void* bias, void* out, int m, int k,
                          int inner, long long ldx, long long ldw, int gelu, void* workspace,
                          void* counters, void* stream) {
  if (!valid(m, k, inner) || gelu < kNone || gelu > kErf) return (int)cudaErrorInvalidValue;
  GegluParams p{};
  int bn;
  p.sched = choose(m, k, inner, gelu, &bn);
  p.bias = static_cast<const sm90::bf16*>(bias);
  p.workspace = workspace;
  p.counters = static_cast<int*>(counters);
  p.m = m;
  p.inner = inner;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gelu) {
    case kNone: return launch_bn<kNone>(p, bn, x, w, out, m, k, inner, ldx, ldw, s);
    case kTanh: return launch_bn<kTanh>(p, bn, x, w, out, m, k, inner, ldx, ldw, s);
    default: return launch_bn<kErf>(p, bn, x, w, out, m, k, inner, ldx, ldw, s);
  }
}
