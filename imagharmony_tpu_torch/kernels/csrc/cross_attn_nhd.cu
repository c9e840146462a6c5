// K2: fused cross-attention with the decoupled image-prompt (IP) branch,
// bf16 in and out, fp32 accumulation, written for Hopper (sm_90a) on the
// helpers of sm90_tiles.cuh:
//
//   out = softmax(q k^T * scale) v + ip_scale * softmax(q k_ip^T * scale) v_ip
//
// per head, in one pass over q; without k_ip/v_ip, the text branch alone.
// Replaces the TPU kernel `_cross_ip_nhd_kernel` (imagharmony_tpu/kernels/
// flash_attention.py:630), reached through `flash_cross_nhd` (:795) ->
// `_cross_nhd_impl` (:670). The Pallas kernel packs heads into 128 lanes,
// pads the keys to 128 on the host, computes exp2 in bf16 and wants v_ip
// pre-scaled by ip_scale in device memory. This one computes what the port's
// model computes: the exact fp32 softmax of each branch, each with its own
// max and normaliser, ip_scale one fp32 in device memory that the kernel
// reads (so one captured launch serves every step of a per-step IP scale
// schedule, its 0.0 steps too), the ragged key edges (77 text
// keys; 4, 16 or 257 IP keys) and query rows masked here, nothing padded in
// device memory.
//
// What bounds it on an H100: bytes. The keys are few, so the work is
// 4*B*H*Sq*(Sk + Sk_ip)*D flops against q and the output (2*B*Sq*H*D bf16
// each way) plus the small K/V: at SDXL's (B, Sq, H, D) = (2, 4096, 10, 64)
// with 77 + 4 keys, 1.7 GFLOP (1.7 us at 989 TFLOP/s) against ~21.4 MB
// (6.4 us at 3.35 TB/s). So the design reads q once and writes the output
// once, keeps copies in flight while the tensor cores work, and never writes
// logits or probabilities to device memory.
//
// Design (cross_attn_wgmma_kernel):
//   * one CTA per (batch, head) and a run of 64-row query tiles (tiles x,
//     x + gridDim.x, ...): one consumer warpgroup and one producer warp. The
//     grid holds as many CTAs as fit on the card at once (by shared memory
//     and registers: three an SM up to D = 64), so several share an SM and
//     the load of one overlaps the products of another, and no partial
//     second wave is left.
//   * a branch of at most 80 keys is resident: the producer warp brings its
//     K and V once per CTA by TMA, in boxes of 16 keys, so 77 keys take 80
//     rows and 4 keys 16. It then streams the Q tiles through a ring of 2-4
//     stages ("full" and "empty" mbarriers). Each finished tile leaves by
//     TMA store from its own stage; the stage is handed back to the producer
//     once that store has read it (checked one tile later), so the next
//     tiles' loads and the last tile's store overlap this tile's products.
//   * a resident branch takes one pass: S = Q K^T by wgmma over all its keys
//     at once (K-major from shared memory, keys past the branch masked to
//     -inf) in a 64-key accumulator and a 16-key tail (m64n16k16): 77 keys
//     are 64 + 16 columns, 4 or 16 keys one tail, so little of S, its exp2
//     and its registers goes to padding. Then the branch's exact row max and
//     sum from registers, P = exp2(s - m) * w with w = branch_scale / l,
//     rounded to bf16, and O += P V by wgmma with P from registers and V read
//     MN-major from the same rows, the contraction stopping at ceil(keys/16)
//     steps of 16. QK^T runs once per branch.
//   * a branch of more keys (MLPProj's 257) is streamed: the consumer walks
//     its 64-key chunks twice per query tile through one chunk buffer, once
//     for the row max and sum and once for P V, so its S never sits whole in
//     registers. Slow, and on no main path.
//   * one fp32 accumulator serves both branches: each arrives normalised and
//     scaled (w = 1 for text, ip_scale for IP), so ip_scale = 0 adds exactly
//     0 and there is no online rescaling. The scale is applied to S in fp32
//     (exp2(s * scale*log2(e) - m)), q is not rescaled or rounded.
//   * head dims 32, 40, 64, 80, 128, 160 are ceil(D/64) panels of 64 columns
//     (sm90_tiles.cuh): QK^T stops at ceil(D/16) steps, PV runs over whole
//     panels and TMA leaves the columns past D out of the store.
//   * every operand takes a batch, a head and a row stride through its own
//     tensor map: q the to_q output, k and v column views of the packed
//     to_kv output (row stride 2*H*D), k_ip and v_ip the IP projections, the
//     output the packed (B, Sq, H*D) buffer that to_out reads; a batch
//     stride of 0 reads batch 0 for every batch.

#include <math.h>

#include <algorithm>
#include <initializer_list>

#include "sm90_tiles.cuh"

namespace {

using sm90::kPanelCols;
using sm90::kRowBytes;

constexpr int kRows = 64;          // query rows of a tile, keys of a chunk
constexpr int kKeyBox = 16;        // keys of one K or V box
constexpr int kMaxResident = 80;   // keys of a branch kept in shared memory: 64 + a tail of 16
constexpr int kMaxStages = 4;      // Q / output tiles in flight
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory a block may take
constexpr int kSmemPerSm = 228 * 1024;
constexpr int kThreads = 128 + 32;
constexpr int kPanel = kRows * kRowBytes;  // one 64-row panel

struct CrossMaps {
  sm90::Map q, k, v, k_ip, v_ip, o;
};

// One branch of the kernel: its keys (0: no IP branch) and where its K and
// V are in shared memory when it is resident. Its weight is passed apart:
// 1 for text, the IP weight read from device memory for IP.
struct Branch {
  int keys;
  int resident;
  int k_off, v_off;  // byte offsets from the aligned base
  int rows;          // rows of each panel: keys rounded up to 16
};

struct CrossArgs {
  Branch text, ip;
  int n_tiles, stages;
  int chunk_off;  // streamed branches: the K chunk, the V chunk after it
  int q_off;      // the stages' Q / output tiles
  int bar_off;
  float scale_log2;
  const float* ip_scale;  // the IP branch's weight, in device memory
};

__host__ __device__ inline int round16(int n) { return (n + kKeyBox - 1) / kKeyBox * kKeyBox; }

// TMA loads of keys [row0, row0 + rows) of one head into panels of
// `panel_bytes`, in boxes of 16 keys (the last box zero-filled past the
// tensor's keys). One thread runs it; the bytes are kPanels<D> * round16(rows)
// * 128.
template <int D>
__device__ __forceinline__ void load_keys(uint8_t* dst, const sm90::Map& m, uint64_t* bar, int h,
                                          int b, int row0, int rows, int panel_bytes) {
  for (int p = 0; p < sm90::kPanels<D>; ++p)
    for (int r = 0; r < rows; r += kKeyBox) {
      sm90::tma_load(dst + p * panel_bytes + r * kRowBytes, m, bar, p * kPanelCols, h, row0 + r, b);
    }
}

// acc (64 query rows x 2M keys: 64, or 16 for a tail) = Q K^T over D
// columns: Q a tile of 64-row panels, K the keys from `k` in panels of
// `k_panel` bytes (rows past the loaded keys are read too and must be
// masked).
template <int D, int M>
__device__ __forceinline__ void scores(float (&acc)[M], const uint8_t* q, const uint8_t* k,
                                       int k_panel) {
#pragma unroll
  for (int s = 0; s < sm90::kSteps<D>; ++s) {
    const int off = (s % 4) * 32;
    sm90::wgmma_ss(acc, sm90::desc_k(q + (s / 4) * kPanel + off),
                   sm90::desc_k(k + (s / 4) * k_panel + off), s > 0);
  }
}

// S times cs = scale*log2(e) (log2 units), the keys key0 + column at and
// past `keys` set to -inf.
template <int M>
__device__ __forceinline__ void scale_and_mask(float (&sc)[M], float cs, int key0, int keys) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int e = 0; e < M; ++e) {
    sc[e] = key0 + 8 * (e / 4) + 2 * t + (e & 1) < keys ? sc[e] * cs : -INFINITY;
  }
}

// The quad's four threads hold the same two rows.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// o[p] += P V over the first `steps` of the KS 16-key steps of P (A
// fragments, see pack_a), V read MN-major from panels of `v_panel` bytes.
template <int D, int KS>
__device__ __forceinline__ void add_pv(float (&o)[sm90::kPanels<D>][32], const uint32_t (&pa)[KS][4],
                                       const uint8_t* v, int v_panel, int steps) {
  sm90::wgmma_fence();
#pragma unroll
  for (int p = 0; p < sm90::kPanels<D>; ++p)
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k < steps) sm90::wgmma_rs(o[p], pa[k], sm90::desc_mn(v + p * v_panel + k * 16 * kRowBytes));
    }
  sm90::wgmma_commit();
  sm90::wgmma_wait();
#pragma unroll
  for (int p = 0; p < sm90::kPanels<D>; ++p) sm90::fence_regs(o[p]);
}

template <int M>
__device__ __forceinline__ void row_max(float (&m)[2], const float (&sc)[M]) {
#pragma unroll
  for (int e = 0; e < M; ++e) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], sc[e]);
}

// sc = exp2(sc - m) per row, added into l.
template <int M>
__device__ __forceinline__ void exp_rows(float (&sc)[M], const float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int e = 0; e < M; ++e) {
    sc[e] = exp2f(sc[e] - m[(e >> 1) & 1]);
    l[(e >> 1) & 1] += sc[e];
  }
}

template <int M>
__device__ __forceinline__ void scale_rows(float (&sc)[M], const float (&w)[2]) {
#pragma unroll
  for (int e = 0; e < M; ++e) sc[e] *= w[(e >> 1) & 1];
}

// o += weight * softmax(s) V for a resident branch, in one pass (see the
// header): S over its first 64 keys where kWide (more than 16 keys), and
// over a tail of 16 keys where kTail (keys 64-79, or all of at most 16).
// cs = scale*log2(e).
template <int D, bool kWide, bool kTail>
__device__ __forceinline__ void add_resident(float (&o)[sm90::kPanels<D>][32], const uint8_t* q,
                                             const uint8_t* smem, const Branch& br, float weight,
                                             float cs) {
  constexpr int kTail0 = kWide ? 64 : 0;  // the tail's first key
  const int panel = br.rows * kRowBytes;
  const uint8_t* k = smem + br.k_off;
  float sw[kWide ? 32 : 1], st[kTail ? 8 : 1];
  sm90::wgmma_fence();
  if constexpr (kWide) scores<D>(sw, q, k, panel);
  if constexpr (kTail) scores<D>(st, q, k + kTail0 * kRowBytes, panel);
  sm90::wgmma_commit();
  sm90::wgmma_wait();
  float m[2] = {-INFINITY, -INFINITY};
  if constexpr (kWide) {
    sm90::fence_regs(sw);
    scale_and_mask(sw, cs, 0, br.keys);
    row_max(m, sw);
  }
  if constexpr (kTail) {
    sm90::fence_regs(st);
    scale_and_mask(st, cs, kTail0, br.keys);
    row_max(m, st);
  }
  float l[2] = {0.f, 0.f}, w[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);  // finite: every row has a key
  if constexpr (kWide) exp_rows(sw, m, l);
  if constexpr (kTail) exp_rows(st, m, l);
#pragma unroll
  for (int r = 0; r < 2; ++r) w[r] = weight / quad_sum(l[r]);  // l >= 1: the max adds 1
  constexpr int kSteps = (kWide ? 4 : 0) + (kTail ? 1 : 0);
  uint32_t pa[kSteps][4];
  if constexpr (kWide) {
    scale_rows(sw, w);
#pragma unroll
    for (int s = 0; s < 4; ++s) sm90::pack_a(pa[s], sw, s);
  }
  if constexpr (kTail) {
    scale_rows(st, w);
    sm90::pack_a(pa[kSteps - 1], st, 0);
  }
  add_pv<D, kSteps>(o, pa, smem + br.v_off, panel, (br.keys + 15) / 16);
}

// The consumer's own load of 64-key chunk c of a streamed branch (K, and V
// if with_v) into the chunk buffer, and the wait for it. Every consumer
// thread calls it after the last reads of the buffer.
template <int D>
__device__ __forceinline__ void load_chunk(uint8_t* ck, const sm90::Map& km, const sm90::Map& vm,
                                           bool with_v, uint64_t* bar, uint32_t& phase, int c,
                                           int keys, int h, int b) {
  constexpr int kTile = sm90::kPanels<D> * kPanel;
  if (threadIdx.x == 0) {
    const int rows = min(64, keys - 64 * c);
    sm90::mbar_expect_tx(bar, (with_v ? 2 : 1) * sm90::kPanels<D> * round16(rows) * kRowBytes);
    load_keys<D>(ck, km, bar, h, b, 64 * c, rows, kPanel);
    if (with_v) load_keys<D>(ck + kTile, vm, bar, h, b, 64 * c, rows, kPanel);
  }
  sm90::mbar_wait(bar, phase);
  phase ^= 1;
}

// o += weight * softmax(s) V for a streamed branch: pass 1 walks the chunks
// for the row max and sum (online), pass 2 walks them again for P V.
template <int D>
__device__ __forceinline__ void add_streamed(float (&o)[sm90::kPanels<D>][32], const uint8_t* q,
                                             uint8_t* ck, const sm90::Map& km, const sm90::Map& vm,
                                             const Branch& br, float weight, float cs, uint64_t* bar,
                                             uint32_t& phase, int h, int b) {
  constexpr int kTile = sm90::kPanels<D> * kPanel;
  const int n_chunks = (br.keys + 63) / 64;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    load_chunk<D>(ck, km, vm, false, bar, phase, c, br.keys, h, b);
    float sc[32];
    sm90::wgmma_fence();
    scores<D>(sc, q, ck, kPanel);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(sc);
    sm90::named_bar(1, 128);  // the chunk buffer is free again
    scale_and_mask(sc, cs, 64 * c, br.keys);
    float mx[2] = {m[0], m[1]};
    row_max(mx, sc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);  // finite: the chunk has a key
      l[r] *= exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
    exp_rows(sc, m, l);
  }
  float w[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) w[r] = weight / quad_sum(l[r]);
  for (int c = 0; c < n_chunks; ++c) {
    load_chunk<D>(ck, km, vm, true, bar, phase, c, br.keys, h, b);
    float sc[32];
    sm90::wgmma_fence();
    scores<D>(sc, q, ck, kPanel);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(sc);
    scale_and_mask(sc, cs, 64 * c, br.keys);
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = exp2f(sc[e] - m[(e >> 1) & 1]) * w[(e >> 1) & 1];
    uint32_t pa[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) sm90::pack_a(pa[s], sc, s);
    add_pv<D, 4>(o, pa, ck + kTile, kPanel, (min(64, br.keys - 64 * c) + 15) / 16);
    sm90::named_bar(1, 128);  // the chunk buffer is free again
  }
}

template <int D>
__device__ __forceinline__ void add_branch(float (&o)[sm90::kPanels<D>][32], const uint8_t* q,
                                           uint8_t* smem, const CrossArgs& a, const Branch& br,
                                           float weight, const sm90::Map& km, const sm90::Map& vm,
                                           uint64_t* bar, uint32_t& phase, int h, int b) {
  if (!br.resident) {
    add_streamed<D>(o, q, smem + a.chunk_off, km, vm, br, weight, a.scale_log2, bar, phase, h, b);
  } else if (br.rows <= 16) {
    add_resident<D, false, true>(o, q, smem, br, weight, a.scale_log2);
  } else if (br.rows <= 64) {
    add_resident<D, true, false>(o, q, smem, br, weight, a.scale_log2);
  } else {
    add_resident<D, true, true>(o, q, smem, br, weight, a.scale_log2);
  }
}

// Blocks an SM should hold at D: up to D = 64 (one O panel) three, which
// caps a thread at 136 registers.
template <int D>
constexpr int kMinBlocks = D <= 64 ? 3 : 1;

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
cross_attn_wgmma_kernel(const __grid_constant__ CrossMaps maps, const __grid_constant__ CrossArgs a) {
  constexpr int kP = sm90::kPanels<D>;
  constexpr int kTile = kP * kPanel;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (sm90::kSmemAlign - sm90::smem_u32(smem_raw) % sm90::kSmemAlign) %
                                 sm90::kSmemAlign;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.bar_off);
  uint64_t* empty = full + kMaxStages;
  uint64_t* kvbar = empty + kMaxStages;  // the resident K and V
  uint64_t* chunkbar = kvbar + 1;        // the streamed chunks
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const bool has_ip = a.ip.keys > 0;
  const bool resident = a.text.resident || (has_ip && a.ip.resident);

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::mbar_init(kvbar, 1);
    sm90::mbar_init(chunkbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer: the resident K and V once, then the Q tiles ----
    if (threadIdx.x % 32 == 0) {
      if (resident) {
        const int ip_rows = has_ip && a.ip.resident ? a.ip.rows : 0;
        sm90::mbar_expect_tx(kvbar, 2 * kP * ((a.text.resident ? a.text.rows : 0) + ip_rows) *
                                        kRowBytes);
        if (a.text.resident) {
          const int panel = a.text.rows * kRowBytes;
          load_keys<D>(smem + a.text.k_off, maps.k, kvbar, h, b, 0, a.text.keys, panel);
          load_keys<D>(smem + a.text.v_off, maps.v, kvbar, h, b, 0, a.text.keys, panel);
        }
        if (has_ip && a.ip.resident) {
          const int panel = a.ip.rows * kRowBytes;
          load_keys<D>(smem + a.ip.k_off, maps.k_ip, kvbar, h, b, 0, a.ip.keys, panel);
          load_keys<D>(smem + a.ip.v_off, maps.v_ip, kvbar, h, b, 0, a.ip.keys, panel);
        }
      }
      int i = 0;
      for (int j = blockIdx.x; j < a.n_tiles; j += gridDim.x, ++i) {
        const int s = i % a.stages;
        if (i >= a.stages) sm90::mbar_wait(&empty[s], (i / a.stages - 1) & 1);
        uint8_t* st = smem + a.q_off + s * kTile;
        sm90::mbar_expect_tx(&full[s], kTile);
        for (int p = 0; p < kP; ++p) {
          sm90::tma_load(st + p * kPanel, maps.q, &full[s], p * kPanelCols, h, j * kRows, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: one query tile after another ----
  const float ip_weight = has_ip ? *a.ip_scale : 0.f;
  if (resident) sm90::mbar_wait(kvbar, 0);
  uint32_t chunk_phase = 0;
  int i = 0;
  for (int j = blockIdx.x; j < a.n_tiles; j += gridDim.x, ++i) {
    const int s = i % a.stages;
    sm90::mbar_wait(&full[s], (i / a.stages) & 1);
    uint8_t* st = smem + a.q_off + s * kTile;
    float o[kP][32];
#pragma unroll
    for (int p = 0; p < kP; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[p][e] = 0.f;
#pragma unroll 1
    for (int bi = 0; bi < (has_ip ? 2 : 1); ++bi) {  // the text branch, then the IP one
      add_branch<D>(o, st, smem, a, bi ? a.ip : a.text, bi ? ip_weight : 1.f,
                    bi ? maps.k_ip : maps.k,
                    bi ? maps.v_ip : maps.v, chunkbar, chunk_phase, h, b);
    }

    // ---- the output through this tile's stage, by TMA store ----
    sm90::named_bar(1, 128);  // every warp's last product has read the Q tile
    const float one[2] = {1.f, 1.f};
#pragma unroll
    for (int p = 0; p < kP; ++p) sm90::store_acc(st + p * kPanel, o[p], 0, one);
    sm90::fence_async_shared();
    sm90::named_bar(1, 128);
    if (threadIdx.x == 0) {
      for (int p = 0; p < kP; ++p) {
        sm90::tma_store(maps.o, st + p * kPanel, p * kPanelCols, h, j * kRows, b);
      }
      sm90::tma_store_commit();
      if (i > 0) {
        // the previous tile's store has read its stage: the producer may refill it
        sm90::tma_store_wait_read<1>();
        sm90::mbar_arrive(&empty[(i - 1) % a.stages]);
      }
    }
  }
  if (threadIdx.x == 0) sm90::tma_store_wait_read<0>();
}

// Where everything of a launch lies in shared memory: the resident branches
// first (each K buffer is then followed by at least 4 KB, which its 64-key
// reads past the loaded rows may touch), the chunk buffer if a branch is
// streamed, the stages, the barriers. A branch of at most 80 keys is
// resident, the stages as many as fit (at least 2); where even 2 do not fit
// at 227 KB, the IP branch and then the text branch are streamed instead.
// Returns the bytes to ask for, or 0.
template <int D>
int plan(CrossArgs* a, int sk, int sk_ip) {
  constexpr int kTile = sm90::kPanels<D> * kPanel;
  const bool fits[3][2] = {{sk <= kMaxResident, sk_ip <= kMaxResident},
                           {sk <= kMaxResident, false},
                           {false, false}};
  for (const auto& f : fits)
    for (int stages = kMaxStages; stages >= 2; --stages) {
      int off = 0;
      bool streamed = false;
      for (Branch* br : {&a->text, &a->ip}) {
        const bool text = br == &a->text;
        br->resident = br->keys > 0 && (text ? f[0] : f[1]);
        if (br->resident) {
          br->rows = round16(br->keys);
          br->k_off = off;
          br->v_off = off + sm90::kPanels<D> * br->rows * kRowBytes;
          off = br->v_off + sm90::kPanels<D> * br->rows * kRowBytes;
        }
        streamed = streamed || (br->keys > 0 && !br->resident);
      }
      a->chunk_off = off;
      off += streamed ? 2 * kTile : 0;
      a->q_off = off;
      off += stages * kTile;
      a->bar_off = off;
      off += (2 * kMaxStages + 2) * 8;
      const int bytes = off + sm90::kSmemAlign;
      if (bytes <= kSmemLimit) {
        a->stages = stages;
        return bytes;
      }
    }
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* k_ip, const void* v_ip,
           void* o, int batch, int sq, int sk, int sk_ip, int heads, const long long (&st)[6][3],
           float scale_log2, const float* ip_scale, cudaStream_t stream) {
  CrossArgs a{};
  a.text.keys = sk;
  a.ip.keys = sk_ip;
  a.ip_scale = ip_scale;
  a.n_tiles = (sq + kRows - 1) / kRows;
  a.scale_log2 = scale_log2;
  const int bytes = plan<D>(&a, sk, sk_ip);
  if (bytes == 0) return (int)cudaErrorInvalidValue;

  CrossMaps maps{};
  auto map = [&](sm90::Map* m, const void* base, int rows, int i, int box) {
    return sm90::make_map(m, base, D, heads, rows, batch, st[i][0], st[i][1], st[i][2], box);
  };
  if (!map(&maps.q, q, sq, 0, kRows) || !map(&maps.k, k, sk, 1, kKeyBox) ||
      !map(&maps.v, v, sk, 2, kKeyBox) || !map(&maps.o, o, sq, 5, kRows) ||
      (sk_ip > 0 && (!map(&maps.k_ip, k_ip, sk_ip, 3, kKeyBox) ||
                     !map(&maps.v_ip, v_ip, sk_ip, 4, kKeyBox)))) {
    return (int)cudaErrorInvalidPitchValue;
  }

  const void* kernel = reinterpret_cast<const void*>(cross_attn_wgmma_kernel<D>);
  static sm90::PerDevice smem_set, regs;  // per device: the attribute, the registers a thread
  cudaError_t err = sm90::allow_smem(kernel, kSmemLimit, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int dev = sm90::current_device();
  int r = regs.get(dev);
  if (r == 0) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return (int)err;
    r = fa.numRegs;
    regs.put(dev, r);
  }
  // CTAs an SM holds at once, by shared memory (1 KB of it reserved per
  // block) and by registers (allocated 8 at a time per thread)
  const int per_sm =
      std::max(1, std::min(kSmemPerSm / (bytes + 1024), 65536 / (kThreads * ((r + 7) / 8 * 8))));
  // as many CTAs as fit at once, but no second, partial wave
  const long long pairs = (long long)batch * heads;
  const long long fit = (long long)sm90::sm_count() * per_sm / pairs;
  const int splits = (int)std::max(1LL, std::min<long long>(fit, a.n_tiles));
  cross_attn_wgmma_kernel<D><<<dim3(splits, heads, batch), kThreads, bytes, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Strides are in elements, three
// per operand (batch, head, row); unit stride along D. k_ip and v_ip are
// null with sk_ip = 0 for the text branch alone; ip_scale points to one
// fp32 on the launch's device (read by the kernel, null without the IP
// branch). Every base address and
// stride must be a multiple of 16 bytes (the TMA's rule). Returns
// cudaGetLastError() after the launch (0 on success); an operand whose
// tensor map cuTensorMapEncodeTiled refuses returns
// cudaErrorInvalidPitchValue, an unsupported head_dim or an empty or
// inconsistent shape cudaErrorInvalidValue, both without launching.
extern "C" int cross_attn_nhd_bf16(
    const void* q, const void* k, const void* v, const void* k_ip, const void* v_ip, void* o,
    int batch, int sq, int sk, int sk_ip, int heads, int head_dim,
    long long q_batch, long long q_head, long long q_row,
    long long k_batch, long long k_head, long long k_row,
    long long v_batch, long long v_head, long long v_row,
    long long kip_batch, long long kip_head, long long kip_row,
    long long vip_batch, long long vip_head, long long vip_row,
    long long o_batch, long long o_head, long long o_row,
    float scale_log2, const float* ip_scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || heads > 65535 || batch > 65535 ||
      sk_ip < 0 || (sk_ip > 0) != (k_ip != nullptr && v_ip != nullptr) ||
      (sk_ip > 0 && ip_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long st[6][3] = {{q_batch, q_head, q_row},       {k_batch, k_head, k_row},
                              {v_batch, v_head, v_row},       {kip_batch, kip_head, kip_row},
                              {vip_batch, vip_head, vip_row}, {o_batch, o_head, o_row}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_LAUNCH(D) \
  return launch<D>(q, k, v, k_ip, v_ip, o, batch, sq, sk, sk_ip, heads, st, scale_log2, ip_scale, s)
  switch (head_dim) {
    case 32: K2_LAUNCH(32);
    case 40: K2_LAUNCH(40);
    case 64: K2_LAUNCH(64);
    case 80: K2_LAUNCH(80);
    case 128: K2_LAUNCH(128);
    case 160: K2_LAUNCH(160);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2_LAUNCH
}
