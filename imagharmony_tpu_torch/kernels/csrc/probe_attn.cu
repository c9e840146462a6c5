// P2-P6: the attention probes' softmax recipes, bf16 in and out, written for
// Hopper (sm_90a), one device kernel (`attn_nomax_wgmma_kernel`) with the
// recipe as a template parameter. On the packed (B, S, H*D) layout, per
// head, P2-P4's recipe (kClampF32):
//
//   qs = bf16(q * scale * log2(e)),  e = exp2(min(qs k^T, clamp)) in fp32,
//   out = (sum_j bf16(e_j) v_j) / (sum_j e_j)
//
// with no running max and no rescale: the logits are clamped instead, so a
// key tile only adds to O and to the row sum. Keys at or past `kv_len`
// score -inf (exp2 gives 0). It replaces the TPU kernels
//   * P2 `_kblock_kernel` (tools/probe_attn_kblock.py:33), reached through
//     `kblock_attn` (:64, call :72): query blocks of bq rows, key blocks of
//     kb keys;
//   * P3 `_batchpack_kernel` (tools/probe_attn_kblock.py:89), through
//     `batchpack_attn` (:116, call :124): every batch row in one grid step;
//   * P4 `_attn_nhd_kernel` (imagharmony_tpu/kernels/flash_attention.py:415)
//     as `nhd_with_g` (tools/probe_attn_lanegroup.py:26, call :34) launches
//     it: G/D heads in one grid step, keys past kv_len masked;
//   * P5 `_kernel_variant` (tools/probe_softmax_nomax.py:32, through
//     `run_variant` :76, call :89) and P6 `_kernel_v`
//     (tools/probe_softmax_tricks.py:41, through `run_variant` :84, call
//     :89): the other recipes below, at the default tile.
// The first three compute one function. Here a work item is 64 * NWG
// query rows (bq) of a list of (batch, head) units, walked with BN keys a
// tile (kb): one unit for P2, P5 and P6, every batch row of one head for P3,
// G/D heads of one batch row for P4. A unit's arithmetic depends neither on
// the list nor on the CTA or warpgroup that walks it, so at the same (BN,
// recipe) the schedules and both bq give the same bits.
//
// The recipes (enum Recipe), what P5 and P6 measure on the TPU: whether the
// max pass, the sum pass and the scale multiply are worth removing. The TPU
// kernels hold a whole key row in a grid step; a CTA here cannot (K of 4096
// keys at d = 64 is 512 KB against 227 KB of shared memory), so the keys
// stream and the recipes compute the same functions this way:
//   * max-subtract (kMaxExp2, kMaxExp2Ones, kMaxExp): K1's running max, its
//     quad shuffles and the rescale of O and of the row sum by
//     exp2(m_old - m_new) in fp32; the exp argument bf16(s - m_running).
//   * a bf16 argument: x rounded to bf16 before the exp, e rounded to bf16
//     after it, and the row sum over the rounded e. Two elements of a row
//     are rounded by one conversion (cvt.rn.bf16x2.f32), and the rounded e
//     pair is the PV product's A fragment as it is: a conversion an element
//     in all, against half of one for the fp32 argument.
//   * natural exp (kMaxExp, kNormFirst): e = exp2(x * log2(e)), one
//     multiply before the MUFU op; the scale folded into Q has no log2(e).
//   * the ones column (the *Ones recipes): a constant panel of bf16 ones in
//     shared memory, one m64n8k16 product a 16-key step beside PV; every
//     column of that accumulator is the row sum of bf16(e), so no register
//     sum is kept.
//   * kNormFirst (P6 v0): Q is not scaled, the fp32 logits are multiplied by
//     the scale; a statistics pass over the K tiles alone keeps the running
//     max and the rescaled sum of bf16(e), then the PV pass recomputes S with
//     the row's final max and multiplies each bf16 e by bf16(1 / sum) before
//     the product: the second QK^T is what normalising first costs here.
//
// What bounds it on an H100: the tensor cores and the exponentials alike.
// A score costs 4 D FLOP of QK^T and PV; an SM's tensor cores do 4096 bf16
// FLOP a clock (989 TFLOP/s over 132 SMs at 1.83 GHz), 16 scores a clock at
// D = 64, and its MUFU unit gives 16 exp2 a clock. At (2, 4096, 10, 64) the
// 86 GFLOP of products take 0.087 ms at 989 TFLOP/s, and the 335.5 M exp2
// take 0.087 ms as well (at D = 32 twice the products' time, at D = 128
// half); 42 MB of operands are far below either. Run one after the other,
// the two floors add up (0.174 ms); run under each other, the larger is the
// floor. The no-max recipe suits the overlap: no row max has to be reduced
// before an element's exp2 can start. (kNormFirst's statistics pass adds a
// third of the products and a second round of exp2.)
//
// The clamp is the TPU kernels': exact whenever the row's largest scaled
// logit is below it, saturating above it (115 for P2-P4, 80 log2(e) for
// P5). O and the row sum are not protected against overflow: 4096 keys at
// the clamp reach 2^127 (2^127.42) in the sum and Σ e v overflows fp32 once
// |v| >= 2, as in the TPU kernels.
//
// Design, to put the exponentials under the products:
//   * warp-specialized: a CTA is 384 threads, two consumer warpgroups
//     (threads 0-255) and a producer warpgroup whose first thread, or first
//     two (one a ring), issue every TMA load. setmaxnreg moves registers
//     from the producer (kProducerRegs) to the consumers (kConsumerRegs), so
//     a consumer thread holds the S tile (64 fp32 at 128 keys), the A
//     fragments of PV, O and the sums while products are in flight. The
//     roles part in one if/else at the top and never meet again.
//   * bq 128 (NWG = 2): a work item is 128 query rows, the two consumer
//     warpgroups take 64 each and share one ring. bq 64 (NWG = 1): a work
//     item is 64 rows, and each consumer warpgroup walks its own items
//     through a ring of its own (two independent streams on an SM).
//   * a ring: two Q buffers and kStages stages of K and of V, K and V on
//     full/empty mbarriers of their own, so a tile's QK^T starts as soon as
//     its K has landed, whatever its V does. A consumer warp releases a K
//     stage once the QK^T that read it is done, a V stage once PV is.
//   * exp2 under the products, within a warpgroup: it issues tile j+1's
//     QK^T and tile j's PV as two product groups, waits for the first only
//     (wgmma.wait_group 1) and runs tile j+1's clamp, exp2, sums and bf16
//     rounding while PV runs, then the second wait and O's rescale (the
//     max-subtract recipes). The two consumer warpgroups run unsynchronised,
//     so one's exponentials also run under the other's products (making
//     them take turns, ping-pong, measured slower). Two things keep the
//     overlap in the SASS, where ptxas places the second wait before the
//     first instruction that touches a register of PV in flight: the A
//     fragments alternate between two buffers (p0, p1), so tile j+1's e
//     never lands in registers PV (j) reads; and the last tile's mask is a
//     compile-time flag of its own step, since ptxas retires every product
//     at a branch between the two waits. exp2 is ex2.approx.ftz
//     (exp2_ftz, below).
//   * S of 128 keys is one m64n128k16 product a 16-column step (two
//     m64n64k16 read K twice as often from shared memory for the same work;
//     measured level with it).
//   * persistent: at most one CTA an SM, each walking the items
//     c + i * grid of a static order with the query tile fastest (the
//     CTAs of a round share K and V in L2); the rings' stages and phases and
//     the Q double buffer run on across items and units, so the producer
//     loads the next unit's Q and K while the consumers finish and store. A
//     Q buffer is released (an mbarrier of NWG arrivals) once its
//     warpgroups' output stores, which go out through it, have read it.
//     P3's and P4's items hold two or more units, so their last round is
//     as long as the units it holds: a unit is the tail's grain.
//   * C7515/C7511: each unit's first PV writes O (and the ones recipes'
//     sums) with scale-d 0, and every accumulator and A fragment is touched
//     only after the wait that retires its product (fence_regs after it).
//   * key tiles entirely at or past kv_len are not loaded (the TPU kernel
//     skips them too); the last one is masked in registers, which also
//     covers the zeros TMA fills in past Sk.
//   * instances: kClampF32 at D = 32, 64 with BN = 64 or 128 and D = 128
//     with BN = 64, NWG = 1 or 2; every other recipe at the default tile
//     only (NWG = 2, BN = 128, 64 at D = 128), since the TPU tools that run
//     them have no tile knob.

#include <algorithm>
#include <climits>
#include <type_traits>

#include "sm90_tiles.cuh"

namespace {

using sm90::kPanelCols;
using sm90::kRowBytes;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumers = 256;             // threads 0-255: two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// 128 * 40 + 256 * 232 = 168 * 384, the count __launch_bounds__(384, 1) gives
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take
constexpr int kMaxStages = 3;  // K and V stages a ring (fewer where shared memory ends)

static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 168 * kThreads,
              "the warpgroups ask for more registers than the block holds");

// How a recipe turns a tile's logits s into the e of the PV product and of
// the row sum (the C entry point's `recipe`; RECIPES in
// kernels/probe_softmax.py).
enum Recipe : int {
  kClampF32 = 0,       // e = exp2(min(s, clamp)), the fp32 e summed (P2-P4; P5 "fp32")
  kMaxExp2 = 1,        // e = bf16(exp2(bf16(s - m))), m the row max (P5 base, P6 v2)
  kMaxExp2Ones = 2,    // kMaxExp2, the sum from the ones column
  kClampBf16 = 3,      // e = bf16(exp2(bf16(min(s, clamp)))) (P5 no_max=True)
  kClampBf16Ones = 4,  // kClampBf16, the sum from the ones column
  kClampF32Ones = 5,   // kClampF32, the sum of bf16(e) from the ones column
  kMaxExp = 6,         // e = bf16(exp(bf16(s - m))), s in natural units (P6 v1)
  kNormFirst = 7,      // P6 v0: s = (q k^T) scale, e as kMaxExp, PV of bf16(e bf16(1 / sum))
};

template <int R>
struct Traits {
  static constexpr bool max_sub =
      R == kMaxExp2 || R == kMaxExp2Ones || R == kMaxExp || R == kNormFirst;
  static constexpr bool bf16_arg = R != kClampF32 && R != kClampF32Ones;
  static constexpr bool ones = R == kMaxExp2Ones || R == kClampBf16Ones || R == kClampF32Ones;
  static constexpr bool natural = R == kMaxExp || R == kNormFirst;
  static constexpr bool norm_first = R == kNormFirst;
};

// Two floats rounded to bf16 by one conversion (cvt.rn.bf16x2.f32).
__device__ __forceinline__ __nv_bfloat162 bf16_pair(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x on the MUFU unit alone (ex2.approx.ftz.f32): exp2f's result wherever
// that is 2^-126 or more, and 0 below it, as in the TPU kernels, whose f32
// arithmetic flushes subnormals to zero. So a clamp recipe's row whose
// logits all lie below -126 sums to 0 here and there, and its output is
// 0 / 0 = NaN (the plain versions keep subnormals and give finite values).
// exp2f keeps the subnormal at three more instructions an element (a
// compare and two multiplies around the same MUFU op), which the consumers'
// instruction issue, already close to the MUFU and tensor floors, cannot
// hide.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct NomaxMaps {
  sm90::Map q, k, v, o;
};

struct NomaxArgs {
  int kv_len, heads_per_cta, batch_per_cta;
  int q_tiles, head_groups, items;  // items: q_tiles * head_groups * batch groups
  float scale_q;  // Q's rows times this, rounded to bf16 (every recipe but kNormFirst)
  float scale_s;  // kNormFirst: the fp32 logits times this
  float clamp;    // the clamp recipes' bound on the exp2 argument
};

// An instance's shape: its rings and, in bytes from a 1024-aligned base,
// its shared memory: each ring's two Q tiles (NWG * 64 rows) and kStages
// stages of K and of V (BN rows), the ones panel (8 rows of 64 bf16 ones,
// the ones recipes only), then the barriers: each ring's K full, V full, K
// empty and V empty a stage, Q full and Q empty a buffer.
template <int D, int NWG, int BN, int R>
struct Nomax {
  using T = Traits<R>;
  static constexpr int kP = sm90::kPanels<D>;
  static constexpr int kRings = 2 / NWG;  // bq 128: one both warpgroups share; bq 64: one each
  static constexpr int kQPanel = NWG * 64 * kRowBytes;
  static constexpr int kKVPanel = BN * kRowBytes;
  static constexpr int kQ = kP * kQPanel;
  static constexpr int kKV = kP * kKVPanel;
  static constexpr int kOnes = T::ones ? 8 * kRowBytes : 0;
  static constexpr int kBarsMax = kRings * (4 * kMaxStages + 4) * 8;
  static constexpr int kStages =
      std::min(kMaxStages,
               ((kSmemMax - sm90::kSmemAlign - kOnes - kBarsMax) / kRings - 2 * kQ) / (2 * kKV));
  static constexpr int kRingBytes = 2 * kQ + 2 * kStages * kKV;  // 1024-aligned: kQ, kKV are
  static constexpr int kRingBars = 4 * kStages + 4;
  static constexpr int kOnesOff = kRings * kRingBytes;
  static constexpr int kBars = kOnesOff + kOnes;
  static constexpr int kBytes = kBars + kRings * kRingBars * 8 + sm90::kSmemAlign;
  static_assert(kStages >= 2 && kBytes <= kSmemMax, "the rings do not fit in shared memory");
};

// One unit of a work item: its head, batch row and first query row.
struct Unit {
  int h, b, m0;
};

// The units ring `ring` of this CTA walks, in order: the items
// kRings * blockIdx.x + ring, then kRings * gridDim.x further each (the
// query tile fastest, then the head group, then the batch group), each
// item's units (heads fastest). The producer and the consumers of a ring
// each run one and get the same units.
template <int NWG>
struct Walk {
  static constexpr int kRings = 2 / NWG;
  const int items, q_tiles, head_groups, heads_per_cta, units;
  int item, u;

  __device__ Walk(const NomaxArgs& a, int ring)
      : items(a.items),
        q_tiles(a.q_tiles),
        head_groups(a.head_groups),
        heads_per_cta(a.heads_per_cta),
        units(a.heads_per_cta * a.batch_per_cta),
        item(kRings * blockIdx.x + ring),
        u(0) {}

  __device__ bool next(Unit& un) {
    if (item >= items) return false;
    const int rest = item / q_tiles;
    un.m0 = (item % q_tiles) * NWG * 64;
    un.h = rest % head_groups * heads_per_cta + u % heads_per_cta;
    un.b = rest / head_groups * (units / heads_per_cta) + u / heads_per_cta;
    if (++u == units) {
      u = 0;
      item += kRings * gridDim.x;
    }
    return true;
  }
};

// A ring's place in shared memory.
template <class C>
struct Ring {
  uint8_t* base;
  uint64_t* bars;

  __device__ Ring(uint8_t* smem, int ring)
      : base(smem + ring * C::kRingBytes),
        bars(reinterpret_cast<uint64_t*>(smem + C::kBars) + ring * C::kRingBars) {}
  __device__ uint8_t* q(int buf) const { return base + buf * C::kQ; }
  __device__ uint8_t* k(int s) const { return base + 2 * C::kQ + s * C::kKV; }
  __device__ uint8_t* v(int s) const { return base + 2 * C::kQ + (C::kStages + s) * C::kKV; }
  __device__ uint64_t* kfull(int s) const { return bars + s; }
  __device__ uint64_t* vfull(int s) const { return bars + C::kStages + s; }
  __device__ uint64_t* kempty(int s) const { return bars + 2 * C::kStages + s; }
  __device__ uint64_t* vempty(int s) const { return bars + 3 * C::kStages + s; }
  __device__ uint64_t* qfull(int buf) const { return bars + 4 * C::kStages + buf; }
  __device__ uint64_t* qempty(int buf) const { return bars + 4 * C::kStages + 2 + buf; }
};

// ---- producer: one thread a ring; per unit its Q tile, then its K and V
// tiles (K alone for kNormFirst's statistics pass), each stage reused once
// the consumers have released it ----
template <int D, int NWG, int BN, int R>
__device__ __forceinline__ void produce(const NomaxMaps& maps, const NomaxArgs& a, uint8_t* smem,
                                        int ring) {
  using C = Nomax<D, NWG, BN, R>;
  constexpr int S = C::kStages;
  constexpr int kPasses = C::T::norm_first ? 2 : 1;
  const Ring<C> rg(smem, ring);
  const int n_tiles = (a.kv_len + BN - 1) / BN;
  Walk<NWG> walk(a, ring);
  Unit un;
  int n = 0, kc = 0, vc = 0;  // units, K tiles and V tiles through the ring so far
  while (walk.next(un)) {
    const int qb = n & 1;
    if (n >= 2) sm90::mbar_wait(rg.qempty(qb), ((n >> 1) - 1) & 1);
    ++n;
    sm90::mbar_expect_tx(rg.qfull(qb), C::kQ);
    for (int p = 0; p < C::kP; ++p) {
      sm90::tma_load(rg.q(qb) + p * C::kQPanel, maps.q, rg.qfull(qb), p * kPanelCols, un.h, un.m0,
                     un.b);
    }
    for (int pass = 0; pass < kPasses; ++pass) {
      const bool with_v = pass == kPasses - 1;
      for (int j = 0; j < n_tiles; ++j) {
        int s = kc % S;
        if (kc >= S) sm90::mbar_wait(rg.kempty(s), (kc / S - 1) & 1);
        ++kc;
        sm90::mbar_expect_tx(rg.kfull(s), C::kKV);
        for (int p = 0; p < C::kP; ++p) {
          sm90::tma_load(rg.k(s) + p * C::kKVPanel, maps.k, rg.kfull(s), p * kPanelCols, un.h,
                         j * BN, un.b);
        }
        if (!with_v) continue;
        s = vc % S;
        if (vc >= S) sm90::mbar_wait(rg.vempty(s), (vc / S - 1) & 1);
        ++vc;
        sm90::mbar_expect_tx(rg.vfull(s), C::kKV);
        for (int p = 0; p < C::kP; ++p) {
          sm90::tma_load(rg.v(s) + p * C::kKVPanel, maps.v, rg.vfull(s), p * kPanelCols, un.h,
                         j * BN, un.b);
        }
      }
    }
  }
}

// ---- consumer warpgroup wg: 64 query rows of each unit its ring walks ----
template <int D, int NWG, int BN, int R>
__device__ __forceinline__ void consume(const NomaxMaps& maps, const NomaxArgs& a,
                                        uint8_t* smem) {
  using C = Nomax<D, NWG, BN, R>;
  using T = typename C::T;
  constexpr int kP = C::kP;
  constexpr int S = C::kStages;
  constexpr int kChunks = kP * kPanelCols / 8;  // 16-byte chunks a row
  const int wg = threadIdx.x / 128;
  const int ring = NWG == 2 ? 0 : wg;
  const int row0 = NWG == 2 ? 64 * wg : 0;  // this warpgroup's rows of a Q tile
  const int tid = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const bool lead = lane == 0;  // arrives for its warp
  const Ring<C> rg(smem, ring);
  const uint64_t ones_desc = sm90::desc_k(smem + C::kOnesOff);
  const int kv_len = a.kv_len;
  const float scale_q = a.scale_q, scale_s = a.scale_s, clamp = a.clamp;
  const int n_tiles = (kv_len + BN - 1) / BN;
  Walk<NWG> walk(a, ring);
  Unit un;
  int n = 0, kc = 0, vc = 0;  // as the producer's
  auto wait_k = [&]() { sm90::mbar_wait(rg.kfull(kc % S), (kc / S) & 1); };
  auto wait_v = [&]() { sm90::mbar_wait(rg.vfull(vc % S), (vc / S) & 1); };
  auto release_k = [&]() {
    if (lead) sm90::mbar_arrive(rg.kempty(kc % S));
    __syncwarp();
    ++kc;
  };
  auto release_v = [&]() {
    if (lead) sm90::mbar_arrive(rg.vempty(vc % S));
    __syncwarp();
    ++vc;
  };

  while (walk.next(un)) {
    const int qb = n & 1;
    uint8_t* sQ = rg.q(qb);
    sm90::mbar_wait(rg.qfull(qb), (n >> 1) & 1);
    ++n;
    if constexpr (!T::norm_first) {
      // scale this warpgroup's Q rows by scale_q, rounded to bf16
      for (int i = tid; i < 64 * kChunks; i += 128) {
        const int row = row0 + i / kChunks;
        const int col = (i % kChunks) * 8;
        uint4* ptr = reinterpret_cast<uint4*>(sQ + (col / kPanelCols) * C::kQPanel +
                                              sm90::swz(row, col % kPanelCols));
        uint4 val = *ptr;
        uint32_t* w = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
          w[e] = sm90::pack_bf16x2(__low2float(x) * scale_q, __high2float(x) * scale_q);
        }
        *ptr = val;
      }
      sm90::fence_async_shared();
      sm90::named_bar(1 + wg, 128);
    }
    const uint8_t* q_rows = sQ + row0 * kRowBytes;

    // rows g and g + 8 of this thread's warp slice: the running max (the
    // max-subtract recipes; the quad's four threads hold the same) and this
    // thread's part of the row sum (its quad's four parts add up at the end)
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    // S of one key tile (the accumulator layout, key 8 (E / 4) + 2 t +
    // (E & 1) of the tile); the A fragments of two tiles' PV, in turn (the
    // bf16 e of the pair (E, E + 1) is entry (E % 8) / 2 of contraction step
    // E / 8): the exponentials of tile j + 1 write one while PV (j) reads
    // the other, so ptxas need not retire PV (j) before them; O; the ones
    // recipes' row sums (rows g, g + 8)
    float sc[BN / 2];
    uint32_t p0[BN / 16][4], p1[BN / 16][4];
    float o[kP][32];
    float rows[4];

    // S = Q K^T of the tile at sK, one product group
    auto issue_s = [&](const uint8_t* sK) {
#pragma unroll
      for (int k = 0; k < sm90::kSteps<D>; ++k) {
        const int off = (k % 4) * 32;
        const uint64_t dq = sm90::desc_k(q_rows + (k / 4) * C::kQPanel + off);
        sm90::wgmma_ss(sc, dq, sm90::desc_k(sK + (k / 4) * C::kKVPanel + off), k > 0);
      }
      sm90::wgmma_commit();
    };
    // O += bf16(e) V (e from registers, V MN-major from the tile at sV),
    // the ones recipes' row sums beside it, one product group; the unit's
    // first writes O and the sums
    auto issue_pv = [&](const uint8_t* sV, const uint32_t (&pa)[BN / 16][4], bool first) {
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int k = 0; k < BN / 16; ++k) {
          sm90::wgmma_rs(o[p], pa[k], sm90::desc_mn(sV + p * C::kKVPanel + k * 16 * kRowBytes),
                         !first || k > 0);
        }
      if constexpr (T::ones) {
#pragma unroll
        for (int k = 0; k < BN / 16; ++k) sm90::wgmma_rs_n8(rows, pa[k], ones_desc, !first || k > 0);
      }
      sm90::wgmma_commit();
    };
    // after the wait that retires a PV group that read pa
    auto fence_pv = [&](uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
      for (int p = 0; p < kP; ++p) sm90::fence_regs(o[p]);
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) sm90::fence_regs(pa[k]);
      if constexpr (T::ones) sm90::fence_regs(rows);
    };
    // S of key tile j in log2 units (kNormFirst: natural, scaled), with
    // `last` (std::true_type: the last tile) keys at or past kv_len at -inf.
    // The flag is a type so that the tile loop below has no branch between
    // its two waits: ptxas retires every product at such a branch.
    auto logits = [&](int j, auto last) {
      if constexpr (T::norm_first) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sc[e] *= scale_s;
      }
      if constexpr (decltype(last)::value) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int key = j * BN + 8 * (e / 4) + 2 * t + (e & 1);
          if (key >= kv_len) sc[e] = -INFINITY;
        }
      }
    };
    // the same, the flag from j (no product in flight)
    auto logits_of = [&](int j) {
      if (j == n_tiles - 1) {
        logits(j, std::true_type{});
      } else {
        logits(j, std::false_type{});
      }
    };
    // the running max taken over the tile: the max to subtract (0 while a
    // row has no key: exp(-inf - 0) = 0, no NaN) and the factor the earlier
    // tiles' sums are rescaled by
    auto take_max = [&](float (&base)[2], float (&alpha)[2]) {
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        const float d = m_run[r] - base[r];
        alpha[r] = exp2_ftz(T::natural ? d * kLog2e : d);
        m_run[r] = mx[r];
      }
    };
    // e of the bf16-argument recipes for two logits of one row (elements E
    // and E + 1), `base` the max to subtract: the arguments rounded to bf16
    // by one conversion, the recipe's exp, and the two e rounded to bf16 by
    // another, which the PV product takes as they are
    auto exp_pair = [&](float s0, float s1, float base) {
      const __nv_bfloat162 x = T::max_sub ? bf16_pair(s0 - base, s1 - base)
                                          : bf16_pair(fminf(s0, clamp), fminf(s1, clamp));
      float x0 = __low2float(x), x1 = __high2float(x);
      if constexpr (T::natural) {
        x0 *= kLog2e;
        x1 *= kLog2e;
      }
      return bf16_pair(exp2_ftz(x0), exp2_ftz(x1));
    };

    // ---- kNormFirst's statistics pass: the row max and the sum of bf16(e)
    // over every key, then bf16(1 / sum) ----
    float norm[2] = {1.f, 1.f};
    if constexpr (T::norm_first) {
      for (int j = 0; j < n_tiles; ++j) {
        wait_k();
        sm90::wgmma_fence();
        issue_s(rg.k(kc % S));
        sm90::wgmma_wait();
        sm90::fence_regs(sc);
        release_k();
        logits_of(j);
        float base[2], alpha[2];
        take_max(base, alpha);
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] *= alpha[r];
#pragma unroll
        for (int e = 0; e < BN / 2; e += 2) {
          const int r = (e >> 1) & 1;
          const __nv_bfloat162 pr = exp_pair(sc[e], sc[e + 1], base[r]);
          l_run[r] += __low2float(pr);
          l_run[r] += __high2float(pr);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        norm[r] = __bfloat162float(__float2bfloat16_rn(1.f / l_run[r]));
      }
    }

    // the tile's e as PV's A fragments pa, and its share of the row sum;
    // alpha: the factor O and the ones sums are rescaled by (the
    // max-subtract recipes but kNormFirst)
    auto softmax = [&](uint32_t (&pa)[BN / 16][4], float (&alpha)[2]) {
      float base[2] = {0.f, 0.f};
      if constexpr (T::norm_first) {
#pragma unroll
        for (int r = 0; r < 2; ++r) base[r] = m_run[r] == -INFINITY ? 0.f : m_run[r];
      } else if constexpr (T::max_sub) {
        take_max(base, alpha);
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int e = 0; e < BN / 2; e += 2) {
        const int r = (e >> 1) & 1;
        uint32_t& a_pair = pa[e / 8][(e % 8) / 2];
        if constexpr (T::bf16_arg) {
          __nv_bfloat162 pr = exp_pair(sc[e], sc[e + 1], base[r]);
          if constexpr (T::norm_first) {
            // bf16 e times bf16(1 / sum) is exact in fp32, then rounded
            // to bf16, as the TPU kernel's bf16 product
            pr = bf16_pair(__low2float(pr) * norm[r], __high2float(pr) * norm[r]);
          } else if constexpr (!T::ones) {
            l_run[r] += __low2float(pr);
            l_run[r] += __high2float(pr);
          }
          a_pair = bits(pr);
        } else {
          const float e0 = exp2_ftz(fminf(sc[e], clamp));
          const float e1 = exp2_ftz(fminf(sc[e + 1], clamp));
          if constexpr (!T::ones) {
            l_run[r] += e0;
            l_run[r] += e1;
          }
          a_pair = sm90::pack_bf16x2(e0, e1);
        }
      }
    };

    // ---- the PV pass: tile 0's S and e, then for each tile j the products
    // of QK^T (j + 1) and PV (j) in flight together, tile j + 1's e under
    // PV (j) ----
    float alpha[2];
    // one step: pc holds tile j's fragments, pn gets tile j + 1's (`last`:
    // whether tile j + 1 is the last one)
    auto step = [&](int j, uint32_t (&pc)[BN / 16][4], uint32_t (&pn)[BN / 16][4], auto last) {
      wait_k();
      wait_v();
      sm90::wgmma_fence();
      issue_s(rg.k(kc % S));
      issue_pv(rg.v(vc % S), pc, j == 0);
      sm90::wgmma_wait_n<1>();  // QK^T (j + 1) done, PV (j) may run on
      sm90::fence_regs(sc);
      release_k();
      logits(j + 1, last);
      softmax(pn, alpha);
#pragma unroll
      for (int k = 0; k < BN / 16; ++k) sm90::fence_regs(pn[k]);  // before the wait, under PV (j)
      sm90::fence_regs(l_run);
      sm90::wgmma_wait();
      fence_pv(pc);
      release_v();
      if constexpr (T::max_sub && !T::norm_first) {
#pragma unroll
        for (int p = 0; p < kP; ++p)
#pragma unroll
          for (int e = 0; e < 32; ++e) o[p][e] *= alpha[(e >> 1) & 1];
        if constexpr (T::ones) {
#pragma unroll
          for (int i = 0; i < 4; ++i) rows[i] *= alpha[i >> 1];
        }
      }
    };
    // the last tile's PV
    auto last_pv = [&](uint32_t (&pc)[BN / 16][4], bool first) {
      wait_v();
      sm90::wgmma_fence();
      issue_pv(rg.v(vc % S), pc, first);
      sm90::wgmma_wait();
      fence_pv(pc);
      release_v();
    };
    wait_k();
    sm90::wgmma_fence();
    issue_s(rg.k(kc % S));
    sm90::wgmma_wait();
    sm90::fence_regs(sc);
    release_k();
    logits_of(0);
    softmax(p0, alpha);
    // tile j's fragments in p0 for even j, in p1 for odd j
    for (int j = 0;; j += 2) {
      if (j + 1 == n_tiles) {
        last_pv(p0, j == 0);
        break;
      }
      if (j + 2 == n_tiles) {
        step(j, p0, p1, std::true_type{});
        last_pv(p1, false);
        break;
      }
      step(j, p0, p1, std::false_type{});
      if (j + 3 == n_tiles) {
        step(j + 1, p1, p0, std::true_type{});
        last_pv(p0, false);
        break;
      }
      step(j + 1, p1, p0, std::false_type{});
    }

    // ---- O / sum (1/0 = inf, as the TPU kernel's reciprocal; kNormFirst
    // is normalised already), store through this warpgroup's Q rows, then
    // release the Q buffer ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (T::norm_first) {
        inv[r] = 1.f;
      } else if constexpr (T::ones) {
        inv[r] = 1.f / rows[2 * r];
      } else {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        inv[r] = 1.f / l_run[r];
      }
    }
    sm90::named_bar(1 + wg, 128);  // every warp's last product has read the Q rows
#pragma unroll
    for (int p = 0; p < kP; ++p) sm90::store_acc(sQ + p * C::kQPanel, o[p], row0, inv);
    sm90::fence_async_shared();
    sm90::named_bar(1 + wg, 128);
    if (tid == 0) {
      for (int p = 0; p < kP; ++p) {
        sm90::tma_store(maps.o, sQ + p * C::kQPanel + row0 * kRowBytes, p * kPanelCols, un.h,
                        un.m0 + row0, un.b);
      }
      sm90::tma_store_wait();
      sm90::mbar_arrive(rg.qempty(qb));
    }
  }
}

template <int D, int NWG, int BN, int R>
__global__ void __launch_bounds__(kThreads, 1)
attn_nomax_wgmma_kernel(const __grid_constant__ NomaxMaps maps, const NomaxArgs a) {
  using C = Nomax<D, NWG, BN, R>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (sm90::kSmemAlign - sm90::smem_u32(smem_raw) % sm90::kSmemAlign) %
                                 sm90::kSmemAlign;
  if (threadIdx.x == 0) {
    for (int r = 0; r < C::kRings; ++r) {
      const Ring<C> rg(smem, r);
      for (int s = 0; s < C::kStages; ++s) {
        sm90::mbar_init(rg.kfull(s), 1);
        sm90::mbar_init(rg.vfull(s), 1);
        sm90::mbar_init(rg.kempty(s), 4 * NWG);  // one arrival a consumer warp of the ring
        sm90::mbar_init(rg.vempty(s), 4 * NWG);
      }
      for (int i = 0; i < 2; ++i) {
        sm90::mbar_init(rg.qfull(i), 1);
        sm90::mbar_init(rg.qempty(i), NWG);
      }
    }
    sm90::fence_barrier_init();
  }
  if constexpr (C::T::ones) {
    // B of the row-sum product: bf16 1.0 is 0x3f80
    uint32_t* ones = reinterpret_cast<uint32_t*>(smem + C::kOnesOff);
    for (int i = threadIdx.x; i < 8 * kRowBytes / 4; i += blockDim.x) ones[i] = 0x3f803f80u;
    sm90::fence_async_shared();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int ring = (threadIdx.x - kConsumers) / 32;
    if (ring < C::kRings && threadIdx.x % 32 == 0) produce<D, NWG, BN, R>(maps, a, smem, ring);
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume<D, NWG, BN, R>(maps, a, smem);
  }
}

// CTAs of a launch: at most one an SM, each with kRings rings.
template <int D, int NWG, int BN, int R>
int grid_of(const NomaxArgs& a) {
  constexpr int kRings = Nomax<D, NWG, BN, R>::kRings;
  const int per_ring = (a.items + kRings - 1) / kRings;
  return std::min(per_ring, sm90::sm_count());
}

template <int D, int NWG, int BN, int R>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int sq, int sk,
           int heads, long long q_row, long long k_row, long long v_row, long long q_batch,
           long long k_batch, long long v_batch, const NomaxArgs& a, cudaStream_t stream) {
  using C = Nomax<D, NWG, BN, R>;
  const long long hd = (long long)heads * D;
  NomaxMaps maps;
  if (!sm90::make_map(&maps.q, q, D, heads, sq, batch, q_batch, D, q_row, NWG * 64) ||
      !sm90::make_map(&maps.k, k, D, heads, sk, batch, k_batch, D, k_row, BN) ||
      !sm90::make_map(&maps.v, v, D, heads, sk, batch, v_batch, D, v_row, BN) ||
      !sm90::make_map(&maps.o, o, D, heads, sq, batch, sq * hd, D, hd, 64)) {
    return (int)cudaErrorInvalidPitchValue;
  }
  static sm90::PerDevice smem_set;
  const cudaError_t err = sm90::allow_smem(
      reinterpret_cast<const void*>(attn_nomax_wgmma_kernel<D, NWG, BN, R>), C::kBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  attn_nomax_wgmma_kernel<D, NWG, BN, R>
      <<<grid_of<D, NWG, BN, R>(a), kThreads, C::kBytes, stream>>>(maps, a);
  return (int)cudaGetLastError();
}

// Calls f.run<D, NWG, BN, R>() for the instance of (head_dim, nwg, bn,
// recipe), or returns cudaErrorInvalidValue where none is built.
template <class F>
int with_instance(int head_dim, int nwg, int bn, int recipe, F& f) {
#define NOMAX_RUN(D, NWG, BN, R) return f.template run<D, NWG, BN, R>()
#define NOMAX_NWG(D, BN)                          \
  if (nwg == 1) NOMAX_RUN(D, 1, BN, kClampF32);   \
  if (nwg == 2) NOMAX_RUN(D, 2, BN, kClampF32);   \
  break
#define NOMAX_RECIPE(D, BN)                                   \
  switch (recipe) {                                           \
    case kMaxExp2: NOMAX_RUN(D, 2, BN, kMaxExp2);             \
    case kMaxExp2Ones: NOMAX_RUN(D, 2, BN, kMaxExp2Ones);     \
    case kClampBf16: NOMAX_RUN(D, 2, BN, kClampBf16);         \
    case kClampBf16Ones: NOMAX_RUN(D, 2, BN, kClampBf16Ones); \
    case kClampF32Ones: NOMAX_RUN(D, 2, BN, kClampF32Ones);   \
    case kMaxExp: NOMAX_RUN(D, 2, BN, kMaxExp);               \
    case kNormFirst: NOMAX_RUN(D, 2, BN, kNormFirst);         \
    default: break;                                           \
  }                                                           \
  break
  if (recipe == kClampF32) {
    switch (head_dim * 1000 + bn) {
      case 32064: NOMAX_NWG(32, 64);
      case 32128: NOMAX_NWG(32, 128);
      case 64064: NOMAX_NWG(64, 64);
      case 64128: NOMAX_NWG(64, 128);
      case 128064: NOMAX_NWG(128, 64);
      default: break;
    }
  } else if (nwg == 2) {
    switch (head_dim * 1000 + bn) {
      case 32128: NOMAX_RECIPE(32, 128);
      case 64128: NOMAX_RECIPE(64, 128);
      case 128064: NOMAX_RECIPE(128, 64);
      default: break;
    }
  }
#undef NOMAX_RECIPE
#undef NOMAX_NWG
#undef NOMAX_RUN
  return (int)cudaErrorInvalidValue;
}

// The work of a launch (NomaxArgs' items), or false where the schedule is
// not one the kernel takes.
bool schedule(int batch, int sq, int heads, int nwg, int heads_per_cta, int batch_per_cta,
              NomaxArgs* a) {
  if (batch <= 0 || sq <= 0 || heads <= 0 || (nwg != 1 && nwg != 2) || heads_per_cta < 1 ||
      batch_per_cta < 1 || heads % heads_per_cta || batch % batch_per_cta ||
      (heads_per_cta > 1 && batch_per_cta > 1)) {
    return false;
  }
  const long long q_tiles = (sq + nwg * 64 - 1) / (nwg * 64);
  const long long items = q_tiles * (heads / heads_per_cta) * (batch / batch_per_cta);
  if (items > INT_MAX) return false;
  a->heads_per_cta = heads_per_cta;
  a->batch_per_cta = batch_per_cta;
  a->q_tiles = (int)q_tiles;
  a->head_groups = heads / heads_per_cta;
  a->items = (int)items;
  return true;
}

struct Launcher {
  const void *q, *k, *v;
  void* o;
  int batch, sq, sk, heads;
  long long q_row, k_row, v_row, q_batch, k_batch, v_batch;
  NomaxArgs a;
  cudaStream_t stream;

  template <int D, int NWG, int BN, int R>
  int run() {
    return launch<D, NWG, BN, R>(q, k, v, o, batch, sq, sk, heads, q_row, k_row, v_row, q_batch,
                                 k_batch, v_batch, a, stream);
  }
};

// What attn_nomax_plan reports of an instance and a schedule.
struct Planner {
  NomaxArgs a;
  long long* info;

  template <int D, int NWG, int BN, int R>
  int run() {
    using C = Nomax<D, NWG, BN, R>;
    const long long v[9] = {kThreads, kProducerRegs, kConsumerRegs, C::kStages, C::kRings,
                            C::kBytes, a.items, (long long)a.heads_per_cta * a.batch_per_cta,
                            grid_of<D, NWG, BN, R>(a)};
    for (int i = 0; i < 9; ++i) info[i] = v[i];
    return 0;
  }
};

}  // namespace

// Plain C entry point (loaded with ctypes). q, k, v packed (B, S, H*D)
// bf16 with a row and a batch stride each (elements; head h at column h*D,
// unit stride along D); o a contiguous (B, Sq, H*D) bf16 buffer. Keys at or
// past kv_len (1 <= kv_len <= sk) are masked. Tiles: 64 * nwg query rows
// (nwg 1 or 2) and bn keys (64 or 128; 64 at head_dim 128); head_dim 32,
// 64 or 128. Schedule: a work item walks heads_per_cta heads (dividing
// heads) of batch_per_cta batch rows (dividing batch), one of the two being
// 1. recipe: a Recipe; every one but kClampF32 only at nwg 2 and bn 128 (64
// at head_dim 128). scale_q multiplies Q (every recipe but kNormFirst),
// scale_s the logits (kNormFirst), clamp bounds the clamp recipes' exp2
// argument. Every base address and stride must be a multiple of 16 bytes
// (the TMA's rule). Returns cudaGetLastError() after the launch (0 on
// success); an operand whose tensor map cuTensorMapEncodeTiled refuses
// returns cudaErrorInvalidPitchValue, anything else it does not take
// cudaErrorInvalidValue, both without launching.
extern "C" int attn_nomax_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                               int sq, int sk, int kv_len, int heads, int head_dim, int nwg,
                               int bn, int heads_per_cta, int batch_per_cta, long long q_row,
                               long long k_row, long long v_row, long long q_batch,
                               long long k_batch, long long v_batch, int recipe, float scale_q,
                               float scale_s, float clamp, void* stream) {
  Launcher l{q, k, v, o, batch, sq, sk, heads, q_row, k_row, v_row, q_batch, k_batch, v_batch,
             {}, static_cast<cudaStream_t>(stream)};
  if (sk <= 0 || kv_len < 1 || kv_len > sk ||
      !schedule(batch, sq, heads, nwg, heads_per_cta, batch_per_cta, &l.a)) {
    return (int)cudaErrorInvalidValue;
  }
  l.a.kv_len = kv_len;
  l.a.scale_q = scale_q;
  l.a.scale_s = scale_s;
  l.a.clamp = clamp;
  return with_instance(head_dim, nwg, bn, recipe, l);
}

// The instance and schedule attn_nomax_bf16 would launch for these
// arguments, on the current device: info = {threads, producer registers,
// consumer registers (after setmaxnreg), K and V stages a ring, rings,
// dynamic shared memory bytes, work items, units an item, CTAs}. Returns 0,
// or cudaErrorInvalidValue where attn_nomax_bf16 would refuse them.
extern "C" int attn_nomax_plan(int head_dim, int nwg, int bn, int recipe, int batch, int sq,
                               int heads, int heads_per_cta, int batch_per_cta, long long* info) {
  Planner p{{}, info};
  if (!schedule(batch, sq, heads, nwg, heads_per_cta, batch_per_cta, &p.a)) {
    return (int)cudaErrorInvalidValue;
  }
  return with_instance(head_dim, nwg, bn, recipe, p);
}
