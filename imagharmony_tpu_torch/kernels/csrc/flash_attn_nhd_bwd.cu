// K3: backward of K1 and K4 (fused self-attention), bf16 in and out, fp32
// accumulation. Two entry points that differ only in the strides they hand
// the same kernels:
//
//   * `flash_attn_nhd_bwd_bf16`: K1's packed (B, S, H*D) layout, head h at
//     column h*D; dq, dk, dv contiguous (B, S, H*D).
//   * `flash_attn_bhsd_bwd_bf16`: K4's head-split (B, H, S, D) layout with a
//     batch, a head and a row stride for every operand and output, so
//     `split_heads` views of a packed to_qkv output go in with no copy.
//
// Head dims 32, 40, 64, 80, 128, 160 under both.
//
// Replaces the TPU kernel `_attn_bwd_kernel` (imagharmony_tpu/kernels/
// flash_attention.py:220), reached through `_flash_bwd_impl` (:270) from the
// custom_vjp backwards `_flash_nhd_bwd` (:540, K1's) and `_flash_bwd` (:350,
// K4's). The Pallas kernel relayouts to (B, H, S, D), pads d to 64 in device
// memory and recomputes a no-max softmax clamped at exp(80); this one takes
// the operands where they lie and recomputes the exact softmax from the row
// log-sum-exp the forward writes (`lse`, scaled-log2 domain: lse = m +
// log2(l) with m the row max of s = q.k*scale*log2(e) and l = sum
// exp2(s - m)), so P = exp2(s - lse) needs no running max here.
//
//   dV = P^T dO        dS = P o (dO V^T - Delta),  Delta = rowsum(dO o O)
//   dQ = scale dS K    dK = scale dS^T Q
//
// What bounds it on an H100: 5 products of (Sq, Sk, D), 10*B*H*Sq*Sk*D flops,
// against q, k, v, o, dO read once and dq, dk, dv written once. At the
// training shape S=1024, H=10, D=64 that is 6.7 GFLOP against 16 MB, about
// 400 flop/byte, above the ~295 flop/byte ridge: tensor-core bound. So, as in
// K1, the (Sq, Sk) probabilities never reach device memory.
//
// Design (simple and correct first; wgmma/TMA are later work). Three kernels,
// no atomics, so the gradients are deterministic:
//   1. delta_kernel: Delta = rowsum(dO o O) in fp32, one thread per (row, head).
//   2. dkdv_kernel: one CTA of 4 warps per (64-key tile, head, batch). The
//      tile's K and V stay in shared memory; each warp owns 16 keys and their
//      dK/dV rows in fp32 registers, and loops over 64-row query tiles:
//      S^T = K Qs^T, P^T = exp2(S^T - lse), dP^T = V dO^T,
//      dS^T = P^T o (dP^T - Delta), dV += P^T dO, dK += dS^T Q.
//      Above D=80 the dV and dK accumulators would not fit the registers
//      together (2*16*D/32 = 160 a thread at D=160), so the loop runs twice:
//      dV alone, then dK alone, one accumulator each; S^T is recomputed.
//   3. dq_kernel: one CTA per (64-row query tile, head, batch), its Qs and dO
//      in shared memory, each warp 16 query rows; it loops over 64-key tiles:
//      S = Qs K^T, P, dP = dO V^T, dS, dQ += dS K.
// Qs = bf16(q * scale*log2(e)), rounded exactly as the forward rounds it, so
// P here is the P of the forward. Products are mma.sync.m16n8k16 bf16 with
// fp32 accumulation; A operands are read from shared memory, P and dS stay
// in registers (the accumulator layout of one product is the A-operand
// layout of the next) and are rounded to bf16 as operands; B operands that a
// product needs with the other axis contiguous are staged transposed.
// Products over the head dim run over D rounded up to 16, the extra columns
// zero in shared memory only (D=40 -> 48), as in K4.
// Shared memory is dynamic: at D=160 a dK/dV CTA needs 130 KB and a dQ CTA
// 107 KB, above the 48 KB a kernel may declare statically; each launch asks
// for its bytes with cudaFuncSetAttribute first.
// Ragged edges are masked here: keys past Sk get P = 0, query rows past Sq
// get lse = +inf (so P = 0) and Delta = 0, and nothing past either edge is
// stored.

#include "attn_tiles.cuh"

namespace {

template <int D>
__global__ void delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                             float* __restrict__ delta, int sq, int heads, Strides os,
                             Strides dos, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int h = (int)(i % heads);
  const int64_t rest = i / heads;
  const int row = (int)(rest % sq);
  const int b = (int)(rest / sq);
  const bf16* op = o + b * os.batch + h * os.head + row * os.row;
  const bf16* dp = dout + b * dos.batch + h * dos.head + row * dos.row;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    uint4 a = *reinterpret_cast<const uint4*>(op + c);
    uint4 d = *reinterpret_cast<const uint4*>(dp + c);
    const bf16* ea = reinterpret_cast<const bf16*>(&a);
    const bf16* ed = reinterpret_cast<const bf16*>(&d);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += __bfloat162float(ea[j]) * __bfloat162float(ed[j]);
  }
  delta[((int64_t)b * heads + h) * sq + row] = acc;
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int sq, sk, heads;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float scale, scale_log2;
};

// Elements of a row-major 64-row tile and of a transposed one.
template <int D>
constexpr int kRowTile = kBlockN * kPitch<D>;
template <int D>
constexpr int kColTile = D * (kBlockN + kPad);

template <int D>
constexpr size_t kDkdvSmem = (4 * kRowTile<D> + 2 * kColTile<D>) * sizeof(bf16) +
                             2 * kBlockM * sizeof(float);
template <int D>
constexpr size_t kDqSmem = (4 * kRowTile<D> + kColTile<D>) * sizeof(bf16);

// One loop over the query tiles for the dK/dV CTA whose K and V are in sK
// and sV: accumulates dV if kDV and dK if kDK, then stores them.
template <int D, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_pass(const Args& a, const bf16* sK, const bf16* sV,
                                          bf16* sQs, bf16* sdO, bf16* sQt, bf16* sdOt,
                                          float* sLse, float* sDelta, int n0, int h, int b) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const bf16* qh = a.q + b * a.qs.batch + h * a.qs.head;
  const bf16* doh = a.dout + b * a.dos.batch + h * a.dos.head;
  const int64_t stat0 = ((int64_t)b * a.heads + h) * a.sq;
  const bf16* k_rows = sK + warp * 16 * kPitch<D>;
  const bf16* v_rows = sV + warp * 16 * kPitch<D>;

  float dv_acc[kDV ? D / 8 : 1][4], dk_acc[kDK ? D / 8 : 1][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kDV) dv_acc[nd][i] = 0.f;
      if constexpr (kDK) dk_acc[nd][i] = 0.f;
    }
  const int key0 = n0 + warp * 16 + g;  // keys of rows g and g + 8

  for (int m0 = 0; m0 < a.sq; m0 += kBlockM) {
    load_tile<D>(sQs, qh, a.qs.row, m0, a.sq, a.scale_log2);
    if constexpr (kDK) {
      load_tile_t<D>(sQt, qh, a.qs.row, m0, a.sq);
      load_tile<D>(sdO, doh, a.dos.row, m0, a.sq);
    }
    if constexpr (kDV) load_tile_t<D>(sdOt, doh, a.dos.row, m0, a.sq);
    for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
      const bool valid = m0 + i < a.sq;
      sLse[i] = valid ? a.lse[stat0 + m0 + i] : INFINITY;
      sDelta[i] = valid ? a.delta[stat0 + m0 + i] : 0.f;
    }
    __syncthreads();

    float s[kBlockN / 8][4], dp[kDK ? kBlockN / 8 : 1][4];
    mma_rows<D>(s, k_rows, sQs, g, t);                 // S^T (keys x queries), log2 domain
    if constexpr (kDK) mma_rows<D>(dp, v_rows, sdO, g, t);  // dP^T
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nb * 8 + 2 * t + (i & 1);
        const int key = key0 + 8 * (i >> 1);
        const float p = key < a.sk ? exp2f(s[nb][i] - sLse[col]) : 0.f;
        s[nb][i] = p;
        if constexpr (kDK) dp[nb][i] = p * (dp[nb][i] - sDelta[col]);
      }
    }
    if constexpr (kDV) mma_cols<D>(dv_acc, s, sdOt, g, t);  // dV += P^T dO
    if constexpr (kDK) mma_cols<D>(dk_acc, dp, sQt, g, t);  // dK += dS^T Q
    __syncthreads();  // before the next tile overwrites shared memory
  }

  if constexpr (kDK) {
    const float mul[2] = {a.scale, a.scale};
    store_rows<D>(a.dk, a.dks, dk_acc, mul, b, h, a.sk, n0 + warp * 16, g, t);
  }
  if constexpr (kDV) {
    const float one[2] = {1.f, 1.f};
    store_rows<D>(a.dv, a.dvs, dv_acc, one, b, h, a.sk, n0 + warp * 16, g, t);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRowTile<D>;
  bf16* sQs = sV + kRowTile<D>;
  bf16* sdO = sQs + kRowTile<D>;
  bf16* sQt = sdO + kRowTile<D>;
  bf16* sdOt = sQt + kColTile<D>;
  float* sLse = reinterpret_cast<float*>(sdOt + kColTile<D>);
  float* sDelta = sLse + kBlockM;

  const int n0 = blockIdx.x * kBlockN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  load_tile<D>(sK, a.k + b * a.ks.batch + h * a.ks.head, a.ks.row, n0, a.sk);
  load_tile<D>(sV, a.v + b * a.vs.batch + h * a.vs.head, a.vs.row, n0, a.sk);
  // the first query tile's __syncthreads publishes them
  if constexpr (D > 80) {
    dkdv_pass<D, true, false>(a, sK, sV, sQs, sdO, sQt, sdOt, sLse, sDelta, n0, h, b);
    dkdv_pass<D, false, true>(a, sK, sV, sQs, sdO, sQt, sdOt, sLse, sDelta, n0, h, b);
  } else {
    dkdv_pass<D, true, true>(a, sK, sV, sQs, sdO, sQt, sdOt, sLse, sDelta, n0, h, b);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQs = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQs + kRowTile<D>;
  bf16* sK = sdO + kRowTile<D>;
  bf16* sV = sK + kRowTile<D>;
  bf16* sKt = sV + kRowTile<D>;

  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const bf16* kh = a.k + b * a.ks.batch + h * a.ks.head;
  const bf16* vh = a.v + b * a.vs.batch + h * a.vs.head;
  const int64_t stat0 = ((int64_t)b * a.heads + h) * a.sq;

  load_tile<D>(sQs, a.q + b * a.qs.batch + h * a.qs.head, a.qs.row, m0, a.sq, a.scale_log2);
  load_tile<D>(sdO, a.dout + b * a.dos.batch + h * a.dos.head, a.dos.row, m0, a.sq);
  const bf16* q_rows = sQs + warp * 16 * kPitch<D>;
  const bf16* do_rows = sdO + warp * 16 * kPitch<D>;

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    lse_r[r] = row < a.sq ? a.lse[stat0 + row] : INFINITY;
    delta_r[r] = row < a.sq ? a.delta[stat0 + row] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[nd][i] = 0.f;

  for (int n0 = 0; n0 < a.sk; n0 += kBlockN) {
    load_tile<D>(sK, kh, a.ks.row, n0, a.sk);
    load_tile<D>(sV, vh, a.vs.row, n0, a.sk);
    load_tile_t<D>(sKt, kh, a.ks.row, n0, a.sk);
    __syncthreads();  // also publishes sQs / sdO on the first tile

    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
    mma_rows<D>(s, q_rows, sK, g, t);    // S (queries x keys), log2 domain
    mma_rows<D>(dp, do_rows, sV, g, t);  // dP
#pragma unroll
    for (int nb = 0; nb < kBlockN / 8; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nb * 8 + 2 * t + (i & 1);
        const int r = i >> 1;
        const float p = col < a.sk ? exp2f(s[nb][i] - lse_r[r]) : 0.f;
        s[nb][i] = p * (dp[nb][i] - delta_r[r]);  // dS
      }
    }
    mma_cols<D>(dq_acc, s, sKt, g, t);  // dQ += dS K
    __syncthreads();
  }

  const float mul[2] = {a.scale, a.scale};
  store_rows<D>(a.dq, a.dqs, dq_acc, mul, b, h, a.sq, m0 + warp * 16, g, t);
}

template <int D>
int launch(const Args& a, const bf16* o, Strides os, float* delta, int batch,
           cudaStream_t stream) {
  const int64_t total = (int64_t)batch * a.sq * a.heads;
  const int threads = 256;
  delta_kernel<D><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      o, a.dout, delta, a.sq, a.heads, os, a.dos, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkdvSmem<D>);
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<D><<<dim3((a.sk + kBlockN - 1) / kBlockN, a.heads, batch), kThreads,
                   kDkdvSmem<D>, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDqSmem<D>);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<D><<<dim3((a.sq + kBlockM - 1) / kBlockM, a.heads, batch), kThreads, kDqSmem<D>,
                 stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, const bf16* o, Strides os, float* delta, int batch, int head_dim,
             cudaStream_t stream) {
  if (batch <= 0 || a.sq <= 0 || a.sk <= 0 || a.heads <= 0 || a.heads > 65535 ||
      batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  switch (head_dim) {
    case 32: return launch<32>(a, o, os, delta, batch, stream);
    case 40: return launch<40>(a, o, os, delta, batch, stream);
    case 64: return launch<64>(a, o, os, delta, batch, stream);
    case 80: return launch<80>(a, o, os, delta, batch, stream);
    case 128: return launch<128>(a, o, os, delta, batch, stream);
    case 160: return launch<160>(a, o, os, delta, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Strides are in elements; `delta`
// is fp32 scratch of B*H*Sq elements that the caller allocates, `lse` the
// forward's contiguous fp32 (B, H, Sq). Each returns the first CUDA error of
// its launches (0 on success); an unsupported head_dim or an empty shape
// returns cudaErrorInvalidValue without launching.

// K1's layout: q, k, v, o, dout with a row and a batch stride each (head h at
// column h*D); dq, dk, dv contiguous (B, S, H*D).
extern "C" int flash_attn_nhd_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int sq, int sk,
    int heads, int head_dim, long long q_row, long long k_row, long long v_row, long long o_row,
    long long do_row, long long q_batch, long long k_batch, long long v_batch, long long o_batch,
    long long do_batch, float scale, float scale_log2, void* stream) {
  const int64_t hd = (int64_t)heads * head_dim;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
               static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
               sq, sk, heads,
               {q_batch, head_dim, q_row}, {k_batch, head_dim, k_row},
               {v_batch, head_dim, v_row}, {do_batch, head_dim, do_row},
               {sq * hd, head_dim, hd}, {sk * hd, head_dim, hd}, {sk * hd, head_dim, hd},
               scale, scale_log2};
  return dispatch(a, static_cast<const bf16*>(o), {o_batch, head_dim, o_row}, delta, batch,
                  head_dim, static_cast<cudaStream_t>(stream));
}

// K4's layout: every operand and output (B, H, S, D) with a batch, a head
// and a row stride (unit stride along D).
extern "C" int flash_attn_bhsd_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int sq, int sk,
    int heads, int head_dim,
    long long q_batch, long long q_head, long long q_row,
    long long k_batch, long long k_head, long long k_row,
    long long v_batch, long long v_head, long long v_row,
    long long o_batch, long long o_head, long long o_row,
    long long do_batch, long long do_head, long long do_row,
    long long dq_batch, long long dq_head, long long dq_row,
    long long dk_batch, long long dk_head, long long dk_row,
    long long dv_batch, long long dv_head, long long dv_row,
    float scale, float scale_log2, void* stream) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
               static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
               sq, sk, heads,
               {q_batch, q_head, q_row}, {k_batch, k_head, k_row}, {v_batch, v_head, v_row},
               {do_batch, do_head, do_row}, {dq_batch, dq_head, dq_row},
               {dk_batch, dk_head, dk_row}, {dv_batch, dv_head, dv_row},
               scale, scale_log2};
  return dispatch(a, static_cast<const bf16*>(o), {o_batch, o_head, o_row}, delta, batch,
                  head_dim, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory each launch at head_dim asks for, in bytes:
// which = 0 for dkdv_kernel, 1 for dq_kernel; -1 for an unsupported head_dim.
extern "C" long long flash_attn_bwd_smem_bytes(int head_dim, int which) {
  switch (head_dim) {
    case 32: return which ? kDqSmem<32> : kDkdvSmem<32>;
    case 40: return which ? kDqSmem<40> : kDkdvSmem<40>;
    case 64: return which ? kDqSmem<64> : kDkdvSmem<64>;
    case 80: return which ? kDqSmem<80> : kDkdvSmem<80>;
    case 128: return which ? kDqSmem<128> : kDkdvSmem<128>;
    case 160: return which ? kDqSmem<160> : kDkdvSmem<160>;
    default: return -1;
  }
}
