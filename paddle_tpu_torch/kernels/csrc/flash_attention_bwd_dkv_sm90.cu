// Flash-attention dK/dV for Hopper tensor cores (sm_90a), bf16 inputs;
// plain C entry point.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` in
// paddle_tpu/kernels/flash_attention.py (the second pallas_call of
// `_flash_bwd`) for bfloat16 inputs: per 64-row key tile, loop over the
// query tiles from the causal start, recompute P = exp(S - lse) under the
// forward's masks (query rows >= Sq, and q_pos < k_pos under causal), and
// accumulate dV += P^T.dO and dK += dS^T.(scale Q), dS = P o (dO.V^T -
// Delta). Delta is the f32 [B, H, Sq] that the bf16 dQ kernel wrote
// (flash_attention_bwd_dq_sm90.cu); nothing here recomputes it. float32
// inputs keep the CUDA-core kernel of flash_attention_bwd.cu.
//
// What bounds it. GPT-small trained at S = 1024 (B*H = 8*12, D = 64,
// causal) asks for four causal-half products (S, dP, dV, dK; ~25.8 GFLOP,
// ~26 us at 989 TFLOP/s) against ~76 MB of q/k/v/dO/lse/Delta/dK/dV
// traffic (~23 us at 3.35 TB/s): operations bound it, by a little. The
// CUDA-core kernel ran all four products as f32 FMAs (67 TFLOP/s peak),
// widened K, V and every Q/dO tile to f32 in shared memory, passed P^T and
// dS^T through shared memory, and loaded synchronously between
// __syncthreads(). Here the tensor cores' issue rate, one ex2 per score
// and each query tile's dependent chain (S^T and dP^T -> P^T, dS^T -> dV,
// dK) are what remain.
//
// Design (the dQ kernel's scheme turned around: keys are wgmma's M).
//  * A block is one consumer warpgroup that owns 64 key rows, plus a
//    producer warp. K and V arrive once by TMA; Q and dO tiles of BQ query
//    rows stream through a 3-stage ring with full/empty mbarriers. The
//    tensor maps are 4-D views over the caller's [B, S, H, D] strides, so
//    q/k/v (views of the fused QKV) and dO are read in place; rows past the
//    end arrive as zeros.
//  * lse and Delta: in the S^T accumulator a thread holds query columns
//    8 j + 2 (lane % 4) + {0, 1}, so it needs BQ / 4 values of each a tile.
//    The producer warp loads a tile's lse (times log2 e) and Delta with
//    plain guarded loads, one value a lane, into shared memory beside the
//    stage, and every producer lane arrives on the stage's full barrier
//    (lane 0 with the TMA bytes), which releases its stores. A 2-D TMA map
//    over [B*H, Sq] f32 is not always legal: its row stride, 4 Sq bytes,
//    must be a multiple of 16, and the wrapper takes any Sq.
//  * S^T = K.Q^T and dP^T = V.dO^T are wgmma from shared memory (A = K or V,
//    B = the Q or dO tile, all K-major as stored), committed as two groups
//    so that P^T's ex2 runs while dP^T is still in flight.
//  * The scale multiplies the f32 scores, never Q in bf16: P = exp2(S *
//    scale log2 e - lse log2 e), one FFMA and one ex2 a score; dK is
//    multiplied by the scale once, in f32, at the end. Query columns >= Sq
//    get P = 0 explicitly (TMA zero-fills Q there, but exp2(0 - lse) is not
//    0); the causal mask applies on the diagonal tiles only.
//  * P^T in bf16 is the register A operand of dV += P^T.dO, issued as soon
//    as it is packed, so it runs on the tensor cores while dS^T = P^T o
//    (dP^T - Delta) is formed; dS^T in bf16 is the register A operand of
//    dK += dS^T.Q. dO and Q are read MN-major (wgmma's transposed B, legal
//    for 16-bit types) from the very tiles S^T and dP^T read K-major
//    (desc_kmajor / desc_mnmajor in sm90.cuh): P^T and dS^T never leave
//    registers, and no transpose is stored.
//  * A stage is released once dK's product, the last reader of its Q tile,
//    has completed: one arrival per consumer warp.
//  * Tiles, as tried on the card: 64 query rows a Q/dO tile at every head
//    dim. At D = 64 a thread holds the dK and dV accumulators (32 + 32
//    f32), S^T and dP^T (32 + 32) and P^T and dS^T in bf16 (16 + 16) in 168
//    registers, the most that lets two blocks share an SM, with no spill.
//    At D = 128 dK and dV alone take 128 registers: at two blocks an SM
//    even 32-row query tiles spilled and had every wgmma serialized, so
//    that instantiation runs one block an SM, where 64-row tiles beat
//    32-row ones. A 2-stage ring was slower than 3; 4 stages gained
//    nothing. Issuing the next tile's S^T and dP^T right behind this
//    tile's dK product (the forward's pipeline, last tile peeled) was
//    slower in all three arrangements tried: ptxas serialized every wgmma,
//    for a spin-wait or a lane-0 arrival while products were in flight,
//    and, once those were gone, for the register pressure.
//  * Longest causal loops first: blockIdx.x is the batch-head and
//    blockIdx.y the key tile, so every key tile 0 (which sees every query
//    tile) launches before any key tile 1; the key-tile-major grid of the
//    CUDA-core kernel was slower.
//  * dK and dV are written in bf16, contiguous [B, Sk, H, D], rows >= Sk
//    skipped. Every element has one owner block: no atomics, the same bits
//    every run (dQ stays in its own kernel).
//  * cudaFuncSetAttribute runs once per instantiation, not per launch.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BK = 64;  // key rows of a block: one consumer warpgroup
constexpr int BQ = 64;  // query rows of a streamed Q/dO tile
constexpr int STAGES = 3;
constexpr int THREADS = 128 + 32;  // the warpgroup and the producer warp
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const float* lse;    // [B, H, Sq] natural-log logsumexp of the forward
  const float* delta;  // [B, H, Sq] rowsum(O o dO), from the dQ kernel
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, Sq, Sk, causal;
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
};

template <int D>
struct Smem {
  static constexpr int KV_BYTES = BK * D * 2;  // one of K, V
  static constexpr int Q_BYTES = BQ * D * 2;   // one of Q, dO
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;
  // + 1024 to align the tiles to the swizzle atom
  static constexpr int BYTES = 2 * KV_BYTES + STAGES * STAGE_BYTES + 1024;
};

// S^T = K.Q^T and dP^T = V.dO^T for the block's 64 keys, committed as two
// groups (S^T first).
template <int D>
__device__ __forceinline__ void st_and_dpt(float (&sc)[BQ / 2],
                                           float (&dp)[BQ / 2], uint32_t sK,
                                           uint32_t sV, uint32_t sQ,
                                           uint32_t sDO) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<BQ>::template ss<0>(sc, desc_kmajor<D, BK>(sK, kk),
                              desc_kmajor<D, BQ>(sQ, kk), kk > 0);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<BQ>::template ss<0>(dp, desc_kmajor<D, BK>(sV, kk),
                              desc_kmajor<D, BQ>(sDO, kk), kk > 0);
  wgmma_commit();
}

// acc += A.T, A (64 keys x BQ queries) from registers and T the BQ-row Q
// or dO tile at sT read transposed, one group.
template <int D>
__device__ __forceinline__ void times_tile(float (&acc)[D / 2],
                                           const uint32_t (&a)[BQ / 16][4],
                                           uint32_t sT) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    Wgmma<D>::template rs<1>(acc, a[kk], desc_mnmajor<D, BQ>(sT, kk), 1);
  wgmma_commit();
}

// This thread's two key rows and the first of its two columns in each 8.
struct Rows {
  int a, b, cq;
};

// In place: S^T of the query tile at q0 -> P^T = exp2(S^T scale log2e -
// lse log2e) under the masks; `lse2` is the tile's lse * log2(e).
__device__ __forceinline__ void probs(float (&sc)[BQ / 2], const float* lse2,
                                      const Rows& r, int q0, int k0,
                                      const Params& p) {
  const bool edge = q0 + BQ > p.Sq || (p.causal && q0 < k0 + BK - 1);
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * i + r.cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = ex2(fmaf(sc[4 * i + e], p.scale_log2, -(e & 1 ? l.y : l.x)));
      if (edge) {
        const int col = q0 + 8 * i + r.cq + (e & 1);
        if (col >= p.Sq || (p.causal && col < (e < 2 ? r.a : r.b))) pr = 0.f;
      }
      sc[4 * i + e] = pr;
    }
  }
}

// In place: P^T -> dS^T = P^T o (dP^T - Delta), `dl` the tile's Delta.
__device__ __forceinline__ void grad_scores(float (&sc)[BQ / 2],
                                            const float (&dp)[BQ / 2],
                                            const float* dl, int cq) {
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    const float2 d = *reinterpret_cast<const float2*>(dl + 8 * i + cq);
    sc[4 * i + 0] *= dp[4 * i + 0] - d.x;
    sc[4 * i + 1] *= dp[4 * i + 1] - d.y;
    sc[4 * i + 2] *= dp[4 * i + 2] - d.x;
    sc[4 * i + 3] *= dp[4 * i + 3] - d.y;
  }
}

// An f32 score fragment to the bf16 A fragments of the k-steps over BQ.
__device__ __forceinline__ void pack(uint32_t (&a)[BQ / 16][4],
                                     const float (&sc)[BQ / 2]) {
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    a[i / 2][2 * (i % 2) + 0] = pack_bf16(sc[4 * i + 0], sc[4 * i + 1]);
    a[i / 2][2 * (i % 2) + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D == 128 ? 1 : 2)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const Params p) {
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, full[STAGES], empty[STAGES];
  // per stage: the query tile's lse * log2(e) and Delta
  __shared__ __align__(16) float s_lse[STAGES][BQ], s_dl[STAGES][BQ];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = base + S::KV_BYTES;
  const uint32_t sQD = base + 2 * S::KV_BYTES;  // the Q/dO ring

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.y * BK;
  const int qt0 = p.causal ? k0 / BQ : 0;  // earlier query tiles are masked
  const int n_qt = (p.Sq + BQ - 1) / BQ - qt0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bar_kv), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 32);  // every producer lane
      mbar_init(smem_u32(&empty[s]), 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      const uint32_t kb = smem_u32(&bar_kv);
      mbar_expect_tx(kb, 2 * S::KV_BYTES);
      tma_tile<D, BK>(sK, &tk, kb, k0, h, b);
      tma_tile<D, BK>(sV, &tv, kb, k0, h, b);
    }
    const float* lse = p.lse + (long long)bh * p.Sq;
    const float* delta = p.delta + (long long)bh * p.Sq;
    for (int j = 0; j < n_qt; ++j) {
      const int s = j % STAGES;
      const int q0 = (qt0 + j) * BQ;
      mbar_wait(smem_u32(&empty[s]), ((j / STAGES) & 1) ^ 1);
      for (int c = lane; c < BQ; c += 32) {
        const bool ok = q0 + c < p.Sq;
        s_lse[s][c] = ok ? lse[q0 + c] * LOG2E : 0.f;
        s_dl[s][c] = ok ? delta[q0 + c] : 0.f;
      }
      const uint32_t fb = smem_u32(&full[s]);
      if (lane == 0) {
        mbar_expect_tx(fb, S::STAGE_BYTES);
        const uint32_t st = sQD + s * S::STAGE_BYTES;
        tma_tile<D, BQ>(st, &tq, fb, q0, h, b);
        tma_tile<D, BQ>(st + S::Q_BYTES, &tdo, fb, q0, h, b);
      } else {
        mbar_arrive(fb);
      }
    }
    return;
  }

  // the consumer warpgroup
  const Rows r{k0 + 16 * warp + lane / 4, k0 + 16 * warp + lane / 4 + 8,
               2 * (lane % 4)};
  float dk[D / 2], dv[D / 2], sc[BQ / 2], dp[BQ / 2];
  uint32_t pt[BQ / 16][4], ds[BQ / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  mbar_wait(smem_u32(&bar_kv), 0);
  for (int j = 0; j < n_qt; ++j) {
    const int s = j % STAGES;
    const int q0 = (qt0 + j) * BQ;
    const uint32_t sQ = sQD + s * S::STAGE_BYTES;
    const uint32_t sDO = sQ + S::Q_BYTES;
    mbar_wait(smem_u32(&full[s]), (j / STAGES) & 1);
    wgmma_fence();
    st_and_dpt<D>(sc, dp, sK, sV, sQ, sDO);
    wgmma_wait<1>();  // S^T is in, dP^T may still run
    fence_regs(sc);
    probs(sc, s_lse[s], r, q0, k0, p);
    pack(pt, sc);
    fence_regs(dv);
    wgmma_fence();
    times_tile<D>(dv, pt, sDO);  // dV += P^T.dO
    wgmma_wait<1>();  // dP^T is in, dV's product may still run
    fence_regs(dp);
    grad_scores(sc, dp, s_dl[s], r.cq);
    pack(ds, sc);
    fence_regs(dk);
    wgmma_fence();
    times_tile<D>(dk, ds, sQ);  // dK += dS^T.Q
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }

  // epilogue: dK = scale * acc and dV in bf16, contiguous [B, Sk, H, D]
  const long long rs = (long long)p.H * D;
  const long long off = ((long long)b * p.Sk + r.a) * rs + h * D;
  __nv_bfloat16* ka = p.dk + off;
  __nv_bfloat16* va = p.dv + off;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + r.cq;
    if (r.a < p.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(ka + col) = __floats2bfloat162_rn(
          dk[4 * i] * p.scale, dk[4 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(va + col) =
          __floats2bfloat162_rn(dv[4 * i], dv[4 * i + 1]);
    }
    if (r.b < p.Sk) {
      *reinterpret_cast<__nv_bfloat162*>(ka + 8 * rs + col) =
          __floats2bfloat162_rn(dk[4 * i + 2] * p.scale,
                                dk[4 * i + 3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(va + 8 * rs + col) =
          __floats2bfloat162_rn(dv[4 * i + 2], dv[4 * i + 3]);
    }
  }
}

template <int D>
int launch(const void* const* in, const Params& p, int B,
           const long long* st, cudaStream_t stream) {
  using S = Smem<D>;
  // above 48 KB a block's shared memory must be opted into: once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv, tdo;
  int e = encode_bshd<D>(&tq, in[0], B, p.Sq, p.H, st[0], st[1], st[2], BQ);
  if (!e) e = encode_bshd<D>(&tk, in[1], B, p.Sk, p.H, st[3], st[4], st[5], BK);
  if (!e) e = encode_bshd<D>(&tv, in[2], B, p.Sk, p.H, st[6], st[7], st[8], BK);
  if (!e)
    e = encode_bshd<D>(&tdo, in[3], B, p.Sq, p.H, st[9], st[10], st[11], BQ);
  if (e) return e;
  const dim3 grid(B * p.H, (p.Sk + BK - 1) / BK);
  flash_bwd_dkv_sm90_kernel<D>
      <<<grid, THREADS, S::BYTES, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype must be 1 (bfloat16). q/k/v/dout are [B, S, H, D] with the head
// dim contiguous, 16-byte aligned bases and the given element strides for
// batch, seq and head (multiples of 8; dout has q's shape); lse and delta
// are contiguous float32 [B, H, Sq]. Writes dk and dv, contiguous bf16
// [B, Sk, H, D]. Returns the cudaError_t of the launch, or
// sm90::ENCODE_ERROR + the CUresult of a failed tensor-map encode.
int paddle_flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int dtype, int B, int H, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  const void* in[4] = {q, k, v, dout};
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(in, p, B, st, s);
    case 64: return launch<64>(in, p, B, st, s);
    case 128: return launch<128>(in, p, B, st, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* paddle_cuda_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
