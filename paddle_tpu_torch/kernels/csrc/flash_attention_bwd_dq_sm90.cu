// Flash-attention dQ for Hopper tensor cores (sm_90a), bf16 inputs, with
// Delta = rowsum(O o dO) folded in; plain C entry point.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` in
// paddle_tpu/kernels/flash_attention.py (the first pallas_call of
// `_flash_bwd`) and the Delta that `_flash_bwd` computes before it, for
// bfloat16 inputs: per query tile, Delta from the tile's O and dO rows,
// then over the key tiles up to the diagonal P = exp(S - lse) under the
// forward's masks, dS = P o (dO.V^T - Delta) and dQ = scale * sum dS.K.
// Delta is written out as f32 [B, H, Sq] for the dK/dV kernel. float32
// inputs keep the CUDA-core kernel of flash_attention_bwd.cu.
//
// What bounds it. GPT-small trained at S = 1024 (B*H = 8*12, D = 64,
// causal) asks for three causal-half products (S, dP, dQ; ~19.3 GFLOP,
// ~20 us at 989 TFLOP/s) against ~66 MB of q/k/v/O/dO/lse/dQ/Delta
// traffic (~20 us at 3.35 TB/s). The CUDA-core kernel ran those products
// in f32 (67 TFLOP/s peak), widened every tile to f32 in shared memory and
// loaded synchronously; Delta was a separate torch pass over O and dO.
// Here the tensor cores' issue rate, one ex2 per score and each key tile's
// dependent chain (S and dP -> dS -> dQ) are what remain.
//
// Design (the forward's scheme, sm90.cuh):
//  * A block is one consumer warpgroup that owns 64 query rows, plus a
//    producer warp, and streams 64-key K/V tiles: the S, dP and dQ
//    accumulators (32 f32 each at D = 64) and dS in bf16 stay in registers,
//    and two blocks share an SM. As in the forward, two warpgroups sharing
//    each K/V tile were slower on the card; so was issuing the next tile's
//    S and dP beside this tile's dQ product (the forward's pipeline), which
//    costs registers without a gain here.
//  * TMA staging: the producer warp loads Q and dO once and K/V tiles into
//    a 3-stage ring with full/empty mbarriers; the maps are 4-D views over
//    the caller's strides, rows past the end arrive as zeros.
//  * Delta: at its start each thread reads a quarter of its two rows of O
//    and dO from global memory (16-byte loads), sums in f32 and reduces
//    over the 4 lanes that share the rows (two shuffles); the row owner
//    writes it out.
//  * S = Q.K^T and dP = dO.V^T are wgmma from shared memory (K and V
//    K-major as they stand), committed as two groups so that P's ex2 runs
//    while dP is still in flight. The scale multiplies the f32 scores,
//    never Q in bf16: P = exp2(S * scale * log2 e - lse * log2 e), one FFMA
//    and one ex2 a score.
//  * dS = P o (dP - Delta) is rounded to bf16 in registers and is the
//    register A operand of dQ += dS.K, K the transposed (MN-major) B.
//  * dQ is scaled and written in bf16. Every dQ element has one owner block:
//    no atomics.
//  * cudaFuncSetAttribute runs once per instantiation, not per launch.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;  // query rows of a block: one consumer warpgroup
constexpr int BK = 64;  // keys of a streamed K/V tile
constexpr int STAGES = 3;
constexpr int THREADS = 128 + 32;  // the warpgroup and the producer warp
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // [B, H, Sq] natural-log logsumexp of the forward
  __nv_bfloat16* dq;
  float* delta;      // [B, H, Sq] out: rowsum(O o dO)
  int H, Sq, Sk, causal;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
};

template <int D>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;  // one of Q, dO
  static constexpr int KV_BYTES = BK * D * 2;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // + 1024 to align the tiles to the swizzle atom
  static constexpr int BYTES = 2 * Q_BYTES + STAGES * STAGE_BYTES + 1024;
};

// The sum over this thread's quarter of row `row` of O o dO (0 past Sq).
template <int D>
__device__ __forceinline__ float row_dot(const Params& p, int b, int h,
                                         int row, int quarter) {
  if (row >= p.Sq) return 0.f;
  const __nv_bfloat16* o =
      p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh + quarter * (D / 4);
  const __nv_bfloat16* g =
      p.dout + b * p.do_sb + row * p.do_ss + h * p.do_sh + quarter * (D / 4);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 4; c += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 gf = __bfloat1622float2(g2[e]);
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
    }
  }
  return acc;
}

// This thread's two query rows with their lse (base 2) and Delta.
struct Rows {
  int first, a, b, cq;  // the block's first row, this thread's two rows
  float lse_a, lse_b, dl_a, dl_b;
};

// S = Q.K^T and dP = dO.V^T for the block's 64 rows, committed as two
// groups (S first).
template <int D>
__device__ __forceinline__ void s_and_dp(float (&sc)[BK / 2],
                                         float (&dp)[BK / 2], uint32_t sQ,
                                         uint32_t sDO, uint32_t sK,
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<BK>::template ss<0>(sc, desc_kmajor<D, BQ>(sQ, kk),
                              desc_kmajor<D, BK>(sK, kk), kk > 0);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<BK>::template ss<0>(dp, desc_kmajor<D, BQ>(sDO, kk),
                              desc_kmajor<D, BK>(sV, kk), kk > 0);
  wgmma_commit();
}

// In place: S of the tile at key k0 -> P = exp2(S scale log2e - lse log2e)
// under the forward's masks.
__device__ __forceinline__ void probs(float (&sc)[BK / 2], const Rows& r,
                                      int k0, const Params& p) {
  const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > r.first);
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ra = e < 2;
      float pr = ex2(fmaf(sc[4 * i + e], p.scale_log2,
                          -(ra ? r.lse_a : r.lse_b)));
      if (edge) {
        const int col = k0 + 8 * i + r.cq + (e & 1);
        if (col >= p.Sk || (p.causal && col > (ra ? r.a : r.b))) pr = 0.f;
      }
      sc[4 * i + e] = pr;
    }
  }
}

// In place: P -> dS = P o (dP - Delta).
__device__ __forceinline__ void grad_scores(float (&sc)[BK / 2],
                                            const float (&dp)[BK / 2],
                                            const Rows& r) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    sc[4 * i + 0] *= dp[4 * i + 0] - r.dl_a;
    sc[4 * i + 1] *= dp[4 * i + 1] - r.dl_a;
    sc[4 * i + 2] *= dp[4 * i + 2] - r.dl_b;
    sc[4 * i + 3] *= dp[4 * i + 3] - r.dl_b;
  }
}

// dQ += dS.K, dS from registers and the K tile at sK read transposed,
// one group.
template <int D>
__device__ __forceinline__ void ds_k(float (&dq)[D / 2],
                                     const uint32_t (&ds)[BK / 16][4],
                                     uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<D>::template rs<1>(dq, ds[kk], desc_mnmajor<D, BK>(sK, kk), 1);
  wgmma_commit();
}

// dS (f32 fragment) to the bf16 A fragments of the k-steps of dS.K.
__device__ __forceinline__ void pack_ds(uint32_t (&ds)[BK / 16][4],
                                        const float (&sc)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    ds[i / 2][2 * (i % 2) + 0] = pack_bf16(sc[4 * i + 0], sc[4 * i + 1]);
    ds[i / 2][2 * (i % 2) + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const Params p) {
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full[STAGES], empty[STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sDO = base + S::Q_BYTES;
  const uint32_t sKV = base + 2 * S::Q_BYTES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qt * BQ;
  int n_kt = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bar_q), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      const uint32_t qb = smem_u32(&bar_q);
      mbar_expect_tx(qb, 2 * S::Q_BYTES);
      tma_tile<D, BQ>(sQ, &tq, qb, q0, h, b);
      tma_tile<D, BQ>(sDO, &tdo, qb, q0, h, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % STAGES;
        mbar_wait(smem_u32(&empty[s]), ((j / STAGES) & 1) ^ 1);
        const uint32_t fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, S::STAGE_BYTES);
        const uint32_t st = sKV + s * S::STAGE_BYTES;
        tma_tile<D, BK>(st, &tk, fb, j * BK, h, b);
        tma_tile<D, BK>(st + S::KV_BYTES, &tv, fb, j * BK, h, b);
      }
    }
    return;
  }

  // the consumer warpgroup; Delta of this thread's two rows while the
  // producer's first loads are in flight
  const int row_a = q0 + 16 * warp + lane / 4;
  const int row_b = row_a + 8;
  float dl_a = row_dot<D>(p, b, h, row_a, lane % 4);
  float dl_b = row_dot<D>(p, b, h, row_b, lane % 4);
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    dl_a += __shfl_xor_sync(0xffffffffu, dl_a, off);
    dl_b += __shfl_xor_sync(0xffffffffu, dl_b, off);
  }
  const float* lse = p.lse + (long long)bh * p.Sq;
  const float lse_a = row_a < p.Sq ? lse[row_a] * LOG2E : 0.f;
  const float lse_b = row_b < p.Sq ? lse[row_b] * LOG2E : 0.f;
  if (lane % 4 == 0) {
    float* delta = p.delta + (long long)bh * p.Sq;
    if (row_a < p.Sq) delta[row_a] = dl_a;
    if (row_b < p.Sq) delta[row_b] = dl_b;
  }
  const Rows r{q0, row_a, row_b, 2 * (lane % 4), lse_a, lse_b, dl_a, dl_b};

  float dq[D / 2], sc[BK / 2], dp[BK / 2];
  uint32_t ds[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(smem_u32(&bar_q), 0);
  for (int j = 0; j < n_kt; ++j) {
    const uint32_t sK = sKV + (j % STAGES) * S::STAGE_BYTES;
    mbar_wait(smem_u32(&full[j % STAGES]), (j / STAGES) & 1);
    wgmma_fence();
    s_and_dp<D>(sc, dp, sQ, sDO, sK, sK + S::KV_BYTES);
    wgmma_wait<1>();  // S is in, dP may still run
    fence_regs(sc);
    probs(sc, r, j * BK, p);
    wgmma_wait<0>();
    fence_regs(dp);
    grad_scores(sc, dp, r);
    pack_ds(ds, sc);
    fence_regs(dq);
    wgmma_fence();
    ds_k<D>(dq, ds, sK);
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[j % STAGES]));
  }

  // epilogue: dQ = scale * acc in bf16, contiguous [B, Sq, H, D]
  const long long rs = (long long)p.H * D;
  __nv_bfloat16* qa = p.dq + ((long long)b * p.Sq + row_a) * rs + h * D;
  __nv_bfloat16* qb = qa + 8 * rs;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + r.cq;
    if (row_a < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(qa + col) = __floats2bfloat162_rn(
          dq[4 * i] * p.scale, dq[4 * i + 1] * p.scale);
    if (row_b < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(qb + col) = __floats2bfloat162_rn(
          dq[4 * i + 2] * p.scale, dq[4 * i + 3] * p.scale);
  }
}

template <int D>
int launch(const void* const* in, const Params& p, int B,
           const long long* st, cudaStream_t stream) {
  using S = Smem<D>;
  // above 48 KB a block's shared memory must be opted into: once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv, tdo;
  int e = encode_bshd<D>(&tq, in[0], B, p.Sq, p.H, st[0], st[1], st[2], BQ);
  if (!e) e = encode_bshd<D>(&tk, in[1], B, p.Sk, p.H, st[3], st[4], st[5], BK);
  if (!e) e = encode_bshd<D>(&tv, in[2], B, p.Sk, p.H, st[6], st[7], st[8], BK);
  if (!e)
    e = encode_bshd<D>(&tdo, in[3], B, p.Sq, p.H, st[12], st[13], st[14], BQ);
  if (e) return e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  flash_bwd_dq_sm90_kernel<D>
      <<<grid, THREADS, S::BYTES, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype must be 1 (bfloat16). q/k/v/o/dO are [B, S, H, D] with the head
// dim contiguous, 16-byte aligned bases and the given element strides
// for batch, seq and head (multiples of 8); lse is a contiguous float32
// [B, H, Sq]. Writes dq, a contiguous bf16 [B, Sq, H, D], and delta, a
// contiguous float32 [B, H, Sq]. Returns the cudaError_t of the launch, or
// sm90::ENCODE_ERROR + the CUresult of a failed tensor-map encode.
int paddle_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta,
    int dtype, int B, int H, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.delta = static_cast<float*>(delta);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  const void* in[4] = {q, k, v, dout};
  const long long st[15] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                            do_sb, do_ss, do_sh};
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
