// Flash-attention forward for Hopper tensor cores (sm_90a), bf16 inputs,
// plain C entry point.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// paddle_tpu/kernels/flash_attention.py (launched by `_flash_fwd`'s
// pallas_call) for bfloat16 q/k/v: online-softmax attention that writes O
// (bf16) and the per-row logsumexp (f32), with keys >= Sk masked and,
// under `causal`, q_pos >= k_pos applied and the key loop stopped at the
// diagonal tile. float32 inputs keep the CUDA-core kernel of
// flash_attention_fwd.cu, whose f32 products the tensor cores would run as
// TF32.
//
// What bounds it. GPT-small trained at S = 1024 (B*H = 8*12, D = 64,
// causal) needs ~12.9 GFLOP of QK^T and PV against ~50 MB of q/k/v/O/lse
// traffic: ~13 us of bf16 tensor-core work at 989 TFLOP/s and ~15 us of
// bytes at 3.35 TB/s, so the card's floor is about equal in both. The
// CUDA-core kernel ran its products in f32 at 67 TFLOP/s peak, widened
// every bf16 tile to f32 in shared memory, loaded synchronously and passed
// P through shared memory. On the tensor cores the next limit is the
// softmax: one ex2 per score on the SFUs (16 a clock an SM) takes as long
// as a D = 64 tile's two products, and its FP32 instructions come on top.
// So the design keeps the softmax to one FFMA, one ex2, a max and an add a
// score, and runs it while the tensor cores work.
//
// Design.
//  * Tiles: a block is one consumer warpgroup that owns 64 query rows (the
//    unit of wgmma) and streams BK-key K/V tiles (BK = 128 for D <= 64, 64
//    for D = 128, whose O accumulator is twice as wide), plus one producer
//    warp. Two blocks share an SM. 64-row blocks give 1536, 768 and 192
//    blocks at the trained shape and served buckets 4 and 1 (132 SMs); on
//    the card, blocks of two warpgroups sharing each K/V tile (128 rows)
//    were slower at all three shapes: the warpgroups wait for each other at
//    every shared stage. Longest causal tiles first.
//  * Staging: TMA, not cp.async. The producer warp (its lane 0) loads Q
//    once and K/V tiles into a 3-stage ring with full/empty mbarriers, so
//    the copies of the next tiles run while the consumers compute; the copy
//    costs the consumers no registers or instructions, and TMA writes the
//    128- or 64-byte swizzle that wgmma reads (sm90.cuh). The tensor maps
//    are 4-D views (D, H, S, B) over the caller's strides, so the model's
//    q/k/v views of its fused QKV are read in place, and rows past the end
//    arrive as zeros: no padding copy. The encoder, libcuda's
//    cuTensorMapEncodeTiled, is looked up through the CUDA runtime at
//    first use, so the library needs no -lcuda.
//  * S = Q.K^T is an m64nBKk16 wgmma per 16 columns of D, Q and K (K-major,
//    its [keys, D] rows as they stand) from shared memory, f32 accumulate.
//  * The softmax scale multiplies the f32 scores inside the exponent
//    (base 2: exp2(s * scale log2 e - m * scale log2 e), one FFMA); Q is
//    never scaled in bf16. The online softmax runs on the accumulator
//    fragment: a thread holds two rows, so row max and sum take two shuffles
//    (lanes ^1, ^2).
//  * P is rounded to bf16 in registers and is the register A operand of
//    O += P.V: the accumulator's layout for columns 16j..16j+15 is the A
//    fragment of k-step j, so P never touches shared memory. V is the
//    MN-major (transposed) B operand.
//  * Software pipeline: S of tile j + 1 and P.V of tile j are issued
//    together, and the softmax of tile j + 1 runs while P.V of tile j is on
//    the tensor cores; O is rescaled once P.V has landed. The loop body
//    issues every product unconditionally (the last P.V is peeled off): a
//    wgmma issued under a branch made ptxas wait after every instruction.
//  * O is written in bf16, contiguous [B, Sq, H, D]; lse in f32 [B, H, Sq].
//  * cudaFuncSetAttribute runs once per instantiation, not per launch.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;  // query rows of a block: one consumer warpgroup
constexpr int STAGES = 3;
constexpr int THREADS = 128 + 32;  // the warpgroup and the producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* o;
  float* lse;
  int H, Sq, Sk, causal;
  float scale_log2;  // softmax scale * log2(e): the kernel works in base 2
};

template <int D>
struct Smem {
  static constexpr int BK = D == 128 ? 64 : 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // + 1024 to align the tiles to the swizzle atom
  static constexpr int BYTES = Q_BYTES + STAGES * STAGE_BYTES + 1024;
};

// This thread's two query rows and their running max and sum.
struct Rows {
  int first, a, b, cq;  // the block's first row, this thread's two rows
  float m_a, m_b, l_a, l_b;
};

// S = Q.K^T for the block's 64 rows and the K tile at sK, one group.
template <int D, int BK>
__device__ __forceinline__ void qk(float (&sc)[BK / 2], uint32_t sQ,
                                   uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<BK>::template ss<0>(sc, desc_kmajor<D, BQ>(sQ, kk),
                              desc_kmajor<D, BK>(sK, kk), kk > 0);
  wgmma_commit();
}

// O += P.V, P from registers and the V tile at sV read transposed, one
// group.
template <int D, int BK>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   const uint32_t (&pa)[BK / 16][4],
                                   uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<D>::template rs<1>(o, pa[kk], desc_mnmajor<D, BK>(sV, kk), 1);
  wgmma_commit();
}

// Mask and the online-softmax update of the score tile at key k0, in
// place: sc becomes P = exp2(s * scale log2e - m_new * scale log2e), one
// FFMA and one ex2 a score, and corr the factor for the rows' O and sum.
// The running max m is kept in unscaled score units.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], Rows& r,
                                             int k0, const Params& p,
                                             float& corr_a, float& corr_b) {
  if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > r.first)) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * i + r.cq + (e & 1);
        const int row = e < 2 ? r.a : r.b;
        if (col >= p.Sk || (p.causal && col > row))
          sc[4 * i + e] = -INFINITY;
      }
    }
  }
  float mx_a = r.m_a, mx_b = r.m_b;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * i + 0], sc[4 * i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  // a row with nothing unmasked yet keeps exp2(-inf - 0) = 0
  const float base_a = mx_a == -INFINITY ? 0.f : mx_a * p.scale_log2;
  const float base_b = mx_b == -INFINITY ? 0.f : mx_b * p.scale_log2;
  corr_a = ex2(fmaf(r.m_a, p.scale_log2, -base_a));
  corr_b = ex2(fmaf(r.m_b, p.scale_log2, -base_b));
  r.m_a = mx_a;
  r.m_b = mx_b;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    sc[4 * i + 0] = ex2(fmaf(sc[4 * i + 0], p.scale_log2, -base_a));
    sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], p.scale_log2, -base_a));
    sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], p.scale_log2, -base_b));
    sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], p.scale_log2, -base_b));
    rs_a += sc[4 * i + 0] + sc[4 * i + 1];
    rs_b += sc[4 * i + 2] + sc[4 * i + 3];
  }
  r.l_a = r.l_a * corr_a + rs_a;
  r.l_b = r.l_b * corr_b + rs_b;
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], float corr_a,
                                        float corr_b) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    o[4 * i + 0] *= corr_a;
    o[4 * i + 1] *= corr_a;
    o[4 * i + 2] *= corr_b;
    o[4 * i + 3] *= corr_b;
  }
}

// P (f32 fragment) to the bf16 A fragments of the k-steps of P.V.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    pa[i / 2][2 * (i % 2) + 0] = pack_bf16(sc[4 * i + 0], sc[4 * i + 1]);
    pa[i / 2][2 * (i % 2) + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params p) {
  using S = Smem<D>;
  constexpr int BK = S::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full[STAGES], empty[STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + S::Q_BYTES;

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
      mbar_expect_tx(smem_u32(&bar_q), S::Q_BYTES);
      tma_tile<D, BQ>(sQ, &tq, smem_u32(&bar_q), q0, h, b);
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

  // the consumer warpgroup
  Rows r;
  r.first = q0;
  r.a = q0 + 16 * warp + lane / 4;  // this thread's two rows
  r.b = r.a + 8;
  r.cq = 2 * (lane % 4);  // first of this thread's column pairs
  r.m_a = r.m_b = -INFINITY;
  r.l_a = r.l_b = 0.f;

  float o[D / 2], sc[BK / 2], corr_a, corr_b;
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  mbar_wait(smem_u32(&bar_q), 0);
  mbar_wait(smem_u32(&full[0]), 0);
  wgmma_fence();
  qk<D, BK>(sc, sQ, sKV);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_tile<BK>(sc, r, 0, p, corr_a, corr_b);
  pack_p<BK>(pa, sc);
  for (int j = 0; j + 1 < n_kt; ++j) {
    const uint32_t sV = sKV + (j % STAGES) * S::STAGE_BYTES + S::KV_BYTES;
    const uint32_t sK1 = sKV + ((j + 1) % STAGES) * S::STAGE_BYTES;
    mbar_wait(smem_u32(&full[(j + 1) % STAGES]), ((j + 1) / STAGES) & 1);
    fence_regs(o);
    wgmma_fence();
    qk<D, BK>(sc, sQ, sK1);
    pv<D, BK>(o, pa, sV);
    wgmma_wait<1>();  // S of tile j + 1 is in, P.V of tile j may run
    fence_regs(sc);
    softmax_tile<BK>(sc, r, (j + 1) * BK, p, corr_a, corr_b);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[j % STAGES]));
    rescale<D>(o, corr_a, corr_b);
    pack_p<BK>(pa, sc);
  }
  const int last = n_kt - 1;
  fence_regs(o);
  wgmma_fence();
  pv<D, BK>(o, pa, sKV + (last % STAGES) * S::STAGE_BYTES + S::KV_BYTES);
  wgmma_wait<0>();
  fence_regs(o);

  // epilogue: O = acc / l, lse = ln(sum exp(scaled logits))
  float l_a = r.l_a, l_b = r.l_b;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float ls_a = fmaxf(l_a, 1e-30f), ls_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / ls_a, inv_b = 1.f / ls_b;
  const long long rs = (long long)p.H * D;  // O's row stride
  __nv_bfloat16* oa = p.o + ((long long)b * p.Sq + r.a) * rs + h * D;
  __nv_bfloat16* ob = oa + 8 * rs;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + r.cq;
    if (r.a < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(oa + col) =
          __floats2bfloat162_rn(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
    if (r.b < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + col) =
          __floats2bfloat162_rn(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
  }
  if (lane % 4 == 0) {
    float* lse = p.lse + (long long)bh * p.Sq;
    if (r.a < p.Sq) lse[r.a] = fmaf(r.m_a, p.scale_log2, log2f(ls_a)) * LN2;
    if (r.b < p.Sq) lse[r.b] = fmaf(r.m_b, p.scale_log2, log2f(ls_b)) * LN2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int B, const long long* st, cudaStream_t stream) {
  using S = Smem<D>;
  // above 48 KB a block's shared memory must be opted into: once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::BYTES);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  int e = encode_bshd<D>(&tq, q, B, p.Sq, p.H, st[0], st[1], st[2], BQ);
  if (!e) e = encode_bshd<D>(&tk, k, B, p.Sk, p.H, st[3], st[4], st[5], S::BK);
  if (!e) e = encode_bshd<D>(&tv, v, B, p.Sk, p.H, st[6], st[7], st[8], S::BK);
  if (e) return e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  flash_fwd_sm90_kernel<D><<<grid, THREADS, S::BYTES, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype must be 1 (bfloat16). q/k/v are [B, S, H, D] with the head dim
// contiguous, 16-byte aligned bases and the given element strides for
// batch, seq and head (multiples of 8); o is a contiguous bf16
// [B, Sq, H, D], lse a contiguous float32 [B, H, Sq]. Returns the
// cudaError_t of the launch, or sm90::ENCODE_ERROR + the CUresult of a
// failed tensor-map encode.
int paddle_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int H, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.scale_log2 = scale * LOG2E;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, p, B, st, s);
    case 64: return launch<64>(q, k, v, p, B, st, s);
    case 128: return launch<128>(q, k, v, p, B, st, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* paddle_cuda_error_string(int err) {
  return sm90::error_string(err);
}

}  // extern "C"
