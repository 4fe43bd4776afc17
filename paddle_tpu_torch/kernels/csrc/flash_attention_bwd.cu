// Flash-attention backward for Hopper (sm_90a), plain C entry points.
//
// Replaces the two Pallas TPU kernels of `_flash_bwd` in
// paddle_tpu/kernels/flash_attention.py:
//   * `_bwd_dq_kernel`  -> flash_bwd_dq_kernel: per 64-row query tile,
//     recompute P = exp(S - lse) tile by tile under the forward's masks,
//     form dS = P o (dO.V^T - Delta) and accumulate dQ = scale * dS.K;
//   * `_bwd_dkv_kernel` -> flash_bwd_dkv_kernel: per 64-row key tile, loop
//     over the query tiles from the causal start and accumulate
//     dV += P^T.dO and dK += dS^T.(scale * Q), masking query rows >= Sq.
// Delta = rowsum(O o dO) and lse come in as float32 [B, H, Sq] (the wrapper
// computes Delta, as the reference does outside its pallas_calls). Like the
// reference this keeps the two-kernel split: every output element has one
// owner block, so there are no atomics and the gradients are the same from
// run to run.
//
// What bounds it. GPT-small trained at S = 1024 (B*H = 8*12, D = 64, bf16,
// causal) asks the dQ kernel for three causal-half products (S, dP, dQ;
// ~19.3 GFLOP) against ~64 MB of q/k/v/dO/lse/Delta/dQ traffic, and the
// dK/dV kernel for four (S, dP, dV, dK; ~25.8 GFLOP) against ~77 MB:
// ~300-335 FLOP per byte, at the card's bf16 ridge (~295), so bytes and
// operations bound it about equally (~20-25 us each) once nothing of size
// S x S touches device memory. The TPU kernels keep a head's whole K/V (dQ)
// or Q/dO/lse/Delta (dK/dV) in VMEM; an SM has at most 227 KB of shared
// memory, so here one block owns a 64-row tile and streams the other side
// through shared memory in 64-row tiles. This first version does its math
// in f32 on the CUDA cores (67 TFLOP/s peak), so what bounds it in
// practice is the f32 FMA rate and shared-memory reads, as in the forward.
//
// Design (first, simple version; the forward's scheme). Arithmetic is f32
// for f32 and bf16 inputs (bf16 is widened on load). 256 threads form a
// 16 x 16 grid; each thread computes a 4-row x 4-column piece of a 64 x 64
// score tile (columns strided by 16, conflict-free float4 reads) and the
// matching 4 rows x D/16 columns of its accumulators. Q is scaled by
// scale * log2(e) on load so P = exp2(S - lse * log2(e)). q/k/v/dO are
// read through their [B, S, H, D] strides (head dim contiguous), so the
// views the model cuts out of its fused QKV projection need no copy, and
// the ragged edge is masked here: no padding to a tile multiple. dQ, dK
// and dV are written contiguous [B, S, H, D] in the input dtype. The
// causal dQ loop stops at the diagonal key tile; the causal dK/dV loop
// starts at it (the reference's `start_q`). Tensor cores, TMA and warp
// specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int TX = 16;        // threads sharing one group of rows
constexpr int ROWS = 4;       // tile rows per thread
constexpr int COLS = 4;       // score columns per thread
constexpr int LDP = 64 + 4;   // row stride of a 64 x 64 score tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq] natural-log logsumexp of the forward
  const float* delta;  // [B, H, Sq] rowsum(O o dO)
  void* dq;
  void* dk;
  void* dv;
  int H, Sq, Sk, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO's strides
  float scale;       // softmax scale
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of a [S, D] slice (row stride `stride`) into
// shared memory as f32 with row stride D + 4, times `mul`; rows >= n are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int row0, int n,
                                          float mul) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int gr = row0 + r;
    float x = 0.f;
    if (gr < n) x = to_float(src[(long long)gr * stride + c]) * mul;
    dst[r * (D + 4) + c] = x;
  }
}

// acc[i][j] += A[row i] . B[col j] over D for two products at once:
// rows ty * 4 + i of a1/a2, columns tx + 16 * j of b1/b2 (all [64][D + 4]).
template <int D>
__device__ __forceinline__ void two_score_tiles(
    const float* a1, const float* b1, const float* a2, const float* b2,
    int tx, int ty, float (&s1)[ROWS][COLS], float (&s2)[ROWS][COLS]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      s1[i][j] = 0.f;
      s2[i][j] = 0.f;
    }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x1[ROWS], x2[ROWS], y1[COLS], y2[COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      x1[i] = *reinterpret_cast<const float4*>(&a1[(ty * ROWS + i) * LD + d]);
      x2[i] = *reinterpret_cast<const float4*>(&a2[(ty * ROWS + i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      y1[j] = *reinterpret_cast<const float4*>(&b1[(tx + TX * j) * LD + d]);
      y2[j] = *reinterpret_cast<const float4*>(&b2[(tx + TX * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        s1[i][j] = fmaf(x1[i].x, y1[j].x, s1[i][j]);
        s1[i][j] = fmaf(x1[i].y, y1[j].y, s1[i][j]);
        s1[i][j] = fmaf(x1[i].z, y1[j].z, s1[i][j]);
        s1[i][j] = fmaf(x1[i].w, y1[j].w, s1[i][j]);
        s2[i][j] = fmaf(x2[i].x, y2[j].x, s2[i][j]);
        s2[i][j] = fmaf(x2[i].y, y2[j].y, s2[i][j]);
        s2[i][j] = fmaf(x2[i].z, y2[j].z, s2[i][j]);
        s2[i][j] = fmaf(x2[i].w, y2[j].w, s2[i][j]);
      }
  }
}

// acc[i][c] += sum_r P[row i][r] * M[r][col c] over the 64 rows r of a
// score tile P ([64][LDP]) and a [64][D + 4] tile M; rows ty * 4 + i,
// columns tx + 16 * c.
template <int D>
__device__ __forceinline__ void tile_times_rows(const float* P,
                                                const float* M, int tx,
                                                int ty,
                                                float (&acc)[ROWS][D / TX]) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int r = 0; r < 64; r += 4) {
    float4 pv[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      pv[i] = *reinterpret_cast<const float4*>(&P[(ty * ROWS + i) * LDP + r]);
#pragma unroll
    for (int c = 0; c < D / TX; ++c) {
      const int col = tx + TX * c;
      const float m0 = M[(r + 0) * LD + col];
      const float m1 = M[(r + 1) * LD + col];
      const float m2 = M[(r + 2) * LD + col];
      const float m3 = M[(r + 3) * LD + col];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        acc[i][c] = fmaf(pv[i].x, m0, acc[i][c]);
        acc[i][c] = fmaf(pv[i].y, m1, acc[i][c]);
        acc[i][c] = fmaf(pv[i].z, m2, acc[i][c]);
        acc[i][c] = fmaf(pv[i].w, m3, acc[i][c]);
      }
    }
  }
}

// One block per (64-row query tile, batch * head): dQ for those rows.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 4;
  constexpr int DC = D / TX;  // dQ columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;           // q * scale * log2(e)
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sdS = sV + BK * LD;  // [BQ][LDP]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* op = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  load_tile<T, D>(sQ, qp, p.q_ss, q0, p.Sq, p.scale_log2);
  load_tile<T, D>(sdO, op, p.o_ss, q0, p.Sq, 1.f);
  float lse2[ROWS], dlt[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + ty * ROWS + i;
    const bool ok = qpos < p.Sq;
    lse2[i] = ok ? p.lse[(long long)bh * p.Sq + qpos] * LOG2E : 0.f;
    dlt[i] = ok ? p.delta[(long long)bh * p.Sq + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, kp, p.k_ss, k0, p.Sk, 1.f);
    load_tile<T, D>(sV, vp, p.v_ss, k0, p.Sk, 1.f);
    __syncthreads();

    // s = Q.K^T (base-2 logits), dp = dO.V^T
    float s[ROWS][COLS], dp[ROWS][COLS];
    two_score_tiles<D>(sQ, sK, sdO, sV, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + ty * ROWS + i;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kpos = k0 + tx + TX * j;
        const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos);
        const float pij = ok ? exp2f(s[i][j] - lse2[i]) : 0.f;
        sdS[(ty * ROWS + i) * LDP + tx + TX * j] = pij * (dp[i][j] - dlt[i]);
      }
    }
    __syncthreads();
    tile_times_rows<D>(sdS, sK, tx, ty, acc);  // dQ += dS.K
  }

  T* dqp = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + ty * ROWS + i;
    if (qpos >= p.Sq) continue;
    T* row = dqp + (((long long)b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(row + tx + TX * c, acc[i][c] * p.scale);
  }
}

// One block per (64-row key tile, batch * head): dK and dV for those rows.
// Score tiles are kept transposed (rows = keys, columns = queries).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 4;
  constexpr int DC = D / TX;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;    // q * scale * log2(e)
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;   // P^T  [BK][LDP]
  float* sdS = sP + BK * LDP;  // dS^T [BK][LDP]
  float* sL = sdS + BK * LDP;  // lse * log2(e) of the query tile
  float* sD = sL + BQ;         // Delta of the query tile

  const int kt = blockIdx.x;  // early key tiles see the most query tiles
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = kt * BK;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* op = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;

  load_tile<T, D>(sK, kp, p.k_ss, k0, p.Sk, 1.f);
  load_tile<T, D>(sV, vp, p.v_ss, k0, p.Sk, 1.f);
  float dk[ROWS][DC], dv[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt_start = p.causal ? k0 / BQ : 0;  // earlier tiles are masked
  for (int qt = qt_start; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sQ, qp, p.q_ss, q0, p.Sq, p.scale_log2);
    load_tile<T, D>(sdO, op, p.o_ss, q0, p.Sq, 1.f);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool ok = q0 + r < p.Sq;
      sL[r] = ok ? p.lse[(long long)bh * p.Sq + q0 + r] * LOG2E : 0.f;
      sD[r] = ok ? p.delta[(long long)bh * p.Sq + q0 + r] : 0.f;
    }
    __syncthreads();

    // st = K.Q^T (base-2 logits, transposed), dpt = V.dO^T
    float st[ROWS][COLS], dpt[ROWS][COLS];
    two_score_tiles<D>(sK, sQ, sV, sdO, tx, ty, st, dpt);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int kpos = k0 + ty * ROWS + i;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = tx + TX * j;
        const int qpos = q0 + col;
        const bool ok = qpos < p.Sq && (!p.causal || qpos >= kpos);
        const float pij = ok ? exp2f(st[i][j] - sL[col]) : 0.f;
        sP[(ty * ROWS + i) * LDP + col] = pij;
        sdS[(ty * ROWS + i) * LDP + col] = pij * (dpt[i][j] - sD[col]);
      }
    }
    __syncthreads();
    tile_times_rows<D>(sP, sdO, tx, ty, dv);  // dV += P^T.dO
    tile_times_rows<D>(sdS, sQ, tx, ty, dk);  // dK += dS^T.(Q scale log2 e)
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kpos = k0 + ty * ROWS + i;
    if (kpos >= p.Sk) continue;
    const long long off = (((long long)b * p.Sk + kpos) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      // sQ carries an extra log2(e); ln(2) takes it out
      store(dkp + off + tx + TX * c, dk[i][c] * LN2);
      store(dvp + off + tx + TX * c, dv[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, bool dkv, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const int tiles = 4 * 64 * LD;  // four [64][D + 4] tiles either way
  const int smem = (dkv ? tiles + 2 * BK * LDP + 2 * BQ : tiles + BQ * LDP)
                   * (int)sizeof(float);
  void (*kernel)(const Params) =
      dkv ? &flash_bwd_dkv_kernel<T, D> : &flash_bwd_dq_kernel<T, D>;
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int rows = dkv ? p.Sk : p.Sq;
  const dim3 grid((rows + 63) / 64, B * p.H);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int B, int D, bool dkv,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, B, dkv, stream);
    case 64: return launch<T, 64>(p, B, dkv, stream);
    case 128: return launch<T, 128>(p, B, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int dtype, int B, int H, int Sq, int Sk, int D,
        long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh,
        long long v_sb, long long v_ss, long long v_sh,
        long long o_sb, long long o_ss, long long o_sh,
        float scale, int causal, void* stream, bool dkv) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(p, B, D, dkv, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, B, D, dkv, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/k/v/dout are [B, S, H, D] with the
// head dim contiguous and the given element strides for batch, seq and
// head (dout has q's shape); lse and delta are contiguous float32
// [B, H, Sq]; dq is a contiguous [B, Sq, H, D] of the input dtype.
// Returns the cudaError_t of the launch.
int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int dtype, int B, int H, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  return run(q, k, v, dout, lse, delta, dq, nullptr, nullptr, dtype, B, H,
             Sq, Sk, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_ss, o_sh, scale, causal, stream, false);
}

// As above; dk and dv are contiguous [B, Sk, H, D] of the input dtype.
int paddle_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int dtype, int B, int H, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  return run(q, k, v, dout, lse, delta, nullptr, dk, dv, dtype, B, H, Sq,
             Sk, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_ss, o_sh, scale, causal, stream, true);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
