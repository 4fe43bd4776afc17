// Flash-attention forward for Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// paddle_tpu/kernels/flash_attention.py (launched by `_flash_fwd`'s
// pallas_call): online-softmax attention that writes O and the per-row
// logsumexp, with keys >= Sk masked and, under `causal`, q_pos >= k_pos
// applied and the key loop stopped at the diagonal tile.
//
// What bounds it. GPT-small served at S = 1024 (B*H = 4*12, D = 64, bf16,
// causal) needs ~6.45 GFLOP of QK^T and PV against ~25.4 MB of q/k/v/o/lse
// traffic, ~254 FLOP per byte: just under the card's bf16 ridge (~295), so
// the roofline floor is the bytes (~7.6 us at 3.35 TB/s) once the S x S
// score matrix stays on chip. The TPU kernel holds a head's whole K/V in
// VMEM; an SM has at most 227 KB of shared memory, so here one block owns a
// 64-query tile and streams 64-key K/V tiles through shared memory,
// keeping the running max/sum and the O accumulator in registers. Nothing
// of size S x S touches device memory. This first version does its math in
// f32 on the CUDA cores, so what bounds it in practice is the f32 FMA rate
// (67 TFLOP/s peak, ~96 us for the same work) and shared-memory reads.
//
// Design (first, simple version). Arithmetic is f32 on the CUDA cores for
// both f32 and bf16 inputs (bf16 is widened on load), so one code path
// serves both dtypes and f32 inputs keep f32 accuracy. 256 threads form a
// 16 x 16 grid; each thread computes a 4-row x 4-column piece of the 64 x 64
// score tile (columns strided by 16, conflict-free float4 reads of K) and
// the matching 4 rows x D/16 columns of O. Row max/sum reductions use warp
// shuffles inside the 16 lanes that share a row. The causal grid walks the
// longest query tiles first. The kernel reads q/k/v through their
// [B, S, H, D] strides (head dim contiguous), so the views the model cuts
// out of its fused QKV projection need no copy, and masks the ragged edge
// itself: no padding to a tile multiple. Tensor cores (mma.sync / wgmma)
// and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per streamed tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int TX = 16;        // threads sharing one group of rows
constexpr int ROWS = 4;       // query rows per thread
constexpr int COLS = 4;       // score columns per thread
constexpr int LDP = BK + 4;   // row stride of the probability tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, Sq, Sk, causal;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale_log2;  // softmax scale * log2(e): the kernel works in base 2
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 4;
  constexpr int DC = D / TX;  // O columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

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

  load_tile<T, D>(sQ, qp, p.q_ss, q0, p.Sq, p.scale_log2);

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;  // this thread's share of the row sum
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

    // scores s[i][j] = Q[row i] . K[col j], col j = tx + 16 * j
    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty * ROWS + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + TX * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + ty * ROWS + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kpos = k0 + tx + TX * j;
        const bool ok = kpos < p.Sk && (!p.causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float pij = s[i][j] > 0.5f * NEG_INF ? exp2f(s[i][j] - m_new)
                                                   : 0.f;
        rs += pij;
        sP[(ty * ROWS + i) * LDP + tx + TX * j] = pij;
      }
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // O[row i][col c] += sum_k P[row i][k] * V[k][col c], col c = tx + 16c
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(ty * ROWS + i) * LDP + kk]);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + TX * c;
        const float v0 = sV[(kk + 0) * LD + col];
        const float v1 = sV[(kk + 1) * LD + col];
        const float v2 = sV[(kk + 2) * LD + col];
        const float v3 = sV[(kk + 3) * LD + col];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          acc[i][c] = fmaf(pv[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(pv[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(pv[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(pv[i].w, v3, acc[i][c]);
        }
      }
    }
  }

  // epilogue: O = acc / l, lse = ln(sum exp(scaled logits))
  T* op = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int qpos = q0 + ty * ROWS + i;
    if (qpos >= p.Sq) continue;
    const float ls = fmaxf(li, 1e-30f);
    const float inv = 1.f / ls;
    T* orow = op + (((long long)b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + TX * c, acc[i][c] * inv);
    if (tx == 0)
      p.lse[(long long)bh * p.Sq + qpos] = (m[i] + log2f(ls)) * LN2;
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const int smem = (BQ * LD + 2 * BK * LD + BQ * LDP) * (int)sizeof(float);
  // above 48 KB a block's shared memory must be opted into, per device
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/k/v are [B, S, H, D] with the head
// dim contiguous and the given element strides for batch, seq and head;
// o is a contiguous [B, Sq, H, D] of the same dtype, lse a contiguous
// float32 [B, H, Sq]. Returns the cudaError_t of the launch.
int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int H, int Sq, int Sk, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(p, B, D, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, B, D, s);
  return cudaErrorInvalidValue;
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
