// Fused inner scan for Hopper (sm_90a): the whole T-step eval-time
// adaptation of ResNet10's final residual block, enqueued from one C call.
//
// Replaces the TPU kernel mft_tpu/ops/pallas/fused_inner_scan.py:
// fused_inner_scan_lanes (Pallas body _kernel, step math _step_grads and
// _adam_update).  Per step t of lane l: gather the B bank rows idx[l, t, :],
// conv1 3x3 (stride s) + masked batch-stats BN + ReLU, conv2 3x3 + BN, 1x1
// shortcut (stride s) + BN, add, ReLU, global average pool, masked CE on the
// pooled features as logits, the hand-derived backward, torch-Adam with
// bf16-stored moments.  Rounding places are the JAX module's: conv outputs,
// the conv2 input, the pooled features and every dy that enters a product are
// rounded to the compute dtype (the bank's: bf16 or f32), products accumulate
// in f32, BN and the loss are f32, the rounded bf16 moments feed the update.
//
// What bounds it, at BlockGeom(14, 256, 512, 2, 5) (245 rows): operations.
// A step is 4.75 GFLOP of products; what must reach device memory is the
// gathered bank rows (0.5 MB a step) and the parameters once in and once out,
// because the lane's state (7.3 MB of bf16 parameters, 14.7 MB of moments) fits
// the 50 MB L2.  So the bound for 500 steps is 2.4 ms at the bf16 tensor-core
// rate (H100 SXM, 989 TFLOP/s) against under 0.1 ms for the bytes; this first,
// simple form computes on the CUDA cores, whose f32 rate gives 35.5 ms.
//
// Design.  The TPU kernel kept one lane's 22 MB of parameters and moments in
// VMEM on one core; an SM has 227 KB, so here a step is 15 small kernels on
// the caller's stream and the state stays in L2.  The C entry point enqueues
// all T steps of all lanes in a loop: no host step, no synchronisation and no
// allocation between minibatches (the caller hands in one scratch buffer).
//   1-2   conv_gemm   conv1 and the shortcut conv as implicit GEMMs over rows
//                     gathered straight from the bank through idx
//   3     bn_fwd      BN1 statistics + normalise + ReLU (keeps xhat, inv)
//   4     conv_gemm   conv2
//   5-6   bn_fwd      BN2, then the shortcut's BN added to it (pre-activation)
//   7     pool_ce     ReLU + average pool + softmax CE + dlogits, per sample
//   8-9   bn_bwd      pool/ReLU backward + BN2 and shortcut-BN backward
//   10    conv_wgrad  conv2 weight gradient  [9Co, R] @ [R, Co]
//   11    conv_gemm   conv2 input gradient as a gather (flipped taps), so no
//                     scatter and a fixed summation order
//   12    bn_bwd      ReLU + BN1 backward
//   13-14 conv_wgrad  conv1 and shortcut weight gradients
//   15    adam        one pass over all nine tensors (one flat buffer)
// The products are f32 FMAs on 64 x 64 tiles with 4 x 4 register tiles, as in
// edge_mlp.cu.  The three GEMMs with only R = 245 rows have 32 output tiles,
// so their K dimension is split over blockIdx.z into partial sums that the
// following BN kernel adds in a fixed order (deterministic, no atomics).
// Tensor cores (wgmma), TMA staging, one persistent kernel or a CUDA graph
// are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (mft_tpu_torch/kernels/build.py); bound with ctypes through the plain C
// entry points at the bottom.  Each returns the first cudaGetLastError() that
// is not 0 (1 = cudaErrorInvalidValue for a geometry the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 64;        // output rows per block
constexpr int TN = 64;        // output columns per block
constexpr int KT = 16;        // reduction elements per shared-memory chunk
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 output tile
constexpr int MAX_ROWS = 1024;
constexpr int BN_CT = 16;     // channels per BN block
constexpr int BN_RG = 16;     // row groups per BN block (BN_CT * BN_RG threads)
constexpr int KERNELS_PER_STEP = 15;
constexpr int TARGET_BLOCKS = 264;  // two blocks per SM for the split GEMMs
constexpr float BN_EPS = 1e-5f;
constexpr float ADAM_EPS = 1e-8f;

__device__ __forceinline__ float ldf(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ldf(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void stp(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void stp(bf16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }

// round to the compute dtype, go on in f32
template <bool BF16>
__device__ __forceinline__ float round_cd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16(v));
  return v;
}

// BN output; one instruction, so the forward and the ReLU mask of the
// backward see the same bits
__device__ __forceinline__ float bn_affine(float xhat, float scale, float bias) { return fmaf(xhat, scale, bias); }

// How the rows of an implicit GEMM map onto an activation tensor
// X [*, hin, hin, C]: row m = (sample b, oy, ox) of a [batch, hout, hout]
// output; tap (ky, kx) of a ksize x ksize window reads pixel
// (oy*stride + sgn*(ky - pad), ox*stride + sgn*(kx - pad)) of image img[b]
// (or image b when img is null), zero outside.  sgn = -1 turns the window
// into the one of the input gradient.
struct Gather {
  int batch, hout, hin, stride, ksize, pad, sgn, C;
};

__device__ __forceinline__ void accumulate_tile(float (*As)[TM + 1], float (*Bs)[TN + 1], int ty, int tx,
                                                float (&acc)[4][4]) {
#pragma unroll
  for (int kf = 0; kf < KT; ++kf) {
    float a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = As[kf][ty + 16 * k];
      b[k] = Bs[kf][tx + 16 * k];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
  }
}

// out[z][m, n] = sum over this block's K range of X[src(m, tap), c] * W[tap, c, n]
// with k = tap*C + c.  W is addressed as tap*w_tap + c*w_c + n*w_n and rounded
// to the compute dtype; W_KFAST says that c (not n) is its contiguous index.
// Grid: (ceil(N/TN), ceil(R/TM), splits); kchunk is a multiple of KT and so is C.
template <typename XT, typename WT, bool CD_BF16, bool W_KFAST>
__global__ void __launch_bounds__(THREADS)
conv_gemm_kernel(const XT* __restrict__ X, const int* __restrict__ img, const WT* __restrict__ W,
                 float* __restrict__ out, Gather g, int N, int w_tap, int w_c, int w_n, int kchunk) {
  __shared__ float As[KT][TM + 1];
  __shared__ float Bs[KT][TN + 1];
  const int hw = g.hout * g.hout;
  const int R = g.batch * hw;
  const int K = g.ksize * g.ksize * g.C;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // the four rows this thread stages: m0 + ty + 16 i, at reduction offset tx
  int rimg[4], roy[4], rox[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    rimg[i] = -1;
    roy[i] = rox[i] = 0;
    if (m < R) {
      const int b = m / hw, rem = m - b * hw;
      roy[i] = rem / g.hout;
      rox[i] = rem - roy[i] * g.hout;
      rimg[i] = img ? img[b] : b;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += KT) {
    const int tap = k0 / g.C, c0 = k0 - tap * g.C;
    const int ky = tap / g.ksize, kx = tap - ky * g.ksize;
    const int dy = g.sgn * (ky - g.pad), dx = g.sgn * (kx - g.pad);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      if (rimg[i] >= 0) {
        const int iy = roy[i] * g.stride + dy, ix = rox[i] * g.stride + dx;
        if (iy >= 0 && iy < g.hin && ix >= 0 && ix < g.hin)
          v = ldf(X, (static_cast<size_t>(rimg[i] * g.hin + iy) * g.hin + ix) * g.C + c0 + tx);
      }
      As[tx][ty + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int kk, nn;
      if constexpr (W_KFAST) {
        kk = tid % KT;
        nn = tid / KT + 16 * i;
      } else {
        nn = tid % TN;
        kk = tid / TN + 4 * i;
      }
      const int n = n0 + nn;
      float v = 0.f;
      if (n < N)
        v = round_cd<CD_BF16>(ldf(W, static_cast<size_t>(tap) * w_tap + static_cast<size_t>(c0 + kk) * w_c +
                                         static_cast<size_t>(n) * w_n));
      Bs[kk][nn] = v;
    }
    __syncthreads();
    accumulate_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float* o = out + static_cast<size_t>(blockIdx.z) * R * N;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + ty + 16 * p;
    if (m >= R) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx + 16 * q;
      if (n < N) o[static_cast<size_t>(m) * N + n] = acc[p][q];
    }
  }
}

// Weight gradient: out[tap*C + c, n] = sum_m X[src(m, tap), c] * DY[m, n].
// Grid: (ceil(N/TN), ceil(ksize*ksize*C/TM)).  DY holds f32 values already
// rounded to the compute dtype.
template <typename XT>
__global__ void __launch_bounds__(THREADS)
conv_wgrad_kernel(const XT* __restrict__ X, const int* __restrict__ img, const float* __restrict__ DY,
                  float* __restrict__ out, Gather g, int N) {
  __shared__ float As[KT][TM + 1];
  __shared__ float Bs[KT][TN + 1];
  __shared__ int srow[MAX_ROWS];  // (image << 16) | (oy << 8) | ox of each row m
  const int hw = g.hout * g.hout;
  const int R = g.batch * hw;
  const int MW = g.ksize * g.ksize * g.C;
  const int n0 = blockIdx.x * TN, r0 = blockIdx.y * TM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int m = tid; m < R; m += THREADS) {
    const int b = m / hw, rem = m - b * hw;
    const int oy = rem / g.hout, ox = rem - oy * g.hout;
    srow[m] = ((img ? img[b] : b) << 16) | (oy << 8) | ox;
  }
  // the weight row this thread stages, fixed for the whole kernel
  const int lane_r = tid % TM;
  const int r = r0 + lane_r;
  const bool r_ok = r < MW;
  const int tap = r / g.C, c = r - tap * g.C;
  const int ky = tap / g.ksize, kx = tap - ky * g.ksize;
  const int dy = g.sgn * (ky - g.pad), dx = g.sgn * (kx - g.pad);
  const int n_st = n0 + tid % TN;
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int k0 = 0; k0 < R; k0 += KT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = tid / TM + 4 * i;
      const int m = k0 + kk;
      float a = 0.f, b = 0.f;
      if (m < R) {
        if (r_ok) {
          const int pk = srow[m];
          const int iy = ((pk >> 8) & 255) * g.stride + dy, ix = (pk & 255) * g.stride + dx;
          if (iy >= 0 && iy < g.hin && ix >= 0 && ix < g.hin)
            a = ldf(X, (static_cast<size_t>((pk >> 16) * g.hin + iy) * g.hin + ix) * g.C + c);
        }
        if (n_st < N) b = DY[static_cast<size_t>(m) * N + n_st];
      }
      As[kk][lane_r] = a;
      Bs[kk][tid % TN] = b;
    }
    __syncthreads();
    accumulate_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int rr = r0 + ty + 16 * p;
    if (rr >= MW) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx + 16 * q;
      if (n < N) out[static_cast<size_t>(rr) * N + n] = acc[p][q];
    }
  }
}

// Sum over the BN_RG row groups of one channel column, in a fixed order;
// every thread of the column gets the same total.
__device__ __forceinline__ float column_sum(float v, float (*red)[BN_CT], int rg, int cx) {
  __syncthreads();  // the previous use of red is over
  red[rg][cx] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < BN_RG; ++i) s += red[i][cx];
  return s;
}

__device__ __forceinline__ float weight_sum(const float* w_t, int batch) {
  float s = 0.f;
  for (int b = 0; b < batch; ++b) s += w_t[b];
  return s;
}

// Masked batch-stats BN forward of y = round_cd(sum_s parts[s]) [R, C]:
// xhat and inv are kept for the backward; h = xhat*scale + bias goes to
// act = round_cd(relu(h)) (the next conv's input) and/or is stored in or
// added to hsum (the block's pre-activation).  Grid: ceil(C / BN_CT).
template <typename WT, bool CD_BF16>
__global__ void __launch_bounds__(BN_CT* BN_RG)
bn_fwd_kernel(const float* __restrict__ parts, int S, const WT* __restrict__ scale, const WT* __restrict__ bias,
              const float* __restrict__ w_t, int batch, int hw, int C, float* __restrict__ xhat,
              float* __restrict__ inv_out, float* __restrict__ act, float* __restrict__ hsum, int accumulate) {
  __shared__ float red[BN_RG][BN_CT];
  const int cx = threadIdx.x % BN_CT, rg = threadIdx.x / BN_CT;
  const int c = blockIdx.x * BN_CT + cx;
  const bool ok = c < C;
  const int R = batch * hw;
  const size_t RC = static_cast<size_t>(R) * C;
  const float count = fmaxf(weight_sum(w_t, batch), 1e-6f) * static_cast<float>(hw);

  float s = 0.f;
  if (ok)
    for (int r = rg; r < R; r += BN_RG) {
      const size_t i = static_cast<size_t>(r) * C + c;
      float y = 0.f;
      for (int k = 0; k < S; ++k) y += parts[k * RC + i];
      y = round_cd<CD_BF16>(y);
      xhat[i] = y;  // parked here until the last pass
      s += y * w_t[r / hw];
    }
  const float mean = column_sum(s, red, rg, cx) / count;
  s = 0.f;
  if (ok)
    for (int r = rg; r < R; r += BN_RG) {
      const float d = xhat[static_cast<size_t>(r) * C + c] - mean;
      s += d * d * w_t[r / hw];
    }
  const float var = column_sum(s, red, rg, cx) / count;
  if (!ok) return;
  const float inv = 1.0f / sqrtf(var + BN_EPS);
  const float sc = ldf(scale, c), bi = ldf(bias, c);
  if (rg == 0) inv_out[c] = inv;
  for (int r = rg; r < R; r += BN_RG) {
    const size_t i = static_cast<size_t>(r) * C + c;
    const float xh = (xhat[i] - mean) * inv;
    xhat[i] = xh;
    const float h = bn_affine(xh, sc, bi);
    if (act) act[i] = round_cd<CD_BF16>(fmaxf(h, 0.f));
    if (hsum) hsum[i] = accumulate ? hsum[i] + h : h;
  }
}

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  __syncthreads();  // the previous use of red is over
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < THREADS / 32; ++i) t = is_max ? fmaxf(t, red[i]) : t + red[i];
  return t;
}

// One block per sample b: logits = round_cd(mean over the hw pixels of
// relu(pre)), softmax CE against label bank_y[idx_t[b]] (a label outside
// [0, C) has an all-zero one-hot), dlogits = (softmax - onehot) * w_b / denom,
// ce[b] = (lse - logit_y) * w_b.  Dynamic shared memory: 2*C floats.
template <bool CD_BF16>
__global__ void __launch_bounds__(THREADS)
pool_ce_kernel(const float* __restrict__ pre, const int* __restrict__ bank_y, const int* __restrict__ idx_t,
               const float* __restrict__ w_t, int batch, int hw, int C, float* __restrict__ dlogits,
               float* __restrict__ ce) {
  extern __shared__ float sm[];
  __shared__ float red[THREADS / 32];
  float* logit = sm;
  float* ez = sm + C;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* pb = pre + static_cast<size_t>(b) * hw * C;
  float zmax = -INFINITY;
  for (int c = tid; c < C; c += THREADS) {
    float s = 0.f;
    for (int j = 0; j < hw; ++j) s += fmaxf(pb[static_cast<size_t>(j) * C + c], 0.f);
    const float f = round_cd<CD_BF16>(s / static_cast<float>(hw));
    logit[c] = f;
    zmax = fmaxf(zmax, f);
  }
  zmax = block_reduce(zmax, red, true);
  float se = 0.f;
  for (int c = tid; c < C; c += THREADS) {
    const float e = expf(logit[c] - zmax);
    ez[c] = e;
    se += e;
  }
  se = block_reduce(se, red, false);
  const float denom = fmaxf(weight_sum(w_t, batch), 1.0f);
  const float wb = w_t[b];
  const int y = bank_y[idx_t[b]];
  const float coef = wb / denom;
  for (int c = tid; c < C; c += THREADS)
    dlogits[static_cast<size_t>(b) * C + c] = (ez[c] / se - (c == y ? 1.0f : 0.0f)) * coef;
  if (tid == 0) ce[b] = (logf(se) + zmax - ((y >= 0 && y < C) ? logit[y] : 0.f)) * wb;
}

__global__ void loss_kernel(const float* __restrict__ ce, const float* __restrict__ w_t, int batch,
                            float* __restrict__ loss) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    float s = 0.f;
    for (int b = 0; b < batch; ++b) s += ce[b];
    *loss = s / fmaxf(weight_sum(w_t, batch), 1.0f);
  }
}

// Masked BN backward.  The incoming gradient g [R, C] is
//   MODE 0: mask[r, c] > 0 ? src[(r / hw), c] / hw : 0   (pool + ReLU backward;
//           src = dlogits [B, C], mask = the pre-activation)
//   MODE 1: h > 0 ? sum_s src[s][r, c] : 0 with h = xhat*scale + bias
//           (ReLU backward of this BN's own output; src = split partial sums)
// Writes dy = round_cd(dx) and the scale/bias gradients.  Grid: ceil(C / BN_CT).
template <typename WT, bool CD_BF16, int MODE>
__global__ void __launch_bounds__(BN_CT* BN_RG)
bn_bwd_kernel(const float* __restrict__ src, int S, const float* __restrict__ mask, const float* __restrict__ xhat,
              const float* __restrict__ inv_in, const WT* __restrict__ scale, const WT* __restrict__ bias,
              const float* __restrict__ w_t, int batch, int hw, int C, float* __restrict__ dy,
              float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float red[BN_RG][BN_CT];
  const int cx = threadIdx.x % BN_CT, rg = threadIdx.x / BN_CT;
  const int c = blockIdx.x * BN_CT + cx;
  const bool ok = c < C;
  const int R = batch * hw;
  const size_t RC = static_cast<size_t>(R) * C;
  const float count = fmaxf(weight_sum(w_t, batch), 1e-6f) * static_cast<float>(hw);
  const float sc = ok ? ldf(scale, c) : 0.f;
  const float bi = (ok && MODE == 1) ? ldf(bias, c) : 0.f;

  float a_gx = 0.f, a_g = 0.f, a_1 = 0.f, a_2 = 0.f;
  if (ok)
    for (int r = rg; r < R; r += BN_RG) {
      const size_t i = static_cast<size_t>(r) * C + c;
      const float xh = xhat[i];
      float gv = 0.f;
      if constexpr (MODE == 0) {
        if (mask[i] > 0.f) gv = src[static_cast<size_t>(r / hw) * C + c] / static_cast<float>(hw);
      } else {
        if (bn_affine(xh, sc, bi) > 0.f)
          for (int k = 0; k < S; ++k) gv += src[k * RC + i];
      }
      dy[i] = gv;  // parked here until the last pass
      const float wr = w_t[r / hw];
      const float dxh = gv * sc;
      a_gx += gv * xh;
      a_g += gv;
      a_1 += dxh * wr;
      a_2 += dxh * xh * wr;
    }
  const float t_gx = column_sum(a_gx, red, rg, cx);
  const float t_g = column_sum(a_g, red, rg, cx);
  const float m1 = column_sum(a_1, red, rg, cx) / count;
  const float m2 = column_sum(a_2, red, rg, cx) / count;
  if (!ok) return;
  if (rg == 0) {
    dscale[c] = t_gx;
    dbias[c] = t_g;
  }
  const float inv = inv_in[c];
  for (int r = rg; r < R; r += BN_RG) {
    const size_t i = static_cast<size_t>(r) * C + c;
    const float dxh = dy[i] * sc;
    dy[i] = round_cd<CD_BF16>((dxh - m1 - xhat[i] * m2) * inv * w_t[r / hw]);
  }
}

// torch-Adam over the flat parameter buffer: f32 math, moments stored bf16
// and read back rounded, the parameter rounded to its carry dtype.  The
// *_rn intrinsics keep the compiler from fusing multiply-adds, so the
// rounding is that of the plain version's separate operations.
template <typename PT>
__global__ void __launch_bounds__(THREADS)
adam_kernel(PT* __restrict__ p, bf16* __restrict__ mu, bf16* __restrict__ nu, const float* __restrict__ g, size_t n,
            float neg_lr, float bc1, float bc2) {
  const float b1 = 0.9f, b2 = 0.999f;
  const float omb1 = static_cast<float>(1.0 - 0.9), omb2 = static_cast<float>(1.0 - 0.999);
  for (size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * THREADS) {
    const float gf = g[i];
    const float m = __fadd_rn(__fmul_rn(b1, __bfloat162float(mu[i])), __fmul_rn(omb1, gf));
    const float v = __fadd_rn(__fmul_rn(b2, __bfloat162float(nu[i])), __fmul_rn(omb2, __fmul_rn(gf, gf)));
    const bf16 mb = __float2bfloat16(m), vb = __float2bfloat16(v);
    mu[i] = mb;
    nu[i] = vb;
    const float mh = __fdiv_rn(__bfloat162float(mb), bc1);
    const float vh = __fdiv_rn(__bfloat162float(vb), bc2);
    const float upd = __fdiv_rn(__fmul_rn(neg_lr, mh), __fadd_rn(__fsqrt_rn(vh), ADAM_EPS));
    stp(p, i, __fadd_rn(ldf(p, i), upd));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Geom {
  int h_in, c_in, c_out, stride, batch, h_out, hw, rows;
};

bool make_geom(int h_in, int c_in, int c_out, int stride, int batch, Geom* g) {
  if (h_in <= 0 || c_in <= 0 || c_out <= 0 || batch <= 0) return false;
  if ((stride != 1 && stride != 2) || h_in % stride) return false;
  if (c_in % KT || c_out % KT || h_in > 255) return false;
  const int h_out = h_in / stride;
  if (batch * h_out * h_out > MAX_ROWS) return false;
  *g = Geom{h_in, c_in, c_out, stride, batch, h_out, h_out * h_out, batch * h_out * h_out};
  return true;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// K range per split of a GEMM with `rows` x `cols` outputs, so that about
// TARGET_BLOCKS blocks run; a multiple of KT
int split_chunk(int rows, int cols, int K) {
  const int tiles = cdiv(rows, TM) * cdiv(cols, TN);
  const int want = TARGET_BLOCKS / tiles > 1 ? TARGET_BLOCKS / tiles : 1;
  return cdiv(cdiv(K, want), KT) * KT;
}

// element offsets of the nine tensors in the flat parameter buffer (PKEYS order)
struct ParamOffsets {
  size_t conv1, bn1_s, bn1_b, conv2, bn2_s, bn2_b, conv_sc, bnsc_s, bnsc_b, total;
};

ParamOffsets param_offsets(const Geom& g) {
  ParamOffsets o;
  size_t at = 0;
  const size_t ci = g.c_in, co = g.c_out;
  o.conv1 = at, at += 9 * ci * co;
  o.bn1_s = at, at += co;
  o.bn1_b = at, at += co;
  o.conv2 = at, at += 9 * co * co;
  o.bn2_s = at, at += co;
  o.bn2_b = at, at += co;
  o.conv_sc = at, at += ci * co;
  o.bnsc_s = at, at += co;
  o.bnsc_b = at, at += co;
  o.total = at;
  return o;
}

// byte offsets into the caller's scratch buffer
struct Scratch {
  size_t mu, nu, grads, part, part_sc, xhat1, z1, xhat2, xhats, pre, dy2, dys, dy1, inv1, inv2, invs, dlogits, ce, total;
  int chunk1, chunk2, splits1, splits2;
};

Scratch make_scratch(const Geom& g) {
  Scratch s;
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  const size_t np = param_offsets(g).total;
  const size_t rc = static_cast<size_t>(g.rows) * g.c_out * sizeof(float);
  s.chunk1 = split_chunk(g.rows, g.c_out, 9 * g.c_in);
  s.chunk2 = split_chunk(g.rows, g.c_out, 9 * g.c_out);
  s.splits1 = cdiv(9 * g.c_in, s.chunk1);
  s.splits2 = cdiv(9 * g.c_out, s.chunk2);
  s.mu = take(np * sizeof(bf16));
  s.nu = take(np * sizeof(bf16));
  s.grads = take(np * sizeof(float));
  s.part = take(rc * (s.splits1 > s.splits2 ? s.splits1 : s.splits2));
  s.part_sc = take(rc);
  s.xhat1 = take(rc), s.z1 = take(rc), s.xhat2 = take(rc), s.xhats = take(rc), s.pre = take(rc);
  s.dy2 = take(rc), s.dys = take(rc), s.dy1 = take(rc);
  s.inv1 = take(g.c_out * sizeof(float)), s.inv2 = take(g.c_out * sizeof(float)), s.invs = take(g.c_out * sizeof(float));
  s.dlogits = take(static_cast<size_t>(g.batch) * g.c_out * sizeof(float));
  s.ce = take(g.batch * sizeof(float));
  s.total = at;
  return s;
}

#define LAUNCH_CHECK()                                      \
  do {                                                      \
    const cudaError_t e_ = cudaGetLastError();              \
    if (e_ != cudaSuccess) return static_cast<int>(e_);     \
  } while (0)

// Forward and backward of one minibatch: the gradients of the flat parameters
// p go to `grads` (every element is written).  PT: carry dtype of p; XT: the
// bank's dtype, which is the compute dtype.
template <typename PT, typename XT>
int enqueue_grads(const Geom& g, const Scratch& s, char* scratch, const PT* p, const XT* bank, const int* bank_y,
                  const int* idx_t, const float* w_t, float* grads, cudaStream_t st) {
  constexpr bool CD = sizeof(XT) == sizeof(bf16);
  const ParamOffsets o = param_offsets(g);
  auto f = [scratch](size_t off) { return reinterpret_cast<float*>(scratch + off); };
  float *part = f(s.part), *part_sc = f(s.part_sc), *xhat1 = f(s.xhat1), *z1 = f(s.z1), *xhat2 = f(s.xhat2),
        *xhats = f(s.xhats), *pre = f(s.pre), *dy2 = f(s.dy2), *dys = f(s.dys), *dy1 = f(s.dy1), *inv1 = f(s.inv1),
        *inv2 = f(s.inv2), *invs = f(s.invs), *dlogits = f(s.dlogits), *ce = f(s.ce);
  const int R = g.rows, ci = g.c_in, co = g.c_out, B = g.batch, hw = g.hw;
  const Gather in3{B, g.h_out, g.h_in, g.stride, 3, 1, 1, ci};    // conv1 over the bank
  const Gather in1{B, g.h_out, g.h_in, g.stride, 1, 0, 1, ci};    // shortcut over the bank
  const Gather mid3{B, g.h_out, g.h_out, 1, 3, 1, 1, co};         // conv2 over z1
  const Gather mid3t{B, g.h_out, g.h_out, 1, 3, 1, -1, co};       // conv2's input gradient over dy2
  const dim3 tiles(cdiv(co, TN), cdiv(R, TM));
  const dim3 tiles1(tiles.x, tiles.y, s.splits1), tiles2(tiles.x, tiles.y, s.splits2);  // K split over z
  const dim3 wg1(cdiv(co, TN), cdiv(9 * ci, TM)), wg2(cdiv(co, TN), cdiv(9 * co, TM)), wgsc(cdiv(co, TN), cdiv(ci, TM));
  const dim3 bn_grid(cdiv(co, BN_CT)), bn_block(BN_CT * BN_RG);

  // forward
  conv_gemm_kernel<XT, PT, CD, false><<<tiles1, THREADS, 0, st>>>(
      bank, idx_t, p + o.conv1, part, in3, co, ci * co, co, 1, s.chunk1);
  LAUNCH_CHECK();
  conv_gemm_kernel<XT, PT, CD, false><<<tiles, THREADS, 0, st>>>(bank, idx_t, p + o.conv_sc, part_sc, in1, co, 0, co,
                                                                 1, ci);
  LAUNCH_CHECK();
  bn_fwd_kernel<PT, CD><<<bn_grid, bn_block, 0, st>>>(part, s.splits1, p + o.bn1_s, p + o.bn1_b, w_t, B, hw, co, xhat1,
                                                      inv1, z1, nullptr, 0);
  LAUNCH_CHECK();
  conv_gemm_kernel<float, PT, CD, false><<<tiles2, THREADS, 0, st>>>(
      z1, nullptr, p + o.conv2, part, mid3, co, co * co, co, 1, s.chunk2);
  LAUNCH_CHECK();
  bn_fwd_kernel<PT, CD><<<bn_grid, bn_block, 0, st>>>(part, s.splits2, p + o.bn2_s, p + o.bn2_b, w_t, B, hw, co, xhat2,
                                                      inv2, nullptr, pre, 0);
  LAUNCH_CHECK();
  bn_fwd_kernel<PT, CD><<<bn_grid, bn_block, 0, st>>>(part_sc, 1, p + o.bnsc_s, p + o.bnsc_b, w_t, B, hw, co, xhats,
                                                      invs, nullptr, pre, 1);
  LAUNCH_CHECK();
  pool_ce_kernel<CD><<<B, THREADS, 2 * co * sizeof(float), st>>>(pre, bank_y, idx_t, w_t, B, hw, co, dlogits, ce);
  LAUNCH_CHECK();

  // backward
  bn_bwd_kernel<PT, CD, 0><<<bn_grid, bn_block, 0, st>>>(dlogits, 1, pre, xhat2, inv2, p + o.bn2_s,
                                                         static_cast<const PT*>(nullptr), w_t, B, hw, co, dy2,
                                                         grads + o.bn2_s, grads + o.bn2_b);
  LAUNCH_CHECK();
  bn_bwd_kernel<PT, CD, 0><<<bn_grid, bn_block, 0, st>>>(dlogits, 1, pre, xhats, invs, p + o.bnsc_s,
                                                         static_cast<const PT*>(nullptr), w_t, B, hw, co, dys,
                                                         grads + o.bnsc_s, grads + o.bnsc_b);
  LAUNCH_CHECK();
  conv_wgrad_kernel<float><<<wg2, THREADS, 0, st>>>(z1, nullptr, dy2, grads + o.conv2, mid3, co);
  LAUNCH_CHECK();
  conv_gemm_kernel<float, PT, CD, true><<<tiles2, THREADS, 0, st>>>(
      dy2, nullptr, p + o.conv2, part, mid3t, co, co * co, 1, co, s.chunk2);
  LAUNCH_CHECK();
  bn_bwd_kernel<PT, CD, 1><<<bn_grid, bn_block, 0, st>>>(part, s.splits2, nullptr, xhat1, inv1, p + o.bn1_s,
                                                         p + o.bn1_b, w_t, B, hw, co, dy1, grads + o.bn1_s,
                                                         grads + o.bn1_b);
  LAUNCH_CHECK();
  conv_wgrad_kernel<XT><<<wg1, THREADS, 0, st>>>(bank, idx_t, dy1, grads + o.conv1, in3, co);
  LAUNCH_CHECK();
  conv_wgrad_kernel<XT><<<wgsc, THREADS, 0, st>>>(bank, idx_t, dys, grads + o.conv_sc, in1, co);
  LAUNCH_CHECK();
  return 0;
}

template <typename PT, typename XT>
int enqueue_scan(const Geom& g, PT* p, const XT* bank, const int* bank_y, const int* idx, const float* w,
                 char* scratch, int L, int T, int span, float lr, cudaStream_t st) {
  const Scratch s = make_scratch(g);
  const size_t np = param_offsets(g).total;
  const size_t lane_bank = static_cast<size_t>(span) * g.h_in * g.h_in * g.c_in;
  bf16* mu = reinterpret_cast<bf16*>(scratch + s.mu);
  bf16* nu = reinterpret_cast<bf16*>(scratch + s.nu);
  float* grads = reinterpret_cast<float*>(scratch + s.grads);
  const float log_b1 = static_cast<float>(log(0.9)), log_b2 = static_cast<float>(log(0.999));
  const int adam_blocks = static_cast<int>((np + THREADS - 1) / THREADS);
  if (2 * g.c_out * sizeof(float) > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < L; ++l) {
    PT* pl = p + static_cast<size_t>(l) * np;
    // mu and nu are adjacent only up to padding: clear each
    cudaError_t e = cudaMemsetAsync(mu, 0, np * sizeof(bf16), st);
    if (e == cudaSuccess) e = cudaMemsetAsync(nu, 0, np * sizeof(bf16), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    for (int t = 0; t < T; ++t) {
      const int err = enqueue_grads<PT, XT>(g, s, scratch, pl, bank + l * lane_bank, bank_y,
                                            idx + (static_cast<size_t>(l) * T + t) * g.batch,
                                            w + static_cast<size_t>(t) * g.batch, grads, st);
      if (err) return err;
      const float tf = static_cast<float>(t + 1);
      adam_kernel<PT><<<adam_blocks, THREADS, 0, st>>>(pl, mu, nu, grads, np, -lr, 1.0f - expf(tf * log_b1),
                                                       1.0f - expf(tf * log_b2));
      LAUNCH_CHECK();
    }
  }
  return 0;
}

template <typename PT>
int scan_entry(void* p, const void* bank, int bank_is_bf16, const int* bank_y, const int* idx, const float* w,
               void* scratch, int L, int T, int span, int h_in, int c_in, int c_out, int stride, int batch, float lr,
               void* stream) {
  Geom g;
  if (!make_geom(h_in, c_in, c_out, stride, batch, &g) || span <= 0 || span >= 32768 || L < 0 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_is_bf16)
    return enqueue_scan<PT, bf16>(g, static_cast<PT*>(p), static_cast<const bf16*>(bank), bank_y, idx, w,
                                  static_cast<char*>(scratch), L, T, span, lr, st);
  return enqueue_scan<PT, float>(g, static_cast<PT*>(p), static_cast<const float*>(bank), bank_y, idx, w,
                                 static_cast<char*>(scratch), L, T, span, lr, st);
}

template <typename PT, typename XT>
int grads_once(const Geom& g, const PT* p, const XT* bank, const int* bank_y, const int* idx_t, const float* w_t,
               char* scratch, float* grads, float* loss, cudaStream_t st) {
  const Scratch s = make_scratch(g);
  if (2 * g.c_out * sizeof(float) > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int err = enqueue_grads<PT, XT>(g, s, scratch, p, bank, bank_y, idx_t, w_t, grads, st);
  if (err) return err;
  loss_kernel<<<1, 32, 0, st>>>(reinterpret_cast<const float*>(scratch + s.ce), w_t, g.batch, loss);
  LAUNCH_CHECK();
  return 0;
}

template <typename PT>
int grads_entry(const void* p, const void* bank, int bank_is_bf16, const int* bank_y, const int* idx_t,
                const float* w_t, void* scratch, float* grads, float* loss, int span, int h_in, int c_in, int c_out,
                int stride, int batch, void* stream) {
  Geom g;
  if (!make_geom(h_in, c_in, c_out, stride, batch, &g) || span <= 0 || span >= 32768)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_is_bf16)
    return grads_once<PT, bf16>(g, static_cast<const PT*>(p), static_cast<const bf16*>(bank), bank_y, idx_t, w_t,
                                static_cast<char*>(scratch), grads, loss, st);
  return grads_once<PT, float>(g, static_cast<const PT*>(p), static_cast<const float*>(bank), bank_y, idx_t, w_t,
                               static_cast<char*>(scratch), grads, loss, st);
}

}  // namespace

// Bytes of scratch the entry points below need for this geometry (0 if the
// kernels do not take it).
extern "C" size_t fused_inner_scan_scratch_bytes(int h_in, int c_in, int c_out, int stride, int batch) {
  Geom g;
  if (!make_geom(h_in, c_in, c_out, stride, batch, &g)) return 0;
  return make_scratch(g).total;
}

// Device kernels enqueued per inner step (the Adam kernel included).
extern "C" int fused_inner_scan_kernels_per_step() { return KERNELS_PER_STEP; }

// The scan.  p [L, n_params] in the carry dtype, updated in place (PKEYS
// order: conv1 [9ci, co], bn1 scale, bias [co], conv2 [9co, co], bn2, conv_sc
// [ci, co], bn_sc); bank [L, span, h_in, h_in, c_in] bf16 or f32; bank_y [span]
// int32; idx [L, T, batch] int32; w [T, batch] f32; scratch of
// fused_inner_scan_scratch_bytes() bytes.  All on the device of `stream`.
extern "C" int fused_inner_scan_bf16(void* p, const void* bank, int bank_is_bf16, const int* bank_y, const int* idx,
                                     const float* w, void* scratch, int L, int T, int span, int h_in, int c_in,
                                     int c_out, int stride, int batch, float lr, void* stream) {
  return scan_entry<bf16>(p, bank, bank_is_bf16, bank_y, idx, w, scratch, L, T, span, h_in, c_in, c_out, stride, batch,
                          lr, stream);
}

extern "C" int fused_inner_scan_f32(void* p, const void* bank, int bank_is_bf16, const int* bank_y, const int* idx,
                                    const float* w, void* scratch, int L, int T, int span, int h_in, int c_in,
                                    int c_out, int stride, int batch, float lr, void* stream) {
  return scan_entry<float>(p, bank, bank_is_bf16, bank_y, idx, w, scratch, L, T, span, h_in, c_in, c_out, stride, batch,
                           lr, stream);
}

// One forward and backward without the update: grads [n_params] f32 and the
// loss (one f32), for the minibatch idx_t [batch], w_t [batch] of one bank.
extern "C" int fused_step_grads_bf16(const void* p, const void* bank, int bank_is_bf16, const int* bank_y,
                                     const int* idx_t, const float* w_t, void* scratch, float* grads, float* loss,
                                     int span, int h_in, int c_in, int c_out, int stride, int batch, void* stream) {
  return grads_entry<bf16>(p, bank, bank_is_bf16, bank_y, idx_t, w_t, scratch, grads, loss, span, h_in, c_in, c_out,
                           stride, batch, stream);
}

extern "C" int fused_step_grads_f32(const void* p, const void* bank, int bank_is_bf16, const int* bank_y,
                                    const int* idx_t, const float* w_t, void* scratch, float* grads, float* loss,
                                    int span, int h_in, int c_in, int c_out, int stride, int batch, void* stream) {
  return grads_entry<float>(p, bank, bank_is_bf16, bank_y, idx_t, w_t, scratch, grads, loss, span, h_in, c_in, c_out,
                            stride, batch, stream);
}
