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
// What bounds it, at BlockGeom(14, 256, 512, 2, 5) (245 rows).  By the
// roofline, operations: a step is 4.75 GFLOP of products against 0.5 MB of
// gathered bank rows, so 500 steps are bound by 2.4 ms at the bf16
// tensor-core rate (H100 SXM, 989 TFLOP/s).  That bound is out of reach at
// one lane: with 245 rows a step is a chain of eight dependent small kernels,
// each a fraction of a wave on 132 SMs, that pass the lane's state (7.3 MB
// of bf16 parameters, 14.7 MB of moments), the operand tiles (once per
// output tile) and the split-K partial sums through L2: about 176 MB a step
// (chip_smoke.py computes it from the shapes and this tiling).  What the
// design does about it: the lanes of a call (the eval's episodes) step
// together, each of a step's kernels covering every lane in one grid, so the
// chain's latency is paid once a step and not once a lane-step; the seven
// products run on the tensor cores from bf16 operands stored as bf16, every
// pass over rows or parameters moves 16 bytes a thread on at least 128
// blocks a lane, kernels that share inputs share a launch, the conv
// gradients go from the accumulators into the Adam update without touching
// memory, and each kernel is a programmatic dependent launch, so that no gap
// is left between one kernel's end and the next one's start; each kernel
// takes the lanes in the reverse order of the one before it, so it starts on
// the operands that one wrote last, still in L2.  With many lanes their
// states no longer fit L2, and what stays per lane is its state read and
// written every step: 3,673,088 bf16 parameters and their two bf16
// moments, 44.1 MB a lane-step, 13.2 us at 3.35 TB/s, besides about 5 us of
// products at half the bf16 peak.  The benchmark's roofline share of the scan
// (fused_bound) counts only the gathered bank rows as bytes, so it stays far
// from 100 % even at that floor.
//
// A step with a bf16 bank (the tensor-core route), 8 kernels, each one grid
// for all lanes of the call (a lane's blocks find its operands from the
// lane's grid coordinate and LaneLayout's strides):
//   1  conv_mma<0, TagConv1ScFwd>  conv1 and the 1x1 shortcut conv (the
//                                  shortcut as one more blockIdx.z slice;
//                                  blockIdx.z = lane * slices + slice)
//   2  bn_fwd<1>                   BN1 + ReLU -> z1 (bf16), xhat1, inv1
//   3  conv_mma<0, TagConv2Fwd>    conv2
//   4  bn_fwd<2>                   BN2 and the shortcut's BN, added -> pre;
//                                  ReLU + average pool -> logits
//   5  bn_bwd<0>                   softmax CE of the logits, pool/ReLU
//                                  backward, BN2 and shortcut-BN backward
//                                  -> dy2, dys (bf16)
//   6  conv_mma<1, TagConv2Dx>     conv2's input gradient as a gather
//                                  (flipped taps): no scatter, fixed order
//   7  bn_bwd<1>                   ReLU + BN1 backward -> dy1 (bf16)
//   8  wgrad_mma<TagDwAllAdam>     the three weight gradients, one grid
//                                  (blockIdx.y the lane); a tile is final,
//                                  so its block applies torch-Adam to its
//                                  weights in place and the f32 conv
//                                  gradients never reach memory (two more
//                                  blocks a lane update the BN vectors)
// The products are warpgroup wgmma.mma_async m64n128k16 (bf16 in, f32
// accumulators in registers), both operands from shared memory in the
// 128-byte swizzle, staged by 16-byte cp.async through a ring of 3 stages for
// the forward and input-gradient products (so that three blocks fit an SM
// when the lanes fill the card) and of 4 for the weight gradients.  The
// A operand of a forward or input-gradient product is an im2col gather (zero
// rows for the padding and for m >= rows, by cp.async's zero fill); with only
// 245 rows these have 16 output tiles, so K is split over blockIdx.z into
// partial sums that the following BN kernel adds in a fixed order (the split
// follows from the geometry alone, not from the number of lanes, so a lane's
// sums are the same whatever lanes share its grid).  A weight
// gradient reduces over the rows, so both of its operands are MN-major and
// the instruction's transpose bits are set; its 224 tiles of 128 x 128 need
// no split.  conv2's input gradient reads W2 with the reduction index
// contiguous (K-major B).  No reduction uses atomics: results repeat bit for
// bit.  With an f32 carry the products read a bf16 copy of the weights that
// the Adam update writes beside the f32 parameters.
//
// An f32 bank (the strict-parity path) keeps the f32 FMA products on the CUDA
// cores (64 x 64 tiles, 4 x 4 a thread; no TF32), 12 kernels a step, one lane
// after another, with the same BN and loss kernels and Adam as a kernel of its
// own.  fused_step_grads_* and fused_inner_scan_product take a route argument
// (1 = FMA) so that a check can run the FMA products on bf16 operands; the
// scan has none.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (mft_tpu_torch/kernels/build.py); bound with ctypes through the plain C
// entry points at the bottom.  Each returns the first CUDA error that is not
// 0 (1 = cudaErrorInvalidValue for a geometry the kernels do not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TM = 64;        // FMA route: output rows per block
constexpr int TN = 64;        // FMA route: output columns per block
constexpr int KT = 16;        // FMA route: reduction elements per shared-memory chunk
constexpr int THREADS = 256;
constexpr int MAX_ROWS = 1024;
constexpr int BN_CH = 4;                      // channels per BN block (one float4)
constexpr int BN_RPT = MAX_ROWS / THREADS;    // rows per BN thread
constexpr int TARGET_BLOCKS = 264;            // FMA route: two blocks per SM for the split GEMMs
constexpr int MMA_TARGET_BLOCKS = 128;        // tensor-core route: blocks of a split GEMM
constexpr int MMA_N = 128;                    // output columns per wgmma tile
constexpr int MMA_KB = 64;                    // reduction elements per stage of a K-major operand (128 bytes)
constexpr int MMA_STAGES = 4;                 // weight gradients: stages of the cp.async ring
constexpr int CONV_STAGES = 3;                // forward and input-gradient products: three blocks fit an SM
constexpr int WG_KB = 32;                     // rows reduced per stage of a weight gradient
constexpr int CONV_STAGE_BYTES = 64 * 128 + MMA_N * 128;
constexpr int CONV_SMEM = CONV_STAGES * CONV_STAGE_BYTES + 1024;
constexpr int WG_STAGE_BYTES = 4 * WG_KB * 128;
constexpr int WG_TILE_LD = MMA_N + 4;         // row stride (floats) of the f32 tile the Adam epilogue stages
constexpr int WG_SMEM = (MMA_STAGES * WG_STAGE_BYTES > 128 * WG_TILE_LD * 4 ? MMA_STAGES * WG_STAGE_BYTES
                                                                            : 128 * WG_TILE_LD * 4) + 1024;
constexpr float BN_EPS = 1e-5f;

__device__ __forceinline__ float ldf(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ldf(const bf16* p, size_t i) { return __bfloat162float(p[i]); }

// round to the compute dtype, go on in f32
template <bool BF16>
__device__ __forceinline__ float round_cd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16(v));
  return v;
}

// how a value that enters a product is stored: as what it is
template <bool BF16> struct Act { typedef float type; };
template <> struct Act<true> { typedef bf16 type; };

// Before every kernel's first access to memory (what comes before it computes
// from the arguments alone): it may have been placed on the SMs while its
// predecessor on the stream was still draining (see launch()); wait until
// that one has completed and its writes are visible.
__device__ __forceinline__ void grid_dependency_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// How the lanes of one grid lie in memory (the tensor-core route steps every
// lane of a call in the same grids): n lanes, and for each kind of operand
// the bytes from one lane's to the next's; 0 for an operand the lanes share.
struct LaneLayout {
  int n;
  size_t scratch;  // the lane's slice of the caller's scratch: moments, activations, partial sums
  size_t param;    // the parameters in their carry dtype
  size_t wq;       // the bf16 weights the products read (the parameters, or their shadow in the scratch)
  size_t bank;     // the gathered bank
  size_t idx;      // the minibatch schedule
  bool reverse;    // the grid takes the lanes last to first (see lane_at)
};

// The lane of a grid's lane slot: the blocks of a grid start in the order of
// their index, so a kernel that takes the lanes in the reverse order of its
// predecessor starts on the lanes whose operands that one wrote last, which
// are still in L2.  A lane's work does not depend on its place in the order.
__device__ __forceinline__ int lane_at(int slot, int lanes, bool reverse) { return reverse ? lanes - 1 - slot : slot; }

// lane `lane`'s copy of an operand whose lane 0 is at p (byte arithmetic on
// the pointer itself, so that the compiler still knows what it points into)
template <typename T>
__device__ __forceinline__ T* lane_ptr(T* p, size_t stride, int lane) {
  typedef typename std::conditional<std::is_const<T>::value, const char, char>::type Byte;
  return (T*)((Byte*)p + static_cast<size_t>(lane) * stride);
}

// torch-Adam for one element: f32 math, moments rounded to bf16 and the
// rounded moments feeding the update.  The *_rn intrinsics keep the compiler
// from fusing multiply-adds, so the rounding is that of the plain version's
// separate operations.  m, v: the stored moments in, the new ones (bf16
// values) out; returns the new parameter, not yet rounded to its carry dtype.
struct AdamCoef {
  float neg_lr, bc1, bc2;
};
__device__ __forceinline__ float adam_one(float p, float g, float& m, float& v, const AdamCoef& k) {
  const float b1 = 0.9f, b2 = 0.999f;
  const float omb1 = static_cast<float>(1.0 - 0.9), omb2 = static_cast<float>(1.0 - 0.999);
  m = __bfloat162float(__float2bfloat16(__fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g))));
  v = __bfloat162float(__float2bfloat16(__fadd_rn(__fmul_rn(b2, v), __fmul_rn(omb2, __fmul_rn(g, g)))));
  const float mh = __fdiv_rn(m, k.bc1);
  const float vh = __fdiv_rn(v, k.bc2);
  return __fadd_rn(p, __fdiv_rn(__fmul_rn(k.neg_lr, mh), __fadd_rn(__fsqrt_rn(vh), 1e-8f)));
}

// BN output; one instruction, so the forward and the ReLU mask of the
// backward see the same bits
__device__ __forceinline__ float bn_affine(float xhat, float scale, float bias) { return fmaf(xhat, scale, bias); }

// How the rows of an implicit GEMM map onto an activation tensor
// X [*, hin, hin, C]: row m = (sample b, oy, ox) of a [batch, hout, hout]
// output; tap (ky, kx) of a ksize x ksize window reads pixel
// (oy*stride + sgn*(ky - pad), ox*stride + sgn*(kx - pad)) of image img[b]
// (or image b when img is null), zero outside.  sgn = -1 turns the window
// into the one of the input gradient.  At stride s and pad 1 the centre tap
// of the 3x3 window is pixel (s*oy, s*ox), the 1x1 stride-s shortcut's.
struct Gather {
  int batch, hout, hin, stride, ksize, pad, sgn, C;
};

// four and eight neighbouring values at a time
__device__ __forceinline__ float4 f4(float v) { return make_float4(v, v, v, v); }
__device__ __forceinline__ float4 operator+(float4 a, float4 b) { return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w); }
__device__ __forceinline__ float4 operator-(float4 a, float4 b) { return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w); }
__device__ __forceinline__ float4 operator*(float4 a, float4 b) { return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w); }
__device__ __forceinline__ float4 operator*(float4 a, float s) { return make_float4(a.x * s, a.y * s, a.z * s, a.w * s); }
__device__ __forceinline__ float4 operator/(float4 a, float s) { return make_float4(a.x / s, a.y / s, a.z / s, a.w / s); }
__device__ __forceinline__ float4 ld4(const float* p, size_t i) { return *reinterpret_cast<const float4*>(p + i); }
__device__ __forceinline__ float4 ld4(const bf16* p, size_t i) {
  const uint2 u = *reinterpret_cast<const uint2*>(p + i);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, size_t i, float4 v) { *reinterpret_cast<float4*>(p + i) = v; }
__device__ __forceinline__ void st4(bf16* p, size_t i, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p + i) = u;
}
template <bool BF16>
__device__ __forceinline__ float4 round_cd4(float4 v) {
  return make_float4(round_cd<BF16>(v.x), round_cd<BF16>(v.y), round_cd<BF16>(v.z), round_cd<BF16>(v.w));
}
__device__ __forceinline__ float4 bn_affine4(float4 x, float4 s, float4 b) {
  return make_float4(bn_affine(x.x, s.x, b.x), bn_affine(x.y, s.y, b.y), bn_affine(x.z, s.z, b.z), bn_affine(x.w, s.w, b.w));
}


// eight consecutive values as f32
struct F8 {
  float v[8];
};
__device__ __forceinline__ F8 ld8(const float* p, size_t i) {
  const float4 a = ld4(p, i), b = ld4(p, i + 4);
  return F8{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}
__device__ __forceinline__ F8 unpack8(const uint4& u) {  // eight packed bf16
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  F8 r;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    r.v[2 * k] = f.x;
    r.v[2 * k + 1] = f.y;
  }
  return r;
}
__device__ __forceinline__ F8 ld8(const bf16* p, size_t i) { return unpack8(*reinterpret_cast<const uint4*>(p + i)); }
__device__ __forceinline__ void st8(float* p, size_t i, const F8& r) {
  st4(p, i, make_float4(r.v[0], r.v[1], r.v[2], r.v[3]));
  st4(p, i + 4, make_float4(r.v[4], r.v[5], r.v[6], r.v[7]));
}
__device__ __forceinline__ void st8(bf16* p, size_t i, const F8& r) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(r.v[2 * k], r.v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The Adam update of eight neighbouring elements (16-byte accesses) whose
// gradients are at hand; `shadow` (or null) receives the new parameters
// rounded to bf16, for the tensor-core products under an f32 carry.
template <typename PT>
__device__ __forceinline__ void adam_eight(PT* p, bf16* mu, bf16* nu, bf16* shadow, size_t i, const F8& g,
                                           const AdamCoef& k) {
  F8 pv = ld8(p, i), m = ld8(mu, i), v = ld8(nu, i);
#pragma unroll
  for (int e = 0; e < 8; ++e) pv.v[e] = adam_one(pv.v[e], g.v[e], m.v[e], v.v[e], k);
  st8(mu, i, m);
  st8(nu, i, v);
  st8(p, i, pv);
  if (shadow) st8(shadow, i, pv);
}

// ---------------------------------------------------------------------------
// the f32 FMA products (f32 bank, or route 1)
// ---------------------------------------------------------------------------

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
  grid_dependency_wait();
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
// Grid: (ceil(N/TN), ceil(ksize*ksize*C/TM)).  DY holds values already
// rounded to the compute dtype.
template <typename XT, typename DT>
__global__ void __launch_bounds__(THREADS)
conv_wgrad_kernel(const XT* __restrict__ X, const int* __restrict__ img, const DT* __restrict__ DY,
                  float* __restrict__ out, Gather g, int N) {
  grid_dependency_wait();
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
        if (n_st < N) b = ldf(DY, static_cast<size_t>(m) * N + n_st);
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

// ---------------------------------------------------------------------------
// the bf16 products on the tensor cores (bf16 bank)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros when !valid (src must still be an address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async wrote through the generic proxy; wgmma reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Every operand tile in shared memory is an array of 128-byte rows (64 bf16)
// in the 128-byte swizzle, its base a multiple of 1024: the 16-byte chunk c of
// row r lies at r*128 + ((c ^ (r & 7)) << 4).  For a K-major operand a row is
// one M (or N) index and holds 64 reduction elements; for an MN-major operand
// a row is one reduction index and holds 64 M (or N) indices, and wider tiles
// are column blocks of 64 side by side.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major: sbo = bytes
// between groups of 8 rows (1024), lbo unused.  MN-major: lbo = bytes between
// column blocks of 64, sbo = bytes between groups of 8 reduction rows (1024).
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], bf16 operands from shared memory,
// f32 accumulators: thread t of the warpgroup holds, for j = 0..15, rows
// 16*(t/32) + (t%32)/4 (d[4j], d[4j+1]) and that + 8 (d[4j+2], d[4j+3]) at
// columns 8j + 2*(t%4) and + 1.  TA / TB = 1: the operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// keeps the compiler from touching the accumulators while the products are in flight
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// names for the profiler: one per product, and one per launch that holds several
struct TagConv1Fwd;
struct TagConvScFwd;
struct TagConv2Fwd;
struct TagConv2Dx;
struct TagConv1ScFwd;
struct TagConv1Dw;
struct TagConv2Dw;
struct TagConvScDw;
struct TagDwAll;
struct TagDwAllAdam;

// One product of the forward / input-gradient kind:
// out[z][m, n] = sum over split z's K range of X[src(m, tap), c] * B[k, n], k = tap*C + c.
struct ConvJob {
  const bf16* X;    // activations [*, hin, hin, C]
  const int* img;   // bank rows to gather, or null
  const bf16* W;    // MODE 0: [K, N], n contiguous.  MODE 1: [taps, N, C], c (the reduction) contiguous
  float* out;       // [splits, R, N] partial sums
  Gather g;
  int kchunk;       // K range of a split, a multiple of MMA_KB
  int splits;
  size_t lx, limg, lw, lout;  // bytes from one lane's X, img, W, out to the next lane's (LaneLayout)
};
struct ConvJobs {
  ConvJob job[2];   // of a lane's job[0].splits + job[1].splits blocks along z, the first job[0].splits belong to job[0]
  int N;
  bool reverse;     // lanes last to first (LaneLayout)
};

// Grid: (N / MMA_N, ceil(R / 64), lanes * (job[0].splits + job[1].splits)),
// blockIdx.z = lane * (job[0].splits + job[1].splits) + split; one warpgroup.
// C and every kchunk are multiples of MMA_KB, N of MMA_N.
template <int MODE, typename TAG>
__global__ void __launch_bounds__(128)
conv_mma_kernel(const ConvJobs js) {
  // the lane's operands from the arguments alone, before the wait
  const int per_lane = js.job[0].splits + js.job[1].splits;
  const int slot = blockIdx.z / per_lane;
  const int lane = lane_at(slot, gridDim.z / per_lane, js.reverse);
  int z = blockIdx.z - slot * per_lane;
  const bool second = z >= js.job[0].splits;
  if (second) z -= js.job[0].splits;
  const ConvJob& j = second ? js.job[1] : js.job[0];
  const bf16* const jX = lane_ptr(j.X, j.lx, lane);
  const int* const jimg = lane_ptr(j.img, j.limg, lane);
  const bf16* const jW = lane_ptr(j.W, j.lw, lane);
  float* const jout = lane_ptr(j.out, j.lout, lane);
  grid_dependency_wait();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Gather g = j.g;
  const int N = js.N;
  const int hw = g.hout * g.hout;
  const int R = g.batch * hw;
  const int K = g.ksize * g.ksize * g.C;
  const int n0 = blockIdx.x * MMA_N, m0 = blockIdx.y * 64;
  const int kbeg = z * j.kchunk;
  const int nk = (min(K, kbeg + j.kchunk) - kbeg) / MMA_KB;
  const int tid = threadIdx.x, ch = tid % 8;

  // the four A rows this thread stages: tid/8 + 16 i, 16-byte chunk ch of each
  int rimg[4], roy[4], rox[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / 8 + 16 * i;
    rimg[i] = -1;
    roy[i] = rox[i] = 0;
    if (m < R) {
      const int b = m / hw, rem = m - b * hw;
      roy[i] = rem / g.hout;
      rox[i] = rem - roy[i] * g.hout;
      rimg[i] = jimg ? jimg[b] : b;
    }
  }

  auto load_stage = [&](int kb) {
    const uint32_t a_base = smem + (kb % CONV_STAGES) * CONV_STAGE_BYTES, b_base = a_base + 64 * 128;
    const int k0 = kbeg + kb * MMA_KB;
    const int tap = k0 / g.C, c0 = k0 - tap * g.C;
    const int ky = tap / g.ksize, kx = tap - ky * g.ksize;
    const int dy = g.sgn * (ky - g.pad), dx = g.sgn * (kx - g.pad);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 8 + 16 * i;
      const int iy = roy[i] * g.stride + dy, ix = rox[i] * g.stride + dx;
      const bool ok = rimg[i] >= 0 && iy >= 0 && iy < g.hin && ix >= 0 && ix < g.hin;
      const bf16* src = ok ? jX + (static_cast<size_t>(rimg[i] * g.hin + iy) * g.hin + ix) * g.C + c0 + 8 * ch : jX;
      cp_async16(a_base + swz(r, ch), src, ok);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = tid + 128 * i;
      if constexpr (MODE == 0) {  // MN-major: two column blocks of [64 k][64 n]
        const int jb = q / 512, r = (q / 8) % 64;
        cp_async16(b_base + jb * 64 * 128 + swz(r, ch),
                   jW + static_cast<size_t>(k0 + r) * N + n0 + 64 * jb + 8 * ch, true);
      } else {  // K-major: [128 n][64 k]
        const int r = q / 8;
        cp_async16(b_base + swz(r, ch),
                   jW + (static_cast<size_t>(tap) * N + n0 + r) * g.C + c0 + 8 * ch, true);
      }
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int s = 0; s < CONV_STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<CONV_STAGES - 2>();  // this thread's copies of stage kb have landed
    fence_proxy_async();
    __syncthreads();                  // everyone's have, and everyone is past the wgmma that read stage kb - 1
    if (kb + CONV_STAGES - 1 < nk) load_stage(kb + CONV_STAGES - 1);
    cp_async_commit();
    const uint32_t a_base = smem + (kb % CONV_STAGES) * CONV_STAGE_BYTES, b_base = a_base + 64 * 128;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MMA_KB / 16; ++kk) {
      const uint64_t da = mma_desc(a_base + 32 * kk, 16, 1024);
      if constexpr (MODE == 0)
        wgmma_m64n128k16<0, 1>(acc, da, mma_desc(b_base + 16 * 128 * kk, 64 * 128, 1024));
      else
        wgmma_m64n128k16<0, 0>(acc, da, mma_desc(b_base + 32 * kk, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
  }

  float* o = jout + static_cast<size_t>(z) * R * N;
  const int row = m0 + 16 * (tid / 32) + (tid % 32) / 4, col = n0 + 2 * (tid % 4);
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
    if (row < R)
      *reinterpret_cast<float2*>(o + static_cast<size_t>(row) * N + col + 8 * jn) = make_float2(acc[4 * jn], acc[4 * jn + 1]);
    if (row + 8 < R)
      *reinterpret_cast<float2*>(o + static_cast<size_t>(row + 8) * N + col + 8 * jn) =
          make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
  }
}

// One weight gradient: out[tap*C + c, n] = sum_m X[src(m, tap), c] * DY[m, n].
struct WgradJob {
  const bf16* X;
  const int* img;
  const bf16* DY;  // [R, N]
  float* out;      // [ksize*ksize*C, N]
  Gather g;
  int tiles;       // ceil(ksize*ksize*C / 128) * (N / MMA_N)
  size_t lx, limg, ldy;  // bytes from one lane's X, img, DY (and out) to the next lane's (LaneLayout)
};
struct WgradJobs {
  WgradJob job[3];
  int njobs, N;
};

// For the form of wgrad_mma_kernel that applies the Adam update instead of
// writing the gradients: the flat parameter buffer and its moments, the
// element offset of each job's weight in it, and the BN vectors (three
// segments of vec_len elements at vec_off, gradients read from `grads`),
// which `vec_blocks` extra blocks after the tiles update.
struct WgradAdam {
  void* p;
  bf16 *mu, *nu, *shadow;
  const float* grads;
  size_t off[3], vec_off[3];
  int vec_len, vec_blocks, tiles;
  AdamCoef k;
  size_t lp, ls;  // bytes from one lane's p to the next lane's, and from its mu, nu, shadow, grads
};

// Grid: (sum of the jobs' tiles [+ vec_blocks], lanes), blockIdx.y the lane;
// two warpgroups, each 64 of the tile's 128
// weight rows.  Both operands are MN-major (the reduction runs over the rows
// m, which are the slow index of X and of DY); rows m >= R are zero-filled.
// C is a multiple of 64, N of MMA_N.  PT = void: the tile goes to j.out.
// PT = the carry dtype: a weight-gradient tile is final (no split), so the
// block applies torch-Adam to its 128 x 128 weights right away and the f32
// gradients never reach memory; nothing else in the launch reads the weights.
// Two blocks an SM, so that one block's Adam update overlaps the other's
// products (the bound also makes ptxas schedule for it: 1.4 % faster at 20
// lanes, where the registers already allowed two).
template <typename TAG, typename PT>
__global__ void __launch_bounds__(256, 2)
wgrad_mma_kernel(const WgradJobs js, WgradAdam ad) {
  // the lane's operands from the arguments alone, before the wait
  const int lane = blockIdx.y;
  ad.p = lane_ptr(ad.p, ad.lp, lane);
  ad.mu = lane_ptr(ad.mu, ad.ls, lane);
  ad.nu = lane_ptr(ad.nu, ad.ls, lane);
  ad.shadow = ad.shadow ? lane_ptr(ad.shadow, ad.ls, lane) : nullptr;
  ad.grads = lane_ptr(ad.grads, ad.ls, lane);
  int t = blockIdx.x, ji = 0;
  while (ji + 1 < js.njobs && t >= js.job[ji].tiles) t -= js.job[ji++].tiles;
  WgradJob j = ji == 0 ? js.job[0] : (ji == 1 ? js.job[1] : js.job[2]);
  j.X = lane_ptr(j.X, j.lx, lane);
  j.img = lane_ptr(j.img, j.limg, lane);
  j.DY = lane_ptr(j.DY, j.ldy, lane);
  j.out = lane_ptr(j.out, j.ldy, lane);
  grid_dependency_wait();
  extern __shared__ unsigned char smem_raw[];
  __shared__ int srow[MAX_ROWS];  // (image << 16) | (oy << 8) | ox of each row m
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  if constexpr (!std::is_void<PT>::value) {
    if (static_cast<int>(blockIdx.x) >= ad.tiles) {  // the BN vectors
      const int first = ((blockIdx.x - ad.tiles) * 256 + threadIdx.x) * 8;
      for (int seg = 0; seg < 3; ++seg)
        for (int i = first; i < ad.vec_len; i += ad.vec_blocks * 256 * 8) {
          const size_t at = ad.vec_off[seg] + i;
          adam_eight(static_cast<PT*>(ad.p), ad.mu, ad.nu, ad.shadow, at, ld8(ad.grads, at), ad.k);
        }
      return;
    }
  }
  const Gather g = j.g;
  const int N = js.N;
  const int hw = g.hout * g.hout;
  const int R = g.batch * hw;
  const int MW = g.ksize * g.ksize * g.C;
  const int r0 = (t / (N / MMA_N)) * 128, n0 = (t % (N / MMA_N)) * MMA_N;
  const int tid = threadIdx.x, ch = tid % 8, wg = tid / 128;

  for (int m = tid; m < R; m += 256) {
    const int b = m / hw, rem = m - b * hw;
    const int oy = rem / g.hout, ox = rem - oy * g.hout;
    srow[m] = ((j.img ? j.img[b] : b) << 16) | (oy << 8) | ox;
  }
  // the two column blocks of A: 64 weight rows each, within one tap
  int cb_c0[2], cb_dy[2], cb_dx[2];
  bool cb_ok[2];
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    const int mrow = r0 + 64 * jb;
    cb_ok[jb] = mrow < MW;
    const int tap = mrow / g.C;
    cb_c0[jb] = mrow - tap * g.C;
    const int ky = tap / g.ksize, kx = tap - ky * g.ksize;
    cb_dy[jb] = g.sgn * (ky - g.pad);
    cb_dx[jb] = g.sgn * (kx - g.pad);
  }
  __syncthreads();
  const int nk = (R + WG_KB - 1) / WG_KB;

  auto load_stage = [&](int kb) {
    const uint32_t a_base = smem + (kb % MMA_STAGES) * WG_STAGE_BYTES, b_base = a_base + 2 * WG_KB * 128;
    const int r = tid / 8;  // 0..31: the reduction row within the stage
    const int m = kb * WG_KB + r;
    const int pk = m < R ? srow[m] : 0;
#pragma unroll
    for (int jb = 0; jb < 2; ++jb) {
      const int iy = ((pk >> 8) & 255) * g.stride + cb_dy[jb], ix = (pk & 255) * g.stride + cb_dx[jb];
      const bool ok = m < R && cb_ok[jb] && iy >= 0 && iy < g.hin && ix >= 0 && ix < g.hin;
      const bf16* src =
          ok ? j.X + (static_cast<size_t>((pk >> 16) * g.hin + iy) * g.hin + ix) * g.C + cb_c0[jb] + 8 * ch : j.X;
      cp_async16(a_base + jb * WG_KB * 128 + swz(r, ch), src, ok);
      const bool okb = m < R;
      cp_async16(b_base + jb * WG_KB * 128 + swz(r, ch),
                 okb ? j.DY + static_cast<size_t>(m) * N + n0 + 64 * jb + 8 * ch : j.DY, okb);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<MMA_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    if (kb + MMA_STAGES - 1 < nk) load_stage(kb + MMA_STAGES - 1);
    cp_async_commit();
    const uint32_t a_base = smem + (kb % MMA_STAGES) * WG_STAGE_BYTES + wg * WG_KB * 128;
    const uint32_t b_base = smem + (kb % MMA_STAGES) * WG_STAGE_BYTES + 2 * WG_KB * 128;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_KB / 16; ++kk)
      wgmma_m64n128k16<1, 1>(acc, mma_desc(a_base + 16 * 128 * kk, WG_KB * 128, 1024),
                             mma_desc(b_base + 16 * 128 * kk, WG_KB * 128, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_acc(acc);
  }

  const int row = r0 + 64 * wg + 16 * ((tid % 128) / 32) + (tid % 32) / 4, col = n0 + 2 * (tid % 4);
  if constexpr (!std::is_void<PT>::value) {
    // through shared memory (the ring is free now), so that the update moves 16 bytes a thread along N
    __syncthreads();  // every warp is past its last wgmma
    float* tile = reinterpret_cast<float*>(smem_raw + (smem - smem_u32(smem_raw)));
    const int lrow = 64 * wg + 16 * ((tid % 128) / 32) + (tid % 32) / 4, lcol = 2 * (tid % 4);
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      *reinterpret_cast<float2*>(tile + lrow * WG_TILE_LD + lcol + 8 * jn) = make_float2(acc[4 * jn], acc[4 * jn + 1]);
      *reinterpret_cast<float2*>(tile + (lrow + 8) * WG_TILE_LD + lcol + 8 * jn) =
          make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
    }
    __syncthreads();
    const size_t off = ji == 0 ? ad.off[0] : (ji == 1 ? ad.off[1] : ad.off[2]);
    PT* p = static_cast<PT*>(ad.p) + off;
    bf16 *mu = ad.mu + off, *nu = ad.nu + off, *shadow = ad.shadow ? ad.shadow + off : nullptr;
#pragma unroll 2
    for (int q = tid; q < 128 * MMA_N / 8; q += 256) {
      const int r = q / (MMA_N / 8), c8 = q % (MMA_N / 8);
      if (r0 + r < MW)
        adam_eight(p, mu, nu, shadow, static_cast<size_t>(r0 + r) * N + n0 + 8 * c8, ld8(tile, r * WG_TILE_LD + 8 * c8), ad.k);
    }
    return;
  }
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
    if (row < MW)
      *reinterpret_cast<float2*>(j.out + static_cast<size_t>(row) * N + col + 8 * jn) =
          make_float2(acc[4 * jn], acc[4 * jn + 1]);
    if (row + 8 < MW)
      *reinterpret_cast<float2*>(j.out + static_cast<size_t>(row + 8) * N + col + 8 * jn) =
          make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
  }
}

// ---------------------------------------------------------------------------
// BN, loss and Adam (f32 math, both routes)
// ---------------------------------------------------------------------------

// Sum over the block's THREADS threads of four values each, in a fixed order
// (a shuffle tree within each warp, then the warps in turn); every thread
// gets the same totals.
__device__ __forceinline__ float4 warp_sum4(float4 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
  }
  return v;
}

__device__ __forceinline__ float4 block_sum4(float4 v, float4* red) {
  v = warp_sum4(v);
  __syncthreads();  // the previous use of red is over
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float4 t = red[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) t = t + red[i];
  return t;
}

__device__ __forceinline__ float weight_sum(const float* w_t, int batch) {
  float s = 0.f;
  for (int b = 0; b < batch; ++b) s += w_t[b];
  return s;
}

// One BN of the forward: y = round_cd(sum_s parts[s]) [R, C]; xhat and inv are kept for the backward.
template <typename WT>
struct BnFwdJob {
  const float* parts;
  int S;
  const WT *scale, *bias;
  float *xhat, *inv;
};

// the job of lane `lane`: its parameters and its slice of the scratch
template <typename WT>
__device__ __forceinline__ BnFwdJob<WT> at_lane(BnFwdJob<WT> j, const LaneLayout& ln, int lane) {
  j.parts = lane_ptr(j.parts, ln.scratch, lane);
  j.scale = lane_ptr(j.scale, ln.param, lane);
  j.bias = lane_ptr(j.bias, ln.param, lane);
  j.xhat = lane_ptr(j.xhat, ln.scratch, lane);
  j.inv = lane_ptr(j.inv, ln.scratch, lane);
  return j;
}

// Masked batch-stats BN forward; a block owns BN_CH channels (16-byte
// accesses along C) and a thread up to BN_RPT rows, which stay in registers
// over the three passes.  NJ = 1: act = round_cd(relu(h)), the next conv's
// input.  NJ = 2: pre = h of j0 + h of j1, the block's pre-activation, and
// logits[b, c] = round_cd(mean over sample b's hw pixels of relu(pre)), the
// pooled features.  Grid: (C / BN_CH, lanes), blockIdx.y the lane (ln: where
// its operands lie; w_t is shared).
template <typename WT, bool CD_BF16, int NJ>
__global__ void __launch_bounds__(THREADS)
bn_fwd_kernel(BnFwdJob<WT> j0, BnFwdJob<WT> j1, const float* __restrict__ w_t, int batch, int hw, int C,
              typename Act<CD_BF16>::type* __restrict__ act, float* __restrict__ pre, float* __restrict__ logits,
              const LaneLayout ln) {
  const int lane = lane_at(blockIdx.y, gridDim.y, ln.reverse);
  act = lane_ptr(act, ln.scratch, lane);
  pre = lane_ptr(pre, ln.scratch, lane);
  logits = lane_ptr(logits, ln.scratch, lane);
  j0 = at_lane(j0, ln, lane);
  j1 = at_lane(j1, ln, lane);
  grid_dependency_wait();
  __shared__ float4 red[THREADS / 32];
  __shared__ float4 pool[NJ == 2 ? MAX_ROWS : 1];
  const int c = blockIdx.x * BN_CH, tid = threadIdx.x;
  const int R = batch * hw;
  const size_t RC = static_cast<size_t>(R) * C;
  const float count = fmaxf(weight_sum(w_t, batch), 1e-6f) * static_cast<float>(hw);
  float wr[BN_RPT];
#pragma unroll
  for (int i = 0; i < BN_RPT; ++i) {
    const int r = tid + THREADS * i;
    wr[i] = r < R ? w_t[r / hw] : 0.f;
  }
  float4 hsum[BN_RPT];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const BnFwdJob<WT> j = jj == 0 ? j0 : j1;
    float4 y[BN_RPT];
    float4 s = f4(0.f);
#pragma unroll
    for (int i = 0; i < BN_RPT; ++i) {
      const int r = tid + THREADS * i;
      y[i] = f4(0.f);
      if (r < R) {
        const size_t at = static_cast<size_t>(r) * C + c;
        for (int k = 0; k < j.S; ++k) y[i] = y[i] + ld4(j.parts, k * RC + at);
        y[i] = round_cd4<CD_BF16>(y[i]);
        s = s + y[i] * wr[i];
      }
    }
    const float4 mean = block_sum4(s, red) / count;
    s = f4(0.f);
#pragma unroll
    for (int i = 0; i < BN_RPT; ++i) {
      const float4 d = y[i] - mean;
      s = s + d * d * wr[i];  // wr is 0 beyond R
    }
    const float4 var = block_sum4(s, red) / count;
    const float4 inv = make_float4(1.0f / sqrtf(var.x + BN_EPS), 1.0f / sqrtf(var.y + BN_EPS),
                                   1.0f / sqrtf(var.z + BN_EPS), 1.0f / sqrtf(var.w + BN_EPS));
    const float4 sc = ld4(j.scale, c), bi = ld4(j.bias, c);
    if (tid == 0) st4(j.inv, c, inv);
#pragma unroll
    for (int i = 0; i < BN_RPT; ++i) {
      const int r = tid + THREADS * i;
      if (r >= R) continue;
      const size_t at = static_cast<size_t>(r) * C + c;
      const float4 xh = (y[i] - mean) * inv;
      st4(j.xhat, at, xh);
      const float4 h = bn_affine4(xh, sc, bi);
      if constexpr (NJ == 1) {
        st4(act, at, round_cd4<CD_BF16>(make_float4(fmaxf(h.x, 0.f), fmaxf(h.y, 0.f), fmaxf(h.z, 0.f), fmaxf(h.w, 0.f))));
      } else {
        hsum[i] = jj == 0 ? h : hsum[i] + h;
        if (jj == NJ - 1) {
          st4(pre, at, hsum[i]);
          pool[r] = make_float4(fmaxf(hsum[i].x, 0.f), fmaxf(hsum[i].y, 0.f), fmaxf(hsum[i].z, 0.f), fmaxf(hsum[i].w, 0.f));
        }
      }
    }
  }
  if constexpr (NJ == 2) {
    __syncthreads();
    for (int b = tid / 32; b < batch; b += THREADS / 32) {  // a warp per sample, a fixed shuffle tree
      float4 sum = f4(0.f);
      for (int p = tid % 32; p < hw; p += 32) sum = sum + pool[b * hw + p];
      sum = warp_sum4(sum);
      if (tid % 32 == 0) st4(logits, static_cast<size_t>(b) * C + c, round_cd4<CD_BF16>(sum / static_cast<float>(hw)));
    }
  }
}

__global__ void loss_kernel(const float* __restrict__ ce, const float* __restrict__ w_t, int batch,
                            float* __restrict__ loss) {
  grid_dependency_wait();
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    float s = 0.f;
    for (int b = 0; b < batch; ++b) s += ce[b];
    *loss = s / fmaxf(weight_sum(w_t, batch), 1.0f);
  }
}

// One BN of the backward: writes dy = round_cd(dx) and the scale/bias gradients.
template <typename WT, typename AT>
struct BnBwdJob {
  const float *xhat, *inv;
  const WT *scale, *bias;
  AT* dy;
  float *dscale, *dbias;
};

template <typename WT, typename AT>
__device__ __forceinline__ BnBwdJob<WT, AT> at_lane(BnBwdJob<WT, AT> j, const LaneLayout& ln, int lane) {
  j.xhat = lane_ptr(j.xhat, ln.scratch, lane);
  j.inv = lane_ptr(j.inv, ln.scratch, lane);
  j.scale = lane_ptr(j.scale, ln.param, lane);
  j.bias = lane_ptr(j.bias, ln.param, lane);
  j.dy = lane_ptr(j.dy, ln.scratch, lane);
  j.dscale = lane_ptr(j.dscale, ln.scratch, lane);
  j.dbias = lane_ptr(j.dbias, ln.scratch, lane);
  return j;
}

// What MODE 0 of bn_bwd_kernel needs for the loss: the pooled features as
// logits [B, C], the labels bank_y[idx_t[b]], and where ce[b] goes.
struct CeArgs {
  const float* logits;
  const int *bank_y, *idx_t;
  float* ce;
};

// Masked BN backward, cut like bn_fwd_kernel.  The incoming gradient g [R, C] is
//   MODE 0: pre[r, c] > 0 ? dlogits[r / hw, c] / hw : 0   (pool + ReLU
//           backward), shared by the two BNs j0 and j1 that were added into
//           pre.  dlogits is the masked softmax CE's gradient, computed here:
//           every block takes the softmax statistics of all batch samples
//           over the C logits (the same arithmetic in every block), then
//           dlogits[b, c] = (softmax - onehot) * w_b / denom for its own
//           channels; a label outside [0, C) has an all-zero one-hot.  Block
//           0 writes ce[b] = (lse - logit_y) * w_b.
//   MODE 1: h > 0 ? sum_s src[s][r, c] : 0 with h = xhat*scale + bias
//           (ReLU backward of j0's own output; src = split partial sums)
// Grid: (C / BN_CH, lanes), blockIdx.y the lane, as bn_fwd_kernel (bank_y is shared).
template <typename WT, bool CD_BF16, int MODE>
__global__ void __launch_bounds__(THREADS)
bn_bwd_kernel(const float* __restrict__ src, int S, const float* __restrict__ pre, CeArgs ce,
              BnBwdJob<WT, typename Act<CD_BF16>::type> j0, BnBwdJob<WT, typename Act<CD_BF16>::type> j1,
              const float* __restrict__ w_t, int batch, int hw, int C, const LaneLayout ln) {
  const int lane = lane_at(blockIdx.y, gridDim.y, ln.reverse);
  src = lane_ptr(src, ln.scratch, lane);
  pre = lane_ptr(pre, ln.scratch, lane);
  ce.logits = lane_ptr(ce.logits, ln.scratch, lane);
  ce.idx_t = lane_ptr(ce.idx_t, ln.idx, lane);
  ce.ce = lane_ptr(ce.ce, ln.scratch, lane);
  j0 = at_lane(j0, ln, lane);
  j1 = at_lane(j1, ln, lane);
  grid_dependency_wait();
  __shared__ float4 red[THREADS / 32];
  __shared__ float zmax_s[MODE == 0 ? MAX_ROWS : 1], se_s[MODE == 0 ? MAX_ROWS : 1];
  const int c = blockIdx.x * BN_CH, tid = threadIdx.x;
  const int R = batch * hw;
  const size_t RC = static_cast<size_t>(R) * C;
  const float wsum = weight_sum(w_t, batch);
  const float count = fmaxf(wsum, 1e-6f) * static_cast<float>(hw);
  if constexpr (MODE == 0) {
    for (int b = tid / 32; b < batch; b += THREADS / 32) {  // a warp per sample, fixed shuffle trees
      const float* lg = ce.logits + static_cast<size_t>(b) * C;
      float zmax = -INFINITY;
      for (int k = tid % 32; k < C; k += 32) zmax = fmaxf(zmax, lg[k]);
      for (int o = 16; o > 0; o >>= 1) zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, o));
      float se = 0.f;
      for (int k = tid % 32; k < C; k += 32) se += expf(lg[k] - zmax);
      for (int o = 16; o > 0; o >>= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
      if (tid % 32 == 0) {
        zmax_s[b] = zmax;
        se_s[b] = se;
        if (blockIdx.x == 0) {
          const int y = ce.bank_y[ce.idx_t[b]];
          ce.ce[b] = (logf(se) + zmax - ((y >= 0 && y < C) ? lg[y] : 0.f)) * w_t[b];
        }
      }
    }
    __syncthreads();
  }
  const float denom = fmaxf(wsum, 1.0f);
  float wr[BN_RPT];
  float4 gv[BN_RPT];
#pragma unroll
  for (int i = 0; i < BN_RPT; ++i) {
    const int r = tid + THREADS * i;
    wr[i] = r < R ? w_t[r / hw] : 0.f;
    gv[i] = f4(0.f);
    if (MODE == 0 && r < R) {
      const int b = r / hw;
      const float4 m = ld4(pre, static_cast<size_t>(r) * C + c);
      const float4 lg = ld4(ce.logits, static_cast<size_t>(b) * C + c);
      const int y = ce.bank_y[ce.idx_t[b]] - c;  // the label's place among this block's channels
      const float zmax = zmax_s[b], se = se_s[b], coef = wr[i] / denom, fhw = static_cast<float>(hw);
      const float4 d = make_float4((expf(lg.x - zmax) / se - (y == 0 ? 1.0f : 0.0f)) * coef / fhw,
                                   (expf(lg.y - zmax) / se - (y == 1 ? 1.0f : 0.0f)) * coef / fhw,
                                   (expf(lg.z - zmax) / se - (y == 2 ? 1.0f : 0.0f)) * coef / fhw,
                                   (expf(lg.w - zmax) / se - (y == 3 ? 1.0f : 0.0f)) * coef / fhw);
      gv[i] = make_float4(m.x > 0.f ? d.x : 0.f, m.y > 0.f ? d.y : 0.f, m.z > 0.f ? d.z : 0.f, m.w > 0.f ? d.w : 0.f);
    }
  }
#pragma unroll
  for (int jj = 0; jj < (MODE == 0 ? 2 : 1); ++jj) {
    const BnBwdJob<WT, typename Act<CD_BF16>::type> j = jj == 0 ? j0 : j1;
    const float4 sc = ld4(j.scale, c);
    float4 xh[BN_RPT];
    float4 a_gx = f4(0.f), a_g = f4(0.f), a_1 = f4(0.f), a_2 = f4(0.f);
#pragma unroll
    for (int i = 0; i < BN_RPT; ++i) {
      const int r = tid + THREADS * i;
      xh[i] = f4(0.f);
      if (r >= R) continue;
      const size_t at = static_cast<size_t>(r) * C + c;
      xh[i] = ld4(j.xhat, at);
      if constexpr (MODE == 1) {
        const float4 h = bn_affine4(xh[i], sc, ld4(j.bias, c));
        float4 t = f4(0.f);
        for (int k = 0; k < S; ++k) t = t + ld4(src, k * RC + at);
        gv[i] = make_float4(h.x > 0.f ? t.x : 0.f, h.y > 0.f ? t.y : 0.f, h.z > 0.f ? t.z : 0.f, h.w > 0.f ? t.w : 0.f);
      }
      const float4 dxh = gv[i] * sc;
      a_gx = a_gx + gv[i] * xh[i];
      a_g = a_g + gv[i];
      a_1 = a_1 + dxh * wr[i];
      a_2 = a_2 + dxh * xh[i] * wr[i];
    }
    const float4 t_gx = block_sum4(a_gx, red);
    const float4 t_g = block_sum4(a_g, red);
    const float4 m1 = block_sum4(a_1, red) / count;
    const float4 m2 = block_sum4(a_2, red) / count;
    if (tid == 0) {
      st4(j.dscale, c, t_gx);
      st4(j.dbias, c, t_g);
    }
    const float4 inv = ld4(j.inv, c);
#pragma unroll
    for (int i = 0; i < BN_RPT; ++i) {
      const int r = tid + THREADS * i;
      if (r >= R) continue;
      const float4 dxh = gv[i] * sc;
      st4(j.dy, static_cast<size_t>(r) * C + c, round_cd4<CD_BF16>((dxh - m1 - xh[i] * m2) * inv * wr[i]));
    }
  }
}

// torch-Adam over a flat parameter buffer, eight elements a thread (16-byte
// accesses): moments stored bf16, the parameter rounded to its carry dtype.
// `shadow` (or null) receives the new parameters rounded to bf16, for the
// tensor-core products under an f32 carry.  n is a multiple of 8.
template <typename PT>
__global__ void __launch_bounds__(THREADS)
adam_kernel(PT* __restrict__ p, bf16* __restrict__ mu, bf16* __restrict__ nu, const float* __restrict__ g,
            bf16* __restrict__ shadow, size_t n, AdamCoef k) {
  grid_dependency_wait();
  const size_t i = (static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x) * 8;
  if (i < n) adam_eight(p, mu, nu, shadow, i, ld8(g, i), k);
}

// bf16 copy of f32 parameters (the tensor-core products' weights under an f32
// carry); blockIdx.y the lane
__global__ void __launch_bounds__(THREADS)
round_params_kernel(const float* __restrict__ p, bf16* __restrict__ shadow, size_t n, const LaneLayout ln) {
  p = lane_ptr(p, ln.param, blockIdx.y);
  shadow = lane_ptr(shadow, ln.wq, blockIdx.y);
  grid_dependency_wait();
  const size_t i = (static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x) * 8;
  if (i < n) st8(shadow, i, ld8(p, i));
}

// out = sum_s parts[s], in the order the BN kernels add the splits (single products only)
__global__ void __launch_bounds__(THREADS)
sum_parts_kernel(const float* __restrict__ parts, int S, size_t n, float* __restrict__ out) {
  grid_dependency_wait();
  const size_t i = (static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x) * 4;
  if (i >= n) return;
  float4 y = f4(0.f);
  for (int k = 0; k < S; ++k) y = y + ld4(parts, k * n + i);
  st4(out, i, y);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Geom {
  int h_in, c_in, c_out, stride, batch, h_out, hw, rows;
};

// mma: the tensor-core products will run (wider channel multiples)
bool make_geom(int h_in, int c_in, int c_out, int stride, int batch, bool mma, Geom* g) {
  if (h_in <= 0 || c_in <= 0 || c_out <= 0 || batch <= 0) return false;
  if ((stride != 1 && stride != 2) || h_in % stride) return false;
  if (c_in % KT || c_out % KT || h_in > 255) return false;
  if (mma && (c_in % MMA_KB || c_out % MMA_N)) return false;
  const int h_out = h_in / stride;
  if (batch * h_out * h_out > MAX_ROWS) return false;
  *g = Geom{h_in, c_in, c_out, stride, batch, h_out, h_out * h_out, batch * h_out * h_out};
  return true;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// K range per split of a GEMM with `rows` x `cols` outputs in tm x tn tiles,
// so that about `target` blocks run; a multiple of kt
int split_chunk(int rows, int cols, int K, int tm, int tn, int kt, int target) {
  const int tiles = cdiv(rows, tm) * cdiv(cols, tn);
  const int want = target / tiles > 1 ? target / tiles : 1;
  return cdiv(cdiv(K, want), kt) * kt;
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
  size_t mu, nu, grads, shadow, part, part_sc, xhat1, z1, xhat2, xhats, pre, dy2, dys, dy1, inv1, inv2, invs, logits,
      ce, total;
  int chunk1, chunk2, splits1, splits2;
};

Scratch make_scratch(const Geom& g, bool mma) {
  Scratch s;
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  const size_t np = param_offsets(g).total;
  const size_t rc = static_cast<size_t>(g.rows) * g.c_out * sizeof(float);
  if (mma) {
    s.chunk1 = split_chunk(g.rows, g.c_out, 9 * g.c_in, 64, MMA_N, MMA_KB, MMA_TARGET_BLOCKS);
    s.chunk2 = split_chunk(g.rows, g.c_out, 9 * g.c_out, 64, MMA_N, MMA_KB, MMA_TARGET_BLOCKS);
  } else {
    s.chunk1 = split_chunk(g.rows, g.c_out, 9 * g.c_in, TM, TN, KT, TARGET_BLOCKS);
    s.chunk2 = split_chunk(g.rows, g.c_out, 9 * g.c_out, TM, TN, KT, TARGET_BLOCKS);
  }
  s.splits1 = cdiv(9 * g.c_in, s.chunk1);
  s.splits2 = cdiv(9 * g.c_out, s.chunk2);
  s.mu = take(np * sizeof(bf16));
  s.nu = take(np * sizeof(bf16));
  s.grads = take(np * sizeof(float));
  s.shadow = take(np * sizeof(bf16));  // used with an f32 carry on the tensor-core route
  s.part = take(rc * (s.splits1 > s.splits2 ? s.splits1 : s.splits2));
  s.part_sc = take(rc);
  // z1 and the dy are bf16 with a bf16 bank; sized for f32
  s.xhat1 = take(rc), s.z1 = take(rc), s.xhat2 = take(rc), s.xhats = take(rc), s.pre = take(rc);
  s.dy2 = take(rc), s.dys = take(rc), s.dy1 = take(rc);
  s.inv1 = take(g.c_out * sizeof(float)), s.inv2 = take(g.c_out * sizeof(float)), s.invs = take(g.c_out * sizeof(float));
  s.logits = take(static_cast<size_t>(g.batch) * g.c_out * sizeof(float));
  s.ce = take(g.batch * sizeof(float));
  s.total = at;
  return s;
}

// Every kernel goes out as a programmatic dependent launch: its blocks may
// be placed while its predecessor on the stream drains, and before its first
// access to memory it calls grid_dependency_wait(), which holds it until that
// predecessor has completed and its writes are visible.
template <typename... P, typename... A>
void launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem, cudaStream_t st, A&&... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);  // LAUNCH_CHECK() reads the error
}

#define LAUNCH_CHECK()                                      \
  do {                                                      \
    const cudaError_t e_ = cudaGetLastError();              \
    if (e_ != cudaSuccess) return static_cast<int>(e_);     \
  } while (0)

// the tensor-core kernels use more than 48 KB of dynamic shared memory
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the limit is a setting of the current device: raised once on each card, under a lock (the eval's mesh launches
// on several cards); a failure is not kept, the next call retries
int configure_mma() {
  constexpr int MAX_DEVICES = 64;
  static std::mutex mu;
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= MAX_DEVICES) e = cudaErrorInvalidDevice;
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> lock(mu);
  if (ready[dev]) return 0;
  e = allow_smem(conv_mma_kernel<0, TagConv1Fwd>, CONV_SMEM);
  if (e == cudaSuccess) e = allow_smem(conv_mma_kernel<0, TagConvScFwd>, CONV_SMEM);
  if (e == cudaSuccess) e = allow_smem(conv_mma_kernel<0, TagConv2Fwd>, CONV_SMEM);
  if (e == cudaSuccess) e = allow_smem(conv_mma_kernel<0, TagConv1ScFwd>, CONV_SMEM);
  if (e == cudaSuccess) e = allow_smem(conv_mma_kernel<1, TagConv2Dx>, CONV_SMEM);
  if (e == cudaSuccess) e = allow_smem(wgrad_mma_kernel<TagConv1Dw, void>, WG_SMEM);
  if (e == cudaSuccess) e = allow_smem(wgrad_mma_kernel<TagConv2Dw, void>, WG_SMEM);
  if (e == cudaSuccess) e = allow_smem(wgrad_mma_kernel<TagConvScDw, void>, WG_SMEM);
  if (e == cudaSuccess) e = allow_smem(wgrad_mma_kernel<TagDwAll, void>, WG_SMEM);
  if (e == cudaSuccess) e = allow_smem(wgrad_mma_kernel<TagDwAllAdam, bf16>, WG_SMEM);
  if (e == cudaSuccess) e = allow_smem(wgrad_mma_kernel<TagDwAllAdam, float>, WG_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  ready[dev] = true;
  return 0;
}

// the gathers of the block's convolutions
struct Gathers {
  Gather in3, in1, mid3, mid3t;
};
Gathers make_gathers(const Geom& g) {
  return Gathers{
      {g.batch, g.h_out, g.h_in, g.stride, 3, 1, 1, g.c_in},   // conv1 over the bank
      {g.batch, g.h_out, g.h_in, g.stride, 1, 0, 1, g.c_in},   // shortcut over the bank
      {g.batch, g.h_out, g.h_out, 1, 3, 1, 1, g.c_out},        // conv2 over z1
      {g.batch, g.h_out, g.h_out, 1, 3, 1, -1, g.c_out}};      // conv2's input gradient over dy2
}

// lanes: the lanes of one grid (the jobs' lane strides say where each lies)
template <int MODE, typename TAG>
int launch_conv_mma(const Geom& g, const ConvJob& a, const ConvJob* b, cudaStream_t st, int lanes = 1,
                    bool reverse = false) {
  ConvJobs js;
  js.job[0] = a;
  js.job[1] = b ? *b : a;
  if (!b) js.job[1].splits = 0;
  js.N = g.c_out;
  js.reverse = reverse;
  const dim3 grid(g.c_out / MMA_N, cdiv(g.rows, 64), lanes * (js.job[0].splits + js.job[1].splits));
  launch(conv_mma_kernel<MODE, TAG>, grid, 128, CONV_SMEM, st, js);
  LAUNCH_CHECK();
  return 0;
}

WgradJob wgrad_job(const Geom& g, const bf16* X, const int* img, const bf16* DY, float* out, const Gather& ga,
                   size_t lx = 0, size_t limg = 0, size_t ldy = 0) {
  return WgradJob{X, img, DY, out, ga, cdiv(ga.ksize * ga.ksize * ga.C, 128) * (g.c_out / MMA_N), lx, limg, ldy};
}

// adam: null to write the gradients; else the update is applied in place (PT: the carry dtype).  lanes: as
// launch_conv_mma's
template <typename TAG, typename PT = void>
int launch_wgrad_mma(const Geom& g, const WgradJob* jobs, int njobs, const WgradAdam* adam, cudaStream_t st,
                     int lanes = 1) {
  WgradJobs js;
  int tiles = 0;
  for (int i = 0; i < 3; ++i) {
    js.job[i] = jobs[i < njobs ? i : 0];
    if (i < njobs) tiles += jobs[i].tiles;
  }
  js.njobs = njobs;
  js.N = g.c_out;
  WgradAdam ad = adam ? *adam : WgradAdam{};
  ad.tiles = tiles;
  launch(wgrad_mma_kernel<TAG, PT>, dim3(tiles + ad.vec_blocks, lanes), 256, WG_SMEM, st, js, ad);
  LAUNCH_CHECK();
  return 0;
}

// Forward and backward of one minibatch: the gradients of the flat parameters
// p go to `grads` (every element is written).  PT: carry dtype of p; XT: the
// bank's dtype, which is the compute dtype; MMA: the products' route.  wq: the
// parameters as bf16 (p itself under a bf16 carry), read by the MMA route only.
// adam (MMA route only; p, mu, nu, shadow and the coefficients filled in):
// the weight-gradient launch applies the update instead of writing the conv
// gradients; the BN gradients still pass through `grads`.  ln: the lanes that
// each grid steps together (the MMA route; the FMA kernels take one lane),
// every pointer here being lane 0's; w_t and bank_y are shared.
template <typename PT, typename XT, bool MMA>
int enqueue_grads(const Geom& g, const Scratch& s, char* scratch, const PT* p, const bf16* wq, const XT* bank,
                  const int* bank_y, const int* idx_t, const float* w_t, float* grads, const WgradAdam* adam,
                  const LaneLayout& ln, cudaStream_t st) {
  constexpr bool CD = sizeof(XT) == sizeof(bf16);
  typedef typename Act<CD>::type AT;
  const ParamOffsets o = param_offsets(g);
  auto f = [scratch](size_t off) { return reinterpret_cast<float*>(scratch + off); };
  auto a = [scratch](size_t off) { return reinterpret_cast<AT*>(scratch + off); };
  float *part = f(s.part), *part_sc = f(s.part_sc), *xhat1 = f(s.xhat1), *xhat2 = f(s.xhat2), *xhats = f(s.xhats),
        *pre = f(s.pre), *inv1 = f(s.inv1), *inv2 = f(s.inv2), *invs = f(s.invs), *logits = f(s.logits), *ce = f(s.ce);
  AT *z1 = a(s.z1), *dy2 = a(s.dy2), *dys = a(s.dys), *dy1 = a(s.dy1);
  const int R = g.rows, ci = g.c_in, co = g.c_out, B = g.batch, hw = g.hw;
  const Gathers ga = make_gathers(g);
  const dim3 tiles(cdiv(co, TN), cdiv(R, TM));
  const dim3 tiles1(tiles.x, tiles.y, s.splits1), tiles2(tiles.x, tiles.y, s.splits2);  // K split over z
  const dim3 wg1(cdiv(co, TN), cdiv(9 * ci, TM)), wg2(cdiv(co, TN), cdiv(9 * co, TM)), wgsc(cdiv(co, TN), cdiv(ci, TM));
  const dim3 bn_grid(co / BN_CH, ln.n);
  int err;
  if (!MMA && ln.n != 1) return static_cast<int>(cudaErrorInvalidValue);
  // each kernel takes the lanes in the reverse order of the one before it (lane_at); the weight-gradient
  // launch, last, goes first to last
  LaneLayout up = ln, down = ln;
  up.reverse = false, down.reverse = true;

  // forward
  if constexpr (MMA) {
    const ConvJob c1{reinterpret_cast<const bf16*>(bank), idx_t, wq + o.conv1, part, ga.in3, s.chunk1, s.splits1,
                     ln.bank, ln.idx, ln.wq, ln.scratch};
    const ConvJob sc{reinterpret_cast<const bf16*>(bank), idx_t, wq + o.conv_sc, part_sc, ga.in1, ci, 1,
                     ln.bank, ln.idx, ln.wq, ln.scratch};
    if ((err = launch_conv_mma<0, TagConv1ScFwd>(g, c1, &sc, st, ln.n, true))) return err;
  } else {
    launch(conv_gemm_kernel<XT, PT, CD, false>, tiles1, THREADS, 0, st,
        bank, idx_t, p + o.conv1, part, ga.in3, co, ci * co, co, 1, s.chunk1);
    LAUNCH_CHECK();
    launch(conv_gemm_kernel<XT, PT, CD, false>, tiles, THREADS, 0, st, bank, idx_t, p + o.conv_sc, part_sc, ga.in1, co, 0,
                                                                   co, 1, ci);
    LAUNCH_CHECK();
  }
  const BnFwdJob<PT> f1{part, s.splits1, p + o.bn1_s, p + o.bn1_b, xhat1, inv1};
  launch(bn_fwd_kernel<PT, CD, 1>, bn_grid, THREADS, 0, st, f1, f1, w_t, B, hw, co, z1, nullptr, nullptr, up);
  LAUNCH_CHECK();
  if constexpr (MMA) {
    const ConvJob c2{reinterpret_cast<const bf16*>(z1), nullptr, wq + o.conv2, part, ga.mid3, s.chunk2, s.splits2,
                     ln.scratch, 0, ln.wq, ln.scratch};
    if ((err = launch_conv_mma<0, TagConv2Fwd>(g, c2, nullptr, st, ln.n, true))) return err;
  } else {
    launch(conv_gemm_kernel<AT, PT, CD, false>, tiles2, THREADS, 0, st,
        z1, nullptr, p + o.conv2, part, ga.mid3, co, co * co, co, 1, s.chunk2);
    LAUNCH_CHECK();
  }
  const BnFwdJob<PT> f2{part, s.splits2, p + o.bn2_s, p + o.bn2_b, xhat2, inv2};
  const BnFwdJob<PT> fs{part_sc, 1, p + o.bnsc_s, p + o.bnsc_b, xhats, invs};
  launch(bn_fwd_kernel<PT, CD, 2>, bn_grid, THREADS, 0, st, f2, fs, w_t, B, hw, co, nullptr, pre, logits, up);
  LAUNCH_CHECK();

  // backward
  const BnBwdJob<PT, AT> b2{xhat2, inv2, p + o.bn2_s, p + o.bn2_b, dy2, grads + o.bn2_s, grads + o.bn2_b};
  const BnBwdJob<PT, AT> bs{xhats, invs, p + o.bnsc_s, p + o.bnsc_b, dys, grads + o.bnsc_s, grads + o.bnsc_b};
  launch(bn_bwd_kernel<PT, CD, 0>, bn_grid, THREADS, 0, st, nullptr, 0, pre, CeArgs{logits, bank_y, idx_t, ce}, b2, bs, w_t, B, hw,
                                                         co, down);
  LAUNCH_CHECK();
  if constexpr (MMA) {
    const ConvJob dx{reinterpret_cast<const bf16*>(dy2), nullptr, wq + o.conv2, part, ga.mid3t, s.chunk2, s.splits2,
                     ln.scratch, 0, ln.wq, ln.scratch};
    if ((err = launch_conv_mma<1, TagConv2Dx>(g, dx, nullptr, st, ln.n, false))) return err;
  } else {
    launch(conv_wgrad_kernel<AT, AT>, wg2, THREADS, 0, st, z1, nullptr, dy2, grads + o.conv2, ga.mid3, co);
    LAUNCH_CHECK();
    launch(conv_gemm_kernel<AT, PT, CD, true>, tiles2, THREADS, 0, st,
        dy2, nullptr, p + o.conv2, part, ga.mid3t, co, co * co, 1, co, s.chunk2);
    LAUNCH_CHECK();
  }
  const BnBwdJob<PT, AT> b1{xhat1, inv1, p + o.bn1_s, p + o.bn1_b, dy1, grads + o.bn1_s, grads + o.bn1_b};
  launch(bn_bwd_kernel<PT, CD, 1>, bn_grid, THREADS, 0, st, part, s.splits2, nullptr, CeArgs{}, b1, b1, w_t, B, hw, co, down);
  LAUNCH_CHECK();
  if constexpr (MMA) {
    const bf16* xb = reinterpret_cast<const bf16*>(bank);
    const WgradJob jobs[3] = {
        wgrad_job(g, reinterpret_cast<const bf16*>(z1), nullptr, reinterpret_cast<const bf16*>(dy2), grads + o.conv2, ga.mid3,
                  ln.scratch, 0, ln.scratch),
        wgrad_job(g, xb, idx_t, reinterpret_cast<const bf16*>(dy1), grads + o.conv1, ga.in3, ln.bank, ln.idx, ln.scratch),
        wgrad_job(g, xb, idx_t, reinterpret_cast<const bf16*>(dys), grads + o.conv_sc, ga.in1, ln.bank, ln.idx,
                  ln.scratch)};
    if (adam) {  // the jobs' order: conv2, conv1, the shortcut
      WgradAdam ad = *adam;
      ad.off[0] = o.conv2, ad.off[1] = o.conv1, ad.off[2] = o.conv_sc;
      ad.vec_off[0] = o.bn1_s, ad.vec_off[1] = o.bn2_s, ad.vec_off[2] = o.bnsc_s;  // each scale with its bias behind it
      ad.vec_len = 2 * co;
      ad.vec_blocks = 2;
      ad.grads = grads;
      ad.lp = ln.param, ad.ls = ln.scratch;
      if ((err = launch_wgrad_mma<TagDwAllAdam, PT>(g, jobs, 3, &ad, st, ln.n))) return err;
    } else if ((err = launch_wgrad_mma<TagDwAll>(g, jobs, 3, nullptr, st, ln.n))) {
      return err;
    }
  } else {
    launch(conv_wgrad_kernel<XT, AT>, wg1, THREADS, 0, st, bank, idx_t, dy1, grads + o.conv1, ga.in3, co);
    LAUNCH_CHECK();
    launch(conv_wgrad_kernel<XT, AT>, wgsc, THREADS, 0, st, bank, idx_t, dys, grads + o.conv_sc, ga.in1, co);
    LAUNCH_CHECK();
  }
  return 0;
}

constexpr int KERNELS_PER_STEP_MMA = 8;
constexpr int KERNELS_PER_STEP_FMA = 12;

// one lane, for the entry points that run a single step or product
constexpr LaneLayout ONE_LANE = {1, 0, 0, 0, 0, 0, false};

// the bf16 weights the tensor-core products read: p itself, or the shadow copy made here, one launch for every
// lane of ln (whose wq stride is then the scratch's)
template <typename PT>
int bf16_weights(const PT* p, size_t np, char* scratch, const Scratch& s, const LaneLayout& ln, cudaStream_t st,
                 const bf16** wq) {
  if constexpr (sizeof(PT) == sizeof(bf16)) {
    *wq = reinterpret_cast<const bf16*>(p);
  } else {
    bf16* shadow = reinterpret_cast<bf16*>(scratch + s.shadow);
    launch(round_params_kernel, dim3(static_cast<int>((np / 8 + THREADS - 1) / THREADS), ln.n), THREADS, 0, st, p,
           shadow, np, ln);
    LAUNCH_CHECK();
    *wq = shadow;
  }
  return 0;
}

// The scan.  The tensor-core route walks the T steps once, each of a step's
// 8 kernels covering every lane in one grid; each lane keeps its own slice
// of the scratch (s.total bytes apart), its own tiling, split-K chunks and
// reduction order, so a lane's bits are those of a call with that lane
// alone.  The FMA route runs the lanes one after another on one slice.
template <typename PT, typename XT>
int enqueue_scan(const Geom& g, PT* p, const XT* bank, const int* bank_y, const int* idx, const float* w,
                 char* scratch, int L, int T, int span, float lr, cudaStream_t st) {
  constexpr bool MMA = sizeof(XT) == sizeof(bf16);
  constexpr bool SHADOW = MMA && sizeof(PT) != sizeof(bf16);
  const Scratch s = make_scratch(g, MMA);
  const size_t np = param_offsets(g).total;
  const size_t lane_bank = static_cast<size_t>(span) * g.h_in * g.h_in * g.c_in;
  bf16* mu = reinterpret_cast<bf16*>(scratch + s.mu);
  bf16* nu = reinterpret_cast<bf16*>(scratch + s.nu);
  float* grads = reinterpret_cast<float*>(scratch + s.grads);
  bf16* shadow = SHADOW ? reinterpret_cast<bf16*>(scratch + s.shadow) : nullptr;
  const float log_b1 = static_cast<float>(log(0.9)), log_b2 = static_cast<float>(log(0.999));
  const int adam_blocks = static_cast<int>((np / 8 + THREADS - 1) / THREADS);
  if (MMA) {
    const int err = configure_mma();
    if (err) return err;
  }
  const int n = MMA ? L : 1;  // the lanes a pass steps together
  for (int l0 = 0; l0 < L; l0 += n) {
    const LaneLayout ln = {n, s.total, np * sizeof(PT), SHADOW ? s.total : np * sizeof(PT), lane_bank * sizeof(XT),
                           static_cast<size_t>(T) * g.batch * sizeof(int), false};
    PT* pl = p + static_cast<size_t>(l0) * np;
    // every lane's moments: mu and nu lie side by side (up to padding) in each lane's slice
    const cudaError_t e = cudaMemset2DAsync(mu, s.total, 0, s.nu - s.mu + np * sizeof(bf16), n, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bf16* wq = nullptr;
    if (MMA) {
      const int err = bf16_weights<PT>(pl, np, scratch, s, ln, st, &wq);
      if (err) return err;
    }
    for (int t = 0; t < T; ++t) {
      const float tf = static_cast<float>(t + 1);
      const AdamCoef coef{-lr, 1.0f - expf(tf * log_b1), 1.0f - expf(tf * log_b2)};
      WgradAdam ad = {};
      ad.p = pl, ad.mu = mu, ad.nu = nu, ad.shadow = shadow, ad.k = coef;
      const int err = enqueue_grads<PT, XT, MMA>(g, s, scratch, pl, wq, bank + l0 * lane_bank, bank_y,
                                                 idx + (static_cast<size_t>(l0) * T + t) * g.batch,
                                                 w + static_cast<size_t>(t) * g.batch, grads, MMA ? &ad : nullptr, ln,
                                                 st);
      if (err) return err;
      if (!MMA) {  // the tensor-core route updated in its weight-gradient launch
        launch(adam_kernel<PT>, adam_blocks, THREADS, 0, st, pl, mu, nu, grads, shadow, np, coef);
        LAUNCH_CHECK();
      }
    }
  }
  return 0;
}

template <typename PT>
int scan_entry(void* p, const void* bank, int bank_is_bf16, const int* bank_y, const int* idx, const float* w,
               void* scratch, int L, int T, int span, int h_in, int c_in, int c_out, int stride, int batch, float lr,
               void* stream) {
  Geom g;
  if (!make_geom(h_in, c_in, c_out, stride, batch, bank_is_bf16 != 0, &g) || span <= 0 || span >= 32768 || L < 0 ||
      T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bank_is_bf16) {  // the lanes share each grid: the conv products' z, lanes times their slices, has to fit
    const Scratch s = make_scratch(g, true);
    const int slices = s.splits1 + 1 > s.splits2 ? s.splits1 + 1 : s.splits2;
    if (L > 65535 / slices) return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bank_is_bf16)
    return enqueue_scan<PT, bf16>(g, static_cast<PT*>(p), static_cast<const bf16*>(bank), bank_y, idx, w,
                                  static_cast<char*>(scratch), L, T, span, lr, st);
  return enqueue_scan<PT, float>(g, static_cast<PT*>(p), static_cast<const float*>(bank), bank_y, idx, w,
                                 static_cast<char*>(scratch), L, T, span, lr, st);
}

template <typename PT, typename XT, bool MMA>
int grads_once(const Geom& g, const PT* p, const XT* bank, const int* bank_y, const int* idx_t, const float* w_t,
               char* scratch, float* grads, float* loss, cudaStream_t st) {
  const Scratch s = make_scratch(g, MMA);
  const bf16* wq = nullptr;
  if (MMA) {
    int err = configure_mma();
    if (!err) err = bf16_weights<PT>(p, param_offsets(g).total, scratch, s, ONE_LANE, st, &wq);
    if (err) return err;
  }
  const int err = enqueue_grads<PT, XT, MMA>(g, s, scratch, p, wq, bank, bank_y, idx_t, w_t, grads, nullptr, ONE_LANE,
                                             st);
  if (err) return err;
  launch(loss_kernel, 1, 32, 0, st, reinterpret_cast<const float*>(scratch + s.ce), w_t, g.batch, loss);
  LAUNCH_CHECK();
  return 0;
}

// route: 0 = the scan's own (tensor cores for a bf16 bank), 1 = the FMA products
template <typename PT>
int grads_entry(const void* p, const void* bank, int bank_is_bf16, const int* bank_y, const int* idx_t,
                const float* w_t, void* scratch, float* grads, float* loss, int span, int h_in, int c_in, int c_out,
                int stride, int batch, int route, void* stream) {
  Geom g;
  const bool mma = bank_is_bf16 && route == 0;
  if (!make_geom(h_in, c_in, c_out, stride, batch, mma, &g) || span <= 0 || span >= 32768 || route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PT* pp = static_cast<const PT*>(p);
  char* sc = static_cast<char*>(scratch);
  if (mma) return grads_once<PT, bf16, true>(g, pp, static_cast<const bf16*>(bank), bank_y, idx_t, w_t, sc, grads, loss, st);
  if (bank_is_bf16)
    return grads_once<PT, bf16, false>(g, pp, static_cast<const bf16*>(bank), bank_y, idx_t, w_t, sc, grads, loss, st);
  return grads_once<PT, float, false>(g, pp, static_cast<const float*>(bank), bank_y, idx_t, w_t, sc, grads, loss, st);
}

// One of the seven products alone.  which: 0 conv1, 1 shortcut conv, 2 conv2
// (forward); 3 conv2's input gradient; 4 conv1's, 5 conv2's, 6 the shortcut's
// weight gradient.  W, X, DY in the compute dtype XT (W: the product's weight
// matrix; X: [batch, h, h, C] already gathered; DY: [R, c_out]); out f32.
template <typename XT, bool MMA>
int product_once(const Geom& g, int which, const XT* W, const XT* X, const XT* DY, float* out, char* scratch,
                 cudaStream_t st) {
  constexpr bool CD = sizeof(XT) == sizeof(bf16);
  const Scratch s = make_scratch(g, MMA);
  float* part = reinterpret_cast<float*>(scratch + s.part);
  const Gathers ga = make_gathers(g);
  const int R = g.rows, ci = g.c_in, co = g.c_out;
  const Gather& gw = which == 4 ? ga.in3 : (which == 5 ? ga.mid3 : ga.in1);
  int err, splits = 1;
  if (MMA && (err = configure_mma())) return err;
  if constexpr (MMA) {
    const bf16 *w = reinterpret_cast<const bf16*>(W), *x = reinterpret_cast<const bf16*>(X),
               *dy = reinterpret_cast<const bf16*>(DY);
    const WgradJob wj = wgrad_job(g, x, nullptr, dy, out, gw);
    switch (which) {
      case 0: err = launch_conv_mma<0, TagConv1Fwd>(g, ConvJob{x, nullptr, w, part, ga.in3, s.chunk1, splits = s.splits1}, nullptr, st); break;
      case 1: err = launch_conv_mma<0, TagConvScFwd>(g, ConvJob{x, nullptr, w, part, ga.in1, ci, 1}, nullptr, st); break;
      case 2: err = launch_conv_mma<0, TagConv2Fwd>(g, ConvJob{x, nullptr, w, part, ga.mid3, s.chunk2, splits = s.splits2}, nullptr, st); break;
      case 3: err = launch_conv_mma<1, TagConv2Dx>(g, ConvJob{dy, nullptr, w, part, ga.mid3t, s.chunk2, splits = s.splits2}, nullptr, st); break;
      case 4: return launch_wgrad_mma<TagConv1Dw>(g, &wj, 1, nullptr, st);
      case 5: return launch_wgrad_mma<TagConv2Dw>(g, &wj, 1, nullptr, st);
      default: return launch_wgrad_mma<TagConvScDw>(g, &wj, 1, nullptr, st);
    }
    if (err) return err;
  } else {
    const dim3 tiles(cdiv(co, TN), cdiv(R, TM));
    const dim3 tiles1(tiles.x, tiles.y, s.splits1), tiles2(tiles.x, tiles.y, s.splits2);
    const dim3 wgrid(cdiv(co, TN), cdiv(gw.ksize * gw.ksize * gw.C, TM));
    switch (which) {
      case 0: splits = s.splits1; launch(conv_gemm_kernel<XT, XT, CD, false>, tiles1, THREADS, 0, st, X, nullptr, W, part, ga.in3, co, ci * co, co, 1, s.chunk1); break;
      case 1: launch(conv_gemm_kernel<XT, XT, CD, false>, tiles, THREADS, 0, st, X, nullptr, W, part, ga.in1, co, 0, co, 1, ci); break;
      case 2: splits = s.splits2; launch(conv_gemm_kernel<XT, XT, CD, false>, tiles2, THREADS, 0, st, X, nullptr, W, part, ga.mid3, co, co * co, co, 1, s.chunk2); break;
      case 3: splits = s.splits2; launch(conv_gemm_kernel<XT, XT, CD, true>, tiles2, THREADS, 0, st, DY, nullptr, W, part, ga.mid3t, co, co * co, 1, co, s.chunk2); break;
      default: launch(conv_wgrad_kernel<XT, XT>, wgrid, THREADS, 0, st, X, nullptr, DY, out, gw, co); LAUNCH_CHECK(); return 0;
    }
    LAUNCH_CHECK();
  }
  const size_t n = static_cast<size_t>(R) * co;
  launch(sum_parts_kernel, static_cast<int>((n / 4 + THREADS - 1) / THREADS), THREADS, 0, st, part, splits, n, out);
  LAUNCH_CHECK();
  return 0;
}

}  // namespace

// Bytes of scratch a lane needs in the entry points below for this geometry
// and route (mma != 0: the tensor-core products, which a bf16 bank takes); 0
// if the kernels do not take the geometry.  The scan takes L times as much on
// the tensor-core route, the others once.
extern "C" size_t fused_inner_scan_scratch_bytes(int h_in, int c_in, int c_out, int stride, int batch, int mma) {
  Geom g;
  if (!make_geom(h_in, c_in, c_out, stride, batch, mma != 0, &g)) return 0;
  return make_scratch(g, mma != 0).total;
}

// Device kernels enqueued per inner step (the Adam kernel included).
extern "C" int fused_inner_scan_kernels_per_step(int bank_is_bf16) {
  return bank_is_bf16 ? KERNELS_PER_STEP_MMA : KERNELS_PER_STEP_FMA;
}

// The scan.  p [L, n_params] in the carry dtype, updated in place (PKEYS
// order: conv1 [9ci, co], bn1 scale, bias [co], conv2 [9co, co], bn2, conv_sc
// [ci, co], bn_sc); bank [L, span, h_in, h_in, c_in] bf16 or f32; bank_y [span]
// int32; idx [L, T, batch] int32; w [T, batch] f32; scratch of L (a bf16
// bank) or 1 (an f32 bank) times fused_inner_scan_scratch_bytes() bytes.  All
// on the device of `stream`.  L is at most 65535 over the conv products'
// slices a lane (about 7,000 lanes at the eval's geometry) for a bf16 bank.
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
// route 1 runs the FMA products whatever the bank's dtype (for checks).
extern "C" int fused_step_grads_bf16(const void* p, const void* bank, int bank_is_bf16, const int* bank_y,
                                     const int* idx_t, const float* w_t, void* scratch, float* grads, float* loss,
                                     int span, int h_in, int c_in, int c_out, int stride, int batch, int route,
                                     void* stream) {
  return grads_entry<bf16>(p, bank, bank_is_bf16, bank_y, idx_t, w_t, scratch, grads, loss, span, h_in, c_in, c_out,
                           stride, batch, route, stream);
}

extern "C" int fused_step_grads_f32(const void* p, const void* bank, int bank_is_bf16, const int* bank_y,
                                    const int* idx_t, const float* w_t, void* scratch, float* grads, float* loss,
                                    int span, int h_in, int c_in, int c_out, int stride, int batch, int route,
                                    void* stream) {
  return grads_entry<float>(p, bank, bank_is_bf16, bank_y, idx_t, w_t, scratch, grads, loss, span, h_in, c_in, c_out,
                            stride, batch, route, stream);
}

// One of the seven products by the route the scan takes for the dtype (or the
// FMA route with route = 1); see product_once for `which` and the operands.
extern "C" int fused_inner_scan_product(int which, const void* W, const void* X, const void* DY, float* out,
                                        void* scratch, int is_bf16, int route, int h_in, int c_in, int c_out,
                                        int stride, int batch, void* stream) {
  Geom g;
  const bool mma = is_bf16 && route == 0;
  if (which < 0 || which > 6 || route < 0 || route > 1 || !make_geom(h_in, c_in, c_out, stride, batch, mma, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  if (mma)
    return product_once<bf16, true>(g, which, static_cast<const bf16*>(W), static_cast<const bf16*>(X),
                                    static_cast<const bf16*>(DY), out, sc, st);
  if (is_bf16)
    return product_once<bf16, false>(g, which, static_cast<const bf16*>(W), static_cast<const bf16*>(X),
                                     static_cast<const bf16*>(DY), out, sc, st);
  return product_once<float, false>(g, which, static_cast<const float*>(W), static_cast<const float*>(X),
                                    static_cast<const float*>(DY), out, sc, st);
}
