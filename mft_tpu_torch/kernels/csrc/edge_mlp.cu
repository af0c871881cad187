// GNN edge kernel for Hopper (sm_90a):
//   out[b, i, j, c] = sum_f |x[b, i, f] - x[b, j, f]| * w[c, f] + bias[c]
//
// Replaces the TPU kernel mft_tpu/ops/pallas/edge_mlp.py:edge_abs_diff_matmul
// (Pallas body _fwd_kernel): the first 1x1 conv of the GNN's adjacency
// network, fused with the pairwise |x_i - x_j| edge construction, so the
// [B, N, N, F] edge tensor never exists in device memory.
//
// What bounds it: at the 5-shot eval shapes (B = 15 query graphs, N = 30
// nodes, F <= 229, C = 192) it does 2*B*N*N*F*C ~ 1.2 GFLOP against ~10 MB of
// output, so it is bound by f32 arithmetic (the f32 CUDA-core rate; the
// product is f32 to match the f32 reference), not by memory.
//
// Design (simple and right first): one block of 256 threads per
// (graph b, tile of 64 flattened (i, j) pair rows, tile of 64 channels).
// The block walks F in chunks of 16: it builds the 64 x 16 edge tile
// |x_i - x_j| from x (which stays in L1/L2: one graph is N*F*4 <= 120 KB)
// straight into shared memory, stages the matching 16 x 64 slice of w, and
// each thread accumulates a 4 x 4 register tile with f32 FMAs.  The edge
// values are recomputed per channel tile (C / 64 = 3 times) instead of being
// stored.  Rows and channels past the edge are masked.  Faster forms
// (tensor cores in TF32 or bf16, TMA staging) are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (mft_tpu_torch/kernels/build.py); bound with ctypes through the plain C
// entry point at the bottom, which launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;       // flattened (i, j) pair rows per block
constexpr int TC = 64;       // output channels per block
constexpr int KF = 16;       // features per shared-memory chunk
constexpr int THREADS = 256; // 16 x 16 threads, each a 4 x 4 output tile

__global__ void __launch_bounds__(THREADS)
edge_abs_diff_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ bias, float* __restrict__ out,
                            int N, int F, int C) {
  // +1 column of padding: the tile writes below walk kf fastest, which
  // would otherwise put a warp's stores on two shared-memory banks
  __shared__ float es[KF][TM + 1];
  __shared__ float ws[KF][TC + 1];

  const int b = blockIdx.z;
  const int r0 = blockIdx.x * TM;
  const int c0 = blockIdx.y * TC;
  const int nn = N * N;
  const float* xb = x + static_cast<size_t>(b) * N * F;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channel group: c = c0 + tx + 16 * q
  const int ty = tid / 16;  // row group:     r = r0 + ty + 16 * p

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int f0 = 0; f0 < F; f0 += KF) {
    // edge tile, kf fastest so neighbouring threads read neighbouring x
    for (int e = tid; e < TM * KF; e += THREADS) {
      const int m = e / KF, kf = e % KF;
      const int r = r0 + m, f = f0 + kf;
      float v = 0.f;
      if (r < nn && f < F) {
        const int i = r / N, j = r - i * N;
        v = fabsf(xb[i * F + f] - xb[j * F + f]);
      }
      es[kf][m] = v;
    }
    // weight tile from w [C, F] (torch layout), kf fastest: coalesced
    for (int e = tid; e < TC * KF; e += THREADS) {
      const int c = e / KF, kf = e % KF;
      const int cc = c0 + c, f = f0 + kf;
      ws[kf][c] = (cc < C && f < F) ? w[static_cast<size_t>(cc) * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kf = 0; kf < KF; ++kf) {
      float a[4], wv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = es[kf][ty + 16 * k];
        wv[k] = ws[kf][tx + 16 * k];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], wv[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = r0 + ty + 16 * p;
    if (r >= nn) continue;
    float* orow = out + (static_cast<size_t>(b) * nn + r) * C;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx + 16 * q;
      if (c < C) orow[c] = acc[p][q] + bias[c];
    }
  }
}

}  // namespace

// x [B, N, F], w [C, F], bias [C], out [B, N, N, C]; all f32, contiguous,
// on the device of `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int edge_abs_diff_matmul_f32(const float* x, const float* w, const float* bias, float* out,
                                        int B, int N, int F, int C, void* stream) {
  const dim3 grid((N * N + TM - 1) / TM, (C + TC - 1) / TC, B);
  edge_abs_diff_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, w, bias, out, N, F, C);
  return static_cast<int>(cudaGetLastError());
}
