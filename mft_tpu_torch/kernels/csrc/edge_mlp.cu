// GNN edge kernel for Hopper (sm_90a):
//   out[b, i, j, c] = sum_f |x[b, i, f] - x[b, j, f]| * w[c, f] + bias[c]
//
// Replaces the TPU kernel mft_tpu/ops/pallas/edge_mlp.py:edge_abs_diff_matmul
// (Pallas body _fwd_kernel): the first 1x1 conv of the GNN's adjacency
// network, fused with the pairwise |x_i - x_j| edge construction, so the
// [B, N, N, F] edge tensor never exists in device memory.  f32 in, f32 out.
//
// Arithmetic: the products run on the tensor cores in bf16 as a three-term
// split that keeps the f32 tolerance.  Each f32 operand v is cut into
// hi = bf16(v) and lo = bf16(v - hi) (round to nearest; hi + lo is v to
// 2^-16), and a product is hi*hi + hi*lo + lo*hi summed in one f32
// accumulator (the lo*lo term, 2^-16 of the product, is dropped).  Every
// bf16 x bf16 product is exact in f32.  At the main path's shapes this is
// within 5e-6 of the f32 product relative to the output's largest value;
// one bf16 product alone is 2e-3, one TF32 product 3e-4, both above the
// 1e-4 the f32 reference is held to.
//
// What bounds it: at the 5-shot eval shapes (B = 15 query graphs of N = 30
// nodes, C = 192, F = 133 / 181 / 229, three calls an episode) the f32
// output alone is 31.1 MB, 9.3 us at 3.35 TB/s, and the function's one
// product over F is 2.8 GFLOP, 2.85 us at the 989 TFLOP/s bf16 peak: the
// calls are bound by bytes, about 9.7 us for the three.  At N = 130 one call
// is bound by bytes too, 58 us.  This route's own work is more: its three
// bf16 products with F padded to 16 take 9.06 us for the three calls and
// 71 us at N = 130; the same product as f32 FMAs on the CUDA cores, 42 us.
//
// Design.  A block owns a tile of 128 flattened (b, i, j) rows (WGS = 2
// consumer warpgroups of 64 rows; rows run across graphs, a row past
// B * N * N is masked) and all C output channels, so the edge tile is built
// once: NT = ceil(C / 64) and one wgmma.mma_async m64n(64 NT)k16 per product
// (C = 192: m64n192k16, 96 f32 accumulators a thread).  The reduction runs in
// stages of 64 (one 128-byte swizzle row of bf16), double-buffered:
//  * A is computed, not copied: each warp builds |x_i - x_j| for its 16 rows
//    of the next stage from x (4-byte coalesced loads through L1; rows of
//    4 F bytes are not 16-byte aligned), splits it into hi / lo and stores
//    both swizzled, in four parts, one between the products of each k16 step
//    of the current stage (the tensor pipe accepts a warpgroup's wgmmas only
//    as fast as it runs them, so the build has to sit between them to overlap
//    them), the loads of a part in flight while the previous one is stored;
//  * W is split once per call by edge_split_w_kernel into bf16 hi / lo
//    [64 NT, Kpad] scratch (Kpad = F rounded up to 64, zeros in the padding,
//    rows 16-byte aligned), which the block streams in with 16-byte cp.async
//    into the same swizzle, a stage ahead; the main kernel is a programmatic
//    dependent launch and builds its first A stage before it waits for that
//    pass;
//  * fence.proxy.async before the tensor cores read what threads wrote;
//  * epilogue: bias added, the tile staged in shared memory (the stages are
//    free by then) and written in 16-byte stores along whole rows (the
//    tile's rows of out are contiguous), rows past the edge masked.
// One stage at C = 192 and 128 rows is A hi + lo 32 KB and B hi + lo 48 KB;
// two stages are 160 KB, one block an SM.  W is re-read from L2 by every
// block (147-197 KB a block at C = 192): the two warpgroups sharing each W
// stage halve that against 64-row tiles, which the H100 ran 20-32 % slower.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (mft_tpu_torch/kernels/build.py); bound with ctypes through the plain C
// entry point at the bottom, which launches both kernels on the caller's
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

using bf16 = __nv_bfloat16;

constexpr int KB = 64;                 // reduction elements per stage (128 bytes of bf16)
constexpr int WGS = 2;                 // consumer warpgroups a block, 64 rows each
constexpr int A_BYTES = 64 * KB * 2;   // one operand tile of 64 rows
constexpr int SPLIT_THREADS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// threads wrote through the generic proxy; wgmma reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void grid_dependency_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void launch_dependents() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

// Every operand tile in shared memory is an array of 128-byte rows (64 bf16
// of the reduction, K-major) in the 128-byte swizzle, its base a multiple of
// 1024: the 16-byte chunk c of row r lies at r*128 + ((c ^ (r & 7)) << 4).
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: sbo = bytes
// between groups of 8 rows (1024), lbo unused.
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// v0, v1 -> bf16 pairs hi = bf16(v), lo = bf16(v - hi), v0 in the low half
// (the lower address).  v - hi is exact in f32.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d[64 x 64 NT] += A[64 x 16] * B[16 x 64 NT], bf16 operands from shared
// memory (both K-major), f32 accumulators: thread t of the warpgroup holds,
// for j = 0 .. 8 NT - 1, rows 16*(t/32) + (t%32)/4 (d[4j], d[4j+1]) and that
// + 8 (d[4j+2], d[4j+3]) at columns 8j + 2*(t%4) and + 1.
template <int NT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32 * NT], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<1>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<2>(float (&d)[64], uint64_t da, uint64_t db) {
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
      "}, %64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<3>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95 "
      "}, %96, %97, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<4>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from touching the accumulators while the products are in flight
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// w [C, F] f32 -> hi, lo [rows_w, kpad] bf16 (rows_w = 64 NT), zeros past C and F.
// One thread a pair of neighbouring k.
__global__ void __launch_bounds__(SPLIT_THREADS)
edge_split_w_kernel(const float* __restrict__ w, bf16* __restrict__ whi, bf16* __restrict__ wlo, int C, int F,
                    int rows_w, int kpad) {
  launch_dependents();  // the main kernel may be placed now; it waits for this grid before reading W
  const int half = kpad / 2;
  const int q = blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (q >= rows_w * half) return;
  const int c = q / half, k = 2 * (q - c * half);
  float v0 = 0.f, v1 = 0.f;
  if (c < C) {
    const float* row = w + static_cast<size_t>(c) * F;
    if (k < F) v0 = row[k];
    if (k + 1 < F) v1 = row[k + 1];
  }
  uint32_t hi, lo;
  split2(v0, v1, hi, lo);
  *reinterpret_cast<uint32_t*>(whi + static_cast<size_t>(c) * kpad + k) = hi;
  *reinterpret_cast<uint32_t*>(wlo + static_cast<size_t>(c) * kpad + k) = lo;
}

template <int NT>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * WGS * A_BYTES + 2 * 64 * NT * KB * 2;  // A hi, lo of each warpgroup; B hi, lo
}
template <int NT>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * stage_bytes<NT>() + 1024;  // two stages, and room to align the base to 1024
}

// Grid: ceil(rows / (64 WGS)); 128 WGS threads.  x [*, F] f32 (node rows),
// whi / wlo [64 NT, kpad] bf16 from edge_split_w_kernel, out [rows, C] f32.
template <int NT>
__global__ void __launch_bounds__(128 * WGS, 1)
edge_abs_diff_matmul_kernel(const float* __restrict__ x, const bf16* __restrict__ whi, const bf16* __restrict__ wlo,
                            const float* __restrict__ bias, float* __restrict__ out, int rows, int N, int F, int C,
                            int kpad) {
  constexpr int TM = 64 * WGS, STAGE = stage_bytes<NT>(), B_BYTES = 64 * NT * KB * 2;
  constexpr int LDO = 64 * NT + 8;  // floats a row of the staged output tile; the pad spreads rows over the banks
  static_assert(TM * LDO * 4 <= 2 * STAGE, "the output tile fits the two stages");
  extern __shared__ unsigned char smem_raw[];
  __shared__ int node_off[2][TM];  // x offsets of node i and node j of each row; -1 past the edge
  __shared__ float s_bias[64 * NT];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const gsmem = smem_raw + (smem - smem_u32(smem_raw));  // the same bytes, generic address
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = blockIdx.x * TM, nn = N * N;

  for (int m = tid; m < TM; m += 128 * WGS) {
    const int r = r0 + m;
    int oi = -1, oj = -1;
    if (r < rows) {
      const int b = r / nn, rem = r - b * nn, i = rem / N, j = rem - i * N;
      oi = (b * N + i) * F;
      oj = (b * N + j) * F;
    }
    node_off[0][m] = oi;
    node_off[1][m] = oj;
  }
  for (int c = tid; c < 64 * NT; c += 128 * WGS) s_bias[c] = c < C ? bias[c] : 0.f;
  __syncthreads();

  // The A tile of stage kb is built in four parts a warp: part p is rows
  // warp * 16 + 4 p + q (q < 4) of this warpgroup's 64, lane holding the
  // reduction elements f, f + 1 (one 4-byte word of each 128-byte row).
  // load_part fetches x_i and x_j into registers, store_part writes
  // |x_i - x_j| split into hi and lo, so that the loads of one part are in
  // flight while the previous part is stored and the wgmmas issue.
  using Part = float[4][4];
  auto load_part = [&](int kb, int p, Part& v) {
    const int f = kb * KB + 2 * lane;
    const bool ok0 = f < F, ok1 = f + 1 < F;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = wg * 64 + warp * 16 + 4 * p + q;
      const int oi = node_off[0][m], oj = node_off[1][m];
      const bool ok = oi >= 0;
      v[q][0] = ok && ok0 ? __ldg(x + oi + f) : 0.f;
      v[q][1] = ok && ok0 ? __ldg(x + oj + f) : 0.f;
      v[q][2] = ok && ok1 ? __ldg(x + oi + f + 1) : 0.f;
      v[q][3] = ok && ok1 ? __ldg(x + oj + f + 1) : 0.f;
    }
  };
  auto store_part = [&](int p, const Part& v, unsigned char* base) {
    unsigned char* a_hi = base + wg * A_BYTES;
    unsigned char* a_lo = a_hi + WGS * A_BYTES;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = warp * 16 + 4 * p + q;
      uint32_t hi, lo;
      split2(fabsf(v[q][0] - v[q][1]), fabsf(v[q][2] - v[q][3]), hi, lo);
      const uint32_t off = swz(m, lane / 4) + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(a_hi + off) = hi;
      *reinterpret_cast<uint32_t*>(a_lo + off) = lo;
    }
  };
  // W's hi and lo rows of stage kb, 16 bytes a copy
  auto load_b = [&](int kb, uint32_t base) {
    const uint32_t b_hi = base + 2 * WGS * A_BYTES, b_lo = b_hi + B_BYTES;
#pragma unroll 4
    for (int q = tid; q < 64 * NT * 8; q += 128 * WGS) {
      const int r = q / 8, ch = q % 8;
      const size_t g = static_cast<size_t>(r) * kpad + kb * KB + 8 * ch;
      cp_async16(b_hi + swz(r, ch), whi + g);
      cp_async16(b_lo + swz(r, ch), wlo + g);
    }
    cp_async_commit();
  };

  float acc[32 * NT];
#pragma unroll
  for (int i = 0; i < 32 * NT; ++i) acc[i] = 0.f;

  const int nk = kpad / KB;
  {
    Part v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) load_part(0, p, v[p]);
#pragma unroll
    for (int p = 0; p < 4; ++p) store_part(p, v[p], gsmem);
  }
  grid_dependency_wait();  // the split pass has completed and its writes are visible
  load_b(0, smem);
  cp_async_wait0();
  fence_proxy_async();
  __syncthreads();
  for (int kb = 0; kb < nk; ++kb) {
    const bool more = kb + 1 < nk;
    const int cur = (kb & 1) * STAGE, nxt = ((kb + 1) & 1) * STAGE;
    const uint32_t a_hi = smem + cur + wg * A_BYTES, a_lo = a_hi + WGS * A_BYTES;
    const uint32_t b_hi = smem + cur + 2 * WGS * A_BYTES, b_lo = b_hi + B_BYTES;
    // the other stage's readers (the products of stage kb - 1) have completed
    Part v[2];
    if (more) {
      load_b(kb + 1, smem + nxt);
      load_part(kb + 1, 0, v[0]);
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint64_t ah = mma_desc(a_hi + 32 * kk), al = mma_desc(a_lo + 32 * kk);
      const uint64_t bh = mma_desc(b_hi + 32 * kk), bl = mma_desc(b_lo + 32 * kk);
      wgmma_bf16<NT>(acc, ah, bh);
      wgmma_bf16<NT>(acc, ah, bl);
      wgmma_bf16<NT>(acc, al, bh);
      if (more) {  // the next stage's edge tile, a part while each k16 step's products run
        if (kk + 1 < KB / 16) load_part(kb + 1, kk + 1, v[(kk + 1) & 1]);
        store_part(kk, v[kk & 1], gsmem + nxt);
      }
    }
    wgmma_commit();
    if (more) {
      cp_async_wait0();
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();
  }

  // the tile, bias added, through shared memory (the stages are free now) so
  // that it leaves in 16-byte stores along whole rows; [r0, r0 + valid) of
  // out is contiguous
  float* tile = reinterpret_cast<float*>(gsmem);
  const int lrow = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < 8 * NT; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const float b0 = s_bias[c], b1 = s_bias[c + 1];
    *reinterpret_cast<float2*>(tile + lrow * LDO + c) = make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<float2*>(tile + (lrow + 8) * LDO + c) = make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  __syncthreads();
  const int valid = min(TM, rows - r0);
  float* o = out + static_cast<size_t>(r0) * C;
  if ((C & 3) == 0) {  // 16-byte aligned rows
    const int c4 = C / 4;
    for (int q = tid; q < valid * c4; q += 128 * WGS) {
      const int r = q / c4, c = 4 * (q - r * c4);
      *reinterpret_cast<float4*>(o + static_cast<size_t>(r) * C + c) = *reinterpret_cast<const float4*>(tile + r * LDO + c);
    }
  } else {
    for (int q = tid; q < valid * C; q += 128 * WGS) {
      const int r = q / C;
      o[static_cast<size_t>(r) * C + (q - r * C)] = tile[r * LDO + q - r * C];
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int NT>
int launch_main(const float* x, const bf16* whi, const bf16* wlo, const float* bias, float* out, int rows, int N,
                int F, int C, int kpad, cudaStream_t st) {
  auto kernel = edge_abs_diff_matmul_kernel<NT>;
  // the shared-memory limit is a setting of the current device: raised once on each card, under a lock (the
  // eval's mesh runs on several cards); a failure is not kept, the next call retries
  static std::mutex mu;
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= MAX_DEVICES) e = cudaErrorInvalidDevice;
  if (e != cudaSuccess) return static_cast<int>(e);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<NT>());
      if (e != cudaSuccess) return static_cast<int>(e);
      ready[dev] = true;
    }
  }
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + 64 * WGS - 1) / (64 * WGS));
  cfg.blockDim = dim3(128 * WGS);
  cfg.dynamicSmemBytes = smem_bytes<NT>();
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, x, whi, wlo, bias, out, rows, N, F, C, kpad);
  return static_cast<int>(cudaGetLastError());
}

// W's split scratch: hi rows, then lo rows, each [64 NT, kpad]
struct SplitLayout {
  int nt, rows_w, kpad;
  explicit SplitLayout(int F, int C) : nt((C + 63) / 64), rows_w(64 * nt), kpad((F + KB - 1) / KB * KB) {}
  size_t elems() const { return 2 * static_cast<size_t>(rows_w) * kpad; }
};

}  // namespace

// bf16 elements of the scratch edge_abs_diff_matmul_f32 needs for W's split
// at these F and C: 2 * 64 * ceil(C / 64) * (F rounded up to 64).
extern "C" size_t edge_abs_diff_matmul_scratch_elems(int F, int C) { return SplitLayout(F, C).elems(); }

// x [B, N, F], w [C, F], bias [C], out [B, N, N, C]: f32, contiguous, on the
// device of `stream`.  wsplit: bf16 scratch of
// edge_abs_diff_matmul_scratch_elems(F, C) elements, 16-byte aligned.
// 1 <= C <= 256.  Launches the W split pass and the main kernel; returns
// cudaGetLastError() after them.
extern "C" int edge_abs_diff_matmul_f32(const float* x, const float* w, const float* bias, float* out, void* wsplit,
                                        int B, int N, int F, int C, void* stream) {
  const SplitLayout L(F, C);
  if (C < 1 || L.nt > 4 || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* whi = static_cast<bf16*>(wsplit);
  bf16* wlo = whi + static_cast<size_t>(L.rows_w) * L.kpad;
  const int pairs = L.rows_w * L.kpad / 2;
  edge_split_w_kernel<<<(pairs + SPLIT_THREADS - 1) / SPLIT_THREADS, SPLIT_THREADS, 0, st>>>(w, whi, wlo, C, F,
                                                                                              L.rows_w, L.kpad);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = B * N * N;
  switch (L.nt) {
    case 1: return launch_main<1>(x, whi, wlo, bias, out, rows, N, F, C, L.kpad, st);
    case 2: return launch_main<2>(x, whi, wlo, bias, out, rows, N, F, C, L.kpad, st);
    case 3: return launch_main<3>(x, whi, wlo, bias, out, rows, N, F, C, L.kpad, st);
    default: return launch_main<4>(x, whi, wlo, bias, out, rows, N, F, C, L.kpad, st);
  }
}
