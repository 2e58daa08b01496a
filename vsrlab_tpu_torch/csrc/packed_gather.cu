// Packed-row gather and fused packed bilinear sampler for Hopper (sm_90a).
//
// The bilinear sampler of the deformable alignment packs each image into a
// table xf (N, R, Wrow) whose row (y, g) holds the 2 x 2gp x C window of
// image rows y, y+1 and x-groups g, g+1 (Wrow = 4*gp*C elements, R =
// (H-1)*(W/gp-1) rows). Every output pixel then needs ONE table row, named by
// idx (N, P), and picks its four corners from it.
//
// Replaces the Pallas TPU kernels of scripts/bench_pallas_deform_gather.py:
//   * pallas_loop  (_loop_kernel, lines 137-168): per-row copies,
//   * pallas_blk   (_blk_kernel, lines 177-228): 8-row block loads and a
//     one-hot sublane select,
//   * pallas_take  (_take_kernel, lines 129-134, 237-259): one vectorised take
//                                      -> packed_row_gather_kernel below.
//     The three compute one function, out[i, p, :] = xf[i, idx[i, p], :], and
//     differ only in how they get round Mosaic's limits on dynamic row
//     addresses. A CUDA thread block addresses any row, so one kernel computes
//     what all three compute.
//   * pallas_fused (_fused_kernel, lines 262-306): the gather times the
//     bilinear one-hot weights, folded over the 2 x 2gp window slots
//                                      -> packed_bilinear_kernel below.
//     It follows the shipped function (vsrlab_tpu/ops/warp.py:157-175): the
//     window is upcast to fp32, weighted and folded in fp32 and rounded once,
//     where the probe rounds the lane product to bf16 before the fold because
//     its output block is bf16.
//
// What bounds them on an H100: both move bytes and do next to no arithmetic
// (the fused kernel does 8 FLOP for each 2-byte output element), far below the
// ridge, so HBM bounds them. Compulsory traffic at the alignment shape (180
// images, 128x128, C=10, gp=2, bf16): the gather reads the table (230 MB) and
// the indices and writes 472 MB of rows; the fused kernel reads the table and
// seven 4-byte fields for each pixel and writes 59 MB, so fusing the fold
// removes the 472 MB round trip. The design is the simple one:
//   * one thread block per (image, run of output rows); a thread moves one
//     16-byte vector (gather) or one output element (fused), neighbouring
//     threads on neighbouring addresses, so stores are fully coalesced and the
//     loads of one table row are one or two transactions;
//   * a block loads its own indices (the TPU kernels prefetch them to SMEM);
//   * nearby pixels name nearby table rows, so re-reads of a row hit L1/L2;
//   * 64-bit offsets throughout: at 256x256 the gather's output alone has
//     9.4e8 elements.
// Not yet done (later work): staging a tile's table rows in shared memory,
// sampling straight from NHWC without the packed table.
//
// Interface: plain C, loaded with ctypes. Every entry point takes contiguous
// operands, launches on the given device and stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success). An index
// outside [0, R) is clamped into it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;
constexpr int GATHER_ROWS = 64;  // output rows per block of the gather
constexpr int FUSED_PIX = 128;   // output pixels per block of the fused sampler

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// out[i, p, :] = xf[i, idx[i, p], :], rows of `vpr` units of type V.
// Block b serves image b / bpi and rows [(b % bpi) * GATHER_ROWS, ...).
template <typename V>
__global__ void __launch_bounds__(NTHREADS)
packed_row_gather_kernel(const V* __restrict__ xf, const int* __restrict__ idx,
                         V* __restrict__ out, int R, int P, int vpr, int bpi) {
  const int i = blockIdx.x / bpi;
  const int p0 = (blockIdx.x - i * bpi) * GATHER_ROWS;
  const int rows = min(GATHER_ROWS, P - p0);
  const int* idx_i = idx + static_cast<int64_t>(i) * P + p0;
  const V* src = xf + static_cast<int64_t>(i) * R * vpr;
  V* dst = out + (static_cast<int64_t>(i) * P + p0) * vpr;
  for (int e = threadIdx.x; e < rows * vpr; e += NTHREADS) {
    const int r = e / vpr;
    const int v = e - r * vpr;
    const int j = min(max(idx_i[r], 0), R - 1);
    dst[e] = src[static_cast<int64_t>(j) * vpr + v];
  }
}

// out[i, p, ch] = sum over the window slots (ys, k) in
// {py0, py0+1} x {rx0, rx0+1}, kept to [0, 2) x [0, 2gp), of
// wy * wx * xf[i, idx[i, p], (ys * 2gp + k) * C + ch], in fp32, rounded once.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
packed_bilinear_kernel(const T* __restrict__ xf, const int* __restrict__ idx,
                       const int* __restrict__ rx0, const int* __restrict__ py0,
                       const float* __restrict__ wx0, const float* __restrict__ wx1,
                       const float* __restrict__ wy0, const float* __restrict__ wy1,
                       T* __restrict__ out, int R, int P, int gp, int c, int bpi) {
  const int i = blockIdx.x / bpi;
  const int p0 = (blockIdx.x - i * bpi) * FUSED_PIX;
  const int pix = min(FUSED_PIX, P - p0);
  const int two_gp = 2 * gp;
  const int64_t m0 = static_cast<int64_t>(i) * P + p0;
  const T* table = xf + static_cast<int64_t>(i) * R * (2 * two_gp * c);
  for (int e = threadIdx.x; e < pix * c; e += NTHREADS) {
    const int pl = e / c;
    const int ch = e - pl * c;
    const int64_t m = m0 + pl;
    const int j = min(max(idx[m], 0), R - 1);
    const T* row = table + static_cast<int64_t>(j) * (2 * two_gp * c);
    const int kx = rx0[m], ky = py0[m];
    const float ax[2] = {wx0[m], wx1[m]};
    const float ay[2] = {wy0[m], wy1[m]};
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int ys = ky + dy;
      if (ys < 0 || ys > 1) continue;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int k = kx + dx;
        if (k < 0 || k >= two_gp) continue;
        acc += (ay[dy] * ax[dx]) * to_float(row[(ys * two_gp + k) * c + ch]);
      }
    }
    out[m0 * c + e] = from_float<T>(acc);
  }
}

// Blocks for N images of P rows, `per` rows a block; 0 if the grid would not fit.
int64_t grid_blocks(int N, int P, int per, int* bpi) {
  *bpi = (P + per - 1) / per;
  const int64_t blocks = static_cast<int64_t>(N) * *bpi;
  return blocks <= 2147483647LL ? blocks : 0;
}

template <typename V>
int launch_gather(const void* xf, const void* idx, void* out, int N, int R, int P, int vpr,
                  cudaStream_t stream) {
  int bpi;
  const int64_t blocks = grid_blocks(N, P, GATHER_ROWS, &bpi);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  packed_row_gather_kernel<V><<<static_cast<unsigned>(blocks), NTHREADS, 0, stream>>>(
      static_cast<const V*>(xf), static_cast<const int*>(idx), static_cast<V*>(out), R, P, vpr,
      bpi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bilinear(const void* xf, const void* idx, const void* rx0, const void* py0,
                    const void* wx0, const void* wx1, const void* wy0, const void* wy1,
                    void* out, int N, int R, int P, int gp, int c, int device, void* stream) {
  if (N <= 0 || R <= 0 || P <= 0 || gp <= 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int bpi;
  const int64_t blocks = grid_blocks(N, P, FUSED_PIX, &bpi);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  packed_bilinear_kernel<T>
      <<<static_cast<unsigned>(blocks), NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xf), static_cast<const int*>(idx),
          static_cast<const int*>(rx0), static_cast<const int*>(py0),
          static_cast<const float*>(wx0), static_cast<const float*>(wx1),
          static_cast<const float*>(wy0), static_cast<const float*>(wy1),
          static_cast<T*>(out), R, P, gp, c, bpi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xf (N, R, row_elems), idx (N, P) int32 -> out (N, P, row_elems); elements of
// `itemsize` bytes (2 or 4). Rows move as 16-byte vectors when their size and
// the three base addresses allow it, else element by element.
int vsr_packed_row_gather(const void* xf, const void* idx, void* out, int N, int R, int P,
                          int row_elems, int itemsize, int device, void* stream) {
  if (N <= 0 || R <= 0 || P <= 0 || row_elems <= 0 || (itemsize != 2 && itemsize != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row_bytes = static_cast<int64_t>(row_elems) * itemsize;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(xf) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (row_bytes % 16 == 0 && aligned)
    return launch_gather<uint4>(xf, idx, out, N, R, P, static_cast<int>(row_bytes / 16), s);
  if (itemsize == 4) return launch_gather<uint32_t>(xf, idx, out, N, R, P, row_elems, s);
  return launch_gather<uint16_t>(xf, idx, out, N, R, P, row_elems, s);
}

// xf (N, R, 4*gp*c), idx/rx0/py0 (N, P) int32, wx0/wx1/wy0/wy1 (N, P) fp32
// -> out (N, P, c) in xf's type.
int vsr_packed_bilinear_bf16(const void* xf, const void* idx, const void* rx0, const void* py0,
                             const void* wx0, const void* wx1, const void* wy0,
                             const void* wy1, void* out, int N, int R, int P, int gp, int c,
                             int device, void* stream) {
  return launch_bilinear<bf16>(xf, idx, rx0, py0, wx0, wx1, wy0, wy1, out, N, R, P, gp, c,
                               device, stream);
}

int vsr_packed_bilinear_fp32(const void* xf, const void* idx, const void* rx0, const void* py0,
                             const void* wx0, const void* wx1, const void* wy0,
                             const void* wy1, void* out, int N, int R, int P, int gp, int c,
                             int device, void* stream) {
  return launch_bilinear<float>(xf, idx, rx0, py0, wx0, wx1, wy0, wy1, out, N, R, P, gp, c,
                                device, stream);
}

const char* vsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
