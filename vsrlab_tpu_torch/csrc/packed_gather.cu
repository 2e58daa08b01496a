// Packed-row gather for Hopper (sm_90a).
//
// The sampler's "take" formulation packs each image into a table xf (N, R,
// Wrow) whose row (y, g) holds the 2 x 2gp x C window of image rows y, y+1 and
// x-groups g, g+1 (Wrow = 4*gp*C elements, R = (H-1)*(W/gp-1) rows). Every
// output pixel then needs ONE table row, named by idx (N, P); the bilinear
// fold of the gathered windows runs in torch.
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
//     what all three compute. (pallas_fused, the gather fused with the fold,
//     has its counterpart in bilinear_sample.cu, which reads the image itself.)
//
// What bounds it on an H100: it moves bytes and does no arithmetic, so HBM
// bounds it. Compulsory traffic at the alignment shape (180 images, 128x128,
// C=10, gp=2, bf16): the table (230 MB) and the indices in, 472 MB of rows
// out. The design is the simple one:
//   * one thread block per (image, run of output rows); a thread moves one
//     16-byte vector, neighbouring threads on neighbouring addresses, so
//     stores are fully coalesced and the loads of one table row are one or two
//     transactions;
//   * a block loads its own indices (the TPU kernels prefetch them to SMEM);
//   * nearby pixels name nearby table rows, so re-reads of a row hit L1/L2;
//   * 64-bit offsets throughout: at 256x256 the output alone has 9.4e8
//     elements.
//
// Interface: plain C, loaded with ctypes. The entry point takes contiguous
// operands, launches on the given device and stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success). An index
// outside [0, R) is clamped into it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int GATHER_ROWS = 64;  // output rows per block of the gather

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

const char* vsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
