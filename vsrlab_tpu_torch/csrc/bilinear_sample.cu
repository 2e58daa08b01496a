// Bilinear sampling of channels-last images at fp32 pixel coordinates, for
// Hopper (sm_90a):
//
//     out[i, p, :] = sum over the corners (y0,x0), (y0,x1), (y1,x0), (y1,x1)
//                    of (wy * wx) * x[i, y, x, :]
//
// with x0 = floor(ix[i, p]), wx1 = ix - x0, wx0 = 1 - wx1 and the same for y,
// summed in fp32 in that order (each term rounded, then added: no fused
// multiply-add) and rounded to x's type once.
//
// Replaces the Pallas TPU kernel pallas_fused of
// scripts/bench_pallas_deform_gather.py (_fused_kernel and pallas_fused, lines
// 262-306), and computes the function the JAX package ships around it
// (vsrlab_tpu/ops/warp.py:102-175, _bilinear_packed). The TPU kernel reads a
// packed table whose row holds one 2 x 2gp x C interpolation window, because
// Mosaic cannot address one arbitrary image row per pixel cheaply; it is given
// the window's row, the corners' slots and the per-axis weights as seven
// per-pixel fields. A Hopper thread addresses any byte, so this kernel reads
// the image itself and computes the fields in registers: no table, no fields.
//
// Zeros mode (`zeros`): each per-axis weight is zeroed where its corner lies
// outside the image (warp.py:108-113), and a corner outside the image is never
// read. Otherwise (the caller has clamped the coordinates into the image for
// border or reflection padding) no weight is masked and a corner's index is
// clamped into the image; with such coordinates the only clamped corner is
// x0 + 1 = W (or y0 + 1 = H) at weight 0. The float clamp bounds every int
// cast, so +-inf, NaN and 1e30 coordinates read nothing out of range; in zeros
// mode they give 0.
//
// What bounds it on an H100: bytes. A launch reads x once, 8 bytes of
// coordinates a pixel and writes the output once, and does about 8 FLOP an
// output element: far below the ridge. At the alignment shape (180 images of
// 256x256x10, bf16) that is 236 + 94 + 236 MB, 0.169 ms at 3.35 TB/s. The
// corners of nearby samples are nearby, so each image byte is asked for about
// four times; those re-reads must come from L1, and the loads that carry them
// must be few, since each load instruction of a warp costs the L1 one cycle
// for every 128-byte line its threads touch. The design:
//   * one thread an output pixel, all C channels in registers (the fast
//     path, instantiated for the channel counts a deformable group has here:
//     4, 8 and 10; any other C takes a generic loop over channels);
//   * the two horizontally adjacent corners of a row are 2*C*itemsize
//     contiguous bytes (40 at C = 10, bf16); they are read as the aligned
//     16-byte words that cover them (three or four) and the two pixels are
//     picked out in registers, never as 2-byte loads per channel;
//   * a CTA samples a 16 x 32 tile of the sample grid, two pixels a thread, so
//     that its corners fall in a box little larger than the tile, which stays
//     in L1 while the CTA reads it (a CTA on one run of 256 output pixels,
//     a row at 256x256, finds its corners spread over some twenty image rows
//     and reads most of them from L2; 8 x 32 and 32 x 32 tiles were slower
//     than 16 x 32 on this card);
//   * a warp's 32 pixels read their coordinates coalesced and store their
//     32*C*itemsize contiguous output bytes through shared memory as 16-byte
//     words;
//   * 64-bit offsets for every address: at 256x256 the 180 images hold 1.2e8
//     elements.
// A variant that first copied each tile's corner box into shared memory (one
// bulk copy by the TMA unit a box row, completing on an mbarrier) and read the
// corners from there was slower at every VRT shape, with every box fitting
// 48 KB: the reads from shared memory cost the same load pipe as L1 hits do,
// and the copy comes on top. Measured (NVIDIA H100 80GB HBM3, 700.00 W,
// device time by CUDA-graph replay, bf16, 180 images of 10 channels,
// coordinates the pixel grid plus an N(0, 3) residue; PERF.md has the rest):
// 0.0070 / 0.0216 / 0.0827 / 0.3022 ms at 32^2 / 64^2 / 128^2 / 256^2, 38 /
// 49 / 51 / 56 % of the bound (staged: 0.0078 / 0.0248 / 0.0888 / 0.3451).
//
// Interface: plain C, loaded with ctypes. Every entry point takes contiguous
// operands, launches on the given device and stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;
constexpr int WARPS = NTHREADS / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc + w * v with the product rounded before the sum, never one fused
// multiply-add: the plain version's arithmetic (a product, then a sum), so
// that the kernel's result is the plain version's bit for bit in fp32. A
// recurrence over sampled values (RAFT's 12 lookups a forward) then follows
// the same path with either sampler.
__device__ __forceinline__ float add_term(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

// One axis of a sample: the corners' weights, whether each is read, and
// their indices clamped into [0, size).
struct Axis {
  float w0, w1;
  bool v0, v1;
  int a, b;
};

__device__ __forceinline__ Axis axis(float c, int size, bool zeros) {
  const float f = floorf(c);
  const float last = static_cast<float>(size - 1);
  Axis r;
  r.w1 = c - f;
  r.w0 = 1.0f - r.w1;
  if (zeros) {
    r.v0 = f >= 0.0f && f <= last;
    r.v1 = f + 1.0f >= 0.0f && f + 1.0f <= last;
    if (!r.v0) r.w0 = 0.0f;
    if (!r.v1) r.w1 = 0.0f;
  } else {
    r.v0 = r.v1 = true;
  }
  // fmaxf(NaN, 0) is 0: the clamp bounds the cast for every input
  r.a = static_cast<int>(fminf(fmaxf(f, 0.0f), last));
  r.b = static_cast<int>(fminf(fmaxf(f + 1.0f, 0.0f), last));
  return r;
}

// One aligned 16-byte word of the image tensor (`nwords` 32-bit words) through
// the read-only path; a last one that runs past the tensor is read word by word.
__device__ __forceinline__ uint4 load_chunk(const uint4* xq, int64_t q, int64_t nwords) {
  if (4 * q + 4 <= nwords) return __ldg(xq + q);
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xq) + 4 * q;
  const int64_t left = nwords - 4 * q;
  uint4 v = make_uint4(__ldg(xw), 0, 0, 0);
  if (left > 1) v.y = __ldg(xw + 1);
  if (left > 2) v.z = __ldg(xw + 2);
  return v;
}

// The 2*WP words at word offset `wo` of the image tensor, read as the fewest
// aligned 16-byte words that cover them (NQ at most, `need` for this offset)
// and picked out of those in registers.
template <int WP>
__device__ __forceinline__ void load_span(const uint4* xq, int64_t wo, int64_t nwords,
                                          uint32_t (&span)[2 * WP]) {
  constexpr int NQ = (2 * WP + 6) / 4;
  const int s = static_cast<int>(wo & 3), need = (s + 2 * WP + 3) >> 2;
  uint32_t w[4 * NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const uint4 v = i < need ? load_chunk(xq, (wo >> 2) + i, nwords) : make_uint4(0, 0, 0, 0);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < 2 * WP; ++k)
    span[k] = s == 0 ? w[k] : s == 1 ? w[k + 1] : s == 2 ? w[k + 2] : w[k + 3];
}

template <typename T, int C>
__device__ __forceinline__ void unpack(const uint32_t* w, float (&f)[C]) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int c = 0; c < C / 2; ++c) {
      f[2 * c] = __uint_as_float(w[c] << 16);
      f[2 * c + 1] = __uint_as_float(w[c] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) f[c] = __uint_as_float(w[c]);
  }
}

template <typename T, int C>
__device__ __forceinline__ void pack(const float (&acc)[C], uint32_t* w) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int c = 0; c < C / 2; ++c)
      w[c] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * c]))) |
             (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * c + 1])))
              << 16);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) w[c] = __float_as_uint(acc[c]);
  }
}

// One row of a sample: the pair of pixels (sx, sx + 1) in `span`, their x
// corners weighted wy * wx, added to acc in the order x0, x1.
template <typename T, int C, int WP>
__device__ __forceinline__ void fold_row(const uint32_t (&span)[2 * WP], float wy, const Axis& ax,
                                         int sx, float (&acc)[C]) {
  float p0[C], p1[C];
  unpack<T, C>(span, p0);
  unpack<T, C>(span + WP, p1);
  const int slot[2] = {ax.a - sx, ax.b - sx};
  const float wx[2] = {ax.w0, ax.w1};
  const bool vx[2] = {ax.v0, ax.v1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!vx[k]) continue;
    const float wgt = wy * wx[k];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = add_term(acc[c], wgt, slot[k] ? p1[c] : p0[c]);
  }
}

// The warp's pixels first .. end - 1 (32 at most) leave from `ow` (WP words
// each) as one contiguous run, in 16-byte words where the run is whole and
// aligned.
template <int WP>
__device__ __forceinline__ void store_warp(const uint32_t* ow, uint32_t* out, int64_t first,
                                           int64_t end, int lane) {
  if (first >= end) return;
  const int npix = static_cast<int>(min(static_cast<int64_t>(32), end - first));
  uint32_t* dst = out + first * WP;
  if (npix == 32 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = lane; i < 8 * WP; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(ow)[i];
  } else {
    for (int i = lane; i < npix * WP; i += 32) dst[i] = ow[i];
  }
}

// ---- the fast path ---------------------------------------------------------
//
// C channels (4, 8 or 10), whole 32-bit words a pixel (WP of them), x
// 16-byte aligned, W >= 2. The output pixels are viewed as rows of L: the
// image's width when P is a whole number of image rows of at least TILE_W
// pixels (a sample grid of the image's own shape, as the alignment and
// flow_warp give), else TILE_W. CTA b owns a TILE_H x TILE_W tile of that view
// in image b / tiles_img; its thread t samples the pixels of tile row
// t / 32 + WARPS * j, column t % 32, so that a warp's 32 pixels are one run
// of the output. The tile's corners lie in a box a few pixels larger than the
// tile, which its 256 threads read from L1 again and again; only the order in
// which pixels are visited depends on the view, any P is sampled right.
constexpr int TILE_H = 16, TILE_W = 32;
constexpr int PPT = TILE_H * TILE_W / NTHREADS;  // pixels a thread

template <typename T, int C>
__global__ void __launch_bounds__(NTHREADS)
    bilinear_sample_kernel(const T* __restrict__ x, const float* __restrict__ ix,
                           const float* __restrict__ iy, T* __restrict__ out, int H, int W,
                           int P, int L, int tiles_x, int tiles_img, bool zeros) {
  constexpr int WP = C * static_cast<int>(sizeof(T)) / 4;
  __shared__ __align__(16) uint32_t ostage[NTHREADS * WP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.x / tiles_img;
  const int tile = blockIdx.x - img * tiles_img;
  const int vr0 = (tile / tiles_x) * TILE_H, vc = (tile % tiles_x) * TILE_W + lane;
  const int64_t img_pix = static_cast<int64_t>(img) * H * W;
  const int64_t nwords = static_cast<int64_t>(gridDim.x / tiles_img) * H * W * WP;
  const uint4* xq = reinterpret_cast<const uint4*>(x);

  float cx[PPT], cy[PPT];
  bool active[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int64_t p = static_cast<int64_t>(vr0 + warp + WARPS * j) * L + vc;
    active[j] = vc < L && p < P;
    const int64_t m = static_cast<int64_t>(img) * P + p;
    cx[j] = active[j] ? __ldg(ix + m) : 0.0f;
    cy[j] = active[j] ? __ldg(iy + m) : 0.0f;
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    uint32_t* ow = ostage + warp * 32 * WP;
    if (active[j]) {
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0f;
      const Axis ax = axis(cx[j], W, zeros), ay = axis(cy[j], H, zeros);
      const int sx = min(ax.a, W - 2);  // the pair (sx, sx + 1) holds both x corners
      const int ys[2] = {ay.a, ay.b};
      const float wy[2] = {ay.w0, ay.w1};
      const bool vy[2] = {ay.v0, ay.v1};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!vy[r]) continue;
        uint32_t span[2 * WP];
        load_span<WP>(xq, (img_pix + static_cast<int64_t>(ys[r]) * W + sx) * WP, nwords, span);
        fold_row<T, C, WP>(span, wy[r], ax, sx, acc);
      }
      pack<T, C>(acc, ow + lane * WP);
    }
    __syncwarp();
    const int64_t first = static_cast<int64_t>(vr0 + warp + WARPS * j) * L + vc - lane;
    const int64_t end = min(first + min(32, L - (vc - lane)), static_cast<int64_t>(P));
    store_warp<WP>(ow, reinterpret_cast<uint32_t*>(out), static_cast<int64_t>(img) * P + first,
                   static_cast<int64_t>(img) * P + end, lane);
    __syncwarp();
  }
}

// The generic path: any C, any alignment, any W. One thread a sample, one
// channel at a time, element loads through the read-only path. The threads
// run over the N*P samples as one sequence, so that a launch of many images
// of few samples each (RAFT's lookups: 49 an image) fills its CTAs.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    bilinear_sample_generic_kernel(const T* __restrict__ x, const float* __restrict__ ix,
                                   const float* __restrict__ iy, T* __restrict__ out, int H,
                                   int W, int C, int P, int64_t total, bool zeros) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * NTHREADS + threadIdx.x;
  if (m >= total) return;
  const int64_t img = m / P;
  const Axis ax = axis(__ldg(ix + m), W, zeros), ay = axis(__ldg(iy + m), H, zeros);
  const float wx[2] = {ax.w0, ax.w1}, wy[2] = {ay.w0, ay.w1};
  const bool vx[2] = {ax.v0, ax.v1}, vy[2] = {ay.v0, ay.v1};
  const int xs[2] = {ax.a, ax.b}, ys[2] = {ay.a, ay.b};
  const int64_t img_pix = static_cast<int64_t>(img) * H * W;
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!vy[r]) continue;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!vx[k]) continue;
        const int64_t e = (img_pix + static_cast<int64_t>(ys[r]) * W + xs[k]) * C + c;
        acc = add_term(acc, wy[r] * wx[k], to_float(x[e]));
      }
    }
    out[m * C + c] = from_float<T>(acc);
  }
}

template <typename T, int C>
int launch_fast(const void* x, const void* ix, const void* iy, void* out, int N, int H, int W,
                int P, bool zeros, cudaStream_t stream) {
  const int L = P % W == 0 && W >= TILE_W ? W : TILE_W;
  const int64_t rows = (static_cast<int64_t>(P) + L - 1) / L;
  const int64_t tiles_x = (L + TILE_W - 1) / TILE_W;
  const int64_t tiles_img = (rows + TILE_H - 1) / TILE_H * tiles_x;
  const int64_t ctas = static_cast<int64_t>(N) * tiles_img;
  if (ctas > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  bilinear_sample_kernel<T, C><<<static_cast<unsigned>(ctas), NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ix), static_cast<const float*>(iy),
      static_cast<T*>(out), H, W, P, L, static_cast<int>(tiles_x), static_cast<int>(tiles_img),
      zeros);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* ix, const void* iy, void* out, int N, int H, int W, int C,
           int P, int zeros, int device, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fast = W >= 2 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  switch (fast ? C : 0) {
    case 4: return launch_fast<T, 4>(x, ix, iy, out, N, H, W, P, zeros != 0, s);
    case 8: return launch_fast<T, 8>(x, ix, iy, out, N, H, W, P, zeros != 0, s);
    case 10: return launch_fast<T, 10>(x, ix, iy, out, N, H, W, P, zeros != 0, s);
    default: break;
  }
  const int64_t total = static_cast<int64_t>(N) * P;
  const int64_t ctas = (total + NTHREADS - 1) / NTHREADS;
  if (ctas > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  bilinear_sample_generic_kernel<T><<<static_cast<unsigned>(ctas), NTHREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(ix), static_cast<const float*>(iy),
      static_cast<T*>(out), H, W, C, P, total, zeros != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (N, H, W, C), ix and iy (N, P) fp32 -> out (N, P, C) in x's type; zeros
// != 0 masks corners outside the image (zeros padding).
int vsr_bilinear_sample_bf16(const void* x, const void* ix, const void* iy, void* out, int N,
                             int H, int W, int C, int P, int zeros, int device, void* stream) {
  return launch<bf16>(x, ix, iy, out, N, H, W, C, P, zeros, device, stream);
}

int vsr_bilinear_sample_fp32(const void* x, const void* ix, const void* iy, void* out, int N,
                             int H, int W, int C, int P, int zeros, int device, void* stream) {
  return launch<float>(x, ix, iy, out, N, H, W, C, P, zeros, device, stream);
}

const char* vsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
