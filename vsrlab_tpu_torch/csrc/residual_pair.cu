// Fused residual conv pair for Hopper (sm_90a):
//
//     out = x + (conv2(relu(conv1(x) + b1)) + b2)
//
// with 3x3 zero-padded convolutions over NHWC activations, C = 64.
//
// Replaces the Pallas TPU kernels of vsrlab_tpu/ops/pallas_conv.py:
//   * residual_conv_pair         (_residual_pair_kernel, lines 39-80): nine
//     shifted K=64 products per conv  -> pair_taps_kernel below;
//   * residual_conv_pair_im2col  (_residual_pair_im2col_kernel, lines 135-181):
//     one K=576 product per conv over a staged patch buffer
//                                      -> pair_im2col_kernel below.
// Both compute in the input dtype with fp32 accumulation, stage conv1's
// output on chip (it never goes to device memory), zero that staged output
// where it lies outside the image (pallas_conv.py:58-64) and add the residual
// in the input dtype (pallas_conv.py:76-77).
//
// What bounds it on an H100: one pair over a 180x320x64 frame is 8.49 GFLOP
// against ~14.9 MB of compulsory traffic at batch 1 (x in, out, both weight
// sets), ~570 FLOP/byte, above the bf16 ridge of ~295: the tensor cores bound
// it, not HBM. The design therefore keeps the intermediate on chip and feeds
// the tensor cores from shared memory:
//   * one CTA per (frame, row tile, column tile), so a single 180x320 frame
//     (one recurrence step at batch 1) launches 300 CTAs over the 132 SMs
//     instead of the Pallas grid's one program per frame;
//   * the x tile (+2-pixel halo) is copied to shared memory with cp.async;
//     conv1 is computed over the tile plus a 1-pixel halo into a shared-memory
//     y tile, so conv2 needs no second pass over device memory;
//   * the products run on bf16 tensor cores (ldmatrix + mma.sync m16n8k16,
//     fp32 accumulators). Every lane computes its own A-row address, so the
//     shifted-window taps need no im2col copy in the taps kernel;
//   * one conv's weights (9*64*64 bf16 = 73.7 KB) are resident at a time:
//     w2 is loaded into w1's buffer while conv1's epilogue writes the y tile;
//   * shared-memory rows are padded to 72 bf16 (144 B) so the 8 row addresses
//     of every ldmatrix hit distinct banks.
// Not yet done (later work): wgmma, TMA, multi-stage pipelining, persistent
// CTAs. fp32 inputs take a plain FMA path (pair_fp32_kernel), used for the
// on-card parity check; it serves both formulations.
//
// Interface: plain C, loaded with ctypes. Every entry point takes NHWC
// x/out, HWIO weights flattened to (9*C, C) in x's type and fp32 biases,
// launches on the given device and stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int C = 64;          // channels: the kernels are compiled for C = 64
constexpr int LDS = C + 8;     // shared-memory pixel stride (bf16): 144 B
constexpr int LDP = 9 * C + 8; // im2col patch row stride (bf16): 1168 B
constexpr int PROWS = 64;      // im2col patch rows per chunk (4 m16 tiles)
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

// Tile geometry: a CTA writes a TH x TW block of output pixels. conv1 is
// computed over (TH+2) x (TW+2) pixels, which read (TH+4) x (TW+4) of x.
template <int TH_, int TW_>
struct Geom {
  static constexpr int TH = TH_, TW = TW_;
  static constexpr int XW = TW + 4;
  static constexpr int YW = TW + 2;
  static constexpr int NX = (TH + 4) * XW;
  static constexpr int NY = (TH + 2) * YW;
  static constexpr int NO = TH * TW;
  static constexpr int MY = (NY + 15) / 16;  // conv1 m16 tiles
  static_assert(NO % 16 == 0, "output tile must be a whole number of m16 tiles");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous global->shared copy; src_size 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}

// D += A (16x16, row) * B (16x8, col), bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy the x tile, rows r0-2 .. r0+TH+1 and columns c0-2 .. c0+TW+1 of frame
// b, into shared memory (row stride LD elements); pixels outside the image
// are zero (the convolutions' zero padding).
template <class G, class T, int LD>
__device__ __forceinline__ void load_x_tile(T* xs, const T* x, int b, int r0, int c0, int H,
                                            int W) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int VPP = C / EPV;         // vectors per pixel
  for (int i = threadIdx.x; i < G::NX * VPP; i += NTHREADS) {
    const int p = i / VPP, v = i % VPP;
    const int gr = r0 - 2 + p / G::XW, gc = c0 - 2 + p % G::XW;
    const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W;
    const T* src = ok ? x + ((static_cast<size_t>(b) * H + gr) * W + gc) * C + v * EPV : x;
    cp_async16(xs + p * LD + v * EPV, src, ok);
  }
}

// Copy one conv's weights, HWIO flattened to (9*C, C), into shared memory.
__device__ __forceinline__ void load_w(bf16* ws, const bf16* w) {
  constexpr int VPR = C / 8;
  for (int i = threadIdx.x; i < 9 * C * VPR; i += NTHREADS) {
    const int row = i / VPR, v = i % VPR;
    cp_async16(ws + row * LDS + v * 8, w + row * C + v * 8, true);
  }
}

// B fragments of NT n8 tiles for one k16 step; wk points at (row k0, column n0).
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], const bf16* wk, int lane) {
  const bf16* p = wk + (lane & 15) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j)
    ldsm_x4_trans(b[2 * j][0], b[2 * j][1], b[2 * j + 1][0], b[2 * j + 1][1], p + j * 16);
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// One 3x3 conv as nine shifted K=64 products, for one warp: MT m16 tiles
// starting at tile m0 (rows = pixels of an OW-wide output region of NP
// pixels) times NT n8 tiles starting at column n0. Output pixel p reads
// source pixel (p / OW + dy) * SW + p % OW + dx of the SW-wide smem tile.
template <int MT, int NT, int OW, int SW, int NP>
__device__ __forceinline__ void conv3x3_taps(float (&acc)[MT][NT][4], const bf16* src,
                                             const bf16* ws, int m0, int n0) {
  const int lane = threadIdx.x & 31;
  int arow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int p = (m0 + i) * 16 + (lane & 15);
    p = p < NP ? p : NP - 1;  // padding rows repeat a pixel; the epilogue drops them
    arow[i] = ((p / OW) * SW + p % OW) * LDS + (lane >> 4) * 8;
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = ((tap / 3) * SW + tap % 3) * LDS;
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) {
      uint32_t b[NT][2];
      load_b<NT>(b, ws + (tap * C + kc * 16) * LDS + n0, lane);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldsm_x4(a, src + arow[i] + toff + kc * 16);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
}

// conv1 epilogue: y = relu(acc + b1) in fp32, cast to bf16, and zero where
// the y pixel lies outside the image (conv2's zero padding).
template <class G, int MT, int NT>
__device__ __forceinline__ void store_y(bf16* ys, const float (&acc)[MT][NT][4],
                                        const float* b1, int m0, int n0, int r0, int c0,
                                        int H, int W) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (m0 + i) * 16 + g + h * 8;
      if (p >= G::NY) continue;
      const int gr = r0 - 1 + p / G::YW, gc = c0 - 1 + p % G::YW;
      const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        float v0 = fmaxf(acc[i][j][2 * h] + __ldg(b1 + n), 0.f);
        float v1 = fmaxf(acc[i][j][2 * h + 1] + __ldg(b1 + n + 1), 0.f);
        if (!inside) v0 = v1 = 0.f;
        *reinterpret_cast<bf162*>(ys + p * LDS + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

// conv2 epilogue: out = x + bf16(acc + b2), the add rounded once to bf16.
template <class G, int MT, int NT>
__device__ __forceinline__ void store_out(bf16* out, const bf16* xs,
                                          const float (&acc)[MT][NT][4], const float* b2,
                                          int m0, int n0, int b, int r0, int c0, int H,
                                          int W) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (m0 + i) * 16 + g + h * 8;
      const int qr = p / G::TW, qc = p % G::TW;
      const int gr = r0 + qr, gc = c0 + qc;
      if (gr >= H || gc >= W) continue;
      const bf16* res = xs + ((qr + 2) * G::XW + qc + 2) * LDS;
      bf16* dst = out + ((static_cast<size_t>(b) * H + gr) * W + gc) * C;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        const float2 z = __bfloat1622float2(__floats2bfloat162_rn(
            acc[i][j][2 * h] + __ldg(b2 + n), acc[i][j][2 * h + 1] + __ldg(b2 + n + 1)));
        const float2 r = __bfloat1622float2(*reinterpret_cast<const bf162*>(res + n));
        *reinterpret_cast<bf162*>(dst + n) = __floats2bfloat162_rn(r.x + z.x, r.y + z.y);
      }
    }
}

// ---- row 1: nine shifted K=64 products per conv --------------------------

constexpr int TAPS_TH = 12, TAPS_TW = 16;  // 180 rows = 15 row tiles

template <int TH, int TW>
__global__ void __launch_bounds__(NTHREADS, 1)
    pair_taps_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, bf16* __restrict__ out, int H, int W) {
  using G = Geom<TH, TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ys = xs + G::NX * LDS;
  bf16* ws = ys + G::NY * LDS;
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5;

  load_x_tile<G, bf16, LDS>(xs, x, b, r0, c0, H, W);
  load_w(ws, w1);
  cp_async_wait_all();
  __syncthreads();

  {  // conv1 over the (TH+2) x (TW+2) region; each warp takes MT1 row tiles x 64 columns
    static_assert(G::MY % NWARPS == 0, "conv1 tiles must split evenly over the warps");
    constexpr int MT1 = G::MY / NWARPS;
    float acc[MT1][8][4];
    zero_acc(acc);
    conv3x3_taps<MT1, 8, G::YW, G::XW, G::NY>(acc, xs, ws, warp * MT1, 0);
    __syncthreads();  // all warps are done reading w1
    load_w(ws, w2);   // in flight while the epilogue writes the y tile
    store_y<G, MT1, 8>(ys, acc, b1, warp * MT1, 0, r0, c0, H, W);
  }
  cp_async_wait_all();
  __syncthreads();

  {  // conv2 over the TH x TW tile; warps split 4 (rows) x 2 (columns)
    constexpr int MO = G::NO / 16, WN = 2, WM = NWARPS / WN;  // conv2 m16 tiles
    static_assert(MO % WM == 0, "conv2 tiles must split evenly over the warps");
    constexpr int MT2 = MO / WM, NT2 = 8 / WN;
    const int m0 = (warp / WN) * MT2, n0 = (warp % WN) * NT2 * 8;
    float acc[MT2][NT2][4];
    zero_acc(acc);
    conv3x3_taps<MT2, NT2, G::TW, G::YW, G::NO>(acc, ys, ws, m0, n0);
    store_out<G, MT2, NT2>(out, xs, acc, b2, m0, n0, b, r0, c0, H, W);
  }
}

// ---- row 2: one K=576 product per conv over a staged patch tile ----------

constexpr int I2C_TH = 8, I2C_TW = 16;

// Patch rows 0..PROWS-1 <- 3x3 neighbourhoods (9*C values, tap-major like
// the HWIO weights) of region pixels p0 .. p0+PROWS-1 (clamped to NP-1).
template <int OW, int SW, int NP>
__device__ __forceinline__ void fill_patch(bf16* patch, const bf16* src, int p0) {
  constexpr int VPT = C / 8;       // 16-byte vectors per tap
  constexpr int VPR = 9 * VPT;     // vectors per patch row
  for (int i = threadIdx.x; i < PROWS * VPR; i += NTHREADS) {
    const int row = i / VPR, v = i % VPR;
    const int tap = v / VPT, cv = v % VPT;
    int p = p0 + row;
    p = p < NP ? p : NP - 1;
    const int sp = (p / OW + tap / 3) * SW + p % OW + tap % 3;
    *reinterpret_cast<uint4*>(patch + row * LDP + v * 8) =
        *reinterpret_cast<const uint4*>(src + sp * LDS + cv * 8);
  }
}

// (16 x 576) @ (576 x NT*8) for one warp: patch row tile mt, columns n0..
template <int NT>
__device__ __forceinline__ void gemm_patch(float (&acc)[1][NT][4], const bf16* patch,
                                           const bf16* ws, int mt, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = patch + (mt * 16 + (lane & 15)) * LDP + (lane >> 4) * 8;
#pragma unroll 4
  for (int k = 0; k < 9 * C; k += 16) {
    uint32_t b[NT][2];
    load_b<NT>(b, ws + k * LDS + n0, lane);
    uint32_t a[4];
    ldsm_x4(a, pa + k);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_bf16(acc[0][j], a, b[j][0], b[j][1]);
  }
}

template <int TH, int TW>
__global__ void __launch_bounds__(NTHREADS, 1)
    pair_im2col_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                       const float* __restrict__ b1, const bf16* __restrict__ w2,
                       const float* __restrict__ b2, bf16* __restrict__ out, int H, int W) {
  using G = Geom<TH, TW>;
  static_assert((G::MY * 16) % PROWS == 0 && G::NO % PROWS == 0, "whole patch chunks");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ys = xs + G::NX * LDS;
  bf16* ws = ys + G::NY * LDS;
  bf16* patch = ws + 9 * C * LDS;
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5;
  // per chunk: warps split 4 (row tiles) x 2 (32-column halves)
  const int wm = warp >> 1, n0 = (warp & 1) * 32;

  load_x_tile<G, bf16, LDS>(xs, x, b, r0, c0, H, W);
  load_w(ws, w1);
  cp_async_wait_all();
  __syncthreads();

  for (int p0 = 0; p0 < G::MY * 16; p0 += PROWS) {
    fill_patch<G::YW, G::XW, G::NY>(patch, xs, p0);
    __syncthreads();
    float acc[1][4][4];
    zero_acc(acc);
    gemm_patch<4>(acc, patch, ws, wm, n0);
    store_y<G, 1, 4>(ys, acc, b1, p0 / 16 + wm, n0, r0, c0, H, W);
    __syncthreads();  // the patch is refilled next
  }
  load_w(ws, w2);
  cp_async_wait_all();
  __syncthreads();

  for (int p0 = 0; p0 < G::NO; p0 += PROWS) {
    fill_patch<G::TW, G::YW, G::NO>(patch, ys, p0);
    __syncthreads();
    float acc[1][4][4];
    zero_acc(acc);
    gemm_patch<4>(acc, patch, ws, wm, n0);
    store_out<G, 1, 4>(out, xs, acc, b2, p0 / 16 + wm, n0, b, r0, c0, H, W);
    __syncthreads();
  }
}

// ---- fp32: plain FMA path (parity checks with TF32 off) ------------------

constexpr int F32_TH = 12, F32_TW = 16;

template <int TH, int TW>
__global__ void __launch_bounds__(NTHREADS)
    pair_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out, int H, int W) {
  using G = Geom<TH, TW>;
  constexpr int PG = NTHREADS / C;  // pixel groups
  constexpr int PB = 8;             // pixels per thread per pass
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + G::NX * C;
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int co = threadIdx.x % C, pg = threadIdx.x / C;

  load_x_tile<G, float, C>(xs, x, b, r0, c0, H, W);
  cp_async_wait_all();
  __syncthreads();

  for (int base = pg; base < G::NY; base += PG * PB) {
    float acc[PB];
    int src[PB];
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      int p = base + j * PG;
      p = p < G::NY ? p : G::NY - 1;
      src[j] = (p / G::YW) * G::XW + p % G::YW;
      acc[j] = 0.f;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * G::XW + tap % 3;
      const float* wt = w1 + tap * C * C + co;
      for (int ci = 0; ci < C; ++ci) {
        const float wv = __ldg(wt + ci * C);
#pragma unroll
        for (int j = 0; j < PB; ++j) acc[j] = fmaf(xs[(src[j] + toff) * C + ci], wv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      const int p = base + j * PG;
      if (p >= G::NY) continue;
      const int gr = r0 - 1 + p / G::YW, gc = c0 - 1 + p % G::YW;
      const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
      ys[p * C + co] = inside ? fmaxf(acc[j] + __ldg(b1 + co), 0.f) : 0.f;
    }
  }
  __syncthreads();

  for (int base = pg; base < G::NO; base += PG * PB) {
    float acc[PB];
    int src[PB];
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      int p = base + j * PG;
      p = p < G::NO ? p : G::NO - 1;
      src[j] = (p / G::TW) * G::YW + p % G::TW;
      acc[j] = 0.f;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * G::YW + tap % 3;
      const float* wt = w2 + tap * C * C + co;
      for (int ci = 0; ci < C; ++ci) {
        const float wv = __ldg(wt + ci * C);
#pragma unroll
        for (int j = 0; j < PB; ++j) acc[j] = fmaf(ys[(src[j] + toff) * C + ci], wv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      const int p = base + j * PG;
      if (p >= G::NO) continue;
      const int qr = p / G::TW, qc = p % G::TW;
      const int gr = r0 + qr, gc = c0 + qc;
      if (gr >= H || gc >= W) continue;
      out[((static_cast<size_t>(b) * H + gr) * W + gc) * C + co] =
          xs[((qr + 2) * G::XW + qc + 2) * C + co] + (acc[j] + __ldg(b2 + co));
    }
  }
}

// Set the device and the kernel's shared-memory limit, then launch one CTA
// per (column tile, row tile, frame). Both settings are per device, so they
// are made on every call (host-side, no synchronisation).
template <int TH, int TW, class T, class K>
int launch(K kernel, size_t smem, const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int B, int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<T*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int vsr_residual_pair_taps_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int B, int H, int W, int device,
                                void* stream) {
  using G = Geom<TAPS_TH, TAPS_TW>;
  constexpr size_t smem = static_cast<size_t>(G::NX + G::NY + 9 * C) * LDS * sizeof(bf16);
  return launch<TAPS_TH, TAPS_TW, bf16>(pair_taps_kernel<TAPS_TH, TAPS_TW>, smem, x, w1, b1, w2,
                                        b2, out, B, H, W, device, stream);
}

int vsr_residual_pair_im2col_bf16(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out, int B, int H,
                                  int W, int device, void* stream) {
  using G = Geom<I2C_TH, I2C_TW>;
  constexpr size_t smem =
      (static_cast<size_t>(G::NX + G::NY + 9 * C) * LDS + PROWS * LDP) * sizeof(bf16);
  return launch<I2C_TH, I2C_TW, bf16>(pair_im2col_kernel<I2C_TH, I2C_TW>, smem, x, w1, b1, w2,
                                      b2, out, B, H, W, device, stream);
}

int vsr_residual_pair_fp32(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int B, int H, int W, int device,
                           void* stream) {
  using G = Geom<F32_TH, F32_TW>;
  constexpr size_t smem = static_cast<size_t>(G::NX + G::NY) * C * sizeof(float);
  return launch<F32_TH, F32_TW, float>(pair_fp32_kernel<F32_TH, F32_TW>, smem, x, w1, b1, w2,
                                       b2, out, B, H, W, device, stream);
}

const char* vsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
