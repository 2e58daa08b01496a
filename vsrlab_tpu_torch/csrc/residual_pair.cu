// Fused residual conv pair for Hopper (sm_90a):
//
//     out = x + bf16(conv2(bf16(relu(conv1(x) + b1))) + b2)
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
// against 14.9 MB of compulsory traffic (x in, out, both weight sets), ~570
// FLOP/byte, above the bf16 ridge of ~295: the tensor cores bound it. At
// batch 10 the 147 MB no longer fit the 50 MB L2, so device memory has to be
// streamed under the products, not before them. Both kernels therefore run
// wgmma (m64nNk16, bf16 in, fp32 accumulators in registers) from
// 128-byte-swizzled shared-memory tiles, on a persistent grid of one CTA of
// two warpgroups a streaming multiprocessor, each walking over image tiles.
//
// pair_taps_kernel computes every tap transposed, (64 channels x N pixels) =
// W_tap^T * X_tap^T:
//   * the weights are wgmma's A operand and stay in registers for the whole
//     launch (144 registers a thread and conv: warpgroup 0 holds w1 and runs
//     conv1, warpgroup 1 holds w2 and runs conv2), so no weight byte crosses
//     shared memory and each wgmma reads only its N pixels x 16 channels;
//   * the pixels are its B operand, read by a descriptor whose start moves
//     by whole pixels (128-byte rows) for each tap over a linearly addressed
//     tile: no patch copy, no ldmatrix, 36 wgmmas a chunk sent back to back;
//   * x tiles arrive by TMA (one box a tile, zero fill outside the image is
//     the convs' padding) into a ring of three, two tiles ahead; conv1's
//     epilogue writes the y tile with stmatrix.trans; conv2's epilogue takes
//     its residual from the x tile with ldmatrix.trans, adds on fragments and
//     hands whole tile rows to TMA stores;
//   * the warpgroups meet only at mbarriers, a chunk at a time (y_full,
//     y_empty), so conv2 of one tile overlaps conv1 of the next.
// pair_im2col_kernel keeps the staged-patch formulation: two producer groups
// copy one tap's 64 x 64 slab at a time, shared to shared, into a ring of
// three that a consumer warpgroup multiplies with both operands behind
// descriptors (all 36 k16 steps into one accumulator: one K=576 product);
// both convs' weights are resident in shared memory, loaded once a CTA.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 5, device
// time of one launch by CUDA-graph replay, bf16, (B, 180, 320, 64)):
//   taps:   0.0203 / 0.0421 / 0.1722 / 0.3321 ms at B = 1 / 2 / 10 / 20, that is
//           42 / 41 / 50 / 52 % of the tensor-core bound (the mma.sync kernels
//           before read 0.0514 / 0.0801 / 0.3608 / 0.6696 ms, 17-26 %);
//   im2col: 0.0609 / 0.4811 ms at B = 1 / 10, 14 / 18 % of the bound, beside
//           0.0644 / 0.5429 ms for two cuDNN convolutions (before: 0.0995 /
//           0.8000 ms). The shared-to-shared patch copy doubles its traffic
//           through shared memory, which is what bounds it.
// No kernel spills (ptxas: 255 and 244 registers for the taps kernel's two
// tile sizes, 87 for im2col).
//
// fp32 inputs of either formulation go to pair_fp32_kernel: IEEE fp32 FFMAs
// on the CUDA cores (no TF32, no tensor-core split), for the flow trainer's
// cleaner, `precision: fp32` serving and training of RealBasicVSR /
// BasicVSR, and the fp32 parity checks. The FMA pipes bound it: 147 kFLOP
// a pixel against 512 bytes of x and out (288 FLOP a byte; the fp32 ridge
// is 67 TFLOP/s over 3.35 TB/s, 20). Each thread keeps 8 output channels
// of 6-10 pixels in registers and reads x and the weights as 16-byte
// vectors from shared memory, 14-18 FFMAs a load; the weights pass through
// a two-slab ring, one tap a slab (design below).
// Measured (the same card, chip_smoke.py phase 6, graph replay):
// 0.1965 / 0.2665 / 2.2256 ms at (16,48,64) / (1,180,320) / (10,180,320),
// 55 / 48 / 57 % of the bound, against cuDNN's fp32 pair with TF32 off at
// 0.3147 / 0.3235 / 3.0352 ms; PR 1's kernel (one channel and 8 pixels a
// thread, every weight read from L2 in the inner loop) took 1.7447 /
// 2.5068 / 19.6808 ms. ptxas: 167 and 168 registers, no spills.
//
// Interface: plain C, loaded with ctypes. Every entry point takes NHWC
// x/out, fp32 biases and the weights in x's type: HWIO flattened to (9*C, C),
// except that the bf16 taps entry takes them as the register fragments of
// ops/residual_pair.py pack_weight_fragments. It launches on the given device
// and stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 on success). vsr_residual_pair_plan reports the tile
// and grid a launch of each kernel would get, by the rule the entries
// themselves use.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int C = 64;                // channels: the kernels are compiled for C = 64
constexpr int PIXB = C * 2;          // bytes of one bf16 pixel: one 128-byte swizzle row
constexpr int WBYTES = 9 * C * PIXB; // one conv's bf16 weights: 73,728 B
constexpr int SLAB = 64 * PIXB;      // one 64 x 64 bf16 operand block: 8,192 B
constexpr int NTHREADS = 256;        // two warpgroups

// Tile geometry: a CTA writes TH x TW output pixels a tile. conv1 is computed
// over (TH+2) x (TW+2) pixels, which read (TH+4) x (TW+4) of x.
template <int TH_, int TW_>
struct Geom {
  static constexpr int TH = TH_, TW = TW_;
  static constexpr int XW = TW + 4;
  static constexpr int YW = TW + 2;
  static constexpr int NX = (TH + 4) * XW;
  static constexpr int NY = (TH + 2) * YW;
  static constexpr int NO = TH * TW;
  static constexpr int MY = (NY + 63) / 64;  // conv1 m64 tiles
  static constexpr int MO = (NO + 63) / 64;  // conv2 m64 tiles
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous global->shared copy; src_size 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  cp_async16(smem_addr(dst), src, valid);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) become visible
// to the async proxy, through which wgmma reads its descriptor operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- swizzled shared-memory layouts ---------------------------------------
//
// Every bf16 tile in shared memory is rows of 128 bytes (one pixel's 64
// channels, or 64 output channels of one weight row), eight 16-byte chunks a
// row, chunk c of row r stored at chunk c ^ (r & 7): the hardware's 128-byte
// swizzle when the tile starts on a 1024-byte boundary, so a wgmma descriptor
// reads it, and the 8 rows of an ldmatrix fall into distinct banks.
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * PIXB + ((chunk ^ (row & 7)) << 4));
}

// Copy the x tile, rows r0-2 .. r0+TH+1 and columns c0-2 .. c0+TW+1 of frame
// b, into shared memory; pixels outside the image are zero (the convolutions'
// zero padding). Called by `nthreads` threads numbered `tid`.
template <class G>
__device__ __forceinline__ void load_x_swz(uint32_t xs, const bf16* x, int b, int r0, int c0,
                                           int H, int W, int tid, int nthreads) {
  for (int i = tid; i < G::NX * 8; i += nthreads) {
    const int p = i >> 3, v = i & 7;
    const int gr = r0 - 2 + p / G::XW, gc = c0 - 2 + p % G::XW;
    const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W;
    const bf16* src = ok ? x + ((static_cast<size_t>(b) * H + gr) * W + gc) * C + v * 8 : x;
    cp_async16(xs + swz(p, v), src, ok);
  }
}

// Copy one conv's weights, HWIO flattened to (9*C, C): row k = tap*64 + ci
// holds the 64 output channels. As a wgmma B operand this is the MN-major
// layout (N contiguous): one tap is four k16 steps of 2,048 B.
__device__ __forceinline__ void load_w_swz(uint32_t ws, const bf16* w, int tid) {
  for (int i = tid; i < 9 * C * 8; i += NTHREADS) {
    const int row = i >> 3, v = i & 7;
    cp_async16(ws + swz(row, v), w + row * C + v * 8, true);
  }
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle, 1,024 B between groups
// of eight rows; the leading-dimension offset is unused at these sizes.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps an accumulator out of the compiler's hands until its wgmma group has
// been waited for.
__device__ __forceinline__ void keep(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VSR_ACC32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define VSR_ACC32_LIST                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D (64 x N, fp32) += A (64 x 16 bf16, this warp's m16k16 fragment in registers)
// * B (N x 16 bf16 in shared memory, K contiguous: N pixels of 16 channels),
// for N = 104, 120 and 128 (N / 2 accumulator registers a thread).
__device__ __forceinline__ void wgmma_rs(float (&d)[52], const uint32_t (&a)[4],
                                         uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[60], const uint32_t (&a)[4],
                                         uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59}, "
      "{%60, %61, %62, %63}, %64, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16 bf16, K contiguous) * B (16 x 64 bf16, N
// contiguous), both in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t adesc, uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VSR_ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : VSR_ACC32(d)
      : "l"(adesc), "l"(bdesc), "r"(1));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the barrier has left the phase of the given parity. A barrier
// that never flips is a fault in the kernel: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The arrival of the one thread that then starts a TMA load of `bytes`.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// One box of a 4-D tensor map into shared memory; `bar` counts its bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, uint64_t map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of shared memory out to a 4-D tensor map (clipped at its edges),
// as part of the calling thread's bulk group.
__device__ __forceinline__ void tma_store_4d(uint64_t map, uint32_t src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Returns once the thread's stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- epilogues ------------------------------------------------------------
//
// Accumulator layout of an m64n64 tile: the thread of warp wq (of its
// warpgroup), lane 4*g + t, holds rows wq*16 + g + 8*h (h = 0, 1) and columns
// 8*j + 2*t, +1 (j = 0..7) in d[4*j + 2*h], d[4*j + 2*h + 1].

// conv1 epilogue: y = relu(acc + b1) in fp32, cast to bf16, and zero where
// the y pixel lies outside the image (conv2's zero padding). Every pixel of
// the y tile is rewritten for every tile.
template <class G>
__device__ __forceinline__ void store_y(unsigned char* ys, const float (&d)[32], const float* b1,
                                        int mt, int r0, int c0, int H, int W) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = mt * 64 + wq * 16 + g + h * 8;
    if (p >= G::NY) continue;
    const int gr = r0 - 1 + p / G::YW, gc = c0 - 1 + p % G::YW;
    const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = j * 8 + 2 * t;
      float v0 = fmaxf(d[4 * j + 2 * h] + __ldg(b1 + n), 0.f);
      float v1 = fmaxf(d[4 * j + 2 * h + 1] + __ldg(b1 + n + 1), 0.f);
      if (!inside) v0 = v1 = 0.f;
      *reinterpret_cast<bf162*>(ys + swz(p, j) + 4 * t) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// The residual for store_out, read from device memory before conv2's products
// are started so that the loads are in flight while they run (the tile's x was
// fetched moments ago, so it comes from L2). The shared x tile is then free
// for the next tile's load as soon as conv1 is done.
template <class G>
__device__ __forceinline__ void load_residual(uint32_t (&res)[16], const bf16* x, int mt, int b,
                                              int r0, int c0, int H, int W) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = mt * 64 + wq * 16 + g + h * 8;
    const int gr = r0 + p / G::TW, gc = c0 + p % G::TW;
    const bool ok = p < G::NO && gr < H && gc < W;
    const bf16* src = x + ((static_cast<size_t>(b) * H + gr) * W + gc) * C + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      res[h * 8 + j] = ok ? *reinterpret_cast<const uint32_t*>(src + j * 8) : 0u;
  }
}

// conv2 epilogue: out = x + bf16(acc + b2), the add rounded once to bf16.
template <class G>
__device__ __forceinline__ void store_out(bf16* out, const uint32_t (&res)[16],
                                          const float (&d)[32], const float* b2, int mt, int b,
                                          int r0, int c0, int H, int W) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = mt * 64 + wq * 16 + g + h * 8;
    if (p >= G::NO) continue;
    const int gr = r0 + p / G::TW, gc = c0 + p % G::TW;
    if (gr >= H || gc >= W) continue;
    bf16* dst = out + ((static_cast<size_t>(b) * H + gr) * W + gc) * C + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = j * 8 + 2 * t;
      const float2 z = __bfloat1622float2(__floats2bfloat162_rn(
          d[4 * j + 2 * h] + __ldg(b2 + n), d[4 * j + 2 * h + 1] + __ldg(b2 + n + 1)));
      const uint32_t rw = res[h * 8 + j];
      const float2 r = __bfloat1622float2(*reinterpret_cast<const bf162*>(&rw));
      *reinterpret_cast<bf162*>(dst + j * 8) = __floats2bfloat162_rn(r.x + z.x, r.y + z.y);
    }
  }
}

// The image tile a CTA works on: tiles are numbered frame-major, then by
// rows, and a persistent CTA takes every gridDim.x-th.
struct Tile {
  int b, r0, c0;
};
template <class G>
__device__ __forceinline__ Tile tile_at(int tile, int tiles_x, int tiles_y) {
  const int per = tiles_x * tiles_y, r = tile % per;
  return {tile / per, (r / tiles_x) * G::TH, (r % tiles_x) * G::TW};
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- row 1: nine shifted K=64 products per conv ---------------------------
//
// The products are computed transposed, D^T (64 channels x N pixels) =
// W_tap^T (64 x 64) * X_tap^T (64 x N): the weights are wgmma's A operand and
// stay in registers for the whole launch (36 k16 fragments a conv, 144
// registers a thread; warpgroup 0 holds w1 and runs conv1, warpgroup 1 holds
// w2 and runs conv2), and the pixels are its B operand, read from the shared
// tile by a descriptor. A tile row is P pixels of 128 bytes and a region is
// addressed linearly, q = row * P + column, so tap (dy, dx) of pixels q0 ..
// q0+N-1 is the same N rows of shared memory dy * P + dx pixels further on:
// a shifted descriptor, no patch copy and no ldmatrix. Columns TW+2 .. P-1
// of a row compute values nothing reads.

template <int TH_, int TW_, int N1_, int C1_, int N2_, int C2_, int XBUF_>
struct TapsGeom {
  static constexpr int TH = TH_, TW = TW_;
  static constexpr int P = TW + 4;          // pitch of the x and y tiles, pixels
  static constexpr int HALO = 2 * P + 2;    // the furthest tap
  static constexpr int NXL = (TH + 4) * P;  // x pixels loaded
  static constexpr int N1 = N1_, C1 = C1_;  // conv1: (TH+2) * P pixels in C1 chunks of N1
  static constexpr int N2 = N2_, C2 = C2_;  // conv2: TH * P pixels in C2 chunks of N2
  static constexpr int XBUF = XBUF_;        // x tiles in shared memory
  static constexpr int XPIX = (C1 * N1 + HALO + 7) / 8 * 8;  // x pixels conv1 may read
  static constexpr int YPIX = C1 * N1;                       // y pixels conv1 writes
  static constexpr int XB = XPIX * PIXB, YB = YPIX * PIXB;
  static constexpr int SB = C2 * N2 * PIXB;    // the staging tile: conv2's output region
  static constexpr int NBAR = C1 + C2 + XBUF;  // y_full[C1], y_empty[C2], x_full[XBUF]
  static constexpr size_t SMEM = XBUF * XB + YB + SB + 8 * NBAR + 1024;  // + room to align
  static_assert(C1 * N1 >= (TH + 2) * P && C2 * N2 >= TH * P, "chunks cover the regions");
  static_assert(C2 * N2 + HALO <= YPIX, "conv2 reads inside the y tile");
  static_assert(XB % 1024 == 0 && YB % 1024 == 0, "tiles start on 1024-byte boundaries");
  static_assert(C2 + 1 <= C1, "conv2's chunk k waits for conv1's chunk k+1");
  static_assert(N2 >= N1 && C2 * N2 - 1 + HALO < (C2 + 1) * N1,
                "chunks 0 .. k+1 of y cover what chunk k of conv2 reads");
  static_assert(SMEM <= 232448, "fits the shared memory a block may use");
  static_assert(XBUF == 1 || XBUF >= 3, "one tile a CTA, or a ring that keeps conv2's residual");
  static_assert(P <= 256 && TH + 4 <= 256, "the x tile is one TMA box");
};
// 180 x 320 is 12 x 11 wide tiles, one an SM: for launches of at most one
// tile a CTA (a frame), which have no next tile to overlap with.
using TapsWide = TapsGeom<15, 30, 120, 5, 128, 4, 1>;
// Smaller tiles leave room for a ring of three x tiles: one computes, the
// next two are on their way from device memory, and the one before stays
// until conv2 has taken its residual. For every launch of more tiles than SMs.
using TapsDeep = TapsGeom<7, 30, 104, 3, 120, 2, 3>;

// This thread's A fragments of one conv's weights. A = W_tap^T: row m is the
// output channel, column k the input channel, and register r of step
// tap*4 + kc holds A[16*wq + g + 8*(r&1)][kc*16 + 2*t + 8*(r>>1), +1] for
// warp wq, lane 4*g + t. The caller passes the weights in that order,
// (36, 4, 32) vectors of four registers (ops/residual_pair.py
// pack_weight_fragments), so a thread's load is 36 coalesced 16-byte reads.
__device__ __forceinline__ void load_w_frags(uint32_t (&a)[36][4], const uint4* wp) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int step = 0; step < 36; ++step) {
    const uint4 v = __ldg(wp + (step * 4 + wq) * 32 + lane);
    a[step][0] = v.x, a[step][1] = v.y, a[step][2] = v.z, a[step][3] = v.w;
  }
}

// One chunk of a 3x3 conv: all 36 k16 steps into one accumulator, sent
// back to back (nothing in the chain waits on a load).
template <int P, int NACC>
__device__ __forceinline__ void conv_chunk(float (&acc)[NACC], const uint32_t (&a)[36][4],
                                           uint32_t src) {
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
  const uint64_t desc = make_desc(src);
  wgmma_fence();
#pragma unroll
  for (int step = 0; step < 36; ++step) {
    const int tap = step >> 2, kc = step & 3;
    const int off = ((tap / 3) * P + tap % 3) * PIXB + kc * 32;
    wgmma_rs(acc, a[step], desc + static_cast<uint64_t>(off >> 4));
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < NACC; ++e) asm volatile("" : "+f"(acc[e])::"memory");
}

__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                              uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stsm_x2_trans(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1, %2};\n" ::"r"(addr),
               "r"(r0), "r"(r1)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf162(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of an m64nN tile: the thread of warp wq, lane 4*g + t,
// holds channels 16*wq + g + 8*h (h = 0, 1) of pixels 8*j + 2*t, +1 in
// d[4*j + 2*h], d[4*j + 2*h + 1]. A packed pair of pixels is the fragment of
// an 8 x 8 (channel x pixel) block, which stmatrix.trans writes pixel-major:
// eight channels, 16 bytes, a pixel row. `dst` is a swizzled tile whose
// pixel 0 is the chunk's first; pair(j, h) gives the packed pair.
template <int NJ, class F>
__device__ __forceinline__ void store_transposed(uint32_t dst, F pair) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j + 1 < NJ; j += 2)
    stsm_x4_trans(dst + swz(8 * (j + (i >> 1)) + r, 2 * wq + (i & 1)), pair(j, 0), pair(j, 1),
                  pair(j + 1, 0), pair(j + 1, 1));
  if (NJ & 1)
    stsm_x2_trans(dst + swz(8 * (NJ - 1) + r, 2 * wq + (i & 1)), pair(NJ - 1, 0),
                  pair(NJ - 1, 1));
}

template <class G>
__global__ void __launch_bounds__(NTHREADS, 1)
    pair_taps_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap omap, const uint4* __restrict__ w1,
                     const float* __restrict__ b1, const uint4* __restrict__ w2,
                     const float* __restrict__ b2, int H, int W, int tiles_x, int tiles_y,
                     int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t XS = smem_addr(sm), YS = XS + G::XBUF * G::XB, ST = YS + G::YB;
  // barriers: y_full[c] (conv1 wrote chunk c), y_empty[k] (conv2's chunk k has
  // read y), x_full[i] (x tile i has landed)
  const uint32_t BARS = ST + G::SB, Y_EMPTY = BARS + 8 * G::C1;
  const uint32_t X_FULL = Y_EMPTY + 8 * G::C2;
  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const uint64_t xmap_addr = reinterpret_cast<uint64_t>(&xmap);
  const uint64_t omap_addr = reinterpret_cast<uint64_t>(&omap);

  // x tile of `tile` into buffer `buf`: one TMA box, rows r0-2 .. r0+TH+1 and
  // columns c0-2 .. c0+P-3 of the frame, zero outside the image (the convs'
  // zero padding), swizzled as swz() does. Called by one thread.
  auto load_x = [&](int tile, int buf) {
    const Tile n = tile_at<G>(tile, tiles_x, tiles_y);
    mbar_expect_tx(X_FULL + 8 * buf, G::NXL * PIXB);
    tma_load_4d(XS + buf * G::XB, xmap_addr, X_FULL + 8 * buf, 0, n.c0 - 2, n.r0 - 2, n.b);
  };
  if (tid == 0) {
    for (int c = 0; c < G::C1 + G::C2; ++c) mbar_init(BARS + 8 * c, 128);
    for (int i = 0; i < G::XBUF; ++i) mbar_init(X_FULL + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
    load_x(blockIdx.x, 0);
    if (G::XBUF >= 3 && blockIdx.x + gridDim.x < ntiles) load_x(blockIdx.x + gridDim.x, 1);
  }
  // pixels past the loaded x tile are read by chunks' last columns only: zero, once
  for (int i = tid; i < G::XBUF * (G::XPIX - G::NXL) * 8; i += NTHREADS) {
    const int buf = i / ((G::XPIX - G::NXL) * 8), j = i % ((G::XPIX - G::NXL) * 8);
    *reinterpret_cast<uint4*>(sm + buf * G::XB + G::NXL * PIXB + j * 16) = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  __syncthreads();

  if (tid < 128) {
    // ---- warpgroup 0: conv1, y tile out ----
    uint32_t a[36][4];
    load_w_frags(a, w1);
    const float bias[2] = {__ldg(b1 + 16 * wq + g), __ldg(b1 + 16 * wq + g + 8)};
    int round = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++round) {
      const Tile tl = tile_at<G>(tile, tiles_x, tiles_y);
      const int buf = round % G::XBUF;
      mbar_wait(X_FULL + 8 * buf, (round / G::XBUF) & 1);  // the x tile has landed
      for (int c = 0; c < G::C1; ++c) {
        float acc[G::N1 / 2];
        conv_chunk<G::P>(acc, a, XS + buf * G::XB + c * G::N1 * PIXB);
        // chunk c of y is last read by conv2's chunk min(c, C2-1) of the tile before
        if (round > 0) mbar_wait(Y_EMPTY + 8 * (c < G::C2 ? c : G::C2 - 1), (round - 1) & 1);
        // y = relu(acc + b1) in fp32, cast to bf16, zero outside the image.
        // Pixel pair j of this thread is q = c*N1 + 8*j + 2*t, +1: both in one
        // tile row (P and q are even), walked row by row without dividing.
        const int q0 = c * G::N1 + 2 * t;
        int gr = tl.r0 - 1 + q0 / G::P, gc = tl.c0 - 1 + q0 % G::P;
        const int gc_wrap = tl.c0 - 1 + G::P;
        bool in0[G::N1 / 8], in1[G::N1 / 8];
#pragma unroll
        for (int j = 0; j < G::N1 / 8; ++j) {
          const bool row_in = static_cast<unsigned>(gr) < static_cast<unsigned>(H);
          in0[j] = row_in && static_cast<unsigned>(gc) < static_cast<unsigned>(W);
          in1[j] = row_in && static_cast<unsigned>(gc + 1) < static_cast<unsigned>(W);
          gc += 8;
          if (gc >= gc_wrap) gc -= G::P, ++gr;
        }
        store_transposed<G::N1 / 8>(YS + c * G::N1 * PIXB, [&](int j, int h) {
          return pack_bf162(in0[j] ? fmaxf(acc[4 * j + 2 * h] + bias[h], 0.f) : 0.f,
                            in1[j] ? fmaxf(acc[4 * j + 2 * h + 1] + bias[h], 0.f) : 0.f);
        });
        fence_proxy_async();
        mbar_arrive(BARS + 8 * c);
      }
      if (G::XBUF < 3) break;  // launched with one tile a CTA
    }
  } else {
    // ---- warpgroup 1: conv2, residual add, out; the x ring's loads ----
    uint32_t a[36][4];
    load_w_frags(a, w2);
    const float bias[2] = {__ldg(b2 + 16 * wq + g), __ldg(b2 + 16 * wq + g + 8)};
    const int mi = lane >> 3, mr = lane & 7;  // ldmatrix / stmatrix: matrix and row of this lane
    int round = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++round) {
      const Tile tl = tile_at<G>(tile, tiles_x, tiles_y);
      const uint32_t xs = XS + (round % G::XBUF) * G::XB;
      for (int k = 0; k < G::C2; ++k) {
        mbar_wait(BARS + 8 * (k + 1), round & 1);  // y up to this chunk's halo is written
        float acc[G::N2 / 2];
        conv_chunk<G::P>(acc, a, YS + k * G::N2 * PIXB);
        mbar_arrive(Y_EMPTY + 8 * k);
        if (k == 0) {
          // The tile two on goes where the tile before this one lay: conv1 and
          // conv2 (whose last epilogue read its residual there) are done with it.
          if (G::XBUF >= 3 && tid == 128 && tile + 2 * gridDim.x < ntiles)
            load_x(tile + 2 * gridDim.x, (round + 2) % G::XBUF);
          // the x tile landed long since: waited for to see it
          mbar_wait(X_FULL + 8 * (round % G::XBUF), (round / G::XBUF) & 1);
          // the stores of the tile before have read the staging tile
          if (tid == 128) tma_store_wait_read();
          asm volatile("bar.sync 2, 128;\n" ::: "memory");
        }
        // out = x + bf16(acc + b2), the add rounded once to bf16, on fragments:
        // ldmatrix.trans hands each thread the residual of its own channels
        // and pixels (the x tile's pixel one halo further on), stmatrix.trans
        // writes the sums pixel-major into the staging tile.
        // Pairs of 8-pixel blocks; when their number is odd the last pair
        // repeats the block before. Residual loads run two pairs ahead of
        // the stores.
        constexpr int NJ = G::N2 / 8, NP = (NJ + 1) / 2;
        const int v = 2 * wq + (mi & 1);
        auto first_pixel = [&](int pr) {
          return k * G::N2 + 8 * ((2 * pr + 1 < NJ ? 2 * pr : NJ - 2) + (mi >> 1)) + mr;
        };
        uint32_t res[NP][4];
        ldsm_x4_trans(res[0], xs + swz(first_pixel(0) + G::HALO, v));
        if (NP > 1) ldsm_x4_trans(res[1], xs + swz(first_pixel(1) + G::HALO, v));
#pragma unroll
        for (int pr = 0; pr < NP; ++pr) {
          if (pr + 2 < NP) ldsm_x4_trans(res[pr + 2], xs + swz(first_pixel(pr + 2) + G::HALO, v));
          const int jj = 2 * pr + 1 < NJ ? 2 * pr : NJ - 2;
          uint32_t o[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int bj = jj + (m >> 1), h = m & 1;
            const float2 zf = __bfloat1622float2(__floats2bfloat162_rn(
                acc[4 * bj + 2 * h] + bias[h], acc[4 * bj + 2 * h + 1] + bias[h]));
            const float2 xf = __bfloat1622float2(*reinterpret_cast<const bf162*>(&res[pr][m]));
            o[m] = pack_bf162(xf.x + zf.x, xf.y + zf.y);
          }
          stsm_x4_trans(ST + swz(first_pixel(pr), v), o[0], o[1], o[2], o[3]);
        }
        if (k == G::C2 - 1) {
          // the staging tile is whole: one TMA store a tile row, TW pixels wide
          // and clipped at the image's edges
          fence_proxy_async();
          asm volatile("bar.sync 2, 128;\n" ::: "memory");
          if (tid == 128) {
            for (int r = 0; r < G::TH; ++r)
              tma_store_4d(omap_addr, ST + r * G::P * PIXB, 0, tl.c0, tl.r0 + r, tl.b);
            tma_store_commit();
          }
        }
      }
      if (G::XBUF < 3) break;  // launched with one tile a CTA
    }
    // the stores must have read shared memory before the CTA exits
    if (tid == 128) tma_store_wait_read();
  }
}

// ---- row 2: one K=576 product per conv over a staged patch ----------------

constexpr int I2C_TH = 8, I2C_TW = 16;
constexpr int NSLAB = 3;  // patch ring: 64 rows x one tap (K = 64) a slab

// Source pixels of patch rows (gtid >> 3) + 8*k, k = 0..7, of m64 tile mt:
// region pixels mt*64 + row (clamped to NP-1) of an OW-wide output region
// over an SW-wide shared tile, before the tap's offset is added.
template <int OW, int SW, int NP>
__device__ __forceinline__ void slab_sources(int (&s0)[8], int mt, int gtid) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int p = mt * 64 + (gtid >> 3) + 8 * k;
    p = p < NP ? p : NP - 1;
    s0[k] = (p / OW) * SW + p % OW;
  }
}

// Patch slab <- tap (dy, dx) of those pixels, in the K-major 128-byte-swizzled
// layout a wgmma descriptor reads. Called by one producer group of 64
// threads; thread gtid copies 16-byte vector gtid & 7 of its eight rows.
template <int SW>
__device__ __forceinline__ void fill_slab(unsigned char* slab, const unsigned char* src,
                                          const int (&s0)[8], int tap, int gtid) {
  const int c = gtid & 7, toff = (tap / 3) * SW + tap % 3;
  uint4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = *reinterpret_cast<const uint4*>(src + swz(s0[k] + toff, c));
#pragma unroll
  for (int k = 0; k < 8; ++k) *reinterpret_cast<uint4*>(slab + swz((gtid >> 3) + 8 * k, c)) = v[k];
}

template <int TH, int TW>
__global__ void __launch_bounds__(NTHREADS, 1)
    pair_im2col_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                       const float* __restrict__ b1, const bf16* __restrict__ w2,
                       const float* __restrict__ b2, bf16* __restrict__ out, int H, int W,
                       int tiles_x, int tiles_y, int ntiles) {
  using G = Geom<TH, TW>;
  constexpr int XB = G::NX * PIXB, YB = (G::NY * PIXB + 1023) / 1024 * 1024;
  static_assert(XB % 1024 == 0, "the patch ring must start on a 1024-byte boundary");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* xsp = sm + 2 * WBYTES;
  unsigned char* ysp = xsp + XB;
  unsigned char* patch = ysp + YB;
  const uint32_t W1 = smem_addr(sm), W2 = W1 + WBYTES, XS = smem_addr(xsp);
  const uint32_t PATCH = smem_addr(patch), BARS = PATCH + NSLAB * SLAB;
  // barriers: full[NSLAB], empty[NSLAB], y_ready
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < NSLAB; ++s) {
      mbar_init(BARS + 8 * s, 64);           // every thread of one producer group arrives
      mbar_init(BARS + 8 * (NSLAB + s), 128);  // every consumer thread arrives
    }
    mbar_init(BARS + 8 * 2 * NSLAB, 128);  // every consumer thread arrives
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    const Tile t = tile_at<G>(blockIdx.x, tiles_x, tiles_y);
    load_w_swz(W1, w1, tid);
    load_w_swz(W2, w2, tid);
    load_x_swz<G>(XS, x, t.b, t.r0, t.c0, H, W, tid, NTHREADS);
    cp_async_commit();
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  }

  if (tid >= 128) {
    // ---- producers: stage patch slabs, fetch the next x tile ----
    // Two groups of 64 threads fill slabs in turn, so that one group's copy
    // runs while the other waits for its slab to be free.
    const int ptid = tid - 128, grp = ptid >> 6, gtid = ptid & 63;
    int it = 0;  // slabs staged so far, by either group
    auto acquire = [&]() -> unsigned char* {  // the next slab, once the consumer has read it
      const int stage = it % NSLAB;
      mbar_wait(BARS + 8 * (NSLAB + stage), ((it / NSLAB) & 1) ^ 1);
      return patch + stage * SLAB;
    };
    auto publish = [&]() {
      fence_proxy_async();
      mbar_arrive(BARS + 8 * (it % NSLAB));
    };
    int round = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++round) {
      for (int mt = 0; mt < G::MY; ++mt) {
        int s0[8];
        slab_sources<G::YW, G::XW, G::NY>(s0, mt, gtid);
        for (int tap = 0; tap < 9; ++tap, ++it)
          if ((it & 1) == grp) {
            fill_slab<G::XW>(acquire(), xsp, s0, tap, gtid);
            publish();
          }
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");  // producers are done reading x
      const int next = tile + gridDim.x;
      if (next < ntiles) {  // lands while conv2 runs
        const Tile n = tile_at<G>(next, tiles_x, tiles_y);
        load_x_swz<G>(XS, x, n.b, n.r0, n.c0, H, W, ptid, 128);
      }
      cp_async_commit();
      mbar_wait(BARS + 8 * 2 * NSLAB, round & 1);  // the y tile is whole
      for (int mt = 0; mt < G::MO; ++mt) {
        int s0[8];
        slab_sources<G::TW, G::YW, G::NO>(s0, mt, gtid);
        for (int tap = 0; tap < 9; ++tap, ++it)
          if ((it & 1) == grp) {
            fill_slab<G::YW>(acquire(), ysp, s0, tap, gtid);
            publish();
          }
      }
      cp_async_wait_all();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the next x tile is whole
    }
  } else {
    // ---- consumer warpgroup: one K=576 product an m64 tile, epilogues ----
    int it = 0;  // slabs consumed so far
    // 36 k16 steps into one accumulator: nine slabs of four
    auto product = [&](float (&acc)[32], uint32_t ws) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      int held = -1;  // the slab the product in flight reads
      for (int tap = 0; tap < 9; ++tap, ++it) {
        const int stage = it % NSLAB;
        mbar_wait(BARS + 8 * stage, (it / NSLAB) & 1);
        const uint64_t ad = make_desc(PATCH + stage * SLAB), bd = make_desc(ws + tap * SLAB);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_ss(acc, ad + static_cast<uint64_t>(kc * (32 >> 4)),
                   bd + static_cast<uint64_t>(kc * (2048 >> 4)));
        wgmma_commit();
        wgmma_wait<1>();  // the slab before this one has been read
        if (held >= 0) mbar_arrive(BARS + 8 * (NSLAB + held));
        held = stage;
      }
      wgmma_wait<0>();
      mbar_arrive(BARS + 8 * (NSLAB + held));
      keep(acc);
    };
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const Tile t = tile_at<G>(tile, tiles_x, tiles_y);
      for (int mt = 0; mt < G::MY; ++mt) {
        float acc[32];
        product(acc, W1);
        store_y<G>(ysp, acc, b1, mt, t.r0, t.c0, H, W);
      }
      mbar_arrive(BARS + 8 * 2 * NSLAB);
      for (int mt = 0; mt < G::MO; ++mt) {
        float acc[32];
        uint32_t res[16];
        load_residual<G>(res, x, mt, t.b, t.r0, t.c0, H, W);
        product(acc, W2);
        store_out<G>(out, res, acc, b2, mt, t.b, t.r0, t.c0, H, W);
      }
    }
  }
}

// ---- fp32: register-tiled FFMA (IEEE fp32 products, no TF32) -------------
//
// One CTA of 256 threads a 12x16 or 12x20 output tile, one launch for the
// whole grid of tiles (one CTA an SM at a time: its shared memory). A thread
// owns a block of pixels x 8 output channels in registers: channels
// 4g..4g+3 and 32+4g..32+4g+3 of channel group g = tid % 8, pixels q, q+32,
// ... of pixel group q = tid / 8 (12x16: conv1 8 pixels of the 252-pixel y
// tile, conv2 6 of the 192 outputs; 12x20: 10 of 308, 8 of 240). For each
// tap and four input channels it reads, as 16-byte vectors, one x vector of
// 4 channels a pixel and 8 weight vectors, for 32 FFMAs a pixel: 16 FFMAs a
// load at 8 pixels, so the FMA pipes and not the load/store unit set the
// pace. The vector axis of x is the channel axis: a tap moves the window by
// whole pixels, and every pixel row starts on 16 bytes, so no tap shift
// misaligns a vector.
//
// Shared memory: the x tile (16x20 / 16x24 px), the y tile (14x18 / 14x22
// px), rows of 68 floats (8 successive pixels in distinct banks: a warp's 4
// pixel groups are 4 successive pixels, its 8 channel groups 128 contiguous
// bytes of a weight row), and a ring of two weight slabs, one tap's 64x64
// [ci][co] (16 KB each): 188,352 / 220,992 B of 227 KB. Tap t+1's slab lands
// by cp.async while tap t is multiplied, so each weight byte crosses L2 once
// a CTA and conv. Each output's sum runs over the taps, then the input
// channels in order, in one register: launches agree bit for bit. The plan
// takes the 12x20 tile where it saves a round of tiles over the SMs that
// costs more than its larger passes ((1, 180, 320): 240 tiles in 2 rounds
// against 300 in 3), else 12x16.
constexpr int F32_LD = C + 4;               // floats a pixel row in shared memory
constexpr int F32_CG = 8;                   // channel groups
constexpr int F32_PG = NTHREADS / F32_CG;   // pixel groups
constexpr int F32_TAPF = C * C;             // floats of one tap's weights

template <int TH_, int TW_, int UNROLL_>
struct F32Tile {
  static constexpr int TH = TH_, TW = TW_;
  static constexpr int UNROLL = UNROLL_;  // of the input-channel loop (measured best)
  using G = Geom<TH, TW>;
  static constexpr int PX1 = (G::NY + F32_PG - 1) / F32_PG;  // conv1 pixels a thread
  static constexpr int PX2 = (G::NO + F32_PG - 1) / F32_PG;  // conv2 pixels a thread
  static constexpr size_t SMEM =
      (static_cast<size_t>(G::NX + G::NY) * F32_LD + 2 * F32_TAPF) * sizeof(float);
  static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
};
using F32Square = F32Tile<12, 16, 8>;  // 8 + 6 pixels a thread, 188,352 B
using F32Wide = F32Tile<12, 20, 2>;    // 10 + 8 pixels a thread, 220,992 B

// The x tile of frame b, rows r0-2 .. r0+TH+1 and columns c0-2 .. c0+TW+1,
// a pixel a row of LD floats; pixels outside the image are zero (the convs'
// zero padding).
template <class G>
__device__ __forceinline__ void load_x_tile_f32(float* xs, const float* x, int b, int r0, int c0,
                                                int H, int W) {
  constexpr int VPP = C / 4;  // 16-byte vectors a pixel
  for (int i = threadIdx.x; i < G::NX * VPP; i += NTHREADS) {
    const int p = i / VPP, v = i % VPP;
    const int gr = r0 - 2 + p / G::XW, gc = c0 - 2 + p % G::XW;
    const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W;
    const float* src = ok ? x + ((static_cast<size_t>(b) * H + gr) * W + gc) * C + v * 4 : x;
    cp_async16(xs + p * F32_LD + v * 4, src, ok);
  }
}

// One tap's 64x64 weights (16 KB, contiguous in HWIO) into a slab.
__device__ __forceinline__ void load_slab(float* dst, const float* src) {
  for (int i = threadIdx.x; i < F32_TAPF / 4; i += NTHREADS) cp_async16(dst + 4 * i, src + 4 * i, true);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// acc[j][0..7] += sum over ci of src[j][ci] * w[ci][co + {0..3, 32..35}] for
// one tap: src[j] is pixel j's row of the tap-shifted tile, ws the slab at
// the thread's first channel.
template <int PX, int UNROLL>
__device__ __forceinline__ void tap_ffma(float (&acc)[PX][8], const float* (&src)[PX],
                                         const float* ws) {
#pragma unroll UNROLL
  for (int ci = 0; ci < C; ci += 4) {
    float4 xv[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) xv[j] = ld4(src[j] + ci);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 wa = ld4(ws + (ci + k) * C), wb = ld4(ws + (ci + k) * C + 32);
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const float v = k == 0 ? xv[j].x : k == 1 ? xv[j].y : k == 2 ? xv[j].z : xv[j].w;
        acc[j][0] = fmaf(v, wa.x, acc[j][0]);
        acc[j][1] = fmaf(v, wa.y, acc[j][1]);
        acc[j][2] = fmaf(v, wa.z, acc[j][2]);
        acc[j][3] = fmaf(v, wa.w, acc[j][3]);
        acc[j][4] = fmaf(v, wb.x, acc[j][4]);
        acc[j][5] = fmaf(v, wb.y, acc[j][5]);
        acc[j][6] = fmaf(v, wb.z, acc[j][6]);
        acc[j][7] = fmaf(v, wb.w, acc[j][7]);
      }
    }
  }
}

template <class T>
__global__ void __launch_bounds__(NTHREADS, 1)
    pair_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out, int H, int W) {
  using G = typename T::G;
  constexpr int TH = T::TH, TW = T::TW, PX1 = T::PX1, PX2 = T::PX2;
  constexpr int LD = F32_LD, PG = F32_PG, TAPF = F32_TAPF;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + G::NX * LD;
  float* ws = ys + G::NY * LD;  // slab s of the 18 (conv1's taps, then conv2's) in ws + (s & 1) * TAPF
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int co = 4 * (threadIdx.x % F32_CG), pg = threadIdx.x / F32_CG;

  load_x_tile_f32<G>(xs, x, b, r0, c0, H, W);
  load_slab(ws, w1);
  cp_async_commit();

  // conv1 over the (TH+2) x (TW+2) y tile; a thread's last pixel may lie
  // past it (read at the tile's last pixel, never stored)
  float acc[PX1][8];
  const float* src[PX1];
#pragma unroll
  for (int j = 0; j < PX1; ++j) {
    const int p = min(pg + PG * j, G::NY - 1);
    src[j] = xs + ((p / G::YW) * G::XW + p % G::YW) * LD;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;
  }
  for (int tap = 0; tap < 9; ++tap) {
    cp_async_wait_all();
    __syncthreads();  // slab `tap` (and at tap 0 the x tile) in; the other slab read
    load_slab(ws + ((tap + 1) & 1) * TAPF, tap < 8 ? w1 + (tap + 1) * TAPF : w2);
    cp_async_commit();
    const float* shifted[PX1];
#pragma unroll
    for (int j = 0; j < PX1; ++j) shifted[j] = src[j] + ((tap / 3) * G::XW + tap % 3) * LD;
    tap_ffma<PX1, T::UNROLL>(acc, shifted, ws + (tap & 1) * TAPF + co);
  }
  // y = relu(conv1 + b1) inside the image, 0 outside it (conv2's padding)
  {
    const float4 ba = __ldg(reinterpret_cast<const float4*>(b1 + co));
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b1 + 32 + co));
#pragma unroll
    for (int j = 0; j < PX1; ++j) {
      const int p = pg + PG * j;
      if (p >= G::NY) continue;
      const int gr = r0 - 1 + p / G::YW, gc = c0 - 1 + p % G::YW;
      const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (inside) {
        lo = make_float4(fmaxf(acc[j][0] + ba.x, 0.f), fmaxf(acc[j][1] + ba.y, 0.f),
                         fmaxf(acc[j][2] + ba.z, 0.f), fmaxf(acc[j][3] + ba.w, 0.f));
        hi = make_float4(fmaxf(acc[j][4] + bb.x, 0.f), fmaxf(acc[j][5] + bb.y, 0.f),
                         fmaxf(acc[j][6] + bb.z, 0.f), fmaxf(acc[j][7] + bb.w, 0.f));
      }
      st4(ys + p * LD + co, lo);
      st4(ys + p * LD + 32 + co, hi);
    }
  }

  // conv2 over the TH x TW output tile; slab 9 + tap sits in ws + ((tap + 1) & 1) * TAPF
  float acc2[PX2][8];
  const float* src2[PX2];
#pragma unroll
  for (int j = 0; j < PX2; ++j) {
    const int p = min(pg + PG * j, G::NO - 1);
    src2[j] = ys + ((p / TW) * G::YW + p % TW) * LD;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc2[j][c] = 0.f;
  }
  for (int tap = 0; tap < 9; ++tap) {
    cp_async_wait_all();
    __syncthreads();  // at tap 0 also: the y tile written
    if (tap < 8) {
      load_slab(ws + (tap & 1) * TAPF, w2 + (tap + 1) * TAPF);
      cp_async_commit();
    }
    const float* shifted[PX2];
#pragma unroll
    for (int j = 0; j < PX2; ++j) shifted[j] = src2[j] + ((tap / 3) * G::YW + tap % 3) * LD;
    tap_ffma<PX2, T::UNROLL>(acc2, shifted, ws + ((tap + 1) & 1) * TAPF + co);
  }
  // out = x + (conv2 + b2), the residual from the x tile
  const float4 ca = __ldg(reinterpret_cast<const float4*>(b2 + co));
  const float4 cb = __ldg(reinterpret_cast<const float4*>(b2 + 32 + co));
#pragma unroll
  for (int j = 0; j < PX2; ++j) {
    const int p = pg + PG * j;
    if (p >= G::NO) continue;
    const int qr = p / TW, qc = p % TW, gr = r0 + qr, gc = c0 + qc;
    if (gr >= H || gc >= W) continue;
    const float* res = xs + ((qr + 2) * G::XW + qc + 2) * LD + co;
    const float4 ra = ld4(res), rb = ld4(res + 32);
    float* o = out + ((static_cast<size_t>(b) * H + gr) * W + gc) * C + co;
    st4(o, make_float4(ra.x + (acc2[j][0] + ca.x), ra.y + (acc2[j][1] + ca.y),
                       ra.z + (acc2[j][2] + ca.z), ra.w + (acc2[j][3] + ca.w)));
    st4(o + 32, make_float4(rb.x + (acc2[j][4] + cb.x), rb.y + (acc2[j][5] + cb.y),
                            rb.z + (acc2[j][6] + cb.z), rb.w + (acc2[j][7] + cb.w)));
  }
}

// Set the device and the kernel's shared-memory limit (both per device, so
// made on every call; host-side, no synchronisation).
template <class K>
cudaError_t prepare(K kernel, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  return err;
}

// SMs of a device, read once.
int sm_count(int device) {
  constexpr int MAXDEV = 64;
  static int cached[MAXDEV] = {};
  if (device < 0 || device >= MAXDEV) return 0;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) n = 0;
    cached[device] = n;
  }
  return cached[device];
}

// How a launch is cut up: the output tile, the tiles of a frame and of the
// launch, and the CTAs that run at once. The bf16 kernels run a persistent
// grid of that many CTAs, one an SM at most, CTA i walking over the tiles
// i, i + grid, ...; the fp32 kernel launches one CTA a tile, of which one an
// SM runs at a time. grid 0: a launch that is refused.
struct Plan {
  int th, tw, tiles_x, tiles_y, ntiles, grid;
};

template <int TH, int TW>
Plan plan_tiles(int B, int H, int W, int device) {
  Plan p = {TH, TW, (W + TW - 1) / TW, (H + TH - 1) / TH, 0, 0};
  const int sms = sm_count(device);
  const long long ntiles = static_cast<long long>(B) * p.tiles_x * p.tiles_y;
  if (sms <= 0 || B <= 0 || H <= 0 || W <= 0 || ntiles > 0x7fffffffLL - sms) return p;
  p.ntiles = static_cast<int>(ntiles);
  p.grid = p.ntiles < sms ? p.ntiles : sms;
  return p;
}

// taps: wide tiles where they give every CTA one tile at most, else deep ones
Plan plan_taps(int B, int H, int W, int device) {
  const Plan wide = plan_tiles<TapsWide::TH, TapsWide::TW>(B, H, W, device);
  if (wide.grid > 0 && wide.ntiles == wide.grid) return wide;
  return plan_tiles<TapsDeep::TH, TapsDeep::TW>(B, H, W, device);
}

Plan plan_im2col(int B, int H, int W, int device) {
  return plan_tiles<I2C_TH, I2C_TW>(B, H, W, device);
}

// fp32: of the two tiles, the one whose rounds (tiles over the SMs) take the
// fewest thread-pixel passes, the square one on a tie; the grid is
// (tiles_x, tiles_y, B)
template <class T>
long long fp32_cost(const Plan& p) {
  return p.grid > 0 ? (p.ntiles + p.grid - 1) / p.grid * static_cast<long long>(T::PX1 + T::PX2)
                    : -1;
}

Plan plan_fp32(int B, int H, int W, int device) {
  const Plan sq = plan_tiles<F32Square::TH, F32Square::TW>(B, H, W, device);
  const Plan wide = plan_tiles<F32Wide::TH, F32Wide::TW>(B, H, W, device);
  Plan p = fp32_cost<F32Wide>(wide) >= 0 && fp32_cost<F32Wide>(wide) < fp32_cost<F32Square>(sq)
               ? wide : sq;
  if (B > 65535 || p.tiles_y > 65535) p.grid = 0;
  return p;
}

// The im2col kernel on its persistent grid.
template <class K>
int launch_persistent(K kernel, size_t smem, const Plan& p, const void* x, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, int H, int W,
                      int device, void* stream) {
  if (p.grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(kernel, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), H, W,
      p.tiles_x, p.tiles_y, p.ntiles);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, through the runtime: libcuda is not linked.
typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);
TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// The fp32 kernel: one CTA a tile.
template <class T>
int launch_fp32(const Plan& p, const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, int B, int H, int W, int device, void* stream) {
  auto kernel = pair_fp32_kernel<T>;
  cudaError_t err = prepare(kernel, T::SMEM, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.tiles_x, p.tiles_y, B), NTHREADS, T::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), H,
      W);
  return static_cast<int>(cudaGetLastError());
}

// The taps kernel: a tensor map over x as (B, H, W, C) whose box is one x
// tile, then the persistent grid.
template <class G>
int launch_taps(const Plan& p, const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, int B, int H, int W, int device, void* stream) {
  if (p.grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pair_taps_kernel<G>;
  cudaError_t err = prepare(kernel, G::SMEM, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidDevice);
  if (G::XBUF < 3 && p.ntiles > p.grid) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {C, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {PIXB, static_cast<cuuint64_t>(W) * PIXB,
                                 static_cast<cuuint64_t>(H) * W * PIXB};
  // x: one box is an x tile; out: one box is a tile row
  const cuuint32_t xbox[4] = {C, G::P, G::TH + 4, 1}, obox[4] = {C, G::TW, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap omap;
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
             xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, dims, strides, obox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<p.grid, NTHREADS, G::SMEM, static_cast<cudaStream_t>(stream)>>>(
      xmap, omap, static_cast<const uint4*>(w1), static_cast<const float*>(b1),
      static_cast<const uint4*>(w2), static_cast<const float*>(b2), H, W, p.tiles_x, p.tiles_y,
      p.ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int vsr_residual_pair_taps_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int B, int H, int W, int device,
                                void* stream) {
  const Plan p = plan_taps(B, H, W, device);
  if (p.th == TapsWide::TH)
    return launch_taps<TapsWide>(p, x, w1, b1, w2, b2, out, B, H, W, device, stream);
  return launch_taps<TapsDeep>(p, x, w1, b1, w2, b2, out, B, H, W, device, stream);
}

int vsr_residual_pair_im2col_bf16(const void* x, const void* w1, const void* b1,
                                  const void* w2, const void* b2, void* out, int B, int H,
                                  int W, int device, void* stream) {
  using G = Geom<I2C_TH, I2C_TW>;
  // as above, the y tile rounded up to 1,024 B, the patch ring and its barriers
  constexpr size_t smem = 2 * WBYTES + static_cast<size_t>(G::NX) * PIXB +
                          (static_cast<size_t>(G::NY) * PIXB + 1023) / 1024 * 1024 +
                          NSLAB * SLAB + 8 * (2 * NSLAB + 1) + 8 + 1024;
  return launch_persistent(pair_im2col_kernel<I2C_TH, I2C_TW>, smem, plan_im2col(B, H, W, device),
                           x, w1, b1, w2, b2, out, H, W, device, stream);
}

// What a launch of (B, H, W, 64) on `device` by `kernel` (0 bf16 taps, 1
// bf16 im2col, 2 fp32) would be given, by the entries' own rule: plan[0..3]
// = tile rows, tile columns, tiles, CTAs at once. Launches nothing.
int vsr_residual_pair_plan(int kernel, int B, int H, int W, int device, int* plan) {
  const Plan p = kernel == 2 ? plan_fp32(B, H, W, device)
                 : kernel    ? plan_im2col(B, H, W, device)
                             : plan_taps(B, H, W, device);
  if (p.grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.th, plan[1] = p.tw, plan[2] = p.ntiles, plan[3] = p.grid;
  return 0;
}

int vsr_residual_pair_fp32(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* b2, void* out, int B, int H, int W, int device,
                           void* stream) {
  const Plan p = plan_fp32(B, H, W, device);
  if (p.grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.tw == F32Wide::TW) return launch_fp32<F32Wide>(p, x, w1, b1, w2, b2, out, B, H, W, device, stream);
  return launch_fp32<F32Square>(p, x, w1, b1, w2, b2, out, B, H, W, device, stream);
}

const char* vsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
