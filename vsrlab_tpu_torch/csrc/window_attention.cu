// Fused window attention for Hopper (sm_90a).
//
// For every (window b, head h):
//   out[b, :, h*hd:(h+1)*hd] = softmax(scale * q k^T + bias[h] + masks[tid[b]]) v
// with q (B, H, nq, hd), k and v (B, H, nk, hd), bias (H, nq, nk) fp32 or
// absent, masks (T, nq, nk) fp32 picked per window by tid (B,) int64, or
// absent. q, k and v are read through their strides (the qkv projection's
// output viewed as heads: no transpose copies); each head's output rows are
// written into its channel slice of out (B, nq, H*hd), which may be a slice
// of a wider buffer (VRT's [mutual, self] concat before the projection).
//
// Replaces no TPU kernel: the JAX package leaves window attention to XLA
// (einsum, add, softmax, einsum). It was added because VRT's window
// attention took 63% of the port's device time on the H100 in plain
// PyTorch, which materialises the fp32 logits in device memory: ~321 GB of
// them a (1,16,256,256,3) request, read and written ~8 times by seven
// launches, for ~8 TFLOP of products.
//
// What bounds it on an H100: with hd 20-30 the products are small (QK^T and
// PV at k16 / n8 granularity); device memory sees q, k, v once and the
// output once (~77 GB a request, 23 ms), but bias and masks are fp32, one
// value each a logit (~0.4 TB a request, from L2, where their few MB stay):
// on the card half of the kernel's time goes to those reads. The design:
//   * one block of 4 warps per (window, head); K and V of that pair sit in
//     shared memory for the whole block (K rows padded to 16*KS + 8 halves,
//     V transposed, rows padded by 8 halves: both conflict-free for the
//     fragment loads), loaded once; keys past nk and features past hd are
//     zero;
//   * each warp takes 16 query rows at a time; QK^T runs on the tensor cores
//     (mma.sync m16n8k16, bf16 operands, fp32 accumulation), 64 keys a step;
//     bias and the window's mask are added in registers; the softmax is
//     online (running max and sum a row) in fp32; P is rounded to bf16 and
//     P.V runs on the tensor cores from registers (the logits' accumulator
//     layout is the A fragment's); the rows are divided by their sums at the
//     end and written once;
//   * fp32 operands go through the same template with fp32 FFMA products
//     (no TF32, no bf16), P kept in fp32 and passed between lanes by
//     shuffles.
// Rounding points (bf16): q * scale is rounded to bf16, as PyTorch's
// `q * scale` is; the q.k products of bf16 operands are exact in fp32 and
// summed in fp32; bias, mask, max, exp and sum are fp32; P = exp(s - m) is
// rounded to bf16 before P.V; P.V is summed in fp32, divided by the fp32 row
// sum and rounded to bf16 once. (The plain version rounds the normalised P
// instead: the same bf16 rounding of each probability, at another scale.)
// exp: bf16 takes exp2f(x * log2(e)), x = s - m <= 0: exp2f is within 2 ulp
// (2^-22 relatively) and the rounding of log2(e) and of the product moves
// the result by at most |x| * 2^-23 relatively, so each probability lies
// within 2^-22 + |x| * 2^-23 of exp(x) (under 2^-16 wherever exp(x) is an
// fp32 normal, x > -87), far inside the 2^-9 of its bf16 rounding; fp32
// takes expf (2 ulp).
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given device and stream, does not synchronise, allocates nothing and
// returns cudaGetLastError() (0 on success); cudaErrorInvalidValue for a
// shape it does not take (hd over 64, K and V of one (window, head) over the
// shared memory). A window whose type id lies outside [0, T) names no mask:
// its rows are written as NaN, so that the fault shows in the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int NTHREADS = 32 * WARPS;
constexpr int KT = 64;                 // keys a step of the online softmax
constexpr int NT = KT / 8;             // n8 tiles of logits a step
constexpr int MAX_SMEM = 232448;       // dynamic shared memory a block may have (227 KB)
constexpr int MAX_HD = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const float* bias;
  const float* masks;
  const int64_t* tid;
  // strides in elements: window, head, token (the feature stride is 1)
  int64_t q_b, q_h, q_n, k_b, k_h, k_n, v_b, v_h, v_n, o_b, o_h, o_n;
  int64_t bias_h, bias_r;  // bias: head, row (column stride 1)
  int64_t mask_t, mask_r;  // masks: type, row (column stride 1)
  int H, nq, nk, hd, types, nkp;
  float scale;
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// Two floats rounded to bf16 in one 32-bit register, `lo` in the low half
// (the lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// d += a * b: one m16n8k16 tile, bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// exp(x) for the softmax, x <= 0 (the error bound: the header)
template <bool kBf16>
__device__ __forceinline__ float softmax_exp(float x) {
  return kBf16 ? exp2f(x * LOG2E) : expf(x);
}

// Columns c and c + 1 of an fp32 row of n values, 0 past its end; one
// 8-byte load where both lie inside and the address allows it.
__device__ __forceinline__ float2 load_pair(const float* __restrict__ row, int c, int n) {
  const float* a = row + c;
  if (c + 1 < n && (reinterpret_cast<uintptr_t>(a) & 7) == 0)
    return __ldg(reinterpret_cast<const float2*>(a));
  float2 r;
  r.x = c < n ? __ldg(a) : 0.f;
  r.y = c + 1 < n ? __ldg(a + 1) : 0.f;
  return r;
}

// Shared memory layout of K and V for one (window, head).
//   bf16: K [nkp][16*KS + 8], V transposed [8*NV][nkp + 8];
//   fp32: K [nkp][hd | 1],    V [nkp][8*NV].
template <typename T, int KS, int NV>
struct Smem {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int KROW = 16 * KS + 8;
  __host__ __device__ static int krow(int hd) { return kBf16 ? KROW : (hd | 1); }
  __host__ __device__ static int vrow(int nkp) { return kBf16 ? nkp + 8 : 8 * NV; }
  __host__ __device__ static int64_t k_elems(int nkp, int hd) {
    return static_cast<int64_t>(nkp) * krow(hd);
  }
  __host__ __device__ static int64_t bytes(int nkp, int hd) {
    const int64_t v = kBf16 ? static_cast<int64_t>(8 * NV) * vrow(nkp)
                            : static_cast<int64_t>(nkp) * vrow(nkp);
    return (k_elems(nkp, hd) + v) * static_cast<int64_t>(sizeof(T));
  }
};

// K and V of one (window, head) into shared memory; zero past nk and hd.
template <typename T, int KS, int NV>
__device__ void load_kv(T* ks, T* vs, const T* __restrict__ k, const T* __restrict__ v,
                        const Params& p) {
  using L = Smem<T, KS, NV>;
  const T zero = from_f<T>(0.f);
  const int kw = L::kBf16 ? 16 * KS : L::krow(p.hd);
  const int krow = L::krow(p.hd), vrow = L::vrow(p.nkp);
  for (int e = threadIdx.x; e < p.nkp * kw; e += NTHREADS) {
    const int r = e / kw, c = e - r * kw;
    ks[r * krow + c] = (r < p.nk && c < p.hd) ? k[r * p.k_n + c] : zero;
  }
  constexpr int VW = 8 * NV;
  for (int e = threadIdx.x; e < p.nkp * VW; e += NTHREADS) {
    const int r = e / VW, c = e - r * VW;
    const T val = (r < p.nk && c < p.hd) ? v[r * p.v_n + c] : zero;
    if (L::kBf16)
      vs[c * vrow + r] = val;
    else
      vs[r * vrow + c] = val;
  }
}

// Logits of 16 query rows (r0 + g, r0 + g + 8) against keys [k0, k0 + 64):
// s[n][0..1] row g, keys k0 + 8n + 2t + {0, 1}; s[n][2..3] row g + 8.
// bf16: from the q fragments and K in shared memory on the tensor cores.
template <int KS>
__device__ __forceinline__ void logits_bf16(float (&s)[NT][4], const uint32_t (&qa)[KS][4],
                                            const bf16* ks, int k0, int g, int t) {
  constexpr int KROW = 16 * KS + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const uint32_t* kr =
        reinterpret_cast<const uint32_t*>(ks + (k0 + 8 * n + g) * KROW + 2 * t);
#pragma unroll
    for (int j = 0; j < KS; ++j) mma_bf16(s[n], qa[j], kr[8 * j], kr[8 * j + 4]);
  }
}

// fp32: FFMA over the features, q * scale from device memory (L1), K from
// shared memory.
__device__ __forceinline__ void logits_fp32(float (&s)[NT][4], const float* __restrict__ qa_row,
                                            const float* __restrict__ qb_row, float scale,
                                            const float* ks, int krow, int hd, int k0, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float xa = qa_row ? __ldg(qa_row + d) * scale : 0.f;
    const float xb = qb_row ? __ldg(qb_row + d) * scale : 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* kr = ks + (k0 + 8 * n + 2 * t) * krow + d;
      const float k0v = kr[0], k1v = kr[krow];
      s[n][0] = fmaf(xa, k0v, s[n][0]);
      s[n][1] = fmaf(xa, k1v, s[n][1]);
      s[n][2] = fmaf(xb, k0v, s[n][2]);
      s[n][3] = fmaf(xb, k1v, s[n][3]);
    }
  }
}

template <typename T, int KS, int NV>
__global__ void __launch_bounds__(NTHREADS) window_attention_kernel(const Params p) {
  using L = Smem<T, KS, NV>;
  constexpr bool kBf16 = L::kBf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + L::k_elems(p.nkp, p.hd);

  const int h = blockIdx.x % p.H;
  const int64_t b = blockIdx.x / p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + h * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + h * p.v_h;
  T* out = static_cast<T*>(p.out) + b * p.o_b + h * p.o_h;
  const float* bias = p.bias ? p.bias + h * p.bias_h : nullptr;
  const float* mask = nullptr;
  if (p.masks) {
    const int64_t ty = p.tid[b];
    if (ty < 0 || ty >= p.types) {  // no such mask: NaN rows (the same for the whole block)
      for (int e = threadIdx.x; e < p.nq * p.hd; e += NTHREADS)
        out[(e / p.hd) * p.o_n + e % p.hd] = from_f<T>(NAN);
      return;
    }
    mask = p.masks + ty * p.mask_t;
  }

  load_kv<T, KS, NV>(ks, vs, k, v, p);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int krow = L::krow(p.hd), vrow = L::vrow(p.nkp);

  for (int r0 = warp * 16; r0 < p.nq; r0 += WARPS * 16) {
    const int ra = r0 + g, rb = r0 + g + 8;
    const bool va = ra < p.nq, vb = rb < p.nq;

    // q fragments (bf16): q * scale rounded to bf16, zero past nq and hd
    uint32_t qa[KS][4];
    if constexpr (kBf16) {
      auto qv = [&](bool valid, int r, int c) {
        return (valid && c < p.hd) ? to_f(from_f<bf16>(to_f(q[r * p.q_n + c]) * p.scale)) : 0.f;
      };
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int c = 16 * j + 2 * t;
        qa[j][0] = pack_bf16(qv(va, ra, c), qv(va, ra, c + 1));
        qa[j][1] = pack_bf16(qv(vb, rb, c), qv(vb, rb, c + 1));
        qa[j][2] = pack_bf16(qv(va, ra, c + 8), qv(va, ra, c + 9));
        qa[j][3] = pack_bf16(qv(vb, rb, c + 8), qv(vb, rb, c + 9));
      }
    }
    const float* bias_a = (bias && va) ? bias + ra * p.bias_r : nullptr;
    const float* bias_b = (bias && vb) ? bias + rb * p.bias_r : nullptr;
    const float* mask_a = (mask && va) ? mask + ra * p.mask_r : nullptr;
    const float* mask_b = (mask && vb) ? mask + rb * p.mask_r : nullptr;

    float acc[NV][4];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int k0 = 0; k0 < p.nk; k0 += KT) {
      float s[NT][4];
      if constexpr (kBf16) {
        logits_bf16<KS>(s, qa, reinterpret_cast<const bf16*>(ks), k0, g, t);
      } else {
        logits_fp32(s, va ? reinterpret_cast<const float*>(q) + ra * p.q_n : nullptr,
                    vb ? reinterpret_cast<const float*>(q) + rb * p.q_n : nullptr, p.scale,
                    reinterpret_cast<const float*>(ks), krow, p.hd, k0, t);
      }

      // (s + bias) + mask in fp32, in the plain version's order; keys past
      // nk out of the softmax
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = k0 + 8 * n + 2 * t;
        const float2 ba = bias_a ? load_pair(bias_a, c, p.nk) : make_float2(0.f, 0.f);
        const float2 bb = bias_b ? load_pair(bias_b, c, p.nk) : make_float2(0.f, 0.f);
        const float2 ma = mask_a ? load_pair(mask_a, c, p.nk) : make_float2(0.f, 0.f);
        const float2 mb = mask_b ? load_pair(mask_b, c, p.nk) : make_float2(0.f, 0.f);
        s[n][0] = (s[n][0] + ba.x) + ma.x;
        s[n][1] = (s[n][1] + ba.y) + ma.y;
        s[n][2] = (s[n][2] + bb.x) + mb.x;
        s[n][3] = (s[n][3] + bb.y) + mb.y;
        if (c >= p.nk) s[n][0] = s[n][2] = -INFINITY;
        if (c + 1 >= p.nk) s[n][1] = s[n][3] = -INFINITY;
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      // online softmax: the row's running max over the four lanes of its row
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);  // finite: key k0 < nk lies in this step
        corr[i] = softmax_exp<kBf16>(m[i] - mn);
        m[i] = mn;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e] - m[e >> 1];
          s[n][e] = softmax_exp<kBf16>(x);
          l[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        acc[i][0] *= corr[0];
        acc[i][1] *= corr[0];
        acc[i][2] *= corr[1];
        acc[i][3] *= corr[1];
      }

      if constexpr (kBf16) {
        // P (rounded to bf16) . V on the tensor cores: keys 16j .. 16j + 15
        const bf16* vt = reinterpret_cast<const bf16*>(vs);
#pragma unroll
        for (int j = 0; j < KT / 16; ++j) {
          const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                  pack_bf16(s[2 * j][2], s[2 * j][3]),
                                  pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                  pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const uint32_t* vr = reinterpret_cast<const uint32_t*>(
                vt + (8 * i + g) * vrow + k0 + 16 * j + 2 * t);
            mma_bf16(acc[i], pa, vr[0], vr[4]);
          }
        }
      } else {
        // P (fp32) . V by FFMA: each key's probabilities from the lane that
        // holds them
        const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pa = __shfl_sync(FULL, s[n][e], g * 4 + tt);
              const float pb = __shfl_sync(FULL, s[n][2 + e], g * 4 + tt);
              const float* vr = vf + (k0 + 8 * n + 2 * tt + e) * vrow + 2 * t;
#pragma unroll
              for (int i = 0; i < NV; ++i) {
                if (8 * i < p.hd) {
                  const float v0 = vr[8 * i], v1 = vr[8 * i + 1];
                  acc[i][0] = fmaf(pa, v0, acc[i][0]);
                  acc[i][1] = fmaf(pa, v1, acc[i][1]);
                  acc[i][2] = fmaf(pb, v0, acc[i][2]);
                  acc[i][3] = fmaf(pb, v1, acc[i][3]);
                }
              }
            }
          }
        }
      }
    }

    // the row sums over the four lanes of each row, then the rows, once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(FULL, l[i], 1);
      l[i] += __shfl_xor_sync(FULL, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = 8 * i + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? ra : rb, cc = c + (e & 1);
        if (r < p.nq && cc < p.hd) out[r * p.o_n + cc] = from_f<T>(acc[i][e] / l[e >> 1]);
      }
    }
  }
}

template <typename T, int KS, int NV>
int launch(const Params& p, int64_t blocks, cudaStream_t stream) {
  const int64_t smem = Smem<T, KS, NV>::bytes(p.nkp, p.hd);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window_attention_kernel<T, KS, NV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), NTHREADS, static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// shape: B, H, nq, nk, hd, types (0 without masks);
// strides (elements): q (b, h, n), k (b, h, n), v (b, h, n), out (b, h, n),
// bias (h, row), masks (type, row); every feature / column stride is 1.
// itemsize 2 (bf16) or 4 (fp32) for q, k, v and out; bias and masks fp32;
// tid int64. bias, masks and tid may be null (masks and tid together).
int vsr_window_attention(const void* q, const void* k, const void* v, void* out,
                         const void* bias, const void* masks, const void* tid,
                         const int64_t* shape, const int64_t* strides, float scale,
                         int itemsize, int device, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.bias = static_cast<const float*>(bias);
  p.masks = static_cast<const float*>(masks);
  p.tid = static_cast<const int64_t*>(tid);
  const int64_t B = shape[0];
  if (B <= 0 || shape[1] <= 0 || shape[2] <= 0 || shape[3] <= 0 || shape[4] <= 0 ||
      shape[4] > MAX_HD || shape[2] >= (1LL << 30) || shape[3] >= (1LL << 30) ||
      (itemsize != 2 && itemsize != 4) || ((masks == nullptr) != (tid == nullptr)) ||
      (masks != nullptr && shape[5] <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  p.H = static_cast<int>(shape[1]);
  p.nq = static_cast<int>(shape[2]);
  p.nk = static_cast<int>(shape[3]);
  p.hd = static_cast<int>(shape[4]);
  p.types = static_cast<int>(shape[5]);
  p.nkp = (p.nk + KT - 1) / KT * KT;
  p.q_b = strides[0], p.q_h = strides[1], p.q_n = strides[2];
  p.k_b = strides[3], p.k_h = strides[4], p.k_n = strides[5];
  p.v_b = strides[6], p.v_h = strides[7], p.v_n = strides[8];
  p.o_b = strides[9], p.o_h = strides[10], p.o_n = strides[11];
  p.bias_h = strides[12], p.bias_r = strides[13];
  p.mask_t = strides[14], p.mask_r = strides[15];
  p.scale = scale;
  const int64_t blocks = B * p.H;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) return launch<float, 4, 8>(p, blocks, s);
  switch ((p.hd + 7) / 8) {  // n8 tiles of the features; k16 steps = half of them, rounded up
    case 1: return launch<bf16, 1, 1>(p, blocks, s);
    case 2: return launch<bf16, 1, 2>(p, blocks, s);
    case 3: return launch<bf16, 2, 3>(p, blocks, s);
    case 4: return launch<bf16, 2, 4>(p, blocks, s);
    case 5: return launch<bf16, 3, 5>(p, blocks, s);
    case 6: return launch<bf16, 3, 6>(p, blocks, s);
    case 7: return launch<bf16, 4, 7>(p, blocks, s);
    default: return launch<bf16, 4, 8>(p, blocks, s);
  }
}

const char* vsr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
