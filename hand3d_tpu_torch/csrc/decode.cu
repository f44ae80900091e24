// Keypoint decode: argmax over the bilinearly upsampled scoremap, for Hopper
// (sm_90a).
//
// Replaces hand3d_tpu/ops/pallas/decode.py::_kernel (with _shift_clamp).
// Per image and keypoint it finds the argmax of the `factor`-times TF1
// legacy bilinear upsampling (src = dst * in/out, edge clamp) of a [h, w]
// scoremap channel, without writing the upsampled map to device memory. Ties
// go to the smallest row-major index of the upsampled map, NaN counts as the
// largest value and -0.0 ties +0.0, as in torch.argmax.
//
// Bound on an H100 (67 TFLOP/s f32, 3.35 TB/s): the TPU kernel's own count,
// f * f * 6 flops per source value (decode.py:105), is 8.26 MFLOP per
// [32, 32, 21] image at f = 8 against 86 KB read, so it is bound by
// operations: 0.12 us an image.
//
// What held the first design back: one block per (channel, image) gathered
// its 32x32 channel from the NHWC tensor at a stride of K floats (one 32-byte
// sector per 4-byte value, each image read by K blocks); every upsampled
// pixel paid an integer division, six table loads and both row lerps again;
// at batch 1 only K = 21 blocks ran on 132 SMs.
//
// Design, for power-of-two factors (the cascade's 8), the overlay form of
// the TPU kernel (decode.py:9-15):
//  * with f = 2^k the float64 grid is exact: destination row f*i + a has
//    lo = i, hi = min(i + 1, h - 1) and weight a/f, and columns alike. So a
//    thread computes the row lerp top*(1-wr) + bot*wr once per (a, source
//    cell) at its column j and at j + 1 (clamped), and reuses the pair for the
//    f column offsets: v = r_j*(1-wc) + r_j1*wc, flat index
//    (f*i + a)*ow + f*j + b, no division. Clamped edges still compute
//    m*(1-w) + m*w literally, as the twin does;
//  * the output rows are cut into bands, enough for about one block per SM
//    at batch 1; a block reads its band's source rows (plus the next one) as
//    one contiguous NHWC range with 16-byte loads and transposes it into
//    per-channel planes in shared memory, so no stride-K gathers;
//  * one warp per channel, one lane per source column; each thread keeps its
//    running best in registers (its indices only grow, so a strict compare
//    keeps the first of equal values). Warps reduce a 64-bit key, the value
//    as an order-preserving uint32 (NaN largest, -0.0 as +0.0) above ~index,
//    and the bands meet in a 64-bit atomicMax in an int64 scratch that a
//    memset on the stream zeroes before the launch; the last block of an
//    image (a ticket counter in the same scratch) turns its keys into
//    (row, col);
//  * nvcc contracts a*b+c into an FMA by default, which changes rounding and
//    can move near-tie argmaxes. Every float op of a value is an explicit
//    round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which
//    nvcc never contracts.
// Other factors keep the table path of the first design: each upsampled
// row/col gets its (lo, hi, weight) from the same float64 grid as the numpy
// tables of ops/image.py. There 1/f is inexact in float64 and the grid can
// leave the overlay form: at f = 49 destination row or column 49 takes
// lo = 0, hi = 1 at weight 1.0 where the overlay takes 1 and 1, so an inf
// in source row or column 0 makes the twin's value 0 * inf = NaN and the
// overlay's finite (tests/test_torch_kernel_designs.py).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTableThreads = 256;
constexpr int kMaxSmem = 232448;  // per block on Hopper
constexpr int kDefaultSmem = 48 * 1024;

// ---------------------------------------------------------------- table path

// true if (v, p) beats (bv, bp): NaN above all, then larger value, then
// smaller index
__device__ __forceinline__ bool better(float v, int p, float bv, int bp) {
  const bool vn = isnan(v);
  const bool bn = isnan(bv);
  if (vn || bn) return vn && (!bn || p < bp);
  return v > bv || (v == bv && p < bp);
}

__device__ __forceinline__ void reduce_warp(float& v, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int op = __shfl_down_sync(0xffffffffu, p, off);
    if (better(ov, op, v, p)) {
      v = ov;
      p = op;
    }
  }
}

// (lo, hi, weight) of output index i on one axis, as ops/image.py's
// _legacy_lin_coeffs computes them in numpy
__device__ __forceinline__ void lin_coeff(int i, int in_size, double scale,
                                          int* lo, int* hi, float* wt) {
  const double src = __dmul_rn(static_cast<double>(i), scale);
  int l = static_cast<int>(floor(src));
  l = min(max(l, 0), in_size - 1);
  *lo = l;
  *hi = min(l + 1, in_size - 1);
  *wt = static_cast<float>(__dsub_rn(src, static_cast<double>(l)));
}

// grid (K, B), one block per channel of one image
__global__ void __launch_bounds__(kTableThreads)
decode_table_kernel(const float* __restrict__ sm, float* __restrict__ out,
                    int h, int w, int K, int factor) {
  extern __shared__ float smem[];
  const int oh = h * factor;
  const int ow = w * factor;
  float* m = smem;                                      // [h * w]
  int* row_lo = reinterpret_cast<int*>(m + h * w);      // [oh]
  int* row_hi = row_lo + oh;                            // [oh]
  float* row_w = reinterpret_cast<float*>(row_hi + oh); // [oh]
  int* col_lo = reinterpret_cast<int*>(row_w + oh);     // [ow]
  int* col_hi = col_lo + ow;                            // [ow]
  float* col_w = reinterpret_cast<float*>(col_hi + ow); // [ow]

  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const float* src = sm + static_cast<size_t>(b) * h * w * K + k;
  for (int i = threadIdx.x; i < h * w; i += blockDim.x)
    m[i] = src[static_cast<size_t>(i) * K];
  const double row_scale = __ddiv_rn(static_cast<double>(h),
                                     static_cast<double>(oh));
  const double col_scale = __ddiv_rn(static_cast<double>(w),
                                     static_cast<double>(ow));
  for (int i = threadIdx.x; i < oh; i += blockDim.x)
    lin_coeff(i, h, row_scale, &row_lo[i], &row_hi[i], &row_w[i]);
  for (int j = threadIdx.x; j < ow; j += blockDim.x)
    lin_coeff(j, w, col_scale, &col_lo[j], &col_hi[j], &col_w[j]);
  __syncthreads();

  float best_v = -INFINITY;
  int best_p = INT_MAX;
  const int total = oh * ow;
  for (int p = threadIdx.x; p < total; p += blockDim.x) {
    const int r = p / ow;
    const int c = p - r * ow;
    const float wr = row_w[r];
    const float cr = __fsub_rn(1.0f, wr);
    const float* top = m + row_lo[r] * w;
    const float* bot = m + row_hi[r] * w;
    const int cl = col_lo[c];
    const int ch = col_hi[c];
    // row pass at source columns cl and ch, then the column pass
    const float a = __fadd_rn(__fmul_rn(top[cl], cr), __fmul_rn(bot[cl], wr));
    const float e = __fadd_rn(__fmul_rn(top[ch], cr), __fmul_rn(bot[ch], wr));
    const float wc = col_w[c];
    const float v = __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, wc)),
                              __fmul_rn(e, wc));
    if (better(v, p, best_v, best_p)) {
      best_v = v;
      best_p = p;
    }
  }

  __shared__ float warp_v[kTableThreads / 32];
  __shared__ int warp_p[kTableThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  reduce_warp(best_v, best_p);
  if (lane == 0) {
    warp_v[warp] = best_v;
    warp_p[warp] = best_p;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    best_v = lane < nwarps ? warp_v[lane] : -INFINITY;
    best_p = lane < nwarps ? warp_p[lane] : INT_MAX;
    reduce_warp(best_v, best_p);
    if (lane == 0) {
      float* o = out + (static_cast<size_t>(b) * K + k) * 2;
      o[0] = static_cast<float>(best_p / ow);
      o[1] = static_cast<float>(best_p % ow);
    }
  }
}

// -------------------------------------------------------------- overlay path

// The argmax order as one unsigned 64-bit key: larger key wins. High word:
// the value as an order-preserving uint32, every NaN the largest and -0.0 as
// +0.0; low word: ~index, so the smaller index wins a tie.
__device__ __forceinline__ unsigned long long order_key(float v, int p) {
  uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));  // -0.0 + 0.0 = +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  if (isnan(v)) u = 0xffffffffu;
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<uint32_t>(~p);
}

struct Band {
  int r0, r1;    // output rows [r0, r1)
  int s0, rows;  // source rows [s0, s0 + rows) held in shared memory
};

__device__ __forceinline__ Band band_of(int band, int nb, int oh, int h,
                                        int lg) {
  Band bd;
  bd.r0 = static_cast<int>(static_cast<long long>(band) * oh / nb);
  bd.r1 = static_cast<int>(static_cast<long long>(band + 1) * oh / nb);
  bd.s0 = bd.r0 >> lg;
  bd.rows = min(((bd.r1 - 1) >> lg) + 1, h - 1) - bd.s0 + 1;
  return bd;
}

// floats of one channel's plane: odd, so that the transposing stores of
// neighbouring channels fall in different banks
__host__ __device__ inline int plane_stride(int rows, int w) {
  return (rows * w) | 1;
}

// One block per (band of output rows, image); warps own channels, lanes own
// source columns. F > 0 is the factor known at compile time, F = 0 a power
// of two given at run time. keys: [B * K] zeroed, then [B] ticket counters,
// zeroed.
template <int F>
__global__ void __launch_bounds__(1024)
decode_overlay_kernel(const float* __restrict__ sm, float* __restrict__ out,
                      unsigned long long* __restrict__ keys, int h, int w,
                      int K, int factor_rt, int lg, int nb) {
  extern __shared__ float planes[];  // [K][plane_stride]
  constexpr int kUnroll = F > 0 ? F : 8;
  const int f = F > 0 ? F : factor_rt;
  const int oh = h * f;
  const int ow = w * f;
  const int b = blockIdx.y;
  const Band bd = band_of(blockIdx.x, nb, oh, h, lg);
  const int stride = plane_stride(bd.rows, w);
  const int T = blockDim.x;
  const int t = threadIdx.x;

  // contiguous NHWC range of the band's source rows -> per-channel planes.
  // Element e of the range is (pixel e / K, channel e % K); each thread
  // steps its (pixel, channel) pair without dividing in the loop.
  {
    const float* src = sm + (static_cast<size_t>(b) * h + bd.s0) * w * K;
    const int n = bd.rows * w * K;
    const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    const int per = vec ? 4 : 1;  // elements a thread takes at a time
    const int step = T * per;
    int pix = (t * per) / K;
    int ch = t * per - pix * K;
    const int dpix = step / K;
    const int dch = step - dpix * K;
    const int n_vec = vec ? n / 4 * 4 : 0;
    for (int e = t * per; e < n_vec; e += step) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + e));
      const float vals[4] = {v.x, v.y, v.z, v.w};
      int p = pix, c = ch;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        planes[c * stride + p] = vals[q];
        if (++c == K) {
          c = 0;
          ++p;
        }
      }
      pix += dpix;
      ch += dch;
      if (ch >= K) {
        ch -= K;
        ++pix;
      }
    }
    if (vec) {  // the last n % 4 elements
      const int e = n_vec + t;
      if (e < n) planes[(e % K) * stride + e / K] = __ldg(src + e);
    } else {
      for (int e = t; e < n; e += step) {
        planes[ch * stride + pix] = __ldg(src + e);
        pix += dpix;
        ch += dch;
        if (ch >= K) {
          ch -= K;
          ++pix;
        }
      }
    }
  }
  __syncthreads();

  const int lane = t & 31;
  const int nwarps = T >> 5;
  const float inv_f = 1.0f / static_cast<float>(f);  // exact: f = 2^lg
  const int i_first = bd.r0 >> lg;
  const int i_last = (bd.r1 - 1) >> lg;
  for (int k = t >> 5; k < K; k += nwarps) {
    const float* plane = planes + k * stride;
    unsigned long long best_key = 0ull;
    for (int j0 = 0; j0 < w; j0 += 32) {
      const int j = min(j0 + lane, w - 1);
      const int jh = min(j + 1, w - 1);
      // this thread's visits go up in flat index, so a strict compare keeps
      // the first of equal values; the first visit is taken or is -inf
      float bv = -INFINITY;
      int bp = bd.r0 * ow + f * j;
      for (int i = i_first; i <= i_last; ++i) {
        const float* top = plane + (i - bd.s0) * w;
        const float* bot = plane + (min(i + 1, h - 1) - bd.s0) * w;
        const float tj = top[j], bj = bot[j], tjh = top[jh], bjh = bot[jh];
        const int a0 = max(bd.r0 - i * f, 0);
        const int a1 = min(bd.r1 - i * f, f);
        for (int a = a0; a < a1; ++a) {
          const float wr = static_cast<float>(a) * inv_f;
          const float cr = __fsub_rn(1.0f, wr);
          const float rj = __fadd_rn(__fmul_rn(tj, cr), __fmul_rn(bj, wr));
          const float rjh =
              __fadd_rn(__fmul_rn(tjh, cr), __fmul_rn(bjh, wr));
          const int base = (i * f + a) * ow + f * j;
#pragma unroll (kUnroll)
          for (int c = 0; c < f; ++c) {
            const float wc = static_cast<float>(c) * inv_f;
            const float v = __fadd_rn(__fmul_rn(rj, __fsub_rn(1.0f, wc)),
                                      __fmul_rn(rjh, wc));
            // greater, or NaN; nothing beats a NaN already held
            if (!(v <= bv) && bv == bv) {
              bv = v;
              bp = base + c;
            }
          }
        }
      }
      const unsigned long long key =
          j0 + lane < w ? order_key(bv, bp) : 0ull;
      best_key = key > best_key ? key : best_key;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best_key, off);
      best_key = o > best_key ? o : best_key;
    }
    if (lane == 0) {
      atomicMax(keys + static_cast<size_t>(b) * K + k, best_key);
      __threadfence();
    }
  }

  // the last band of this image to finish writes its (row, col)
  __shared__ bool last;
  __syncthreads();
  if (t == 0) {
    unsigned long long* ticket = keys + static_cast<size_t>(gridDim.y) * K + b;
    last = atomicAdd(ticket, 1ull) == static_cast<unsigned long long>(nb - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = t; k < K; k += T) {
    const unsigned long long key =
        __ldcg(keys + static_cast<size_t>(b) * K + k);
    const int p = static_cast<int>(~static_cast<uint32_t>(key));
    float* o = out + (static_cast<size_t>(b) * K + k) * 2;
    o[0] = static_cast<float>(p / ow);
    o[1] = static_cast<float>(p % ow);
  }
}

// Dynamic shared memory of the overlay path for a band of `rows` source
// rows, or -1 if it does not fit beside the kernel's static flag.
int overlay_smem(int rows, int w, int K) {
  const long long bytes = 4ll * plane_stride(rows, w) * K;
  return bytes > kMaxSmem - 16 ? -1 : static_cast<int>(bytes);
}

template <int F>
int launch_overlay(const float* sm, float* out, unsigned long long* keys,
                   int B, int h, int w, int K, int factor, int lg, int nb,
                   int smem, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_overlay_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = 32 * min(K, 32);
  decode_overlay_kernel<F><<<dim3(nb, B), threads, smem, stream>>>(
      sm, out, keys, h, w, K, factor, lg, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// sm [B, h, w, K] f32, out [B, K, 2] f32 (row, col), contiguous device
// memory; scratch: B * K + B int64, which power-of-two factors use (zeroed
// here on the stream) and the others ignore. Launches on `stream`; returns a
// cudaError_t.
int h3d_decode_upsampled(const float* sm, float* out, long long* scratch,
                         int B, int h, int w, int K, int factor,
                         void* stream) {
  if (B <= 0 || h <= 0 || w <= 0 || K <= 0 || factor <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (factor & (factor - 1)) {
    const long long smem = sizeof(float) * static_cast<long long>(h) * w +
                           12ll * (h + w) * factor;
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > kDefaultSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          decode_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    decode_table_kernel<<<dim3(K, B), kTableThreads, smem, st>>>(
        sm, out, h, w, K, factor);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int lg = 0;
  while ((1 << lg) < factor) ++lg;
  const int oh = h * factor;
  // bands: about one block per SM at small batch, fewer at large batch,
  // more if a band's source rows would not fit in shared memory
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int nb = min(max((sms + B - 1) / B, 1), oh);
  int smem = -1;
  for (; nb <= oh; ++nb) {
    // a band of R output rows holds at most ceil((R - 1) / f) + 1 source
    // rows and the row below them
    const int R = (oh + nb - 1) / nb;
    smem = overlay_smem(min((R - 1 + factor - 1) / factor + 2, h), w, K);
    if (smem >= 0) break;
  }
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(scratch);
  e = cudaMemsetAsync(
      keys, 0, sizeof(unsigned long long) * (static_cast<size_t>(B) * K + B),
      st);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the cascade's factor 8 gets its column loop unrolled at compile time
  return factor == 8
      ? launch_overlay<8>(sm, out, keys, B, h, w, K, factor, lg, nb, smem, st)
      : launch_overlay<0>(sm, out, keys, B, h, w, K, factor, lg, nb, smem, st);
}

const char* h3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
