// Flood fill of the single-blob mask, for Hopper (sm_90a).
//
// Replaces hand3d_tpu/ops/pallas/floodfill.py::_kernel (with _win21_max).
// Per image it grows a one-pixel seed into its connected foreground blob:
// each pass is obj = det * max21x21(obj), the 21x21 window centered and
// clipped to the image, until the map stops changing or num_passes passes
// have run. Extra passes past the fixed point are no-ops, so the early exit
// equals the full trip count. The pass dilates first and masks after, so a
// seed on a background pixel still grows into foreground within its window;
// a seed outside the image grows nothing.
//
// Bound on an H100: on binary maps a pass is integer work on 32-pixel words,
// 43.125 word operations a word (below: the vertical tree 89 per 8 rows, the
// two reach trees 14 each, combine and mask 2, change test 2), plus one
// compare a pixel to pack and one select to unpack. The card issues 64 INT32
// operations per SM and clock against 128 f32 lanes, a quarter of the 67
// TFLOP/s f32 rate (which counts an FMA as two): 16.75 Tops/s. Against one
// read of det and one write of the result at 3.35 TB/s (614 KB, 0.18 us per
// 240x320 image), 32 passes cost 0.20 us an image: the two bounds are about
// equal, and an input that needs fewer passes is bound by its bytes.
//
// The maps stay on chip for all passes as bit masks, 32 pixels a word
// (240x320: 10 words a row, 9.6 KB a map). All arithmetic is integer, and
// the result is unpacked to 0.0f / 1.0f, bit-equal to the f32 twin (max and
// multiply of {0, 1} values are exact).
//
// What held the first design back: one block per image, so at batch 1 one
// SM of 132 did all the work; det was packed one dependent 4-byte load and
// ballot at a time; each pass paid two divisions, ten shift pairs and 21
// shared loads per word and two block barriers; unpacking paid a division
// per pixel.
//
// Design:
//  * one image is spread over a thread-block cluster: the largest of up to
//    8 CTAs (the portable limit) whose B clusters the card holds at once
//    (cudaOccupancyMaxActiveClusters, which chip_smoke.py logs), launched
//    with cudaLaunchKernelEx. Each CTA owns a band of at least 10
//    rows, so a band's 10-row halos lie in its two neighbours' bands. At
//    large batch a cluster is one CTA, one image;
//  * in a cluster, each CTA keeps obj with 10-row margins. As it writes the
//    first and last 10 rows of its band, it also stores them into its
//    neighbours' margins through distributed shared memory, so the next pass
//    reads only its own shared memory. obj is double-buffered: a pass reads
//    one buffer and writes the other, so one cluster barrier a pass orders
//    it. A CTA that changed a word sets the pass's flag in every CTA of the
//    cluster (three flags in rotation, each cleared by its owner two passes
//    after use), and all CTAs leave on one pass;
//  * a cluster of one keeps the first design's 12 bytes a row-word (det, the
//    vertical OR, one obj buffer, no margins), so every map size that fitted
//    then fits now; it needs one buffer because a pass writes obj only after
//    a block barrier, from the vertical OR. Its pass ends in one
//    __syncthreads_or;
//  * a pass ORs vertically first (21 rows), then horizontally, then masks
//    with det. The vertical reach is a log-step tree in registers: a thread
//    loads the 28 words of one column that 8 consecutive rows need (zero
//    beyond the rows it holds), ORs pairs at distance 1, 2 and 4 (y4[i]
//    covers rows i..i+7), then
//    out[i] = y4[i] | y4[i + 8] | y4[i + 13]. The horizontal reach of +-10
//    is a log-step tree (1, 2, 4, then 3 gives 0..10) on each side, with the
//    neighbouring word carried in by __funnelshift_r / __funnelshift_l and
//    zeros beyond the edge; a thread walks a segment of a row, keeping the
//    previous, current and next words in registers;
//  * det is packed from 16-byte loads, up to four in flight per lane, eight
//    lanes OR-ing their nibbles into a word by shuffles; the result is
//    unpacked with 16-byte stores. Rows whose width is not a multiple of 4
//    floats, or a misaligned tensor, take 4-byte loads and ballots. No loop
//    divides: work is walked in two levels from positions computed once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kHalf = 10;  // 21-tap window, general.py:236
constexpr int kRun = 8;    // rows a thread ORs in the vertical tree
constexpr int kTaps = kRun + 2 * kHalf;
constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kMaxSmem = 232448;  // per block on Hopper
constexpr int kDefaultSmem = 48 * 1024;

// In a cluster, obj is held with margins: row g of the image is row
// g - r0 + kHalf of a CTA's buffer, whose rows [0, kHalf) and
// [nr + kHalf, nr + 2 kHalf) take the neighbours' halos (zero beyond the
// image), and kRun more rows let the last run of the vertical tree load past
// them unchecked. A cluster of one holds no margins.
__host__ __device__ inline int margin_rows(int C) {
  return C > 1 ? kHalf : 0;
}

__host__ __device__ inline int held_rows(int band_cap, int C) {
  return C > 1 ? band_cap + 2 * kHalf + kRun : band_cap;
}

// Shared memory of one CTA in words: det and the vertical OR for `band_cap`
// rows, then in a cluster two obj buffers with margins and three flags, in a
// cluster of one a single obj buffer.
__host__ __device__ inline long long smem_words(int band_cap, int words,
                                                int C) {
  if (C == 1) return 3ll * band_cap * words;
  return (2ll * band_cap + 2ll * held_rows(band_cap, C)) * words + 3;
}

// Row band [r0, r1) of rank `rank` in a cluster of `C` over H rows: bands
// differ by at most one row.
__device__ __forceinline__ int band_start(int rank, int C, int H) {
  return static_cast<int>(static_cast<long long>(rank) * H / C);
}

// 0..10 columns to the right (higher bits, then the next word)
__device__ __forceinline__ uint32_t reach_right(uint32_t lo, uint32_t hi) {
  lo |= __funnelshift_r(lo, hi, 1);
  hi |= hi >> 1;
  lo |= __funnelshift_r(lo, hi, 2);
  hi |= hi >> 2;
  lo |= __funnelshift_r(lo, hi, 4);  // 0..7
  hi |= hi >> 4;
  return lo | __funnelshift_r(lo, hi, 3);  // 0..10
}

// 0..10 columns to the left (lower bits, then the previous word)
__device__ __forceinline__ uint32_t reach_left(uint32_t lo, uint32_t hi) {
  hi |= __funnelshift_l(lo, hi, 1);
  lo |= lo << 1;
  hi |= __funnelshift_l(lo, hi, 2);
  lo |= lo << 2;
  hi |= __funnelshift_l(lo, hi, 4);
  lo |= lo << 4;
  return hi | __funnelshift_l(lo, hi, 3);
}

__device__ __forceinline__ uint32_t nibble(float4 v) {
  return (v.x != 0.0f ? 1u : 0u) | (v.y != 0.0f ? 2u : 0u) |
         (v.z != 0.0f ? 4u : 0u) | (v.w != 0.0f ? 8u : 0u);
}

// Pack rows [r0, r1) of det_b into bit words: bit j of word c of a row is
// column 32 c + j; bits beyond W are 0.
__device__ void pack_rows(const float* __restrict__ det_b, uint32_t* bits,
                          int r0, int r1, int W, int words, bool vec) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (vec) {
    // float4 q of a row covers columns 4q..4q+3: word q / 8, bits 4 (q % 8)
    const int nq = W >> 2;
    for (int r = r0 + warp; r < r1; r += nwarps) {
      const float4* src = reinterpret_cast<const float4*>(
          det_b + static_cast<size_t>(r) * W);
      uint32_t* row = bits + (r - r0) * words;
      for (int q0 = 0; q0 < nq; q0 += 4 * 32) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u * 32 + lane;
          v[u] = q < nq ? __ldg(src + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t word = nibble(v[u]) << (4 * (lane & 7));
          word |= __shfl_xor_sync(0xffffffffu, word, 1);
          word |= __shfl_xor_sync(0xffffffffu, word, 2);
          word |= __shfl_xor_sync(0xffffffffu, word, 4);
          const int c = ((q0 + u * 32) >> 3) + (lane >> 3);
          if ((lane & 7) == 0 && c < words) row[c] = word;
        }
      }
    }
  } else {
    for (int r = r0 + warp; r < r1; r += nwarps) {
      const float* src = det_b + static_cast<size_t>(r) * W;
      uint32_t* row = bits + (r - r0) * words;
      for (int c = 0; c < words; ++c) {
        const int col = 32 * c + lane;
        const uint32_t word =
            __ballot_sync(0xffffffffu, col < W && src[col] != 0.0f);
        if (lane == 0) row[c] = word;
      }
    }
  }
}

// Unpack rows [r0, r1) of bit words into 0.0f / 1.0f.
__device__ void unpack_rows(const uint32_t* bits, float* __restrict__ out_b,
                            int r0, int r1, int W, int words, bool vec) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (vec) {
    const int nq = W >> 2;
    for (int r = r0 + warp; r < r1; r += nwarps) {
      float4* dst =
          reinterpret_cast<float4*>(out_b + static_cast<size_t>(r) * W);
      const uint32_t* row = bits + (r - r0) * words;
      for (int q = lane; q < nq; q += 32) {
        const uint32_t nib = row[q >> 3] >> (4 * (q & 7));
        __stcs(dst + q, make_float4(nib & 1u ? 1.0f : 0.0f,
                                    nib & 2u ? 1.0f : 0.0f,
                                    nib & 4u ? 1.0f : 0.0f,
                                    nib & 8u ? 1.0f : 0.0f));
      }
    }
  } else {
    for (int r = r0 + warp; r < r1; r += nwarps) {
      float* dst = out_b + static_cast<size_t>(r) * W;
      const uint32_t* row = bits + (r - r0) * words;
      for (int c = 0; c < words; ++c) {
        const int col = 32 * c + lane;
        if (col < W) dst[col] = (row[c] >> lane) & 1u ? 1.0f : 0.0f;
      }
    }
  }
}

// grid (C, B), cluster (C, 1, 1): CTA `rank` of cluster b owns a band of
// image b's rows. Every CTA lays out its shared memory alike, for band_cap
// rows, so a neighbour's buffer is at the same offset in its CTA.
__global__ void __launch_bounds__(kThreads, 1)
flood_fill_kernel(const float* __restrict__ det, const int* __restrict__ seed,
                  float* __restrict__ out, int H, int W, int words,
                  int num_passes, int band_cap, bool vec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int r0 = band_start(rank, C, H);
  const int r1 = band_start(rank + 1, C, H);
  const int nr = r1 - r0;

  extern __shared__ uint32_t smem[];
  const int m = margin_rows(C);
  const int span = nr + 2 * m;  // buffer rows that hold image rows from r0 - m
  const int held = held_rows(band_cap, C);  // buffer rows in all
  const int n = band_cap * words;
  const int n_ext = held * words;
  uint32_t* det_bits = smem;
  uint32_t* vert = smem + n;
  uint32_t* const obj[2] = {smem + 2 * n,
                            C > 1 ? smem + 2 * n + n_ext : smem + 2 * n};
  uint32_t* flags = smem + 2 * n + 2 * n_ext;  // [3], in a cluster only

  const float* det_b = det + static_cast<size_t>(b) * H * W;
  float* out_b = out + static_cast<size_t>(b) * H * W;
  const int t = threadIdx.x;
  const int T = blockDim.x;

  pack_rows(det_b, det_bits, r0, r1, W, words, vec);
  for (int i = t; i < (C > 1 ? 2 * n_ext : n_ext); i += T) obj[0][i] = 0u;
  if (C > 1 && t < 3) flags[t] = 0u;
  __syncthreads();
  const int sr = seed[2 * b];
  const int sc = seed[2 * b + 1];
  // the seed, in this CTA's rows or margins
  if (t == 0 && sr >= 0 && sr < H && sc >= 0 && sc < W &&
      sr >= r0 - m && sr < r1 + m)
    obj[0][(sr - r0 + m) * words + (sc >> 5)] = 1u << (sc & 31);

  // the neighbours' buffers: this band's first and last 10 rows are the
  // margins of the band above and below; the band above holds up_nr rows
  const int up_nr = rank > 0 ? r0 - band_start(rank - 1, C, H) : 0;
  const int above = rank > 0 ? rank - 1 : rank;
  const int below = rank + 1 < C ? rank + 1 : rank;
  uint32_t* const up[2] = {cluster.map_shared_rank(obj[0], above),
                           cluster.map_shared_rank(obj[1], above)};
  uint32_t* const down[2] = {cluster.map_shared_rank(obj[0], below),
                             cluster.map_shared_rank(obj[1], below)};

  // work is walked in two levels, (row group, word) or (row, segment),
  // from positions computed once here
  const int cols = min(words, T);
  const int row_lanes = T / cols;
  const int my_c = t % cols;
  const int my_row = t / cols;  // idle if >= row_lanes
  const int runs = my_row < row_lanes ? (nr + kRun - 1) / kRun : 0;
  int nseg = min(max(T / nr, 1), words);  // segments of a row
  const int seg_len = (words + nseg - 1) / nseg;
  nseg = (words + seg_len - 1) / seg_len;
  const int seg_rows = T / nseg;  // rows in flight
  const int h_row = t / nseg;  // idle if >= seg_rows
  const int h_c0 = (t - h_row * nseg) * seg_len;
  const int h_c1 = min(h_c0 + seg_len, words);
  const int h_nr = h_row < seg_rows ? nr : 0;

  cluster.sync();  // every CTA's det, obj[0] and flags are ready
  int cur = 0;
  int fi = 0;  // flag of this pass; (fi + 2) % 3 is cleared after it
  for (int pass = 0; pass < num_passes; ++pass) {
    const uint32_t* own = cur ? obj[1] : obj[0];
    // vertical: vert[r] = OR of obj rows r - 10 .. r + 10 (margins included)
    for (int run = my_row; run < runs; run += row_lanes) {
      const int ra = run * kRun;
      const int row0 = ra - kHalf + m;  // buffer row of the first tap
      // taps past `span` feed only rows past the band, which are not
      // stored, so a run inside the buffer loads unchecked: every run in a
      // cluster. A warp checks its loads if any of its runs needs it, so
      // that its lanes do not diverge.
      const bool inside = __all_sync(__activemask(),
                                     row0 >= 0 && row0 + kTaps <= held);
      for (int c = my_c; c < words; c += cols) {
        const uint32_t* col = own + c;
        uint32_t x[kTaps];
        if (inside) {
#pragma unroll
          for (int i = 0; i < kTaps; ++i) x[i] = col[(row0 + i) * words];
        } else {
#pragma unroll
          for (int i = 0; i < kTaps; ++i) {
            const int row = row0 + i;
            x[i] = static_cast<unsigned>(row) < static_cast<unsigned>(span)
                ? col[row * words] : 0u;
          }
        }
#pragma unroll
        for (int i = 0; i + 1 < kTaps; ++i) x[i] |= x[i + 1];  // 2 rows
#pragma unroll
        for (int i = 0; i + 3 < kTaps; ++i) x[i] |= x[i + 2];  // 4
        uint32_t y4[kTaps - 7];
#pragma unroll
        for (int i = 0; i + 7 < kTaps; ++i) y4[i] = x[i] | x[i + 4];  // 8
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          // y4[i] | y4[i + 8] covers rows i..i+15, y4[i + 13] i+13..i+20
          if (ra + i < nr)
            vert[(ra + i) * words + c] = y4[i] | y4[i + 8] | y4[i + 13];
        }
      }
    }
    __syncthreads();
    // horizontal along a segment of a row, then mask; own rows only. Rows
    // within 10 of the band's edges also go to the neighbours' margins of
    // the same buffer, which they read only in the next pass.
    uint32_t* next = cur ? obj[0] : obj[1];
    uint32_t* next_up = cur ? up[0] : up[1];
    uint32_t* next_down = cur ? down[0] : down[1];
    bool changed = false;
    for (int r = h_row; r < h_nr; r += seg_rows) {
      const uint32_t* vrow = vert + r * words;
      const uint32_t* drow = det_bits + r * words;
      const uint32_t* orow = own + (r + m) * words;
      uint32_t* nrow = next + (r + m) * words;
      uint32_t* up_row = r < kHalf && rank > 0
          ? next_up + (up_nr + kHalf + r) * words : nullptr;
      uint32_t* down_row = r >= nr - kHalf && rank + 1 < C
          ? next_down + (r - nr + kHalf) * words : nullptr;
      uint32_t prev = h_c0 > 0 ? vrow[h_c0 - 1] : 0u;
      uint32_t mid = vrow[h_c0];
      for (int c = h_c0; c < h_c1; ++c) {
        const uint32_t nxt = c + 1 < words ? vrow[c + 1] : 0u;
        const uint32_t grown =
            (reach_right(mid, nxt) | reach_left(prev, mid)) & drow[c];
        changed |= grown != orow[c];
        nrow[c] = grown;
        if (up_row) up_row[c] = grown;
        if (down_row) down_row[c] = grown;
        prev = mid;
        mid = nxt;
      }
    }
    bool any;
    if (C == 1) {
      any = __syncthreads_or(changed);
    } else {
      if (__any_sync(0xffffffffu, changed) && (t & 31) == 0)
        for (int q = 0; q < C; ++q)
          *cluster.map_shared_rank(flags + fi, q) = 1u;
      cluster.sync();
      any = *static_cast<volatile uint32_t*>(flags + fi) != 0u;
      if (t == 0) flags[fi == 0 ? 2 : fi - 1] = 0u;
      fi = fi == 2 ? 0 : fi + 1;
    }
    cur ^= 1;
    if (!any) break;
  }
  unpack_rows((cur ? obj[1] : obj[0]) + m * words, out_b, r0, r1, W, words,
              vec);
}

// A launch of B clusters of C CTAs with `smem` bytes each.
void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int C,
               int B, int smem, cudaStream_t stream) {
  cfg->gridDim = dim3(C, B);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

cudaError_t allow_smem(int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(flood_fill_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// How many clusters of C CTAs the device can run at once, asked once per
// (device, C, smem).
cudaError_t clusters_held(int C, int smem, int dev, int* held) {
  struct Entry {
    int dev, C, smem, held;
  };
  static std::mutex mu;
  static Entry seen[64];
  static int n_seen = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].dev == dev && seen[i].C == C && seen[i].smem == smem) {
      *held = seen[i].held;
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  configure(&cfg, attr, C, 1, smem, nullptr);
  cudaError_t e = allow_smem(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(held, flood_fill_kernel, &cfg);
  if (e == cudaSuccess && n_seen < 64) seen[n_seen++] = {dev, C, smem, *held};
  return e;
}

// Cluster size C: the largest, up to 8, whose B clusters the card holds at
// once (`held` of them), with bands of at least 10 rows so that a halo lies
// in the neighbouring band; else 1, one CTA an image, which the caller has
// checked fits.
cudaError_t plan(int B, int H, int words, int* C, int* held) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  *C = 1;
  *held = 0;
  for (int c = min(kMaxCluster, H / kHalf); e == cudaSuccess && c > 1; --c) {
    const long long bytes = 4 * smem_words((H + c - 1) / c, words, c);
    if (bytes > kMaxSmem) break;
    e = clusters_held(c, static_cast<int>(bytes), dev, held);
    if (e == cudaSuccess && *held >= B) {
      *C = c;
      break;
    }
  }
  if (*C == 1) *held = 0;
  return e;
}

}  // namespace

extern "C" {

// The cluster size h3d_flood_fill takes for [B, H, W], and how many such
// clusters the card holds at once (0 for a cluster of one).
int h3d_flood_fill_plan(int B, int H, int W, int* C, int* held) {
  const int words = (W + 31) / 32;
  if (B <= 0 || H <= 0 || W <= 0 || 4 * smem_words(H, words, 1) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(plan(B, H, words, C, held));
}

// det [B, H, W] f32, seed [B, 2] int32 (row, col), out [B, H, W] f32, all
// contiguous device memory. The maps must fit one CTA (12 bytes a row and
// 32-pixel word). Launches on `stream`; returns a cudaError_t.
int h3d_flood_fill(const float* det, const int* seed, float* out, int B, int H,
                   int W, int num_passes, void* stream) {
  const int words = (W + 31) / 32;
  if (B <= 0 || H <= 0 || W <= 0 || num_passes < 0 || B > 65535 ||
      4 * smem_words(H, words, 1) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  int C = 1, held = 0;
  cudaError_t e = plan(B, H, words, &C, &held);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int band_cap = (H + C - 1) / C;
  const long long smem = 4 * smem_words(band_cap, words, C);
  e = allow_smem(static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte loads and stores need rows of whole float4s on aligned tensors
  const bool vec = W % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(det) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  configure(&cfg, attr, C, B, static_cast<int>(smem),
            static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&cfg, flood_fill_kernel, det, seed, out, H, W, words,
                         num_passes, band_cap, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* h3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
