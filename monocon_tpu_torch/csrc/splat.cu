// Max-composited Gaussian splatting onto per-channel heatmaps, for sm_90a.
//
// Replaces the TPU kernel monocon_tpu/ops/pallas_splat.py::_splat_kernel
// (launched by splat_max_heatmap_pallas). Each valid instance n of channel
// c splats exp(-(dx^2 + dy^2) / (2 sigma^2)), sigma = (2r + 1) / 6, on the
// box |dx|, |dy| <= r around its integer centre; values below float32 eps
// are dropped, and each (b, c) plane takes the max over its instances.
//
// Bound: bytes. The output, B*C*H*W*4 bytes written once, is the whole
// device-memory traffic (11.8 MB per train step at the main-path shapes,
// B=8, 96x320, C=3 + C=9: about 3.5 us at 3.35 TB/s); the inputs are a
// few KB and the work per covered pixel is a handful of flops.
//
// Design: a block owns a tile of SPLAT_TILE_C channels x SPLAT_TILE_H rows
// x SPLAT_TILE_W columns (5 x 32 x 32 as ops/splat.py builds it) of one
// batch element. Each of its threads owns 4 adjacent columns of one tile
// row, in each of the tile's channels. With all C channels in one block it
// would read the instances once per tile; a busy tile of the keypoint call
// (C=9) then keeps one SM evaluating long after the others, so its
// channels take two blocks, which read the instances twice.
//   1. Cull, in rounds of kRound instances: each thread issues the loads of
//      its kPerThread instances of the round (coalesced) before using any,
//      and keeps an instance if it is valid, its channel is in the block's
//      range and its box can reach the tile. Each warp compacts its
//      survivors by ballot and __popc into a list in dynamic shared memory,
//      at an offset summed from the warps' counts, with their scalars
//      precomputed once: two barriers a round, no shared atomics. The list
//      is sized for N at launch (20 bytes per instance: about 11 600
//      instances in the H100's 227 KB opt-in limit); a larger N is refused
//      before launch. The main path has N = 30 and 270: one round.
//   2. Evaluate, one channel at a time: a warp ballots the survivors of the
//      channel (usually 0-3) and runs each over its 4 pixels per thread,
//      keeping the running max in 4 registers.
//   3. Store the channel at once, so that its stores overlap the next
//      channel's work: one 16-byte float4 per thread when W % 4 == 0 and
//      the output is 16-byte aligned, else scalar stores.
// Tiles with no survivors still write their zeros: every pixel is written
// exactly once, with no zeroing pass and no atomics on the output, so the
// result is deterministic (the max of exact values does not depend on the
// survivors' order). An atomicMax scatter over each support would need a
// zeroing pass (twice the bytes) and lose the coalesced stores. There is
// no matrix product for wgmma, and a TMA store would only add a staging
// copy in front of stores that are already coalesced 16-byte writes.
//
// The cull tests the tile's first and last pixel with the same float
// arithmetic as the per-pixel box test below. px - cx rounds monotonically
// in px, so an instance it drops fails |px - cx| <= r at every pixel of the
// tile, for any int32 input.
//
// Arithmetic follows pallas_splat.py: the box test on float offsets, one
// full expf (no fast-math, so expf is the accurate one), the eps floor.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#if !defined(SPLAT_TILE_C) || !defined(SPLAT_TILE_H) || !defined(SPLAT_TILE_W)
#error "the SPLAT_TILE_* sizes are set by monocon_tpu_torch/ops/splat.py"
#endif

namespace {

constexpr int kTileC = SPLAT_TILE_C;
constexpr int kTileH = SPLAT_TILE_H;
constexpr int kTileW = SPLAT_TILE_W;
constexpr int kThreads = kTileH * kTileW / 4;  // 4 columns per thread
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 512;                    // instances culled per round
constexpr int kPerThread = kRound / kThreads;  // instances a thread culls
constexpr unsigned kAll = 0xffffffffu;
static_assert(kTileW % 4 == 0 && kThreads % 32 == 0 && kThreads <= 1024,
              "a tile row is whole float4s and a block whole warps");
static_assert(kRound % kThreads == 0, "a round is whole passes of the block");
static_assert(kTileC >= 1, "a tile has channels");

struct __align__(16) Survivor {  // one 16-byte shared load
  float cx, cy, r, inv_2s2;
};

// Dynamic shared memory per instance: its Survivor, then its channel in a
// second array after the N Survivors.
constexpr size_t kListBytesPerInstance = sizeof(Survivor) + sizeof(int);
// Shared memory a block may use without opting in.
constexpr size_t kDefaultSharedBytes = 48 * 1024;

// Appends to `list` and `list_channel`, from slot `offset` on, the
// instances [base, base + kRound) of batch element b whose channel is in
// [c_lo, c_hi) and whose box can reach the tile of columns x0..x1 and rows
// y0..y1; returns how many. Every thread of the block calls it.
__device__ int cull(const int32_t* __restrict__ centers,
                    const int32_t* __restrict__ radius,
                    const int32_t* __restrict__ channel,
                    const uint8_t* __restrict__ valid, int b, int n,
                    int base, int offset, int c_lo, int c_hi, float x0,
                    float x1, float y0, float y1, Survivor* list,
                    int* list_channel, int* warp_count) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  Survivor s[kPerThread];
  int ch[kPerThread];
  bool ok[kPerThread];
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {  // all loads first
    const int i = base + p * kThreads + threadIdx.x;
    ok[p] = i < n;
    if (ok[p]) {
      const int64_t bi = static_cast<int64_t>(b) * n + i;
      ok[p] = valid[bi];
      ch[p] = channel[bi];
      s[p].cx = static_cast<float>(centers[2 * bi]);
      s[p].cy = static_cast<float>(centers[2 * bi + 1]);
      s[p].r = static_cast<float>(radius[bi]);
    }
  }
  unsigned keep[kPerThread];
  int own = 0;
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const Survivor& t = s[p];
    keep[p] = __ballot_sync(
        kAll, ok[p] && ch[p] >= c_lo && ch[p] < c_hi &&
              x1 - t.cx >= -t.r && x0 - t.cx <= t.r &&
              y1 - t.cy >= -t.r && y0 - t.cy <= t.r);
    own += __popc(keep[p]);
  }
  if (lane == 0) warp_count[warp] = own;
  __syncthreads();
  const int count = lane < kWarps ? warp_count[lane] : 0;
  const int total = __reduce_add_sync(kAll, count);
  int slot = offset + __reduce_add_sync(kAll, lane < warp ? count : 0);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    if (keep[p] >> lane & 1u) {
      const int j = slot + __popc(keep[p] & below);
      const float sigma = (2.0f * s[p].r + 1.0f) / 6.0f;
      s[p].inv_2s2 = 1.0f / (2.0f * sigma * sigma);
      list[j] = s[p];
      list_channel[j] = ch[p];
    }
    slot += __popc(keep[p]);
  }
  __syncthreads();  // the list is complete; warp_count may be reused
  return total;
}

// Max-composites survivor v onto the 4 pixels (x..x+3, py) of a thread.
__device__ __forceinline__ void splat_survivor(const Survivor& v, int x,
                                               float py, float acc[4]) {
  const float dy = py - v.cy;
  if (!(fabsf(dy) <= v.r)) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float dx = static_cast<float>(x + q) - v.cx;
    if (fabsf(dx) <= v.r) {
      const float g = expf(-(dx * dx + dy * dy) * v.inv_2s2);
      if (g >= FLT_EPSILON) acc[q] = fmaxf(acc[q], g);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
splat_kernel(const int32_t* __restrict__ centers,   // (B, N, 2) x, y
             const int32_t* __restrict__ radius,    // (B, N)
             const int32_t* __restrict__ channel,   // (B, N)
             const uint8_t* __restrict__ valid,     // (B, N) bool
             float* __restrict__ out,               // (B, C, H, W)
             int n, int num_channels, int h, int w, int tiles_w,
             bool vector_store) {
  extern __shared__ Survivor list[];  // n Survivors, then n channels
  int* const list_channel = reinterpret_cast<int*>(list + n);
  __shared__ int warp_count[kWarps];
  const int b = blockIdx.z;
  const int c_first = blockIdx.y * kTileC;
  const int c_end = min(num_channels, c_first + kTileC);
  const int x_first = (blockIdx.x % tiles_w) * kTileW;
  const int y_first = (blockIdx.x / tiles_w) * kTileH;
  const float x0 = static_cast<float>(x_first);
  const float x1 = static_cast<float>(min(x_first + kTileW, w) - 1);
  const float y0 = static_cast<float>(y_first);
  const float y1 = static_cast<float>(min(y_first + kTileH, h) - 1);

  int m = 0;  // survivors listed
  for (int base = 0; base < n; base += kRound) {
    m += cull(centers, radius, channel, valid, b, n, base, m, c_first, c_end,
              x0, x1, y0, y1, list, list_channel, warp_count);
  }

  const int lane = threadIdx.x % 32;
  const int x = x_first + 4 * (threadIdx.x % (kTileW / 4));
  const int y = y_first + threadIdx.x / (kTileW / 4);
  const float py = static_cast<float>(y);
  const bool in_map = x < w && y < h;
  const int first_channel = lane < m ? list_channel[lane] : -1;
  for (int c = c_first; c < c_end; ++c) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const int cj = j0 == 0 ? first_channel : j < m ? list_channel[j] : -1;
      unsigned todo = __ballot_sync(kAll, cj == c);
      while (todo != 0) {
        splat_survivor(list[j0 + __ffs(todo) - 1], x, py, acc);
        todo &= todo - 1;
      }
    }
    if (in_map) {
      float* row = out + ((static_cast<int64_t>(b) * num_channels + c) * h
                          + y) * w + x;
      if (vector_store) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (x + q < w) row[q] = acc[q];
        }
      }
    }
  }
}

}  // namespace

// Returned, instead of a CUDA error, when the N instances of a batch
// element do not fit the block's shared list on this device.
constexpr int kTooManyInstances = -1;

// C interface for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success) or kTooManyInstances; does not
// synchronise.
extern "C" int splat_max_heatmap(const int32_t* centers, const int32_t* radius,
                                 const int32_t* channel, const uint8_t* valid,
                                 float* out, int b, int n, int num_channels,
                                 int h, int w, void* stream) {
  const size_t list_bytes = static_cast<size_t>(n) * kListBytesPerInstance;
  const size_t static_bytes = kWarps * sizeof(int);
  if (list_bytes + static_bytes > kDefaultSharedBytes) {
    int device = 0;
    int limit = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (list_bytes + static_bytes > static_cast<size_t>(limit)) {
      return kTooManyInstances;
    }
    err = cudaFuncSetAttribute(splat_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(list_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int tiles_h = (h + kTileH - 1) / kTileH;
  const dim3 grid(tiles_w * tiles_h, (num_channels + kTileC - 1) / kTileC, b);
  const bool vector_store =
      w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  splat_kernel<<<grid, kThreads, list_bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      centers, radius, channel, valid, out, n, num_channels, h, w, tiles_w,
      vector_store);
  return static_cast<int>(cudaGetLastError());
}
