// Closest-hit parameter t of R rays against the static triangle soup:
// two-sided Moller-Trumbore, a hit when |det| > 1e-9 and t in
// (1e-5, max_t]; 1e30 means a miss.
//
// Replaces: c_game_engine_tpu/ops/ray_tris.py::ray_tris_pallas (_kernel),
// with the chunk lists its wrapper builds (block_minmax and
// compact_chunk_lists over each 128-ray block's segment XZ box, margin 0).
//
// What bounds it on an H100: latency and the staging reads, not the
// arithmetic. A tick's 8192 rays make ~4.6 x 10^6 listed (ray, row) pairs
// at ~60 float operations and one IEEE division each (0.004 ms at the
// float32 peak); each block also builds its list and copies its listed
// chunks from L2 (about 18 MB a launch), and a variant that builds the
// lists and stages the chunks but tests no row takes about 80% of the
// kernel's time (profile_kernels.py).
//
// Design: one warp per ray, 16 warps (16 rays of one 128-ray group) per
// block: a tick's 8192 rays are 512 blocks. Each block builds its group's
// chunk list itself: its first 128 threads compute the group's segment XZ
// box exactly as the plain version does (min(o, o + d * max_t) per lane,
// the zero-padded lanes included, which widen the box as on the TPU), the
// block tests up to 512 chunk bounds at once with the same <= / >= and
// margin 0, and a ballot compaction writes the listed ids in increasing
// order to shared memory. NaN: torch.amin propagates it and fminf drops
// it, so a lane whose box coordinate is NaN is flagged instead, and a
// flagged group lists no chunk, as the NaN comparisons of
// compact_chunk_lists list none. The global reads of this prologue are
// issued together. The listed chunks are staged into shared memory 8 at
// a time with cp.async, into two buffers (the next batch arrives while
// the current one is tested), each row at an 80-byte stride so that a
// warp's 16-byte reads of 32 rows hit every bank once: staged once per
// block, a chunk serves all 16 rays (read directly from global memory,
// each warp's rows missed L1 and the kernel took 1.7 times as long).
// Lane t tests row t of each chunk, and a warp fminf reduction gives the
// closest t: a min is exact in any order, so the result is deterministic
// and needs no atomics. The block is capped at 64 registers, so two fit
// on an SM and the 512 blocks are resident at once. Built with
// --fmad=false every expression rounds as the plain PyTorch version in
// ops/ray_tris.py does, and the two agree to the last bit.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLK = 128;                  // rays per group: one chunk list
constexpr int T_CHUNK = 32;               // rows per chunk, one per lane
constexpr int WARPS = 16;                 // rays per block, one per warp
constexpr int NTHREADS = 32 * WARPS;
constexpr int BLOCKS_PER_GROUP = BLK / WARPS;
constexpr int BATCH = 8;                  // chunks per staging buffer
constexpr int ROW = 20;                   // staged row stride in floats: 80 B, so a warp's
                                          // 16-byte reads of 32 rows hit no bank twice
constexpr unsigned FULL = 0xffffffffu;
constexpr float MISS = 1e30f;

// Stage chunks list[0 .. nb) (nb <= BATCH) into buf, row by row, with
// cp.async; the caller waits and syncs.
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ tri16, const int* list, int nb) {
  for (int k = threadIdx.x; k < nb * T_CHUNK * 4; k += NTHREADS) {
    const int c = k / (T_CHUNK * 4), r = (k / 4) % T_CHUNK, q = k % 4;
    __pipeline_memcpy_async(buf + (c * T_CHUNK + r) * ROW + q * 4,
                            tri16 + ((size_t)list[c] * T_CHUNK + r) * 16 + q * 4, 16);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(NTHREADS, 2)
ray_tris_kernel(const float* __restrict__ tri16, const float* __restrict__ cbounds, int nc,
                const float* __restrict__ rays, float* __restrict__ t_out, int R) {
  __shared__ __align__(16) float staged[2][BATCH * T_CHUNK * ROW];
  __shared__ float part[4][WARPS];  // per-warp box partials: lo x, hi x, lo z, hi z
  __shared__ int part_bad[WARPS];
  __shared__ int wcount[WARPS];
  __shared__ int list[NTHREADS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x / BLOCKS_PER_GROUP;

  // Every global read of the prologue is issued first, so that their
  // latencies overlap: this thread's chunk bound of the first round, the
  // warp's ray, and this thread's lane of the group's box.
  // chunk_bounds [NC, 4]: min x, min z, max x, max z
  float cb[4];
  const auto load_bound = [&](int c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) cb[i] = c < nc ? cbounds[(size_t)c * 4 + i] : 0.f;
  };
  load_bound(threadIdx.x);
  const int ray = blockIdx.x * WARPS + warp;
  const float ox = rays[ray], oy = rays[R + ray], oz = rays[2 * R + ray];
  const float dx = rays[3 * R + ray], dy = rays[4 * R + ray], dz = rays[5 * R + ray];
  const float maxt = rays[6 * R + ray];
  float tbest = MISS;

  // the group's segment XZ box (rays: [8, R] rows ox oy oz dx dy dz max_t pad)
  float lox = INFINITY, hix = -INFINITY, loz = INFINITY, hiz = -INFINITY;
  bool bad = false;
  if (threadIdx.x < BLK) {
    const int r = g * BLK + threadIdx.x;
    const float ox = rays[r], oz = rays[2 * R + r];
    const float ex = ox + rays[3 * R + r] * rays[6 * R + r];
    const float ez = oz + rays[5 * R + r] * rays[6 * R + r];
    bad = isnan(ox) || isnan(ex) || isnan(oz) || isnan(ez);
    lox = fminf(ox, ex);
    hix = fmaxf(ox, ex);
    loz = fminf(oz, ez);
    hiz = fmaxf(oz, ez);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lox = fminf(lox, __shfl_xor_sync(FULL, lox, o));
    hix = fmaxf(hix, __shfl_xor_sync(FULL, hix, o));
    loz = fminf(loz, __shfl_xor_sync(FULL, loz, o));
    hiz = fmaxf(hiz, __shfl_xor_sync(FULL, hiz, o));
  }
  bad = __any_sync(FULL, bad);
  if (lane == 0) {
    part[0][warp] = lox;
    part[1][warp] = hix;
    part[2][warp] = loz;
    part[3][warp] = hiz;
    part_bad[warp] = bad;
  }
  __syncthreads();
  bool empty = false;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    lox = fminf(lox, part[0][w]);
    hix = fmaxf(hix, part[1][w]);
    loz = fminf(loz, part[2][w]);
    hiz = fmaxf(hiz, part[3][w]);
    empty |= part_bad[w] != 0;
  }

  for (int base = 0; base < nc && !empty; base += NTHREADS) {
    // the listed chunks of this round, in increasing order
    const int c = base + threadIdx.x;
    if (base > 0) load_bound(c);
    const bool hit = c < nc && cb[0] <= hix && cb[2] >= lox && cb[1] <= hiz && cb[3] >= loz;
    const unsigned m = __ballot_sync(FULL, hit);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? wcount[w] : 0;
      n += wcount[w];
    }
    if (hit) list[off + __popc(m & ((1u << lane) - 1u))] = c;
    __syncthreads();

    // walk them BATCH chunks at a time, staging the next batch meanwhile
    if (n > 0) stage(staged[0], tri16, list, min(BATCH, n));
    for (int s0 = 0, cur = 0; s0 < n; s0 += BATCH, cur ^= 1) {
      __pipeline_wait_prior(0);
      __syncthreads();  // staged[cur] complete; every warp is done with the other buffer
      if (s0 + BATCH < n) stage(staged[cur ^ 1], tri16, list + s0 + BATCH, min(BATCH, n - s0 - BATCH));
      const int nb = min(BATCH, n - s0);
      for (int j = 0; j < nb; ++j) {
        const float* row = staged[cur] + (j * T_CHUNK + lane) * ROW;
        const float4 ta = *reinterpret_cast<const float4*>(row);
        const float4 tb = *reinterpret_cast<const float4*>(row + 4);
        const float4 tc = *reinterpret_cast<const float4*>(row + 8);
        const float valid = reinterpret_cast<const float4*>(row + 12)->x;
        const float ax = ta.x, ay = ta.y, az = ta.z;
        const float e1x = ta.w - ax, e1y = tb.x - ay, e1z = tb.y - az;
        const float e2x = tb.z - ax, e2y = tb.w - ay, e2z = tc.x - az;
        const float hx = dy * e2z - dz * e2y;
        const float hy = dz * e2x - dx * e2z;
        const float hz = dx * e2y - dy * e2x;
        const float det = e1x * hx + e1y * hy + e1z * hz;
        const bool ok = fabsf(det) > 1e-9f;
        const float inv = 1.f / (ok ? det : 1.f);
        const float sx = ox - ax, sy = oy - ay, sz = oz - az;
        const float u = (sx * hx + sy * hy + sz * hz) * inv;
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
        const bool h = ok & (valid > 0.5f) & (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) &
                       (tt > 1e-5f) & (tt <= maxt);
        tbest = fminf(tbest, h ? tt : MISS);
      }
    }
    __syncthreads();  // the list and the buffers are rewritten by the next round
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tbest = fminf(tbest, __shfl_xor_sync(FULL, tbest, o));
  if (lane == 0) t_out[ray] = tbest;
}

}  // namespace

// tri16 [T, 16] f32 (T >= 32 * nc, 16-byte aligned), cbounds [nc, 4] f32,
// rays [8, R] f32, output t [R] f32; R a multiple of 128. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int ray_tris_launch(const void* tri16, const void* cbounds, int nc, const void* rays,
                               void* t_out, int R, void* stream) {
  const int blocks = R / WARPS;
  if (blocks > 0) {
    ray_tris_kernel<<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tri16, (const float*)cbounds, nc, (const float*)rays, (float*)t_out, R);
  }
  return (int)cudaGetLastError();
}
