// Streamed z and winner pass for big triangle tables, batched over envs:
// for every pixel, a walk in increasing id order over the rows whose screen
// bbox overlaps its 8x128 tile (edge functions, affine z, the
// strictly-closer test that skips one excluded id per pixel). No
// attributes: the caller gathers them from the winner image.
//
// Replaces: c_game_engine_tpu/ops/raster_tiles_big.py::raster_tiles_big
// (_kernel_big), vmapped over envs.
//
// What bounds it on an H100: the z test's arithmetic. Each (pixel, row)
// pair whose row's bbox overlaps the pixel's tile costs ~40 float
// operations (three edge functions, the denominator, affine z, the
// compares); pass 1 of a 64-env 256x256 frame batch of the 82k-triangle
// arena_orb after 60 ticks holds 8.9 x 10^8 such pairs, which bound it at
// 0.53 ms by operations against 3.2 ms measured (chip_smoke.py, H100 80GB
// HBM3 at 700 W), while its bytes (the 679,616 overlapping rows' 14
// columns and the two output planes, 72 MB) take 0.02 ms. The reveal pass
// enables only the tiles with something to reveal and is bound by the two
// output planes' bytes (0.011 ms against 0.12 ms measured). An exclude id
// is read only in an enabled tile, and none without an exclude image.
//
// Design: one block of 256 threads per (env, tile); each thread keeps 4
// pixels of one tile column (rows r, r+2, r+4, r+6) in registers for the
// whole walk. The TPU kernel's chunk-outer grid and its VMEM-resident
// full-frame accumulators existed to reuse one DMA'd chunk across tiles;
// here each block streams the table itself, and the prune tests decide
// what it reads: a chunk whose bbox union misses the tile is skipped, then
// each 64-row subchunk likewise, and a hit subchunk's 64 rows (columns
// 0-13, each 64 contiguous floats of the fields-major table: coalesced) are
// staged through shared memory, where every thread reads the same row (a
// broadcast). Every prune test reads values shared by the whole block, so
// the branches are uniform. A skipped row also fails its own bbox test, so
// the result is the TPU kernel's, which folds that test into its mask. The
// walk is serial per pixel with a strict z < zbuf, so of two rows at equal
// z the lower id wins, as on the TPU; no atomics. Built with --fmad=false,
// every expression rounds as in the plain PyTorch version in
// ops/raster_tiles_big.py, and the two agree to the last bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int T_CHK = 4096;
constexpr int SUB = 64;
constexpr int N_SUB = T_CHK / SUB;
constexpr int N_ROWS = 16;  // fields of the table
constexpr int N_USE = 14;   // fields the kernel reads (0-13)
constexpr int NTHREADS = 256;
constexpr int ROW_STEP = NTHREADS / TILE_W;       // 2
constexpr int PIX = TILE_H * TILE_W / NTHREADS;   // 4 pixels per thread

__device__ __forceinline__ bool overlaps(const float* b, float x0, float x1, float y0, float y1) {
  return b[0] <= x1 && b[1] >= x0 && b[2] <= y1 && b[3] >= y0;
}

__global__ void __launch_bounds__(NTHREADS)
raster_tiles_big_kernel(const float* __restrict__ trit, const float* __restrict__ cbox,
                        const float* __restrict__ scb, const int* __restrict__ excl,
                        const int* __restrict__ tile_on, float* __restrict__ z_out,
                        int* __restrict__ win_out, int nc, int nty, int ntx) {
  __shared__ float rows[N_USE * SUB];  // field-major: rows[k * SUB + q]
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int H = nty * TILE_H, W = ntx * TILE_W;
  const int c = threadIdx.x % TILE_W;
  const int r0 = threadIdx.x / TILE_W;
  const float x0 = (float)(tx * TILE_W), y0 = (float)(ty * TILE_H);
  const float x1 = x0 + (float)TILE_W, y1 = y0 + (float)TILE_H;
  const float gx = (x0 + (float)c) + 0.5f;

  float gy[PIX], zbuf[PIX];
  int win[PIX], ex[PIX];
  size_t pix[PIX];
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const int r = r0 + p * ROW_STEP;
    gy[p] = (y0 + (float)r) + 0.5f;
    pix[p] = ((size_t)b * H + (ty * TILE_H + r)) * W + (tx * TILE_W + c);
    zbuf[p] = INFINITY;
    win[p] = -1;
  }

  if (tile_on[(size_t)b * nty * ntx + tile] != 0) {
    // a gated tile reads no exclude id; no image excludes nothing
#pragma unroll
    for (int p = 0; p < PIX; ++p) ex[p] = excl ? excl[pix[p]] : -1;
    const size_t T = (size_t)nc * T_CHK;
    const float* table = trit + (size_t)b * N_ROWS * T;
    const float* cb = cbox + (size_t)b * nc * 4;
    const float* sb = scb + (size_t)b * nc * N_SUB * 4;
    for (int ci = 0; ci < nc; ++ci) {
      if (!overlaps(cb + ci * 4, x0, x1, y0, y1)) continue;
      for (int s = 0; s < N_SUB; ++s) {
        if (!overlaps(sb + ((size_t)ci * N_SUB + s) * 4, x0, x1, y0, y1)) continue;
        const size_t base = (size_t)ci * T_CHK + s * SUB;
        __syncthreads();
        for (int k = threadIdx.x; k < N_USE * SUB; k += NTHREADS) {
          const int field = k / SUB, q = k - field * SUB;
          rows[k] = table[field * T + base + q];
        }
        __syncthreads();
        for (int q = 0; q < SUB; ++q) {
          const float* t = rows + q;
          const float bb[4] = {t[10 * SUB], t[11 * SUB], t[12 * SUB], t[13 * SUB]};
          if (!overlaps(bb, x0, x1, y0, y1)) continue;
          const float ax = t[0], ay = t[SUB], bx = t[2 * SUB], by = t[3 * SUB];
          const float cx = t[4 * SUB], cy = t[5 * SUB];
          const float z0 = t[6 * SUB], z1 = t[7 * SUB], z2 = t[8 * SUB];
          // the per-row and per-column factors of the edge functions
          const float dx0 = bx - ax, dy0 = by - ay, dx1 = cx - bx, dy1 = cy - by;
          const float dx2 = ax - cx, dy2 = ay - cy;
          const float px0 = gx - ax, px1 = gx - bx, px2 = gx - cx;
          const int id = (int)(base + q);
#pragma unroll
          for (int p = 0; p < PIX; ++p) {
            const float e0 = dx0 * (gy[p] - ay) - dy0 * px0;
            const float e1 = dx1 * (gy[p] - by) - dy1 * px1;
            const float e2 = dx2 * (gy[p] - cy) - dy2 * px2;
            const bool inside = (e0 <= 0.f && e1 <= 0.f && e2 <= 0.f) ||
                                (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f);
            float denom = (e0 + e1) + e2;
            denom = fabsf(denom) > 1e-9f ? denom : 1e-9f;
            const float z = ((e1 * z0 + e2 * z1) + e0 * z2) / denom;
            if (inside && z > 0.f && z < 1.f && z < zbuf[p] && id != ex[p]) {
              zbuf[p] = z;
              win[p] = id;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    z_out[pix[p]] = zbuf[p];
    win_out[pix[p]] = win[p];
  }
}

}  // namespace

// trit [B, 16, nc * 4096] f32 (fields-major), cbox [B, nc, 4] f32, scb
// [B, nc * 64, 4] f32, excl [B, H, W] i32 or null (no exclude), tile_on
// [B, nty * ntx] i32, z
// [B, H, W] f32, win [B, H, W] i32 with H = 8 nty, W = 128 ntx. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int raster_tiles_big_launch(const void* trit, const void* cbox, const void* scb,
                                       const void* excl, const void* tile_on, void* z, void* win,
                                       int B, int nc, int nty, int ntx, void* stream) {
  if (B > 0 && nc > 0 && nty > 0 && ntx > 0) {
    dim3 grid(nty * ntx, B);
    raster_tiles_big_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)trit, (const float*)cbox, (const float*)scb, (const int*)excl,
        (const int*)tile_on, (float*)z, (int*)win, nc, nty, ntx);
  }
  return (int)cudaGetLastError();
}
