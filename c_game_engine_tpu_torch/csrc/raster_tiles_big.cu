// Streamed z and winner pass for big triangle tables, batched over envs:
// for every pixel, a walk in increasing id order over the rows whose screen
// bbox overlaps its 8x128 tile (edge functions, affine z, the
// strictly-closer test that skips one excluded id per pixel). No
// attributes: the caller gathers them from the winner image.
//
// Replaces: c_game_engine_tpu/ops/raster_tiles_big.py::raster_tiles_big
// (_kernel_big), vmapped over envs.
//
// What bounds it on an H100: instruction issue on the (pixel, row) pairs.
// Pass 1 of a 64-env 256x256 frame batch of the 82k-triangle arena_orb
// after 60 ticks holds 8.9 x 10^8 pairs whose row's bbox overlaps the
// pixel's tile; each costs the three edge functions and the inside test
// (~15 instructions), and only the few pairs that are inside (the sphere's
// triangles cover about a pixel each) also pay for the denominator, z and
// the IEEE division. The function needs fewer per pair, about 10 flops:
// each edge function's last subtraction and the 6 compares, once a row's
// per-line factors dx * (gy - a) are shared by the 128 pixels of a line,
// as its per-column ones are by a column; here a thread holds 4 lines of
// one column, so it recomputes the per-line product on every pair. Next
// come the per-subchunk steps (one barrier, two
// ballots) and the per-row set-up. Bytes are far below: the hit rows' 14
// columns and the two output planes are ~72 MB, 0.02 ms at 3.35 TB/s. The
// reveal pass enables only the tiles with something to reveal and is bound
// by the two output planes' bytes. An exclude id is read only in an
// enabled tile, and none without an exclude image.
//
// Design: one block of 256 threads per (env, tile); each thread keeps 4
// pixels of one tile column (rows r, r+2, r+4, r+6) in registers for the
// whole walk, so a row's per-column factors (gx - a, dy * (gx - a)) serve
// 4 pixels. The TPU kernel's chunk-outer grid and its VMEM-resident
// full-frame accumulators existed to reuse one DMA'd chunk across tiles;
// here each block streams the table itself, and the bbox tests decide what
// it reads, with no serial chain of dependent loads:
//   1. the block tests up to 256 chunk boxes at once and a ballot
//      compaction lists the hit chunks in increasing order (shared memory);
//   2. for up to 16 hit chunks at a time, 64 threads per chunk test its 64
//      subchunk boxes at once (4 chunks per pass), and a ballot compaction
//      lists the hit subchunks in increasing order;
//   3. the hit subchunks' 14 columns (each 64 contiguous floats of the
//      fields-major table, 256 bytes) are staged through two shared-memory
//      buffers with cp.async: the next subchunk's columns arrive while the
//      current one is walked, one barrier per subchunk;
//   4. every warp tests the staged subchunk's 64 row bboxes, two rows a
//      lane, and two ballots give the 64-bit mask of hit rows, whose set
//      bits the walk visits in increasing order (each warp computes the
//      same mask, so no barrier is needed and the loop is uniform);
//   5. per pixel, the three edge functions and `inside` come first; the
//      denominator, z and the division run only where the pixel is inside,
//      and a warp skips them when none of its lanes' 4 pixels is (a
//      skipped pair fails `inside`, so zbuf and the winner are unchanged).
// A row that no list reaches also fails its own bbox test, so the result
// is the TPU kernel's, which folds that test into its mask. The walk is
// serial per pixel with a strict z < zbuf, so of two rows at equal z the
// lower id wins, as on the TPU; no atomics. Built with --fmad=false, every
// expression rounds as in the plain PyTorch version in
// ops/raster_tiles_big.py, and the two agree to the last bit.

#include <cuda_pipeline.h>
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
constexpr int NWARPS = NTHREADS / 32;
constexpr int ROW_STEP = NTHREADS / TILE_W;       // 2
constexpr int PIX = TILE_H * TILE_W / NTHREADS;   // 4 pixels per thread
constexpr int S_CHUNKS = 16;                      // hit chunks listed per subchunk round
constexpr int S_CAP = S_CHUNKS * N_SUB;           // subchunk list capacity
constexpr int CHUNKS_PER_PASS = NTHREADS / N_SUB; // 4
constexpr int N_COPY = N_USE * SUB / 4;           // 16-byte copies per staged subchunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool overlaps(const float* b, float x0, float x1, float y0, float y1) {
  return b[0] <= x1 && b[1] >= x0 && b[2] <= y1 && b[3] >= y0;
}

// Row q's bbox of a staged subchunk (fields-major: rows[k * SUB + q]).
__device__ __forceinline__ bool row_overlaps(const float* rows, int q, float x0, float x1, float y0,
                                             float y1) {
  return rows[10 * SUB + q] <= x1 && rows[11 * SUB + q] >= x0 && rows[12 * SUB + q] <= y1 &&
         rows[13 * SUB + q] >= y0;
}

// Writes `value` of every thread with `hit` to list[base + rank], ranks in
// thread order, and returns the block's number of hits. Two barriers: the
// list is complete, and wcnt free, when it returns.
__device__ __forceinline__ int compact(bool hit, int value, int* list, int base, int* wcnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(FULL, hit);
  if (lane == 0) wcnt[warp] = __popc(m);
  __syncthreads();
  int off = base, n = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    off += w < warp ? wcnt[w] : 0;
    n += wcnt[w];
  }
  if (hit) list[off + __popc(m & ((1u << lane) - 1u))] = value;
  __syncthreads();
  return n;
}

// Stage the 14 columns of subchunk `gs` (rows gs * SUB ...) into dst.
__device__ __forceinline__ void stage(float* dst, const float* table, size_t T, int gs) {
  const size_t base = (size_t)gs * SUB;
  for (int k = threadIdx.x; k < N_COPY; k += NTHREADS) {
    const int field = k / (SUB / 4), part = k - field * (SUB / 4);
    __pipeline_memcpy_async(dst + field * SUB + part * 4, table + field * T + base + part * 4, 16);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(NTHREADS)
raster_tiles_big_kernel(const float* __restrict__ trit, const float* __restrict__ cbox,
                        const float* __restrict__ scb, const int* __restrict__ excl,
                        const int* __restrict__ tile_on, float* __restrict__ z_out,
                        int* __restrict__ win_out, int nc, int nty, int ntx) {
  __shared__ __align__(16) float staged[2][N_USE * SUB];
  __shared__ int clist[NTHREADS];
  __shared__ int slist[S_CAP];
  __shared__ int wcnt[NWARPS];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int H = nty * TILE_H, W = ntx * TILE_W;
  const int c = threadIdx.x % TILE_W;
  const int r0 = threadIdx.x / TILE_W;
  const int lane = threadIdx.x & 31;
  const float x0 = (float)(tx * TILE_W), y0 = (float)(ty * TILE_H);
  const float x1 = x0 + (float)TILE_W, y1 = y0 + (float)TILE_H;
  const float gx = (x0 + (float)c) + 0.5f;
  auto pixel = [&](int p) {
    return ((size_t)b * H + (ty * TILE_H + r0 + p * ROW_STEP)) * W + (tx * TILE_W + c);
  };

  float gy[PIX], zbuf[PIX];
  int win[PIX], ex[PIX];
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    gy[p] = (y0 + (float)(r0 + p * ROW_STEP)) + 0.5f;
    zbuf[p] = INFINITY;
    win[p] = -1;
  }

  if (tile_on[(size_t)b * nty * ntx + tile] != 0) {
    // a gated tile reads no exclude id; no image excludes nothing
#pragma unroll
    for (int p = 0; p < PIX; ++p) ex[p] = excl ? excl[pixel(p)] : -1;
    const size_t T = (size_t)nc * T_CHK;
    const float* table = trit + (size_t)b * N_ROWS * T;
    const float* cb = cbox + (size_t)b * nc * 4;
    const float* sb = scb + (size_t)b * nc * N_SUB * 4;
    for (int cr = 0; cr < nc; cr += NTHREADS) {
      // 1. the hit chunks of this round, in increasing order
      const int ci = cr + threadIdx.x;
      const int n_c = compact(ci < nc && overlaps(cb + (size_t)ci * 4, x0, x1, y0, y1), ci, clist, 0, wcnt);
      for (int k0 = 0; k0 < n_c; k0 += S_CHUNKS) {
        // 2. the hit subchunks of up to S_CHUNKS hit chunks, in increasing order
        const int k1 = min(n_c, k0 + S_CHUNKS);
        int n_s = 0;
        for (int k = k0; k < k1; k += CHUNKS_PER_PASS) {
          const int kk = k + threadIdx.x / N_SUB;
          const int gs = kk < k1 ? clist[kk] * N_SUB + threadIdx.x % N_SUB : 0;
          n_s += compact(kk < k1 && overlaps(sb + (size_t)gs * 4, x0, x1, y0, y1), gs, slist, n_s, wcnt);
        }
        // 3. walk them, staging the next one's columns meanwhile
        if (n_s > 0) stage(staged[0], table, T, slist[0]);
        for (int j = 0; j < n_s; ++j) {
          __pipeline_wait_prior(0);
          __syncthreads();  // staged[j & 1] complete; every warp is done with the other buffer
          if (j + 1 < n_s) stage(staged[(j + 1) & 1], table, T, slist[j + 1]);
          const float* rows = staged[j & 1];
          // 4. the hit rows, as a 64-bit mask
          const unsigned lo = __ballot_sync(FULL, row_overlaps(rows, lane, x0, x1, y0, y1));
          const unsigned hi = __ballot_sync(FULL, row_overlaps(rows, lane + 32, x0, x1, y0, y1));
          unsigned long long mask = (unsigned long long)lo | ((unsigned long long)hi << 32);
          const int base = slist[j] * SUB;
          while (mask != 0ull) {
            const int q = __ffsll((long long)mask) - 1;
            mask &= mask - 1ull;
            const float* t = rows + q;
            const float ax = t[0], ay = t[SUB], bx = t[2 * SUB], by = t[3 * SUB];
            const float cx = t[4 * SUB], cy = t[5 * SUB];
            // the per-row and per-column factors of the edge functions
            const float dx0 = bx - ax, dy0 = by - ay, dx1 = cx - bx, dy1 = cy - by;
            const float dx2 = ax - cx, dy2 = ay - cy;
            const float qx0 = dy0 * (gx - ax), qx1 = dy1 * (gx - bx), qx2 = dy2 * (gx - cx);
            // 5. inside first
            float e0[PIX], e1[PIX], e2[PIX];
            bool in[PIX];
            bool any = false;
#pragma unroll
            for (int p = 0; p < PIX; ++p) {
              e0[p] = dx0 * (gy[p] - ay) - qx0;
              e1[p] = dx1 * (gy[p] - by) - qx1;
              e2[p] = dx2 * (gy[p] - cy) - qx2;
              in[p] = (e0[p] <= 0.f && e1[p] <= 0.f && e2[p] <= 0.f) ||
                      (e0[p] >= 0.f && e1[p] >= 0.f && e2[p] >= 0.f);
              any |= in[p];
            }
            if (!__any_sync(FULL, any)) continue;
            const float z0 = t[6 * SUB], z1 = t[7 * SUB], z2 = t[8 * SUB];
            const int id = base + q;
#pragma unroll
            for (int p = 0; p < PIX; ++p) {
              if (!in[p]) continue;
              float denom = (e0[p] + e1[p]) + e2[p];
              denom = fabsf(denom) > 1e-9f ? denom : 1e-9f;
              const float z = ((e1[p] * z0 + e2[p] * z1) + e0[p] * z2) / denom;
              if (z > 0.f && z < 1.f && z < zbuf[p] && id != ex[p]) {
                zbuf[p] = z;
                win[p] = id;
              }
            }
          }
        }
        __syncthreads();  // slist and the buffers are rewritten by the next round
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    z_out[pixel(p)] = zbuf[p];
    win_out[pixel(p)] = win[p];
  }
}

}  // namespace

// trit [B, 16, nc * 4096] f32 (fields-major, 16-byte aligned), cbox
// [B, nc, 4] f32, scb [B, nc * 64, 4] f32, excl [B, H, W] i32 or null (no
// exclude), tile_on [B, nty * ntx] i32, z [B, H, W] f32, win [B, H, W] i32
// with H = 8 nty, W = 128 ntx. Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
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
