// Tile rasterization with in-kernel attribute interpolation, batched over
// envs: for every pixel, a serial walk over its 8x128 tile's triangle list
// (edge functions, affine z, the strictly-closer test that skips one
// excluded id per pixel) and, where a triangle is closer, its
// perspective-correct uv, lightmap uv, rgba, fragment depth and enc word.
//
// Replaces: c_game_engine_tpu/ops/raster_tiles.py::raster_tiles_pallas
// (_kernel), vmapped over envs.
//
// What bounds it on an H100: the 12 output planes' bytes, then the z-test
// arithmetic. Each listed (pixel, triangle) pair costs ~40 float
// operations and each covered pixel's winner ~80 more for its attributes;
// a 64-env 256x256 frame batch of arena_lit lists ~5 x 10^7 pairs (~2
// GFLOP, 0.03 ms at 67 TFLOP/s) and writes 12 planes of 4 bytes per pixel
// (~200 MB, 0.06 ms at 3.35 TB/s), while the listed triangle rows are a
// few MB. The per-env table (up to 8192 x 48 x 4 B = 1.5 MB) does not fit a
// block's shared memory.
//
// Design: one block of 256 threads per (env, tile, pair of tile rows), one
// thread per pixel, so four blocks share a tile's list and neighbouring
// threads write neighbouring pixels (whole 128-byte lines per plane). The
// block stages its list's rows through shared memory NB at a time
// (columns 0-37 only, NB * 38 floats), and every thread then reads the
// same row (a broadcast).
// Each thread walks the list in order with the strict z < zbuf test, so of
// two triangles at equal z the lower index wins, as on the TPU; the result
// is deterministic and needs no atomics. The attribute expressions are
// evaluated only where the test holds, in the order of the TPU kernel and
// of the plain PyTorch version in ops/raster_tiles.py; built with
// --fmad=false, the two agree to the last bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int SUB_H = 2;  // tile rows per block
constexpr int NTHREADS = SUB_H * TILE_W;
constexpr int N_COLS = 48;
constexpr int N_USE = 38;  // columns the kernel reads
constexpr int NB = 64;     // rows staged per batch

__global__ void __launch_bounds__(NTHREADS)
raster_tiles_kernel(const float* __restrict__ tri48, const int* __restrict__ idx,
                    const int* __restrict__ cnt, const int* __restrict__ excl,
                    float* __restrict__ out_f, int* __restrict__ out_i,
                    int B, int T, int L, int nty, int ntx) {
  __shared__ float rows[NB * N_USE];
  const int b = blockIdx.y;
  const int tile = blockIdx.x / (TILE_H / SUB_H);
  const int sub = blockIdx.x % (TILE_H / SUB_H);
  const int ty = tile / ntx, tx = tile % ntx;
  const int r = sub * SUB_H + threadIdx.x / TILE_W;
  const int c = threadIdx.x % TILE_W;
  const int H = nty * TILE_H, W = ntx * TILE_W;
  const float gx = ((float)(tx * TILE_W) + (float)c) + 0.5f;
  const float gy = ((float)(ty * TILE_H) + (float)r) + 0.5f;
  const size_t plane = (size_t)B * H * W;
  const size_t pix = ((size_t)b * H + (ty * TILE_H + r)) * W + (tx * TILE_W + c);
  const int ex = excl[pix];
  const size_t t_off = ((size_t)b * nty + ty) * ntx + tx;
  const int n = cnt[t_off];
  const int* list = idx + t_off * L;
  const float* table = tri48 + (size_t)b * T * N_COLS;

  float zbuf = INFINITY, tid = -1.f, fd = 0.f, u = 0.f, v = 0.f, lu = 0.f, lv = 0.f;
  float cr = 0.f, cg = 0.f, cb = 0.f, ca = 0.f, enc = 0.f;
  for (int j0 = 0; j0 < n; j0 += NB) {
    const int nb = min(NB, n - j0);
    __syncthreads();
    for (int k = threadIdx.x; k < nb * N_USE; k += NTHREADS) {
      const int q = k / N_USE, col = k - q * N_USE;
      rows[k] = table[(size_t)list[j0 + q] * N_COLS + col];
    }
    __syncthreads();
    for (int q = 0; q < nb; ++q) {
      const float* t = rows + q * N_USE;
      const float ax = t[0], ay = t[1], bx = t[2], by = t[3], cx = t[4], cy = t[5];
      const float e0 = (bx - ax) * (gy - ay) - (by - ay) * (gx - ax);
      const float e1 = (cx - bx) * (gy - by) - (cy - by) * (gx - bx);
      const float e2 = (ax - cx) * (gy - cy) - (ay - cy) * (gx - cx);
      const bool inside = (e0 <= 0.f && e1 <= 0.f && e2 <= 0.f) ||
                          (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f);
      float denom = (e0 + e1) + e2;
      denom = fabsf(denom) > 1e-9f ? denom : 1e-9f;
      const float z0 = t[6], z1 = t[7], z2 = t[8];
      const float z = ((e1 * z0 + e2 * z1) + e0 * z2) / denom;
      const float ti = t[9];
      const bool closer = inside && z > 0.f && z < 1.f && z < zbuf && (int)ti != ex;
      if (!closer) continue;
      zbuf = z;
      const float b0 = e1 / denom, b1 = e2 / denom, b2 = e0 / denom;
      const float iw0 = t[10], iw1 = t[11], iw2 = t[12];
      const float iw = (b0 * iw0 + b1 * iw1) + b2 * iw2;
      const float pw = 1.f / (iw < 1e-12f ? 1e-12f : iw);
      const float bw0 = b0 * iw0, bw1 = b1 * iw1, bw2 = b2 * iw2;
      tid = ti;
      fd = ((b0 * z0 + b1 * z1) + b2 * z2) * pw;
      u = ((bw0 * t[13] + bw1 * t[15]) + bw2 * t[17]) * pw;
      v = ((bw0 * t[14] + bw1 * t[16]) + bw2 * t[18]) * pw;
      lu = ((bw0 * t[19] + bw1 * t[21]) + bw2 * t[23]) * pw;
      lv = ((bw0 * t[20] + bw1 * t[22]) + bw2 * t[24]) * pw;
      cr = ((bw0 * t[25] + bw1 * t[29]) + bw2 * t[33]) * pw;
      cg = ((bw0 * t[26] + bw1 * t[30]) + bw2 * t[34]) * pw;
      cb = ((bw0 * t[27] + bw1 * t[31]) + bw2 * t[35]) * pw;
      ca = ((bw0 * t[28] + bw1 * t[32]) + bw2 * t[36]) * pw;
      enc = t[37];
    }
  }
  // float planes: z fd u v lu lv cr cg cb ca; int planes: winner enc
  out_f[pix] = zbuf;
  out_f[plane + pix] = fd;
  out_f[2 * plane + pix] = u;
  out_f[3 * plane + pix] = v;
  out_f[4 * plane + pix] = lu;
  out_f[5 * plane + pix] = lv;
  out_f[6 * plane + pix] = cr;
  out_f[7 * plane + pix] = cg;
  out_f[8 * plane + pix] = cb;
  out_f[9 * plane + pix] = ca;
  out_i[pix] = (int)tid;
  out_i[plane + pix] = (int)enc;
}

}  // namespace

// tri48 [B, T, 48] f32, idx [B, nty, ntx, L] i32 (entries < T), cnt
// [B, nty, ntx] i32 (<= L), excl [B, H, W] i32, out_f [10, B, H, W] f32,
// out_i [2, B, H, W] i32 with H = 8 nty, W = 128 ntx. Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int raster_tiles_launch(const void* tri48, const void* idx, const void* cnt,
                                   const void* excl, void* out_f, void* out_i, int B,
                                   int T, int L, int nty, int ntx, void* stream) {
  if (B > 0 && nty > 0 && ntx > 0) {
    dim3 grid(nty * ntx * (TILE_H / SUB_H), B);
    raster_tiles_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tri48, (const int*)idx, (const int*)cnt, (const int*)excl,
        (float*)out_f, (int*)out_i, B, T, L, nty, ntx);
  }
  return (int)cudaGetLastError();
}
