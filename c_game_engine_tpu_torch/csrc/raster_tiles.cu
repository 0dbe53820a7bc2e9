// Tile rasterization with in-kernel binning and attribute interpolation,
// batched over envs: each 8x128 tile lists the rows whose screen bbox
// overlaps it, and for every pixel a serial walk over that list (edge
// functions, affine z, the strictly-closer test that skips one excluded id
// per pixel) keeps the closest row, whose perspective-correct uv, lightmap
// uv, rgba, fragment depth and enc word are then interpolated.
//
// Replaces: c_game_engine_tpu/ops/raster_tiles.py::raster_tiles_pallas
// (_kernel), vmapped over envs, together with its binning pass
// bin_triangles: one launch goes from the table and tri_ok to the 12
// planes.
//
// What bounds it on an H100: the 12 output planes' bytes (4 bytes a pixel
// each, 201 MB for a 64-env 256x256 frame batch, 0.06 ms at 3.35 TB/s;
// the kernel writing only the planes takes 0.065 ms). Then instruction
// issue: the edge functions and inside test of every listed (pixel, row)
// pair (4.6 x 10^7 on pass 1 of arena_lit, about 20 instructions each
// without FMA) and the attributes of every pixel (4 IEEE divisions). The
// binning reads each ok row's box once per tile from L2 (the table of a
// 64-env arena_lit frame batch is 17 MB).
//
// Design: one block of 256 threads per (env, tile); warp r holds line r of
// the tile, a thread 4 neighbouring pixels of it.
//   1. Binning in the prologue. The block tests the rows' boxes 6 x 256 at
//      a time (tri_ok, then columns 0-5 of the ok rows, the loads of the 6
//      rounds issued together), with the compares of bin_triangles
//      (xmin <= (tx + 1) * 128, xmax >= tx * 128, and the same in y).
//      torch.amin propagates NaN and fminf drops it, so a row with a NaN
//      coordinate is flagged and never listed, as its NaN compares list it
//      nowhere. Ballot compactions write the hit ids in increasing order
//      to shared memory and stop at L = min(T, 512): a tile with more drops
//      the highest ids. A gated-off tile (tile_on 0) lists nothing.
//   2. Staging. A list of at most 2 NB = 128 rows (every tile of
//      arena_lit) is staged whole with cp.async (columns 0-39 of each row,
//      ten 16-byte copies, no integer division per element) and stays
//      there for the attributes. A longer list goes through two buffers of
//      NB rows, the next batch arriving while the current one is walked.
//   3. The walk. A row's per-line products dx * (gy - a) of the edge
//      functions are computed once for the thread's 4 pixels; every
//      product is the same value whichever pixel computes it, so each edge
//      function rounds exactly as in the plain version. The edge functions
//      and `inside` come first; the denominator, z and the division run
//      only where a pixel is inside, and a warp skips them when none of its
//      lanes' pixels is (a pixel that is not inside fails the closer test
//      whatever its z). Only z and the winner's list slot are kept.
//   4. Attributes once per pixel, from the winner's staged row (after a
//      longer list, the block lists the slots that won a pixel with a
//      ballot compaction and stages their rows again, 2 NB at a time), by
//      the expressions of the plain version; each plane of the thread's 4
//      pixels is one 16-byte store, so a warp writes a whole 512-byte line
//      (8-byte stores from 2 x 2 pixels a thread, or reading the winner's
//      row from global memory per pixel, were slower: profile_kernels.py).
//      A pixel with no winner gets the defaults. An exclude id is read
//      only in an enabled tile, and none without an exclude image.
// 64 registers a thread (4 blocks an SM; without the cap the kernel takes
// about 108 and is slower). The walk is serial per pixel with a strict
// z < zbuf, so of two rows at equal z the lower index wins, as on the TPU;
// no atomics. Built with --fmad=false, every expression rounds as in the
// plain PyTorch version in ops/raster_tiles.py, and the two agree to the
// last bit.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int N_COLS = 48;
constexpr int L_CAP = 512;
constexpr int ROW = 40;    // staged floats per row: columns 0-39
constexpr int N_COPY = 10; // 16-byte copies per staged row
constexpr int NB = 64;     // rows per staging buffer
constexpr int PIX = TILE_H * TILE_W / NTHREADS;  // 4 pixels a thread, neighbours on one line
constexpr int ROUNDS = 6;  // rounds of NTHREADS rows tested per compaction
constexpr unsigned FULL = 0xffffffffu;

// R rounds of a compaction in one: writes value[k] of every thread with
// hit[k] to list[base + rank[k]] for the ranks below `cap`, ranks in
// (round, thread) order, and returns min(base + hits, cap). Two barriers:
// the list is complete, and wcnt free, when it returns.
template <int R>
__device__ __forceinline__ int compact(const bool (&hit)[R], const int (&value)[R], int* list, int base, int cap,
                                       int (*wcnt)[NWARPS], int (&rank)[R]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned m[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    m[k] = __ballot_sync(FULL, hit[k]);
    if (lane == 0) wcnt[k][warp] = __popc(m[k]);
  }
  __syncthreads();
  int n = base;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      before += w < warp ? wcnt[k][w] : 0;
      total += wcnt[k][w];
    }
    rank[k] = n + before + __popc(m[k] & ((1u << lane) - 1u));
    if (hit[k] && rank[k] < cap) list[rank[k]] = value[k];
    n += total;
  }
  __syncthreads();
  return min(n, cap);
}

// Whether rows row[k] of the env's table are binned into the tile
// [x0, x1] x [y0, y1]: bin_triangles' test, with NaN coordinates flagged.
// The R rows' tri_ok are loaded together, then the columns 0-5 of those
// that are ok (reading every row's box instead costs more L2 bandwidth
// than the round trip it saves, profile_kernels.py).
template <int R>
__device__ __forceinline__ void binned(const float* table, const unsigned char* ok, int T, const int (&row)[R],
                                       float x0, float x1, float y0, float y1, bool (&hit)[R]) {
  bool in_t[R];
  unsigned char okv[R];
  float4 p[R];
  float2 q[R];
#pragma unroll
  for (int k = 0; k < R; ++k) in_t[k] = row[k] < T;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    okv[k] = in_t[k] ? ok[row[k]] : 0;
    p[k] = okv[k] ? *reinterpret_cast<const float4*>(table + (size_t)row[k] * N_COLS) : make_float4(0.f, 0.f, 0.f, 0.f);
    q[k] = okv[k] ? *reinterpret_cast<const float2*>(table + (size_t)row[k] * N_COLS + 4) : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const bool nan = isnan(p[k].x) || isnan(p[k].y) || isnan(p[k].z) || isnan(p[k].w) || isnan(q[k].x) ||
                     isnan(q[k].y);
    const float xmin = fminf(fminf(p[k].x, p[k].z), q[k].x), xmax = fmaxf(fmaxf(p[k].x, p[k].z), q[k].x);
    const float ymin = fminf(fminf(p[k].y, p[k].w), q[k].y), ymax = fmaxf(fmaxf(p[k].y, p[k].w), q[k].y);
    hit[k] = okv[k] != 0 && !nan && xmin <= x1 && xmax >= x0 && ymin <= y1 && ymax >= y0;
  }
}

// Stage rows rows[j0 .. j0 + nb) (nb <= CAP) into buf, columns 0-39 of
// each.
template <int CAP>
__device__ __forceinline__ void stage(float* buf, const float* table, const int* rows, int j0, int nb) {
  for (int k = threadIdx.x; k < CAP * 16; k += NTHREADS) {
    const int q = k >> 4, part = k & 15;
    if (q < nb && part < N_COPY)
      __pipeline_memcpy_async(buf + q * ROW + part * 4, table + (size_t)rows[j0 + q] * N_COLS + part * 4, 16);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(NTHREADS, 4)
raster_tiles_kernel(const float* __restrict__ tri48, const unsigned char* __restrict__ tri_ok,
                    const int* __restrict__ excl, const int* __restrict__ tile_on,
                    float* __restrict__ out_f, int* __restrict__ out_i, int B, int T, int nty, int ntx) {
  __shared__ __align__(16) float staged[2 * NB * ROW];  // two buffers of NB rows
  __shared__ int list[L_CAP];  // the tile's rows; after the walk, a winner slot's place in `wins`
  __shared__ int wins[L_CAP];  // during the walk, whether a slot won a pixel; then the winner rows
  __shared__ int wcnt[ROUNDS][NWARPS];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int ty = tile / ntx, tx = tile % ntx;
  const int H = nty * TILE_H, W = ntx * TILE_W;
  // warp r holds line r of the tile; a thread its columns c0 .. c0 + 3
  const int r = threadIdx.x >> 5, c0 = (threadIdx.x & 31) * PIX;
  const float gy = ((float)(ty * TILE_H) + (float)r) + 0.5f;
  // pixel c's centre ((float)(tx * TILE_W) + (float)(c0 + c)) + 0.5f, exactly
  const float gx0 = ((float)(tx * TILE_W) + (float)c0) + 0.5f;
  const auto gx = [&](int c) { return gx0 + (float)c; };
  const size_t plane = (size_t)B * H * W;
  const size_t pix = ((size_t)b * H + (ty * TILE_H + r)) * W + (tx * TILE_W + c0);  // the first of the 4
  const float* table = tri48 + (size_t)b * T * N_COLS;

  // 1. the tile's list
  int n = 0;
  int ex[PIX];
#pragma unroll
  for (int c = 0; c < PIX; ++c) ex[c] = -1;
  if (tile_on == nullptr || tile_on[(size_t)b * nty * ntx + tile] != 0) {
    if (excl != nullptr) {
#pragma unroll
      for (int c = 0; c < PIX; ++c) ex[c] = excl[pix + c];
    }
    const float x0 = (float)(tx * TILE_W), x1 = (float)((tx + 1) * TILE_W);
    const float y0 = (float)(ty * TILE_H), y1 = (float)((ty + 1) * TILE_H);
    const unsigned char* ok = tri_ok + (size_t)b * T;
    const int L = min(T, L_CAP);
    for (int base = 0; base < T && n < L; base += ROUNDS * NTHREADS) {
      int row[ROUNDS], rank[ROUNDS];
      bool hit[ROUNDS];
#pragma unroll
      for (int k = 0; k < ROUNDS; ++k) row[k] = base + k * NTHREADS + threadIdx.x;
      binned(table, ok, T, row, x0, x1, y0, y1, hit);
      n = compact(hit, row, list, n, L, wcnt, rank);
    }
  }

  // 2-3. stage and walk it
  float zbuf[PIX];
  int win[PIX];  // list slot of the winner
#pragma unroll
  for (int c = 0; c < PIX; ++c) {
    zbuf[c] = INFINITY;
    win[c] = -1;
  }
  // the walk over staged rows rows[0 .. nb), list slots j0 ...
  const auto walk = [&](const float* rows, int j0, int nb) {
    for (int q = 0; q < nb; ++q) {
      const float* t = rows + q * ROW;
      const float4 v0 = *reinterpret_cast<const float4*>(t);      // ax ay bx by
      const float4 v1 = *reinterpret_cast<const float4*>(t + 4);  // cx cy z0 z1
      const float ax = v0.x, ay = v0.y, bx = v0.z, by = v0.w, cx = v1.x, cy = v1.y;
      const float dy0 = by - ay, dy1 = cy - by, dy2 = ay - cy;
      // the line's factors of the three edge functions, then each column's
      const float l0 = (bx - ax) * (gy - ay), l1 = (cx - bx) * (gy - by), l2 = (ax - cx) * (gy - cy);
      float e0[PIX], e1[PIX], e2[PIX];
      bool in[PIX];
      bool any = false;
#pragma unroll
      for (int c = 0; c < PIX; ++c) {
        e0[c] = l0 - dy0 * (gx(c) - ax);
        e1[c] = l1 - dy1 * (gx(c) - bx);
        e2[c] = l2 - dy2 * (gx(c) - cx);
        in[c] = (e0[c] <= 0.f && e1[c] <= 0.f && e2[c] <= 0.f) || (e0[c] >= 0.f && e1[c] >= 0.f && e2[c] >= 0.f);
        any |= in[c];
      }
      if (!__any_sync(FULL, any)) continue;
      const float2 v2 = *reinterpret_cast<const float2*>(t + 8);  // z2 id
      const float z0 = v1.z, z1 = v1.w, z2 = v2.x;
      const int ti = (int)v2.y;
#pragma unroll
      for (int c = 0; c < PIX; ++c) {
        if (!in[c]) continue;
        float denom = (e0[c] + e1[c]) + e2[c];
        denom = fabsf(denom) > 1e-9f ? denom : 1e-9f;
        const float z = ((e1[c] * z0 + e2[c] * z1) + e0[c] * z2) / denom;
        if (z > 0.f && z < 1.f && z < zbuf[c] && ti != ex[c]) {
          zbuf[c] = z;
          win[c] = j0 + q;
        }
      }
    }
  };
  // a list of at most 2 NB rows stays staged whole: the attributes then
  // read the winners' rows where the walk did
  const bool resident = n <= 2 * NB;
  if (resident) {
    stage<2 * NB>(staged, table, list, 0, n);
    __pipeline_wait_prior(0);
    __syncthreads();
    walk(staged, 0, n);
  } else {
    for (int s = threadIdx.x; s < n; s += NTHREADS) wins[s] = 0;
    stage<NB>(staged, table, list, 0, min(NB, n));
    for (int j0 = 0, k = 0; j0 < n; j0 += NB, ++k) {
      __pipeline_wait_prior(0);
      __syncthreads();  // buffer k & 1 complete; every warp is done with the other one
      if (j0 + NB < n) stage<NB>(staged + ((k + 1) & 1) * NB * ROW, table, list, j0 + NB, min(NB, n - j0 - NB));
      walk(staged + (k & 1) * NB * ROW, j0, min(NB, n - j0));
    }
  }

  // 4. the winners' attributes, each pixel's once, from its winner's
  // staged row; a pixel with no winner gets the defaults. Plane by plane,
  // one 16-byte store for a thread's 4 pixels when they are all handled in
  // one round.
  const auto emit = [&](int w0, int mb) {
    // per pixel: its winner's staged row (-1: none or another round's)
    int at[PIX];
    bool here[PIX];
    bool all = true;
#pragma unroll
    for (int c = 0; c < PIX; ++c) {
      // the winner's row in the buffer: its slot, or where the round put it
      at[c] = win[c] < 0 ? -1 : resident ? win[c] : list[win[c]] - w0;
      here[c] = win[c] >= 0 ? at[c] >= 0 && at[c] < mb : w0 == 0;
      all &= here[c];
      if (!here[c]) at[c] = -1;
    }
    const auto put = [&](float* dst, const float (&v)[PIX]) {
      if (all) {
        *reinterpret_cast<float4*>(dst + pix) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < PIX; ++c)
          if (here[c]) dst[pix + c] = v[c];
      }
    };
    const auto put_i = [&](int* dst, const int (&v)[PIX]) {
      if (all) {
        *reinterpret_cast<int4*>(dst + pix) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < PIX; ++c)
          if (here[c]) dst[pix + c] = v[c];
      }
    };
    put(out_f, zbuf);  // float planes: z fd u v lu lv cr cg cb ca
    // fragment depth, 1 / the interpolated 1/w and the weights of the
    // perspective-correct interpolation
    float fd[PIX], pw[PIX], bw0[PIX], bw1[PIX], bw2[PIX];
#pragma unroll
    for (int c = 0; c < PIX; ++c) {
      fd[c] = pw[c] = bw0[c] = bw1[c] = bw2[c] = 0.f;
      if (at[c] < 0) continue;
      const float* t = staged + at[c] * ROW;
      const float ax = t[0], ay = t[1], bx = t[2], by = t[3], cx = t[4], cy = t[5];
      const float e0 = (bx - ax) * (gy - ay) - (by - ay) * (gx(c) - ax);
      const float e1 = (cx - bx) * (gy - by) - (cy - by) * (gx(c) - bx);
      const float e2 = (ax - cx) * (gy - cy) - (ay - cy) * (gx(c) - cx);
      float denom = (e0 + e1) + e2;
      denom = fabsf(denom) > 1e-9f ? denom : 1e-9f;
      const float b0 = e1 / denom, b1 = e2 / denom, b2 = e0 / denom;
      const float iw = (b0 * t[10] + b1 * t[11]) + b2 * t[12];
      pw[c] = 1.f / (iw < 1e-12f ? 1e-12f : iw);
      bw0[c] = b0 * t[10];
      bw1[c] = b1 * t[11];
      bw2[c] = b2 * t[12];
      fd[c] = ((b0 * t[6] + b1 * t[7]) + b2 * t[8]) * pw[c];
    }
    // the interpolation of columns k, k + step, k + 2 step of each winner
    const auto interp = [&](int k, int step, float (&v)[PIX]) {
#pragma unroll
      for (int c = 0; c < PIX; ++c) {
        const float* t = staged + max(at[c], 0) * ROW;  // row 0 for none: never read out of bounds
        v[c] = at[c] >= 0 ? ((bw0[c] * t[k] + bw1[c] * t[k + step]) + bw2[c] * t[k + 2 * step]) * pw[c] : 0.f;
      }
    };
    float v[PIX];
    int vi[PIX];
    put(out_f + plane, fd);
    interp(13, 2, v);
    put(out_f + 2 * plane, v);
    interp(14, 2, v);
    put(out_f + 3 * plane, v);
    interp(19, 2, v);
    put(out_f + 4 * plane, v);
    interp(20, 2, v);
    put(out_f + 5 * plane, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      interp(25 + k, 4, v);
      put(out_f + (6 + k) * plane, v);
    }
#pragma unroll
    for (int c = 0; c < PIX; ++c) vi[c] = at[c] >= 0 ? (int)staged[max(at[c], 0) * ROW + 9] : -1;
    put_i(out_i, vi);  // int planes: winner enc
#pragma unroll
    for (int c = 0; c < PIX; ++c) vi[c] = at[c] >= 0 ? (int)staged[max(at[c], 0) * ROW + 37] : 0;
    put_i(out_i + plane, vi);
  };
  if (resident) {
    emit(0, n);
    return;
  }
  // a longer list: the block marks the slots that won a pixel, lists them
  // in slot order and stages their rows 2 NB at a time
  __syncthreads();  // the walk is done with the buffers and the marks are zeroed
#pragma unroll
  for (int c = 0; c < PIX; ++c)
    if (win[c] >= 0) wins[win[c]] = 1;  // threads that mark one slot write the same value
  __syncthreads();
  int m = 0;
  for (int s0 = 0; s0 < n; s0 += NTHREADS) {
    const int s = s0 + threadIdx.x;
    const bool won[1] = {s < n && wins[s] != 0};
    const int row[1] = {won[0] ? list[s] : 0};
    int rank[1];
    m = compact(won, row, wins, m, L_CAP, wcnt, rank);  // rank <= s: no unread mark is overwritten
    if (won[0]) list[s] = rank[0];
  }
  for (int w0 = 0; w0 == 0 || w0 < m; w0 += 2 * NB) {
    const int mb = min(2 * NB, m - w0);
    if (w0 > 0) __syncthreads();  // every thread is done with the previous rows
    stage<2 * NB>(staged, table, wins, w0, mb);
    __pipeline_wait_prior(0);
    __syncthreads();
    emit(w0, mb);
  }
}

}  // namespace

// tri48 [B, T, 48] f32 (16-byte aligned), tri_ok [B, T] bool, excl
// [B, H, W] i32 or null (no exclude), tile_on [B, nty * ntx] i32 or null
// (every tile on), out_f [10, B, H, W] f32, out_i [2, B, H, W] i32 with
// H = 8 nty, W = 128 ntx. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int raster_tiles_launch(const void* tri48, const void* tri_ok, const void* excl, const void* tile_on,
                                   void* out_f, void* out_i, int B, int T, int nty, int ntx, void* stream) {
  if (B > 0 && T > 0 && nty > 0 && ntx > 0) {
    dim3 grid(nty * ntx, B);
    raster_tiles_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tri48, (const unsigned char*)tri_ok, (const int*)excl, (const int*)tile_on,
        (float*)out_f, (int*)out_i, B, T, nty, ntx);
  }
  return (int)cudaGetLastError();
}
