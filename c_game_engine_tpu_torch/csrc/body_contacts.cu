// Top-K support contacts of the dynamic bodies against the static triangle
// soup: per (env lane, body), the K = 4 deepest contacts over the triangles
// of the body's compacted chunk list, with the closed-form box support or
// the max over the body's vertex cloud, and the active-edge normal fix.
//
// Replaces: c_game_engine_tpu/ops/body_contacts.py::body_contacts_pallas
// (_kernel, _feature_active).
//
// What bounds it on an H100: instruction issue, not bytes. Each awake
// (lane, body) pair tests the ~100 triangles of its block's chunk list at
// ~260 flops each (a closest-point projection with 5 IEEE divisions, a
// square root, the support radius, the barycentric edge test; built
// without FMA), plus ~7 flops per cloud vertex for hull bodies; the inputs
// of one 4096-lane call are a few MB and the ~330 KB triangle table of a
// 5k-triangle map stays in L2. The serial kernel (one thread per (lane,
// body), 32 rows a chunk one after another, a serial insertion per row)
// already kept the rows' arithmetic SIMT-efficient, so the warp design
// gains only what it saves around it: off pairs, the per-row insertion,
// and latency hidden by many more warps. Registers and block shape do
// not help (profile_contacts.py; PERF.md §6).
//
// Design: one warp per (env lane, body slot). A block is W = 4 warps of
// one body slot and one 128-lane env block, so they share the chunk list
// (ops/chunk_compact.py, margin = the body's half-extent diagonal + 0.35)
// and the body's vertex cloud, which a hull body's block stages in shared
// memory before the block's one barrier; the grid is (B / W, D). A warp
// whose pair is off (asleep, absent or padding) skips to writing the empty
// buffer: the test is uniform across the warp. Thread t tests row t of
// each listed chunk (four 16-byte loads; a warp reads the 2 KB chunk in
// one sweep). The contact, the support radius and the active-edge fix are
// the serial kernel's expressions in the same order. The contacts are kept
// in the TPU kernel's two levels: the chunk's top 4 is up to 4 rounds of a
// warp argmax on (depth, row), the larger depth first and then the smaller
// row, the winner's entry masked to -1e30 after each round (the TPU's
// repeated max with _first_row); each round's candidate is bubbled with a
// strict `>` at every slot into the running top 4. The bubble is not a
// stable merge: an entry displaced by a deeper one keeps its slot-by-slot
// comparison, so of two equal entries the later one can survive, which is
// what the TPU kernel does. A round whose candidate is no deeper than slot
// 3 ends the chunk, since no later round's can enter. The running top 4 is
// spread over the warp: its four depths in every thread, and field f of
// slot s in thread 4 f + s, which is also where that value is written in
// the [8, D*K, B] output. The rounds bubble the depths alone and track
// where each slot's entry comes from; the fields move once a chunk, an old
// entry by one shuffle and a new one from the chunk's contacts staged per
// warp in shared memory (1 KB). Rows at -1e30 (invalid) and NaN never
// enter. No atomics, so runs are bitwise repeatable. Built with
// --fmad=false, the arithmetic rounds exactly as the plain PyTorch version
// in ops/body_contacts.py.

#include <cuda_runtime.h>

#include "contact_math.cuh"

namespace {

using namespace contact;

constexpr int BLK = 128;  // lanes of an env block (one chunk list)
constexpr int WARPS = 4;  // (lane, body) pairs (warps) per CUDA block
constexpr int K = 4;
constexpr float EDGE_EPS = 1e-3f;
constexpr int MAX_V = 256;

// Closest point qt on an interior point or an active edge/vertex of t
// (compiler/edges.py flags in t[13..15]: AB, BC, CA).
__device__ __forceinline__ bool feature_active(float qtx, float qty,
                                               float qtz, const float* t) {
  const float ax = t[0], ay = t[1], az = t[2];
  const float v0x = t[3] - ax, v0y = t[4] - ay, v0z = t[5] - az;
  const float v1x = t[6] - ax, v1y = t[7] - ay, v1z = t[8] - az;
  const float v2x = qtx - ax, v2y = qty - ay, v2z = qtz - az;
  const float d00 = v0x * v0x + v0y * v0y + v0z * v0z;
  const float d01 = v0x * v1x + v0y * v1y + v0z * v1z;
  const float d11 = v1x * v1x + v1y * v1y + v1z * v1z;
  const float d20 = v2x * v0x + v2y * v0y + v2z * v0z;
  const float d21 = v2x * v1x + v2y * v1y + v2z * v1z;
  const float den = d00 * d11 - d01 * d01;
  const float inv_den = 1.f / (fabsf(den) > 1e-12f ? den : 1e-12f);
  const float v = (d11 * d20 - d01 * d21) * inv_den;
  const float w = (d00 * d21 - d01 * d20) * inv_den;
  const float u = 1.f - v - w;
  const bool on_ab = w < EDGE_EPS;
  const bool on_bc = u < EDGE_EPS;
  const bool on_ca = v < EDGE_EPS;
  const bool interior = !(on_ab | on_bc | on_ca);
  return interior | (on_ab & (t[13] > 0.5f)) | (on_bc & (t[14] > 0.5f)) |
         (on_ca & (t[15] > 0.5f));
}

__global__ void __launch_bounds__(WARPS * 32)
body_contacts_kernel(const float* __restrict__ tri16,
                     const int* __restrict__ idx, const int* __restrict__ cnt,
                     int nc, const float* __restrict__ body,
                     const float* __restrict__ verts,
                     const int* __restrict__ is_box, int V, int D,
                     float* __restrict__ out, int B) {
  __shared__ float cloud[MAX_V * 3];
  __shared__ float rowf[WARPS][T_CHUNK][8];  // a chunk's contacts, per warp
  const int tid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * WARPS + warp;  // B % BLK == 0
  const int g = lane / BLK;
  const int d = blockIdx.y;
  const int G = B / BLK;
  const bool box = is_box[d] != 0;
  if (!box) {
    for (int k = threadIdx.x; k < V * 3; k += WARPS * 32)
      cloud[k] = verts[(size_t)d * V * 3 + k];
  }
  __syncthreads();  // the last barrier: warps may leave after it

  const size_t plane = (size_t)D * B;
  const float* row_b = body + (size_t)d * B + lane;
  const bool on = row_b[10 * plane] > 0.5f;
  // field f of slot s of the running top K: (depth, nx, ny, nz, px, py,
  // pz, pad), empty = (-1e30, 0, 1, 0, 0, 0, 0, 0)
  const int f = tid >> 2, s = tid & 3;
  float mine = f == 0 ? NEG_BIG : (f == 2 ? 1.f : 0.f);
  if (on) {
    const float ccx = row_b[0], ccy = row_b[plane], ccz = row_b[2 * plane];
    const float qx = row_b[3 * plane], qy = row_b[4 * plane];
    const float qz = row_b[5 * plane], qw = row_b[6 * plane];
    const float hx = row_b[7 * plane], hy = row_b[8 * plane];
    const float hz = row_b[9 * plane];
    const float bvx = row_b[11 * plane], bvy = row_b[12 * plane];
    const float bvz = row_b[13 * plane];
    float bd[K];  // the slots' depths, the same in every thread
#pragma unroll
    for (int q = 0; q < K; ++q) bd[q] = NEG_BIG;

    const int n_chunks = cnt[d * G + g];
    const int* list = idx + ((size_t)d * G + g) * nc;
    for (int j = 0; j < n_chunks; ++j) {
      float t[16];
      load_row(tri16, list[j], tid, t);
      float qtx, qty, qtz;
      closest_on_tri(ccx, ccy, ccz, t, qtx, qty, qtz);
      const float dx = ccx - qtx, dy = ccy - qty, dz = ccz - qtz;
      const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
      const float inv = 1.f / fmaxf(dist, 1e-9f);
      const float rx = dx * inv, ry = dy * inv, rz = dz * inv;
      const float fnx = t[9], fny = t[10], fnz = t[11];
      float side =
          signf((ccx - t[0]) * fnx + (ccy - t[1]) * fny + (ccz - t[2]) * fnz);
      side = side == 0.f ? 1.f : side;
      float flip = signf(rx * fnx + ry * fny + rz * fnz) * side;
      flip = flip == 0.f ? 1.f : flip;
      float nx, ny, nz;
      if (dist > 1e-6f) {
        nx = rx * flip; ny = ry * flip; nz = rz * flip;
      } else {
        nx = fnx * side; ny = fny * side; nz = fnz * side;
      }
      const float fx = fnx * side, fy = fny * side, fz = fnz * side;
      float lx, ly, lz;
      qrot(-qx, -qy, -qz, qw, nx, ny, nz, lx, ly, lz);
      float r_sup;
      if (box) {
        r_sup = fabsf(lx) * hx + fabsf(ly) * hy + fabsf(lz) * hz;
      } else {
        r_sup = -(cloud[0] * lx + cloud[1] * ly + cloud[2] * lz);
        for (int v = 1; v < V; ++v) {
          const float sv =
              -(cloud[3 * v] * lx + cloud[3 * v + 1] * ly + cloud[3 * v + 2] * lz);
          r_sup = fmaxf(r_sup, sv);
        }
      }
      const float sgn = dx * nx + dy * ny + dz * nz;
      const float depth = t[12] > 0.5f ? r_sup - sgn : NEG_BIG;
      const float align = nx * fx + ny * fy + nz * fz;
      const float vdotf = bvx * fx + bvy * fy + bvz * fz;
      const float vt2 = bvx * bvx + bvy * bvy + bvz * bvz - vdotf * vdotf;
      if ((depth > -0.02f) & (align > 0.7f) & (vt2 > 0.0025f) &&
          !feature_active(qtx, qty, qtz, t)) {
        nx = fx; ny = fy; nz = fz;
      }

      // the chunk's top K, deepest first, each bubbled into the running K,
      // on the depths alone; src[q] is where slot q's entry comes from
      // (0..K-1 a slot at the chunk's start, K + k round k's candidate,
      // row rk[k])
      __syncwarp();  // the previous chunk's fields are read
      float* const my_row = rowf[warp][tid];
      my_row[0] = depth; my_row[1] = nx; my_row[2] = ny; my_row[3] = nz;
      my_row[4] = qtx; my_row[5] = qty; my_row[6] = qtz; my_row[7] = 0.f;
      __syncwarp();
      float w = depth > NEG_BIG ? depth : NEG_BIG;  // NaN never enters
      int src[K], rk[K];
#pragma unroll
      for (int q = 0; q < K; ++q) { src[q] = q; rk[q] = 0; }
      bool moved_any = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = warp_argmax(w, tid);
        const float m = __shfl_sync(FULL, w, r);
        if (!(m > bd[K - 1])) break;  // this and every later pick stay out
        if (tid == r) w = NEG_BIG;
        rk[k] = r;
        moved_any = true;
        float cd = m;
        int cs = K + k;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (cd > bd[q]) {
            const float od = bd[q];
            const int os = src[q];
            bd[q] = cd; src[q] = cs;
            cd = od; cs = os;
          }
        }
      }
      if (moved_any) {
        const int from = s == 0 ? src[0] : s == 1 ? src[1] : s == 2 ? src[2] : src[3];
        const float moved = __shfl_sync(FULL, mine, (tid & ~3) | (from & 3));
        const int cr = from == K ? rk[0] : from == K + 1 ? rk[1] : from == K + 2 ? rk[2] : rk[3];
        mine = from >= K ? rowf[warp][cr][f] : moved;
      }
    }
  }
  out[(size_t)(f * D * K + d * K + s) * B + lane] = mine;
}

}  // namespace

// tri16 [T, 16] f32, 16-byte aligned (T >= 32 * nc; columns 13-15 the
// active-edge flags), idx [D, B/128, nc] i32, cnt [D, B/128] i32, body
// [16, D, B] f32, verts [D, V, 3] f32 (V <= 256), is_box [D] i32, output
// [8, D*4, B] f32; B a multiple of 128. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue for V > 256
// or a misaligned table).
extern "C" int body_contacts_launch(const void* tri16, const void* idx,
                                    const void* cnt, int nc, const void* body,
                                    const void* verts, const void* is_box,
                                    int V, int D, void* out, int B,
                                    void* stream) {
  if (V < 1 || V > MAX_V || (size_t)tri16 % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid(B / WARPS, D);
  if (grid.x > 0 && D > 0) {
    body_contacts_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)tri16, (const int*)idx, (const int*)cnt, nc,
        (const float*)body, (const float*)verts, (const int*)is_box, V, D,
        (float*)out, B);
  }
  return (int)cudaGetLastError();
}
