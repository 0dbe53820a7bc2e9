// Capsule penetration-resolve against the static triangle soup and the
// solid actor OBBs: 4 iterations of deepest-contact push, inward-velocity
// clip and walkable grounding per env.
//
// Replaces: c_game_engine_tpu/ops/capsule_resolve.py::resolve_capsule_pallas
// (_kernel, _chunk_best, _closest_on_tri, _first_row).
//
// What bounds it on an H100: instruction issue and latency, not bytes.
// Each env tests the ~130 triangles of its 128-lane block's chunk list 4
// times, at ~380 flops a test (3 dependent closest-point projections, 15
// IEEE divisions and a square root; built without FMA), and its 16 or so
// solid boxes; the inputs of the main 8192-lane call are a few hundred KB,
// and the ~330 KB triangle table of a 5k-triangle map stays in L2. One
// thread per env walking the rows one after another left the card
// latency-bound: 64 blocks of 4 warps on 132 SMs, each thread a chain of
// ~525 dependent triangle tests. Now the triangle arithmetic is about half
// the time and the row and box reads, reductions and the push the other
// half; registers and block shape barely move it (profile_contacts.py;
// PERF.md §6).
//
// Design: one warp per env lane, W = 4 warps (lanes) per block, all in one
// 128-lane env block, so they share its compacted chunk list
// (ops/chunk_compact.py, margin 1.0); 8192 lanes are 2,048 blocks. A chunk
// is 32 triangles, one per thread: in listed chunk j thread t tests row t,
// read as four 16-byte loads, so a warp reads the 2 KB chunk in one sweep
// and the warps of a block hit it in L1. Each thread keeps a running best
// with a strict `>` in list order, keyed j * 32 + t; a warp argmax on
// (depth, key), larger depth first and then the smaller key, gives exactly
// the serial walk's "first deepest contact wins" (a reduction that broke
// ties by thread would hand a tie between chunk 0 row 20 and chunk 1 row 2
// to the later row). NaN and invalid rows (-1e30) never enter a thread's
// best. The boxes go the same way, thread t taking boxes t, t + 32, ...,
// ranked by (depth, box index) over non-NaN depths, with box 0 always the
// serial walk's first candidate; a box replaces the triangle winner only
// when strictly deeper. Every thread then applies the same push, velocity
// clip and grounding, so the warp stays uniform through the 4 iterations,
// and thread 0 writes the lane's results. No shared memory, no barrier, no
// atomics: runs are bitwise repeatable. Built with --fmad=false, the
// per-row arithmetic (contact_math.cuh, the same expressions in the same
// order) rounds exactly as the plain PyTorch version in
// ops/capsule_resolve.py.

#include <cuda_runtime.h>
#include <math.h>

#include "contact_math.cuh"

namespace {

using namespace contact;

constexpr int BLK = 128;  // lanes of an env block (one chunk list)
constexpr int WARPS = 4;  // lanes (warps) per CUDA block
constexpr int ITERS = 4;
constexpr float RADIUS = 0.2f;
constexpr float HALF_HEIGHT = 0.25f;
constexpr float MAX_SLOPE_COS = 0.6427876097f;
constexpr int KEY_NONE = 0x7fffffff;  // above every row's and box's key

// Capsule (vertical segment through p, y in [sy0, sy1]) vs one triangle
// row: depth along the oriented contact normal (TPU _chunk_best per row).
__device__ __forceinline__ void tri_contact(float px, float py, float pz,
                                            float sy0, float sy1,
                                            const float* t, float& depth,
                                            float& nx, float& ny, float& nz) {
  float qx, qy, qz;
  closest_on_tri(px, py, pz, t, qx, qy, qz);
  // 2 alternating-projection rounds (exact for face contacts)
  for (int k = 0; k < 2; ++k) {
    const float spy = clipf(qy, sy0, sy1);
    closest_on_tri(px, spy, pz, t, qx, qy, qz);
  }
  const float spy = clipf(qy, sy0, sy1);
  const float dx = px - qx, dy = spy - qy, dz = pz - qz;
  const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inv = 1.f / fmaxf(dist, 1e-9f);
  const float rx = dx * inv, ry = dy * inv, rz = dz * inv;
  const float fnx = t[9], fny = t[10], fnz = t[11];
  float side = signf((px - t[0]) * fnx + (py - t[1]) * fny + (pz - t[2]) * fnz);
  side = side == 0.f ? 1.f : side;
  float flip = signf(rx * fnx + ry * fny + rz * fnz) * side;
  flip = flip == 0.f ? 1.f : flip;
  if (dist > 1e-6f) {
    nx = rx * flip; ny = ry * flip; nz = rz * flip;
  } else {
    nx = fnx * side; ny = fny * side; nz = fnz * side;
  }
  const float sgn = dx * nx + dy * ny + dz * nz;
  depth = t[12] > 0.5f ? RADIUS - sgn : NEG_BIG;
}

struct Obb {
  float ox, oy, oz, qx, qy, qz, qw, hx, hy, hz;
};

__device__ __forceinline__ void obb_closest(const Obb& b, float wx, float wy,
                                            float wz, float& gx, float& gy,
                                            float& gz) {
  float lx, ly, lz;
  qrot(-b.qx, -b.qy, -b.qz, b.qw, wx - b.ox, wy - b.oy, wz - b.oz, lx, ly, lz);
  lx = clipf(lx, -b.hx, b.hx);
  ly = clipf(ly, -b.hy, b.hy);
  lz = clipf(lz, -b.hz, b.hz);
  qrot(b.qx, b.qy, b.qz, b.qw, lx, ly, lz, gx, gy, gz);
  gx = gx + b.ox; gy = gy + b.oy; gz = gz + b.oz;
}

// Box n of `lane` from box8 [8, n_box, B] and boxh [4, n_box, B].
__device__ __forceinline__ void load_box(const float* __restrict__ box8,
                                         const float* __restrict__ boxh,
                                         int n_box, int B, int n, int lane,
                                         Obb& b, float& mask) {
  const size_t o = (size_t)n * B + lane;
  const size_t s = (size_t)n_box * B;
  b.ox = box8[o]; b.oy = box8[s + o]; b.oz = box8[2 * s + o];
  b.qx = box8[3 * s + o]; b.qy = box8[4 * s + o];
  b.qz = box8[5 * s + o]; b.qw = box8[6 * s + o];
  mask = box8[7 * s + o];
  b.hx = boxh[o]; b.hy = boxh[s + o]; b.hz = boxh[2 * s + o];
}

__global__ void __launch_bounds__(WARPS * 32)
capsule_resolve_kernel(const float* __restrict__ tri16,
                       const int* __restrict__ idx, const int* __restrict__ cnt,
                       int nc, const float* __restrict__ box8,
                       const float* __restrict__ boxh, int n_box,
                       const float* __restrict__ pos,
                       const float* __restrict__ vel,
                       float* __restrict__ pos_out,
                       float* __restrict__ vel_out,
                       bool* __restrict__ grounded_out, int B) {
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * WARPS + (threadIdx.x >> 5);  // B % BLK == 0
  const int g = lane / BLK;
  float px = pos[lane * 3 + 0], py = pos[lane * 3 + 1], pz = pos[lane * 3 + 2];
  float vx = vel[lane * 3 + 0], vy = vel[lane * 3 + 1], vz = vel[lane * 3 + 2];
  bool grounded = false;
  const int n_chunks = cnt[g];
  const int* list = idx + (size_t)g * nc;

  for (int it = 0; it < ITERS; ++it) {
    const float sy0 = py - HALF_HEIGHT;
    const float sy1 = py + HALF_HEIGHT;

    // triangles: row t of each listed chunk, first deepest in list order
    float best = NEG_BIG, wnx = 0.f, wny = 1.f, wnz = 0.f;
    int key = KEY_NONE;
    for (int j = 0; j < n_chunks; ++j) {
      float row[16];
      load_row(tri16, list[j], t, row);
      float d, nx, ny, nz;
      tri_contact(px, py, pz, sy0, sy1, row, d, nx, ny, nz);
      if (d > best) { best = d; key = j * T_CHUNK + t; wnx = nx; wny = ny; wnz = nz; }
    }
    key = warp_argmax(best, key);
    const int src = key & 31;  // KEY_NONE: every thread holds (0, 1, 0)
    best = __shfl_sync(FULL, best, src);
    wnx = __shfl_sync(FULL, wnx, src);
    wny = __shfl_sync(FULL, wny, src);
    wnz = __shfl_sync(FULL, wnz, src);

    // solid boxes: alternating projection segment <-> OBB; the serial
    // walk takes box 0, then any strictly deeper box
    float bb = -INFINITY, bbx = 0.f, bby = 0.f, bbz = 0.f;
    int bkey = KEY_NONE;
    bool box0_nan = false;
    for (int n = t; n < n_box; n += 32) {
      Obb b;
      float mask;
      load_box(box8, boxh, n_box, B, n, lane, b, mask);
      float qx, qy, qz;
      obb_closest(b, px, py, pz, qx, qy, qz);
      for (int k = 0; k < 2; ++k) {
        const float spy = clipf(qy, sy0, sy1);
        obb_closest(b, px, spy, pz, qx, qy, qz);
      }
      const float spy = clipf(qy, sy0, sy1);
      const float dx = px - qx, dy = spy - qy, dz = pz - qz;
      const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
      const float inv = 1.f / fmaxf(dist, 1e-9f);
      const float d = mask > 0.5f ? RADIUS - dist : NEG_BIG;
      box0_nan = box0_nan | ((n == 0) & (d != d));
      if (d == d && (bkey == KEY_NONE || d > bb)) {
        bb = d; bkey = n; bbx = dx * inv; bby = dy * inv; bbz = dz * inv;
      }
    }
    if (n_box > 0) {
      bkey = warp_argmax(bb, bkey);
      const int bsrc = bkey & 31;
      bb = __shfl_sync(FULL, bb, bsrc);
      bbx = __shfl_sync(FULL, bbx, bsrc);
      bby = __shfl_sync(FULL, bby, bsrc);
      bbz = __shfl_sync(FULL, bbz, bsrc);
      // a NaN box 0 stays the serial walk's winner, and NaN is never deeper
      if (__shfl_sync(FULL, (int)box0_nan, 0)) bb = NAN;
      if (bb > best) { best = bb; wnx = bbx; wny = bby; wnz = bbz; }
    }

    const bool hit = best > -0.01f;
    const float push = hit ? fmaxf(best, 0.f) : 0.f;
    px = px + wnx * push;
    py = py + wny * push;
    pz = pz + wnz * push;
    const float vn = vx * wnx + vy * wny + vz * wnz;
    if (hit & (vn < 0.f)) {
      vx = vx - wnx * vn;
      vy = vy - wny * vn;
      vz = vz - wnz * vn;
    }
    grounded = grounded | (hit & (wny >= MAX_SLOPE_COS));
  }
  if (t == 0) {
    pos_out[lane * 3 + 0] = px; pos_out[lane * 3 + 1] = py; pos_out[lane * 3 + 2] = pz;
    vel_out[lane * 3 + 0] = vx; vel_out[lane * 3 + 1] = vy; vel_out[lane * 3 + 2] = vz;
    grounded_out[lane] = grounded;
  }
}

}  // namespace

// tri16 [T, 16] f32, 16-byte aligned (T >= 32 * nc), idx [B/128, nc] i32,
// cnt [B/128] i32, box8 [8, n_box, B] f32, boxh [4, n_box, B] f32, pos/vel
// [B, 3] f32, outputs pos/vel [B, 3] f32 and grounded [B] bool; B a
// multiple of 128. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for a misaligned table).
extern "C" int capsule_resolve_launch(const void* tri16, const void* idx,
                                      const void* cnt, int nc,
                                      const void* box8, const void* boxh,
                                      int n_box, const void* pos,
                                      const void* vel, void* pos_out,
                                      void* vel_out, void* grounded, int B,
                                      void* stream) {
  if ((size_t)tri16 % 16) return (int)cudaErrorInvalidValue;
  const int blocks = B / WARPS;
  if (blocks > 0) {
    capsule_resolve_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)tri16, (const int*)idx, (const int*)cnt, nc,
        (const float*)box8, (const float*)boxh, n_box, (const float*)pos,
        (const float*)vel, (float*)pos_out, (float*)vel_out, (bool*)grounded,
        B);
  }
  return (int)cudaGetLastError();
}
