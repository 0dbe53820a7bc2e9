// Top-K support contacts of the dynamic bodies against the static triangle
// soup: per (env lane, body), the K = 4 deepest contacts over the triangles
// of the body's compacted chunk list, with the closed-form box support or
// the max over the body's vertex cloud, and the active-edge normal fix.
//
// Replaces: c_game_engine_tpu/ops/body_contacts.py::body_contacts_pallas
// (_kernel, _feature_active).
//
// What bounds it on an H100: arithmetic and latency, not bytes. Each awake
// (lane, body) pair tests the ~100-200 triangles of its block's chunk list
// at ~260 flops each (a closest-point projection, the support radius, the
// barycentric edge test), plus ~7 flops per cloud vertex for hull bodies;
// the inputs of one 4096-lane call are a few MB and every triangle row is
// shared by the 128 threads of a block. The triangle table of a 5k-triangle
// map (~330 KB) does not fit in the 227 KB of shared memory a block can
// have, so it cannot stay resident the way the TPU kept it in VMEM.
//
// Design: a grid of (B/128 env blocks) x (D bodies), 128 threads, one
// thread per (lane, body). The block walks the body's compacted chunk list
// for its env block (ops/chunk_compact.py, margin = the body's half-extent
// diagonal + 0.35), staging each 32-triangle chunk (2 KB) in shared memory
// for all 128 threads, which then read the same row (a broadcast). The
// body's vertex cloud sits in shared memory too; its `is_box` flag picks
// the closed form per body, as the TPU kernel's compile-time tuple did.
// Each thread keeps its contacts in registers, in the TPU kernel's two
// levels: the chunk's top 4 (a stable insertion of its 32 rows, so an
// earlier row wins a tie: the TPU's repeated first-row max), then those
// four, deepest first, bubbled into the running top 4 with a strict `>` at
// every slot. The bubble is not a stable merge: an entry displaced by a
// deeper one keeps its slot-by-slot comparison, so of two equal entries the
// later one can survive. One bubble over all triangles therefore differs
// from the TPU whenever a deeper contact arrives after two equal ones; the
// two levels reproduce it. No atomics, so runs are bitwise repeatable.
// A lane whose body is off skips the arithmetic (its depth would be -1e30,
// which never enters the buffer). Built with --fmad=false, the arithmetic
// rounds exactly as the plain PyTorch version in ops/body_contacts.py.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 128;
constexpr int T_CHUNK = 32;
constexpr int K = 4;
constexpr float NEG_BIG = -1e30f;
constexpr float EDGE_EPS = 1e-3f;
constexpr int MAX_V = 256;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// Ericson closest point on triangle t (rows ax..cz) to p.
__device__ __forceinline__ void closest_on_tri(float px, float py, float pz,
                                               const float* t, float& qx,
                                               float& qy, float& qz) {
  const float ax = t[0], ay = t[1], az = t[2];
  const float bx = t[3], by = t[4], bz = t[5];
  const float cx = t[6], cy = t[7], cz = t[8];
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  const float apx = px - ax, apy = py - ay, apz = pz - az;
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float bpx = px - bx, bpy = py - by, bpz = pz - bz;
  const float d3 = abx * bpx + aby * bpy + abz * bpz;
  const float d4 = acx * bpx + acy * bpy + acz * bpz;
  const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
  const float d5 = abx * cpx + aby * cpy + abz * cpz;
  const float d6 = acx * cpx + acy * cpy + acz * cpz;
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float denom = fmaxf(va + vb + vc, 1e-30f);
  const float v_f = vb / denom;
  const float w_f = vc / denom;
  qx = ax + abx * v_f + acx * w_f;
  qy = ay + aby * v_f + acy * w_f;
  qz = az + abz * v_f + acz * w_f;
  const float t_ab = clipf(d1 / fmaxf(d1 - d3, 1e-30f), 0.f, 1.f);
  const float t_ac = clipf(d2 / fmaxf(d2 - d6, 1e-30f), 0.f, 1.f);
  const float t_bc =
      clipf((d4 - d3) / fmaxf((d4 - d3) + (d5 - d6), 1e-30f), 0.f, 1.f);
  // later regions override earlier ones, as the jnp.where chain does
  if ((vc <= 0.f) & (d1 >= 0.f) & (d3 <= 0.f)) {
    qx = ax + abx * t_ab; qy = ay + aby * t_ab; qz = az + abz * t_ab;
  }
  if ((vb <= 0.f) & (d2 >= 0.f) & (d6 <= 0.f)) {
    qx = ax + acx * t_ac; qy = ay + acy * t_ac; qz = az + acz * t_ac;
  }
  if ((va <= 0.f) & (d4 - d3 >= 0.f) & (d5 - d6 >= 0.f)) {
    qx = bx + (cx - bx) * t_bc;
    qy = by + (cy - by) * t_bc;
    qz = bz + (cz - bz) * t_bc;
  }
  if ((d1 <= 0.f) & (d2 <= 0.f)) { qx = ax; qy = ay; qz = az; }
  if ((d3 >= 0.f) & (d4 <= d3)) { qx = bx; qy = by; qz = bz; }
  if ((d6 >= 0.f) & (d5 <= d6)) { qx = cx; qy = cy; qz = cz; }
}

// Rotate v by (qx, qy, qz, qw) in the TPU kernel's term order (_qrot).
__device__ __forceinline__ void qrot(float qx, float qy, float qz, float qw,
                                     float vx, float vy, float vz, float& ox,
                                     float& oy, float& oz) {
  const float tx = 2.f * (qy * vz - qz * vy);
  const float ty = 2.f * (qz * vx - qx * vz);
  const float tz = 2.f * (qx * vy - qy * vx);
  ox = vx + qw * tx + qy * tz - qz * ty;
  oy = vy + qw * ty + qz * tx - qx * tz;
  oz = vz + qw * tz + qx * ty - qy * tx;
}

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

struct Contact {
  float d, nx, ny, nz, px, py, pz;
};

// The TPU kernel's running-buffer insertion: c bubbles down the buffer,
// changing places with every entry it is strictly deeper than.
__device__ __forceinline__ void bubble(Contact (&buf)[K], Contact c) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (c.d > buf[s].d) {
      const Contact t = buf[s];
      buf[s] = c;
      c = t;
    }
  }
}

// Stable insertion: c goes after every entry at least as deep and the
// entries after it move down one slot (an earlier candidate wins a tie).
__device__ __forceinline__ void insert_stable(Contact (&buf)[K], Contact c) {
  bool placed = false;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    placed = placed || c.d > buf[s].d;
    if (placed) {
      const Contact t = buf[s];
      buf[s] = c;
      c = t;
    }
  }
}

__global__ void __launch_bounds__(BLK)
body_contacts_kernel(const float* __restrict__ tri16,
                     const int* __restrict__ idx, const int* __restrict__ cnt,
                     int nc, const float* __restrict__ body,
                     const float* __restrict__ verts,
                     const int* __restrict__ is_box, int V, int D,
                     float* __restrict__ out, int B) {
  __shared__ float tile[T_CHUNK * 16];
  __shared__ float cloud[MAX_V * 3];
  const int g = blockIdx.x;
  const int d = blockIdx.y;
  const int G = gridDim.x;
  const int lane = g * BLK + threadIdx.x;  // B is a multiple of BLK
  const size_t plane = (size_t)D * B;
  const float* row = body + (size_t)d * B + lane;
  const float ccx = row[0], ccy = row[plane], ccz = row[2 * plane];
  const float qx = row[3 * plane], qy = row[4 * plane];
  const float qz = row[5 * plane], qw = row[6 * plane];
  const float hx = row[7 * plane], hy = row[8 * plane], hz = row[9 * plane];
  const bool on = row[10 * plane] > 0.5f;
  const float bvx = row[11 * plane], bvy = row[12 * plane];
  const float bvz = row[13 * plane];
  const bool box = is_box[d] != 0;
  for (int k = threadIdx.x; k < V * 3; k += BLK)
    cloud[k] = verts[(size_t)d * V * 3 + k];

  const Contact empty = {NEG_BIG, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f};
  Contact best[K];
#pragma unroll
  for (int s = 0; s < K; ++s) best[s] = empty;

  const int n_chunks = cnt[d * G + g];
  const int* list = idx + ((size_t)d * G + g) * nc;
  for (int j = 0; j < n_chunks; ++j) {
    const float* src = tri16 + (size_t)list[j] * (T_CHUNK * 16);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < T_CHUNK * 16; k += BLK) tile[k] = src[k];
    __syncthreads();
    if (!on) continue;
    Contact chunk[K];
#pragma unroll
    for (int s = 0; s < K; ++s) chunk[s] = empty;
    for (int r = 0; r < T_CHUNK; ++r) {
      const float* t = tile + r * 16;
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
          const float s =
              -(cloud[3 * v] * lx + cloud[3 * v + 1] * ly + cloud[3 * v + 2] * lz);
          r_sup = fmaxf(r_sup, s);
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
      insert_stable(chunk, Contact{depth, nx, ny, nz, qtx, qty, qtz});
    }
#pragma unroll
    for (int s = 0; s < K; ++s) bubble(best, chunk[s]);
  }

  const size_t ch = (size_t)D * K * B;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float* o = out + (size_t)(d * K + s) * B + lane;
    o[0] = best[s].d;
    o[ch] = best[s].nx;
    o[2 * ch] = best[s].ny;
    o[3 * ch] = best[s].nz;
    o[4 * ch] = best[s].px;
    o[5 * ch] = best[s].py;
    o[6 * ch] = best[s].pz;
    o[7 * ch] = 0.f;
  }
}

}  // namespace

// tri16 [T, 16] f32 (T >= 32 * nc; columns 13-15 the active-edge flags),
// idx [D, B/128, nc] i32, cnt [D, B/128] i32, body [16, D, B] f32,
// verts [D, V, 3] f32 (V <= 256), is_box [D] i32, output [8, D*4, B] f32;
// B a multiple of 128. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for V > 256).
extern "C" int body_contacts_launch(const void* tri16, const void* idx,
                                    const void* cnt, int nc, const void* body,
                                    const void* verts, const void* is_box,
                                    int V, int D, void* out, int B,
                                    void* stream) {
  if (V < 1 || V > MAX_V) return (int)cudaErrorInvalidValue;
  const dim3 grid(B / BLK, D);
  if (grid.x > 0 && D > 0) {
    body_contacts_kernel<<<grid, BLK, 0, (cudaStream_t)stream>>>(
        (const float*)tri16, (const int*)idx, (const int*)cnt, nc,
        (const float*)body, (const float*)verts, (const int*)is_box, V, D,
        (float*)out, B);
  }
  return (int)cudaGetLastError();
}
