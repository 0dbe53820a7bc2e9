// Device helpers shared by the capsule-resolve (K1) and body-contact (K3)
// kernels: the chunked triangle table's row load, the Ericson closest
// point on a triangle and the quaternion rotation, each in the TPU
// kernels' term order, so that with --fmad=false they round exactly as
// the plain PyTorch versions do.

#pragma once

#include <cuda_runtime.h>

namespace contact {

constexpr int T_CHUNK = 32;  // triangles per chunk: one per thread of a warp
constexpr float NEG_BIG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

// Row r of chunk c of the [T, 16] table (16-byte aligned) as four 16-byte
// loads: the 32 threads of a warp reading rows 0-31 of a chunk read its
// 2 KB in one sweep.
__device__ __forceinline__ void load_row(const float* __restrict__ tri16,
                                         int c, int r, float (&t)[16]) {
  const float4* src =
      reinterpret_cast<const float4*>(tri16) + ((size_t)c * T_CHUNK + r) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = __ldg(src + k);
    t[4 * k] = v.x; t[4 * k + 1] = v.y; t[4 * k + 2] = v.z; t[4 * k + 3] = v.w;
  }
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

// Rotate v by (qx, qy, qz, qw) in the TPU kernels' term order (_qrot).
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

// Warp argmax on (value, key): the larger value wins, and of equal values
// the smaller key. Every thread ends with the winner's key; `v` is not
// touched (the caller fetches the winner's own value: of +0 and -0, equal
// here, the first one's). Two warp reductions on integers: the values as
// order-preserving unsigned keys (with -0 read as +0), then the least key
// among the threads that hold the maximum. NaN never takes part: callers
// keep it out of `v`.
__device__ __forceinline__ int warp_argmax(float v, int key) {
  const unsigned b = __float_as_uint(v + 0.f);  // -0 + 0 = +0
  const unsigned u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const unsigned top = __reduce_max_sync(FULL, u);
  return __reduce_min_sync(FULL, u == top ? key : 0x7fffffff);
}

}  // namespace contact
