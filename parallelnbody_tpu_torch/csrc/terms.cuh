// The softened interaction terms that the kernels K1-K4 share.
//
// A source (a particle, or a tree node's centre of mass) at x_s with mass m
// acts on a target at x_i through
//     d = x_s - x_i,  u = rsqrt(|d|^2 + eps^2),  w = m u^3:
//     acc += w d,  pot_sum += m u
// The caller scales the sums by g and negates the potential sum. With
// GUARD_ZERO (softening 0) u is 0 where r^2 = 0, which skips exact overlaps
// and the self pair. A node with a traceless quadrupole
// [Qxx, Qyy, Qxy, Qxz, Qyz] (Qzz = -Qxx - Qyy) adds, with qd = Q d and
// qq = d.Q.d,
//     acc += 2.5 qq u^7 d - u^5 qd,  pot_sum += 0.5 qq u^5
// the formula of parallelnbody_tpu/ops/pallas_bh.py:98-117 and :438-455.
// The sums live in a float4 (x, y, z, potential) of registers.

#pragma once

namespace pnb {

// Adds the monopole term of mass m at displacement d; returns u.
template <bool GUARD_ZERO, bool COMPUTE_POT>
__device__ __forceinline__ float monopole_term(float dx, float dy, float dz,
                                               float m, float eps2,
                                               float4& s) {
  const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
  float u = rsqrtf(r2);
  if (GUARD_ZERO) u = r2 > 0.f ? u : 0.f;
  const float mu = m * u;
  const float w = mu * (u * u);
  s.x = fmaf(w, dx, s.x);
  s.y = fmaf(w, dy, s.y);
  s.z = fmaf(w, dz, s.z);
  if (COMPUTE_POT) s.w += mu;
  return u;
}

// Adds the monopole (C = 4) or monopole + quadrupole (C = 9) term of the
// node row nd = [x, y, z, m(, Qxx, Qyy, Qxy, Qxz, Qyz)] on the target
// (xi, yi, zi).
template <bool QUAD, bool GUARD_ZERO, bool COMPUTE_POT>
__device__ __forceinline__ void node_term(const float* nd, float xi, float yi,
                                          float zi, float eps2, float4& s) {
  const float dx = nd[0] - xi;
  const float dy = nd[1] - yi;
  const float dz = nd[2] - zi;
  const float u =
      monopole_term<GUARD_ZERO, COMPUTE_POT>(dx, dy, dz, nd[3], eps2, s);
  if (QUAD) {
    const float qxx = nd[4], qyy = nd[5], qxy = nd[6];
    const float qxz = nd[7], qyz = nd[8];
    const float qzz = -(qxx + qyy);
    const float qdx = fmaf(qxx, dx, fmaf(qxy, dy, qxz * dz));
    const float qdy = fmaf(qxy, dx, fmaf(qyy, dy, qyz * dz));
    const float qdz = fmaf(qxz, dx, fmaf(qyz, dy, qzz * dz));
    const float qq = fmaf(qdx, dx, fmaf(qdy, dy, qdz * dz));
    const float u2 = u * u;
    const float u5 = u2 * u2 * u;
    const float c1 = (2.5f * qq) * (u5 * u2);
    s.x += fmaf(c1, dx, -u5 * qdx);
    s.y += fmaf(c1, dy, -u5 * qdy);
    s.z += fmaf(c1, dz, -u5 * qdz);
    if (COMPUTE_POT) s.w = fmaf(0.5f * qq, u5, s.w);
  }
}

}  // namespace pnb
