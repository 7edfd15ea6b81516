// CPU direct-sum N-body oracle (double precision).
//
// Native re-implementation of the reference's force law
//   a_i += G * M / d^3 * (x_j - x_i)        (OctreeSearch.h:104, G=1e4 there)
// with optional Plummer softening, evaluated over every pair — the theta -> 0
// exact limit of the reference's Barnes-Hut. Used as the correctness baseline
// for the TPU kernels (energy-drift parity must not depend on JAX itself —
// SURVEY.md §2 "native equivalent" / §7 stage 2).
//
// The d == 0 guard below mirrors the reference's exact-overlap skip
// (OctreeSearch.h:102), which also removes self-interaction when eps == 0.
//
// Exposed via extern "C" for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Accelerations and per-particle potentials. pos: n*3, mass: n, acc out: n*3,
// pot out: n (phi_i = -G sum_j m_j / r_soft).
void nbody_direct_accel(const double* pos, const double* mass, int64_t n,
                        double g, double eps, double* acc, double* pot) {
  const double eps2 = eps * eps;
  for (int64_t i = 0; i < n; ++i) {
    double ax = 0.0, ay = 0.0, az = 0.0, ph = 0.0;
    const double xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    for (int64_t j = 0; j < n; ++j) {
      const double dx = pos[3 * j] - xi;
      const double dy = pos[3 * j + 1] - yi;
      const double dz = pos[3 * j + 2] - zi;
      const double r2 = dx * dx + dy * dy + dz * dz + eps2;
      if (r2 <= 0.0) continue;  // reference d==0 guard (OctreeSearch.h:102)
      const double inv_r = 1.0 / std::sqrt(r2);
      const double w = mass[j] * inv_r * inv_r * inv_r;
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
      ph += mass[j] * inv_r;
    }
    acc[3 * i] = g * ax;
    acc[3 * i + 1] = g * ay;
    acc[3 * i + 2] = g * az;
    pot[i] = -g * ph;
  }
}

// Kick-drift-kick leapfrog for `steps` steps, in place. acc must hold the
// accelerations at the initial positions (call nbody_direct_accel first).
void nbody_leapfrog_steps(double* pos, double* vel, const double* mass,
                          int64_t n, double g, double eps, double dt,
                          int64_t steps, double* acc, double* pot) {
  const double half = 0.5 * dt;
  for (int64_t s = 0; s < steps; ++s) {
    for (int64_t i = 0; i < 3 * n; ++i) {
      vel[i] += half * acc[i];
      pos[i] += dt * vel[i];
    }
    nbody_direct_accel(pos, mass, n, g, eps, acc, pot);
    for (int64_t i = 0; i < 3 * n; ++i) vel[i] += half * acc[i];
  }
}

// Reference-compat semi-implicit Euler (OctreeSearch.cpp:28-31):
// a = F(x); v += dt*a; x += dt*v.
void nbody_semi_euler_steps(double* pos, double* vel, const double* mass,
                            int64_t n, double g, double eps, double dt,
                            int64_t steps, double* acc, double* pot) {
  for (int64_t s = 0; s < steps; ++s) {
    nbody_direct_accel(pos, mass, n, g, eps, acc, pot);
    for (int64_t i = 0; i < 3 * n; ++i) {
      vel[i] += dt * acc[i];
      pos[i] += dt * vel[i];
    }
  }
}

// Total energy (KE + pairwise PE) — compensated (Kahan) summation so the
// drift measurement itself is not polluted by accumulation error.
double nbody_total_energy(const double* pos, const double* vel,
                          const double* mass, int64_t n, double g,
                          double eps) {
  const double eps2 = eps * eps;
  double ke = 0.0, kec = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double v2 = vel[3 * i] * vel[3 * i] + vel[3 * i + 1] * vel[3 * i + 1] +
                      vel[3 * i + 2] * vel[3 * i + 2];
    const double term = 0.5 * mass[i] * v2 - kec;
    const double t = ke + term;
    kec = (t - ke) - term;
    ke = t;
  }
  double pe = 0.0, pec = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = i + 1; j < n; ++j) {
      const double dx = pos[3 * j] - pos[3 * i];
      const double dy = pos[3 * j + 1] - pos[3 * i + 1];
      const double dz = pos[3 * j + 2] - pos[3 * i + 2];
      const double r2 = dx * dx + dy * dy + dz * dz + eps2;
      if (r2 <= 0.0) continue;
      const double term = -g * mass[i] * mass[j] / std::sqrt(r2) - pec;
      const double t = pe + term;
      pec = (t - pe) - term;
      pe = t;
    }
  }
  return ke + pe;
}

}  // extern "C"
