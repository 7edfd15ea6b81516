// The softened interaction terms that the kernels K1-K4 share, and the
// source-tile pipeline of the two pair-sum kernels K1 and K3.
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
//
// The rsqrt is rsqrt.approx.ftz.f32, one MUFU.RSQ. rsqrtf() without
// -ftz=true adds a denormal-range fix-up around it (a compare and two
// predicated multiplies per pair); r^2 >= eps^2 is never denormal on a
// softened path, and with GUARD_ZERO a zero r^2 is masked anyway.
//
// Tensor cores do not fit these terms: r^2 through |x|^2 + |y|^2 - 2 x.y in
// TF32 or fp16 loses near-field separations to cancellation, and the rsqrt
// and the weights are element-wise. A pair is 12 FP32 instructions (3 FADD
// for d, 3 FFMA for r^2, 3 FMUL for m u and w, 3 FFMA for the sums) and one
// MUFU.RSQ; the tile routine below amortises the shared-memory load of a
// source over the R targets a thread holds.

#pragma once

namespace pnb {

constexpr int kStages = 3;  // depth of the shared-memory source ring (K1, K3)
constexpr int kUnroll = 4;  // sources a step of the sweep loop (K1, K3)

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Adds the monopole term of mass m at displacement d; returns u.
template <bool GUARD_ZERO, bool COMPUTE_POT>
__device__ __forceinline__ float monopole_term(float dx, float dy, float dz,
                                               float m, float eps2,
                                               float4& s) {
  const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
  float u = rsqrt_ftz(r2);
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

// R targets held in registers by one thread, and their sums.
template <int R>
struct Targets {
  float x[R], y[R], z[R];
  float4 s[R];
};

// Adds the n float4 sources [x, y, z, m] of src (shared memory; every
// thread reads the same address, one broadcast LDS.128 per source) to each
// of the R targets, in source order.
template <int R, bool GUARD_ZERO, bool COMPUTE_POT>
__device__ __forceinline__ void sweep(const float4* src, int n, float eps2,
                                      Targets<R>& t) {
#pragma unroll (kUnroll)
  for (int j = 0; j < n; ++j) {
    const float4 p = src[j];
#pragma unroll
    for (int r = 0; r < R; ++r)
      monopole_term<GUARD_ZERO, COMPUTE_POT>(p.x - t.x[r], p.y - t.y[r],
                                             p.z - t.z[r], p.w, eps2, t.s[r]);
  }
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sweeps n_tiles tiles of `tile` float4 sources through a ring of kStages
// shared-memory buffers (ring holds kStages * tile float4).
// Tile k starts at tile_src(k) in global memory and holds tile_len(k) <=
// tile live sources; the rest of its buffer is zero (massless sources add
// exactly 0). cp.async keeps kStages - 1 tiles in flight while one is
// swept; one __syncthreads per tile both publishes the tile that landed and
// frees the buffer swept last, which the next copy then overwrites. Every
// thread of the block must call this.
template <int R, bool GUARD_ZERO, bool COMPUTE_POT, class TileSrc,
          class TileLen>
__device__ __forceinline__ void sweep_tiles(float4* ring, int tile,
                                            int n_tiles, TileSrc tile_src,
                                            TileLen tile_len, float eps2,
                                            Targets<R>& t) {
  constexpr int S = kStages;
  static_assert(S >= 2, "the ring needs two buffers or more");
  auto stage = [&](int k) {
    const float4* g = tile_src(k);
    const int live = tile_len(k);
    float4* d = ring + (k % S) * tile;
    for (int q = threadIdx.x; q < tile; q += blockDim.x) {
      if (q < live)
        cp_async16(d + q, g + q);
      else
        d[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < n_tiles) stage(k);
    cp_async_commit();
  }
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<S - 2>();  // this thread's copies of tile k have landed
    __syncthreads();         // everyone's have; tile k-1 is swept by all
    if (k + S - 1 < n_tiles) stage(k + S - 1);
    cp_async_commit();
    sweep<R, GUARD_ZERO, COMPUTE_POT>(ring + (k % S) * tile, tile, eps2, t);
  }
}

}  // namespace pnb
