// The softened interaction terms that the kernels K1-K4 share, the
// source-tile pipeline of the two pair-sum kernels K1 and K3, and the node-row
// pipeline of the two far-field kernels K2 and K4.
//
// A source (a particle, or a tree node's centre of mass) at x_s with mass m
// acts on a target at x_i through
//     d = x_s - x_i,  u = rsqrt(|d|^2 + eps^2),  w = m u^3:
//     acc += w d,  pot_sum += m u
// The caller scales the sums by g and negates the potential sum. With
// GUARD_ZERO (softening 0) u is 0 where r^2 = 0, which skips exact overlaps
// and the self pair. A node with a traceless quadrupole Q (Qzz = -Qxx - Qyy)
// adds, with qd = Q d and qq = d.Q.d,
//     acc += 2.5 qq u^7 d - u^5 qd,  pot_sum += 0.5 qq u^5
// the formula of parallelnbody_tpu/ops/pallas_bh.py:98-117 and :438-455.
// The sums live in a float4 (x, y, z, potential) of registers.
//
// The rsqrt is rsqrt.approx.ftz.f32, one MUFU.RSQ. rsqrtf() without
// -ftz=true adds a denormal-range fix-up around it (a compare and two
// predicated multiplies per pair); r^2 >= eps^2 is never denormal on a
// softened path, and with GUARD_ZERO a zero r^2 is masked anyway.
//
// A pair is 12 FP32 instructions (3 FADD for d, 3 FFMA for r^2, 3 FMUL for
// m u and w, 3 FFMA for the sums) and one MUFU.RSQ; the tile routine below
// amortises the shared-memory load of a source over the R targets a thread
// holds. Moving the sums (or r^2's cross term) onto the tensor cores
// (allpairs_mma.cu, K5-K7) runs fewer instructions a pair but ran no
// faster on the card, and lost accuracy unless re-centred (PERF.md §6).

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

// Adds the monopole + traceless quadrupole term of the node row
// p = [x, y, z, m], qa = [Qxx, Qyy, Qxy, Qxz], qb = [Qyz, Qzz, -, -].
// With m u^3 = u^5 (m r^2) (r^2 = |d|^2 + eps^2 = u^-2) the acceleration is
//     acc += u^5 ((m r^2 + 2.5 qq u^2) d - qd)
// two FFMA a component, and Qzz comes formed with the row. 18 FFMA, 9 FMUL
// and 3 FADD (48 FP32 operations, an FMA as two) and one MUFU.RSQ a term;
// the potential adds two FFMA and one FMUL.
template <bool GUARD_ZERO, bool COMPUTE_POT>
__device__ __forceinline__ void quad_term(float4 p, float4 qa, float4 qb,
                                          float xi, float yi, float zi,
                                          float eps2, float4& s) {
  const float dx = p.x - xi;
  const float dy = p.y - yi;
  const float dz = p.z - zi;
  const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
  float u = rsqrt_ftz(r2);
  if (GUARD_ZERO) u = r2 > 0.f ? u : 0.f;
  const float qdx = fmaf(qa.x, dx, fmaf(qa.z, dy, qa.w * dz));
  const float qdy = fmaf(qa.z, dx, fmaf(qa.y, dy, qb.x * dz));
  const float qdz = fmaf(qa.w, dx, fmaf(qb.x, dy, qb.y * dz));
  const float qq = fmaf(qdx, dx, fmaf(qdy, dy, qdz * dz));
  const float u2 = u * u;
  const float u5 = u2 * u2 * u;
  const float c = fmaf(qq * u2, 2.5f, p.w * r2);
  s.x = fmaf(u5, fmaf(c, dx, -qdx), s.x);
  s.y = fmaf(u5, fmaf(c, dy, -qdy), s.y);
  s.z = fmaf(u5, fmaf(c, dz, -qdz), s.z);
  if (COMPUTE_POT) s.w = fmaf(0.5f * qq, u5, fmaf(p.w, u, s.w));
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

// ------------------------------------------------ far field (K2, K4)
// A node row is ROW float4: [x, y, z, m] (ROW = 1, monopole), or
// [x, y, z, m] [Qxx, Qyy, Qxy, Qxz] [Qyz, Qzz, 0, 0] (ROW = 3, the
// wrapper's bh_kernels.far_rows), so that a row is staged with 16-byte
// cp.async copies and read with LDS.128.

// Rows a ring buffer holds, and buffers in the ring. A buffer of 64 rows
// (3 KB with quadrupoles) serves 64 x G node-target terms, thousands of
// FP32 instructions a thread, against one L2 round trip to stage the next
// one: two buffers hide the copy, and 6 KB a block leaves room for every
// block that an SM's registers can hold. 32 rows in three buffers and 128
// in two ran slower on the card (far_octet.cu).
constexpr int kFarTile = 64;
constexpr int kFarStages = 2;

// Loads targets first + i, i = threadIdx.x + r * blockDim.x < G, into t
// (a thread past the leaf's end repeats target 0 and writes nothing), and
// zeroes their sums.
template <int R>
__device__ __forceinline__ void load_targets(const float* tgt,
                                             long long first, int G,
                                             Targets<R>& t) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    const long long row = first + (i < G ? i : 0);
    t.x[r] = tgt[row * 3 + 0];
    t.y[r] = tgt[row * 3 + 1];
    t.z[r] = tgt[row * 3 + 2];
    t.s[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Writes the sums of load_targets' targets scaled as the callers expect:
// acc = g s.xyz, pot = -g s.w (0 without the potential).
template <int R, bool COMPUTE_POT>
__device__ __forceinline__ void store_targets(float* acc, float* pot,
                                              long long first, int G, float g,
                                              const Targets<R>& t) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i >= G) continue;
    const long long row = first + i;
    acc[row * 3 + 0] = g * t.s[r].x;
    acc[row * 3 + 1] = g * t.s[r].y;
    acc[row * 3 + 2] = g * t.s[r].z;
    pot[row] = COMPUTE_POT ? -g * t.s[r].w : 0.f;
  }
}

// Adds the n node rows of `rows` (shared memory, ROW float4 each; every
// thread reads the same address, one broadcast LDS.128 per float4) to each
// of the R targets, in row order.
template <int R, int ROW, bool GUARD_ZERO, bool COMPUTE_POT>
__device__ __forceinline__ void sweep_rows(const float4* rows, int n,
                                           float eps2, Targets<R>& t) {
  if constexpr (ROW == 1) {
    sweep<R, GUARD_ZERO, COMPUTE_POT>(rows, n, eps2, t);
  } else {
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4 p = rows[j * ROW + 0];
      const float4 qa = rows[j * ROW + 1];
      const float4 qb = rows[j * ROW + 2];
#pragma unroll
      for (int r = 0; r < R; ++r)
        quad_term<GUARD_ZERO, COMPUTE_POT>(p, qa, qb, t.x[r], t.y[r], t.z[r],
                                           eps2, t.s[r]);
    }
  }
}

// Sweeps a far list of n entries through a ring of kFarStages buffers of
// kFarTile rows (ring: kFarStages * kFarTile * ROW float4 of shared memory,
// n_rows: kFarStages ints). entry(e, src, mask) names the rows of entry e:
// bit b of the 8-bit mask set means row src + b * ROW acts (an octet key of
// K2: its 8 sibling rows and child mask; a row index of K4: one row, mask 1,
// or 0 where a scattered list's entry is not valid).
//
// Warp 0 stages: its lanes read 32 entries at once, a prefix sum of the
// masks' popcounts gives each acting row its place, and only acting rows
// are copied, densely, in list order (entry, then bit), so every target
// adds its terms in list order and the sums are the same bits from launch
// to launch. A buffer takes whole entries up to kFarTile rows; the sweep
// then has no mask to test. The next buffer's copies are in flight while
// the block sweeps the current one; one __syncthreads per buffer publishes
// the buffer that landed and frees the one swept last. Every thread of the
// block must call this.
template <int R, int ROW, bool GUARD_ZERO, bool COMPUTE_POT, class Entry>
__device__ __forceinline__ void far_sweep(float4* ring, int* n_rows, int n,
                                          Entry entry, float eps2,
                                          Targets<R>& t) {
  constexpr int S = kFarStages;
  constexpr int T = kFarTile;
  static_assert(S >= 2 && T >= 8, "two buffers of one octet or more");
  const int lane = threadIdx.x & 31;
  const int width = min(32, (int)blockDim.x);  // warp 0's lanes
  const unsigned lanes = width == 32 ? 0xffffffffu : (1u << width) - 1;
  int next = 0;  // warp 0: the first entry not yet staged
  // Fills buffer k % S from entry `next` on; n_rows 0 marks the list's end
  // (a buffer holds a row whenever an entry is left: T >= 8).
  auto stage = [&](int k) {
    if (threadIdx.x >= 32) return;
    float4* dst = ring + (k % S) * T * ROW;
    int rows = 0;
    while (next < n) {
      const int e = next + lane;
      const float4* src = nullptr;
      unsigned mask = 0;
      if (e < n) entry(e, src, mask);
      const int cnt = __popc(mask);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(lanes, incl, o);
        if (lane >= o) incl += v;
      }
      // incl grows with the lane, so the entries that fit are a prefix.
      const bool fits = e < n && rows + incl <= T;
      const int taken = __popc(__ballot_sync(lanes, fits));
      if (fits) {
        float4* d = dst + (rows + incl - cnt) * ROW;
        while (mask) {
          const float4* s = src + (__ffs(mask) - 1) * ROW;
          mask &= mask - 1;
#pragma unroll
          for (int q = 0; q < ROW; ++q) cp_async16(d + q, s + q);
          d += ROW;
        }
      }
      if (taken > 0) rows += __shfl_sync(lanes, incl, taken - 1);
      next += taken;
      if (taken < width || rows == T) break;
    }
    if (threadIdx.x == 0) n_rows[k % S] = rows;
  };
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    stage(k);
    cp_async_commit();
  }
  for (int k = 0;; ++k) {
    cp_async_wait<S - 2>();  // this thread's copies of buffer k have landed
    __syncthreads();         // everyone's have; buffer k-1 is swept by all
    const int rows = n_rows[k % S];
    if (rows == 0) break;    // uniform: read after the barrier
    stage(k + S - 1);
    cp_async_commit();
    sweep_rows<R, ROW, GUARD_ZERO, COMPUTE_POT>(ring + (k % S) * T * ROW,
                                                rows, eps2, t);
  }
}

}  // namespace pnb
