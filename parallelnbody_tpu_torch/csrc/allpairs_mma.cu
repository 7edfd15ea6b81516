// K5, K6, K7: the all-pairs sums on Hopper's tensor cores (sm_90a),
// mma.sync TF32 in inline PTX.
//
// Replace the three matrix-unit kernels of scripts/mxu_allpairs.py, a TPU
// experiment that no path of the JAX package runs: _kern_v3 (:41, K5),
// _kern_v1 (:65, K6) and _kern_v4 (:86, K7), called through run_variant
// (:206) and run_v4 (:157). Wrappers and plain PyTorch versions:
// parallelnbody_tpu_torch/ops/direct_mma.py.
//
// What they compute, for n particles on themselves (src = [x, y, z, m]):
//   V3: raw (n, 4) = W @ [x_j, y_j, z_j, 1], w_ij = m_j u^3,
//       u = rsqrt(|x_j - x_i|^2 + eps^2), w on the FP32 pipes, the product
//       on the tensor cores;
//   V1: the same with r^2 = max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) + eps^2,
//       the cross term x_i.x_j a tensor-core product too;
//   V4: Hilbert-sorted input; per source j-tile of tile_j, off the band
//       raw += [W @ (x_j - c_j) + rowsum c_j, rowsum] (c_j the tile's
//       centroid), in the band (|i_mid - j_mid| < tile_j/2 + tile_i/2 +
//       band_tiles tile_j, per tile_i x tile_j tile as the script) raw +=
//       [sum w d, 0] on the FP32 pipes.
// The caller forms acc = raw[:, :3] - raw[:, 3:4] x_i.
//
// Precision P (template): 1 = one TF32 pass (operands rounded as
// cvt.rna.tf32.f32 rounds, to_tf32); 3 = 3xTF32, each operand split into big = tf32(x) and
// small = tf32(x - big), the products small.big, big.small and big.big
// chained through the accumulator in that order.
//
// The tensor core's rounding (direct_mma.tensor_core_step, held bit for bit
// to mma_probe_kernel by the card tests): products exact, every addend cut
// toward zero to 25 bits below the largest one's exponent, the sum rounded
// toward zero. Each step of a chain of such sums can lose up to 2^-23 of
// the sum, always toward zero, so a chain over the 32768 slabs of
// N = 262144 could drift by ~4e-3: each warp's tensor-core sums run over
// one staged tile (TILE sources, TILE / 8 steps) and are then added into
// f32 registers, rounded to nearest.
//
// Design. A block of WARPS warps; a warp owns MT tiles of 16 targets (the
// mma's m16) in registers. Sources stream through shared memory in tiles
// of TILE, loaded into registers one tile ahead and staged by one thread a
// source, which also forms the source's B-fragment values once (TF32 parts,
// V4 centred, laid out so that lane l reads its own with one LDS.64 or
// LDS.128). A k-step takes a slab of 8 sources: lane (g = l / 4, t = l % 4)
// forms w at its own A-fragment positions of m16n8k8 (targets g and g + 8,
// sources t and t + 4), so W never passes through shared memory, and one B
// fragment and two source loads serve the warp's MT m-tiles. B's 8 columns
// are [x, 1, y, 1, z, 1, 0, 0]: lane t of the accumulator's (row, 2t) and
// (row, 2t + 1) then holds component t and the rowsum, so V4's centroid
// term and the output need no shuffle.
// V1's cross term is m16n8k4 with k = [x, y, z, 0]; its accumulator holds
// sources 2t and 2t + 1 of the slab at lane t, so V1 stages the second
// product's B with sources 2t and 2t + 1 in rows t and t + 4, where lane t's
// A columns want them: no shuffle either.
// V4 walks a tile's slabs in runs of one j-tile. A warp's 64 targets lie in
// one i-tile (tile_i is a multiple of 64), so the band test holds for the
// whole warp: a run in the band takes K3's pair arithmetic on the FP32
// pipes into per-lane partial sums (added across the lanes of a quad at the
// end), any other run V3's path with the centred B; the centroid term is
// added at the end of each j-tile, and of each staged tile.
//
// What bounds it. A pair is 12 FP32 operations in V3 and in V4 off the
// band (d 3, r^2 6, w 3; the sums on the tensor cores), 8 in V1 (no d),
// one more for the split of w at P = 3, and one rsqrt: the MUFU's n^2
// rsqrts (16.41 ms at N = 262144) bound every variant. The tensor-core
// work (16 x 8 x 8 x 2 FLOPs a k-step and m-tile, times P) is far below
// its 495 TFLOP/s. On the card they run at 0.31-0.52 of that bound, slower
// than K3 but for V1 at one pass (PERF.md §6); WARPS, MT and MIN_BLOCKS
// were chosen among 10 shapes by tools/mxu_shapes.py.
//
// Split over sources. As K3 (allpairs.cu): pnb_allpairs_mma_splits cuts the
// source tiles into ranges that fill the card in one wave; partial sums per
// range are added in range order by allpairs_mma_combine. No float atomics:
// repeat launches give the same bits.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "terms.cuh"

namespace {

constexpr int WARPS = 8;                  // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int MT = 4;                     // m16 tiles a warp
constexpr int ROWS = WARPS * MT * 16;     // targets a block
constexpr int MIN_BLOCKS = 2;            // blocks an SM: <= 128 registers
constexpr int TILE = 128;                 // sources a staged tile
constexpr int SLABS = TILE / 8;           // k-steps a tile

enum Variant { kV1 = 1, kV3 = 3, kV4 = 4 };

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, the low 13 bits zero), in two integer instructions: half a
// TF32 unit added to the magnitude bits, the low bits cleared. The same bits
// as cvt.rna for every finite x (checked on the card; direct_mma.tf32_round
// is the same formula), where cvt.rna.tf32.f32 compiles to more.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ float tf32f(float x) {
  return __uint_as_float(to_tf32(x));
}

// c += A (16 x 8, rows g and g + 8, columns t and t + 4) @ B (8 x 8).
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A (16 x 4, rows g and g + 8, column t) @ B (4 x 8).
__device__ __forceinline__ void mma_k4(float (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The TF32 parts of an operand at precision P: [big] or [big, small].
template <int P>
constexpr int kParts = P == 1 ? 1 : 2;

// c += W @ B for the four w of a lane (a0 = (g, t), a1 = (g + 8, t),
// a2 = (g, t + 4), a3 = (g + 8, t + 4)); b = [big_t, big_t4] or
// [big_t, big_t4, small_t, small_t4].
template <int P>
__device__ __forceinline__ void mma_w(float (&c)[4], float w0, float w1,
                                      float w2, float w3, const float* b) {
  const uint32_t h0 = to_tf32(w0), h1 = to_tf32(w1), h2 = to_tf32(w2),
                 h3 = to_tf32(w3);
  const uint32_t bb0 = __float_as_uint(b[0]), bb1 = __float_as_uint(b[1]);
  if constexpr (P == 3) {
    const uint32_t l0 = to_tf32(w0 - __uint_as_float(h0));
    const uint32_t l1 = to_tf32(w1 - __uint_as_float(h1));
    const uint32_t l2 = to_tf32(w2 - __uint_as_float(h2));
    const uint32_t l3 = to_tf32(w3 - __uint_as_float(h3));
    mma_k8(c, l0, l1, l2, l3, bb0, bb1);  // small.big
    mma_k8(c, h0, h1, h2, h3, __float_as_uint(b[2]),
           __float_as_uint(b[3]));        // big.small
  }
  mma_k8(c, h0, h1, h2, h3, bb0, bb1);    // big.big
}

// One staged tile: what the k-steps of its SLABS slabs read.
template <int P>
struct Stage {
  static constexpr int NP = kParts<P>;
  float4 src[TILE];               // V3, V4: [x, y, z, m]
  float bt[SLABS][32][2 * NP];    // main product's B values, by lane
  float cb[SLABS][32][NP];        // V1: cross product's B values, by lane
  float4 nm[SLABS][4];            // V1: [|x|^2, m] of sources 2t, 2t + 1
};

// Stages source slot q of a tile: p = [x, y, z, m] (zero past n), n2 its
// |x|^2 (V1), c its j-tile's centroid (V4).
template <int VAR, int P>
__device__ __forceinline__ void stage_source(Stage<P>& st, int q, float4 p,
                                             float n2, float4 c) {
  constexpr int NP = kParts<P>;
  const int slab = q >> 3, k = q & 7;
  if (VAR != kV1) st.src[q] = p;
  const float col[3] = {p.x - c.x, p.y - c.y, p.z - c.z};
  // Row k of B; V1 puts source k in row (k & 1) * 4 + k / 2, so that its
  // cross-term column k lands at lane t = k / 2, half k & 1.
  const int t = VAR == kV1 ? k >> 1 : k & 3;
  const int h = VAR == kV1 ? k & 1 : k >> 2;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float v = g < 6 ? ((g & 1) ? 1.f : col[g >> 1]) : 0.f;
    const float big = tf32f(v);
    st.bt[slab][g * 4 + t][h] = big;
    if constexpr (NP == 2) st.bt[slab][g * 4 + t][2 + h] = tf32f(v - big);
  }
  if constexpr (VAR == kV1) {
    const float xyz[4] = {p.x, p.y, p.z, 0.f};
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const float big = tf32f(xyz[tt]);
      st.cb[slab][k * 4 + tt][0] = big;
      if constexpr (NP == 2) st.cb[slab][k * 4 + tt][1] = tf32f(xyz[tt] - big);
    }
    float* nm = reinterpret_cast<float*>(&st.nm[slab][k >> 1]);
    nm[2 * (k & 1)] = n2;
    nm[2 * (k & 1) + 1] = p.w;
  }
}

// u^3 m for r^2 = r2 (terms.cuh's rsqrt).
__device__ __forceinline__ float weight_r2(float r2, float m) {
  const float u = pnb::rsqrt_ftz(r2);
  return (m * u) * (u * u);
}

// Block (x, s): targets [x * ROWS, (x + 1) * ROWS) against source tiles
// [s * per_split, (s + 1) * per_split), raw sums into out + s * n * 4.
// aux: V1 |x|^2 (n), V4 the centroids (n / tile_j, 4).
template <int VAR, int P>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    allpairs_mma_kernel(const float4* __restrict__ src,
                        const float* __restrict__ aux, float* __restrict__ out,
                        int n, int per_split, float eps2, int tile_i,
                        int tile_j, int band_tiles) {
  constexpr int NP = kParts<P>;
  __shared__ Stage<P> stage[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * ROWS + warp * MT * 16;

  // Targets g and g + 8 of each m-tile (zero past n; never written).
  float tx[MT][2], ty[MT][2], tz[MT][2], tn[MT][2];
  uint32_t ca[MT][2][NP];  // V1: the cross product's A (coordinate t)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + mt * 16 + g + 8 * r;
      const float4 p = i < n ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      tx[mt][r] = p.x;
      ty[mt][r] = p.y;
      tz[mt][r] = p.z;
      tn[mt][r] = (VAR == kV1 && i < n) ? aux[i] : 0.f;
      const float ct = t == 0 ? p.x : t == 1 ? p.y : t == 2 ? p.z : 0.f;
      const float big = tf32f(ct);
      ca[mt][r][0] = __float_as_uint(big);
      if constexpr (NP == 2) ca[mt][r][1] = to_tf32(ct - big);
    }
  }
  // V4: the script's row_mid of the warp's i-tile (tile_i is a multiple of
  // a warp's MT * 16 targets, so they share it).
  const int i_mid = (row0 / tile_i) * tile_i + tile_i / 2;
  // Sums in f32 registers: component t (t < 3) and the rowsum of rows g,
  // g + 8; V4's band partials over this lane's sources.
  float acc[MT][2] = {}, rs[MT][2] = {};
  float bx[MT][2] = {}, by[MT][2] = {}, bz[MT][2] = {};
  const int band_lim = tile_j / 2 + tile_i / 2 + band_tiles * tile_j;

  const int n_tiles_all = (n + TILE - 1) / TILE;
  const int first = blockIdx.y * per_split;
  const int n_tiles = min(per_split, n_tiles_all - first);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 pf = zero4, pc = zero4;
  float pn2 = 0.f;
  auto fetch = [&](int k) {
    const long long s = (long long)(first + k) * TILE + threadIdx.x;
    if (threadIdx.x >= TILE) return;
    const bool live = s < n;
    pf = live ? src[s] : zero4;
    if (VAR == kV1) pn2 = live ? aux[s] : 0.f;
    if (VAR == kV4)
      pc = live ? reinterpret_cast<const float4*>(aux)[s / tile_j] : zero4;
  };
  fetch(0);
  for (int k = 0; k < n_tiles; ++k) {
    Stage<P>& st = stage[k & 1];
    if (threadIdx.x < TILE) stage_source<VAR, P>(st, threadIdx.x, pf, pn2, pc);
    __syncthreads();  // tile k staged; tile k - 2's buffer swept by all
    if (k + 1 < n_tiles) fetch(k + 1);
    const int base = (first + k) * TILE;
    const int live_slabs = min(SLABS, (n - base + 7) / 8);
    float c[MT][4] = {};
    // V4: the j-tile of the current slab, where it ends, its midpoint.
    int jt = 0, edge = 0, j_mid = 0;
    if constexpr (VAR == kV4) {
      jt = base / tile_j;
      edge = (jt + 1) * tile_j;
      j_mid = jt * tile_j + tile_j / 2;
    }
    // The tensor-core sums so far into the f32 registers: component t with
    // V4's centroid term rowsum * c, and the rowsum.
    auto fold = [&](float cj) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[mt][r] += fmaf(c[mt][2 * r + 1], cj, c[mt][2 * r]);
          rs[mt][r] += c[mt][2 * r + 1];
          c[mt][2 * r] = c[mt][2 * r + 1] = 0.f;
        }
    };
    bool pending = false;  // V4: c holds sums of j-tile jt
    // Runs of slabs in one j-tile (V4; V3 and V1: the whole tile), each on
    // one path for the whole warp: the band test is the same for every
    // lane, so the branch is uniform over the warp, as mma.sync needs.
    for (int sl = 0; sl < live_slabs;) {
      int end = live_slabs;
      bool band = false;
      if constexpr (VAR == kV4) {
        end = min(live_slabs, (edge - base) >> 3);
        band = abs(i_mid - j_mid) < band_lim;
      }
      if (band) {
        for (; sl < end; ++sl) {  // V4's band: K3's sums on the FP32 pipes
          const float4 s0 = st.src[sl * 8 + t], s1 = st.src[sl * 8 + t + 4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 sj = (e & 1) ? s1 : s0;
              const int r = e >> 1;
              const float dx = sj.x - tx[mt][r], dy = sj.y - ty[mt][r],
                          dz = sj.z - tz[mt][r];
              const float w = weight_r2(
                  fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2))), sj.w);
              bx[mt][r] = fmaf(w, dx, bx[mt][r]);
              by[mt][r] = fmaf(w, dy, by[mt][r]);
              bz[mt][r] = fmaf(w, dz, bz[mt][r]);
            }
        }
      } else {
        for (; sl < end; ++sl) {
          float b[2 * NP];
          if constexpr (NP == 2) {
            const float4 v = *reinterpret_cast<const float4*>(st.bt[sl][lane]);
            b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(st.bt[sl][lane]);
            b[0] = v.x, b[1] = v.y;
          }
          if constexpr (VAR == kV1) {
            uint32_t cbv[NP];
#pragma unroll
            for (int q = 0; q < NP; ++q)
              cbv[q] = __float_as_uint(st.cb[sl][lane][q]);
            const float4 nm = st.nm[sl][t];  // sources 2t, 2t + 1
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              float x4[4] = {0.f, 0.f, 0.f, 0.f};
              if constexpr (P == 3) {
                mma_k4(x4, ca[mt][0][1], ca[mt][1][1], cbv[0]);  // small.big
                mma_k4(x4, ca[mt][0][0], ca[mt][1][0], cbv[1]);  // big.small
              }
              mma_k4(x4, ca[mt][0][0], ca[mt][1][0], cbv[0]);    // big.big
              // x4 and w: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
              float w[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float ni = tn[mt][e >> 1];
                const float nj = (e & 1) ? nm.z : nm.x;
                const float mj = (e & 1) ? nm.w : nm.y;
                const float r2 = fmaxf(fmaf(-2.f, x4[e], ni + nj), 0.f) + eps2;
                w[e] = weight_r2(r2, mj);
              }
              // A columns t and t + 4 hold sources 2t and 2t + 1.
              mma_w<P>(c[mt], w[0], w[2], w[1], w[3], b);
            }
          } else {
            const float4 s0 = st.src[sl * 8 + t], s1 = st.src[sl * 8 + t + 4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              // e = 2 r + h: rows g, g + 8 (r), sources t, t + 4 (h)
              float w[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float4 sj = (e & 1) ? s1 : s0;
                const int r = e >> 1;
                const float dx = sj.x - tx[mt][r], dy = sj.y - ty[mt][r],
                            dz = sj.z - tz[mt][r];
                w[e] = weight_r2(
                    fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2))), sj.w);
              }
              mma_w<P>(c[mt], w[0], w[2], w[1], w[3], b);
            }
          }
        }
      }
      if constexpr (VAR == kV4) {
        pending = true;
        if (base + end * 8 == edge) {  // the run ends j-tile jt
          fold(t < 3 ? aux[jt * 4 + t] : 0.f);
          pending = false;
          jt += 1;
          edge += tile_j;
          j_mid += tile_j;
        }
      }
    }
    if constexpr (VAR == kV4) {
      if (pending) fold(t < 3 ? aux[jt * 4 + t] : 0.f);
    } else {
      fold(0.f);
    }
  }

  float* dst = out + (long long)blockIdx.y * n * 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float band_sum = 0.f;
      if (VAR == kV4) {
        float v[3] = {bx[mt][r], by[mt][r], bz[mt][r]};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          v[q] += __shfl_xor_sync(0xffffffffu, v[q], 1);
          v[q] += __shfl_xor_sync(0xffffffffu, v[q], 2);
        }
        band_sum = t == 0 ? v[0] : t == 1 ? v[1] : v[2];
      }
      const int i = row0 + mt * 16 + g + 8 * r;
      if (i >= n) continue;
      if (t < 3) dst[(long long)i * 4 + t] = acc[mt][r] + band_sum;
      if (t == 0) dst[(long long)i * 4 + 3] = rs[mt][r];
    }
}

// out[i] = partial[0][i] + partial[1][i] + ... in range order.
__global__ void allpairs_mma_combine(const float4* __restrict__ partial,
                                     float4* __restrict__ out, int n,
                                     int n_split) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 s = partial[i];
  for (int k = 1; k < n_split; ++k) {
    const float4 q = partial[(long long)k * n + i];
    s.x += q.x;
    s.y += q.y;
    s.z += q.z;
    s.w += q.w;
  }
  out[i] = s;
}

// One TF32 mma of a warp for each of n problems, D = A @ B + C with A
// (16 x k, k = 4 or 8), B (k x 8) and C, D (16 x 8) row-major, loaded into
// the fragments the kernels use. The card tests hold
// direct_mma.tensor_core_step, the plain versions' model of the tensor
// core's sums, to it bit for bit.
template <int K>
__global__ void mma_probe_kernel(const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 const float* __restrict__ c,
                                 float* __restrict__ d, int n) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (p >= n) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* pa = a + (long long)p * 16 * K;
  const float* pb = b + (long long)p * K * 8;
  float acc[4];
  const int at[4] = {g * 8 + 2 * t, g * 8 + 2 * t + 1, (g + 8) * 8 + 2 * t,
                     (g + 8) * 8 + 2 * t + 1};
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = c[(long long)p * 128 + at[e]];
  auto bits = [](float x) { return __float_as_uint(x); };
  if constexpr (K == 4) {
    mma_k4(acc, bits(pa[g * 4 + t]), bits(pa[(g + 8) * 4 + t]),
           bits(pb[t * 8 + g]));
  } else {
    mma_k8(acc, bits(pa[g * 8 + t]), bits(pa[(g + 8) * 8 + t]),
           bits(pa[g * 8 + t + 4]), bits(pa[(g + 8) * 8 + t + 4]),
           bits(pb[t * 8 + g]), bits(pb[(t + 4) * 8 + g]));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) d[(long long)p * 128 + at[e]] = acc[e];
}

using KernelFn = void (*)(const float4*, const float*, float*, int, int,
                          float, int, int, int);

KernelFn kernel_for(int variant, int precision) {
  const bool p3 = precision == 3;
  switch (variant) {
    case kV3:
      return p3 ? allpairs_mma_kernel<kV3, 3> : allpairs_mma_kernel<kV3, 1>;
    case kV1:
      return p3 ? allpairs_mma_kernel<kV1, 3> : allpairs_mma_kernel<kV1, 1>;
    case kV4:
      return p3 ? allpairs_mma_kernel<kV4, 3> : allpairs_mma_kernel<kV4, 1>;
    default:
      return nullptr;
  }
}

}  // namespace

// The number S of source ranges for n particles: the most that keeps the
// grid within one wave of resident blocks of this variant's kernel, at
// most one range a tile, and no range empty. Negative: a CUDA error.
extern "C" int pnb_allpairs_mma_splits(int n, int variant, int precision) {
  const KernelFn fn = kernel_for(variant, precision);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                        0);
  if (err != cudaSuccess) return -(int)err;
  const int blocks = (n + ROWS - 1) / ROWS;
  const int tiles = (n + TILE - 1) / TILE;
  if (tiles <= 1 || blocks <= 0) return 1;
  const int s = std::max(1, std::min(tiles, sms * per_sm / blocks));
  const int per_split = (tiles + s - 1) / s;
  return std::max(1, (tiles + per_split - 1) / per_split);
}

// src (n, 4) [x, y, z, m]; aux: V1 |x|^2 (n), V4 centroids (n / tile_j, 4),
// V3 unread; out (n, 4); partial (n_split, n, 4), unused when n_split is 1.
extern "C" int pnb_allpairs_mma(const void* src, const void* aux, void* out,
                                void* partial, int n, int n_split, float eps2,
                                int variant, int precision, int tile_i,
                                int tile_j, int band_tiles, void* stream) {
  const KernelFn fn = kernel_for(variant, precision);
  if (fn == nullptr || n_split < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + TILE - 1) / TILE;
  const int per_split = (tiles + n_split - 1) / n_split;
  const dim3 grid((n + ROWS - 1) / ROWS, n_split);
  fn<<<grid, THREADS, 0, st>>>(
      static_cast<const float4*>(src), static_cast<const float*>(aux),
      static_cast<float*>(n_split > 1 ? partial : out), n, per_split, eps2,
      tile_i, tile_j, band_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  allpairs_mma_combine<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float4*>(partial), static_cast<float4*>(out), n,
      n_split);
  return (int)cudaGetLastError();
}

// a (n, 16, k), b (n, k, 8), c and d (n, 16, 8), f32; k is 4 or 8.
extern "C" int pnb_mma_tf32_probe(const void* a, const void* b, const void* c,
                                  void* d, int n, int k, void* stream) {
  if (k != 4 && k != 8) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n * 32 + 127) / 128);
  auto fa = static_cast<const float*>(a), fb = static_cast<const float*>(b),
       fc = static_cast<const float*>(c);
  auto fd = static_cast<float*>(d);
  if (k == 4)
    mma_probe_kernel<4><<<grid, 128, 0, st>>>(fa, fb, fc, fd, n);
  else
    mma_probe_kernel<8><<<grid, 128, 0, st>>>(fa, fb, fc, fd, n);
  return (int)cudaGetLastError();
}
