// The pyramid refresh of a frozen-list evaluation, on the card: the
// multipole pyramid of the current sorted positions, written as K2's packed
// octet node rows.
//
// Replaces no Pallas kernel: the JAX package's refresh is XLA's fusion of
// `build_tree` (parallelnbody_tpu/ops/bh.py). Wrapper:
// parallelnbody_tpu_torch/ops/bh_kernels.py (`pyramid_rows`); plain PyTorch
// version and level plan: parallelnbody_tpu_torch/ops/bh.py
// (`refresh_plain`, `_pyramid_plan`; `_refresh_nodes8` picks one by the
// tensors' device).
//
// What it computes. The sorted bodies (n_pad rows; rows [n_live:] are pads)
// fall into leaves of G rows. Each node of the pyramid gets its mass, its
// centre of mass and, with quadrupoles, its traceless quadrupole about that
// centre, [Qxx, Qyy, Qxy, Qxz, Qyz] with Qxx = sum m (3 dx dx - |d|^2) and
// Qxy = sum m 3 dx dy: a leaf over its bodies, an upper node over its
// children (their quadrupoles plus the parallel-axis term of their masses
// at their centres). The levels follow build_upper's plan (radix 8 where the
// width divides by 8, the remaining factor at the top, at most max_levels
// levels); the wrapper passes each level's width and first row. The rows
// go into one table, leaves first, each level padded to a multiple of 8
// rows, so that a node's 8 siblings form an aligned octet:
// [x, y, z, m, Qxx, Qyy, Qxy, Qxz, Qyz, Qzz, 0, 0] with Qzz = -(Qxx + Qyy)
// (bh_kernels.far_rows' packing) or [x, y, z, m] for monopoles. A node of
// mass 0 gets centre = the sentinel of the domain cube of the live rows
// (bh.domain_cube's formula, on the exact minimum and maximum, so the same
// bits) and mass and quadrupole 0; pad rows are zero (Qzz -0, as far_rows
// gives). No radius is computed: K2 reads none.
//
// What bounds it. Each body is read once from memory (16 bytes) and the
// table written once (48 bytes a row); the arithmetic is ~30 FP32
// operations a body. So it is bound by memory: ~0.05 ms at N = 8M.
//
// Design: three launches, no float atomics, so repeats give the same bits.
//   * pyramid_leaf_kernel: one warp a leaf, 8 leaves (an octet) a block.
//     Lanes stride over the leaf's bodies, reduce mass and m x by warp
//     shuffles (a xor butterfly, so every lane holds the same bits), then
//     read the bodies again (from L1) for the quadrupole about that centre.
//     The same pass keeps the box of the leaf's live rows, reduced to one
//     box a block. Where the level above the leaves has radix 8, the block's
//     8 leaves are one node of it, which the block builds from the leaf
//     rows in shared memory.
//   * pyramid_top_kernel: one block. The block boxes reduce to the domain
//     cube's sentinel; then every remaining level, one after the other,
//     each node from its children's rows; every level's pad rows.
//   * pyramid_fill_kernel: the rows of the levels the first launch wrote
//     whose mass is 0 take the sentinel as centre.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 16;
constexpr int kLeafWarps = 8;  // leaves a block of the leaf kernel: one octet
constexpr int kTopThreads = 1024;
constexpr int kFillThreads = 256;

struct Plan {
  int n_levels;
  int width[kMaxLevels];  // nodes of each level, leaves first
  int row[kMaxLevels];    // first row of each level in the table
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A node's values: centre x, y, z, mass, then Qxx, Qyy, Qxy, Qxz, Qyz.
struct Node {
  float v[9];
};

// Writes node n (centre `com` where its mass is 0) as row r of the table.
template <bool QUAD>
__device__ __forceinline__ void put_row(float* rows, int64_t r, const Node& n,
                                        const float* com) {
  const bool empty = !(n.v[3] > 0.0f);
  const float x = empty ? com[0] : n.v[0], y = empty ? com[1] : n.v[1],
              z = empty ? com[2] : n.v[2];
  if (!QUAD) {
    reinterpret_cast<float4*>(rows)[r] = make_float4(x, y, z, n.v[3]);
    return;
  }
  float q[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) q[c] = empty ? 0.0f : n.v[4 + c];
  float4* out = reinterpret_cast<float4*>(rows) + 3 * r;
  out[0] = make_float4(x, y, z, n.v[3]);
  out[1] = make_float4(q[0], q[1], q[2], q[3]);
  out[2] = make_float4(q[4], -(q[0] + q[1]), 0.0f, 0.0f);
}

template <bool QUAD>
__device__ __forceinline__ void put_pad(float* rows, int64_t r) {
  const Node zero = {};
  const float origin[3] = {0.0f, 0.0f, 0.0f};
  put_row<QUAD>(rows, r, zero, origin);
}

// Reads row r of the table back as a node.
template <bool QUAD>
__device__ __forceinline__ Node get_row(const float* rows, int64_t r) {
  Node n = {};
  if (!QUAD) {
    const float4 a = reinterpret_cast<const float4*>(rows)[r];
    n.v[0] = a.x, n.v[1] = a.y, n.v[2] = a.z, n.v[3] = a.w;
    return n;
  }
  const float4* in = reinterpret_cast<const float4*>(rows) + 3 * r;
  const float4 a = in[0], b = in[1], c = in[2];
  n.v[0] = a.x, n.v[1] = a.y, n.v[2] = a.z, n.v[3] = a.w;
  n.v[4] = b.x, n.v[5] = b.y, n.v[6] = b.z, n.v[7] = b.w, n.v[8] = c.x;
  return n;
}

// The node over b children, child(k) giving the k-th: mass, centre of mass
// (0 where the mass is 0), and the children's quadrupoles plus the
// parallel-axis term of their masses at their centres. A child of mass 0
// adds nothing.
template <bool QUAD, class Child>
__device__ __forceinline__ Node combine(int b, Child child) {
  float m = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int k = 0; k < b; ++k) {
    const Node c = child(k);
    m += c.v[3];
    sx += c.v[3] * c.v[0];
    sy += c.v[3] * c.v[1];
    sz += c.v[3] * c.v[2];
  }
  Node n = {};
  n.v[3] = m;
  if (!(m > 0.0f)) return n;
  const float div = fmaxf(m, 1e-30f);
  n.v[0] = sx / div, n.v[1] = sy / div, n.v[2] = sz / div;
  if (QUAD) {
    for (int k = 0; k < b; ++k) {
      const Node c = child(k);
      const float w = c.v[3];
      const float dx = c.v[0] - n.v[0], dy = c.v[1] - n.v[1],
                  dz = c.v[2] - n.v[2];
      const float d2 = dx * dx + dy * dy + dz * dz;
      n.v[4] += c.v[4] + w * (3.0f * dx * dx - d2);
      n.v[5] += c.v[5] + w * (3.0f * dy * dy - d2);
      n.v[6] += c.v[6] + w * 3.0f * dx * dy;
      n.v[7] += c.v[7] + w * 3.0f * dx * dz;
      n.v[8] += c.v[8] + w * 3.0f * dy * dz;
    }
  }
  return n;
}

template <bool QUAD>
__global__ void __launch_bounds__(kLeafWarps * 32)
    pyramid_leaf_kernel(const float* __restrict__ pos,
                        const float* __restrict__ mass,
                        float* __restrict__ rows, float* __restrict__ boxes,
                        int n_leaves, int leaf_size, int n_live, int up_row) {
  __shared__ Node s_node[kLeafWarps];
  __shared__ float s_box[kLeafWarps][6];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int leaf = blockIdx.x * kLeafWarps + warp;
  float m = 0.0f, sx = 0.0f, sy = 0.0f, sz = 0.0f;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  const int64_t first = (int64_t)leaf * leaf_size;
  if (leaf < n_leaves) {
#pragma unroll 4
    for (int j = lane; j < leaf_size; j += 32) {
      const int64_t r = first + j;
      const float w = mass[r];
      const float x = pos[3 * r], y = pos[3 * r + 1], z = pos[3 * r + 2];
      m += w;
      sx += w * x;
      sy += w * y;
      sz += w * z;
      if (r < n_live) {
        lo[0] = fminf(lo[0], x), lo[1] = fminf(lo[1], y);
        lo[2] = fminf(lo[2], z);
        hi[0] = fmaxf(hi[0], x), hi[1] = fmaxf(hi[1], y);
        hi[2] = fmaxf(hi[2], z);
      }
    }
  }
  m = warp_sum(m);
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  sz = warp_sum(sz);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = warp_min(lo[c]);
    hi[c] = warp_max(hi[c]);
  }
  Node n = {};
  n.v[3] = m;
  if (m > 0.0f) {
    const float div = fmaxf(m, 1e-30f);
    n.v[0] = sx / div, n.v[1] = sy / div, n.v[2] = sz / div;
    if (QUAD) {
      float q[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int j = lane; j < leaf_size; j += 32) {
        const int64_t r = first + j;
        const float w = mass[r];
        const float dx = pos[3 * r] - n.v[0], dy = pos[3 * r + 1] - n.v[1],
                    dz = pos[3 * r + 2] - n.v[2];
        const float d2 = dx * dx + dy * dy + dz * dz;
        q[0] += w * (3.0f * dx * dx - d2);
        q[1] += w * (3.0f * dy * dy - d2);
        q[2] += w * 3.0f * dx * dy;
        q[3] += w * 3.0f * dx * dz;
        q[4] += w * 3.0f * dy * dz;
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) n.v[4 + c] = warp_sum(q[c]);
    }
  }
  if (lane == 0) {
    s_node[warp] = n;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_box[warp][c] = lo[c];
      s_box[warp][3 + c] = hi[c];
    }
    if (leaf < n_leaves) {
      const float origin[3] = {0.0f, 0.0f, 0.0f};
      put_row<QUAD>(rows, leaf, n, origin);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float box[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) box[c] = s_box[0][c];
    for (int k = 1; k < kLeafWarps; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        box[c] = fminf(box[c], s_box[k][c]);
        box[3 + c] = fmaxf(box[3 + c], s_box[k][3 + c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) boxes[6 * blockIdx.x + c] = box[c];
    if (up_row >= 0) {
      // The block's 8 leaves are node blockIdx.x of level 1.
      const Node up = combine<QUAD>(kLeafWarps,
                                    [&](int k) { return s_node[k]; });
      const float origin[3] = {0.0f, 0.0f, 0.0f};
      put_row<QUAD>(rows, (int64_t)up_row + blockIdx.x, up, origin);
    }
  }
}

template <bool QUAD>
__global__ void __launch_bounds__(kTopThreads)
    pyramid_top_kernel(float* __restrict__ rows,
                       const float* __restrict__ boxes, int n_boxes,
                       Plan plan, int first_level,
                       float* __restrict__ sentinel) {
  __shared__ float s_box[kTopThreads / 32][6];
  __shared__ float s_sent[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float box[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                  -INFINITY};
  for (int i = threadIdx.x; i < n_boxes; i += kTopThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      box[c] = fminf(box[c], boxes[6 * i + c]);
      box[3 + c] = fmaxf(box[3 + c], boxes[6 * i + 3 + c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    box[c] = warp_min(box[c]);
    box[3 + c] = warp_max(box[3 + c]);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s_box[warp][c] = box[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kTopThreads / 32; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        box[c] = fminf(box[c], s_box[k][c]);
        box[3 + c] = fmaxf(box[3 + c], s_box[k][3 + c]);
      }
    }
    // bh.domain_cube, each operation rounded as PyTorch rounds it (no
    // contraction): centre = 0.5 (lo + hi), half = max(0.5 (hi - lo))
    // clamped to 1e-12 and scaled by 1 + 1e-6, sentinel = centre + 4 half.
    float half = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float h = __fmul_rn(0.5f, __fsub_rn(box[3 + c], box[c]));
      half = c == 0 ? h : fmaxf(half, h);
    }
    half = __fmul_rn(fmaxf(half, 1e-12f), static_cast<float>(1.0 + 1e-6));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float centre = __fmul_rn(0.5f, __fadd_rn(box[c], box[3 + c]));
      s_sent[c] = __fadd_rn(centre, __fmul_rn(4.0f, half));
      sentinel[c] = s_sent[c];
    }
  }
  __syncthreads();
  for (int k = 0; k < plan.n_levels; ++k) {
    const int w = plan.width[k], padded = (w + 7) & ~7;
    for (int i = w + threadIdx.x; i < padded; i += kTopThreads)
      put_pad<QUAD>(rows, (int64_t)plan.row[k] + i);
  }
  for (int k = first_level; k < plan.n_levels; ++k) {
    const int w = plan.width[k], b = plan.width[k - 1] / w;
    const int64_t below = plan.row[k - 1];
    for (int i = threadIdx.x; i < w; i += kTopThreads) {
      const Node n = combine<QUAD>(b, [&](int c) {
        return get_row<QUAD>(rows, below + (int64_t)i * b + c);
      });
      put_row<QUAD>(rows, (int64_t)plan.row[k] + i, n, s_sent);
    }
    __syncthreads();
  }
}

// Rows [0, n_rows) hold the levels the leaf kernel wrote: a node row of
// mass 0 takes the sentinel as centre; pad rows stay zero.
template <bool QUAD>
__global__ void __launch_bounds__(kFillThreads)
    pyramid_fill_kernel(float* __restrict__ rows, int n_rows, Plan plan,
                        const float* __restrict__ sentinel) {
  const int r = blockIdx.x * kFillThreads + threadIdx.x;
  if (r >= n_rows) return;
  constexpr int C = QUAD ? 12 : 4;
  float* row = rows + (int64_t)r * C;
  if (row[3] > 0.0f) return;
  int k = 0;
  while (k + 1 < plan.n_levels && plan.row[k + 1] <= r) ++k;
  if (r - plan.row[k] >= plan.width[k]) return;  // a pad row
  row[0] = sentinel[0];
  row[1] = sentinel[1];
  row[2] = sentinel[2];
}

// The level plan from the host: n_levels widths then n_levels first rows.
// Each width divides the one below it, the leaves are n_leaves, and each
// level starts at the 8-aligned row after the one below it.
bool read_plan(const int* host, int n_levels, int n_leaves, int n_rows,
               Plan* plan) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  plan->n_levels = n_levels;
  int next = 0;
  for (int k = 0; k < n_levels; ++k) {
    plan->width[k] = host[k];
    plan->row[k] = host[n_levels + k];
    if (plan->width[k] < 1 || plan->row[k] != next) return false;
    if (k == 0 ? plan->width[0] != n_leaves
               : plan->width[k - 1] % plan->width[k] != 0)
      return false;
    next += (plan->width[k] + 7) & ~7;
  }
  for (int k = n_levels; k < kMaxLevels; ++k)
    plan->width[k] = 0, plan->row[k] = next;
  return next == n_rows;
}

// The levels the leaf kernel builds: the leaves, and level 1 where its
// radix is 8 (a block's octet of leaves is one of its nodes).
int leaf_levels(const Plan& plan) {
  return plan.n_levels > 1 && plan.width[0] == 8 * plan.width[1] ? 2 : 1;
}

}  // namespace

// The leaves (and level 1 where its radix is 8) of the pyramid over pos
// (n_leaves * leaf_size, 3) and mass: rows of the (n_rows, 12 | 4) table,
// one box of live rows a block in boxes (ceil(n_leaves / 8), 6).
extern "C" int pnb_pyramid_leaves(const void* pos, const void* mass,
                                  void* rows, void* boxes, const void* plan,
                                  int n_levels, int n_leaves, int leaf_size,
                                  int n_live, int n_rows, int quad,
                                  void* stream) {
  Plan p;
  if (leaf_size < 1 || n_live < 1 ||
      !read_plan(static_cast<const int*>(plan), n_levels, n_leaves, n_rows,
                 &p))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_leaves + kLeafWarps - 1) / kLeafWarps;
  const int up_row = leaf_levels(p) == 2 ? p.row[1] : -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto ps = static_cast<const float*>(pos);
  auto ms = static_cast<const float*>(mass);
  auto rw = static_cast<float*>(rows);
  auto bx = static_cast<float*>(boxes);
  if (quad)
    pyramid_leaf_kernel<true><<<blocks, kLeafWarps * 32, 0, st>>>(
        ps, ms, rw, bx, n_leaves, leaf_size, n_live, up_row);
  else
    pyramid_leaf_kernel<false><<<blocks, kLeafWarps * 32, 0, st>>>(
        ps, ms, rw, bx, n_leaves, leaf_size, n_live, up_row);
  return (int)cudaGetLastError();
}

// The sentinel (3 floats) from the leaf kernel's boxes, every level above
// the leaf kernel's and every level's pad rows.
extern "C" int pnb_pyramid_top(void* rows, const void* boxes,
                               void* sentinel, const void* plan,
                               int n_levels, int n_leaves, int n_rows,
                               int quad, void* stream) {
  Plan p;
  if (!read_plan(static_cast<const int*>(plan), n_levels, n_leaves, n_rows,
                 &p))
    return (int)cudaErrorInvalidValue;
  const int n_boxes = (n_leaves + kLeafWarps - 1) / kLeafWarps;
  auto st = static_cast<cudaStream_t>(stream);
  auto rw = static_cast<float*>(rows);
  auto bx = static_cast<const float*>(boxes);
  auto se = static_cast<float*>(sentinel);
  if (quad)
    pyramid_top_kernel<true><<<1, kTopThreads, 0, st>>>(
        rw, bx, n_boxes, p, leaf_levels(p), se);
  else
    pyramid_top_kernel<false><<<1, kTopThreads, 0, st>>>(
        rw, bx, n_boxes, p, leaf_levels(p), se);
  return (int)cudaGetLastError();
}

// The sentinel as centre of the empty nodes of the leaf kernel's levels.
extern "C" int pnb_pyramid_fill(void* rows, const void* sentinel,
                                const void* plan, int n_levels, int n_leaves,
                                int n_rows, int quad, void* stream) {
  Plan p;
  if (!read_plan(static_cast<const int*>(plan), n_levels, n_leaves, n_rows,
                 &p))
    return (int)cudaErrorInvalidValue;
  const int levels = leaf_levels(p);
  const int filled =
      levels < p.n_levels ? p.row[levels] : n_rows;  // rows of those levels
  const int blocks = (filled + kFillThreads - 1) / kFillThreads;
  auto st = static_cast<cudaStream_t>(stream);
  auto rw = static_cast<float*>(rows);
  auto se = static_cast<const float*>(sentinel);
  if (quad)
    pyramid_fill_kernel<true><<<blocks, kFillThreads, 0, st>>>(rw, filled, p,
                                                               se);
  else
    pyramid_fill_kernel<false><<<blocks, kFillThreads, 0, st>>>(rw, filled, p,
                                                                se);
  return (int)cudaGetLastError();
}
