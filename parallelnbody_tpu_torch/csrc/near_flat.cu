// K9, K10 and K11: the flat-list near-field kernels of three TPU
// experiments, hand-written for Hopper (sm_90a).
//
// Replace the Pallas kernels of scripts/flat_kernel_proto.py (`kernel`,
// called through `flat_near`), scripts/flat_kernel_tune.py
// (`make_kernel(step_packs, out_mode)`, through `run`) and
// scripts/flat_kernel_tune2.py (`make_kernel(step_packs, mode, g)`, through
// `run`). Wrappers, row starts, list packing and plain PyTorch versions:
// parallelnbody_tpu_torch/ops/near_flat.py (`flat_near`, `flat_tune`,
// `flat_tune2`, `row_starts`, `pack_lists`, `*_plain`). No path of the
// system runs them; tools/flat_kernel.py times them, and against K1
// (near_field.cu) on K1's own lists cut into this form.
//
// What they compute. The near field as a flat work list: step c (of S,
// CSR-grouped by target row, rows[c] ascending, every row owning a step)
// holds P packs of 128 sources, src[c, p] = (4, 128) [x; y; z; m]; the
// target row holds G targets, tgt[row] = (4, G). Every target adds, for
// every source of its row's steps,
//     u = rsqrt(r^2 + eps^2) (GUARD_ZERO: 0 where r^2 = 0),  w = m u^3,
//     [w dx, w dy, w dz, m u]   (the last only with COMPUTE_POT)
// and out[row] = (4, G) raw sums. What differs is the summation order,
// kept from each script:
//   * K9 and K10: each pack summed over its 128 sources, the packs added
//     into the step's sum in order, the steps into the row's in order.
//   * K11: sums kept per source lane (128 a target and component) across
//     the packs, reduced over the lanes once a step ("step", the step's
//     sum then added into the row's) or once a row ("row", the lanes
//     carried across the row's steps).
//
// What bounds them. A pair is K1's 18 FP32 operations (19 with the
// potential) and one rsqrt, and a pack of 2 KB serves 128 G pairs: FP32
// issue, as K1 (bytes only at tiny G).
//
// Design. A TPU grid runs its steps in order, so the scripts carry a row's
// sum from step to step in the output block ("rmw") or in scratch ("row").
// A card runs blocks in no order, and the port uses no float atomics, so
// two launch shapes replace that:
//   * ROW: one block per target row (K11: per row and group of 32 targets)
//     walks the row's steps in order, from the row starts that the wrapper
//     finds once in `rows`, and writes the row once. K9, K10 "rmw", K11.
//   * STEPS: one block per step writes its (4, G) step sum to `partial`;
//     flat_combine_kernel then adds each row's partials in step order
//     (0 + p0 = p0 exactly, so the bits are ROW's). K10 "steps".
// Pack-sum kernel: one thread per target; a step's P packs are staged
// into shared memory as float4 [x, y, z, m] (a broadcast LDS.128 a pair).
// Lane kernel (K11): a target's 128 lane sums do not fit one thread, so a
// thread is a source lane: 4 groups of 128 threads, each thread holding 8
// targets' lane sums of its lane and reading its lane's source from the
// staged step; the lanes are reduced by warp shuffles and then the 4 warps
// of a group in order, a fixed order, so repeat launches give the same
// bits.

#include <cuda_runtime.h>

#include <type_traits>

#include "terms.cuh"

namespace {

constexpr int kLanes = 128;      // sources a pack
constexpr int kPackFloats = 512;  // (4, 128)
constexpr int kGroups = 4;       // lane kernel: groups of 128 threads
constexpr int kLaneR = 8;        // lane kernel: targets a thread
constexpr int kLaneTargets = kGroups * kLaneR;  // targets a lane block

// The P packs of step c into shared memory as float4 [x, y, z, m].
template <int P>
__device__ __forceinline__ void stage_step(float4* pack, const float* src,
                                           long long c) {
  const float* s = src + c * P * kPackFloats;
  for (int q = threadIdx.x; q < P * kLanes; q += blockDim.x) {
    const float* b = s + (q / kLanes) * kPackFloats + (q % kLanes);
    pack[q] = make_float4(b[0], b[kLanes], b[2 * kLanes], b[3 * kLanes]);
  }
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// K9 / K10: ROW (STEPS false: block = row, steps [starts[row],
// starts[row + 1]), dst = out) or STEPS (block = step, dst = partial).
template <int P, bool GUARD_ZERO, bool COMPUTE_POT, bool STEPS>
__global__ void __launch_bounds__(1024)
    flat_pack_kernel(const int* __restrict__ starts,
                     const int* __restrict__ rows,
                     const float* __restrict__ tgt,
                     const float* __restrict__ src, float* __restrict__ dst,
                     int G, float eps2) {
  __shared__ float4 pack[P * kLanes];
  const int i = threadIdx.x;
  int row, c0, c1;
  if (STEPS) {
    c0 = blockIdx.x;
    c1 = c0 + 1;
    row = rows[c0];
  } else {
    row = blockIdx.x;
    c0 = starts[row];
    c1 = starts[row + 1];
  }
  const float* tt = tgt + (long long)row * 4 * G;
  const float xi = tt[i], yi = tt[G + i], zi = tt[2 * G + i];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = c0; c < c1; ++c) {
    __syncthreads();  // the last step's packs are swept by all
    stage_step<P>(pack, src, c);
    __syncthreads();
    float4 step = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int j = 0; j < P; ++j) {
      float4 ps = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int l = 0; l < kLanes; ++l) {
        const float4 p = pack[j * kLanes + l];
        pnb::monopole_term<GUARD_ZERO, COMPUTE_POT>(p.x - xi, p.y - yi,
                                                    p.z - zi, p.w, eps2, ps);
      }
      add4(step, ps);
    }
    add4(acc, step);
  }
  float* o = dst + (long long)(STEPS ? c0 : row) * 4 * G;
  o[i] = acc.x;
  o[G + i] = acc.y;
  o[2 * G + i] = acc.z;
  o[3 * G + i] = COMPUTE_POT ? acc.w : 0.f;
}

// K10 "steps": out[row] = the row's step partials added in step order.
__global__ void flat_combine_kernel(const int* __restrict__ starts,
                                    const float* __restrict__ partial,
                                    float* __restrict__ out, int n_rows,
                                    int G) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_row = 4LL * G;
  if (k >= n_rows * per_row) return;
  const int row = (int)(k / per_row);
  const long long e = k % per_row;
  const int c0 = starts[row], c1 = starts[row + 1];
  float s = partial[c0 * per_row + e];
  for (int c = c0 + 1; c < c1; ++c) s += partial[c * per_row + e];
  out[k] = s;
}

// The 128 lane sums of each of a group's kLaneR targets and 4 components,
// reduced: warp shuffles, then the group's 4 warps in order (red: shared,
// kGroups x 4 x kLaneR float4). Returns the sum in the thread of lane r of
// the group's first warp for target r (r < kLaneR); every thread of the
// block must call it.
__device__ __forceinline__ float4 reduce_lanes(float4 (&a)[kLaneR],
                                               float4 (*red)[4][kLaneR]) {
  const int g = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
#pragma unroll
  for (int r = 0; r < kLaneR; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a[r].x += __shfl_xor_sync(0xffffffffu, a[r].x, o);
      a[r].y += __shfl_xor_sync(0xffffffffu, a[r].y, o);
      a[r].z += __shfl_xor_sync(0xffffffffu, a[r].z, o);
      a[r].w += __shfl_xor_sync(0xffffffffu, a[r].w, o);
    }
  }
  if (l % 32 == 0) {
#pragma unroll
    for (int r = 0; r < kLaneR; ++r) red[g][l / 32][r] = a[r];
  }
  __syncthreads();
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (l < kLaneR) {
    s = red[g][0][l];
#pragma unroll
    for (int w = 1; w < 4; ++w) add4(s, red[g][w][l]);
  }
  return s;
}

// K11: block = (row, group of kLaneTargets targets); thread = (group g,
// lane l), targets t0 + g * kLaneR + r. ROW_MODE: the lane sums carried
// across the row's steps and reduced once; else reduced each step and the
// step sums added into the row's.
template <int P, bool COMPUTE_POT, bool ROW_MODE>
__global__ void __launch_bounds__(kGroups * kLanes)
    flat_lane_kernel(const int* __restrict__ starts,
                     const float* __restrict__ tgt,
                     const float* __restrict__ src, float* __restrict__ out,
                     int G, float eps2) {
  __shared__ float4 pack[P * kLanes];
  __shared__ float4 red[kGroups][4][kLaneR];
  const int blocks_per_row = G / kLaneTargets;
  const int row = blockIdx.x / blocks_per_row;
  const int g = threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const int t0 = (blockIdx.x % blocks_per_row) * kLaneTargets + g * kLaneR;
  const float* tt = tgt + (long long)row * 4 * G + t0;
  float xi[kLaneR], yi[kLaneR], zi[kLaneR];
  float4 a[kLaneR];
#pragma unroll
  for (int r = 0; r < kLaneR; ++r) {
    xi[r] = tt[r];
    yi[r] = tt[G + r];
    zi[r] = tt[2 * G + r];
    a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c0 = starts[row], c1 = starts[row + 1];
  for (int c = c0; c < c1; ++c) {
    __syncthreads();
    stage_step<P>(pack, src, c);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < P; ++j) {
      const float4 p = pack[j * kLanes + l];
#pragma unroll
      for (int r = 0; r < kLaneR; ++r)
        pnb::monopole_term<false, COMPUTE_POT>(p.x - xi[r], p.y - yi[r],
                                               p.z - zi[r], p.w, eps2, a[r]);
    }
    if (!ROW_MODE || c == c1 - 1) {
      const float4 s = reduce_lanes(a, red);
      add4(acc, s);
#pragma unroll
      for (int r = 0; r < kLaneR; ++r) a[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (l < kLaneR) {
    float* o = out + (long long)row * 4 * G + t0 + l;
    o[0] = acc.x;
    o[G] = acc.y;
    o[2 * G] = acc.z;
    o[3 * G] = COMPUTE_POT ? acc.w : 0.f;
  }
}

template <int P, bool GUARD_ZERO, bool COMPUTE_POT>
cudaError_t launch_pack(const int* starts, const int* rows, const float* tgt,
                        const float* src, float* out, float* partial,
                        int n_rows, int n_steps, int G, float eps2, bool steps,
                        cudaStream_t stream) {
  if (!steps) {
    flat_pack_kernel<P, GUARD_ZERO, COMPUTE_POT, false>
        <<<n_rows, G, 0, stream>>>(starts, rows, tgt, src, out, G, eps2);
    return cudaGetLastError();
  }
  flat_pack_kernel<P, GUARD_ZERO, COMPUTE_POT, true>
      <<<n_steps, G, 0, stream>>>(starts, rows, tgt, src, partial, G, eps2);
  const long long n = (long long)n_rows * 4 * G;
  flat_combine_kernel<<<(int)((n + 255) / 256), 256, 0, stream>>>(
      starts, partial, out, n_rows, G);
  return cudaGetLastError();
}

template <int P, bool COMPUTE_POT, bool ROW_MODE>
cudaError_t launch_lane(const int* starts, const float* tgt, const float* src,
                        float* out, int n_rows, int G, float eps2,
                        cudaStream_t stream) {
  const long long blocks = (long long)n_rows * (G / kLaneTargets);
  flat_lane_kernel<P, COMPUTE_POT, ROW_MODE>
      <<<(int)blocks, kGroups * kLanes, 0, stream>>>(starts, tgt, src, out, G,
                                                      eps2);
  return cudaGetLastError();
}

// f(std::true_type()) or f(std::false_type()), as b says.
template <class F>
int with_bool(bool b, F f) {
  return b ? f(std::true_type()) : f(std::false_type());
}

}  // namespace

// shape: 0 ROW pack sums (K9, K10 "rmw"), 1 STEPS pack sums (K10 "steps",
// partial (n_steps, 4, G)), 2 lane sums reduced a step (K11 "step"), 3
// lane sums reduced a row (K11 "row"; guard_zero not taken). step_packs 4,
// 8 or 16; G at most 1024, and a multiple of 32 for shapes 2 and 3.
extern "C" int pnb_near_flat(const void* starts, const void* rows,
                             const void* tgt, const void* src, void* out,
                             void* partial, int n_rows, int n_steps,
                             int leaf_size, int step_packs, int shape,
                             float eps2, int guard_zero, int compute_pot,
                             void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const int G = leaf_size;
  if (G <= 0 || G > 1024 || shape < 0 || shape > 3 ||
      (shape >= 2 && (G % kLaneTargets || guard_zero)))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const int*>(starts);
  auto rw = static_cast<const int*>(rows);
  auto t = static_cast<const float*>(tgt);
  auto sr = static_cast<const float*>(src);
  auto o = static_cast<float*>(out);
  auto pa = static_cast<float*>(partial);
  auto with_p = [&](auto p) {
    constexpr int P = decltype(p)::value;
    return with_bool(compute_pot, [&](auto cp) {
      constexpr bool CP = decltype(cp)::value;
      if (shape >= 2)
        return with_bool(shape == 3, [&](auto row_mode) {
          return (int)launch_lane<P, CP, decltype(row_mode)::value>(
              s, t, sr, o, n_rows, G, eps2, st);
        });
      return with_bool(guard_zero, [&](auto gz) {
        return (int)launch_pack<P, decltype(gz)::value, CP>(
            s, rw, t, sr, o, pa, n_rows, n_steps, G, eps2, shape == 1, st);
      });
    });
  };
  switch (step_packs) {
    case 4: return with_p(std::integral_constant<int, 4>());
    case 8: return with_p(std::integral_constant<int, 8>());
    case 16: return with_p(std::integral_constant<int, 16>());
    default: return (int)cudaErrorInvalidValue;
  }
}
