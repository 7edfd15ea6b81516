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
//   * K11: sums kept per source lane across the packs, reduced over the
//     lanes once a step ("step", the step's sum then added into the
//     row's) or once for the steps carried ("row").
//
// What bounds them. A pair is K1's 18 FP32 operations (19 with the
// potential) and one rsqrt, and a pack of 2 KB serves 128 G pairs: FP32
// issue, as K1 (bytes only at tiny G).
//
// K9 and K10. A TPU grid runs its steps in order, so the scripts carry a
// row's sum from step to step in the output block ("rmw"). A card runs
// blocks in no order, and the port uses no float atomics, so two launch
// shapes replace that:
//   * ROW: one block per target row walks the row's steps in order, from
//     the row starts that the wrapper finds once in `rows`, and writes the
//     row once. K9, K10 "rmw".
//   * STEPS: one block per step writes its (4, G) step sum to `partial`;
//     flat_combine_kernel then adds each row's partials in step order
//     (0 + p0 = p0 exactly, so the bits are ROW's). K10 "steps".
// One thread per target; a step's P packs are staged into shared memory
// as float4 [x, y, z, m] (a broadcast LDS.128 a pair).
//
// K11, what bounded the first design: a thread was one of a
// pack's 128 lanes for 8 targets, a block 512 threads over 32 targets of
// a row; 86 registers left one block an SM; every step was staged by
// scalar gathers between two barriers; each row was walked, and staged
// again, by G / 32 blocks, one block per (row, 32 targets), so the longest
// rows were the tail; and "step" reduced 128 lanes x 8 targets x 4
// components with shuffles every step. "row" at 8 packs ran 22.1-22.6 ms
// on the 1M lists' flat form (0.33 of its bound), "step" 31.5-32.0.
//
// K11, the design:
//   * Balanced work. The wrapper cuts each row's steps into work items of
//     at most near_flat.lane_chunk(P) steps (8192 sources, K1's item),
//     heaviest first, one block per item (bh_kernels.near_items); the sums
//     of a split row's items are added in item order by
//     flat_lane_combine_kernel, as K10 "steps" adds its steps. In "row"
//     mode an item carries its lane sums across its own steps and reduces
//     them once: the reduction falls at the item's end, not the row's.
//   * Fewer partial sums a target, more pairs an LDS. A block is kSlices
//     lane slices of T = G / R threads (one warp at G = 256), each thread
//     holding R targets (K1's rule: 8 at G = 256) and summing the 32 lanes
//     of its slice of every pack: a target has kSlices partial sums, not
//     128, and one broadcast LDS.128 serves R pairs (terms.cuh `sweep`).
//     The slices are added in slice order through shared memory, a fixed
//     order, so repeat launches give the same bits.
//   * Staging. A step's packs land in shared memory as float4 [x, y, z, m]
//     by 4-byte cp.async copies out of the (4, 128) packs, at most 8 packs
//     (16 KB) a buffer, the next buffer's in flight while this one is
//     swept, one barrier a buffer: 32 KB of ring a block at 8 and 16
//     packs, plus 16 KB for the reduction in "step" mode.
// What it reaches (tools/flat_kernel.py lists, NVIDIA H100 80GB HBM3 at
// 700 W, PERF.md §6): "row" at 8 packs 13.54 ms on the 1M lists' flat
// form, 0.542 of its bound (K1 with the potential 13.87 on the same
// pairs), "step" 14.24 (0.516), the difference the cost of a reduction a
// step. 14.3 SASS instructions a pair with the potential; 99-102
// registers and 32-48 KB of shared memory leave four 4-warp blocks an SM.

#include <cuda_runtime.h>

#include <type_traits>

#include "terms.cuh"

namespace {

constexpr int kLanes = 128;      // sources a pack
constexpr int kPackFloats = 512;  // (4, 128)
constexpr int kSlices = 4;       // lane kernel: lane slices a block
constexpr int kStagePacks = 8;   // lane kernel: packs a staging buffer

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

// K11. A block runs one work item (row, first step, end step, dst) of a
// row's steps; its threads are kSlices lane slices of T threads, thread
// (slice w, i0) holding the R targets i0 + r T of the row (those past G
// repeat target 0 and are not stored) and summing, for each of them, the
// sources of its slice's kLanes / kSlices lanes of every pack, pack by
// pack (one broadcast LDS.128 a source and R targets: every lane of a warp
// reads the same source).

// The float at src into the float at dst (shared memory), asynchronously.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// The PC packs from pack s on into shared memory as float4 [x, y, z, m],
// each float by a 4-byte cp.async from its (4, 128) pack, in flight until
// the caller waits for them.
template <int PC>
__device__ __forceinline__ void stage_packs_async(float4* pack,
                                                  const float* s) {
  for (int q = threadIdx.x; q < PC * kLanes; q += blockDim.x) {
    const float* b = s + (q / kLanes) * kPackFloats + (q % kLanes);
    float* d = reinterpret_cast<float*>(pack + q);
    cp_async4(d, b);
    cp_async4(d + 1, b + kLanes);
    cp_async4(d + 2, b + 2 * kLanes);
    cp_async4(d + 3, b + 3 * kLanes);
  }
}

// Reduces the kSlices slice sums of each target: every thread writes its
// R sums to red (slice-major, kSlices x R T float4) and zeroes them; after
// a barrier, thread k adds, for each target j = k + c * blockDim.x, the
// slices' sums in slice order into acc[c]. Every thread of the block must
// call it.
template <int R, int CR>
__device__ __forceinline__ void reduce_slices(pnb::Targets<R>& t, float4* red,
                                              int T, float4 (&acc)[CR]) {
  const int RT = R * T;
  const int w = threadIdx.x / T;
  const int i0 = threadIdx.x % T;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    red[w * RT + i0 + r * T] = t.s[r];
    t.s[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CR; ++c) {
    const int j = threadIdx.x + c * blockDim.x;
    if (j >= RT) continue;
    float4 s = red[j];
#pragma unroll
    for (int v = 1; v < kSlices; ++v) add4(s, red[v * RT + j]);
    add4(acc[c], s);
  }
}

// K11: ROW_MODE carries the slice sums across the item's steps and reduces
// them once; else they are reduced every step and the step sums added into
// the item's sum. The item's sum (targets j = threadIdx.x + c blockDim.x)
// is stored as the row (dst < 0) or into partial slot dst. A step is
// staged in stages of PC = min(P, kStagePacks) packs, double-buffered in
// shared memory: the next stage's copies are in flight while this one is
// swept, one barrier a stage (and one more a step in "step" mode).
template <int P, int R, bool COMPUTE_POT, bool ROW_MODE>
__global__ void __launch_bounds__(kSlices * 128)
    flat_lane_kernel(const int4* __restrict__ items,
                     const float* __restrict__ tgt,
                     const float* __restrict__ src, float* __restrict__ out,
                     float4* __restrict__ partial, int G, float eps2) {
  constexpr int CR = (R + kSlices - 1) / kSlices;
  constexpr int L = kLanes / kSlices;
  constexpr int PC = P < kStagePacks ? P : kStagePacks;
  constexpr int H = P / PC;  // stages a step
  extern __shared__ float4 smem[];
  float4* red = ROW_MODE ? smem : smem + 2 * PC * kLanes;
  const int T = blockDim.x / kSlices;
  const int w = threadIdx.x / T;
  const int i0 = threadIdx.x % T;
  const int4 item = items[blockIdx.x];
  const float* tt = tgt + (long long)item.x * 4 * G;
  pnb::Targets<R> t;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * T;
    const int j = i < G ? i : 0;
    t.x[r] = tt[j];
    t.y[r] = tt[G + j];
    t.z[r] = tt[2 * G + j];
    t.s[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 acc[CR];
#pragma unroll
  for (int c = 0; c < CR; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  // Stage q: packs (q % H) PC .. of step item.y + q / H.
  const float* first = src + (long long)item.y * P * kPackFloats;
  const int n = (item.z - item.y) * H;
  if (n > 0) stage_packs_async<PC>(smem, first);
  pnb::cp_async_commit();
  for (int q = 0; q < n; ++q) {
    pnb::cp_async_wait<0>();  // this thread's copies of stage q have landed
    __syncthreads();          // everyone's have; stage q - 1 is swept by all
    if (q + 1 < n)
      stage_packs_async<PC>(smem + ((q + 1) & 1) * PC * kLanes,
                            first + (long long)(q + 1) * PC * kPackFloats);
    pnb::cp_async_commit();
    const float4* packs = smem + (q & 1) * PC * kLanes + w * L;
#pragma unroll 1
    for (int p = 0; p < PC; ++p)
      pnb::sweep<R, false, COMPUTE_POT>(packs + p * kLanes, L, eps2, t);
    if (!ROW_MODE && q % H == H - 1) reduce_slices<R, CR>(t, red, T, acc);
  }
  if (ROW_MODE) {
    __syncthreads();  // every stage swept: red may take the ring's place
    reduce_slices<R, CR>(t, red, T, acc);
  }
  float* o = out + (long long)item.x * 4 * G;
#pragma unroll
  for (int c = 0; c < CR; ++c) {
    const int j = threadIdx.x + c * blockDim.x;
    if (j >= G) continue;
    if (item.w < 0) {
      o[j] = acc[c].x;
      o[G + j] = acc[c].y;
      o[2 * G + j] = acc[c].z;
      o[3 * G + j] = acc[c].w;  // 0 without the potential
    } else {
      partial[(long long)item.w * G + j] = acc[c];
    }
  }
}

// K11, rows cut into several items: splits[k] = (row, first partial,
// count); one thread per (split row, target) adds the partials in item
// order and writes the row.
__global__ void flat_lane_combine_kernel(const float4* __restrict__ partial,
                                         const int* __restrict__ splits,
                                         float* __restrict__ out, int n_split,
                                         int G) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)n_split * G) return;
  const int* sp = splits + 3 * (k / G);
  const int i = (int)(k % G);
  const float4* p = partial + (long long)sp[1] * G + i;
  float4 s = p[0];
  for (int c = 1; c < sp[2]; ++c) add4(s, p[(long long)c * G]);
  float* o = out + (long long)sp[0] * 4 * G;
  o[i] = s.x;
  o[G + i] = s.y;
  o[2 * G + i] = s.z;
  o[3 * G + i] = s.w;
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

template <int P, int R, bool COMPUTE_POT, bool ROW_MODE>
cudaError_t launch_lanes(const int4* items, const int* splits,
                         const float* tgt, const float* src, float* out,
                         float4* partial, int n_items, int n_split, int G,
                         float eps2, cudaStream_t stream) {
  const int T = 32 * ((G + 32 * R - 1) / (32 * R));  // whole warps a slice
  const size_t ring = 2 * (P < kStagePacks ? P : kStagePacks) * kLanes;
  const size_t red = (size_t)kSlices * R * T;
  const size_t smem =
      (ROW_MODE ? (ring > red ? ring : red) : ring + red) * sizeof(float4);
  auto kernel = flat_lane_kernel<P, R, COMPUTE_POT, ROW_MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_items, kSlices * T, smem, stream>>>(items, tgt, src, out,
                                                 partial, G, eps2);
  if (n_split > 0) {
    const long long n = (long long)n_split * G;
    flat_lane_combine_kernel<<<(int)((n + 255) / 256), 256, 0, stream>>>(
        partial, splits, out, n_split, G);
  }
  return cudaGetLastError();
}

// f(std::true_type()) or f(std::false_type()), as b says.
template <class F>
int with_bool(bool b, F f) {
  return b ? f(std::true_type()) : f(std::false_type());
}

}  // namespace

// shape: 0 ROW pack sums (K9, K10 "rmw"), 1 STEPS pack sums (K10 "steps",
// partial (n_steps, 4, G)). step_packs 4, 8 or 16; G at most 1024.
extern "C" int pnb_near_flat(const void* starts, const void* rows,
                             const void* tgt, const void* src, void* out,
                             void* partial, int n_rows, int n_steps,
                             int leaf_size, int step_packs, int shape,
                             float eps2, int guard_zero, int compute_pot,
                             void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  const int G = leaf_size;
  if (G <= 0 || G > 1024 || shape < 0 || shape > 1)
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

// K11 over its work items (items (n_items, 4) [row, first step, end step,
// dst], splits (n_split, 3) [row, first, n], partial (n_partial * G)
// float4): out (Ls, 4, G) written, every row by its items. row_mode 0 lane
// sums reduced a step ("step"), 1 once an item ("row"). step_packs 4, 8 or
// 16; G a multiple of 32, at most 1024.
extern "C" int pnb_near_flat_lanes(const void* items, const void* splits,
                                   const void* tgt, const void* src,
                                   void* out, void* partial, int n_items,
                                   int n_split, int leaf_size, int step_packs,
                                   int row_mode, int compute_pot, float eps2,
                                   void* stream) {
  if (n_items <= 0) return (int)cudaSuccess;
  const int G = leaf_size;
  if (G <= 0 || G > 1024 || G % 32) return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return (int)fn(static_cast<const int4*>(items),
                   static_cast<const int*>(splits),
                   static_cast<const float*>(tgt),
                   static_cast<const float*>(src), static_cast<float*>(out),
                   static_cast<float4*>(partial), n_items, n_split, G, eps2,
                   static_cast<cudaStream_t>(stream));
  };
  // R: the most targets a thread that still leave a slice one full warp
  // (K1's rule, near_field.cu).
  const int R = G >= 256 ? 8 : G >= 128 ? 4 : G >= 64 ? 2 : 1;
  auto with_r = [&](auto p, auto cp, auto rm) {
    constexpr int P = decltype(p)::value;
    constexpr bool CP = decltype(cp)::value;
    constexpr bool RM = decltype(rm)::value;
    switch (R) {
      case 8: return go(launch_lanes<P, 8, CP, RM>);
      case 4: return go(launch_lanes<P, 4, CP, RM>);
      case 2: return go(launch_lanes<P, 2, CP, RM>);
      default: return go(launch_lanes<P, 1, CP, RM>);
    }
  };
  auto with_p = [&](auto p) {
    return with_bool(compute_pot, [&](auto cp) {
      return with_bool(row_mode, [&](auto rm) { return with_r(p, cp, rm); });
    });
  };
  switch (step_packs) {
    case 4: return with_p(std::integral_constant<int, 4>());
    case 8: return with_p(std::integral_constant<int, 8>());
    case 16: return with_p(std::integral_constant<int, 16>());
    default: return (int)cudaErrorInvalidValue;
  }
}
