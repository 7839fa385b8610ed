// Device code shared by the GLM kernels (fused_glm.cu: B1 and B2;
// fused_hess.cu: B3): the four pointwise losses with their first and second
// derivatives in the margin, the storage-type helpers, the row stream (a
// ring of bulk copies into shared memory, and the rows' scalars staged
// ahead of it), the fixed-order cross-CTA sum that runs in the launch that
// wrote the partials, and the dispatch over loss and storage type.
//
// The losses match photon_ml_tpu_torch/function/losses.py, which matches
// the JAX package's function/losses.py branch for branch.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace glm {

// Order matches PointwiseLoss.kernel_id.
enum LossId { LOSS_LINEAR = 0, LOSS_LOGISTIC = 1, LOSS_POISSON = 2, LOSS_SMOOTHED_HINGE = 3 };

__device__ __forceinline__ float log1p_exp(float x) {
  // jnp.logaddexp(0, x): max(0, x) + log1p(exp(-|x|)); NaN stays NaN
  if (isnan(x)) return x;
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int LOSS>
__device__ __forceinline__ void loss_and_dz(float z, float y, float& l, float& dz) {
  if (LOSS == LOSS_LOGISTIC) {
    if (y > 0.5f) {
      l = log1p_exp(-z);
      dz = -sigmoid(-z);
    } else {
      l = log1p_exp(z);
      dz = sigmoid(z);
    }
  } else if (LOSS == LOSS_LINEAR) {
    float d = z - y;
    l = d * d / 2.0f;
    dz = d;
  } else if (LOSS == LOSS_POISSON) {
    float p = expf(z);
    l = p - z * y;
    dz = p - y;
  } else {  // smoothed hinge
    float m = (y < 0.5f) ? -1.0f : 1.0f;
    float zy = m * z;
    float u = 1.0f - zy;
    l = (zy <= 0.0f) ? (0.5f - zy) : ((zy < 1.0f) ? 0.5f * (u * u) : 0.0f);
    float der = (zy < 0.0f) ? -1.0f : ((zy < 1.0f) ? zy - 1.0f : 0.0f);
    dz = der * m;
  }
}

// Second derivative in the margin (the smoothed hinge's is the a.e. one:
// 1 on its quadratic segment).
template <int LOSS>
__device__ __forceinline__ float dzz(float z, float y) {
  if (LOSS == LOSS_LOGISTIC) {
    const float s = sigmoid(z);
    return s * (1.0f - s);
  } else if (LOSS == LOSS_LINEAR) {
    return 1.0f;
  } else if (LOSS == LOSS_POISSON) {
    return expf(z);
  } else {
    const float zy = ((y < 0.5f) ? -1.0f : 1.0f) * z;
    return (zy >= 0.0f && zy < 1.0f) ? 1.0f : 0.0f;
  }
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round to the storage precision's matrix-unit operand type (identity for f32).
template <typename T> __device__ __forceinline__ float round_like(float v);
template <> __device__ __forceinline__ float round_like<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_like<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---- the row stream: a ring of bulk copies into shared memory ---------------
//
// One thread issues each copy; the copy reports its bytes to the stage's
// mbarrier, and every thread waits on that barrier for the stage's n-th use
// with parity n & 1.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Every stage's barrier expects one arrival (the issuing thread's) per use.
// Call from one thread, then __syncthreads() before any use.
__device__ __forceinline__ void ring_init(uint64_t* bars, int stages) {
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + s)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`. One thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// A copy that never lands (a fault of the caller's sizes) ends the launch with
// an error after about ten seconds instead of hanging the card.
__device__ __forceinline__ void ring_wait(uint64_t* bar, unsigned parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  }
}

// The per-row scalars (w, off, y) of a CTA's row tiles, staged in shared
// memory two tiles ahead of their use: thread r < bn loads row r of tile
// t + 2 into registers at the top of iteration t and stores it at the end,
// so the loads' latency hides under a whole tile of work. `s` holds three
// slots of [3][bn] floats (w, off, y); rows past the tile read as weight 0.
struct RowScalars {
  float* s;
  int bn;
  float w, off, y;
  bool pending;

  __device__ __forceinline__ const float* slot(int t) const { return s + (t % 3) * 3 * bn; }

  __device__ __forceinline__ void load(const float* __restrict__ gw, const float* __restrict__ goff,
                                       const float* __restrict__ gy, long long r0, int rows) {
    const int r = threadIdx.x;
    pending = r < bn;
    w = off = y = 0.0f;
    if (r < rows) {
      w = gw[r0 + r];
      off = goff[r0 + r];
      y = gy[r0 + r];
    }
  }

  __device__ __forceinline__ void store(int t) {
    if (!pending) return;
    float* p = s + (t % 3) * 3 * bn;
    p[threadIdx.x] = w;
    p[bn + threadIdx.x] = off;
    p[2 * bn + threadIdx.x] = y;
    pending = false;
  }
};

// ---- one cut of the rows per CTA ------------------------------------------
struct RowRange {
  long long begin, end;
};

__device__ __forceinline__ RowRange cta_rows(long long n, long long rows_per_cta) {
  const long long b = (long long)blockIdx.x * rows_per_cta;
  const long long e = b + rows_per_cta;
  return {b < n ? b : n, e < n ? e : n};
}

// ---- the cross-CTA sum, in the launch that wrote the partials ---------------
//
// After this CTA has written its partial: true, in every thread, for the CTA
// that is the `count`-th to arrive at *ticket (an integer counter; no float
// atomics). That CTA sets the counter back to 0, so the next launch on the
// stream finds it zeroed. `s_flag` is a shared int.
__device__ __forceinline__ bool last_arrival(unsigned* ticket, unsigned count, int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ticket, 1u) == count - 1;
    if (last) atomicExch(ticket, 0u);
    *s_flag = last;
  }
  __syncthreads();
  const bool last = *s_flag != 0;
  if (last) __threadfence();
  return last;
}

// Column j < width of rows [m0, m1) of p (row m at p + m * stride), summed
// in row order and handed to store(j, sum), for every j; all threads of the
// block call it. A thread sums four columns at once, four rows a step, so
// sixteen loads are in flight; they go through L2 (other CTAs wrote p).
template <int NT, typename Store>
__device__ __forceinline__ void sum_rows(const float* p, int m0, int m1, long long stride,
                                         long long width, Store store) {
  for (long long j0 = threadIdx.x; j0 < width; j0 += 4 * NT) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int m = m0;
    for (; m + 4 <= m1; m += 4) {
      float v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long j = j0 + q * NT;
          v[r][q] = j < width ? __ldcg(p + (long long)(m + r) * stride + j) : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q] += v[r][q];
    }
    for (; m < m1; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long j = j0 + q * NT;
        if (j < width) s[q] += __ldcg(p + (long long)m * stride + j);
      }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j0 + q * NT < width) store(j0 + q * NT, s[q]);
  }
}

// Deterministic sum of the partials part[n_parts][width] that CTA b wrote to
// row b. CTAs [g*group, (g+1)*group) form group g: the last of them to
// arrive sums the group's rows in CTA order into row n_parts + g, and the
// last group to finish calls last(part + n_parts * width, n_groups) in every
// thread of its CTA, to sum those rows in group order. The order of every
// addition depends only on (n_parts, group), so results repeat bitwise.
// Uses ticket[0 .. n_groups], which are zero on entry and again on exit.
template <int NT, typename Last>
__device__ void grid_sum(float* part, long long width, int n_parts, int group, unsigned* ticket,
                         int* s_flag, Last last) {
  const int n_groups = (n_parts + group - 1) / group;
  const int g = blockIdx.x / group;
  const int m0 = g * group, m1 = min(n_parts, m0 + group);
  if (!last_arrival(ticket + g, m1 - m0, s_flag)) return;
  float* gpart = part + (long long)n_parts * width;
  sum_rows<NT>(part, m0, m1, width, width, [&](long long j, float s) { gpart[g * width + j] = s; });
  if (!last_arrival(ticket + n_groups, n_groups, s_flag)) return;
  last(static_cast<const float*>(gpart), n_groups);
}

}  // namespace glm

// Dispatch helpers: expand M(<compile-time value>, args...) for a run-time
// loss id or storage type id, returning cudaErrorInvalidValue for an
// unknown one. Storage type 0 = f32, 1 = bf16.
#define GLM_SWITCH_LOSS(loss, M, ...)                                             \
  switch (loss) {                                                                 \
    case glm::LOSS_LINEAR: { M(glm::LOSS_LINEAR, __VA_ARGS__) }                   \
    case glm::LOSS_LOGISTIC: { M(glm::LOSS_LOGISTIC, __VA_ARGS__) }               \
    case glm::LOSS_POISSON: { M(glm::LOSS_POISSON, __VA_ARGS__) }                 \
    case glm::LOSS_SMOOTHED_HINGE: { M(glm::LOSS_SMOOTHED_HINGE, __VA_ARGS__) }   \
    default: return cudaErrorInvalidValue;                                        \
  }

#define GLM_SWITCH_DTYPE(dtype, M, ...)                                           \
  if (dtype == 0) { M(float, __VA_ARGS__) }                                       \
  if (dtype == 1) { M(__nv_bfloat16, __VA_ARGS__) }                               \
  return cudaErrorInvalidValue;
