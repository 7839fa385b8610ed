// Kernels B1 and B2: one pass over the design matrix X for the GLM
// objective's value+gradient sums (B1) and its Hessian-vector product (B2).
//
// B1 replaces the Pallas TPU kernel photon_ml_tpu/ops/pallas_glm.py
// (fused_loss_grad_sums, kernel body _kernel). For rows i with weight w_i:
//
//   z_i   = (off_i + margin_shift) + X_i . coef
//   val   = sum_live w_i * l(z_i, y_i)
//   grad  = sum_live X_i^T (w_i * dz(z_i, y_i))
//   wsum  = sum_live w_i * dz(z_i, y_i)
//
// B2 replaces fused_hessian_vector_sums (kernel body _hvp_kernel). Each
// staged row feeds both of its products before the X^T u accumulation:
//
//   z_i   = (off_i + margin_shift) + X_i . coef
//   dv_i  = X_i . v + shift_v       (shift_v is dv's own shift; margin_shift
//                                    shifts z only)
//   u_i   = w_i * dzz(z_i, y_i) * dv_i
//   vec   = sum_live X_i^T u_i,   usum = sum_live u_i
//
// The stock path reads X three times per HVP (z, dv, X^T u); B2 reads it
// once, and TRON runs one HVP per conjugate-gradient step. margin_shift and
// shift_v are device scalars read by every CTA; margin_shift is added to the
// offset before the dot, the plain version's rounding order.
//
// A row is live iff w_i != 0 and i < n. Dead rows contribute exactly 0 and
// their X values are never multiplied (they are never loaded from the
// staged tile, and their dzz is never evaluated, so Poisson's exp(z) of an
// inf row stays inert). X is not padded.
//
// bf16 storage (the TPU kernels' _mxu_dtype contract): coef and v are
// rounded to bf16 before their products, and the row weight (w*dz or u) is
// rounded to bf16 before the X^T product; every product of two bf16 values
// is exact in f32 and all accumulation is f32.
//
// Bound on an H100: memory, for both. Per call a kernel must move
// N*D*sizeof(X) bytes of X plus 12*N bytes of (y, off, w) against 4*N*D
// (B1) or 6*N*D (B2) flops, one to two flops per byte for f32 storage,
// far below the card's ~20 flop/byte balance point for non-tensor-core f32.
// So the design reads X from device memory once, keeps many tiles in
// flight from the first cycle, and spends one launch per call:
//
//   * A persistent grid: as many CTAs per SM as fit, at most four (the
//     host's occupancy query; registers allow two), each owning one
//     contiguous range of rows fixed by N and the grid, walked in tiles of
//     BN rows (at most 16 KB). The
//     tiles' (w, off, y) are staged in shared memory two tiles ahead
//     (glm::RowScalars), and their loads go out before the first copies.
//   * When a row is 16-byte aligned (D * sizeof(X) % 16 == 0 and X's base
//     aligned), a tile is one contiguous span of X and arrives by one bulk
//     copy (cp.async.bulk) that completes on its stage's mbarrier, in a ring
//     of S = 4 stages: the CTA's first four tiles are requested before any
//     compute, and the copy of tile t+3 runs under the compute of tile t.
//     Otherwise each thread loads its values of a row directly.
//   * A row belongs to tpr threads (1 to 256, a power of two; each holds
//     16 of its values): they load their values once into registers,
//     reduce the row's dot products by shuffles (and, past one warp, through
//     shared memory), evaluate the row's weight each, bit for bit the same,
//     and add value * weight into column sums that stay in registers
//     across the CTA's tiles. X leaves shared memory once, and one barrier
//     per tile frees its stage.
//   * The cross-CTA sum in the same launch: every CTA writes one partial
//     (grad[D], val, wsum) and takes an integer ticket; the last CTA of each
//     group of CTAs sums its group's partials in CTA order, and the last
//     group sums the group sums in group order (glm::grid_sum). No float
//     atomics, so repeated calls give bitwise-identical results.
//
// The loss and the mode (B1 or B2) are template parameters; all four GLM
// losses are instantiated for both. Plain C interface, loaded with ctypes
// (no PyTorch headers).

#include "glm_common.cuh"

namespace {

using glm::round_like;
using glm::to_f32;

constexpr int NT = 256;  // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int PER = 16;  // values of a row each thread holds
constexpr int S = 4;     // stages of the async ring
constexpr int RED_BYTES = 16 * 1024;  // the end's slot sums: (NT / tpr) * D floats at most

// Byte offsets of the shared-memory carve-up, for the host's size and the
// kernel's pointers alike.
struct Layout {
  size_t rows, dot, wval, wsum, flag, x, stage, total;
};

__host__ __device__ inline Layout layout(int d, int bn, int elem, bool async) {
  Layout L;
  size_t o = 128;  // the ring's mbarriers
  L.rows = o;      // glm::RowScalars: [3][3][bn]
  o += 4 * 9 * (size_t)bn;
  L.dot = o;  // [2 steps][2 dots][NWARPS]: a row's per-warp dots when it spans warps
  o += 4 * 4 * NWARPS;
  L.wval = o;
  o += 4 * NWARPS;
  L.wsum = o;
  o += 4 * NWARPS;
  L.flag = o;
  o += 16;
  L.x = (o + 127) & ~size_t(127);
  L.stage = ((size_t)bn * d * elem + 127) & ~size_t(127);
  const size_t ring = async ? S * L.stage : 0;
  L.total = L.x + (ring > RED_BYTES ? ring : RED_BYTES);  // the slot sums reuse the ring
  return L;
}

// HVP = false: kernel B1 (per-row weight a = w*dz, scalars val and wsum).
// HVP = true: kernel B2 (a = u = w*dzz(z)*(x.v + shift_v), scalar usum in
// the wsum slot, val stays 0). part is [gridDim.x + groups][d + 2]; out is
// [d + 2] = (grad, val, wsum).
//
// A row belongs to tpr threads (a power of two, 1 .. NT): thread sl of the
// row holds its words sl, sl + tpr, ... (CPL words of VEC values, PER values
// in all), so a thread's columns are the same in every row. It keeps those
// values in registers from the dot to the X^T a update, with its
// coefficients and its column sums, so X is read from shared memory once.
template <typename T, int VEC, int LOSS, bool HVP>
__global__ void __launch_bounds__(NT) fused_rows_kernel(
    const T* __restrict__ X, const float* __restrict__ y, const float* __restrict__ off,
    const float* __restrict__ w, const float* __restrict__ coef, const float* __restrict__ vdir,
    const float* __restrict__ shift_z, const float* __restrict__ shift_v, long long n, int d,
    int bn, int tpr, long long rows_per_cta, int group, float* __restrict__ part,
    unsigned* __restrict__ ticket, float* __restrict__ out) {
  constexpr bool ASYNC = VEC * sizeof(T) == 16;
  constexpr int CPL = PER / VEC;  // words of a row per thread
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(d, bn, sizeof(T), ASYNC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  glm::RowScalars rs{reinterpret_cast<float*>(smem + L.rows), bn};
  float* s_dot = reinterpret_cast<float*>(smem + L.dot);
  float* s_wval = reinterpret_cast<float*>(smem + L.wval);
  float* s_wsum = reinterpret_cast<float*>(smem + L.wsum);
  int* s_flag = reinterpret_cast<int*>(smem + L.flag);
  T* s_x = reinterpret_cast<T*>(smem + L.x);
  const long long stage_elems = L.stage / sizeof(T);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = tid / tpr, sl = tid % tpr, rps = NT / tpr;  // rows per step
  const int words = d / VEC;  // VEC divides d on the async path
  const glm::RowRange rr = glm::cta_rows(n, rows_per_cta);
  const int n_tiles = (int)((rr.end - rr.begin + bn - 1) / bn);
  auto tile_r0 = [&](int t) { return rr.begin + (long long)t * bn; };
  auto tile_rows = [&](int t) {
    const long long left = rr.end - tile_r0(t);
    return (int)(left < bn ? left : bn);
  };
  auto issue = [&](int t) {  // tile t of this CTA into stage t % S
    glm::bulk_load(s_x + (t % S) * stage_elems, X + tile_r0(t) * d,
                   (unsigned)((long long)tile_rows(t) * d * sizeof(T)), bars + t % S);
  };
  // the first two tiles' row scalars go out before the tiles' bulk copies,
  // so they are not queued behind them
  glm::RowScalars rs1 = rs;
  if (n_tiles > 0) rs.load(w, off, y, tile_r0(0), tile_rows(0));
  if (n_tiles > 1) rs1.load(w, off, y, tile_r0(1), tile_rows(1));
  if (ASYNC && tid == 0) glm::ring_init(bars, S);
  __syncthreads();
  if (ASYNC && tid == 0)
    for (int t = 0; t < S && t < n_tiles; ++t) issue(t);

  // this thread's coefficients, rounded where the TPU's matrix unit rounds
  float cf[PER], cv[PER], acc[PER];
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int u = sl + i * tpr, e = u * VEC + k;
      cf[i * VEC + k] = u < words ? round_like<T>(coef[e]) : 0.0f;
      cv[i * VEC + k] = HVP && u < words ? round_like<T>(vdir[e]) : 0.0f;
      acc[i * VEC + k] = 0.0f;
    }
  const float sz = *shift_z;
  const float sv = HVP ? *shift_v : 0.0f;
  if (n_tiles > 0) rs.store(0);
  if (n_tiles > 1) rs1.store(1);
  __syncthreads();

  float acc_val = 0.0f, acc_wsum = 0.0f;
  int step = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const long long r0 = tile_r0(t);
    const int rows = tile_rows(t);
    if (t + 2 < n_tiles) rs.load(w, off, y, tile_r0(t + 2), tile_rows(t + 2));
    const float* s_w = rs.slot(t);
    const float* s_off = s_w + bn;
    const float* s_y = s_w + 2 * bn;
    const T* sx = s_x + (t % S) * stage_elems;
    if constexpr (ASYNC) glm::ring_wait(bars + t % S, (t / S) & 1);
    for (int rb = 0; rb < rows; rb += rps, ++step) {  // uniform over the CTA
      const int r = rb + slot;
      const float wt = r < rows ? s_w[r] : 0.0f;
      const bool live = wt != 0.0f;  // a dead row's values are never loaded
      float xv[PER], p1[VEC], p2[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) p1[k] = p2[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int u = sl + i * tpr;
        if (live && u < words) {
          if constexpr (ASYNC) {
            const uint4 raw = *reinterpret_cast<const uint4*>(sx + (long long)r * d + u * VEC);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int k = 0; k < VEC; ++k) xv[i * VEC + k] = to_f32<T>(e[k]);
          } else {
            xv[i] = to_f32<T>(X[(r0 + r) * d + u]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) xv[i * VEC + k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          p1[k] += xv[i * VEC + k] * cf[i * VEC + k];
          if constexpr (HVP) p2[k] += xv[i * VEC + k] * cv[i * VEC + k];
        }
      }
      float dot = 0.0f, dot2 = 0.0f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        dot += p1[k];
        if constexpr (HVP) dot2 += p2[k];
      }
      // the row's dots, in every one of its threads
      const int in_warp = tpr < 32 ? tpr : 32;
      for (int o = 1; o < in_warp; o <<= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if constexpr (HVP) dot2 += __shfl_xor_sync(0xffffffffu, dot2, o);
      }
      if (tpr > 32) {  // the row spans tpr / 32 warps
        float* sd = s_dot + (step & 1) * 2 * NWARPS;
        if (lane == 0) {
          sd[warp] = dot;
          sd[NWARPS + warp] = dot2;
        }
        __syncthreads();
        const int w0 = slot * (tpr / 32);
        dot = dot2 = 0.0f;
        for (int q = 0; q < tpr / 32; ++q) {
          dot += sd[w0 + q];
          dot2 += sd[NWARPS + w0 + q];
        }
      }
      if (live) {  // every thread of the row computes its weight, bit for bit
        const float z = (s_off[r] + sz) + dot;
        float a;
        if constexpr (HVP) {
          a = wt * glm::dzz<LOSS>(z, s_y[r]) * (dot2 + sv);
        } else {
          float l, dz;
          glm::loss_and_dz<LOSS>(z, s_y[r], l, dz);
          a = wt * dz;
          if (sl == 0) acc_val += wt * l;
        }
        if (sl == 0) acc_wsum += a;
        a = round_like<T>(a);
#pragma unroll
        for (int e = 0; e < PER; ++e) acc[e] += xv[e] * a;
      }
    }
    __syncthreads();  // every thread is done with this stage
    if (ASYNC && tid == 0 && t + S < n_tiles) issue(t + S);
    rs.store(t + 2);  // its slot was last read before this barrier
  }

  // ---- this CTA's partial, then the fixed-order cross-CTA sum --------------
  // threads of one warp that hold the same columns add up first
  for (int o = tpr; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  for (int o = 16; o > 0; o >>= 1) {
    acc_val += __shfl_xor_sync(0xffffffffu, acc_val, o);
    acc_wsum += __shfl_xor_sync(0xffffffffu, acc_wsum, o);
  }
  if (lane == 0) {
    s_wval[warp] = acc_val;
    s_wsum[warp] = acc_wsum;
  }
  // then one row of slot sums per warp (tpr < 32) or per row slot, in the
  // idle ring
  float* red = reinterpret_cast<float*>(smem + L.x);
  const int n_slots = tpr < 32 ? NWARPS : rps;
  if (tpr >= 32 || lane < tpr) {
    float* mine = red + (tpr < 32 ? warp : slot) * d;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int u = sl + i * tpr;
      if (u < words)
#pragma unroll
        for (int k = 0; k < VEC; ++k) mine[u * VEC + k] = acc[i * VEC + k];
    }
  }
  __syncthreads();
  const long long width = d + 2;
  float* mine = part + (long long)blockIdx.x * width;
  for (int j = tid; j < d; j += NT) {
    float s = 0.0f;
    for (int q = 0; q < n_slots; ++q) s += red[q * d + j];
    mine[j] = s;
  }
  if (tid == 0) {
    float v = 0.0f, s = 0.0f;
    for (int k = 0; k < NWARPS; ++k) {
      v += s_wval[k];
      s += s_wsum[k];
    }
    mine[d] = v;
    mine[d + 1] = s;
  }
  glm::grid_sum<NT>(part, width, gridDim.x, group, ticket, s_flag,
                    [&](const float* gp, int n_groups) {
                      glm::sum_rows<NT>(gp, 0, n_groups, width, width,
                                        [&](long long j, float s) { out[j] = s; });
                    });
}

template <typename T, int VEC, int LOSS, bool HVP>
cudaError_t plan_t(int d, int bn, int* ctas_per_sm) {
  auto kern = fused_rows_kernel<T, VEC, LOSS, HVP>;
  const size_t smem = layout(d, bn, sizeof(T), VEC * sizeof(T) == 16).total;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, NT, smem);
}

template <typename T, int VEC, int LOSS, bool HVP>
cudaError_t launch_t(const void* X, const float* y, const float* off, const float* w,
                     const float* coef, const float* vdir, const float* shift_z,
                     const float* shift_v, long long n, int d, int bn, int tpr,
                     long long rows_per_cta, int n_ctas, int group, float* part,
                     unsigned* ticket, float* out, cudaStream_t stream) {
  auto kern = fused_rows_kernel<T, VEC, LOSS, HVP>;
  const size_t smem = layout(d, bn, sizeof(T), VEC * sizeof(T) == 16).total;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<n_ctas, NT, smem, stream>>>(reinterpret_cast<const T*>(X), y, off, w, coef, vdir,
                                     shift_z, shift_v, n, d, bn, tpr, rows_per_cta, group, part,
                                     ticket, out);
  return cudaGetLastError();
}

// Dispatch over (mode, storage dtype, vector width, loss). mode 0 = B1,
// 1 = B2; vec 0 = one element per load from global memory, 1 = 16-byte
// words through the bulk-copy ring (16 / sizeof(T) elements).
#define LOSS_CASE(LOSS, T, VEC, HVP, FN, ...) return FN<T, VEC, LOSS, HVP>(__VA_ARGS__);

#define FOR_VEC(T, HVP, FN, ...)                                                          \
  if (vec) { GLM_SWITCH_LOSS(loss, LOSS_CASE, T, 16 / sizeof(T), HVP, FN, __VA_ARGS__) } \
  GLM_SWITCH_LOSS(loss, LOSS_CASE, T, 1, HVP, FN, __VA_ARGS__)

#define DISPATCH(FN, ...)                                                      \
  if (mode == 1) { GLM_SWITCH_DTYPE(dtype, FOR_VEC, true, FN, __VA_ARGS__) }   \
  if (mode == 0) { GLM_SWITCH_DTYPE(dtype, FOR_VEC, false, FN, __VA_ARGS__) }  \
  return cudaErrorInvalidValue;

cudaError_t plan_dispatch(int mode, int dtype, int vec, int loss, int d, int bn,
                          int* ctas_per_sm) {
  DISPATCH(plan_t, d, bn, ctas_per_sm)
}

cudaError_t launch_dispatch(int mode, int dtype, int vec, int loss, const void* X,
                            const float* y, const float* off, const float* w,
                            const float* coef, const float* vdir, const float* shift_z,
                            const float* shift_v, long long n, int d, int bn, int tpr,
                            long long rows_per_cta, int n_ctas, int group, float* part,
                            unsigned* ticket, float* out, cudaStream_t stream) {
  DISPATCH(launch_t, X, y, off, w, coef, vdir, shift_z, shift_v, n, d, bn, tpr, rows_per_cta,
           n_ctas, group, part, ticket, out, stream)
}

}  // namespace

extern "C" {

// Resident CTAs per SM for this instantiation and tile (also raises the
// kernel's dynamic shared-memory limit). Returns a cudaError_t code.
int fused_glm_plan(int mode, int dtype, int vec, int loss, int d, int bn, int* ctas_per_sm) {
  return (int)plan_dispatch(mode, dtype, vec, loss, d, bn, ctas_per_sm);
}

// One launch on `stream`; returns its launch error (0 = success). CTA b
// owns rows [b * rows_per_cta, (b + 1) * rows_per_cta) of n, tpr threads a
// row (a power of two, at most 256, D <= 16 * tpr). part holds
// (n_ctas + groups) * (d + 2) floats, ticket groups + 1 zeroed counters (left
// zeroed), out d + 2 floats = (grad, val, wsum). Mode 0 (B1) ignores vdir and
// shift_v; mode 1 (B2) writes val = 0 and its usum into wsum.
int fused_glm_launch(int mode, int dtype, int vec, int loss, const void* X, const float* y,
                     const float* off, const float* w, const float* coef, const float* vdir,
                     const float* shift_z, const float* shift_v, long long n, int d, int bn,
                     int tpr, long long rows_per_cta, int n_ctas, int group, float* part,
                     unsigned* ticket, float* out, void* stream) {
  return (int)launch_dispatch(mode, dtype, vec, loss, X, y, off, w, coef, vdir, shift_z, shift_v,
                              n, d, bn, tpr, rows_per_cta, n_ctas, group, part, ticket, out,
                              reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
