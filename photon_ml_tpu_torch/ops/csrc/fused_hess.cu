// Kernel B3: the full Gauss-Newton Hessian of the GLM objective in one
// pass over the design matrix X, with the normalized rows built on chip.
//
// Replaces the Pallas TPU kernel photon_ml_tpu/ops/pallas_glm.py
// (fused_hessian_matrix, kernel body _hess_kernel). For rows i:
//
//   z_i  = (off_i + margin_shift) + X_i . coef
//   d_i  = live_i ? w_i * dzz(z_i, y_i) : 0
//   a_i  = live_i ? (f32(X_i) - shift) * factor : 0
//   H    = sum_i a_i^T (a_i * d_i)        [D, D], D <= MAX_HESS_DIM = 512
//
// The caller adds l2 * I. A row is live iff w_i != 0 and i < n. The row is
// widened to f32 first and only then normalized, and it is selected away
// AFTER the normalization: a shifted zero row is not zero, and inf * 0 is
// NaN, so a dead row holding inf stays inert only because it is never used.
// The math is f32 from start to end, also for bf16 storage (where the
// coefficients are rounded to bf16 for the z product, as the TPU kernel's
// _mxu_dtype does).
//
// Bound on an H100: at D = 64 the bytes (26.8 MB at 100,000 x 64 f32,
// 0.0080 ms at 3.35 TB/s); at D = 512 the operations. The products run on
// the tensor cores in split-precision TF32 (each f32 operand a = hi + lo,
// both TF32, and hi*hi + hi*lo + lo*hi summed in f32: f32 accuracy, where
// plain TF32 keeps about three digits), so the work is 3 * N * D * (D + 1)
// TF32 operations, 0.16 ms at 100,000 x 512 at 495 TFLOP/s. What the design
// does about each:
//
//   * D <= ROW_MAX = 128: one launch that reads X once. A persistent grid
//     (two CTAs per SM up to D = 64, one above), each CTA owning one
//     contiguous range of rows, streams row tiles of about 8 KB through a
//     three-stage ring of bulk copies (cp.async.bulk on mbarriers, as kernel
//     B1 does) when rows are 16-byte aligned, else loads them directly; the
//     rows' (w, off, y) come two tiles ahead (glm::RowScalars). The lanes
//     of a row hold its values in registers: they compute z_i and d_i, then
//     normalize, select, weight by d_i and split each value once into the
//     tile's split arrays (double-buffered, so one barrier a tile). The
//     warps then run mma.sync m16n8k8 TF32 over the upper 16 x 8 tiles of
//     H, each warp one pair of m-tile rows (p and mt - 1 - p, the same tile
//     count for every pair) at its share of the tile's 8-row steps, so its
//     ten (D <= 64) or eighteen products are independent. Its partial (the
//     upper triangle, packed) and the fixed-order cross-CTA sum
//     (glm::grid_sum) finish in the same launch; the sum writes (j, k) and
//     (k, j) from one value, so H is symmetric bitwise.
//   * D > 128: two launches. A row-weight stage writes d_i (one warp per
//     row; about 1/6 of X's bytes at D = 512), then a tile stage: CTAs of
//     (upper 128 x 128 output tile x row chunk) stage the tile's two column
//     blocks and their row weights 32 rows at a time through a three-stage
//     cp.async ring, split them as above, and sixteen warps (32 x 32 each)
//     run the same split-precision products. The last chunk of each tile
//     to arrive sums the tile's partials in chunk order and writes both
//     triangles.
//   * Each 8-row step's three products accumulate from zero and are then
//     added to the running sum in f32, so the tensor cores' own accumulation
//     (which need not round to nearest) never runs longer than one step.
//   * No float atomics: integer tickets pick the CTA that sums, and every
//     sum runs in a fixed order, so results repeat bitwise.
//
// The loss is a template parameter; all four GLM losses are instantiated.
// Plain C interface, loaded with ctypes (no PyTorch headers).

#include "glm_common.cuh"

namespace {

using glm::round_like;
using glm::to_f32;

constexpr int NT = 256;  // threads per CTA of the one-launch kernel
constexpr int NW = NT / 32;
constexpr int ROW_MAX = 128;  // widest D of the one-launch kernel
constexpr int S = 3;          // stages of its bulk-copy ring
constexpr int PER = 8;        // values of a row each lane holds there
constexpr int NTT = 512;      // threads per CTA of the tile stage
constexpr int NWT = NTT / 32;
constexpr int TB = 128;       // output tile edge of the two-launch path
constexpr int KT = 32;        // rows per stage there
constexpr int ST = 3;         // stages of its cp.async ring
constexpr int TP = TB + 8;    // pitch of its split rows (conflict-free fragment loads)

// ---- split-precision TF32 on the tensor cores -------------------------------

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// a = hi + lo with both TF32: hi keeps a's top 11 bits, lo the rest, rounded.
__device__ __forceinline__ void split_store(float a, unsigned* hi, unsigned* lo, int i) {
  const unsigned h = tf32(a);
  hi[i] = h;
  lo[i] = tf32(a - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B to f32 accuracy, small terms first (lo*lo is below f32 rounding).
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Fragments from split rows s[k][pitch] (k = data row): the A operand is
// A[m][k] = s[k0 + k][m0 + m] (16 x 8), the B operand B[k][n] =
// s[k0 + k][n0 + n] (8 x 8). With pitch = 8 or 24 (mod 32) the 32 lanes hit
// 32 banks.
__device__ __forceinline__ void frag_a(const unsigned* s, int pitch, int k0, int m0,
                                       unsigned (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const unsigned* p = s + (k0 + (lane & 3)) * pitch + m0 + (lane >> 2);
  a[0] = p[0];
  a[1] = p[8];
  a[2] = p[4 * pitch];
  a[3] = p[4 * pitch + 8];
}

__device__ __forceinline__ void frag_b(const unsigned* s, int pitch, int k0, int n0,
                                       unsigned (&b)[2]) {
  const int lane = threadIdx.x & 31;
  const unsigned* p = s + (k0 + (lane & 3)) * pitch + n0 + (lane >> 2);
  b[0] = p[0];
  b[1] = p[4 * pitch];
}

// (row, col) of accumulator entry q of a 16 x 8 tile, for this lane.
__device__ __forceinline__ int acc_row(int q) { return ((threadIdx.x & 31) >> 2) + (q >> 1) * 8; }
__device__ __forceinline__ int acc_col(int q) { return (threadIdx.x & 3) * 2 + (q & 1); }

// Index of (j, k), j <= k, in the row-major packed upper triangle of a D x D.
__device__ __forceinline__ long long tri(int j, int k, int d) {
  return (long long)j * d - (long long)j * (j - 1) / 2 + (k - j);
}

// The row j of packed index p: tri(j, j, d) <= p < tri(j + 1, j + 1, d).
__device__ __forceinline__ int tri_row(long long p, int d) {
  const double b = 2.0 * d + 1.0;
  int j = (int)((b - sqrt(b * b - 8.0 * (double)p)) / 2.0);
  j = max(0, min(j, d - 1));
  while (j > 0 && tri(j, j, d) > p) --j;
  while (j + 1 < d && tri(j + 1, j + 1, d) <= p) ++j;
  return j;
}

// ---- D <= ROW_MAX: whole rows, one launch -------------------------------------

struct RowLayout {
  int dp, pitch;
  size_t sh, fc, rows, flag, split, x, stage, total;
};

// The split arrays are double-buffered: [2 tiles][ah, al, bh, bl][kr][pitch].
__host__ __device__ inline RowLayout row_layout(int d, int kr, int elem, bool async) {
  RowLayout L;
  L.dp = (d + 15) & ~15;
  L.pitch = L.dp + 8;
  size_t o = 128;  // the ring's mbarriers
  L.sh = o;
  o += 4 * L.dp;
  L.fc = o;
  o += 4 * L.dp;
  L.rows = o;  // glm::RowScalars: [3][3][kr]
  o += 4 * 9 * kr;
  L.flag = o;
  o += 16;
  L.split = (o + 15) & ~size_t(15);
  o = L.split + (size_t)2 * 4 * 4 * kr * L.pitch;
  L.x = (o + 127) & ~size_t(127);
  L.stage = ((size_t)kr * d * elem + 127) & ~size_t(127);
  L.total = L.x + (async ? S : 0) * L.stage;
  // the end's k-slot sums ([wpp][D (D + 1) / 2], wpp = NW / ceil(mt / 2)
  // warps a pair of m-tile rows) reuse the split arrays and the ring
  const int wpp = NW / (((d + 15) / 16 + 1) / 2);
  const size_t red = L.split + (size_t)4 * wpp * d * (d + 1) / 2;
  if (L.total < red) L.total = red;
  return L;
}

// part is [gridDim.x + groups][D (D + 1) / 2]. A row belongs to tpr lanes
// (a power of two, at most 32), each holding at most PER of its values in
// registers (CPL words of VEC). TPW: the upper 16 x 8 tiles of one pair of
// m-tile rows (10 up to D = 64, two CTAs an SM; 18 up to D = 128, one).
template <typename T, int VEC, int LOSS, int TPW>
__global__ void __launch_bounds__(NT, TPW <= 10 ? 2 : 1) hess_rows_kernel(
    const T* __restrict__ X, const float* __restrict__ y, const float* __restrict__ off,
    const float* __restrict__ w, const float* __restrict__ coef,
    const float* __restrict__ shift_z, const float* __restrict__ shift,
    const float* __restrict__ factor, long long n, int d, int kr, int tpr,
    long long rows_per_cta, int group, float* __restrict__ part, unsigned* __restrict__ ticket,
    float* __restrict__ H) {
  constexpr bool ASYNC = VEC * sizeof(T) == 16;
  constexpr int CPL = PER / VEC;  // words of a row per lane
  extern __shared__ __align__(128) unsigned char smem[];
  const RowLayout L = row_layout(d, kr, sizeof(T), ASYNC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* s_sh = reinterpret_cast<float*>(smem + L.sh);
  float* s_fc = reinterpret_cast<float*>(smem + L.fc);
  glm::RowScalars rs{reinterpret_cast<float*>(smem + L.rows), kr};
  int* s_flag = reinterpret_cast<int*>(smem + L.flag);
  unsigned* s_split = reinterpret_cast<unsigned*>(smem + L.split);
  T* s_x = reinterpret_cast<T*>(smem + L.x);
  const long long stage_elems = L.stage / sizeof(T);
  const int pitch = L.pitch, plane = kr * pitch;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / tpr, sl = lane % tpr, rpw = 32 / tpr;  // rows per warp a step
  const int words = d / VEC;  // VEC divides d on the async path
  const glm::RowRange rr = glm::cta_rows(n, rows_per_cta);
  const int n_tiles = (int)((rr.end - rr.begin + kr - 1) / kr);
  auto tile_r0 = [&](int t) { return rr.begin + (long long)t * kr; };
  auto tile_rows = [&](int t) {
    const long long left = rr.end - tile_r0(t);
    return (int)(left < kr ? left : kr);
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

  // this lane's coefficients, rounded as for the TPU's matrix unit
  float cf[PER];
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int u = sl + i * tpr;
      cf[i * VEC + k] = u < words ? round_like<T>(coef[u * VEC + k]) : 0.0f;
    }
  for (int j = tid; j < d; j += NT) {
    s_sh[j] = shift[j];
    s_fc[j] = factor[j];
  }
  // columns d .. dp of every split array stay zero
  for (int e = tid; e < 8 * kr * (L.dp - d); e += NT) {
    const int c = d + e % (L.dp - d), r = (e / (L.dp - d)) % kr, a = e / ((L.dp - d) * kr);
    s_split[a * plane + r * pitch + c] = 0u;
  }
  const float sz = *shift_z;

  // the MMA work of a tile: items (8-row step, pair of m-tile rows p and
  // mt - 1 - p, whose upper 16 x 8 tiles number 2 nt - 2 (mt - 1) for every
  // pair but an odd middle one); warp w takes pair w % P and every wpp-th
  // step from w / P, so a warp's tiles and accumulators are fixed
  const int mt = (d + 15) / 16, nt = (d + 7) / 8;
  const int P = (mt + 1) / 2, wpp = NW / P;
  const bool mma_warp = warp < P * wpp;
  const int pair = warp % P, kslot = warp / P;
  const int mi0 = pair, mi1 = mt - 1 - pair;
  const int n0 = nt - 2 * mi0, n1 = mi1 > mi0 ? nt - 2 * mi1 : 0;
  float acc[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
  if (n_tiles > 0) rs.store(0);
  if (n_tiles > 1) rs1.store(1);
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const long long r0 = tile_r0(t);
    const int rows = tile_rows(t);
    if (t + 2 < n_tiles) rs.load(w, off, y, tile_r0(t + 2), tile_rows(t + 2));
    const float* s_w = rs.slot(t);
    const float* s_off = s_w + kr;
    const float* s_y = s_w + 2 * kr;
    const T* sx = s_x + (t % S) * stage_elems;
    unsigned* s_ah = s_split + (t & 1) * 4 * plane;
    unsigned* s_al = s_ah + plane;
    unsigned* s_bh = s_al + plane;
    unsigned* s_bl = s_bh + plane;
    if constexpr (ASYNC) glm::ring_wait(bars + t % S, (t / S) & 1);
    // ---- each row: z_i and d_i, then its values normalized, selected,
    // weighted and split, once each, into this tile's split arrays ----------
    for (int rb = warp * rpw; rb < kr; rb += NW * rpw) {  // warp-uniform
      const int r = rb + sub;
      const float wt = r < rows ? s_w[r] : 0.0f;
      const bool live = wt != 0.0f;  // a dead row's values are never loaded
      float xv[PER], p[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) p[k] = 0.0f;
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
        for (int k = 0; k < VEC; ++k) p[k] += xv[i * VEC + k] * cf[i * VEC + k];
      }
      float dot = 0.0f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) dot += p[k];
      for (int o = 1; o < tpr; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      // every lane of the row computes d_i, bit for bit the same
      const float dr = live ? wt * glm::dzz<LOSS>((s_off[r] + sz) + dot, s_y[r]) : 0.0f;
      if (r < kr) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int u = sl + i * tpr;
          if (u < words)
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const int c = u * VEC + k;
              const float a = live ? (xv[i * VEC + k] - s_sh[c]) * s_fc[c] : 0.0f;
              split_store(a, s_ah, s_al, r * pitch + c);
              split_store(a * dr, s_bh, s_bl, r * pitch + c);
            }
        }
      }
    }
    __syncthreads();
    // every thread is done with this stage's raw rows, and with the split
    // arrays of tile t - 1, which tile t + 1 writes next
    if (ASYNC && tid == 0 && t + S < n_tiles) issue(t + S);
    // ---- this warp's upper tiles on the tensor cores ----------------------
    const int ksteps = (rows + 7) / 8;
    for (int ks = kslot; mma_warp && ks < ksteps; ks += wpp) {
      const int k0 = ks * 8;
      unsigned ah0[4], al0[4], ah1[4], al1[4];
      frag_a(s_ah, pitch, k0, 16 * mi0, ah0);
      frag_a(s_al, pitch, k0, 16 * mi0, al0);
      frag_a(s_ah, pitch, k0, 16 * mi1, ah1);
      frag_a(s_al, pitch, k0, 16 * mi1, al1);
      // every tile slot is computed (a slot past the pair's tiles repeats a
      // valid column and is never stored), so the products pipeline freely
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const bool second = i >= n0;
        const int ni = min(second ? 2 * mi1 + (i - n0) : 2 * mi0 + i, nt - 1);
        unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // selects, not a run-time index: registers
          ah[q] = second ? ah1[q] : ah0[q];
          al[q] = second ? al1[q] : al0[q];
        }
        frag_b(s_bh, pitch, k0, 8 * ni, bh);
        frag_b(s_bl, pitch, k0, 8 * ni, bl);
        // from zero, then into the running sum in f32
        float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma3(c4, ah, al, bh, bl);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += c4[q];
      }
    }
    rs.store(t + 2);  // its slot was last read before this tile's barrier
  }

  // ---- this CTA's packed upper triangle, then the fixed-order sum ---------
  // each k-slot's sums go to its row of the idle split arrays and ring, then
  // the rows are added in k-slot order
  const long long width = (long long)d * (d + 1) / 2;
  float* red = reinterpret_cast<float*>(smem + L.split);
  __syncthreads();
  if (mma_warp) {
    float* mine = red + kslot * width;
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      if (i < n0 + n1) {
        const int second = i >= n0;
        const int mi = second ? mi1 : mi0, ni = second ? 2 * mi1 + (i - n0) : 2 * mi0 + i;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 16 * mi + acc_row(q), k = 8 * ni + acc_col(q);
          if (j <= k && k < d) mine[tri(j, k, d)] = acc[i][q];
        }
      }
    }
  }
  __syncthreads();
  float* mine = part + (long long)blockIdx.x * width;
  for (long long e = tid; e < width; e += NT) {
    float v = 0.0f;
    for (int q = 0; q < wpp; ++q) v += red[q * width + e];
    mine[e] = v;
  }
  glm::grid_sum<NT>(part, width, gridDim.x, group, ticket, s_flag,
                    [&](const float* gp, int n_groups) {
                      glm::sum_rows<NT>(gp, 0, n_groups, width, width, [&](long long p, float s) {
                        const int j = tri_row(p, d), k = j + (int)(p - tri(j, j, d));
                        H[(long long)j * d + k] = s;
                        H[(long long)k * d + j] = s;
                      });
                    });
}

// ---- D > ROW_MAX: the row weights, then the tile stage ----------------------

// d_i = w_i * dzz(z_i, y_i) for live rows, 0 for dead ones; one warp a row.
template <typename T, int LOSS>
__global__ void __launch_bounds__(NT) hess_weights_kernel(
    const T* __restrict__ X, const float* __restrict__ y, const float* __restrict__ off,
    const float* __restrict__ w, const float* __restrict__ coef,
    const float* __restrict__ shift_z, long long n, int d, float* __restrict__ dvec) {
  extern __shared__ float s_coef[];  // [d]
  for (int j = threadIdx.x; j < d; j += NT) s_coef[j] = round_like<T>(coef[j]);
  const float sz = *shift_z;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * NW;
  for (long long row = (long long)blockIdx.x * NW + threadIdx.x / 32; row < n; row += warps) {
    const float wt = w[row];
    if (wt == 0.0f) {  // warp-uniform: the whole warp owns this row
      if (lane == 0) dvec[row] = 0.0f;
      continue;
    }
    const T* xr = X + row * (long long)d;
    float dot = 0.0f;
    for (int j = lane; j < d; j += 32) dot += to_f32<T>(xr[j]) * s_coef[j];
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) dvec[row] = wt * glm::dzz<LOSS>((off[row] + sz) + dot, y[row]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(glm::smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(glm::smem_addr(smem)),
               "l"(gmem));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct TileLayout {
  size_t sh, fc, rw, rd, flag, ah, al, bh, bl, x, stage, total;
};

__host__ __device__ inline TileLayout tile_layout(int elem, bool async) {
  TileLayout L;
  size_t o = 0;
  L.sh = o;  // [2][TB]
  o += 4 * 2 * TB;
  L.fc = o;  // [2][TB]
  o += 4 * 2 * TB;
  L.rw = o;  // [ST][KT] row weights w
  o += 4 * ST * KT;
  L.rd = o;  // [ST][KT] row weights d
  o += 4 * ST * KT;
  L.flag = o;
  o += 16;
  const size_t split = (size_t)4 * KT * TP;
  L.ah = o;
  o += split;
  L.al = o;
  o += split;
  L.bh = o;
  o += split;
  L.bl = o;
  o += split;
  L.x = (o + 127) & ~size_t(127);
  L.stage = (size_t)2 * KT * TB * elem;  // both column blocks
  L.total = L.x + (async ? ST : 0) * L.stage;
  return L;
}

// The partial of upper tile blockIdx.x over row chunk blockIdx.y, into
// part[chunk][tile][TB * TB]; the last chunk of the tile to arrive writes
// the tile's entries of H.
template <typename T, bool ASYNC>
__global__ void __launch_bounds__(NTT, 1) hess_tile_kernel(
    const T* __restrict__ X, const float* __restrict__ w, const float* __restrict__ dvec,
    const float* __restrict__ shift, const float* __restrict__ factor, long long n, int d,
    int n_side, long long rows_per_chunk, float* __restrict__ part,
    unsigned* __restrict__ ticket, float* __restrict__ H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TileLayout L = tile_layout(sizeof(T), ASYNC);
  float* s_sh = reinterpret_cast<float*>(smem + L.sh);
  float* s_fc = reinterpret_cast<float*>(smem + L.fc);
  float* s_w = reinterpret_cast<float*>(smem + L.rw);
  float* s_d = reinterpret_cast<float*>(smem + L.rd);
  int* s_flag = reinterpret_cast<int*>(smem + L.flag);
  unsigned* s_ah = reinterpret_cast<unsigned*>(smem + L.ah);
  unsigned* s_al = reinterpret_cast<unsigned*>(smem + L.al);
  unsigned* s_bh = reinterpret_cast<unsigned*>(smem + L.bh);
  unsigned* s_bl = reinterpret_cast<unsigned*>(smem + L.bl);
  T* s_x = reinterpret_cast<T*>(smem + L.x);

  // upper tile index -> (bi, bj), bi <= bj, row-major over the triangle
  int t = blockIdx.x, bi = 0;
  while (t >= n_side - bi) {
    t -= n_side - bi;
    ++bi;
  }
  const int bj = bi + t;
  const bool diag = bi == bj;
  const int c0[2] = {bi * TB, bj * TB};
  const int vc[2] = {min(TB, d - c0[0]), min(TB, d - c0[1])};  // columns inside D
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < 2 * TB; e += NTT) {
    const int side = e / TB, c = e % TB;
    s_sh[e] = c < vc[side] ? shift[c0[side] + c] : 0.0f;
    s_fc[e] = c < vc[side] ? factor[c0[side] + c] : 0.0f;
  }

  const long long r_begin = (long long)blockIdx.y * rows_per_chunk;
  const long long r_end = min(n, r_begin + rows_per_chunk);
  const int n_steps = r_end > r_begin ? (int)((r_end - r_begin + KT - 1) / KT) : 0;
  auto step_rows = [&](int s) { return (int)min((long long)KT, r_end - (r_begin + (long long)s * KT)); };
  auto raw = [&](int st, int side) { return s_x + ((size_t)st * 2 + side) * KT * TB; };
  // the column blocks and row weights of step s into stage s % ST; one
  // commit group per step, empty past the last
  auto issue = [&](int s) {
    if (s < n_steps) {
      constexpr int E = 16 / sizeof(T);
      const long long r0 = r_begin + (long long)s * KT;
      const int rows = step_rows(s);
      for (int side = 0; side < (diag ? 1 : 2); ++side) {
        const int cpr = vc[side] / E;  // 16-byte words per row
        T* dst = raw(s % ST, side);
        const T* src = X + r0 * d + c0[side];
        for (int e = tid; e < rows * cpr; e += NTT) {
          const int r = e / cpr, q = e % cpr;
          cp_async16(dst + r * TB + q * E, src + (long long)r * d + q * E);
        }
      }
      if (tid < rows) {
        cp_async4(s_w + (s % ST) * KT + tid, w + r0 + tid);
        cp_async4(s_d + (s % ST) * KT + tid, dvec + r0 + tid);
      }
    }
    cp_async_commit();
  };
  if constexpr (ASYNC) {
    for (int s = 0; s < ST - 1; ++s) issue(s);
  }

  // warp (wm, wn) owns output rows 32 wm .. +32 and columns 32 wn .. +32 of
  // the tile; on a diagonal tile the six warps below it have nothing to do
  const int mb = (warp / 4) * 32, nb = (warp % 4) * 32;
  const bool active = !(diag && mb > nb + 31) && mb < vc[0] && nb < vc[1];
  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.0f;

  for (int s = 0; s < n_steps; ++s) {
    const long long r0 = r_begin + (long long)s * KT;
    const int rows = step_rows(s);
    const int st = ASYNC ? s % ST : 0;
    if constexpr (ASYNC) {
      issue(s + ST - 1);
      cp_async_wait<ST - 1>();
    } else if (tid < rows) {
      s_w[tid] = w[r0 + tid];
      s_d[tid] = dvec[r0 + tid];
    }
    __syncthreads();
    // ---- normalize, select, weight and split the two blocks' elements -----
    for (int r = warp; r < KT; r += NWT) {
      const bool live = r < rows && s_w[st * KT + r] != 0.0f;
      const float dr = live ? s_d[st * KT + r] : 0.0f;
      const T* x0 = ASYNC ? raw(st, 0) + r * TB : X + (r0 + r) * d + c0[0];
      const T* x1 = ASYNC ? raw(st, 1) + r * TB : X + (r0 + r) * d + c0[1];
      for (int c = lane; c < TB; c += 32) {
        float a0 = 0.0f, a1 = 0.0f;
        if (live) {
          if (c < vc[0]) a0 = (to_f32<T>(x0[c]) - s_sh[c]) * s_fc[c];
          if (diag)
            a1 = a0;
          else if (c < vc[1])
            a1 = (to_f32<T>(x1[c]) - s_sh[TB + c]) * s_fc[TB + c];
        }
        split_store(a0, s_ah, s_al, r * TP + c);
        split_store(a1 * dr, s_bh, s_bl, r * TP + c);
      }
    }
    __syncthreads();
    if (!active) continue;
    const int ksteps = (rows + 7) / 8;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k0 = ks * 8;
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        frag_b(s_bh, TP, k0, nb + 8 * b, bh[b]);
        frag_b(s_bl, TP, k0, nb + 8 * b, bl[b]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        unsigned ah[4], al[4];
        frag_a(s_ah, TP, k0, mb + 16 * a, ah);
        frag_a(s_al, TP, k0, mb + 16 * a, al);
#pragma unroll
        for (int b = 0; b < 4; ++b) {  // from zero, then into the running sum in f32
          float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma3(c4, ah, al, bh[b], bl[b]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][b][q] += c4[q];
        }
      }
    }
  }
  if constexpr (ASYNC) cp_async_wait<0>();  // no copy outlives the CTA

  // ---- this chunk's partial of the tile, then the tile's fixed-order sum ---
  constexpr int TT = TB * TB;
  const int tiles = gridDim.x;
  float* mine = part + ((long long)blockIdx.y * tiles + blockIdx.x) * TT;
  if (active) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mine[(mb + 16 * a + acc_row(q)) * TB + nb + 8 * b + acc_col(q)] = acc[a][b][q];
  }
  if (!glm::last_arrival(ticket + blockIdx.x, gridDim.y, s_flag)) return;
  glm::sum_rows<NTT>(part + (long long)blockIdx.x * TT, 0, gridDim.y, (long long)tiles * TT, TT,
                     [&](long long e, float s) {
                       const int j = c0[0] + (int)(e / TB), k = c0[1] + (int)(e % TB);
                       if (j > k || k >= d) return;
                       H[(long long)j * d + k] = s;
                       H[(long long)k * d + j] = s;
                     });
}

// ---- host side ------------------------------------------------------------------

// The whole-row kernel for this D: ten tiles a pair up to D = 64, else 18.
template <typename T, int VEC, int LOSS>
auto rows_kernel(int d) {
  return d <= 64 ? hess_rows_kernel<T, VEC, LOSS, 10> : hess_rows_kernel<T, VEC, LOSS, 18>;
}

template <typename T, int VEC, int LOSS>
cudaError_t plan_t(int d, int kr, int* ctas_per_sm) {
  auto kern = rows_kernel<T, VEC, LOSS>(d);
  const size_t smem = row_layout(d, kr, sizeof(T), VEC * sizeof(T) == 16).total;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kern, NT, smem);
}

struct Args {
  const void* X;
  const float *y, *off, *w, *coef, *shift_z, *shift, *factor;
  long long n;
  int d, kr, tpr;
  long long rows_per_cta;
  int n_ctas, group, tiles, weight_ctas;
  float *dvec, *part;
  unsigned* ticket;
  float* H;
  cudaStream_t stream;
};

template <typename T, int VEC, int LOSS>
cudaError_t rows_t(const Args& a) {
  const size_t smem = row_layout(a.d, a.kr, sizeof(T), VEC * sizeof(T) == 16).total;
  auto kern = rows_kernel<T, VEC, LOSS>(a.d);
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<a.n_ctas, NT, smem, a.stream>>>(
      reinterpret_cast<const T*>(a.X), a.y, a.off, a.w, a.coef, a.shift_z, a.shift, a.factor,
      a.n, a.d, a.kr, a.tpr, a.rows_per_cta, a.group, a.part, a.ticket, a.H);
  return cudaGetLastError();
}

template <typename T, int VEC, int LOSS>
cudaError_t tiles_t(const Args& a) {
  const T* Xt = reinterpret_cast<const T*>(a.X);
  hess_weights_kernel<T, LOSS><<<a.weight_ctas, NT, a.d * sizeof(float), a.stream>>>(
      Xt, a.y, a.off, a.w, a.coef, a.shift_z, a.n, a.d, a.dvec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr bool ASYNC = VEC > 1;
  auto kern = hess_tile_kernel<T, ASYNC>;
  const size_t smem = tile_layout(sizeof(T), ASYNC).total;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int n_side = (a.d + TB - 1) / TB;
  kern<<<dim3(a.tiles, a.n_ctas), NTT, smem, a.stream>>>(Xt, a.w, a.dvec, a.shift, a.factor, a.n,
                                                        a.d, n_side, a.rows_per_cta, a.part,
                                                        a.ticket, a.H);
  return cudaGetLastError();
}

// Dispatch over (path, storage dtype, vector width, loss). vec 1 = rows
// 16-byte aligned: bulk copies (whole rows) or cp.async words (tiles).
#define HESS_BY_LOSS(LOSS, T, VEC, FN, ...) return FN<T, VEC, LOSS>(__VA_ARGS__);
#define HESS_BY_VEC(T, FN, ...)                                                       \
  if (vec) { GLM_SWITCH_LOSS(loss, HESS_BY_LOSS, T, 16 / sizeof(T), FN, __VA_ARGS__) } \
  GLM_SWITCH_LOSS(loss, HESS_BY_LOSS, T, 1, FN, __VA_ARGS__)

cudaError_t plan_dispatch(int dtype, int vec, int loss, int d, int kr, int* ctas_per_sm) {
  GLM_SWITCH_DTYPE(dtype, HESS_BY_VEC, plan_t, d, kr, ctas_per_sm)
}

cudaError_t rows_dispatch(int dtype, int vec, int loss, const Args& a) {
  GLM_SWITCH_DTYPE(dtype, HESS_BY_VEC, rows_t, a)
}

cudaError_t tiles_dispatch(int dtype, int vec, int loss, const Args& a) {
  GLM_SWITCH_DTYPE(dtype, HESS_BY_VEC, tiles_t, a)
}

}  // namespace

extern "C" {

// Resident CTAs per SM of the whole-row kernel for this instantiation and
// tile (also raises its dynamic shared-memory limit). Returns a cudaError_t.
int fused_hess_plan(int dtype, int vec, int loss, int d, int kr, int* ctas_per_sm) {
  if (d < 1 || d > ROW_MAX || kr < 8 || kr % 8 != 0) return (int)cudaErrorInvalidValue;
  return (int)plan_dispatch(dtype, vec, loss, d, kr, ctas_per_sm);
}

// Path 0 (D <= 128): one launch of n_ctas CTAs of rows_per_cta rows, kr
// rows a tile, tpr lanes a row; part holds (n_ctas + groups) * D (D + 1) / 2
// floats; dvec, tiles and weight_ctas are unused. Path 1 (D > 128): the
// row-weight launch (weight_ctas CTAs, dvec [n]) and the tile launch of
// tiles x n_ctas CTAs, each chunk rows_per_cta rows; part holds
// n_ctas * tiles * 128 * 128 floats. ticket: zeroed counters (groups + 1 or
// tiles of them), left zeroed. Returns the first launch error (0 = success).
int fused_hess_launch(int path, int dtype, int vec, int loss, const void* X, const float* y,
                      const float* off, const float* w, const float* coef,
                      const float* shift_z, const float* shift, const float* factor,
                      long long n, int d, int kr, int tpr, long long rows_per_cta, int n_ctas,
                      int group, int tiles, int weight_ctas, float* dvec, float* part,
                      unsigned* ticket, float* H, void* stream) {
  const Args a{X,  y,     off,   w,           coef, shift_z, shift,  factor,
               n,  d,     kr,    tpr,         rows_per_cta,  n_ctas, group,
               tiles, weight_ctas, dvec, part, ticket, H, reinterpret_cast<cudaStream_t>(stream)};
  if (path == 0) {
    if (d < 1 || d > ROW_MAX || kr < 8 || kr % 8 != 0) return (int)cudaErrorInvalidValue;
    return (int)rows_dispatch(dtype, vec, loss, a);
  }
  if (path == 1) return (int)tiles_dispatch(dtype, vec, loss, a);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
