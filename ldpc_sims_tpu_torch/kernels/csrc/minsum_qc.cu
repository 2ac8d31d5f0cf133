// QC-LDPC min-sum decode kernels for Hopper (sm_90a), one source for both
// schedules.
//
// Replaces the Pallas TPU kernel `bp_qc_pallas` in
// ldpc_sims_tpu/kernels/minsum_qc.py (pl.pallas_call at :788, body built by
// `_build_kernel` :116-530) in its two fixed-iteration min-sum forms:
//   * minsum_qc_flooding: the flooding update (`update` :353-373,
//     `write_posterior` :247-257, min-sum `check_excl` :293-330);
//   * minsum_qc_layered: the serial-C layered sweep with layered_group=1
//     (`layered_sweep` :375-440) and the per-iteration (alpha, beta) table
//     (:170-174, :318-323).
// Both take scalar alpha/beta as a table with one repeated row, an optional
// clamp, and emit hard bits (int8) or the posterior (f32, log(Pr1/Pr0)).
//
// Design. One CTA decodes one codeword. Its c2v messages (P planes of z
// floats, 27,864 B at wifi1944) and its posterior (n floats, 7,776 B) stay
// in shared memory for all iterations, so device memory sees the LLRs read
// (once per iteration for flooding, through L2) and the output written
// once. The public (batch, n) layout is kept: a CTA reads its codeword's
// contiguous n floats. Threads map to checks:
//   * flooding updates all mb*z checks from the posterior, then rebuilds
//     each variable's posterior as LLR + sum of its c2v messages in
//     check-sorted order (the order of the plain version), with no atomics,
//     so results are deterministic;
//   * layered walks the mb block rows in order with z threads active per
//     row; the z checks of one block row touch disjoint variables in every
//     column block, so each thread folds its message change into the
//     posterior without atomics, and __syncthreads() separates rows.
// Circulant orientation: check i*z+r meets variable j*z+((r+s) mod z).
// The exclusive sign is the parity of the count of strict v < 0 (-0.0 is
// positive), and a message is sign * max(exmin - beta, 0) * alpha, then
// clamped. Built with --fmad=false so the arithmetic matches the plain
// PyTorch version (ops/bp_roll.py) bit for bit.
//
// What bounds it on the H100: the shared-memory residency of ~36 KB per
// codeword caps a SM at 6 resident codewords, and the per-edge f32 work
// (about 16 ops per edge per iteration) is issued by few warps, so the
// kernel is latency bound well above both the byte bound and the f32 op
// bound (PERF.md). The plain design stays until a faster one (compressed
// messages: two minima, index and sign bits per check; several codewords
// per CTA) is measured against it.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kBig = 1e30f;

// The decode plan, copied into shared memory at CTA start (int32):
//   row_ptr[mb+1]   planes of block row i are [row_ptr[i], row_ptr[i+1])
//                   (planes are sorted block-row-major)
//   plane_col[P]    column block j of each plane
//   plane_shift[P]  circulant shift s of each plane, in [0, z)
//   col_ptr[nb+1]   entries of column block j in col_planes
//   col_planes[P]   plane ids of each column block, sorted by block row
struct Plan {
  const int* row_ptr;
  const int* plane_col;
  const int* plane_shift;
  const int* col_ptr;
  const int* col_planes;
};

__host__ __device__ inline int plan_ints(int mb, int nb, int P) {
  return (mb + 1) + 3 * P + (nb + 1);
}

__host__ __device__ inline int plan_ints_padded(int mb, int nb, int P) {
  return (plan_ints(mb, nb, P) + 3) & ~3;
}

// Bytes of dynamic shared memory one CTA needs: plan, c2v planes, posterior.
inline int smem_bytes(int z, int mb, int nb, int P) {
  return 4 * (plan_ints_padded(mb, nb, P) + P * z + nb * z);
}

// Exclusive min-sum update of check (i, r). Reads v2c = post - c2v for each
// of its edges, writes the new c2v messages and, for the layered schedule,
// folds each message change into the posterior.
template <bool kLayered>
__device__ __forceinline__ void check_update(const Plan& pl, float* msg,
                                             float* post, int z, int i,
                                             int r, float alpha, float beta,
                                             float clamp) {
  const int p0 = pl.row_ptr[i], p1 = pl.row_ptr[i + 1];
  float min1 = kBig, min2 = kBig;
  int idx = -1, nneg = 0;
  for (int p = p0; p < p1; ++p) {
    int q = r + pl.plane_shift[p];
    if (q >= z) q -= z;
    const float v = post[pl.plane_col[p] * z + q] - msg[p * z + r];
    const float a = fabsf(v);
    nneg += (v < 0.f) ? 1 : 0;
    if (a < min1) {  // strict: idx is the first minimum, as argmin
      min2 = min1;
      min1 = a;
      idx = p;
    } else if (a < min2) {
      min2 = a;
    }
  }
  for (int p = p0; p < p1; ++p) {
    int q = r + pl.plane_shift[p];
    if (q >= z) q -= z;
    const int vi = pl.plane_col[p] * z + q;
    const float old = msg[p * z + r];
    const float v = post[vi] - old;
    const int exneg = (nneg - ((v < 0.f) ? 1 : 0)) & 1;
    const float sgn = exneg ? -1.f : 1.f;
    const float exmin = (p == idx) ? min2 : min1;
    float y = (sgn * fmaxf(exmin - beta, 0.f)) * alpha;
    y = fminf(fmaxf(y, -clamp), clamp);
    msg[p * z + r] = y;
    if (kLayered) post[vi] = post[vi] + (y - old);
  }
}

template <bool kLayered>
__device__ __forceinline__ void decode(const float* __restrict__ llr,
                                       float* __restrict__ post_out,
                                       int8_t* __restrict__ bits_out,
                                       const int* __restrict__ plan_g,
                                       const float* __restrict__ ab, int z,
                                       int mb, int nb, int P, int iterations,
                                       float clamp) {
  extern __shared__ float4 smem_f4[];
  int* plan = reinterpret_cast<int*>(smem_f4);
  float* msg = reinterpret_cast<float*>(smem_f4) + plan_ints_padded(mb, nb, P);
  const int n = nb * z;
  float* post = msg + P * z;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  const float* l = llr + base;

  const int n_plan = plan_ints(mb, nb, P);
  for (int t = threadIdx.x; t < n_plan; t += blockDim.x) plan[t] = plan_g[t];
  for (int t = threadIdx.x; t < P * z; t += blockDim.x) msg[t] = 0.f;
  // internal convention log(Pr0/Pr1): the negated API LLR
  for (int t = threadIdx.x; t < n; t += blockDim.x) post[t] = -l[t];
  __syncthreads();
  const Plan pl{plan, plan + (mb + 1), plan + (mb + 1) + P,
                plan + (mb + 1) + 2 * P, plan + (mb + 1) + 2 * P + (nb + 1)};

  for (int it = 0; it < iterations; ++it) {
    const float alpha = ab[2 * it], beta = ab[2 * it + 1];
    if (kLayered) {
      for (int i = 0; i < mb; ++i) {
        for (int r = threadIdx.x; r < z; r += blockDim.x)
          check_update<true>(pl, msg, post, z, i, r, alpha, beta, clamp);
        __syncthreads();
      }
    } else {
      for (int c = threadIdx.x; c < mb * z; c += blockDim.x)
        check_update<false>(pl, msg, post, z, c / z, c % z, alpha, beta,
                            clamp);
      __syncthreads();
      for (int v = threadIdx.x; v < n; v += blockDim.x) {
        const int j = v / z, q = v % z;
        float acc = -l[v];
        for (int e = pl.col_ptr[j]; e < pl.col_ptr[j + 1]; ++e) {
          const int p = pl.col_planes[e];
          int r = q - pl.plane_shift[p];
          if (r < 0) r += z;
          acc = acc + msg[p * z + r];
        }
        post[v] = acc;
      }
      __syncthreads();
    }
  }

  if (bits_out != nullptr) {
    for (int t = threadIdx.x; t < n; t += blockDim.x)
      bits_out[base + t] = post[t] < 0.f ? 1 : 0;
  } else {
    for (int t = threadIdx.x; t < n; t += blockDim.x)
      post_out[base + t] = -post[t];
  }
}

}  // namespace

__global__ void minsum_qc_flooding(const float* llr, float* post_out,
                                   int8_t* bits_out, const int* plan,
                                   const float* ab, int z, int mb, int nb,
                                   int P, int iterations, float clamp) {
  decode<false>(llr, post_out, bits_out, plan, ab, z, mb, nb, P, iterations,
                clamp);
}

__global__ void minsum_qc_layered(const float* llr, float* post_out,
                                  int8_t* bits_out, const int* plan,
                                  const float* ab, int z, int mb, int nb,
                                  int P, int iterations, float clamp) {
  decode<true>(llr, post_out, bits_out, plan, ab, z, mb, nb, P, iterations,
               clamp);
}

extern "C" {

// Launches one decode on `stream`: grid = batch CTAs, one codeword each.
// `out` is int8 hard bits when out_hard != 0, else the f32 posterior in
// the log(Pr1/Pr0) convention; both (batch, nb*z) row-major. `ab` holds
// `iterations` rows of (alpha, beta). clamp = +inf for no clamp. Returns
// the CUDA error code of the launch (0 on success).
int minsum_qc_decode(int layered, const float* llr, void* out, int out_hard,
                     const int* plan, const float* ab, int batch, int z,
                     int mb, int nb, int P, int iterations, float clamp,
                     cudaStream_t stream) {
  const int smem = smem_bytes(z, mb, nb, P);
  const void* fn = layered ? reinterpret_cast<const void*>(&minsum_qc_layered)
                           : reinterpret_cast<const void*>(&minsum_qc_flooding);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // layered: one thread per check of a block row; flooding: 256 threads
  // stride over the checks, then over the variables
  int threads = layered ? ((z + 31) / 32) * 32 : 256;
  if (threads > 1024) threads = 1024;
  float* post_out = out_hard ? nullptr : static_cast<float*>(out);
  int8_t* bits_out = out_hard ? static_cast<int8_t*>(out) : nullptr;
  if (layered) {
    minsum_qc_layered<<<batch, threads, smem, stream>>>(
        llr, post_out, bits_out, plan, ab, z, mb, nb, P, iterations, clamp);
  } else {
    minsum_qc_flooding<<<batch, threads, smem, stream>>>(
        llr, post_out, bits_out, plan, ab, z, mb, nb, P, iterations, clamp);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* minsum_qc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
