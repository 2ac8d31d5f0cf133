// QC-LDPC belief-propagation decode kernels for Hopper (sm_90a), one source
// for both check rules and both schedules.
//
// Replaces the Pallas TPU kernel `bp_qc_pallas` in
// ldpc_sims_tpu/kernels/minsum_qc.py (pl.pallas_call at :788, body built by
// `_build_kernel` :116-530) in these forms:
//   * the flooding update (`update` :353-373, `write_posterior` :247-257);
//   * the serial-C layered sweep with layered_group=1 (`layered_sweep`
//     :375-440) and the per-iteration (alpha, beta) table (:170-174,
//     :318-323);
//   * both check rules of `check_excl`: min-sum (:293-330) and the stable
//     log-domain sum-product (:331-344), the latter in the expm1/log1p form
//     of ldpc_sims_tpu/ops/bp_roll.py:_sumproduct_excl, not the TPU kernel's
//     `_log1mexp` series (Mosaic has no expm1; CUDA has);
//   * the clamp and message quantization postlude (`msg_qbits`/`msg_qclip`,
//     :345-350), a compile-time flag, so the unquantized forms compile as
//     they did before it existed.
// Every form takes scalar alpha/beta as a table with one repeated row (min-sum
// only; sum-product ignores it), an optional clamp, and emits hard bits
// (int8) or the posterior (f32, log(Pr1/Pr0)). Every form takes two optional
// arguments:
//   * done_in (`with_done_in` :521-528, :752-757): a CTA whose codeword is
//     flagged returns at entry and writes nothing;
//   * unsat_out (`output='hard_unsat'`, `syndrome_unsat` :277-291,
//     :515-516): after the last iteration each thread counts the
//     unsatisfied checks among its rows of the shared-memory posterior,
//     and a shared-memory integer sum gives one count per codeword (an
//     integer sum, so the same in any order).
// The *_es entry points carry early stop (`early_stop` :469-508): the CTA
// checks its syndrome at entry (unless done_in is given: those codewords are
// known unconverged) and after every check_every-th iteration with a
// block-wide vote (__syncthreads_or), stops at the first satisfying state,
// writes the iterations it ran (0 at entry, (r+1)*K at the r-th check,
// `iterations` if never) and emits the posterior it stopped at. The TPU
// kernel decodes a 128-lane tile and has to keep updating its frozen lanes
// behind masks until the whole tile is done; a CTA decodes one codeword, so
// it simply leaves the loop.
//
// Entry points, named {minsum,sumproduct}_qc_{flooding,layered}[_es][_msgq]
// (_msgq: with message quantization), 16 in all.
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
// positive). A min-sum message is sign * max(exmin - beta, 0) * alpha. A
// sum-product message is sign * mag with, per edge,
//   a = max(|v|, 1e-12), lt = log(-expm1(-a)) - log1p(exp(-a)),
//   s = min(sum(lt) - lt, -1e-12), mag = log1p(exp(s)) - log(-expm1(s));
// the row sum is taken left to right over the row's slots, as in the plain
// version, and each thread keeps its row's lt values in a per-thread array
// of kMaxRowDeg floats rather than computing them twice (the wrapper reads
// the bound through bp_qc_max_row_degree and checks the code's row degree
// against it at launch). The transcendentals are libdevice's
// expf/expm1f/log1pf/logf, as PyTorch's CUDA exp/expm1/log1p/log, never the
// __expf-style intrinsics. Then every message is clamped, and quantized
// when the form has it: q = rint(y / step) * step, clipped to +-qclip, with
// a true IEEE division and rint's round-half-to-even (torch.round's). Built
// with --fmad=false and without fast math so the arithmetic matches the
// plain PyTorch version (ops/bp_roll.py) bit for bit.
//
// What bounds the kernels on the H100: the shared-memory residency of
// ~36 KB per codeword caps a SM at 6 resident codewords, and the per-edge
// f32 work is issued by few warps, so the min-sum forms are latency bound
// well above both the byte bound and the f32 op bound (PERF.md). The
// sum-product forms add eight libdevice transcendentals per edge, about
// 150 f32 and 4 MUFU instructions in the SASS, so f32 issue bounds them,
// not the special-function units. The plain design stays until a
// faster one (compressed messages: two minima, index and sign bits per
// check; several codewords per CTA) is measured against it. The early-stop
// forms do the work of the iterations each codeword runs plus one syndrome
// pass (about one iteration's reads, no writes) per check; a CTA that
// finishes early frees its SM slot for the next codeword, so the grid's
// time follows the mean of the iterations, not their maximum.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kBig = 1e30f;
constexpr int kMinSum = 0;
constexpr int kSumProduct = 1;
// lt values one thread keeps for its check (bp_qc_max_row_degree)
constexpr int kMaxRowDeg = 32;

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

// The message rule's parameters for one iteration.
struct Rule {
  float alpha, beta;   // min-sum normalization and offset
  float clamp;         // +inf for no clamp
  float qstep, qclip;  // quantization step and clip (the _msgq forms)
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

// log tanh(a/2) of a v2c message, a = max(|v|, 1e-12): in [-28.3, 0]
__device__ __forceinline__ float sp_lt(float v) {
  const float a = fmaxf(fabsf(v), 1e-12f);
  return logf(-expm1f(-a)) - log1pf(expf(-a));
}

// 2 atanh(exp(s)) for s <= -1e-12: at most 28.3
__device__ __forceinline__ float sp_mag(float s) {
  return log1pf(expf(s)) - logf(-expm1f(s));
}

// Message quantization: round half to even onto the step's grid, then clip.
__device__ __forceinline__ float quantize(float y, float step, float clip) {
  const float q = rintf(y / step) * step;
  return fminf(fmaxf(q, -clip), clip);
}

// The clamp, then the quantization of the _msgq forms.
template <bool kQuant>
__device__ __forceinline__ float postlude(float y, const Rule& u) {
  y = fminf(fmaxf(y, -u.clamp), u.clamp);
  if constexpr (kQuant) y = quantize(y, u.qstep, u.qclip);
  return y;
}

// Exclusive check update of check (i, r). Reads v2c = post - c2v for each
// of its edges, writes the new c2v messages and, for the layered schedule,
// folds each message change into the posterior.
template <int kMethod, bool kLayered, bool kQuant>
__device__ __forceinline__ void check_update(const Plan& pl, float* msg,
                                             float* post, int z, int i,
                                             int r, const Rule& u) {
  const int p0 = pl.row_ptr[i], p1 = pl.row_ptr[i + 1];
  float min1 = kBig, min2 = kBig;  // min-sum
  int idx = -1, nneg = 0;
  float lts[kMethod == kSumProduct ? kMaxRowDeg : 1];  // sum-product
  float total = 0.f;
  for (int p = p0; p < p1; ++p) {
    int q = r + pl.plane_shift[p];
    if (q >= z) q -= z;
    const float v = post[pl.plane_col[p] * z + q] - msg[p * z + r];
    nneg += (v < 0.f) ? 1 : 0;
    if constexpr (kMethod == kMinSum) {
      const float a = fabsf(v);
      if (a < min1) {  // strict: idx is the first minimum, as argmin
        min2 = min1;
        min1 = a;
        idx = p;
      } else if (a < min2) {
        min2 = a;
      }
    } else {
      const float lt = sp_lt(v);
      lts[p - p0] = lt;
      total = total + lt;
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
    float y;
    if constexpr (kMethod == kMinSum) {
      const float exmin = (p == idx) ? min2 : min1;
      y = (sgn * fmaxf(exmin - u.beta, 0.f)) * u.alpha;
    } else {
      y = sgn * sp_mag(fminf(total - lts[p - p0], -1e-12f));
    }
    y = postlude<kQuant>(y, u);
    msg[p * z + r] = y;
    if (kLayered) post[vi] = post[vi] + (y - old);
  }
}

// One iteration: the serial-C sweep over the mb block rows (layered), or
// all checks from the posterior and then the posterior rebuilt (flooding).
// Ends with __syncthreads(), so the posterior is complete on return.
template <int kMethod, bool kLayered, bool kQuant>
__device__ __forceinline__ void iterate(const Plan& pl, float* msg,
                                        float* post, const float* l, int z,
                                        int mb, int n, const Rule& u) {
  if (kLayered) {
    for (int i = 0; i < mb; ++i) {
      for (int r = threadIdx.x; r < z; r += blockDim.x)
        check_update<kMethod, true, kQuant>(pl, msg, post, z, i, r, u);
      __syncthreads();
    }
  } else {
    for (int c = threadIdx.x; c < mb * z; c += blockDim.x)
      check_update<kMethod, false, kQuant>(pl, msg, post, z, c / z, c % z,
                                           u);
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

// This thread's count of unsatisfied checks (its checks c = tid + k*blockDim)
// for the hard decisions of the posterior (bit 1 where post < 0).
__device__ __forceinline__ int local_unsat(const Plan& pl, const float* post,
                                           int z, int mb) {
  int count = 0;
  for (int c = threadIdx.x; c < mb * z; c += blockDim.x) {
    const int i = c / z, r = c % z;
    int parity = 0;
    for (int p = pl.row_ptr[i]; p < pl.row_ptr[i + 1]; ++p) {
      int q = r + pl.plane_shift[p];
      if (q >= z) q -= z;
      parity ^= post[pl.plane_col[p] * z + q] < 0.f ? 1 : 0;
    }
    count += parity;
  }
  return count;
}

// aux_out: the iterations run (kEarlyStop), else the unsatisfied-check
// count when not null. done_in: codewords to skip, when not null.
template <int kMethod, bool kLayered, bool kEarlyStop, bool kQuant>
__device__ __forceinline__ void decode(
    const float* __restrict__ llr, float* __restrict__ post_out,
    int8_t* __restrict__ bits_out, const int* __restrict__ done_in,
    int* __restrict__ aux_out, const int* __restrict__ plan_g,
    const float* __restrict__ ab, int z, int mb, int nb, int P,
    int iterations, int check_every, float clamp, float qstep,
    float qclip) {
  // the flag is the same for the whole CTA, so the return is uniform
  if (done_in != nullptr && done_in[blockIdx.x] != 0) return;
  extern __shared__ float4 smem_f4[];
  __shared__ int unsat_sum;
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
  auto rule = [&](int it) {
    return Rule{ab[2 * it], ab[2 * it + 1], clamp, qstep, qclip};
  };

  if (kEarlyStop) {
    int ran = iterations;
    // the vote returns the same value to every thread: `done` is uniform
    bool done = done_in == nullptr &&
                !__syncthreads_or(local_unsat(pl, post, z, mb) != 0);
    if (done) ran = 0;
    const int rounds = iterations / check_every;
    for (int r = 0; r < rounds && !done; ++r) {
      for (int k = 0; k < check_every; ++k)
        iterate<kMethod, kLayered, kQuant>(pl, msg, post, l, z, mb, n,
                                           rule(r * check_every + k));
      if (!__syncthreads_or(local_unsat(pl, post, z, mb) != 0)) {
        done = true;
        ran = (r + 1) * check_every;
      }
    }
    if (threadIdx.x == 0) aux_out[blockIdx.x] = ran;
  } else {
    for (int it = 0; it < iterations; ++it)
      iterate<kMethod, kLayered, kQuant>(pl, msg, post, l, z, mb, n,
                                         rule(it));
    if (aux_out != nullptr) {
      const int mine = local_unsat(pl, post, z, mb);
      if (threadIdx.x == 0) unsat_sum = 0;
      __syncthreads();
      if (mine != 0) atomicAdd(&unsat_sum, mine);
      __syncthreads();
      if (threadIdx.x == 0) aux_out[blockIdx.x] = unsat_sum;
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

#define QC_KERNEL(name, method, layered, early_stop, quant)                  \
  __global__ void name(const float* llr, float* post_out, int8_t* bits_out, \
                       const int* done_in, int* aux_out, const int* plan,   \
                       const float* ab, int z, int mb, int nb, int P,       \
                       int iterations, int check_every, float clamp,        \
                       float qstep, float qclip) {                          \
    decode<method, layered, early_stop, quant>(                             \
        llr, post_out, bits_out, done_in, aux_out, plan, ab, z, mb, nb, P,  \
        iterations, check_every, clamp, qstep, qclip);                      \
  }

QC_KERNEL(minsum_qc_flooding, kMinSum, false, false, false)
QC_KERNEL(minsum_qc_layered, kMinSum, true, false, false)
QC_KERNEL(minsum_qc_flooding_es, kMinSum, false, true, false)
QC_KERNEL(minsum_qc_layered_es, kMinSum, true, true, false)
QC_KERNEL(minsum_qc_flooding_msgq, kMinSum, false, false, true)
QC_KERNEL(minsum_qc_layered_msgq, kMinSum, true, false, true)
QC_KERNEL(minsum_qc_flooding_es_msgq, kMinSum, false, true, true)
QC_KERNEL(minsum_qc_layered_es_msgq, kMinSum, true, true, true)
QC_KERNEL(sumproduct_qc_flooding, kSumProduct, false, false, false)
QC_KERNEL(sumproduct_qc_layered, kSumProduct, true, false, false)
QC_KERNEL(sumproduct_qc_flooding_es, kSumProduct, false, true, false)
QC_KERNEL(sumproduct_qc_layered_es, kSumProduct, true, true, false)
QC_KERNEL(sumproduct_qc_flooding_msgq, kSumProduct, false, false, true)
QC_KERNEL(sumproduct_qc_layered_msgq, kSumProduct, true, false, true)
QC_KERNEL(sumproduct_qc_flooding_es_msgq, kSumProduct, false, true, true)
QC_KERNEL(sumproduct_qc_layered_es_msgq, kSumProduct, true, true, true)

extern "C" {

// Launches one decode on `stream`: grid = batch CTAs, one codeword each.
// method: 0 min-sum, 1 sum-product. quant != 0 selects the _msgq form with
// step qstep and clip qclip. `out` is int8 hard bits when out_hard != 0,
// else the f32 posterior in the log(Pr1/Pr0) convention; both (batch, nb*z)
// row-major. `ab` holds `iterations` rows of (alpha, beta). clamp = +inf
// for no clamp. done_in: (batch,) int32 flags of codewords to skip, or
// null. aux_out: (batch,) int32, the iterations run when early_stop != 0
// (then required), else the unsatisfied-check counts, or null. check_every
// must divide iterations; a sum-product code's rows have at most
// kMaxRowDeg slots. Returns the CUDA error code of the launch (0 on
// success).
int bp_qc_decode(int method, int layered, int early_stop, int quant,
                 const float* llr, void* out, int out_hard,
                 const int* done_in, int* aux_out, const int* plan,
                 const float* ab, int batch, int z, int mb, int nb, int P,
                 int iterations, int check_every, float clamp, float qstep,
                 float qclip, cudaStream_t stream) {
  using Kernel = void (*)(const float*, float*, int8_t*, const int*, int*,
                          const int*, const float*, int, int, int, int, int,
                          int, float, float, float);
  // [method][layered][early_stop][quant]
  static const Kernel kKernels[2][2][2][2] = {
      {{{minsum_qc_flooding, minsum_qc_flooding_msgq},
        {minsum_qc_flooding_es, minsum_qc_flooding_es_msgq}},
       {{minsum_qc_layered, minsum_qc_layered_msgq},
        {minsum_qc_layered_es, minsum_qc_layered_es_msgq}}},
      {{{sumproduct_qc_flooding, sumproduct_qc_flooding_msgq},
        {sumproduct_qc_flooding_es, sumproduct_qc_flooding_es_msgq}},
       {{sumproduct_qc_layered, sumproduct_qc_layered_msgq},
        {sumproduct_qc_layered_es, sumproduct_qc_layered_es_msgq}}}};
  const Kernel fn = kKernels[method != 0][layered != 0][early_stop != 0]
                            [quant != 0];
  const int smem = smem_bytes(z, mb, nb, P);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // layered: one thread per check of a block row; flooding: 256 threads
  // stride over the checks, then over the variables
  int threads = layered ? ((z + 31) / 32) * 32 : 256;
  if (threads > 1024) threads = 1024;
  float* post_out = out_hard ? nullptr : static_cast<float*>(out);
  int8_t* bits_out = out_hard ? static_cast<int8_t*>(out) : nullptr;
  fn<<<batch, threads, smem, stream>>>(llr, post_out, bits_out, done_in,
                                       aux_out, plan, ab, z, mb, nb, P,
                                       iterations, check_every, clamp, qstep,
                                       qclip);
  return static_cast<int>(cudaGetLastError());
}

// The largest row degree the sum-product forms take.
int bp_qc_max_row_degree() { return kMaxRowDeg; }

const char* bp_qc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
