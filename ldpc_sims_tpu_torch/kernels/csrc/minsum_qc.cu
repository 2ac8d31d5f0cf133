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
//     they did before it existed;
//   * per-edge neural-BP weights under both schedules (`write_posterior_w`
//     :259-275, the weighted update :356-367 and sweep :392-397,
//     :408-410, :434-436, the re-base :442-457, :463-467), a compile-time
//     flag too (the _w forms; no early stop, as on the TPU);
//   * the group-serial layered sweep, layered_group > 1 (:398-440): a
//     runtime argument of the layered forms, whose group = 1 path is the
//     serial-C code, and on a code within the compressed state's limits
//     the _gs kernels below;
//   * bf16 and int8 message storage (`dtype`, :130-134, `ld`/`st`
//     :216-228, the folds :420-439), a template parameter of every form.
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
// (_msgq: with message quantization) and
// {minsum,sumproduct}_qc_{flooding,layered}_w[_msgq] (weighted), 24 forms,
// each for three storage types: f32 (no suffix), _bf16 and _i8, 72 in all.
// The six serial-C min-sum forms (minsum_qc_layered[_es][_msgq],
// minsum_qc_layered_w[_msgq]) and the six flooding min-sum forms
// (minsum_qc_flooding[_es][_msgq], minsum_qc_flooding_w[_msgq]) have a
// second kernel each, name_cs, on the compressed check state below (36 in
// all); the launcher takes it, under the same form, for group 1 (layered)
// on a code within the state's limits. The twelve sum-product forms
// (sumproduct_qc_{flooding,layered}[_es][_msgq] and
// sumproduct_qc_{flooding,layered}_w[_msgq]) have a second kernel each
// too, name_sr, with a check's slots in registers (36 more), which the
// launcher takes under the same limits: flooding, or layered with group 1,
// on a code of row degree 8 or less within the parameter plan's block
// rows, planes and block columns. The twelve layered forms of both rules
// (the six min-sum and six sum-product layered forms) have a third kernel
// each, name_gs, group-serial (36 more), which the launcher takes for
// group > 1 on a code within the same limits. The twelve min-sum forms
// with a name_cs kernel have a fourth, name_cw, on the compressed state's
// wide word (36 more), which the launcher takes for flooding and group 1
// on a code beyond the limits by its row degree alone (rows of degree
// 8-18: the rate-2/3, 3/4 and 5/6 qc648 and qc1944 codes). On the same
// codes the six serial-C name_sr forms have a name_rw kernel (18 more) and
// the twelve name_gs forms a name_gw kernel (36 more): the same designs
// with each row's slots unrolled to its degree, min-sum on the wide word.
//
// Storage. The source is compiled once per storage type (-DQC_STORAGE=0, 1
// or 2; the three objects are built in parallel and linked into one
// library), and that translation unit's 24 entry points store:
//   * f32: everything in f32, as before;
//   * bf16: the messages, the posterior and the channel LLRs (rounded on
//     entry) as __nv_bfloat16, rounded to nearest even (XLA's convert);
//   * int8: the messages as q in [-127, 127] on the grid q*qstep, qstep =
//     2*msg_qclip/255, stored as clip(rint(v * (1/qstep)), -127, 127): the
//     product with the f32 reciprocal, rounded half to even; the posterior
//     and the LLRs stay f32.
// Every load lifts to f32 (int8: f32(q) * qstep) and all arithmetic is f32.
// Flooding computes each v2c on the fly but passes it through the storage
// before the check rule reads it, as the TPU kernel stores and reloads it;
// a posterior rebuild sums in f32 and rounds once per variable. A layered
// fold adds, for int8, what the stored message changes by, lift(st(new)) -
// old, and for bf16 the unrounded new - old while the message is stored
// rounded (so the posterior drifts from LLR + the messages, as on the
// TPU), and re-rounds the posterior after each fold; the group-serial
// scratch stays f32 and its fold rounds after each addition. The regions
// of shared memory are carved by their types, each on a 16-byte boundary
// (an int8 region of odd length is followed by an f32 posterior). The TPU
// kernel's pad slots (`stamp_pads`, `unpad`) have no counterpart: every
// loop runs over a check's true degree.
//
// Weights. The tables (iterations+1 rows of P*z check-oriented edge
// weights and of n LLR weights, the last row the final marginalization's;
// 195 KB + 54 KB for a 6-iteration wifi1944 decoder) are shared by all
// codewords and too large to sit in shared memory beside a CTA's 36 KB of
// state, so each thread reads its edges' weights through the read-only
// path (__ldg, served from L1/L2) and occupancy stays as it was. The order
// is the plain version's: w multiplies the message before the v2c
// subtraction, the posterior is rebuilt as wl*LLR + sum of w*c2v in
// check-sorted order (at start with row 0, after every iteration with the
// next row; for layered this is the re-base between sweeps), and a layered
// message change folds in as w*(new - old).
//
// Group-serial layered. The checks of a group of G block rows read the
// posterior as it stood before the group, so a change cannot fold at once
// where two rows of the group meet in a column block. On the full-message
// kernels (the codes beyond the limits below) each check writes all its
// changes into a shared-memory scratch of the group's planes (at most
// min(P, G*row_deg) planes of z floats); after a barrier each thread
// folds them into its variables, adding a variable's changes in row order
// (its column's planes are listed by block row) as the plain version does,
// deterministic and without atomics; the threads (G*z rounded to warps)
// stride over the group's checks, then over all the variables, each
// scanning its column's plane list. So a group costs two barriers.
//
// The _gs kernels (both rules, every group-taking form, on a code within
// the limits) redesign that loop for Hopper. A plane is private when it
// is the only plane of its column block within its group: no other check
// of the group reads its variables, so its check folds its change into
// the posterior at once, store(pv + d), the plain version's one addition
// (at wifi1944, G = 4: 25 of 86 planes). Only a shared plane's change goes
// to the scratch, which holds the largest group's shared planes (7,128 B
// at wifi1944, G = 4, against 10,368 for all its planes), in variable
// orientation: at the offset q its check computed for the posterior, so
// the fold pass reads the rows at the variable's own offset, without
// shifts. The per-group plan (GroupPlan: each plane private or its
// scratch row; each group's shared column blocks with their count and the
// first of their consecutive scratch rows, by block row) is built on the
// host (kernels/minsum_qc.py:group_plan) and read from the kernel
// parameter, like FloodPlan. Warps walk (block row of the group, 32
// checks), so no warp mixes two rows' degrees and plans and no index is
// divided by z (the full-message loop's warps straddle rows at z = 81); a
// check's slots are unrolled to its degree and held in registers (min-sum
// on the compressed state: gs_check_cs; sum-product: sp_check, no lt
// array in local memory). After one barrier the fold pass walks (fold
// entry, 32 variables) over the group's shared column blocks alone (23 a
// wifi1944 iteration at G = 4 against 3 x 1,944 variables), each variable
// adding its changes in block-row order, rounding to storage after each,
// two loads at a time; then one barrier (none where the group has no
// shared column block). A sum-product CTA has a warp for each 32 checks of
// a group (at most 1024 threads), a min-sum CTA one block row's warps
// where four CTAs fit an SM's shared memory, else as sum-product (the
// launcher); bit for bit the full-message kernels'
// results (kernels/compare.py against the earlier tree, PERF.md).
//
// Design. One CTA decodes one codeword. Its check state (the c2v messages,
// P planes of z floats, 27,864 B at wifi1944, or the compressed state
// below) and its posterior (n floats, 7,776 B) stay in shared memory for
// all iterations, so device memory sees the LLRs read (the full-message
// flooding forms read them again each iteration, through L2; the
// compressed ones keep them in shared memory) and the output written
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
// version. The full-message kernels keep a row's lt values in a
// per-thread array of kMaxRowDeg floats rather than computing them twice
// (a slot indexed at run time: local memory, a 128 B stack frame; the
// wrapper reads the bound through bp_qc_max_row_degree and checks the
// code's row degree against it at launch), the _sr kernels in registers.
// The transcendentals are libdevice's
// expf/expm1f/log1pf/logf, as PyTorch's CUDA exp/expm1/log1p/log, never the
// __expf-style intrinsics. Then every message is clamped, and quantized
// when the form has it: q = rint(y / step) * step, clipped to +-qclip, with
// a true IEEE division and rint's round-half-to-even (torch.round's). Built
// with --fmad=false and without fast math so the arithmetic matches the
// plain PyTorch version (ops/bp_roll.py) bit for bit.
//
// Min-sum on a compressed check state (the _cs kernels). A min-sum
// check's message on slot e is sgn_e * T(exmin_e), exmin_e = min2
// at the slot of the first minimum and min1 at the others, T the whole
// chain that makes a message: (s * max(m - beta, 0)) * alpha, the clamp,
// the message quantization, the storage. Every step of T is odd:
// multiplying by +-1 is exact; the clamp and the +-qclip clip are
// symmetric; rint rounds half to even; bf16's round to nearest even and
// int8's rint(v * inv) with its +-127 clip are symmetric. So T(-m) = -T(m)
// bit for bit, and a check keeps T(min1) and T(min2) as stored values and
// a 16-bit word: the exclusive-sign bits of its slots (bits 0-7) and the
// slot of its first minimum (bits 8-10). Each message is rebuilt from
// them exactly: f32 and bf16 negate the lifted magnitude (a stored -0 stays
// -0), int8 negates the code (a zero code lifts to +0, as the stored
// message does). The folds are the full design's: int8 adds lift(st(new)) -
// old, bf16 the unrounded new - old, old the rebuilt stored message; a
// weighted form's rebuild reads the messages the same way (variable j*z+q
// meets check q - shift[p] of plane p's block row at the plane's slot).
// The state takes 2*sizeof(Msg) + 2 bytes a check instead of a message an
// edge: a CTA of wifi1944 at f32 18,688 B against 36,832 (6 -> 11 CTAs an
// SM by shared memory; its 48 registers a thread allow 14), qc12288 111,488
// B against 174,976 (1 -> 2), qc8448 75,968 B against 121,024 (1 -> 3).
// A thread keeps its check's posterior values and old messages in
// registers (arrays of kCsMaxDeg = 8 slots, unrolled; no slot is indexed
// at run time), so it reads each edge's posterior once and writes it once
// as store(pv + (y - old)), and it reads the sweep's plan from the kernel
// parameter (the constant bank; a plane's index is the same for the whole
// warp). That leaves d + 2 shared-memory loads and d + 2 stores a check of
// degree d: 2.56 an edge at wifi1944's mean degree 7.17, against 10.28 with
// full messages (a plan, message and posterior load in the first pass, the
// same three loads and two stores in the second, two row_ptr loads a
// check), as the SASS of both kernels shows (chip_smoke.py phase 4). The
// serial-C forms then run at 1.20-1.60x their full-message times, bit for
// bit the same (PERF.md, kernels/compare.py on an NVIDIA H100 80GB HBM3 at
// 700 W). The min-sum _gs kernels keep the compressed state too: against
// full messages with a check's slots in registers (64 registers a thread
// to its 56) it measured 1.04-1.32x faster at f32 and equal at int8
// (PERF.md). Every code the main path and the bigcode run decode has rows
// of degree 5-8, and 8 slots measured 1.05-1.30x faster than 12 (48
// registers a thread against 60), so the codes with rows above 8 slots take
// the wide word below instead of widening this one.
//
// Min-sum on the wide compressed state (the _cw kernels). The rate-2/3,
// 3/4 and 5/6 qc648 and qc1944 codes have rows of degree 8-9, 11-12 and
// 17-18 and fit the limits above but for the 8 slots. Their serial-C and
// flooding min-sum forms keep the same state with a 32-bit word: the
// exclusive-sign bits of up to 24 slots (bits 0-23) and the slot of the
// first minimum (bits 24-28); CsState<true> names the word, and every
// function of the state takes it as a template parameter, so the _cs
// kernels are the same instantiations as before. A check's slots are
// unrolled to its row's exact degree, one body for each degree the
// library's codes have (CwDegrees: 8, 9, 11, 12, 17, 18), dispatched once
// a block row (serial-C: the CTA's row; flooding: the warp's task), so no
// slot is guarded and no register array is larger than the row. The
// flooding plan's column entries carry the slot's sign bit and the slot
// in the wide word's index field (slot << 24; the narrow word's slot << 8
// would put a slot of 8 or more into the index field).
//
// The other forms on the wide rows (the _gw and _rw kernels). The
// group-serial forms of both rules (_gw) are the _gs kernels with each
// check's slots in a body of its row's degree, dispatched once a warp's
// task by by_degree over CwDegrees, min-sum on the wide word (gs_check_cs
// takes the word as a template parameter, as check_update_cs does), and
// sum-product's serial-C forms (_rw) are the _sr kernels with the same
// bodies, one dispatch a block row. A degree-18 body would keep 54 values
// a check in registers (72 weighted); these bodies keep only the v2c and
// read each slot's old message, posterior and weight again in pass 2
// (kReload), which cut the registers of the sum-product serial-C kernel
// from 179 to 141 and made it faster than the full messages. Sum-product
// flooding on these rows keeps the full-message kernel: with the slots in
// registers it ran 1.04-1.07x slower at every CTA size (80 registers a
// thread, the flooding check's 18 lt values live across its calls).
// PERF.md has ptxas's registers and stack frame of every entry point and
// their times against the full-message kernels they replace, which a code
// with a row of another degree still takes.
//
// Flooding min-sum on the compressed state. A flooding check reads only
// its own old messages, so its new state overwrites its old one in place;
// the check pass rebuilds each old message from the state, passes each
// v2c through the message storage as the full design does, and writes the
// magnitude pair and the word once a check and no posterior. Then each
// variable's posterior is rebuilt from its checks' states in check-sorted
// order (variable j*z+q meets check q - shift[p] of plane p's block row at
// the plane's slot), with the (w*) messages added to (wl*) LLR in f32 and
// stored once: the plain version's sums in its order, no atomics. The
// LLRs stay in shared memory as the posterior's storage holds them (n
// values more a CTA; a register copy on a fixed thread-to-variable map
// took two to four times the registers a thread and ran slower than
// reading them again through L2). Warps walk (block row, 32 checks) in the
// check pass and (column block, 32 variables) in the rebuild, so every
// plan index a warp reads is uniform and the plan, with each column's
// (check offset, shift, slot, plane) entries, comes from the kernel
// parameter (FloodPlan, 6.7 KB); no index is divided by z. A check's slots
// are unrolled to its degree (one uniform dispatch a check, no guarded
// slot) and the two minima are kept without a branch; the rebuild adds a
// column's entries two at a time. Shared-memory instructions an edge at
// wifi1944 (d = 7.17, 3.58 edges a variable): d + 4 a check and 2 an edge
// plus 2 a variable (its LLR load and posterior store), 4.12, against
// 13.12 for the full-message loops (SASS, chip_smoke.py phase 4). The
// __launch_bounds__(1024) keeps every CTA size the flooding forms take
// launchable (64 registers at most; the fixed forms use 31-32, early stop
// 40-42, the weighted 50-53). A CTA takes the state, the posterior and
// the LLRs: wifi1944 f32 25,280 B, qc12288 159,744 B, qc8448 108,544 B
// (smem_bytes). The flooding forms then run 1.26-1.63x faster than on
// full messages, bit for bit the same (PERF.md, kernels/compare.py on an
// NVIDIA H100 80GB HBM3 at 700 W).
//
// Sum-product with a check's slots in registers (the _sr kernels). A
// sum-product message is not a function of two magnitudes, so its check
// state stays the full messages; what the min-sum designs changed around
// it carries over. Both schedules read their plan, rows and columns, from
// the kernel parameter (FloodPlan), so no plan sits in shared memory. A
// check's slots are unrolled to its degree (one uniform dispatch a check):
// pass 1 reads each slot's stored message and posterior once and keeps
// them, the v2c and (weighted) the weight in registers, the v2c's sign as
// a bit; pass 2 reads no shared memory and writes each message and, for
// serial-C, each posterior once. That is 2 loads and 2 stores an edge
// (serial-C) or 2 loads and 1 store an edge and a rebuild of 1 load an
// edge and 2 a variable (flooding), against 10.28 and 13.12 shared-memory
// instructions an edge and a local store and load (the lt array) with the
// full messages at wifi1944 (SASS, chip_smoke.py phase 4). Flooding
// walks warps over (block row, 32 checks) and (column block, 32
// variables), no index divided by z, and keeps the LLRs in shared memory
// in the posterior's type (kSrFloodLlrShared; PERF.md times it against
// reading them again through L2). The arithmetic is check_update's in its
// order (the row
// sum left to right, each v2c through the storage for flooding, the same
// folds), and within a block row the checks touch disjoint variables, so
// the values are the same bits. The sequences of sp_lt and sp_mag are
// calls (sp_lt2, sp_mag2: two slots interleaved a call, two independent
// chains; one copy a kernel): inlined into every unrolled slot of the
// eight degree bodies they made each kernel several times longer, and it
// ran slower than the full-message kernel; one slot a call ran slower than
// two, four no faster. On an NVIDIA H100 80GB HBM3 at 700 W the _sr forms
// run 1.00-1.32x faster than the full messages, bit for bit the same
// (PERF.md, kernels/compare.py). Registers (ptxas, chip_smoke.py phase
// 1): 52-59 a thread for flooding, 72-98 for serial-C, so a 256-thread
// flooding CTA is held to four an SM by its registers.
//
// What bounds the kernels on the H100. Serial-C min-sum on the compressed
// state issues about 45 instructions a slot across its two passes (the
// message rebuild, the index arithmetic, the two-minima update; the check
// body's SASS), so instruction issue bounds it, not shared memory: at
// wifi1944's 3 warps a block row (the third with 17 of 32 lanes busy) that
// is about 3 ms of a 4.05 ms trained layered-8 at batch 32768. Flooding
// min-sum on the compressed state is issue bound the same way: its check
// pass holds 947 instructions for the bodies of degrees 1-8 (36 slots,
// about 21 a slot with each body's state update), its rebuild 17 an edge
// (SASS), with 81 of 96 lanes busy at z = 81, at full occupancy (32
// registers, 256 threads, 8 CTAs an SM). The full-message forms hold ~36
// KB a codeword at wifi1944 (6 resident codewords an SM; bf16 19 KB, 11;
// int8 16 KB, 13; the 5G-class codes' 121-175 KB at f32 one, bf16 and
// int8 two to four), and their per-edge work, about 10 (serial-C) or 13
// (flooding) shared-memory instructions an edge, is issued by few warps,
// so they are latency bound well above both the byte bound and the f32
// op bound (PERF.md). The sum-product forms add eight libdevice
// transcendentals per edge, about 150 f32 and 4 MUFU instructions in the
// SASS, so f32 issue bounds them, not the special-function units; with
// the rest of libdevice's sequences (integer exponent work, selects,
// branches) a sum-product edge issues well over those ~154 instructions,
// so the f32 bound understates the issue time (PERF.md). The
// early-stop forms do the work of the iterations each codeword runs plus
// one syndrome pass (about one iteration's reads, no writes) per check; a
// CTA that finishes early frees its SM slot for the next codeword, so the
// grid's time follows the mean of the iterations, not their maximum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#ifndef QC_STORAGE
#error "compile once per storage type: -DQC_STORAGE=0 (f32), 1 (bf16), 2 (int8)"
#endif

namespace {

// message storage types: the dtype code of bp_qc_decode
constexpr int kF32 = 0;
constexpr int kBf16 = 1;
constexpr int kInt8 = 2;

// The types one storage code keeps its messages and its posterior in.
template <int kT>
struct Storage;
template <>
struct Storage<kF32> {
  using Msg = float;
  using Post = float;
};
template <>
struct Storage<kBf16> {
  using Msg = __nv_bfloat16;
  using Post = __nv_bfloat16;
};
template <>
struct Storage<kInt8> {
  using Msg = int8_t;
  using Post = float;
};

// A stored value lifted to f32 (`ld`); step: the int8 grid's step.
__device__ __forceinline__ float lift(float x, float) { return x; }
__device__ __forceinline__ float lift(__nv_bfloat16 x, float) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float lift(int8_t x, float step) {
  return static_cast<float>(x) * step;
}

// An f32 value stored (`st`); inv: the reciprocal of the int8 grid's step.
template <typename T>
__device__ __forceinline__ T store(float v, float inv);
template <>
__device__ __forceinline__ float store<float>(float v, float) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v,
                                                              float) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ int8_t store<int8_t>(float v, float inv) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v * inv), -127.f), 127.f));
}

// A posterior (or LLR) value as its storage holds it.
template <typename T>
__device__ __forceinline__ float round_post(float v) {
  return lift(store<T>(v, 1.f), 1.f);
}

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
  float sstep, sinv;   // the int8 storage grid's step and its reciprocal
};

__host__ __device__ inline int plan_ints(int mb, int nb, int P) {
  return (mb + 1) + 3 * P + (nb + 1);
}

__host__ __device__ inline int plan_ints_padded(int mb, int nb, int P) {
  return (plan_ints(mb, nb, P) + 3) & ~3;
}

__host__ __device__ inline int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// The kernel designs (bp_qc_decode's `design`): the full messages, the
// compressed min-sum check state (the _cs kernels), the sum-product slots
// in registers (the _sr kernels), the group-serial sweep with its
// per-group plan in the kernel parameter (the _gs kernels).
constexpr int kDesignFull = 0;
constexpr int kDesignCs = 1;
constexpr int kDesignSr = 2;
constexpr int kDesignGs = 3;
// the compressed min-sum check state on its wide word (the _cw kernels)
constexpr int kDesignCw = 4;
// the group-serial sweep of both rules on the wide rows (the _gw kernels:
// min-sum on the wide word, sum-product with its slots in registers)
constexpr int kDesignGw = 5;
// sum-product serial-C with a check's slots in registers on the wide rows
// (the _rw kernels)
constexpr int kDesignRw = 6;
// whether the flooding _sr kernels keep the LLRs in shared memory (else
// each rebuild reads them again through L2; PERF.md times both)
constexpr bool kSrFloodLlrShared = true;
// shared memory of an H100 SM, and what it reserves a CTA
constexpr int kSmemPerSm = 233472;
constexpr int kSmemPerCta = 1024;

// Bytes of dynamic shared memory one CTA needs: plan (not on the
// compressed flooding forms, the _sr or the _gs forms, which read theirs
// from the parameter), c2v planes (Msg) or, on the compressed state
// (`compressed`), two Msg magnitudes and a 16-bit word per check (a
// 32-bit word on the _cw kernels),
// posterior (Post), the LLRs in the posterior's type (the compressed
// flooding forms, and the flooding _sr forms with kSrFloodLlrShared) and,
// for a group of G > 1 block rows, the f32 scratch of scratch_planes
// planes (the full-message kernels: the group's planes; the _gs kernels:
// the largest group's shared planes); each region starts on a 16-byte
// boundary.
template <int kT>
inline int smem_bytes(int z, int mb, int nb, int P, int scratch_planes,
                      int design, bool layered, bool compressed) {
  using S = Storage<kT>;
  const bool sr = design == kDesignSr || design == kDesignRw;
  const bool gs = design == kDesignGs || design == kDesignGw;
  const int msg = static_cast<int>(sizeof(typename S::Msg));
  // CsState's Word
  const int word = design == kDesignCw || design == kDesignGw ? 4 : 2;
  const int state = compressed
                        ? align16(mb * z * 2 * msg) + align16(mb * z * word)
                        : align16(P * z * msg);
  const bool param_plan = (compressed && !layered) || sr || gs;
  const bool llrs = !layered && (compressed || (sr && kSrFloodLlrShared));
  const int plan = param_plan ? 0 : 4 * plan_ints_padded(mb, nb, P);
  const int post = align16(nb * z * static_cast<int>(sizeof(typename S::Post)));
  return plan + state + (llrs ? 2 * post : post) + 4 * scratch_planes * z;
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

// sp_lt and sp_mag as calls for the _sr kernels, which unroll a check's
// slots: two slots' sequences interleaved in one call (two independent
// chains for the scheduler) and a single one for an odd last slot, one copy
// of each a kernel. Inlined into every slot of every degree's body the
// sequences made a kernel several times longer, and it ran slower than the
// full-message kernel.
__device__ __noinline__ float2 sp_lt2(float a, float b) {
  return make_float2(sp_lt(a), sp_lt(b));
}
__device__ __noinline__ float2 sp_mag2(float a, float b) {
  return make_float2(sp_mag(a), sp_mag(b));
}
__device__ __noinline__ float sp_lt1(float v) { return sp_lt(v); }
__device__ __noinline__ float sp_mag1(float s) { return sp_mag(s); }

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

// What a check update does with its message changes.
constexpr int kFoldNone = 0;   // flooding: nothing (the posterior is rebuilt)
constexpr int kFoldPost = 1;   // serial-C: fold into the posterior at once
constexpr int kFoldDelta = 2;  // group-serial: keep in `delta` for later
// the _gs kernels: a private plane's change into the posterior at once, a
// shared plane's into `delta` at its scratch row
constexpr int kFoldGroup = 3;

// Exclusive check update of check (i, r). Reads v2c = post - c2v (with
// weights, post - w*c2v) for each of its edges (flooding: as the message
// storage holds it), writes the new c2v messages and, for the layered
// schedules, the message change (with weights, w*(new - old); int8: of the
// stored message) as kFold says (kFoldDelta: slot k of the row into
// delta[k*z + r]). w: this iteration's weights of the check-oriented edges
// (P*z), read through the read-only cache.
template <int kMethod, int kFold, bool kQuant, bool kW, int kT>
__device__ __forceinline__ void check_update(
    const Plan& pl, typename Storage<kT>::Msg* msg,
    typename Storage<kT>::Post* post, float* delta,
    const float* __restrict__ w, int z, int i, int r, const Rule& u) {
  using Msg = typename Storage<kT>::Msg;
  using Post = typename Storage<kT>::Post;
  // the v2c of an edge; flooding passes it through the message storage
  auto v2c = [&](float pv, float m) {
    const float v = pv - m;
    return kFold == kFoldNone ? lift(store<Msg>(v, u.sinv), u.sstep) : v;
  };
  const int p0 = pl.row_ptr[i], p1 = pl.row_ptr[i + 1];
  float min1 = kBig, min2 = kBig;  // min-sum
  int idx = -1, nneg = 0;
  float lts[kMethod == kSumProduct ? kMaxRowDeg : 1];  // sum-product
  float total = 0.f;
  for (int p = p0; p < p1; ++p) {
    int q = r + pl.plane_shift[p];
    if (q >= z) q -= z;
    float m = lift(msg[p * z + r], u.sstep);
    if constexpr (kW) m = __ldg(w + p * z + r) * m;
    const float v = v2c(lift(post[pl.plane_col[p] * z + q], 1.f), m);
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
    const float old = lift(msg[p * z + r], u.sstep);
    const float wp = kW ? __ldg(w + p * z + r) : 1.f;
    const float pv = lift(post[vi], 1.f);
    const float v = kW ? v2c(pv, wp * old) : v2c(pv, old);
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
    const Msg stored = store<Msg>(y, u.sinv);
    msg[p * z + r] = stored;
    // int8 folds what the stored message changes by; bf16 the unrounded
    // change, as the TPU kernel does
    if constexpr (kT == kInt8) y = lift(stored, u.sstep);
    const float d = kW ? wp * (y - old) : y - old;
    if constexpr (kFold == kFoldPost) post[vi] = store<Post>(pv + d, 1.f);
    if constexpr (kFold == kFoldDelta) delta[(p - p0) * z + r] = d;
  }
}

// The posterior rebuilt from the messages: (wl*) LLR + the sum of the
// (w*) c2v messages of each variable in check-sorted order (the order of
// the plain version), in f32 and stored once, one thread per variable, no
// atomics. The LLR is taken as the posterior's storage holds it. w, wl: one
// row of the weight tables (kW only).
template <bool kW, int kT>
__device__ __forceinline__ void rebuild(const Plan& pl,
                                        const typename Storage<kT>::Msg* msg,
                                        typename Storage<kT>::Post* post,
                                        const float* l,
                                        const float* __restrict__ w,
                                        const float* __restrict__ wl, int z,
                                        int n, float sstep) {
  using Post = typename Storage<kT>::Post;
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int j = v / z, q = v % z;
    float acc = round_post<Post>(-l[v]);
    if constexpr (kW) acc = __ldg(wl + v) * acc;
    for (int e = pl.col_ptr[j]; e < pl.col_ptr[j + 1]; ++e) {
      const int p = pl.col_planes[e];
      int r = q - pl.plane_shift[p];
      if (r < 0) r += z;
      const float m = lift(msg[p * z + r], sstep);
      acc = acc + (kW ? __ldg(w + p * z + r) * m : m);
    }
    post[v] = store<Post>(acc, 1.f);
  }
}

// ---- The compressed min-sum check state (the layered min-sum forms) ----
//
// A min-sum check's messages are sgn_e * T(exmin_e) with exmin_e = min2 at
// the slot of the first minimum and min1 elsewhere, and every step of T
// (the offset and normalization, the clamp, the quantization, the storage)
// is odd, so a check keeps two stored magnitudes and one 16-bit word (the
// exclusive-sign bits of its slots, and the slot of the first minimum) and
// rebuilds each message exactly from them (the header says why).

// slots a compressed check takes: bits 0-7 of its word are the signs,
// bits 8-10 the slot of the first minimum
constexpr int kCsMaxDeg = 8;
constexpr int kCsIdxShift = kCsMaxDeg;
// slots a wide compressed check takes (the _cw kernels): bits 0-23 of its
// 32-bit word are the signs, bits 24-28 the slot of the first minimum
constexpr int kCwMaxDeg = 24;
// the largest plan the kernel parameter carries
constexpr int kCsMaxRows = 64;
constexpr int kCsMaxPlanes = 192;

// The word of a compressed check: its type, the slots it takes, where the
// slot of the first minimum starts and the masks of both fields. The
// narrow word (the _cs and _gs kernels) has 8 sign bits and a 3-bit index
// in 16 bits; the wide word (the _cw kernels) 24 sign bits and a 5-bit
// index in 32.
template <bool kWide>
struct CsState {
  using Word = uint16_t;
  static constexpr bool kIsWide = false;
  static constexpr int kMaxDeg = kCsMaxDeg;
  static constexpr int kIdxShift = kCsIdxShift;
  static constexpr unsigned kIdxMask = 7u << kIdxShift;
  static constexpr unsigned kSignMask = (1u << kMaxDeg) - 1;
};
template <>
struct CsState<true> {
  using Word = uint32_t;
  static constexpr bool kIsWide = true;
  static constexpr int kMaxDeg = kCwMaxDeg;
  static constexpr int kIdxShift = kCwMaxDeg;
  static constexpr unsigned kIdxMask = 31u << kIdxShift;
  static constexpr unsigned kSignMask = (1u << kMaxDeg) - 1;
};
using CsNarrow = CsState<false>;
using CsWide = CsState<true>;
static_assert(sizeof(CsNarrow::Word) == 2 && sizeof(CsWide::Word) == 4,
              "smem_bytes sizes the words");
static_assert(CsWide::kIdxShift + 5 <= 32 &&
                  (kCwMaxDeg - 1) <= (CsWide::kIdxMask >> CsWide::kIdxShift),
              "the wide word holds 24 sign bits and a 5-bit slot");

// The row degrees the wide kernels have a body for, each unrolled to its
// degree: those of the library's codes beyond the narrow word's 8 slots
// (rows of degree 8-9, 11-12 and 17-18, each code's rows one degree
// apart), the most common first. A body for every degree up to 24 would
// make each kernel several times longer (PERF.md). The launcher refuses a
// code with a row of another degree.
template <int... kDegs>
struct Degrees {};
using CwDegrees = Degrees<17, 11, 8, 18, 12, 9>;
template <int... kDegs>
constexpr unsigned degree_mask(Degrees<kDegs...>) {
  return ((1u << kDegs) | ...);
}
constexpr unsigned kCwDegreeMask = degree_mask(CwDegrees{});
static_assert((kCwDegreeMask >> (kCwMaxDeg + 1)) == 0,
              "a wide body above the word's slots");

// f(std::integral_constant<int, deg>) for the body of degree deg: one
// uniform comparison a degree of the list, the last taken without one.
template <typename F, int kD, int... kRest>
__device__ __forceinline__ void by_degree(Degrees<kD, kRest...>, int deg,
                                          const F& f) {
  if constexpr (sizeof...(kRest) > 0) {
    if (deg != kD) {
      by_degree(Degrees<kRest...>{}, deg, f);
      return;
    }
  }
  f(std::integral_constant<int, kD>{});
}


// The layered sweep's plan in the kernel's parameter space (the constant
// bank): its index p is the same for every thread of a warp, so each read
// is one uniform constant-cache load, not a shared-memory instruction.
//   row_ptr[mb+1]  planes of block row i are [row_ptr[i], row_ptr[i+1])
//   plane[p]       (col*z, shift, row*z, slot) of plane p: its variables'
//                  offset, its circulant shift, its checks' offset and its
//                  slot in its block row
struct ParamPlan {
  int row_ptr[kCsMaxRows + 1];
  int4 plane[kCsMaxPlanes];
};

// block columns the flooding plan in the kernel parameter takes
constexpr int kCsMaxCols = 64;

// The flooding plan in the kernel's parameter space: the rows' plan, and
// for the posterior rebuild each column block's checks (6.7 KB, within
// the 32,764 B a kernel's parameters may take since CUDA 12.1).
//   col_ptr[nb+1]  entries of column block j are [col_ptr[j], col_ptr[j+1]),
//                  by block row (the plain version's order)
//   col[e]         (row*z, shift, 1 << slot | slot << kIdxShift, plane) of
//                  entry e: its checks' offset, its circulant shift, its
//                  slot in its block row as the word's sign bit and index
//                  field hold it (kIdxShift: 8 for the narrow word, 24 for
//                  the wide one), its plane (the weight table's index)
struct FloodPlan : ParamPlan {
  int col_ptr[kCsMaxCols + 1];
  int4 col[kCsMaxPlanes];
};

// groups and fold entries the group-serial plan takes: G >= 2 over at most
// kCsMaxRows block rows, and an entry holds two planes or more
constexpr int kGsMaxGroups = kCsMaxRows / 2;
constexpr int kGsMaxFolds = kCsMaxPlanes / 2;

// The group-serial plan in the kernel's parameter space (the _gs kernels,
// 9,136 B): the flooding plan (the check walk, the counts and the weighted
// rebuild read its rows and columns), and what each group's fold pass
// needs. A plane is private when it is the only plane of its column block
// within its group: no other check of the group reads its variables, so
// its change folds into the posterior at once, as serial-C folds; a shared
// plane's change waits in the group's f32 scratch for the fold pass, in
// variable orientation (the change of variable col*z + q at scratch row
// times z + q), so the fold pass does no shift arithmetic. The shared
// planes of a column block have consecutive scratch rows in block-row
// order. The launcher copies it from the host ints of
// kernels/minsum_qc.py:group_plan.
//   fold_ptr[g+1]  group g's fold entries are [fold_ptr[g], fold_ptr[g+1])
//   scratch[p]     plane p's scratch row times z, or -1 (private)
//   fold[f]        (col*z, row*z, count, 0): a column block that count >= 2
//                  planes of the group meet, and the scratch row of the
//                  first of them (by block row, the plain version's order)
struct GroupPlan : FloodPlan {
  int fold_ptr[kGsMaxGroups + 1];
  int scratch[kCsMaxPlanes];
  int4 fold[kGsMaxFolds];
};
static_assert(sizeof(GroupPlan) <= 32764,
              "a kernel's parameters take at most 32,764 B on sm_90");

// A warp's walk over the tasks of a flooding pass: block b (a block row,
// or a column block) and its chunk k of 32 checks or variables, lanes
// k*32 .. k*32+31 of the z. Warp w starts at task w and steps by the CTA's
// warp count; (b, k) steps without a division, and every plan index a
// task reads is the same for the whole warp.
struct WarpWalk {
  int b, k;    // the task
  int db, dk;  // the step: blocks and chunks
  int chunks;  // chunks a block, ceil(z / 32)
  __device__ __forceinline__ void next() {
    b += db;
    k += dk;
    if (k >= chunks) {
      k -= chunks;
      ++b;
    }
  }
  // this thread's check or variable offset in block b
  __device__ __forceinline__ int at() const {
    return (k << 5) + static_cast<int>(threadIdx.x & 31);
  }
};

__device__ __forceinline__ WarpWalk warp_walk(int z) {
  const int chunks = (z + 31) >> 5;
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  return WarpWalk{w / chunks, w % chunks, nw / chunks, nw % chunks, chunks};
}

// The two stored magnitudes of a check: T(min1) and T(min2).
template <typename Msg>
struct alignas(2 * sizeof(Msg)) MagPair {
  Msg m1, m2;
};

// A stored magnitude with the sign of its slot: the message as the full
// state would store it. f32 and bf16 negate the lifted value (the sign of
// a zero is kept, as the stored -0 would keep it); int8 negates the code,
// so a zero code lifts to +0 either way, as it does when stored.
template <typename Msg>
__device__ __forceinline__ float signed_lift(Msg m, bool neg, float step) {
  const float v = lift(m, step);
  return neg ? -v : v;
}
__device__ __forceinline__ float signed_lift(int8_t m, bool neg, float step) {
  return lift(static_cast<int8_t>(neg ? -m : m), step);
}

// The message of slot e of a check from its state (S: its word).
template <typename S, typename Msg>
__device__ __forceinline__ float cs_message(const MagPair<Msg>& s,
                                            unsigned word, int e,
                                            float step) {
  const bool second = e == static_cast<int>(word >> S::kIdxShift);
  return signed_lift(second ? s.m2 : s.m1, (word >> e) & 1u, step);
}

// A compressed check's new word from its v2c, and T of both magnitudes
// into t1, t2: (1 * max(exmin - beta, 0)) * alpha is the message of a
// positive sign, then the clamp and quantization; with no minimum below
// kBig, min1 == min2 and slot 0 stands for the index. The exclusive sign
// of slot e is the parity of the other slots' negatives (negs: bit e set
// where the v2c of slot e is < 0).
template <bool kQuant, typename S>
__device__ __forceinline__ unsigned cs_finish(float min1, float min2, int idx,
                                              unsigned negs, const Rule& u,
                                              float& t1, float& t2) {
  t1 = postlude<kQuant>(fmaxf(min1 - u.beta, 0.f) * u.alpha, u);
  t2 = postlude<kQuant>(fmaxf(min2 - u.beta, 0.f) * u.alpha, u);
  const unsigned signs =
      (negs ^ ((__popc(negs) & 1) ? S::kSignMask : 0u)) & S::kSignMask;
  return signs | (static_cast<unsigned>(idx < 0 ? 0 : idx) << S::kIdxShift);
}

// check_update's serial-C form (kFoldPost) for min-sum on the compressed
// state: the same arithmetic in the same order, with each edge's posterior
// read once. Pass 1 keeps each slot's
// posterior value and old message in registers (arrays of kSlots,
// unrolled: no slot is indexed at run time), pass 2 writes the posterior
// as store(pv + (y - old)) and the new state once per check. S: the word.
// The narrow word's kernels take kSlots = 8 and guard each slot by the
// row's degree; the wide word's are called at the row's exact degree
// kSlots (by_degree), so no slot is guarded.
template <bool kQuant, bool kW, int kT, typename S = CsNarrow,
          int kSlots = kCsMaxDeg>
__device__ __forceinline__ void check_update_cs(
    const ParamPlan& pp, MagPair<typename Storage<kT>::Msg>* mag,
    typename S::Word* word, typename Storage<kT>::Post* post,
    const float* __restrict__ w, int z, int i, int r, const Rule& u) {
  using Msg = typename Storage<kT>::Msg;
  using Post = typename Storage<kT>::Post;
  static_assert(kSlots <= S::kMaxDeg, "more slots than the word's");
  const int p0 = pp.row_ptr[i];
  const int deg = S::kIsWide ? kSlots : pp.row_ptr[i + 1] - p0;
  const int c = i * z + r;
  const MagPair<Msg> os = mag[c];
  const unsigned ow = word[c];
  float pv[kSlots], old[kSlots], wv[kW ? kSlots : 1];
  float min1 = kBig, min2 = kBig;
  int idx = -1;
  unsigned negs = 0;  // bit e: the v2c of slot e is < 0
#pragma unroll
  for (int e = 0; e < kSlots; ++e) {
    if (e < deg) {
      const int4 pl = pp.plane[p0 + e];
      int q = r + pl.y;
      if (q >= z) q -= z;
      old[e] = cs_message<S>(os, ow, e, u.sstep);
      float m = old[e];
      if constexpr (kW) {
        wv[e] = __ldg(w + (p0 + e) * z + r);
        m = wv[e] * m;
      }
      pv[e] = lift(post[pl.x + q], 1.f);
      const float v = pv[e] - m;
      negs |= (v < 0.f ? 1u : 0u) << e;
      const float a = fabsf(v);
      if (a < min1) {  // strict: idx is the first minimum, as argmin
        min2 = min1;
        min1 = a;
        idx = e;
      } else if (a < min2) {
        min2 = a;
      }
    }
  }
  float t1, t2;
  const unsigned nw = cs_finish<kQuant, S>(min1, min2, idx, negs, u, t1, t2);
  const MagPair<Msg> ns{store<Msg>(t1, u.sinv), store<Msg>(t2, u.sinv)};
#pragma unroll
  for (int e = 0; e < kSlots; ++e) {
    if (e < deg) {
      // int8 folds what the stored message changes by; bf16 the unrounded
      // change, as the TPU kernel does
      float y;
      if constexpr (kT == kInt8) {
        y = cs_message<S>(ns, nw, e, u.sstep);
      } else {
        const float t = e == static_cast<int>(nw >> S::kIdxShift) ? t2 : t1;
        y = (nw >> e) & 1u ? -t : t;
      }
      float d = y - old[e];
      if constexpr (kW) d = wv[e] * d;
      const int4 pl = pp.plane[p0 + e];
      int q = r + pl.y;
      if (q >= z) q -= z;
      post[pl.x + q] = store<Post>(pv[e] + d, 1.f);
    }
  }
  mag[c] = ns;
  word[c] = static_cast<typename S::Word>(nw);
}

// rebuild on the compressed state: variable j*z+q meets check r = q -
// shift[p] of plane p's block row at the plane's slot.
template <int kT, typename S = CsNarrow>
__device__ __forceinline__ void rebuild_cs(
    const Plan& pl, const ParamPlan& pp,
    const MagPair<typename Storage<kT>::Msg>* mag,
    const typename S::Word* word,
    typename Storage<kT>::Post* post, const float* l,
    const float* __restrict__ w, const float* __restrict__ wl, int z, int n,
    float sstep) {
  using Post = typename Storage<kT>::Post;
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int j = v / z, q = v % z;
    float acc = __ldg(wl + v) * round_post<Post>(-l[v]);
    for (int e = pl.col_ptr[j]; e < pl.col_ptr[j + 1]; ++e) {
      const int p = pl.col_planes[e];
      const int4 info = pp.plane[p];
      int r = q - info.y;
      if (r < 0) r += z;
      const int c = info.z + r;
      const float m = cs_message<S>(mag[c], word[c], info.w, sstep);
      acc = acc + __ldg(w + p * z + r) * m;
    }
    post[v] = store<Post>(acc, 1.f);
  }
}

// check_update's flooding form (kFoldNone) for min-sum on the compressed
// state, for check c = i*z + r of degree kDeg whose planes start at p0:
// its new state from the posterior, written over its old one (a flooding
// check reads only its own old messages), with the same arithmetic in the
// same order: the old message rebuilt from the state, the v2c through the
// message storage (as the TPU kernel stores and reloads it), the two
// minima and the signs. One posterior load an edge, a state load and store
// a check, no posterior store. The slots are unrolled to the degree, so
// no slot is guarded. S: the word. flood_slots is the pass over the slots
// from the old state (os, ow), into min1, min2, idx and negs (kBig, kBig,
// -1 and 0 before it); flood_finish writes the new state. The wide word's
// check pass calls them apart, the slots in a body of the row's degree and
// one flood_finish after it (one copy of its quantization a kernel).
template <int kDeg, bool kW, int kT, typename S>
__device__ __forceinline__ void flood_slots(
    const FloodPlan& fp, const MagPair<typename Storage<kT>::Msg>& os,
    unsigned ow, const typename Storage<kT>::Post* post,
    const float* __restrict__ w, int z, int r, int p0, const Rule& u,
    float& min1, float& min2, int& idx, unsigned& negs) {
  using Msg = typename Storage<kT>::Msg;
  static_assert(kDeg <= S::kMaxDeg, "more slots than the word's");
  const int oslot = static_cast<int>(ow >> S::kIdxShift);
#pragma unroll
  for (int e = 0; e < kDeg; ++e) {
    const int4 pl = fp.plane[p0 + e];
    int q = r + pl.y;
    if (q >= z) q -= z;
    float m =
        signed_lift(e == oslot ? os.m2 : os.m1, (ow >> e) & 1u, u.sstep);
    if constexpr (kW) m = __ldg(w + (p0 + e) * z + r) * m;
    const float v =
        lift(store<Msg>(lift(post[pl.x + q], 1.f) - m, u.sinv), u.sstep);
    negs |= (v < 0.f ? 1u : 0u) << e;
    // the two minima without a branch: strict, so idx is the first
    // minimum, as argmin; the minima are magnitudes, never -0
    const float a = fabsf(v);
    const bool first = a < min1;
    min2 = first ? min1 : fminf(min2, a);
    min1 = first ? a : min1;
    idx = first ? e : idx;
  }
}

template <bool kQuant, int kT, typename S>
__device__ __forceinline__ void flood_finish(
    MagPair<typename Storage<kT>::Msg>* mag, typename S::Word* word, int c,
    float min1, float min2, int idx, unsigned negs, const Rule& u) {
  using Msg = typename Storage<kT>::Msg;
  float t1, t2;
  word[c] = static_cast<typename S::Word>(
      cs_finish<kQuant, S>(min1, min2, idx, negs, u, t1, t2));
  mag[c] = MagPair<Msg>{store<Msg>(t1, u.sinv), store<Msg>(t2, u.sinv)};
}

template <int kDeg, bool kQuant, bool kW, int kT, typename S = CsNarrow>
__device__ __forceinline__ void flood_check(
    const FloodPlan& fp, MagPair<typename Storage<kT>::Msg>* mag,
    typename S::Word* word, const typename Storage<kT>::Post* post,
    const float* __restrict__ w, int z, int c, int r, int p0,
    const Rule& u) {
  using Msg = typename Storage<kT>::Msg;
  const MagPair<Msg> os = mag[c];
  const unsigned ow = word[c];
  float min1 = kBig, min2 = kBig;
  int idx = -1;
  unsigned negs = 0;
  flood_slots<kDeg, kW, kT, S>(fp, os, ow, post, w, z, r, p0, u, min1, min2,
                               idx, negs);
  flood_finish<kQuant, kT, S>(mag, word, c, min1, min2, idx, negs, u);
}

// flood_check at the check's degree deg (at most kDeg): one uniform
// comparison a degree, from kDeg down.
template <int kDeg, bool kQuant, bool kW, int kT>
__device__ __forceinline__ void flood_check_deg(
    int deg, const FloodPlan& fp, MagPair<typename Storage<kT>::Msg>* mag,
    uint16_t* word, const typename Storage<kT>::Post* post,
    const float* __restrict__ w, int z, int c, int r, int p0,
    const Rule& u) {
  if constexpr (kDeg > 1) {
    if (deg != kDeg) {
      flood_check_deg<kDeg - 1, kQuant, kW, kT>(deg, fp, mag, word, post, w,
                                                z, c, r, p0, u);
      return;
    }
  }
  flood_check<kDeg, kQuant, kW, kT>(fp, mag, word, post, w, z, c, r, p0, u);
}

// The flooding check pass on the compressed state. Warps walk (block row,
// 32 checks), so each plane read from the parameter is warp-uniform, and
// so is the degree: the narrow word's bodies of degrees 8 down to 1
// (flood_check_deg), the wide word's of the degrees of CwDegrees.
template <bool kQuant, bool kW, int kT, typename S = CsNarrow>
__device__ __forceinline__ void flood_checks_cs(
    const FloodPlan& fp, MagPair<typename Storage<kT>::Msg>* mag,
    typename S::Word* word, const typename Storage<kT>::Post* post,
    const float* __restrict__ w, int z, int mb, WarpWalk wk,
    const Rule& u) {
  for (; wk.b < mb; wk.next()) {
    const int r = wk.at();
    if (r >= z) continue;
    const int p0 = fp.row_ptr[wk.b], deg = fp.row_ptr[wk.b + 1] - p0;
    const int c = wk.b * z + r;
    if constexpr (S::kIsWide) {
      const MagPair<typename Storage<kT>::Msg> os = mag[c];
      const unsigned ow = word[c];
      float min1 = kBig, min2 = kBig;
      int idx = -1;
      unsigned negs = 0;
      by_degree(CwDegrees{}, deg, [&](auto d) {
        flood_slots<decltype(d)::value, kW, kT, S>(
            fp, os, ow, post, w, z, r, p0, u, min1, min2, idx, negs);
      });
      flood_finish<kQuant, kT, S>(mag, word, c, min1, min2, idx, negs, u);
    } else {
      flood_check_deg<kCsMaxDeg, kQuant, kW, kT>(deg, fp, mag, word, post, w,
                                                 z, c, r, p0, u);
    }
  }
}

// Edge cp of a column (FloodPlan::col) added to the posterior sum acc of
// its variable j*z+q: the message of check row*z + (q - shift mod z) at
// its slot, times its weight (kW).
template <bool kW, typename S, typename Msg>
__device__ __forceinline__ float flood_add(float acc, const int4& cp,
                                           const MagPair<Msg>* mag,
                                           const typename S::Word* word,
                                           const float* __restrict__ w, int z,
                                           int q, float sstep) {
  int r = q - cp.y;
  if (r < 0) r += z;
  const int c = cp.x + r;
  const unsigned wd = word[c];
  // cp.z: the slot's sign bit, and the slot in the index field's place
  const bool second =
      ((wd ^ static_cast<unsigned>(cp.z)) & S::kIdxMask) == 0;
  const MagPair<Msg> s = mag[c];
  const float m = signed_lift(second ? s.m2 : s.m1,
                              (wd & static_cast<unsigned>(cp.z) &
                               S::kSignMask) != 0, sstep);
  return acc + (kW ? __ldg(w + cp.w * z + r) * m : m);
}

// The posterior of variable j*z+q rebuilt from the compressed state: (wl*)
// LLR + the sum of its (w*) messages in check-sorted order, in f32 and
// stored once. The LLR as the posterior's storage holds it: from lv in
// shared memory (kLlrShared), else rounded from l. The column's entries go
// two at a time (columns have 2-12).
template <bool kW, bool kLlrShared, int kT, typename S = CsNarrow>
__device__ __forceinline__ void flood_variable_cs(
    const FloodPlan& fp, const MagPair<typename Storage<kT>::Msg>* mag,
    const typename S::Word* word, typename Storage<kT>::Post* post,
    const typename Storage<kT>::Post* lv, const float* l,
    const float* __restrict__ w, const float* __restrict__ wl, int z, int j,
    int q, float sstep) {
  using Post = typename Storage<kT>::Post;
  const int v = j * z + q;
  float acc = kLlrShared ? lift(lv[v], 1.f) : round_post<Post>(-l[v]);
  if constexpr (kW) acc = __ldg(wl + v) * acc;
  const int e1 = fp.col_ptr[j + 1];
  int e = fp.col_ptr[j];
  for (; e + 1 < e1; e += 2) {
    acc = flood_add<kW, S>(acc, fp.col[e], mag, word, w, z, q, sstep);
    acc = flood_add<kW, S>(acc, fp.col[e + 1], mag, word, w, z, q, sstep);
  }
  if (e < e1)
    acc = flood_add<kW, S>(acc, fp.col[e], mag, word, w, z, q, sstep);
  post[v] = store<Post>(acc, 1.f);
}

// The posterior rebuild on the compressed state (flooding, and the weighted
// _gs forms' re-base), warps walking (column block, 32 variables).
template <bool kW, bool kLlrShared, int kT, typename S = CsNarrow>
__device__ __forceinline__ void flood_rebuild_cs(
    const FloodPlan& fp, const MagPair<typename Storage<kT>::Msg>* mag,
    const typename S::Word* word, typename Storage<kT>::Post* post,
    const typename Storage<kT>::Post* lv, const float* l,
    const float* __restrict__ w, const float* __restrict__ wl, int z, int nb,
    WarpWalk wk, float sstep) {
  for (; wk.b < nb; wk.next()) {
    const int q = wk.at();
    if (q < z)
      flood_variable_cs<kW, kLlrShared, kT, S>(fp, mag, word, post, lv, l, w,
                                               wl, z, wk.b, q, sstep);
  }
}

// check_update_cs's group-serial form (the min-sum _gs kernels) for check
// c = i*z + r of degree kDeg whose planes start at p0: the same arithmetic
// in the same order, the slots unrolled to the degree (no slot guarded) and
// the two minima kept without a branch, as flood_check keeps them. Pass 1
// reads the state once and each slot's posterior once; pass 2 folds a
// private slot's change into the posterior at once, as store(pv + d), and
// writes a shared slot's d to its scratch row at its variable's offset;
// then the new state once. S: the word; on the wide word (the _gw kernels,
// up to 18 slots) pass 1 keeps no slot in registers, and pass 2 rebuilds
// each old message from the old state and reads each weight and private
// posterior again, the same values (no other check of the group writes
// them), so more warps share an SM.
template <int kDeg, bool kQuant, bool kW, int kT, typename S = CsNarrow>
__device__ __forceinline__ void gs_check_cs(
    const GroupPlan& gp, MagPair<typename Storage<kT>::Msg>* mag,
    typename S::Word* word, typename Storage<kT>::Post* post, float* delta,
    const float* __restrict__ w, int z, int c, int r, int p0,
    const Rule& u) {
  using Msg = typename Storage<kT>::Msg;
  using Post = typename Storage<kT>::Post;
  static_assert(kDeg <= S::kMaxDeg, "more slots than the word's");
  constexpr bool kReload = S::kIsWide;
  constexpr int kKept = kReload ? 1 : kDeg;  // the slots pass 1 keeps
  const MagPair<Msg> os = mag[c];
  const unsigned ow = word[c];
  float pv[kKept], old[kKept], wv[kW ? kKept : 1];
  float min1 = kBig, min2 = kBig;
  int idx = -1;
  unsigned negs = 0;  // bit e: the v2c of slot e is < 0
#pragma unroll
  for (int e = 0; e < kDeg; ++e) {
    const int4 pl = gp.plane[p0 + e];
    int q = r + pl.y;
    if (q >= z) q -= z;
    float v;
    if constexpr (kReload) {
      float m = cs_message<S>(os, ow, e, u.sstep);
      if constexpr (kW) m = __ldg(w + (p0 + e) * z + r) * m;
      v = lift(post[pl.x + q], 1.f) - m;
    } else {
      old[e] = cs_message<S>(os, ow, e, u.sstep);
      float m = old[e];
      if constexpr (kW) {
        wv[e] = __ldg(w + (p0 + e) * z + r);
        m = wv[e] * m;
      }
      pv[e] = lift(post[pl.x + q], 1.f);
      v = pv[e] - m;
    }
    negs |= (v < 0.f ? 1u : 0u) << e;
    // strict, so idx is the first minimum, as argmin
    const float a = fabsf(v);
    const bool first = a < min1;
    min2 = first ? min1 : fminf(min2, a);
    min1 = first ? a : min1;
    idx = first ? e : idx;
  }
  float t1, t2;
  const unsigned nw = cs_finish<kQuant, S>(min1, min2, idx, negs, u, t1, t2);
  const MagPair<Msg> ns{store<Msg>(t1, u.sinv), store<Msg>(t2, u.sinv)};
#pragma unroll
  for (int e = 0; e < kDeg; ++e) {
    // int8 folds what the stored message changes by; bf16 the unrounded
    // change, as the TPU kernel does
    float y;
    if constexpr (kT == kInt8) {
      y = cs_message<S>(ns, nw, e, u.sstep);
    } else {
      const float t = e == static_cast<int>(nw >> S::kIdxShift) ? t2 : t1;
      y = (nw >> e) & 1u ? -t : t;
    }
    float d;
    if constexpr (kReload) {
      d = y - cs_message<S>(os, ow, e, u.sstep);
      if constexpr (kW) d = __ldg(w + (p0 + e) * z + r) * d;
    } else {
      d = y - old[e];
      if constexpr (kW) d = wv[e] * d;
    }
    const int4 pl = gp.plane[p0 + e];
    int q = r + pl.y;
    if (q >= z) q -= z;
    const int sc = gp.scratch[p0 + e];
    if (sc >= 0) {
      delta[sc + q] = d;
    } else if constexpr (kReload) {
      post[pl.x + q] = store<Post>(lift(post[pl.x + q], 1.f) + d, 1.f);
    } else {
      post[pl.x + q] = store<Post>(pv[e] + d, 1.f);
    }
  }
  mag[c] = ns;
  word[c] = static_cast<typename S::Word>(nw);
}

// gs_check_cs at the check's degree deg (at most kDeg): one uniform
// comparison a degree, from kDeg down.
template <int kDeg, bool kQuant, bool kW, int kT>
__device__ __forceinline__ void gs_check_cs_deg(
    int deg, const GroupPlan& gp, MagPair<typename Storage<kT>::Msg>* mag,
    uint16_t* word, typename Storage<kT>::Post* post, float* delta,
    const float* __restrict__ w, int z, int c, int r, int p0,
    const Rule& u) {
  if constexpr (kDeg > 1) {
    if (deg != kDeg) {
      gs_check_cs_deg<kDeg - 1, kQuant, kW, kT>(deg, gp, mag, word, post,
                                                delta, w, z, c, r, p0, u);
      return;
    }
  }
  gs_check_cs<kDeg, kQuant, kW, kT>(gp, mag, word, post, delta, w, z, c, r,
                                    p0, u);
}

// The per-iteration arguments of `iterate`: the (alpha, beta) rule and,
// for the weighted forms, the weight rows of this iteration (w) and of the
// next (w_next, wl_next: the final rows after the last iteration).
struct Step {
  Rule u;
  const float* w;
  const float* w_next;
  const float* wl_next;
};

// ---- Sum-product with a check's slots in registers (the _sr kernels) ----
//
// The full messages, with the plan in the kernel parameter (FloodPlan, both
// schedules), a check's slots unrolled to its degree and its values in
// registers (the header says why and what it costs).

// Sum-product check r of the block row whose kDeg planes start at p0, the
// arithmetic of check_update in its order. Pass 1 reads each slot's stored
// message and posterior once and keeps them, its v2c and (kW) its weight
// in registers, with the v2c's sign as a bit of negs; then each slot's lt,
// two slots a call, and the row sum left to right. Pass 2 reads no shared
// memory: each magnitude from the registers, two slots a call, then each
// message is stored and, layered, the posterior as store(pv + (w*)
// (y - old)). Flooding passes each v2c through the message storage, as the
// TPU kernel stores and reloads it, and writes no posterior. Within a block
// row the checks touch disjoint variables and a check's slots distinct
// column blocks, so the posterior pass 2 would read again is the pv of pass
// 1, and a flooding check writes its new messages over its old ones.
// kFold: kFoldNone (flooding), kFoldPost (serial-C) or kFoldGroup (the _gs
// kernels: a shared slot writes its change to its scratch row in delta,
// at its variable's offset, and a private one folds it at once).
// kReload (the bodies of the wide rows, up to 18 slots): pass 1 keeps only
// the v2c in registers, and pass 2 reads each slot's old message,
// posterior and weight again, the same values (nothing else writes them
// between the passes), as the full-message kernel does; three registers a
// slot fewer, so more warps share an SM.
template <int kDeg, int kFold, bool kQuant, bool kW, int kT,
          bool kReload = false>
__device__ __forceinline__ void sp_check(
    const FloodPlan& fp, typename Storage<kT>::Msg* msg,
    typename Storage<kT>::Post* post, float* delta, const int* scratch,
    const float* __restrict__ w, int z, int r, int p0, const Rule& u) {
  using Msg = typename Storage<kT>::Msg;
  using Post = typename Storage<kT>::Post;
  constexpr int kKept = kReload ? 1 : kDeg;  // the slots pass 1 keeps
  float pv[kKept], old[kKept], x[kDeg], wv[kW ? kKept : 1];
  unsigned negs = 0;  // bit e: the v2c of slot e is < 0
  const int m0 = p0 * z + r;  // slot e's message and weight: m0 + e*z
#pragma unroll
  for (int e = 0; e < kDeg; ++e) {
    const int4 pl = fp.plane[p0 + e];
    int q = r + pl.y;
    if (q >= z) q -= z;
    if constexpr (kReload) {
      float m = lift(msg[m0 + e * z], u.sstep);
      if constexpr (kW) m = __ldg(w + m0 + e * z) * m;
      x[e] = lift(post[pl.x + q], 1.f) - m;
    } else {
      old[e] = lift(msg[m0 + e * z], u.sstep);
      float m = old[e];
      if constexpr (kW) {
        wv[e] = __ldg(w + m0 + e * z);
        m = wv[e] * m;
      }
      pv[e] = lift(post[pl.x + q], 1.f);
      x[e] = pv[e] - m;
    }
    float v = x[e];
    if constexpr (kFold == kFoldNone)
      v = lift(store<Msg>(v, u.sinv), u.sstep);
    negs |= (v < 0.f ? 1u : 0u) << e;
    x[e] = v;
  }
  // x: the v2c, then each slot's lt, then its magnitude
#pragma unroll
  for (int e = 0; e + 1 < kDeg; e += 2) {
    const float2 t = sp_lt2(x[e], x[e + 1]);
    x[e] = t.x;
    x[e + 1] = t.y;
  }
  if constexpr (kDeg % 2 == 1) x[kDeg - 1] = sp_lt1(x[kDeg - 1]);
  float total = 0.f;
#pragma unroll
  for (int e = 0; e < kDeg; ++e) total = total + x[e];
#pragma unroll
  for (int e = 0; e + 1 < kDeg; e += 2) {
    const float2 t = sp_mag2(fminf(total - x[e], -1e-12f),
                             fminf(total - x[e + 1], -1e-12f));
    x[e] = t.x;
    x[e + 1] = t.y;
  }
  if constexpr (kDeg % 2 == 1)
    x[kDeg - 1] = sp_mag1(fminf(total - x[kDeg - 1], -1e-12f));
  // the exclusive sign of slot e: the parity of the other slots' negatives
  const unsigned odd = static_cast<unsigned>(__popc(negs)) & 1u;
#pragma unroll
  for (int e = 0; e < kDeg; ++e) {
    const float sgn = (((negs >> e) & 1u) ^ odd) ? -1.f : 1.f;
    float y = postlude<kQuant>(sgn * x[e], u);
    const Msg stored = store<Msg>(y, u.sinv);
    float o = 0.f;  // kReload: the slot's old message, read before the store
    if constexpr (kReload && kFold != kFoldNone)
      o = lift(msg[m0 + e * z], u.sstep);
    msg[m0 + e * z] = stored;
    if constexpr (kFold != kFoldNone) {
      // int8 folds what the stored message changes by; bf16 the unrounded
      // change, as the TPU kernel does
      if constexpr (kT == kInt8) y = lift(stored, u.sstep);
      float d;
      if constexpr (kReload) {
        d = y - o;
        if constexpr (kW) d = __ldg(w + m0 + e * z) * d;
      } else {
        d = y - old[e];
        if constexpr (kW) d = wv[e] * d;
      }
      const int4 pl = fp.plane[p0 + e];
      int q = r + pl.y;
      if (q >= z) q -= z;
      if (kFold == kFoldGroup && scratch[p0 + e] >= 0) {
        delta[scratch[p0 + e] + q] = d;
      } else if constexpr (kReload) {
        post[pl.x + q] = store<Post>(lift(post[pl.x + q], 1.f) + d, 1.f);
      } else {
        post[pl.x + q] = store<Post>(pv[e] + d, 1.f);
      }
    }
  }
}

// sp_check at the check's degree deg (at most kDeg): one uniform
// comparison a degree, from kDeg down.
template <int kDeg, int kFold, bool kQuant, bool kW, int kT>
__device__ __forceinline__ void sp_check_deg(
    int deg, const FloodPlan& fp, typename Storage<kT>::Msg* msg,
    typename Storage<kT>::Post* post, float* delta, const int* scratch,
    const float* __restrict__ w, int z, int r, int p0, const Rule& u) {
  if constexpr (kDeg > 1) {
    if (deg != kDeg) {
      sp_check_deg<kDeg - 1, kFold, kQuant, kW, kT>(deg, fp, msg, post,
                                                    delta, scratch, w, z, r,
                                                    p0, u);
      return;
    }
  }
  sp_check<kDeg, kFold, kQuant, kW, kT>(fp, msg, post, delta, scratch, w, z,
                                        r, p0, u);
}

// The posterior rebuilt from the full messages, warps walking (column
// block, 32 variables): (wl*) LLR + the sum of the (w*) c2v messages of
// each variable in check-sorted order, in f32 and stored once, no
// atomics. The LLR as the posterior's storage holds it: from lv in shared
// memory (kLlrShared), else rounded from l.
template <bool kW, bool kLlrShared, int kT>
__device__ __forceinline__ void rebuild_sr(
    const FloodPlan& fp, const typename Storage<kT>::Msg* msg,
    typename Storage<kT>::Post* post, const typename Storage<kT>::Post* lv,
    const float* l, const float* __restrict__ w,
    const float* __restrict__ wl, int z, int nb, WarpWalk wk, float sstep) {
  using Post = typename Storage<kT>::Post;
  for (; wk.b < nb; wk.next()) {
    const int q = wk.at();
    if (q >= z) continue;
    const int v = wk.b * z + q;
    float acc = kLlrShared ? lift(lv[v], 1.f) : round_post<Post>(-l[v]);
    if constexpr (kW) acc = __ldg(wl + v) * acc;
    for (int e = fp.col_ptr[wk.b]; e < fp.col_ptr[wk.b + 1]; ++e) {
      const int4 cp = fp.col[e];
      int r = q - cp.y;
      if (r < 0) r += z;
      const int m = cp.w * z + r;  // plane cp.w's message of check r
      const float x = lift(msg[m], sstep);
      acc = acc + (kW ? __ldg(w + m) * x : x);
    }
    post[v] = store<Post>(acc, 1.f);
  }
}

// One sum-product iteration on the _sr kernels: the serial-C sweep, one
// thread per check of a block row and a barrier a row (the weighted form
// then rebuilds the posterior with the next row of weights), or the
// flooding check pass with warps walking (block row, 32 checks), then the
// rebuild. kWide: the _rw kernels (serial-C), a check's slots unrolled to
// its row's degree in the bodies of CwDegrees, one dispatch a block row
// (uniform for the CTA). Ends with __syncthreads().
template <bool kLayered, bool kQuant, bool kW, bool kLlrShared, int kT,
          bool kWide = false>
__device__ __forceinline__ void iterate_sr(
    const FloodPlan& fp, typename Storage<kT>::Msg* msg,
    typename Storage<kT>::Post* post, const typename Storage<kT>::Post* lv,
    const float* l, int z, int mb, int nb, WarpWalk wk, const Step& st) {
  static_assert(kLayered || !kWide, "the _rw kernels are serial-C");
  if constexpr (kLayered) {
    for (int i = 0; i < mb; ++i) {
      const int p0 = fp.row_ptr[i], deg = fp.row_ptr[i + 1] - p0;
      if constexpr (kWide) {
        by_degree(CwDegrees{}, deg, [&](auto d) {
          for (int r = threadIdx.x; r < z; r += blockDim.x)
            sp_check<decltype(d)::value, kFoldPost, kQuant, kW, kT, true>(
                fp, msg, post, nullptr, nullptr, st.w, z, r, p0, st.u);
        });
      } else {
        for (int r = threadIdx.x; r < z; r += blockDim.x)
          sp_check_deg<kCsMaxDeg, kFoldPost, kQuant, kW, kT>(
              deg, fp, msg, post, nullptr, nullptr, st.w, z, r, p0, st.u);
      }
      __syncthreads();
    }
    if constexpr (!kW) return;
  } else {
    for (WarpWalk c = wk; c.b < mb; c.next()) {
      const int r = c.at();
      if (r >= z) continue;
      const int p0 = fp.row_ptr[c.b];
      sp_check_deg<kCsMaxDeg, kFoldNone, kQuant, kW, kT>(
          fp.row_ptr[c.b + 1] - p0, fp, msg, post, nullptr, nullptr, st.w, z,
          r, p0, st.u);
    }
    __syncthreads();
  }
  rebuild_sr<kW, kLlrShared, kT>(fp, msg, post, lv, l, st.w_next, st.wl_next,
                                 z, nb, wk, st.u.sstep);
  __syncthreads();
}

// One group-serial iteration on the _gs kernels, for each group of `group`
// block rows (the last one possibly shorter): the check pass, warps walking
// (block row of the group, 32 checks), a private slot's change folded into
// the posterior at once and a shared slot's kept in delta; a barrier; the
// fold pass, warps walking (fold entry, 32 variables) over the group's
// shared column blocks alone, each variable adding its changes in block-row
// order and rounding to the posterior's storage after each; a barrier (none
// where the group has no shared column block: its checks folded all their
// changes). The weighted forms then rebuild the posterior with the next
// iteration's weights. kCsState: min-sum on the compressed check state
// (mag, word), else sum-product on the full messages (msg). kWide: the _gw
// kernels, a check's slots unrolled to its row's degree in the bodies of
// CwDegrees (one dispatch a warp's task), min-sum on the wide word. Ends
// with __syncthreads().
template <bool kCsState, bool kQuant, bool kW, int kT, bool kWide = false>
__device__ __forceinline__ void iterate_gs(
    const GroupPlan& gp, typename Storage<kT>::Msg* msg,
    MagPair<typename Storage<kT>::Msg>* mag,
    typename CsState<kWide>::Word* word, typename Storage<kT>::Post* post,
    float* delta, const float* l, int z, int mb, int nb, int group,
    WarpWalk wk, const Step& st) {
  using Post = typename Storage<kT>::Post;
  using S = CsState<kWide>;
  for (int g = 0, g0 = 0; g0 < mb; ++g, g0 += group) {
    const int g1 = min(g0 + group, mb);
    WarpWalk c = wk;
    for (c.b += g0; c.b < g1; c.next()) {
      const int r = c.at();
      if (r >= z) continue;
      const int p0 = gp.row_ptr[c.b], deg = gp.row_ptr[c.b + 1] - p0;
      if constexpr (kWide) {
        by_degree(CwDegrees{}, deg, [&](auto d) {
          if constexpr (kCsState)
            gs_check_cs<decltype(d)::value, kQuant, kW, kT, S>(
                gp, mag, word, post, delta, st.w, z, c.b * z + r, r, p0,
                st.u);
          else
            sp_check<decltype(d)::value, kFoldGroup, kQuant, kW, kT, true>(
                gp, msg, post, delta, gp.scratch, st.w, z, r, p0, st.u);
        });
      } else if constexpr (kCsState) {
        gs_check_cs_deg<kCsMaxDeg, kQuant, kW, kT>(
            deg, gp, mag, word, post, delta, st.w, z, c.b * z + r, r, p0,
            st.u);
      } else {
        sp_check_deg<kCsMaxDeg, kFoldGroup, kQuant, kW, kT>(
            deg, gp, msg, post, delta, gp.scratch, st.w, z, r, p0, st.u);
      }
    }
    __syncthreads();
    const int f0 = gp.fold_ptr[g], f1 = gp.fold_ptr[g + 1];
    if (f0 == f1) continue;  // uniform: the group's value
    WarpWalk f = wk;
    for (f.b += f0; f.b < f1; f.next()) {
      const int q = f.at();
      if (q >= z) continue;
      // the entry's changes of variable col*z + q, by block row: scratch
      // rows fe.y/z .. fe.y/z + fe.z - 1, loaded two at a time
      const int4 fe = gp.fold[f.b];
      const float* dq = delta + fe.y + q;
      float acc = lift(post[fe.x + q], 1.f);
      int k = 0;
      for (; k + 1 < fe.z; k += 2) {
        const float d0 = dq[k * z], d1 = dq[(k + 1) * z];
        acc = round_post<Post>(acc + d0);
        acc = round_post<Post>(acc + d1);
      }
      if (k < fe.z) acc = round_post<Post>(acc + dq[k * z]);
      post[fe.x + q] = store<Post>(acc, 1.f);
    }
    __syncthreads();
  }
  if constexpr (kW) {
    if constexpr (kCsState)
      flood_rebuild_cs<true, false, kT, S>(gp, mag, word, post, nullptr, l,
                                           st.w_next, st.wl_next, z, nb, wk,
                                           st.u.sstep);
    else
      rebuild_sr<true, false, kT>(gp, msg, post, nullptr, l, st.w_next,
                                  st.wl_next, z, nb, wk, st.u.sstep);
    __syncthreads();
  }
}

// One iteration: the serial-C sweep over the mb block rows (layered,
// group = 1), the group-serial sweep (layered, group > 1), or all checks
// from the posterior and then the posterior rebuilt (flooding). The
// weighted layered forms then rebuild the posterior with the next
// iteration's weights. Ends with __syncthreads(), so the posterior is
// complete on return. delta: the group's scratch (group > 1 only).
template <int kMethod, bool kLayered, bool kQuant, bool kW, int kT>
__device__ __forceinline__ void iterate(const Plan& pl,
                                        typename Storage<kT>::Msg* msg,
                                        typename Storage<kT>::Post* post,
                                        float* delta, const float* l, int z,
                                        int mb, int n, int group,
                                        const Step& st) {
  using Post = typename Storage<kT>::Post;
  if (kLayered) {
    if (group == 1) {
      for (int i = 0; i < mb; ++i) {
        for (int r = threadIdx.x; r < z; r += blockDim.x)
          check_update<kMethod, kFoldPost, kQuant, kW, kT>(
              pl, msg, post, nullptr, st.w, z, i, r, st.u);
        __syncthreads();
      }
    } else {
      // The checks of a group read the posterior as it stood before the
      // group, so their changes wait in `delta` (plane p at scratch row
      // p - P0); then each variable adds its column's changes from the
      // group in block-row order, re-rounding to its storage after each.
      // A thread folds variables tid + k*blockDim (column block j, offset
      // q), stepping (j, q) without a division.
      const int nb = n / z, dj = blockDim.x / z, dq = blockDim.x % z;
      for (int g0 = 0; g0 < mb; g0 += group) {
        const int g1 = min(g0 + group, mb);
        const int P0 = pl.row_ptr[g0], P1 = pl.row_ptr[g1];
        for (int c = threadIdx.x; c < (g1 - g0) * z; c += blockDim.x) {
          const int i = g0 + c / z;
          check_update<kMethod, kFoldDelta, kQuant, kW, kT>(
              pl, msg, post, delta + (pl.row_ptr[i] - P0) * z, st.w, z, i,
              c % z, st.u);
        }
        __syncthreads();
        for (int j = threadIdx.x / z, q = threadIdx.x % z; j < nb;
             j += dj + (q + dq >= z), q += dq - (q + dq >= z ? z : 0)) {
          float acc = lift(post[j * z + q], 1.f);
          bool hit = false;
          // a column's planes are listed by block row, so by plane id
          for (int e = pl.col_ptr[j]; e < pl.col_ptr[j + 1]; ++e) {
            const int p = pl.col_planes[e];
            if (p < P0) continue;
            if (p >= P1) break;
            int r = q - pl.plane_shift[p];
            if (r < 0) r += z;
            acc = round_post<Post>(acc + delta[(p - P0) * z + r]);
            hit = true;
          }
          if (hit) post[j * z + q] = store<Post>(acc, 1.f);
        }
        __syncthreads();
      }
    }
    if constexpr (kW) {
      rebuild<true, kT>(pl, msg, post, l, st.w_next, st.wl_next, z, n,
                        st.u.sstep);
      __syncthreads();
    }
  } else {
    for (int c = threadIdx.x; c < mb * z; c += blockDim.x)
      check_update<kMethod, kFoldNone, kQuant, kW, kT>(
          pl, msg, post, nullptr, st.w, z, c / z, c % z, st.u);
    __syncthreads();
    rebuild<kW, kT>(pl, msg, post, l, st.w_next, st.wl_next, z, n,
                    st.u.sstep);
    __syncthreads();
  }
}

// `iterate` for the serial-C min-sum forms on the compressed state: the
// same sweep, folds and barriers. S: the word; the wide word's checks are
// unrolled to their block row's degree (uniform for the CTA).
template <bool kQuant, bool kW, int kT, typename S = CsNarrow>
__device__ __forceinline__ void iterate_cs(
    const Plan& pl, const ParamPlan& pp,
    MagPair<typename Storage<kT>::Msg>* mag, typename S::Word* word,
    typename Storage<kT>::Post* post, const float* l, int z, int mb, int n,
    const Step& st) {
  for (int i = 0; i < mb; ++i) {
    if constexpr (S::kIsWide) {
      by_degree(CwDegrees{}, pp.row_ptr[i + 1] - pp.row_ptr[i], [&](auto d) {
        for (int r = threadIdx.x; r < z; r += blockDim.x)
          check_update_cs<kQuant, kW, kT, S, decltype(d)::value>(
              pp, mag, word, post, st.w, z, i, r, st.u);
      });
    } else {
      for (int r = threadIdx.x; r < z; r += blockDim.x)
        check_update_cs<kQuant, kW, kT>(pp, mag, word, post, st.w, z, i, r,
                                        st.u);
    }
    __syncthreads();
  }
  if constexpr (kW) {
    rebuild_cs<kT, S>(pl, pp, mag, word, post, l, st.w_next, st.wl_next, z,
                      n, st.u.sstep);
    __syncthreads();
  }
}

// This thread's count of unsatisfied checks (its checks c = tid + k*blockDim)
// for the hard decisions of the posterior (bit 1 where post < 0).
template <typename Post>
__device__ __forceinline__ int local_unsat(const Plan& pl, const Post* post,
                                           int z, int mb) {
  int count = 0;
  for (int c = threadIdx.x; c < mb * z; c += blockDim.x) {
    const int i = c / z, r = c % z;
    int parity = 0;
    for (int p = pl.row_ptr[i]; p < pl.row_ptr[i + 1]; ++p) {
      int q = r + pl.plane_shift[p];
      if (q >= z) q -= z;
      parity ^= lift(post[pl.plane_col[p] * z + q], 1.f) < 0.f ? 1 : 0;
    }
    count += parity;
  }
  return count;
}

// local_unsat of the compressed flooding forms and the _sr forms: this
// thread's checks of the warps' walk over (block row, 32 checks), the plan
// from the parameter.
template <typename Post>
__device__ __forceinline__ int local_unsat_cs(const FloodPlan& fp,
                                              const Post* post, int z, int mb,
                                              WarpWalk wk) {
  int count = 0;
  for (; wk.b < mb; wk.next()) {
    const int r = wk.at();
    if (r >= z) continue;
    int parity = 0;
    for (int p = fp.row_ptr[wk.b]; p < fp.row_ptr[wk.b + 1]; ++p) {
      const int4 pl = fp.plane[p];
      int q = r + pl.y;
      if (q >= z) q -= z;
      parity ^= lift(post[pl.x + q], 1.f) < 0.f ? 1 : 0;
    }
    count += parity;
  }
  return count;
}

// aux_out: the iterations run (kEarlyStop), else the unsatisfied-check
// count when not null. done_in: codewords to skip, when not null. wm, wl:
// the weight tables (kW: iterations+1 rows of P*z and of n floats).
// group: block rows per group of the layered schedule. sstep, sinv: the
// int8 storage grid's step and its reciprocal (kT = kInt8).
// kCs: the min-sum forms on the compressed check state: serial-C with the
// sweep's plan read from pp, flooding with its plan read from fp (each the
// kernel's parameter). kSr: the sum-product forms with a check's slots in
// registers, both schedules with their plan read from fp. kGs: the
// group-serial forms (layered, group > 1) with their plan read from gp (and
// fp, the same parameter): min-sum on the compressed state (kCs),
// sum-product on full messages. Else the full messages, and the three are
// unused. kWide: the wide rows (degree 8-18, the bodies of CwDegrees):
// min-sum on the compressed state's wide word, serial-C and flooding (the
// _cw kernels) and group-serial (the _gw kernels), and sum-product with a
// check's slots in registers, serial-C (the _rw kernels) and group-serial
// (the _gw kernels).
template <int kMethod, bool kLayered, bool kEarlyStop, bool kQuant, bool kW,
          int kT, bool kCs = false, bool kSr = false, bool kGs = false,
          bool kWide = false>
__device__ __forceinline__ void decode(
    const float* __restrict__ llr, float* __restrict__ post_out,
    int8_t* __restrict__ bits_out, const int* __restrict__ done_in,
    int* __restrict__ aux_out, const int* __restrict__ plan_g,
    const float* __restrict__ ab, const float* __restrict__ wm,
    const float* __restrict__ wl, int z, int mb, int nb, int P,
    int iterations, int check_every, int group, float clamp, float qstep,
    float qclip, float sstep, float sinv, const ParamPlan* pp,
    const FloodPlan* fp, const GroupPlan* gp) {
  static_assert(!kCs || kMethod == kMinSum,
                "the compressed state is the min-sum forms'");
  static_assert(!kSr || (kMethod == kSumProduct && !kCs),
                "the _sr kernels are the sum-product forms'");
  static_assert(!kGs || (kLayered && !kSr && kCs == (kMethod == kMinSum)),
                "the _gs kernels are the group-serial layered forms', "
                "min-sum on the compressed state");
  static_assert(!kWide || kCs || kSr || kGs,
                "the wide rows' kernels read their plan from the parameter");
  using S = CsState<kWide>;
  using Word = typename S::Word;
  // flooding on the compressed state: no plan in shared memory
  constexpr bool kFloodCs = kCs && !kLayered;
  // the plan from the parameter alone (fp, gp), none in shared memory
  constexpr bool kParamPlan = kFloodCs || kSr || kGs;
  // the LLRs in shared memory, as the posterior holds them
  constexpr bool kLlrShared =
      kFloodCs || (kSr && !kLayered && kSrFloodLlrShared);
  using Msg = typename Storage<kT>::Msg;
  using Post = typename Storage<kT>::Post;
  // the flag is the same for the whole CTA, so the return is uniform
  if (done_in != nullptr && done_in[blockIdx.x] != 0) return;
  extern __shared__ float4 smem_f4[];
  __shared__ int unsat_sum;
  // regions on 16-byte boundaries, each of its own type (smem_bytes)
  char* smem = reinterpret_cast<char*>(smem_f4);
  const int n = nb * z;
  int* plan = reinterpret_cast<int*>(smem);
  int off = kParamPlan ? 0 : 4 * plan_ints_padded(mb, nb, P);
  // the full messages, or the compressed state: a magnitude pair and a
  // word per check
  Msg* msg = reinterpret_cast<Msg*>(smem + off);
  MagPair<Msg>* mag = reinterpret_cast<MagPair<Msg>*>(smem + off);
  Word* word = nullptr;
  if constexpr (kCs) {
    off += align16(mb * z * static_cast<int>(sizeof(MagPair<Msg>)));
    word = reinterpret_cast<Word*>(smem + off);
    off += align16(mb * z * static_cast<int>(sizeof(Word)));
  } else {
    off += align16(P * z * static_cast<int>(sizeof(Msg)));
  }
  Post* post = reinterpret_cast<Post*>(smem + off);
  off += align16(n * static_cast<int>(sizeof(Post)));
  // the LLRs as the posterior holds them (kLlrShared)
  Post* lv = reinterpret_cast<Post*>(smem + off);
  float* delta = reinterpret_cast<float*>(smem + off);  // group > 1 only
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  const float* l = llr + base;

  if constexpr (!kParamPlan) {
    const int n_plan = plan_ints(mb, nb, P);
    for (int t = threadIdx.x; t < n_plan; t += blockDim.x)
      plan[t] = plan_g[t];
  }
  const WarpWalk walk = warp_walk(z);  // the kParamPlan forms'
  if constexpr (kCs) {
    for (int t = threadIdx.x; t < mb * z; t += blockDim.x) {
      mag[t] = MagPair<Msg>{store<Msg>(0.f, sinv), store<Msg>(0.f, sinv)};
      word[t] = 0;
    }
  } else {
    for (int t = threadIdx.x; t < P * z; t += blockDim.x)
      msg[t] = store<Msg>(0.f, sinv);
  }
  // internal convention log(Pr0/Pr1): the negated API LLR
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    if constexpr (!kW) post[t] = store<Post>(-l[t], 1.f);
    if constexpr (kLlrShared) lv[t] = store<Post>(-l[t], 1.f);
  }
  __syncthreads();
  const Plan pl{plan, plan + (mb + 1), plan + (mb + 1) + P,
                plan + (mb + 1) + 2 * P, plan + (mb + 1) + 2 * P + (nb + 1)};
  if constexpr (kW) {
    // the posterior of the zero messages under the first weight row
    if constexpr (kFloodCs || (kGs && kCs))
      flood_rebuild_cs<true, kLlrShared, kT, S>(*fp, mag, word, post, lv, l,
                                                wm, wl, z, nb, walk, sstep);
    else if constexpr (kCs)
      rebuild_cs<kT, S>(pl, *pp, mag, word, post, l, wm, wl, z, n, sstep);
    else if constexpr (kSr || kGs)
      rebuild_sr<true, kLlrShared, kT>(*fp, msg, post, lv, l, wm, wl, z, nb,
                                       walk, sstep);
    else
      rebuild<true, kT>(pl, msg, post, l, wm, wl, z, n, sstep);
    __syncthreads();
  }
  auto step = [&](int it) {
    const Rule u{ab[2 * it], ab[2 * it + 1], clamp, qstep, qclip, sstep,
                 sinv};
    if constexpr (kW) {
      const int64_t e = static_cast<int64_t>(P) * z;
      return Step{u, wm + it * e, wm + (it + 1) * e, wl + (it + 1) * n};
    } else {
      return Step{u, nullptr, nullptr, nullptr};
    }
  };

  auto one = [&](const Step& st) {
    if constexpr (kGs) {
      iterate_gs<kCs, kQuant, kW, kT, kWide>(*gp, msg, mag, word, post, delta,
                                             l, z, mb, nb, group, walk, st);
    } else if constexpr (kFloodCs) {
      flood_checks_cs<kQuant, kW, kT, S>(*fp, mag, word, post, st.w, z, mb,
                                         walk, st.u);
      __syncthreads();
      flood_rebuild_cs<kW, true, kT, S>(*fp, mag, word, post, lv, l,
                                        st.w_next, st.wl_next, z, nb, walk,
                                        st.u.sstep);
      __syncthreads();
    } else if constexpr (kCs) {
      iterate_cs<kQuant, kW, kT, S>(pl, *pp, mag, word, post, l, z, mb, n,
                                    st);
    } else if constexpr (kSr) {
      iterate_sr<kLayered, kQuant, kW, kLlrShared, kT, kWide>(
          *fp, msg, post, lv, l, z, mb, nb, walk, st);
    } else {
      iterate<kMethod, kLayered, kQuant, kW, kT>(pl, msg, post, delta, l, z,
                                                 mb, n, group, st);
    }
  };
  // this thread's count of unsatisfied checks
  auto unsat = [&]() {
    if constexpr (kParamPlan)
      return local_unsat_cs(*fp, post, z, mb, walk);
    else
      return local_unsat(pl, post, z, mb);
  };

  if (kEarlyStop) {
    int ran = iterations;
    // the vote returns the same value to every thread: `done` is uniform
    bool done = done_in == nullptr &&
                !__syncthreads_or(unsat() != 0);
    if (done) ran = 0;
    const int rounds = iterations / check_every;
    for (int r = 0; r < rounds && !done; ++r) {
      for (int k = 0; k < check_every; ++k)
        one(step(r * check_every + k));
      if (!__syncthreads_or(unsat() != 0)) {
        done = true;
        ran = (r + 1) * check_every;
      }
    }
    if (threadIdx.x == 0) aux_out[blockIdx.x] = ran;
  } else {
    for (int it = 0; it < iterations; ++it) one(step(it));
    if (aux_out != nullptr) {
      const int mine = unsat();
      if (threadIdx.x == 0) unsat_sum = 0;
      __syncthreads();
      if (mine != 0) atomicAdd(&unsat_sum, mine);
      __syncthreads();
      if (threadIdx.x == 0) aux_out[blockIdx.x] = unsat_sum;
    }
  }

  if (bits_out != nullptr) {
    for (int t = threadIdx.x; t < n; t += blockDim.x)
      bits_out[base + t] = lift(post[t], 1.f) < 0.f ? 1 : 0;
  } else {
    for (int t = threadIdx.x; t < n; t += blockDim.x)
      post_out[base + t] = -lift(post[t], 1.f);
  }
}

// This translation unit's storage type and the suffix of its entry points.
#if QC_STORAGE == 0
constexpr int kStorage = kF32;
#define QC_SUFFIX
#elif QC_STORAGE == 1
constexpr int kStorage = kBf16;
#define QC_SUFFIX _bf16
#elif QC_STORAGE == 2
constexpr int kStorage = kInt8;
#define QC_SUFFIX _i8
#else
#error "QC_STORAGE must be 0, 1 or 2"
#endif

}  // namespace

#define QC_CAT2(a, b) a##b
#define QC_CAT(a, b) QC_CAT2(a, b)
#define QC_KERNEL(name, method, layered, early_stop, quant, weighted)        \
  __global__ void QC_CAT(name, QC_SUFFIX)(                                  \
      const float* llr, float* post_out, int8_t* bits_out,                  \
      const int* done_in, int* aux_out, const int* plan, const float* ab,   \
      const float* wm, const float* wl, int z, int mb, int nb, int P,       \
      int iterations, int check_every, int group, float clamp, float qstep, \
      float qclip, float sstep, float sinv) {                               \
    decode<method, layered, early_stop, quant, weighted, kStorage>(         \
        llr, post_out, bits_out, done_in, aux_out, plan, ab, wm, wl, z, mb, \
        nb, P, iterations, check_every, group, clamp, qstep, qclip, sstep,  \
        sinv, nullptr, nullptr, nullptr);                                   \
  }
// The serial-C min-sum forms on the compressed state (entry point name_cs,
// or name_cw on the wide word): the same arguments and the sweep's plan as
// a parameter.
#define QC_KERNEL_CS(name, sfx, wide, early_stop, quant, weighted)          \
  __global__ void QC_CAT(QC_CAT(name, sfx), QC_SUFFIX)(                     \
      const float* llr, float* post_out, int8_t* bits_out,                  \
      const int* done_in, int* aux_out, const int* plan, const float* ab,   \
      const float* wm, const float* wl, int z, int mb, int nb, int P,       \
      int iterations, int check_every, int group, float clamp, float qstep, \
      float qclip, float sstep, float sinv,                                 \
      const __grid_constant__ ParamPlan pp) {                               \
    decode<kMinSum, true, early_stop, quant, weighted, kStorage, true,      \
           false, false, wide>(                                             \
        llr, post_out, bits_out, done_in, aux_out, plan, ab, wm, wl, z, mb, \
        nb, P, iterations, check_every, group, clamp, qstep, qclip, sstep,  \
        sinv, &pp, nullptr, nullptr);                                       \
  }
// The flooding min-sum forms on the compressed state (name_cs, or name_cw
// on the wide word): the same arguments and the flooding plan as a
// parameter.
#define QC_KERNEL_FLOOD_CS(name, sfx, wide, early_stop, quant, weighted)    \
  __global__ void __launch_bounds__(1024)                                   \
      QC_CAT(QC_CAT(name, sfx), QC_SUFFIX)(                                 \
      const float* llr, float* post_out, int8_t* bits_out,                  \
      const int* done_in, int* aux_out, const int* plan, const float* ab,   \
      const float* wm, const float* wl, int z, int mb, int nb, int P,       \
      int iterations, int check_every, int group, float clamp, float qstep, \
      float qclip, float sstep, float sinv,                                 \
      const __grid_constant__ FloodPlan fp) {                               \
    decode<kMinSum, false, early_stop, quant, weighted, kStorage, true,     \
           false, false, wide>(                                             \
        llr, post_out, bits_out, done_in, aux_out, plan, ab, wm, wl, z, mb, \
        nb, P, iterations, check_every, group, clamp, qstep, qclip, sstep,  \
        sinv, nullptr, &fp, nullptr);                                       \
  }

// The sum-product forms with a check's slots in registers (name_sr, or
// name_rw on the wide rows, serial-C alone): the same arguments and the
// plan, rows and columns, as a parameter.
#define QC_KERNEL_SR(name, sfx, wide, layered, early_stop, quant, weighted) \
  __global__ void QC_CAT(QC_CAT(name, sfx), QC_SUFFIX)(                     \
      const float* llr, float* post_out, int8_t* bits_out,                  \
      const int* done_in, int* aux_out, const int* plan, const float* ab,   \
      const float* wm, const float* wl, int z, int mb, int nb, int P,       \
      int iterations, int check_every, int group, float clamp, float qstep, \
      float qclip, float sstep, float sinv,                                 \
      const __grid_constant__ FloodPlan fp) {                               \
    decode<kSumProduct, layered, early_stop, quant, weighted, kStorage,     \
           false, true, false, wide>(                                       \
        llr, post_out, bits_out, done_in, aux_out, plan, ab, wm, wl, z, mb, \
        nb, P, iterations, check_every, group, clamp, qstep, qclip, sstep,  \
        sinv, nullptr, &fp, nullptr);                                       \
  }

// The group-serial layered forms (name_gs, or name_gw on the wide rows):
// the same arguments and the per-group plan as a parameter; min-sum on the
// compressed state. bounds: the kernel's launch bounds, or QC_NO_BOUNDS.
// The weighted min-sum _gw kernels are held to 80 registers a thread
// (QC_GW_WEIGHTED_BOUNDS: 8 CTAs of 96 threads an SM), which spills 16-32
// B and ran 1.25x faster than with their 103 registers on qc1944_r34; the
// same bounds made the other min-sum _gw kernels 3-7% slower (PERF.md).
#define QC_NO_BOUNDS
#define QC_GW_WEIGHTED_BOUNDS __launch_bounds__(96, 8)
#define QC_KERNEL_GS(name, sfx, wide, bounds, method, early_stop, quant,   \
                     weighted)                                              \
  __global__ void bounds QC_CAT(QC_CAT(name, sfx), QC_SUFFIX)(              \
      const float* llr, float* post_out, int8_t* bits_out,                  \
      const int* done_in, int* aux_out, const int* plan, const float* ab,   \
      const float* wm, const float* wl, int z, int mb, int nb, int P,       \
      int iterations, int check_every, int group, float clamp, float qstep, \
      float qclip, float sstep, float sinv,                                 \
      const __grid_constant__ GroupPlan gp) {                               \
    decode<method, true, early_stop, quant, weighted, kStorage,             \
           method == kMinSum, false, true, wide>(                           \
        llr, post_out, bits_out, done_in, aux_out, plan, ab, wm, wl, z, mb, \
        nb, P, iterations, check_every, group, clamp, qstep, qclip, sstep,  \
        sinv, nullptr, &gp, &gp);                                           \
  }

QC_KERNEL(minsum_qc_flooding, kMinSum, false, false, false, false)
QC_KERNEL(minsum_qc_layered, kMinSum, true, false, false, false)
QC_KERNEL(minsum_qc_flooding_es, kMinSum, false, true, false, false)
QC_KERNEL(minsum_qc_layered_es, kMinSum, true, true, false, false)
QC_KERNEL(minsum_qc_flooding_msgq, kMinSum, false, false, true, false)
QC_KERNEL(minsum_qc_layered_msgq, kMinSum, true, false, true, false)
QC_KERNEL(minsum_qc_flooding_es_msgq, kMinSum, false, true, true, false)
QC_KERNEL(minsum_qc_layered_es_msgq, kMinSum, true, true, true, false)
QC_KERNEL(sumproduct_qc_flooding, kSumProduct, false, false, false, false)
QC_KERNEL(sumproduct_qc_layered, kSumProduct, true, false, false, false)
QC_KERNEL(sumproduct_qc_flooding_es, kSumProduct, false, true, false, false)
QC_KERNEL(sumproduct_qc_layered_es, kSumProduct, true, true, false, false)
QC_KERNEL(sumproduct_qc_flooding_msgq, kSumProduct, false, false, true, false)
QC_KERNEL(sumproduct_qc_layered_msgq, kSumProduct, true, false, true, false)
QC_KERNEL(sumproduct_qc_flooding_es_msgq, kSumProduct, false, true, true,
          false)
QC_KERNEL(sumproduct_qc_layered_es_msgq, kSumProduct, true, true, true, false)
// the weighted forms (no early stop, as in the TPU kernel)
QC_KERNEL(minsum_qc_flooding_w, kMinSum, false, false, false, true)
QC_KERNEL(minsum_qc_layered_w, kMinSum, true, false, false, true)
QC_KERNEL(minsum_qc_flooding_w_msgq, kMinSum, false, false, true, true)
QC_KERNEL(minsum_qc_layered_w_msgq, kMinSum, true, false, true, true)
QC_KERNEL(sumproduct_qc_flooding_w, kSumProduct, false, false, false, true)
QC_KERNEL(sumproduct_qc_layered_w, kSumProduct, true, false, false, true)
QC_KERNEL(sumproduct_qc_flooding_w_msgq, kSumProduct, false, false, true,
          true)
QC_KERNEL(sumproduct_qc_layered_w_msgq, kSumProduct, true, false, true, true)
QC_KERNEL_CS(minsum_qc_layered, _cs, false, false, false, false)
QC_KERNEL_CS(minsum_qc_layered_es, _cs, false, true, false, false)
QC_KERNEL_CS(minsum_qc_layered_msgq, _cs, false, false, true, false)
QC_KERNEL_CS(minsum_qc_layered_es_msgq, _cs, false, true, true, false)
QC_KERNEL_CS(minsum_qc_layered_w, _cs, false, false, false, true)
QC_KERNEL_CS(minsum_qc_layered_w_msgq, _cs, false, false, true, true)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding, _cs, false, false, false, false)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_es, _cs, false, true, false, false)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_msgq, _cs, false, false, true, false)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_es_msgq, _cs, false, true, true, false)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_w, _cs, false, false, false, true)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_w_msgq, _cs, false, false, true, true)
QC_KERNEL_CS(minsum_qc_layered, _cw, true, false, false, false)
QC_KERNEL_CS(minsum_qc_layered_es, _cw, true, true, false, false)
QC_KERNEL_CS(minsum_qc_layered_msgq, _cw, true, false, true, false)
QC_KERNEL_CS(minsum_qc_layered_es_msgq, _cw, true, true, true, false)
QC_KERNEL_CS(minsum_qc_layered_w, _cw, true, false, false, true)
QC_KERNEL_CS(minsum_qc_layered_w_msgq, _cw, true, false, true, true)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding, _cw, true, false, false, false)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_es, _cw, true, true, false, false)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_msgq, _cw, true, false, true, false)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_es_msgq, _cw, true, true, true, false)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_w, _cw, true, false, false, true)
QC_KERNEL_FLOOD_CS(minsum_qc_flooding_w_msgq, _cw, true, false, true, true)
QC_KERNEL_SR(sumproduct_qc_flooding, _sr, false, false, false, false, false)
QC_KERNEL_SR(sumproduct_qc_layered, _sr, false, true, false, false, false)
QC_KERNEL_SR(sumproduct_qc_flooding_es, _sr, false, false, true, false, false)
QC_KERNEL_SR(sumproduct_qc_layered_es, _sr, false, true, true, false, false)
QC_KERNEL_SR(sumproduct_qc_flooding_msgq, _sr, false, false, false, true, false)
QC_KERNEL_SR(sumproduct_qc_layered_msgq, _sr, false, true, false, true, false)
QC_KERNEL_SR(sumproduct_qc_flooding_es_msgq, _sr, false, false, true, true,
             false)
QC_KERNEL_SR(sumproduct_qc_layered_es_msgq, _sr, false, true, true, true, false)
QC_KERNEL_SR(sumproduct_qc_flooding_w, _sr, false, false, false, false, true)
QC_KERNEL_SR(sumproduct_qc_layered_w, _sr, false, true, false, false, true)
QC_KERNEL_SR(sumproduct_qc_flooding_w_msgq, _sr, false, false, false, true,
             true)
QC_KERNEL_SR(sumproduct_qc_layered_w_msgq, _sr, false, true, false, true, true)
QC_KERNEL_SR(sumproduct_qc_layered, _rw, true, true, false, false, false)
QC_KERNEL_SR(sumproduct_qc_layered_es, _rw, true, true, true, false, false)
QC_KERNEL_SR(sumproduct_qc_layered_msgq, _rw, true, true, false, true, false)
QC_KERNEL_SR(sumproduct_qc_layered_es_msgq, _rw, true, true, true, true, false)
QC_KERNEL_SR(sumproduct_qc_layered_w, _rw, true, true, false, false, true)
QC_KERNEL_SR(sumproduct_qc_layered_w_msgq, _rw, true, true, false, true, true)
QC_KERNEL_GS(minsum_qc_layered, _gs, false, QC_NO_BOUNDS, kMinSum, false, false,
             false)
QC_KERNEL_GS(minsum_qc_layered_es, _gs, false, QC_NO_BOUNDS, kMinSum, true,
             false, false)
QC_KERNEL_GS(minsum_qc_layered_msgq, _gs, false, QC_NO_BOUNDS, kMinSum, false,
             true, false)
QC_KERNEL_GS(minsum_qc_layered_es_msgq, _gs, false, QC_NO_BOUNDS, kMinSum, true,
             true, false)
QC_KERNEL_GS(minsum_qc_layered_w, _gs, false, QC_NO_BOUNDS, kMinSum, false,
             false, true)
QC_KERNEL_GS(minsum_qc_layered_w_msgq, _gs, false, QC_NO_BOUNDS, kMinSum, false,
             true, true)
QC_KERNEL_GS(sumproduct_qc_layered, _gs, false, QC_NO_BOUNDS, kSumProduct,
             false, false, false)
QC_KERNEL_GS(sumproduct_qc_layered_es, _gs, false, QC_NO_BOUNDS, kSumProduct,
             true, false, false)
QC_KERNEL_GS(sumproduct_qc_layered_msgq, _gs, false, QC_NO_BOUNDS, kSumProduct,
             false, true, false)
QC_KERNEL_GS(sumproduct_qc_layered_es_msgq, _gs, false, QC_NO_BOUNDS,
             kSumProduct, true, true, false)
QC_KERNEL_GS(sumproduct_qc_layered_w, _gs, false, QC_NO_BOUNDS, kSumProduct,
             false, false, true)
QC_KERNEL_GS(sumproduct_qc_layered_w_msgq, _gs, false, QC_NO_BOUNDS,
             kSumProduct, false, true, true)
QC_KERNEL_GS(minsum_qc_layered, _gw, true, QC_NO_BOUNDS, kMinSum, false, false,
             false)
QC_KERNEL_GS(minsum_qc_layered_es, _gw, true, QC_NO_BOUNDS, kMinSum, true,
             false, false)
QC_KERNEL_GS(minsum_qc_layered_msgq, _gw, true, QC_NO_BOUNDS, kMinSum, false,
             true, false)
QC_KERNEL_GS(minsum_qc_layered_es_msgq, _gw, true, QC_NO_BOUNDS, kMinSum, true,
             true, false)
QC_KERNEL_GS(minsum_qc_layered_w, _gw, true, QC_GW_WEIGHTED_BOUNDS, kMinSum,
             false, false, true)
QC_KERNEL_GS(minsum_qc_layered_w_msgq, _gw, true, QC_GW_WEIGHTED_BOUNDS,
             kMinSum, false, true, true)
QC_KERNEL_GS(sumproduct_qc_layered, _gw, true, QC_NO_BOUNDS, kSumProduct, false,
             false, false)
QC_KERNEL_GS(sumproduct_qc_layered_es, _gw, true, QC_NO_BOUNDS, kSumProduct,
             true, false, false)
QC_KERNEL_GS(sumproduct_qc_layered_msgq, _gw, true, QC_NO_BOUNDS, kSumProduct,
             false, true, false)
QC_KERNEL_GS(sumproduct_qc_layered_es_msgq, _gw, true, QC_NO_BOUNDS,
             kSumProduct, true, true, false)
QC_KERNEL_GS(sumproduct_qc_layered_w, _gw, true, QC_NO_BOUNDS, kSumProduct,
             false, false, true)
QC_KERNEL_GS(sumproduct_qc_layered_w_msgq, _gw, true, QC_NO_BOUNDS, kSumProduct,
             false, true, true)

#define QC_K(name) QC_CAT(name, QC_SUFFIX)

// The launch of one decode with this translation unit's storage type (the
// arguments of bp_qc_decode, below).
extern "C" int QC_CAT(bp_qc_launch, QC_SUFFIX)(
    int method, int layered, int early_stop, int quant, const float* llr,
    void* out, int out_hard, const int* done_in, int* aux_out,
    const int* plan, const int* plan_host, const int* group_host, int design,
    const float* ab, const float* wm, const float* wl, int batch, int z,
    int mb, int nb, int P, int row_deg, int iterations, int check_every,
    int group, float clamp, float qstep, float qclip, float sstep,
    float sinv, int threads, cudaStream_t stream) {
  using Kernel = void (*)(const float*, float*, int8_t*, const int*, int*,
                          const int*, const float*, const float*,
                          const float*, int, int, int, int, int, int, int,
                          float, float, float, float, float);
  using KernelCs = void (*)(const float*, float*, int8_t*, const int*, int*,
                            const int*, const float*, const float*,
                            const float*, int, int, int, int, int, int, int,
                            float, float, float, float, float, ParamPlan);
  using KernelFloodCs = void (*)(const float*, float*, int8_t*, const int*,
                                 int*, const int*, const float*,
                                 const float*, const float*, int, int, int,
                                 int, int, int, int, float, float, float,
                                 float, float, FloodPlan);
  using KernelGs = void (*)(const float*, float*, int8_t*, const int*, int*,
                            const int*, const float*, const float*,
                            const float*, int, int, int, int, int, int, int,
                            float, float, float, float, float, GroupPlan);
  // [early_stop][quant], and the weighted forms by [quant]
  static const KernelCs kCompressed[2][2] = {
      {QC_K(minsum_qc_layered_cs), QC_K(minsum_qc_layered_msgq_cs)},
      {QC_K(minsum_qc_layered_es_cs), QC_K(minsum_qc_layered_es_msgq_cs)}};
  static const KernelCs kCompressedW[2] = {QC_K(minsum_qc_layered_w_cs),
                                           QC_K(minsum_qc_layered_w_msgq_cs)};
  static const KernelFloodCs kFloodCompressed[2][2] = {
      {QC_K(minsum_qc_flooding_cs), QC_K(minsum_qc_flooding_msgq_cs)},
      {QC_K(minsum_qc_flooding_es_cs), QC_K(minsum_qc_flooding_es_msgq_cs)}};
  static const KernelFloodCs kFloodCompressedW[2] = {
      QC_K(minsum_qc_flooding_w_cs), QC_K(minsum_qc_flooding_w_msgq_cs)};
  // the same forms on the wide word (the _cw kernels)
  static const KernelCs kCompressedWide[2][2] = {
      {QC_K(minsum_qc_layered_cw), QC_K(minsum_qc_layered_msgq_cw)},
      {QC_K(minsum_qc_layered_es_cw), QC_K(minsum_qc_layered_es_msgq_cw)}};
  static const KernelCs kCompressedWideW[2] = {
      QC_K(minsum_qc_layered_w_cw), QC_K(minsum_qc_layered_w_msgq_cw)};
  static const KernelFloodCs kFloodWide[2][2] = {
      {QC_K(minsum_qc_flooding_cw), QC_K(minsum_qc_flooding_msgq_cw)},
      {QC_K(minsum_qc_flooding_es_cw), QC_K(minsum_qc_flooding_es_msgq_cw)}};
  static const KernelFloodCs kFloodWideW[2] = {
      QC_K(minsum_qc_flooding_w_cw), QC_K(minsum_qc_flooding_w_msgq_cw)};
  // the _sr kernels by [layered][early_stop][quant], weighted by
  // [layered][quant]
  static const KernelFloodCs kRegisters[2][2][2] = {
      {{QC_K(sumproduct_qc_flooding_sr), QC_K(sumproduct_qc_flooding_msgq_sr)},
       {QC_K(sumproduct_qc_flooding_es_sr),
        QC_K(sumproduct_qc_flooding_es_msgq_sr)}},
      {{QC_K(sumproduct_qc_layered_sr), QC_K(sumproduct_qc_layered_msgq_sr)},
       {QC_K(sumproduct_qc_layered_es_sr),
        QC_K(sumproduct_qc_layered_es_msgq_sr)}}};
  static const KernelFloodCs kRegistersW[2][2] = {
      {QC_K(sumproduct_qc_flooding_w_sr), QC_K(sumproduct_qc_flooding_w_msgq_sr)},
      {QC_K(sumproduct_qc_layered_w_sr), QC_K(sumproduct_qc_layered_w_msgq_sr)}};
  // the _gs kernels by [method][early_stop][quant], weighted by
  // [method][quant]
  static const KernelGs kGroupSerial[2][2][2] = {
      {{QC_K(minsum_qc_layered_gs), QC_K(minsum_qc_layered_msgq_gs)},
       {QC_K(minsum_qc_layered_es_gs), QC_K(minsum_qc_layered_es_msgq_gs)}},
      {{QC_K(sumproduct_qc_layered_gs), QC_K(sumproduct_qc_layered_msgq_gs)},
       {QC_K(sumproduct_qc_layered_es_gs),
        QC_K(sumproduct_qc_layered_es_msgq_gs)}}};
  static const KernelGs kGroupSerialW[2][2] = {
      {QC_K(minsum_qc_layered_w_gs), QC_K(minsum_qc_layered_w_msgq_gs)},
      {QC_K(sumproduct_qc_layered_w_gs), QC_K(sumproduct_qc_layered_w_msgq_gs)}};
  // the same forms on the wide rows: the _rw kernels (serial-C) by
  // [early_stop][quant], weighted by [quant], and the _gw kernels
  static const KernelFloodCs kRegistersWide[2][2] = {
      {QC_K(sumproduct_qc_layered_rw), QC_K(sumproduct_qc_layered_msgq_rw)},
      {QC_K(sumproduct_qc_layered_es_rw),
       QC_K(sumproduct_qc_layered_es_msgq_rw)}};
  static const KernelFloodCs kRegistersWideW[2] = {
      QC_K(sumproduct_qc_layered_w_rw), QC_K(sumproduct_qc_layered_w_msgq_rw)};
  static const KernelGs kGroupWide[2][2][2] = {
      {{QC_K(minsum_qc_layered_gw), QC_K(minsum_qc_layered_msgq_gw)},
       {QC_K(minsum_qc_layered_es_gw), QC_K(minsum_qc_layered_es_msgq_gw)}},
      {{QC_K(sumproduct_qc_layered_gw), QC_K(sumproduct_qc_layered_msgq_gw)},
       {QC_K(sumproduct_qc_layered_es_gw),
        QC_K(sumproduct_qc_layered_es_msgq_gw)}}};
  static const KernelGs kGroupWideW[2][2] = {
      {QC_K(minsum_qc_layered_w_gw), QC_K(minsum_qc_layered_w_msgq_gw)},
      {QC_K(sumproduct_qc_layered_w_gw), QC_K(sumproduct_qc_layered_w_msgq_gw)}};
  // [method][layered][early_stop][quant]
  static const Kernel kKernels[2][2][2][2] = {
      {{{QC_K(minsum_qc_flooding), QC_K(minsum_qc_flooding_msgq)},
        {QC_K(minsum_qc_flooding_es), QC_K(minsum_qc_flooding_es_msgq)}},
       {{QC_K(minsum_qc_layered), QC_K(minsum_qc_layered_msgq)},
        {QC_K(minsum_qc_layered_es), QC_K(minsum_qc_layered_es_msgq)}}},
      {{{QC_K(sumproduct_qc_flooding), QC_K(sumproduct_qc_flooding_msgq)},
        {QC_K(sumproduct_qc_flooding_es), QC_K(sumproduct_qc_flooding_es_msgq)}},
       {{QC_K(sumproduct_qc_layered), QC_K(sumproduct_qc_layered_msgq)},
        {QC_K(sumproduct_qc_layered_es), QC_K(sumproduct_qc_layered_es_msgq)}}}};
  // [method][layered][quant]
  static const Kernel kWeighted[2][2][2] = {
      {{QC_K(minsum_qc_flooding_w), QC_K(minsum_qc_flooding_w_msgq)},
       {QC_K(minsum_qc_layered_w), QC_K(minsum_qc_layered_w_msgq)}},
      {{QC_K(sumproduct_qc_flooding_w), QC_K(sumproduct_qc_flooding_w_msgq)},
       {QC_K(sumproduct_qc_layered_w), QC_K(sumproduct_qc_layered_w_msgq)}}};
  const bool weighted = wm != nullptr;
  if (weighted && (early_stop || wl == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (group < 1 || (group > 1 && !layered))
    return static_cast<int>(cudaErrorInvalidValue);
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the compressed state (min-sum) and the _sr kernels (sum-product):
  // flooding or serial-C; the _gs kernels: group-serial (both rules); each
  // on a code whose rows, block rows, planes and block columns fit the
  // state's word, the register arrays and the parameter's plan. The same
  // on a code whose rows fit the wide word and each have a body of their
  // degree (CwDegrees): the _cw kernels (min-sum), the _rw kernels
  // (sum-product serial-C) and the _gw kernels (group-serial)
  if (group > mb) group = mb;
  if (design < kDesignFull || design > kDesignRw)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide =
      design == kDesignCw || design == kDesignGw || design == kDesignRw;
  const bool group_design = design == kDesignGs || design == kDesignGw;
  const bool registers = design == kDesignSr || design == kDesignRw;
  const int max_deg = wide ? kCwMaxDeg : kCsMaxDeg;
  if (design != kDesignFull &&
      (group_design != (group > 1) ||
       (!group_design && method != (registers ? 1 : 0)) ||
       (design == kDesignRw && !layered) ||
       plan_host == nullptr || row_deg > max_deg || mb > kCsMaxRows ||
       P > kCsMaxPlanes || nb > kCsMaxCols))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    for (int i = 0; i < mb; ++i)
      if (((kCwDegreeMask >> (plan_host[i + 1] - plan_host[i])) & 1u) == 0)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  // the group plan's header: G, groups, fold entries, shared planes, the
  // largest group's shared planes (kernels/minsum_qc.py:group_plan)
  if (group_design &&
      (group_host == nullptr || group_host[0] != group ||
       group_host[1] != (mb + group - 1) / group ||
       group_host[1] > kGsMaxGroups || group_host[2] > kGsMaxFolds ||
       group_host[3] > P || group_host[4] > group_host[3]))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ly = layered != 0, es = early_stop != 0, qu = quant != 0;
  const int sp = method != 0;
  const Kernel fn = weighted ? kWeighted[sp][ly][qu] : kKernels[sp][ly][es][qu];
  KernelCs fn_cs = nullptr;       // the plan's rows in the parameter
  KernelFloodCs fn_fp = nullptr;  // its rows and columns
  KernelGs fn_gs = nullptr;       // and its groups
  if (design == kDesignCs && layered)
    fn_cs = weighted ? kCompressedW[qu] : kCompressed[es][qu];
  else if (design == kDesignCs)
    fn_fp = weighted ? kFloodCompressedW[qu] : kFloodCompressed[es][qu];
  else if (design == kDesignCw && layered)
    fn_cs = weighted ? kCompressedWideW[qu] : kCompressedWide[es][qu];
  else if (design == kDesignCw)
    fn_fp = weighted ? kFloodWideW[qu] : kFloodWide[es][qu];
  else if (design == kDesignSr)
    fn_fp = weighted ? kRegistersW[ly][qu] : kRegisters[ly][es][qu];
  else if (design == kDesignRw)
    fn_fp = weighted ? kRegistersWideW[qu] : kRegistersWide[es][qu];
  else if (design == kDesignGs)
    fn_gs = weighted ? kGroupSerialW[sp][qu] : kGroupSerial[sp][es][qu];
  else if (design == kDesignGw)
    fn_gs = weighted ? kGroupWideW[sp][qu] : kGroupWide[sp][es][qu];
  const void* entry =
      fn_cs != nullptr   ? reinterpret_cast<const void*>(fn_cs)
      : fn_fp != nullptr ? reinterpret_cast<const void*>(fn_fp)
      : fn_gs != nullptr ? reinterpret_cast<const void*>(fn_gs)
                         : reinterpret_cast<const void*>(fn);
  // the scratch: the _gs and _gw kernels' largest group's shared planes,
  // the full messages' group planes
  const int scratch_planes =
      group_design ? group_host[4]
      : group > 1         ? (group * row_deg < P ? group * row_deg : P)
                          : 0;
  const bool compressed = design == kDesignCs || design == kDesignCw ||
                          (group_design && method == 0);
  const int smem = smem_bytes<kStorage>(z, mb, nb, P, scratch_planes, design,
                                        layered != 0, compressed);
  cudaError_t err = cudaFuncSetAttribute(
      entry, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, entry);
  if (err != cudaSuccess) return static_cast<int>(err);
  // layered: one thread per check of a group of block rows (as many as the
  // kernel's registers allow); flooding: `threads` stride over the checks,
  // then over the variables. The _gs kernels' walks take any warp count:
  // sum-product takes a warp for each (block row of a group, 32 checks), at
  // most 1024 threads; so does min-sum where its CTA's shared memory leaves
  // room for fewer than four CTAs an SM (the 5G-class codes), and else one
  // block row's warps, serial-C's CTA, whose warps walk the group's rows
  // (its barriers wait for fewer warps, and more CTAs share the SM; PERF.md
  // times both on wifi648, wifi1944, qc8448 and qc12288, and for the _gw
  // kernels on qc1944_r34 and r56)
  if (group_design) {
    const int chunks = (z + 31) / 32;
    const bool row = method == 0 && 4 * (smem + kSmemPerCta) <= kSmemPerSm;
    const int warps = row ? chunks : group * chunks;
    threads = (warps < 32 ? warps : 32) * 32;
  } else if (layered) {
    threads = ((group * z + 31) / 32) * 32;
  }
  if (threads > attr.maxThreadsPerBlock)
    threads = attr.maxThreadsPerBlock / 32 * 32;
  float* post_out = out_hard ? nullptr : static_cast<float*>(out);
  int8_t* bits_out = out_hard ? static_cast<int8_t*>(out) : nullptr;
  if (design != kDesignFull) {
    // the host plan (the layout of `plan`) into the parameter: row_ptr,
    // then per plane its variables' and checks' offsets, shift and slot;
    // then col_ptr, and per column entry its checks' offset, shift, slot
    // and plane (the compressed serial-C forms take the rows alone); the
    // _gs forms add the group plan's arrays as group_host holds them
    GroupPlan gp{};
    const int* plane_col = plan_host + (mb + 1);
    const int* plane_shift = plane_col + P;
    const int* col_ptr = plane_shift + P;
    const int* col_planes = col_ptr + (nb + 1);
    for (int i = 0; i <= mb; ++i) gp.row_ptr[i] = plan_host[i];
    for (int i = 0; i < mb; ++i)
      for (int p = plan_host[i]; p < plan_host[i + 1]; ++p)
        gp.plane[p] = make_int4(plane_col[p] * z, plane_shift[p], i * z,
                                p - plan_host[i]);
    for (int j = 0; j <= nb; ++j) gp.col_ptr[j] = col_ptr[j];
    // the slot's sign bit and index field where the design's word keeps
    // them (8 sign bits, or 24 on the wide word)
    const int shift = wide ? CsWide::kIdxShift : CsNarrow::kIdxShift;
    for (int e = 0; e < P; ++e) {
      const int4 pl = gp.plane[col_planes[e]];
      gp.col[e] = make_int4(pl.z, pl.y, (1 << pl.w) | (pl.w << shift),
                            col_planes[e]);
    }
    if (fn_gs != nullptr) {
      const int groups = group_host[1], folds = group_host[2];
      const int* fold_ptr = group_host + 5;
      const int* scratch = fold_ptr + groups + 1;
      const int* fold = scratch + P;
      for (int g = 0; g <= groups; ++g) gp.fold_ptr[g] = fold_ptr[g];
      for (int p = 0; p < P; ++p) gp.scratch[p] = scratch[p];
      for (int f = 0; f < folds; ++f)
        gp.fold[f] = make_int4(fold[3 * f], fold[3 * f + 1], fold[3 * f + 2],
                               0);
      fn_gs<<<batch, threads, smem, stream>>>(
          llr, post_out, bits_out, done_in, aux_out, plan, ab, wm, wl, z, mb,
          nb, P, iterations, check_every, group, clamp, qstep, qclip, sstep,
          sinv, gp);
    } else if (fn_cs != nullptr) {
      const ParamPlan pp = gp;  // the rows' plan alone
      fn_cs<<<batch, threads, smem, stream>>>(
          llr, post_out, bits_out, done_in, aux_out, plan, ab, wm, wl, z, mb,
          nb, P, iterations, check_every, group, clamp, qstep, qclip, sstep,
          sinv, pp);
    } else {
      const FloodPlan fp = gp;  // the rows and columns
      fn_fp<<<batch, threads, smem, stream>>>(
          llr, post_out, bits_out, done_in, aux_out, plan, ab, wm, wl, z, mb,
          nb, P, iterations, check_every, group, clamp, qstep, qclip, sstep,
          sinv, fp);
    }
  } else {
    fn<<<batch, threads, smem, stream>>>(
        llr, post_out, bits_out, done_in, aux_out, plan, ab, wm, wl, z, mb,
        nb, P, iterations, check_every, group, clamp, qstep, qclip, sstep,
        sinv);
  }
  return static_cast<int>(cudaGetLastError());
}

#if QC_STORAGE == 0
extern "C" {

int bp_qc_launch_bf16(int, int, int, int, const float*, void*, int,
                      const int*, int*, const int*, const int*, const int*,
                      int, const float*, const float*, const float*, int, int,
                      int, int, int, int, int, int, int, float, float, float,
                      float, float, int, cudaStream_t);
int bp_qc_launch_i8(int, int, int, int, const float*, void*, int, const int*,
                    int*, const int*, const int*, const int*, int,
                    const float*, const float*, const float*, int, int, int,
                    int, int, int, int, int, int, float, float, float, float,
                    float, int, cudaStream_t);

// Launches one decode on `stream`: grid = batch CTAs, one codeword each.
// dtype: the message storage, 0 f32, 1 bf16, 2 int8 (its grid's step sstep
// and the reciprocal sinv, both f32). method: 0 min-sum, 1 sum-product.
// quant != 0 selects the _msgq form with step qstep and clip qclip. `out`
// is int8 hard bits when out_hard != 0, else the f32 posterior in the
// log(Pr1/Pr0) convention; both (batch, nb*z) row-major. `ab` holds
// `iterations` rows of (alpha, beta). plan: the device plan; plan_host: the
// same ints on the host. design: kDesignFull (0) the full messages;
// kDesignCs (1) the compressed check state of the min-sum forms, kDesignSr
// (2) the sum-product forms with a check's slots in registers, each
// flooding or serial-C with group 1 (the _cs and _sr kernels); kDesignCw
// (4) the min-sum forms of kDesignCs on the wide word, on codes with rows
// above 8 slots (the _cw kernels, bp_qc_wide_limits); kDesignGs
// (3) the group-serial forms of both rules with group > 1 (the _gs
// kernels), which also read group_host (kernels/minsum_qc.py:group_plan)
// into the parameter's GroupPlan (or null for the other designs); each
// within the limits of bp_qc_compressed_limits, reading plan_host into the
// kernel's parameter. On the codes of the _cw kernels, kDesignRw (6) the
// serial-C forms of kDesignSr (the _rw kernels) and kDesignGw (5) those of
// kDesignGs (the _gw kernels, min-sum on the wide word), each row's slots
// unrolled to its degree. clamp = +inf for no clamp. done_in:
// (batch,) int32 flags of codewords to skip, or null. aux_out: (batch,)
// int32, the iterations run when early_stop != 0 (then required), else the
// unsatisfied-check counts, or null. check_every must divide iterations; a
// sum-product code's rows have at most kMaxRowDeg slots (row_deg: the
// code's largest row degree). wm, wl: the weight tables ((iterations+1)
// rows of P*z check-oriented edge weights and of nb*z LLR weights), or both
// null; weights take no early stop. group: block rows per group of the
// layered schedule (1 = serial-C; above 1 the full-message kernels take
// min(P, group*row_deg)*z floats more of shared memory, the _gs kernels
// the largest group's shared planes of z floats). threads: the flooding
// forms' CTA size, a multiple of 32 in [32, 1024] (a layered CTA has
// group*z threads rounded up to warps, a _gs CTA a warp for each 32 checks
// of a group or of one block row, at most 1024 threads). Returns the CUDA
// error code of the launch (0 on success).
int bp_qc_decode(int dtype, int method, int layered, int early_stop,
                 int quant, const float* llr, void* out, int out_hard,
                 const int* done_in, int* aux_out, const int* plan,
                 const int* plan_host, const int* group_host, int design,
                 const float* ab, const float* wm, const float* wl, int batch,
                 int z, int mb, int nb, int P, int row_deg, int iterations,
                 int check_every, int group, float clamp, float qstep,
                 float qclip, float sstep, float sinv, int threads,
                 cudaStream_t stream) {
  auto* launch = dtype == kF32    ? bp_qc_launch
                 : dtype == kBf16 ? bp_qc_launch_bf16
                 : dtype == kInt8 ? bp_qc_launch_i8
                                  : nullptr;
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(method, layered, early_stop, quant, llr, out, out_hard,
                done_in, aux_out, plan, plan_host, group_host, design, ab, wm,
                wl, batch, z, mb, nb, P, row_deg, iterations, check_every,
                group, clamp, qstep, qclip, sstep, sinv, threads, stream);
}

// The limits of the compressed state and the _sr kernels: row degree,
// block rows, planes, block columns.
int bp_qc_compressed_limits(int* out) {
  out[0] = kCsMaxDeg;
  out[1] = kCsMaxRows;
  out[2] = kCsMaxPlanes;
  out[3] = kCsMaxCols;
  return 0;
}

// The limits of the wide word (the _cw kernels): its slots, and a mask of
// the row degrees they have a body for (bit d: degree d).
int bp_qc_wide_limits(int* out) {
  out[0] = kCwMaxDeg;
  out[1] = static_cast<int>(kCwDegreeMask);
  return 0;
}

// The group-serial plan's bytes (sizeof(GroupPlan)), groups and fold
// entries.
int bp_qc_group_plan_limits(int* out) {
  out[0] = static_cast<int>(sizeof(GroupPlan));
  out[1] = kGsMaxGroups;
  out[2] = kGsMaxFolds;
  return 0;
}

// The largest row degree the sum-product forms take.
int bp_qc_max_row_degree() { return kMaxRowDeg; }

const char* bp_qc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
#endif
