// GF(2) systematic encode of LDPC codewords for Hopper (sm_90a): int8 info
// bits in, int8 codewords out in the code's original position order, in one
// launch.
//
// Replaces no Pallas kernel: the JAX package's encode
// (ldpc_sims_tpu/ops/encode.py:encode) is an XLA int8 dot that XLA lowers
// for the TPU's matrix unit. The port's first encode was its CUDA
// counterpart, a float32 torch.matmul of the 0/1 matrices (TF32 off) with
// four elementwise passes around it: a dense SIMT GEMM over the whole
// (k x n) generator, half of it the identity block, and ~1.3 GB of passes a
// step at batch 32768 on wifi1944. The kernel is its replacement on the
// card; ldpc_sims_tpu_torch/ops/encode.py keeps that product as the plain
// version for CPU tensors.
//
// What bounds it on the H100, wifi1944 (k = 972, n = 1944) at batch 32768:
//   * bytes: 31.85 MB of info bits read and 63.70 MB of codewords written,
//     95.55 MB, 0.029 ms at 3.35 TB/s;
//   * operations: each parity bit is popc(XOR_w (u_w & P_rw)) & 1 over the
//     info bits packed 32 a word: 972 rows x 31 words x 32768 codewords =
//     0.99 G 32-bit AND-and-XOR (one LOP3 each on the SIMT cores), 0.06 ms
//     at 64 INT32 lanes x 132 SMs x 1.98 GHz.
// What the design does about it:
//   * the parities are a binary matrix product on the tensor cores:
//     mma.sync m16n8k256 .b1 with .and.popc sums popc(u & P) over 256 info
//     bits for 16 codewords x 8 parity rows in one instruction, and the
//     parity is the sum & 1. A first design ran the same product as LOP3s
//     on the SIMT cores, a lane a codeword, and took 0.226 ms: each 16-B
//     broadcast load of table words fed only four LOP3s, so shared memory's
//     bandwidth held it near four times its LOP3 bound. One mma takes one
//     8-B table load a thread for 1024 LOP3s' worth of work;
//   * the table (the parity rows of the original-order generator, packed
//     32 info bits a word; 152 KB for wifi1944) is copied once into shared
//     memory by a persistent CTA an SM, where it fits beside the staging;
//     else (the 5G-class codes, 2.2-4.7 MB) it is read through L2 with
//     __ldg;
//   * a word's 32 info bits come from 32 lanes' byte loads and one ballot,
//     32 loads in flight before the ballots;
//   * the codewords are staged in shared memory (parity bits and copied
//     info bits at their output positions) and written out a codeword a
//     warp with 4-B stores, 128 contiguous bytes a warp store.
// So the kernel is left bound by its bytes and the latency of each tile's
// loads, not by its arithmetic.
// Positions: the host gives, for each output position, either "copy info
// bit i" (a unit row of the generator) or "parity row r" (ops/encode.py:
// encode_plan), so a code whose systematic positions are not [0, k) (the
// library's peg256_128) comes out right. Codes whose staging does not fit
// beside the table are staged in chunks of output positions.
//
// Fragments (PTX ISA, mma.m16n8k256 .b1; g = lane / 4, t = lane % 4): A
// (16 codewords x 256 bits, row-major) a0/a2 hold row g, a1/a3 row g + 8,
// bits [32t, 32t + 32) in a0/a1 and [128 + 32t, ...) in a2/a3; B (256 bits
// x 8 parity rows, column-major) b0/b1 hold row g's bits [32t, ...) and
// [128 + 32t, ...); C c0/c1 hold codeword g and parity rows 2t, 2t + 1,
// c2/c3 codeword g + 8. The host stores each 256-bit chunk's eight words
// in the order w0 w4 w1 w5 w2 w6 w3 w7 (and the ballots are stored so),
// so a thread's two words of a row are one 8-B load; the row stride keeps
// a half-warp's eight 8-B loads on 32 different banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// codewords a tile: two m16 groups
constexpr int kTile = 32;
// 32 warps: warp w packs, copies and writes out codeword w of the tile,
// and takes every 32nd (m16 group, block of 8 parity rows) of a chunk
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// info words the ballots pack at once: 32 loads in flight a lane
constexpr int kPackWords = 32;

struct EncodeArgs {
  const int8_t* u;          // (batch, k) info bits, bit = byte & 1
  int8_t* out;              // (batch, n) codewords
  const uint32_t* table;    // (rows, stride) packed parity rows
  const int* par_pos;       // (rows) output position of each parity row
  const int* copy_src;      // (copies) info bit of each copied position
  const int* copy_pos;      // (copies) its output position
  const int* row_lo;        // (chunks + 1) parity rows of each chunk
  const int* copy_lo;       // (chunks + 1) copies of each chunk
  long long batch;
  int n, k;
  int kchunks;  // 256-bit chunks of the info bits (eight words each)
  int stride;   // words a table row and a packed codeword
  int chunk;    // output positions a chunk
  int sstride;  // bytes a staged codeword chunk (a multiple of 4, odd / 4)
  int chunks;   // chunks of output positions
  int rows;     // parity rows
};

__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint2 alo,
                                             uint2 ahi, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(alo.x), "r"(ahi.x), "r"(alo.y), "r"(ahi.y), "r"(b.x), "r"(b.y));
}

template <bool kSmemTable>
__global__ void __launch_bounds__(kThreads, 1)
    encode_gf2(const EncodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t table_bytes =
      kSmemTable ? static_cast<size_t>(a.rows) * a.stride * 4 : 0;
  uint32_t* us = reinterpret_cast<uint32_t*>(smem + table_bytes);
  unsigned char* stage =
      smem + table_bytes + static_cast<size_t>(kTile) * a.stride * 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int words = a.kchunks * 8;

  if (kSmemTable) {
    const uint4* src = reinterpret_cast<const uint4*>(a.table);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    const int n16 = a.rows * a.stride / 4;
    for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = __ldg(src + i);
    __syncthreads();
  }
  const uint2* table = kSmemTable ? reinterpret_cast<const uint2*>(smem)
                                  : reinterpret_cast<const uint2*>(a.table);

  const long long tiles = (a.batch + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long cw = tile * kTile + warp;
    const bool live = cw < a.batch;
    // pack: word w of this warp's codeword is the ballot of its 32 bytes,
    // stored in each 256-bit chunk's order w0 w4 w1 w5 w2 w6 w3 w7
    const int8_t* urow = a.u + cw * a.k;
    uint32_t* upack = us + warp * a.stride;
    for (int w0 = 0; w0 < words; w0 += kPackWords) {
      int b[kPackWords];
#pragma unroll
      for (int i = 0; i < kPackWords; ++i) {
        const int j = (w0 + i) * 32 + lane;
        b[i] = live && j < a.k ? __ldg(urow + j) : 0;
      }
      uint32_t w[kPackWords];
#pragma unroll
      for (int i = 0; i < kPackWords; ++i)
        w[i] = __ballot_sync(0xffffffffu, b[i] & 1);
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < kPackWords / 8; ++s) {
          if (w0 + 8 * s < words) {
            uint4* d = reinterpret_cast<uint4*>(upack + w0 + 8 * s);
            const uint32_t* v = w + 8 * s;
            d[0] = make_uint4(v[0], v[4], v[1], v[5]);
            d[1] = make_uint4(v[2], v[6], v[3], v[7]);
          }
        }
      }
    }
    __syncthreads();

    for (int pc = 0; pc < a.chunks; ++pc) {
      const int p0 = pc * a.chunk;
      const int plen = min(a.chunk, a.n - p0);
      unsigned char* srow = stage + warp * a.sstride;
      // the copied info bits of this chunk, this warp's codeword (word
      // w of a chunk sits at slot 2 (w % 4) + w / 4)
      const int qhi = __ldg(a.copy_lo + pc + 1);
#pragma unroll 4
      for (int q = __ldg(a.copy_lo + pc) + lane; q < qhi; q += 32) {
        const int src = __ldg(a.copy_src + q);
        const int w = src >> 5;
        const int slot = (w & ~7) | ((w & 3) << 1) | ((w >> 2) & 1);
        srow[__ldg(a.copy_pos + q) - p0] =
            static_cast<unsigned char>((upack[slot] >> (src & 31)) & 1);
      }
      // the parity rows of this chunk: a warp takes (m16 group, 8 rows)
      // blocks; the group is the warp's parity, since kWarps is even
      const int rlo = __ldg(a.row_lo + pc);
      const int rhi = __ldg(a.row_lo + pc + 1);
      const int mg = warp & 1;
      const uint2* alo = reinterpret_cast<const uint2*>(
          us + (mg * 16 + g) * a.stride) + t;
      const uint2* ahi = alo + 4 * a.stride;  // 8 rows on: 8 * stride / 2
      unsigned char* slo = stage + (mg * 16 + g) * a.sstride - p0;
      unsigned char* shi = slo + 8 * a.sstride;
      for (int r0 = rlo + (warp >> 1) * 8; r0 < rhi; r0 += kWarps / 2 * 8) {
        // the block's row g, clamped: rows past rhi are computed and
        // not stored
        const int rb = min(r0 + g, a.rows - 1);
        const uint2* brow =
            table + static_cast<size_t>(rb) * (a.stride / 2) + t;
        int c[4] = {0, 0, 0, 0};
        for (int kc = 0; kc < a.kchunks; ++kc) {
          const uint2 bv = kSmemTable ? brow[4 * kc] : __ldg(brow + 4 * kc);
          mma_and_popc(c, alo[4 * kc], ahi[4 * kc], bv);
        }
        const int ra = r0 + 2 * t;
        if (ra < rhi) {
          const int pos = __ldg(a.par_pos + ra);
          slo[pos] = static_cast<unsigned char>(c[0] & 1);
          shi[pos] = static_cast<unsigned char>(c[2] & 1);
        }
        if (ra + 1 < rhi) {
          const int pos = __ldg(a.par_pos + ra + 1);
          slo[pos] = static_cast<unsigned char>(c[1] & 1);
          shi[pos] = static_cast<unsigned char>(c[3] & 1);
        }
      }
      __syncthreads();
      // write out this warp's codeword chunk: 4-B stores where n allows
      if (live) {
        int8_t* orow = a.out + cw * a.n + p0;
        if ((a.n & 3) == 0) {
          const uint32_t* s4 = reinterpret_cast<const uint32_t*>(srow);
          uint32_t* o4 = reinterpret_cast<uint32_t*>(orow);
          for (int i = lane; i < plen / 4; i += 32) o4[i] = s4[i];
        } else {
          for (int i = lane; i < plen; i += 32)
            orow[i] = static_cast<int8_t>(srow[i]);
        }
      }
      // the next chunk writes the same staging
      if (pc + 1 < a.chunks) __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// One launch of the encode on `stream` (a cudaStream_t): a persistent CTA of
// 1024 threads an SM, at most one a tile of 32 codewords. Returns
// cudaGetLastError() after the launch (0: launched).
int ldpc_encode(const void* u, void* out, const void* table,
                const void* par_pos, const void* copy_src,
                const void* copy_pos, const void* row_lo, const void* copy_lo,
                long long batch, int n, int k, int kchunks, int stride,
                int chunk, int sstride, int chunks, int rows, int smem_table,
                int smem_bytes, void* stream) {
  EncodeArgs a;
  a.u = static_cast<const int8_t*>(u);
  a.out = static_cast<int8_t*>(out);
  a.table = static_cast<const uint32_t*>(table);
  a.par_pos = static_cast<const int*>(par_pos);
  a.copy_src = static_cast<const int*>(copy_src);
  a.copy_pos = static_cast<const int*>(copy_pos);
  a.row_lo = static_cast<const int*>(row_lo);
  a.copy_lo = static_cast<const int*>(copy_lo);
  a.batch = batch;
  a.n = n;
  a.k = k;
  a.kchunks = kchunks;
  a.stride = stride;
  a.chunk = chunk;
  a.sstride = sstride;
  a.chunks = chunks;
  a.rows = rows;
  const void* entry = smem_table
                          ? reinterpret_cast<const void*>(encode_gf2<true>)
                          : reinterpret_cast<const void*>(encode_gf2<false>);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        entry, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (batch + kTile - 1) / kTile;
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_table)
    encode_gf2<true><<<blocks, kThreads, smem_bytes, s>>>(a);
  else
    encode_gf2<false><<<blocks, kThreads, smem_bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
