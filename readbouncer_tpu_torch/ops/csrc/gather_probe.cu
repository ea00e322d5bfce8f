// Kernel K5, the gather probe, for Hopper (sm_90a).
//
// Plain C interface (extern "C", no PyTorch headers), built and bound as
// ops/csrc/ibf_count.cu is (readbouncer_tpu_torch/ops/_build.py).  The entry
// point launches three kernels on the stream it is given, in order,
// allocates nothing, and returns the first launch error (cudaError_t).
//
// K5  rb_xor_gather — replaces the Pallas kernel
//     scripts/dma_gather_probe.py::_dma_gather_kernel (:59), reached
//     through dma_gather (:106).
//     tab [N, S] uint32 (S = BR*WD words per slice), idx [M] int32, CH, NBUF
//     -> out [S]: the XOR of tab[idx[j]] over every j.  The TPU kernel
//     streams every index's slice from HBM into VMEM through an NBUF-deep
//     ring of async copies and XORs it into an accumulator, CH indices per
//     grid step, the grid in order.
//     Bound: bytes.  XOR cancels pairs, so the function needs only the
//     slices hit an odd number of times, each read once, plus idx and the
//     output.  At the probe's defaults (M = 974,848) that is 77,564 of
//     154,533 4 KiB blocks (318 MB, 0.096 ms at 3.35 TB/s) or 489,978 of
//     1,236,269 512 B rows (251 MB, 0.076 ms); reading every index's slice
//     (4.0 GB / 0.50 GB), as the first version of this kernel did, costs
//     12x / 2x that, and the L2 cache (50 MB) catches few repeats in a
//     633 MB table.  So one call reads only the odd-hit slices, in three
//     launches:
//     1. parity_kernel: one thread per index; a valid index i flips bit
//        i & 31 of word i >> 5 of a zeroed bitmap of ceil(N/32) words with
//        atomicXor (resolved in L2: 19 KB on blocks, 155 KB on rows); an
//        index outside [0, N) is an error, as the TPU's copy would fault:
//        it flips nothing and sets the error word that follows the output,
//        which the wrapper reads back and raises on.  Lanes of a warp
//        rarely share a bitmap word (32 random indices over 4,830 or
//        38,634 words), so the atomics are not aggregated.
//     2. compact_kernel: one thread per bitmap word; a warp's inclusive
//        scan of the words' popcounts and one atomicAdd on a counter give
//        each word its place in the list of odd-hit slice numbers.  XOR does
//        not depend on order, so this append needs no global prefix sum.
//     3. xor_gather_kernel over that list.  A slice is S/4 16-byte
//        vectors; a group of S/4 threads owns one slice, one vector each,
//        so a slice is read with coalesced 16-byte loads, and G = 256 /
//        (S/4) groups (at least 1) share the block, group g taking entries
//        g, g+G, g+2G, ... of the block's share.  Each thread keeps NBUF
//        cp.async copies in flight into its own slots of a shared-memory
//        ring of NBUF stages (the counterpart of make_async_copy and its
//        semaphores): it waits for the oldest stage, XORs it into its
//        register accumulator and reuses the slot for the entry NBUF
//        further on.  A thread reads only the slots it wrote, so the ring
//        needs no barrier.  The list's length is known only on the card, so
//        the host launches max(ceil(min(M, N) / CH), one full wave) blocks
//        and each takes an equal share of the list: at most CH entries
//        (min(M, N) bounds the list), and at the probe's CH = 2048 the
//        77,564 entries on blocks fill every SM, not 38 of them.  At
//        the end the groups' accumulators are folded in shared memory and
//        the block's result goes into the zeroed output with atomicXor.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define RB_MAX_NBUF 16
#define RB_MAX_SLICE_VECTORS 1024
#define RB_GROUP_THREADS 256

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void parity_kernel(const int* __restrict__ idx, int M, int N,
                              uint32_t* __restrict__ bitmap, int* __restrict__ bad) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= M) return;
  const int i = __ldg(idx + j);
  if ((unsigned)i < (unsigned)N)
    atomicXor(bitmap + (i >> 5), 1u << (i & 31));
  else
    *bad = 1;
}

__global__ void compact_kernel(const uint32_t* __restrict__ bitmap, int nwords,
                               int* __restrict__ count, int* __restrict__ list) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  uint32_t bits = k < nwords ? bitmap[k] : 0u;
  const int n = __popc(bits);
  int incl = n;  // the warp's inclusive scan of the popcounts
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  int base = 0;
  if (lane == 31 && incl) base = atomicAdd(count, incl);
  int pos = __shfl_sync(0xffffffffu, base, 31) + incl - n;
  while (bits) {
    list[pos++] = (k << 5) | (__ffs(bits) - 1);
    bits &= bits - 1u;
  }
}

template <int NBUF>
__global__ void xor_gather_kernel(const uint4* __restrict__ tab,
                                  const int* __restrict__ list,
                                  const int* __restrict__ count, int S4, int G,
                                  uint32_t* __restrict__ out) {
  extern __shared__ uint4 ring[];  // [NBUF][blockDim.x]
  const int total = *count;
  const int lo = (int)((long long)blockIdx.x * total / gridDim.x);
  const int n = (int)((long long)(blockIdx.x + 1) * total / gridDim.x) - lo;
  if (n == 0) return;  // the whole block
  const int tid = threadIdx.x;
  const int g = tid / S4;
  const int v = tid - g * S4;
  const int* block_list = list + lo;
  const int mine = g < n ? (n - g + G - 1) / G : 0;  // entries of this group
  auto fetch = [&](int t, int slot) {
    const int i = __ldg(block_list + g + t * G);
    cp_async16(&ring[slot * blockDim.x + tid], tab + (size_t)i * S4 + v);
  };
#pragma unroll
  for (int s = 0; s < NBUF; ++s) {
    if (s < mine) fetch(s, s);
    cp_async_commit();
  }
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int base = 0; base < mine; base += NBUF) {
#pragma unroll
    for (int s = 0; s < NBUF; ++s) {
      const int t = base + s;
      if (t < mine) {
        cp_async_wait<NBUF - 1>();  // stage t has landed
        const uint4 x = ring[s * blockDim.x + tid];
        acc.x ^= x.x;
        acc.y ^= x.y;
        acc.z ^= x.z;
        acc.w ^= x.w;
        if (t + NBUF < mine) fetch(t + NBUF, s);
        cp_async_commit();
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  ring[tid] = acc;
  __syncthreads();
  if (g == 0) {
    for (int o = 1; o < G; ++o) {
      const uint4 x = ring[o * S4 + v];
      acc.x ^= x.x;
      acc.y ^= x.y;
      acc.z ^= x.z;
      acc.w ^= x.w;
    }
    uint32_t* dst = out + 4 * v;
    atomicXor(dst + 0, acc.x);
    atomicXor(dst + 1, acc.y);
    atomicXor(dst + 2, acc.z);
    atomicXor(dst + 3, acc.w);
  }
}

template <int NBUF>
cudaError_t launch(const uint4* tab, const int* idx, int N, int M, int CH, int S4,
                   uint32_t* out, int* bad, int* count, uint32_t* bitmap, int* list,
                   cudaStream_t stream) {
  const int G = S4 >= RB_GROUP_THREADS ? 1 : RB_GROUP_THREADS / S4;
  const int threads = G * S4;
  const size_t smem = (size_t)NBUF * threads * sizeof(uint4);
  // everything that can refuse the launch is asked before the first kernel
  cudaError_t err = cudaFuncSetAttribute(
      xor_gather_kernel<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xor_gather_kernel<NBUF>,
                                                           threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int cap = std::min(M, N);  // the odd list is at most this long
  parity_kernel<<<(unsigned)(((long long)M + 255) / 256), 256, 0, stream>>>(idx, M, N, bitmap, bad);
  if ((err = cudaGetLastError()) != cudaSuccess || cap == 0) return err;
  const int nwords = (N + 31) / 32;
  compact_kernel<<<(unsigned)((nwords + 255) / 256), 256, 0, stream>>>(bitmap, nwords, count, list);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long by_ch = ((long long)cap + CH - 1) / CH;
  const long long blocks = std::min((long long)cap, std::max(by_ch, (long long)sms * per_sm));
  xor_gather_kernel<NBUF><<<(unsigned)blocks, threads, smem, stream>>>(tab, list, count, S4, G, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// buf holds S + 2 + ceil(N/32) zeroed words: the S words of the result,
// the error word (set to 1 if an index lies outside [0, N)), the count of
// odd-hit slices, then the parity bitmap.  list holds min(M, N) words,
// the odd-hit slice numbers (need not be zeroed).  The slice is S words, a
// multiple of 4 and at most 4,096; tab is 16-byte aligned; M % CH == 0 and
// M > 0; 1 <= NBUF <= 16, and the ring (NBUF stages of one 16-byte vector
// per thread) must fit a block's shared memory, which cudaFuncSetAttribute
// checks.  Anything else returns an error and launches nothing.
cudaError_t rb_xor_gather(const void* tab, const void* idx, void* buf, void* list, int N,
                          int S, int M, int CH, int NBUF, void* stream) {
  if (S <= 0 || S % 4 || S / 4 > RB_MAX_SLICE_VECTORS || CH <= 0 || M <= 0 ||
      M % CH || N < 0 || NBUF < 1 || NBUF > RB_MAX_NBUF ||
      reinterpret_cast<uintptr_t>(tab) % 16)
    return cudaErrorInvalidValue;
  const uint4* t = static_cast<const uint4*>(tab);
  const int* i = static_cast<const int*>(idx);
  uint32_t* o = static_cast<uint32_t*>(buf);
  int* b = reinterpret_cast<int*>(o + S);
  int* c = b + 1;
  uint32_t* bm = o + S + 2;
  int* l = static_cast<int*>(list);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S4 = S / 4;
  switch (NBUF) {
    case 1: return launch<1>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 2: return launch<2>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 3: return launch<3>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 4: return launch<4>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 5: return launch<5>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 6: return launch<6>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 7: return launch<7>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 8: return launch<8>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 9: return launch<9>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 10: return launch<10>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 11: return launch<11>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 12: return launch<12>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 13: return launch<13>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 14: return launch<14>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 15: return launch<15>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    case 16: return launch<16>(t, i, N, M, CH, S4, o, b, c, bm, l, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
