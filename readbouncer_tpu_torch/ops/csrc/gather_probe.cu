// Kernel K5, the gather probe, for Hopper (sm_90a).
//
// Plain C interface (extern "C", no PyTorch headers), built and bound as
// ops/csrc/ibf_count.cu is (readbouncer_tpu_torch/ops/_build.py).  The entry
// point launches one kernel on the stream it is given, allocates nothing,
// and returns the launch's cudaError_t.
//
// K5  rb_xor_gather — replaces the Pallas kernel
//     scripts/dma_gather_probe.py::_dma_gather_kernel (:59), reached
//     through dma_gather (:106).
//     tab [N, S] uint32 (S = BR*WD words per slice), idx [M] int32, CH, NBUF
//     -> out [S]: the XOR of tab[idx[j]] over every j.  The TPU kernel
//     streams each index's slice from HBM into VMEM through an NBUF-deep
//     ring of async copies and XORs it into an accumulator, CH indices per
//     grid step, the grid in order.  Here each block takes CH consecutive
//     indices.  A slice is S/4 16-byte vectors; a group of S/4 threads owns
//     one slice, one vector each, so a slice is read with coalesced 16-byte
//     loads, and G = 256 / (S/4) groups (at least 1) share the block, group
//     g taking indices g, g+G, g+2G, ... of the block's CH.  Each thread
//     keeps NBUF cp.async copies in flight into its own slots of a
//     shared-memory ring of NBUF stages (the counterpart of
//     make_async_copy and its semaphores): it waits for the oldest stage,
//     XORs it into its register accumulator and reuses the slot for the
//     index NBUF further on.  A thread reads only the slots it wrote, so
//     the ring needs no barrier.  At the end the groups' accumulators are
//     folded in shared memory and the block's result goes into the zeroed
//     output with atomicXor.  XOR does not depend on order, so the result
//     is exact.  An index outside [0, N) is an error, as the TPU's copy
//     would fault: the kernel reads nothing for it and sets the error word
//     that follows the output, which the wrapper reads back and raises on.
//     Bound: bytes.  XOR cancels pairs, so the function needs only the
//     slices hit an odd number of times, each read once (plus idx and the
//     output); chip_smoke.py counts them from the run's idx.  This kernel
//     reads every index's slice, and the L2 cache (50 MB) catches few
//     repeats at the probe's table sizes (633 MB).

#include <cuda_runtime.h>
#include <stdint.h>

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

template <int NBUF>
__global__ void xor_gather_kernel(const uint4* __restrict__ tab,
                                  const int* __restrict__ idx, int N, int CH,
                                  int S4, int G, uint32_t* __restrict__ out,
                                  int* __restrict__ bad) {
  extern __shared__ uint4 ring[];  // [NBUF][blockDim.x]
  const int tid = threadIdx.x;
  const int g = tid / S4;
  const int v = tid - g * S4;
  const int* block_idx = idx + (size_t)blockIdx.x * CH;
  const int mine = g < CH ? (CH - g + G - 1) / G : 0;  // indices of this group
  auto fetch = [&](int t, int slot) {
    const int i = __ldg(block_idx + g + t * G);
    if ((unsigned)i < (unsigned)N)
      cp_async16(&ring[slot * blockDim.x + tid], tab + (size_t)i * S4 + v);
    else {
      ring[slot * blockDim.x + tid] = make_uint4(0u, 0u, 0u, 0u);
      *bad = 1;
    }
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
cudaError_t launch(const uint4* tab, const int* idx, int N, int M, int CH,
                   int S4, uint32_t* out, int* bad, cudaStream_t stream) {
  const int G = S4 >= RB_GROUP_THREADS ? 1 : RB_GROUP_THREADS / S4;
  const int threads = G * S4;
  const size_t smem = (size_t)NBUF * threads * sizeof(uint4);
  cudaError_t err = cudaFuncSetAttribute(
      xor_gather_kernel<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  xor_gather_kernel<NBUF><<<M / CH, threads, smem, stream>>>(tab, idx, N, CH, S4, G, out, bad);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out must hold S + 1 zeroed words: the S words of the result, then the
// error word, set to 1 if an index lies outside [0, N).  The slice is S
// words, a multiple of 4 and at most 4,096; tab is 16-byte aligned;
// M % CH == 0 and M > 0; 1 <= NBUF <= 16, and the ring (NBUF stages of one
// 16-byte vector per thread) must fit a block's shared memory, which
// cudaFuncSetAttribute checks.  Anything else returns cudaErrorInvalidValue
// and launches nothing.
cudaError_t rb_xor_gather(const void* tab, const void* idx, void* out, int N,
                          int S, int M, int CH, int NBUF, void* stream) {
  if (S <= 0 || S % 4 || S / 4 > RB_MAX_SLICE_VECTORS || CH <= 0 || M <= 0 ||
      M % CH || NBUF < 1 || NBUF > RB_MAX_NBUF ||
      reinterpret_cast<uintptr_t>(tab) % 16)
    return cudaErrorInvalidValue;
  const uint4* t = static_cast<const uint4*>(tab);
  const int* i = static_cast<const int*>(idx);
  uint32_t* o = static_cast<uint32_t*>(out);
  int* b = reinterpret_cast<int*>(o + S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S4 = S / 4;
  switch (NBUF) {
    case 1: return launch<1>(t, i, N, M, CH, S4, o, b, s);
    case 2: return launch<2>(t, i, N, M, CH, S4, o, b, s);
    case 3: return launch<3>(t, i, N, M, CH, S4, o, b, s);
    case 4: return launch<4>(t, i, N, M, CH, S4, o, b, s);
    case 5: return launch<5>(t, i, N, M, CH, S4, o, b, s);
    case 6: return launch<6>(t, i, N, M, CH, S4, o, b, s);
    case 7: return launch<7>(t, i, N, M, CH, S4, o, b, s);
    case 8: return launch<8>(t, i, N, M, CH, S4, o, b, s);
    case 9: return launch<9>(t, i, N, M, CH, S4, o, b, s);
    case 10: return launch<10>(t, i, N, M, CH, S4, o, b, s);
    case 11: return launch<11>(t, i, N, M, CH, S4, o, b, s);
    case 12: return launch<12>(t, i, N, M, CH, S4, o, b, s);
    case 13: return launch<13>(t, i, N, M, CH, S4, o, b, s);
    case 14: return launch<14>(t, i, N, M, CH, S4, o, b, s);
    case 15: return launch<15>(t, i, N, M, CH, S4, o, b, s);
    case 16: return launch<16>(t, i, N, M, CH, S4, o, b, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
