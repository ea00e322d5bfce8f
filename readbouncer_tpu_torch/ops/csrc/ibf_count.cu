// Kernels K1, K2 and K4 of the IBF query, for Hopper (sm_90a).
//
// Plain C interface (extern "C", no PyTorch headers): built by nvcc into a
// shared library on first use and bound with ctypes
// (readbouncer_tpu_torch/ops/_build.py).  Each entry point launches one
// kernel on the stream it is given, allocates nothing, and returns the
// launch's cudaError_t.  Words are uint32; the wrappers pass int32 tensors.
//
// K1  rb_accumulate_planes — replaces the Pallas kernel
//     readbouncer_tpu/ops/ibf_count_pallas.py::_planes_kernel (:109),
//     reached through accumulate_planes_pallas (:145).
//     a [R2, n, W] membership words -> planes [R2, P, W]: bit p of plane j
//     of row r2 is bit j of the number of windows i whose word a[r2, i, w]
//     has bit p set (bin w*32+p).  One thread per (r2, w) word column, w
//     fastest so a warp reads neighbouring words of one window row; the P
//     planes live in registers and each window is a bit-sliced increment
//     (carry-ripple over the planes).  Exact while 2^P > n.
//     Bound: memory.  At the phase-A shape (R2=2048, n=238, W=72) it reads
//     ~140 MB and writes ~4.7 MB: a ~43 us floor at 3.35 TB/s; its ~2P bit
//     operations per word read sit below the int32 rate.  A later version
//     fuses the row gather + AND of readbouncer_tpu_torch/ibf/query.py::
//     anded_windows into this loop, so the anded words never reach HBM
//     (that removes the 140 MB write and 140 MB read of `anded`).
//
// K2  rb_planes_dual_max — replaces the Pallas kernel
//     readbouncer_tpu/ops/ibf_count_pallas.py::_dual_max_kernel (:200),
//     reached through planes_dual_max_pallas (:248).
//     planes [2R, P, W] (rows 2r fwd, 2r+1 rc), thresholds thr_b/thr_r [R],
//     declared-bin mask words [W], F word-aligned segments -> mb, mr [R, F]:
//     per filter, the max over declared bins whose fwd or rc count reaches
//     the threshold of max(fwd, rc), 0 if none.  One warp per read, lane p
//     owns bit p of each word: it rebuilds the two counts of bin w*32+p from
//     the planes (a broadcast load per plane word), applies both
//     thresholds, and the warp reduces each segment's max with shuffles.
//     Bound: memory.  At the phase-A shape (R=1024, P=8, W=72) the
//     function moves ~4.7 MB (planes, thresholds, mask; mb and mr): ~1.4 us
//     at 3.35 TB/s.  Bit-sliced comparators would test 32 bins per word op,
//     ~9 M int32 ops, far below the int32 rate.  This kernel instead
//     rebuilds each declared bin's two counts bit by bit (~6 ops per plane
//     per strand, ~118 M ops), so it runs well above that bound; a later
//     version compares the bit-sliced counts with the thresholds 32 bins
//     at a time instead of expanding every bin.
//
// K4  rb_accumulate_counts — replaces the Pallas kernel
//     readbouncer_tpu/ops/ibf_count_pallas.py::_count_kernel (:62),
//     reached through accumulate_counts_pallas (:326): the v1 per-bin
//     count accumulation.  a_t [W, n_pad, R2] membership words (read-strand
//     q on the fastest axis, padded windows zero) -> counts [W, 32, R2]
//     int32: counts[w, p, q] is the number of windows i whose word
//     a_t[w, i, q] has bit p set (bin w*32+p of read-strand q).  One thread
//     per (w, q) column, q fastest so a warp's loads of one window row are
//     coalesced; 32 int32 counters in registers; a loop over the windows;
//     32 coalesced stores.  The TPU kernel's (wb, wcb, r2b) blocks carried
//     the sum in VMEM across a sequential window grid axis; here the
//     window loop inside the thread takes that place.
//     Bound: at the profile_realistic shape (W=72, n_pad=256, R2=4096) it
//     reads 302 MB and writes 37.7 MB, a 0.101 ms floor at 3.35 TB/s; the
//     least integer work (a bit-sliced carry-save add per word, as K1
//     does, then one expansion) is ~0.3 G ops, far below the int32 rate,
//     so bytes bound it.  This kernel's source does a shift, a mask and
//     an add per bit (~96 ops per word, ~7 G at this shape) and it runs
//     several times its bound; what limits it is not measured (the
//     instructions the compiler emits were not counted).  A later version
//     counts bit-sliced, as K1 does, and expands once.

#include <cuda_runtime.h>
#include <stdint.h>

#define RB_MAX_PLANES 16
#define RB_MAX_SEGMENTS 32

namespace {

template <int P>
__global__ void accumulate_planes_kernel(const uint32_t* __restrict__ a,
                                         uint32_t* __restrict__ out, int R2,
                                         int n, int W) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)R2 * W) return;
  const int r2 = (int)(idx / W);
  const int w = (int)(idx - (long long)r2 * W);
  const uint32_t* src = a + (size_t)r2 * n * W + w;
  uint32_t p[P];
#pragma unroll
  for (int j = 0; j < P; ++j) p[j] = 0u;
  for (int i = 0; i < n; ++i) {
    uint32_t c = __ldg(src + (size_t)i * W);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const uint32_t t = p[j] & c;
      p[j] ^= c;
      c = t;
    }
  }
  uint32_t* dst = out + (size_t)r2 * P * W + w;
#pragma unroll
  for (int j = 0; j < P; ++j) dst[(size_t)j * W] = p[j];
}

template <int P>
cudaError_t launch_accumulate(const uint32_t* a, uint32_t* out, int R2, int n,
                              int W, cudaStream_t stream) {
  const int threads = 256;
  const long long total = (long long)R2 * W;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  accumulate_planes_kernel<P><<<blocks, threads, 0, stream>>>(a, out, R2, n, W);
  return cudaGetLastError();
}

__global__ void accumulate_counts_kernel(const uint32_t* __restrict__ a,
                                         int* __restrict__ out, int W,
                                         int n_pad, int R2) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)W * R2) return;
  const int w = (int)(idx / R2);
  const int q = (int)(idx - (long long)w * R2);
  const uint32_t* src = a + (size_t)w * n_pad * R2 + q;
  int c[32];
#pragma unroll
  for (int p = 0; p < 32; ++p) c[p] = 0;
#pragma unroll 4
  for (int i = 0; i < n_pad; ++i) {
    const uint32_t x = __ldg(src + (size_t)i * R2);
#pragma unroll
    for (int p = 0; p < 32; ++p) c[p] += (int)((x >> p) & 1u);
  }
  int* dst = out + (size_t)w * 32 * R2 + q;
#pragma unroll
  for (int p = 0; p < 32; ++p) dst[(size_t)p * R2] = c[p];
}

struct SegTable {
  int w0[RB_MAX_SEGMENTS];
  int nw[RB_MAX_SEGMENTS];
};

__global__ void planes_dual_max_kernel(const uint32_t* __restrict__ planes,
                                       const int* __restrict__ thr_b,
                                       const int* __restrict__ thr_r,
                                       const uint32_t* __restrict__ mask,
                                       SegTable seg, int F, int* __restrict__ mb,
                                       int* __restrict__ mr, int R, int P,
                                       int W) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= R) return;  // whole warps leave together
  const uint32_t* pf = planes + (size_t)(2 * r) * P * W;
  const uint32_t* pr = pf + (size_t)P * W;
  const int tb = thr_b[r];
  const int tr = thr_r[r];
  for (int f = 0; f < F; ++f) {
    int best_b = 0, best_r = 0;
    const int w_end = seg.w0[f] + seg.nw[f];
    for (int w = seg.w0[f]; w < w_end; ++w) {
      if (!((__ldg(mask + w) >> lane) & 1u)) continue;
      int cf = 0, cr = 0;
      for (int j = 0; j < P; ++j) {
        cf |= (int)((__ldg(pf + (size_t)j * W + w) >> lane) & 1u) << j;
        cr |= (int)((__ldg(pr + (size_t)j * W + w) >> lane) & 1u) << j;
      }
      const int mx = max(cf, cr);
      if (cf >= tb || cr >= tb) best_b = max(best_b, mx);
      if (cf >= tr || cr >= tr) best_r = max(best_r, mx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      best_b = max(best_b, __shfl_xor_sync(0xffffffffu, best_b, o));
      best_r = max(best_r, __shfl_xor_sync(0xffffffffu, best_r, o));
    }
    if (lane == 0) {
      mb[(size_t)r * F + f] = best_b;
      mr[(size_t)r * F + f] = best_r;
    }
  }
}

}  // namespace

extern "C" {

cudaError_t rb_accumulate_planes(const void* a, void* out, int R2, int n, int W,
                                 int P, void* stream) {
  const uint32_t* src = static_cast<const uint32_t*>(a);
  uint32_t* dst = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch_accumulate<1>(src, dst, R2, n, W, s);
    case 2: return launch_accumulate<2>(src, dst, R2, n, W, s);
    case 3: return launch_accumulate<3>(src, dst, R2, n, W, s);
    case 4: return launch_accumulate<4>(src, dst, R2, n, W, s);
    case 5: return launch_accumulate<5>(src, dst, R2, n, W, s);
    case 6: return launch_accumulate<6>(src, dst, R2, n, W, s);
    case 7: return launch_accumulate<7>(src, dst, R2, n, W, s);
    case 8: return launch_accumulate<8>(src, dst, R2, n, W, s);
    case 9: return launch_accumulate<9>(src, dst, R2, n, W, s);
    case 10: return launch_accumulate<10>(src, dst, R2, n, W, s);
    case 11: return launch_accumulate<11>(src, dst, R2, n, W, s);
    case 12: return launch_accumulate<12>(src, dst, R2, n, W, s);
    case 13: return launch_accumulate<13>(src, dst, R2, n, W, s);
    case 14: return launch_accumulate<14>(src, dst, R2, n, W, s);
    case 15: return launch_accumulate<15>(src, dst, R2, n, W, s);
    case 16: return launch_accumulate<16>(src, dst, R2, n, W, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t rb_planes_dual_max(const void* planes, const void* thr_b,
                               const void* thr_r, const void* mask_words,
                               const void* seg_words, int F, void* mb, void* mr,
                               int R, int P, int W, void* stream) {
  if (F < 1 || F > RB_MAX_SEGMENTS || P < 1 || P > RB_MAX_PLANES)
    return cudaErrorInvalidValue;
  SegTable seg;
  const int* table = static_cast<const int*>(seg_words);  // host: (w0, nw) pairs
  for (int f = 0; f < F; ++f) {
    seg.w0[f] = table[2 * f];
    seg.nw[f] = table[2 * f + 1];
  }
  const int warps = 4;
  const unsigned blocks = (unsigned)((R + warps - 1) / warps);
  planes_dual_max_kernel<<<blocks, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<const int*>(thr_b),
      static_cast<const int*>(thr_r), static_cast<const uint32_t*>(mask_words),
      seg, F, static_cast<int*>(mb), static_cast<int*>(mr), R, P, W);
  return cudaGetLastError();
}

cudaError_t rb_accumulate_counts(const void* a_t, void* out, int W, int n_pad,
                                 int R2, void* stream) {
  const int threads = 256;
  const long long total = (long long)W * R2;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  accumulate_counts_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a_t), static_cast<int*>(out), W, n_pad, R2);
  return cudaGetLastError();
}

const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
