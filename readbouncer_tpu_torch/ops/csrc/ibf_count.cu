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
//     the threshold of max(fwd, rc), 0 if none.
//     Design: bit-sliced, 32 bins per word operation, never expanding a
//     count.  One warp per (read, segment); lane l owns word w0 + l (and
//     + 32 per further pass of a segment longer than 32 words).  The kernel
//     is a template on P, so a lane's 2P plane words and its mask word are
//     loaded into registers by independent loads, coalesced across lanes,
//     all in flight at once.  Per word: sel = the bins where fwd >= rc, an
//     MSB-first bit-sliced comparator of the two P-bit numbers, and mx_j =
//     (f_j & sel) | (r_j & ~sel); per threshold t, ge_f and ge_r from a
//     bit-sliced comparison with the scalar t (every bin for t <= 0, none
//     for t >= 2^P), M = mask & (ge_f | ge_r); then the segment's max of mx
//     over M, MSB first: for j = P-1..0, c = M & mx_j, and where any lane's
//     c is nonzero (__any_sync) M = c and bit j of the result is set.  No
//     matched bin, or only bins of count 0, gives 0.  Per lane that is 2P+1
//     loads, ~10P word operations and 2P warp votes per pass.
//     Bound: memory.  At the phase-A shape (R=1024, P=8, W=72) the
//     function moves ~4.7 MB (planes, thresholds, mask; mb and mr): ~1.4 us
//     at 3.35 TB/s; its ~9 M bit-sliced word operations sit far below the
//     int32 rate.  That bound lies below the cost of one launch (a few
//     microseconds), so this kernel, now about as short as its launch,
//     still reads below half of it; fusing it into K1's epilogue, so that
//     it needs no launch of its own, is what would close the gap.
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
#define RB_DUAL_MAX_WARPS 8  // K2: warps per block, one per (read, segment)

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

// bins (bits) where the P-bit bit-sliced number x is >= the scalar t
template <int P>
__device__ __forceinline__ uint32_t ge_scalar(const uint32_t (&x)[P], int t) {
  if (t <= 0) return ~0u;
  if (t >= (1 << P)) return 0u;
  uint32_t gt = 0u, eq = ~0u;
#pragma unroll
  for (int j = P - 1; j >= 0; --j) {
    const uint32_t tj = ((t >> j) & 1) ? ~0u : 0u;
    gt |= eq & x[j] & ~tj;
    eq &= ~(x[j] ^ tj);
  }
  return gt | eq;
}

template <int P>
__global__ void __launch_bounds__(RB_DUAL_MAX_WARPS * 32, 4)  // <= 64 registers: 32 warps an SM
planes_dual_max_kernel(const uint32_t* __restrict__ planes, const int* __restrict__ thr_b,
                       const int* __restrict__ thr_r, const uint32_t* __restrict__ mask,
                       SegTable seg, int F, int* __restrict__ mb, int* __restrict__ mr, int R,
                       int W) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= (long long)R * F) return;  // whole warps leave together
  const int r = (int)(g / F);
  const int f = (int)(g - (long long)r * F);
  const uint32_t* pf = planes + (size_t)(2 * r) * P * W;
  const uint32_t* pr = pf + (size_t)P * W;
  const int tb = thr_b[r];
  const int tr = thr_r[r];
  const int w0 = seg.w0[f], nw = seg.nw[f];
  int best_b = 0, best_r = 0;
  for (int base = 0; base < nw; base += 32) {  // the same trip count on every lane
    const bool in = base + lane < nw;
    const int w = w0 + base + lane;
    uint32_t fw[P], rw[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      fw[j] = in ? __ldg(pf + (size_t)j * W + w) : 0u;
      rw[j] = in ? __ldg(pr + (size_t)j * W + w) : 0u;
    }
    const uint32_t m = in ? __ldg(mask + w) : 0u;
    // the declared bins whose fwd or rc count reaches each threshold
    uint32_t mb_bins = m & (ge_scalar<P>(fw, tb) | ge_scalar<P>(rw, tb));
    uint32_t mr_bins = m & (ge_scalar<P>(fw, tr) | ge_scalar<P>(rw, tr));
    uint32_t gt = 0u, eq = ~0u;  // fwd > rc, fwd == rc so far, MSB first
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      gt |= eq & fw[j] & ~rw[j];
      eq &= ~(fw[j] ^ rw[j]);
    }
    const uint32_t sel = gt | eq;  // fwd >= rc
#pragma unroll
    for (int j = 0; j < P; ++j) fw[j] = (fw[j] & sel) | (rw[j] & ~sel);  // now max(fwd, rc)
    // the warp's max over each bin set, MSB first: keep the bins that have
    // bit j wherever any lane has one; both thresholds in one pass
    int pass_b = 0, pass_r = 0;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const uint32_t cb = mb_bins & fw[j];
      const uint32_t cr = mr_bins & fw[j];
      if (__any_sync(0xffffffffu, cb != 0u)) {
        mb_bins = cb;
        pass_b |= 1 << j;
      }
      if (__any_sync(0xffffffffu, cr != 0u)) {
        mr_bins = cr;
        pass_r |= 1 << j;
      }
    }
    best_b = max(best_b, pass_b);
    best_r = max(best_r, pass_r);
  }
  if (lane == 0) {
    mb[(size_t)r * F + f] = best_b;
    mr[(size_t)r * F + f] = best_r;
  }
}

template <int P>
cudaError_t launch_dual_max(const uint32_t* planes, const int* thr_b, const int* thr_r,
                            const uint32_t* mask, const SegTable& seg, int F, int* mb,
                            int* mr, int R, int W, cudaStream_t stream) {
  const int warps = RB_DUAL_MAX_WARPS;
  const long long total = (long long)R * F;
  const unsigned blocks = (unsigned)((total + warps - 1) / warps);
  planes_dual_max_kernel<P><<<blocks, warps * 32, 0, stream>>>(planes, thr_b, thr_r, mask, seg,
                                                               F, mb, mr, R, W);
  return cudaGetLastError();
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
  const uint32_t* pl = static_cast<const uint32_t*>(planes);
  const int* tb = static_cast<const int*>(thr_b);
  const int* tr = static_cast<const int*>(thr_r);
  const uint32_t* mw = static_cast<const uint32_t*>(mask_words);
  int* ob = static_cast<int*>(mb);
  int* orr = static_cast<int*>(mr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch_dual_max<1>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 2: return launch_dual_max<2>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 3: return launch_dual_max<3>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 4: return launch_dual_max<4>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 5: return launch_dual_max<5>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 6: return launch_dual_max<6>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 7: return launch_dual_max<7>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 8: return launch_dual_max<8>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 9: return launch_dual_max<9>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 10: return launch_dual_max<10>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 11: return launch_dual_max<11>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 12: return launch_dual_max<12>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 13: return launch_dual_max<13>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 14: return launch_dual_max<14>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 15: return launch_dual_max<15>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    case 16: return launch_dual_max<16>(pl, tb, tr, mw, seg, F, ob, orr, R, W, s);
    default: return cudaErrorInvalidValue;
  }
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
