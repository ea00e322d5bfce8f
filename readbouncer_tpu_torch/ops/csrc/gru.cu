// Kernel K3 of the basecaller: one GRU layer's recurrence, for Hopper (sm_90a).
//
// Plain C interface (extern "C", no PyTorch headers): built by nvcc into a
// shared library on first use and bound with ctypes
// (readbouncer_tpu_torch/ops/_build.py).  The entry point launches one
// kernel on the stream it is given, allocates nothing, and returns the
// launch's cudaError_t.
//
// K3  rb_gru_layer — replaces the Pallas kernel
//     readbouncer_tpu/ops/gru_pallas.py::_gru_kernel (:38), reached through
//     gru_layer_pallas (:76) and gru_logits_pallas (:128).
//     xg [B, T, 3H] f32 (the input-side gate terms x @ w_zrn + b_zrn, in
//     z, r, n order), r_zr [H, 2H], b_hzr [2H], rn [H, H], bhn [H] ->
//     ys [B, T, H] f32, the reset-after GRU with h_0 = 0:
//         z  = sigmoid(xg_z[t] + (h @ Rz + bhz))
//         r  = sigmoid(xg_r[t] + (h @ Rr + bhr))
//         n  = tanh(xg_n[t] + r * (h @ Rn + bhn))
//         h' = (1 - z) * n + z * h,   ys[:, t] = h'
//     With reverse != 0 the scan runs from t = T-1 down to 0 and ys[:, t]
//     is still the state after step t: the same as flipping xg in time,
//     scanning forwards and flipping ys back (the odd layers of the net).
//
//     Design.  One block owns `rows` batch rows for the whole sequence and
//     runs the time loop inside; thread (row, j) owns hidden unit j of one
//     row.  The recurrent weights sit in shared memory as one [H, 3H]
//     matrix (row k = [Rz[k] | Rr[k] | Rn[k]]), so at each step thread j
//     reads column j of the three gates (consecutive j: consecutive banks)
//     and the row's h[k] (a broadcast).  h is double-buffered in shared
//     memory: each step reads one buffer, writes the other, and ends in
//     one __syncthreads.  xg is read straight from its [B, T, 3H] layout
//     by stride, one step ahead of its use, and ys is written as each
//     step ends; neither needs a copy to a time-major layout.  `rows` is
//     chosen so that the grid covers the SMs where B allows.  H up to 96
//     (111 KB of weights) needs dynamic shared memory above 48 KB.
//     Accurate expf / tanhf (no fast math).
//
//     Bound.  The function must read xg and write ys once, 16 B per (b, t,
//     unit): 63 MB at B=256, T=320, H=48, ~19 us at 3.35 TB/s; its
//     6 B T H^2 flops (1.1 GFLOP) take ~17 us at 67 TFLOP/s fp32.  The
//     kernel is held back by neither: its T steps are serial, and each is
//     a chain of H dependent shared-memory FMAs per gate, the gate math and
//     a barrier, on a few warps per SM.  A later version spreads a step's
//     dot products over more threads (or wgmma over a wider batch tile) to
//     shorten that chain.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void gru_layer_kernel(const float* __restrict__ xg, const float* __restrict__ r_zr,
                                 const float* __restrict__ b_hzr, const float* __restrict__ rn,
                                 const float* __restrict__ bhn, float* __restrict__ ys, int B,
                                 int T, int H, int rows, int reverse) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  float* w = smem;                  // [H, 3H]
  float* hbuf = smem + H * G;       // [2, rows, H]
  const int tid = threadIdx.x;
  for (int i = tid; i < H * G; i += blockDim.x) {
    const int k = i / G, c = i - k * G;
    w[i] = c < 2 * H ? r_zr[k * 2 * H + c] : rn[k * H + (c - 2 * H)];
  }
  for (int i = tid; i < 2 * rows * H; i += blockDim.x) hbuf[i] = 0.0f;
  const int lr = tid / H, j = tid - lr * H;
  const int b = blockIdx.x * rows + lr;
  const bool active = b < B;  // rows past B still take part in the barriers
  const float bz = b_hzr[j], br = b_hzr[H + j], bn = bhn[j];
  const float* xrow = xg + (size_t)(active ? b : 0) * T * G;
  float* yrow = ys + (size_t)(active ? b : 0) * T * H;
  const int t0 = reverse ? T - 1 : 0;
  const int dt = reverse ? -1 : 1;
  float xz = 0.0f, xr = 0.0f, xn = 0.0f;
  if (active) {
    const float* p = xrow + (size_t)t0 * G;
    xz = p[j];
    xr = p[H + j];
    xn = p[2 * H + j];
  }
  float h = 0.0f;
  __syncthreads();
  for (int s = 0; s < T; ++s) {
    const int t = t0 + s * dt;
    const float* hc = hbuf + (s & 1) * rows * H + lr * H;
    float* hw = hbuf + ((s + 1) & 1) * rows * H + lr * H;
    float nz = 0.0f, nr = 0.0f, nn = 0.0f;
    if (active && s + 1 < T) {  // next step's gate inputs, in flight during the dots
      const float* p = xrow + (size_t)(t + dt) * G;
      nz = p[j];
      nr = p[H + j];
      nn = p[2 * H + j];
    }
    float az = 0.0f, ar = 0.0f, an = 0.0f;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float hk = hc[k];
      const float* wk = w + k * G;
      az = fmaf(hk, wk[j], az);
      ar = fmaf(hk, wk[H + j], ar);
      an = fmaf(hk, wk[2 * H + j], an);
    }
    const float z = sigmoidf_(xz + (az + bz));
    const float r = sigmoidf_(xr + (ar + br));
    const float n = tanhf(xn + r * (an + bn));
    h = (1.0f - z) * n + z * h;
    hw[j] = h;
    if (active) yrow[(size_t)t * H + j] = h;
    xz = nz;
    xr = nr;
    xn = nn;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Batch rows per block: enough blocks to cover the SMs where B allows,
// and no more rows than the block's thread and shared-memory limits take.
int rb_gru_rows(int B, int H) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int rows = (B + sms - 1) / sms;
  const int max_rows = 1024 / H;
  if (rows > max_rows) rows = max_rows;
  return rows < 1 ? 1 : rows;
}

int rb_gru_layer(const void* xg, const void* r_zr, const void* b_hzr, const void* rn,
                 const void* bhn, void* ys, int B, int T, int H, int reverse, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (H <= 0 || H > 1024) return cudaErrorInvalidValue;
  const int rows = rb_gru_rows(B, H);
  const size_t smem = (size_t)(3 * H * H + 2 * rows * H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gru_layer_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + rows - 1) / rows;
  gru_layer_kernel<<<grid, rows * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xg), static_cast<const float*>(r_zr),
      static_cast<const float*>(b_hzr), static_cast<const float*>(rn),
      static_cast<const float*>(bhn), static_cast<float*>(ys), B, T, H, rows, reverse);
  return cudaGetLastError();
}

const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
