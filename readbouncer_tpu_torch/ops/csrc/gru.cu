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
//     Bound.  The function must read xg and write ys once, 16 B per (b, t,
//     unit): 63 MB at B=256, T=320, H=48, ~19 us at 3.35 TB/s; its
//     6 B T H^2 flops take ~17 us at 67 TFLOP/s fp32 (at H=96, ~69 us,
//     the flops bound it).  Neither is what limits a kernel of this
//     function: its T steps are serial, and at B=256 a step has 2 batch
//     rows per SM.  Each step is a chain: h from shared memory, the dot
//     products, their reduction, the gate math, h' back to shared memory,
//     a barrier.  Its length in cycles, and the instructions the few warps
//     of an SM issue in it, set the time.
//
//     Design.  One block of H*S threads (S slices, rounded up to whole
//     warps) owns ROWS batch rows for the whole sequence and runs the time
//     loop inside.  Thread (j, s) owns hidden unit j and the slice of k
//     whose float4 chunks are s, s+S, s+2S, ...: it loads its 3 * 4 * NC
//     weights Rz[k, j], Rr[k, j], Rn[k, j] into registers once (NC =
//     ceil(H / 4S) chunks, zero past H; 72 registers at H=48 and at H=96)
//     and reuses them for every row and step.  A step, per row of the
//     block: NC float4 loads of the row's h from shared memory (the S
//     slices read neighbouring 16-byte chunks, the units of one slice the
//     same ones: broadcasts, no bank conflict), two FMA chains per gate
//     (even and odd chunks), and __shfl_xor_sync over the S lanes of the
//     unit, which leaves every lane the full sums.  With S = 2 the sums
//     are formed in the order four lanes of one chain each would form
//     them.  That order buys no accuracy: on the H100, against the
//     forward in float64, the logits are 1.49e-4 off with it, 1.36e-4
//     with the order of S = 4 (a0 + a1, then the shuffles) and 1.62e-4
//     through the plain float32 forward (chip_smoke.py).  It is kept
//     because the forward's gate holds the logits within 1e-4 of the
//     plain float32 forward, and the S = 4 order lands 1.01e-4 from it.
//     Lane s then does the gate math of rows s, s+S, ... (accurate expf /
//     tanhf, no fast math), keeps that row's h_j in a register, writes h'
//     to the other half of a double buffer in shared memory and to ys,
//     coalesced across j.  One __syncthreads ends the step.  xg is read straight from its
//     [B, T, 3H] layout: each lane copies its rows' three gate inputs with
//     4-byte cp.async into a ring of D = 8 steps in shared memory (4 where
//     8 would pass 48 KB), D - 1 steps ahead of their use, and waits only
//     for its own copies.  A load into registers one step ahead would make
//     a short step (H=48) wait for it.
//
//     Configuration (rb_gru_config).  S = 2 for H <= 48, else 4: at B=256
//     and H=48 this gives 3 warps per SM, one per scheduler, each lane
//     doing one row's gate math; S = 4 there doubles the warps and the
//     shuffle rounds, and S = 2 at H=96 would need 144 weight registers a
//     thread.  ROWS is the least of 1, 2, 4, 8 that is
//     at least min(S, ceil(B / SMs)) and lets every block be resident at
//     once (the occupancy query: registers); at B=256 that is 2, at B=512
//     it is 2 for H=48 (two blocks per SM) and 4 for H=96.  Of the layouts
//     with S = 1, 2, 4, 8 and ROWS = 1 to 4 tried on the H100, these were
//     the fastest (PERF.md, §6).  chip_smoke prints the launch, and
//     registers and local memory per thread (no spill).
//
//     No tensor cores: mma / wgmma need 16- or 64-row tiles, and B=256
//     over 132 SMs is 2 rows each; TF32 would also break the reference's
//     float32 precision="highest".

#include <cuda_runtime.h>

namespace {

constexpr int kMaxHidden = 96;
constexpr int kRowChoices = 4;  // ROWS = 1, 2, 4, 8
constexpr int kDepth = 8;       // ring depth in steps
constexpr int kStaticShared = 48 * 1024;  // the most static shared memory a block may have

// Ring depth for ROWS * HP floats of h per buffer: kDepth steps where the
// ring (3 gates) and the double buffer of h fit the static limit, else 4.
__host__ __device__ constexpr int ring_depth(int row_floats) {
  return (kDepth * 3 + 2) * row_floats * 4 <= kStaticShared ? kDepth : 4;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// 4-byte asynchronous copy global -> shared (cp.async) to a shared-space
// address; a thread waits (cp.async.wait_group) only for its own copies
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

template <int S, int NC, int ROWS>
__global__ void __launch_bounds__((4 * NC * S * S + 31) / 32 * 32)
gru_layer_kernel(const float* __restrict__ xg, const float* __restrict__ r_zr,
                 const float* __restrict__ b_hzr, const float* __restrict__ rn,
                 const float* __restrict__ bhn, float* __restrict__ ys, int B, int T,
                 int H, int reverse) {
  constexpr int K4 = NC * S;               // float4 chunks of one row's padded h
  constexpr int HP = 4 * K4;               // padded h length
  constexpr int OWN = (ROWS + S - 1) / S;  // rows whose gate math one lane does
  constexpr int D = ring_depth(ROWS * HP);
  constexpr int SLOT = ROWS * 3 * HP;      // floats per ring slot
  __shared__ float4 hbuf[2][ROWS][K4];
  __shared__ float xq[D][ROWS][3][HP];
  const int tid = threadIdx.x;
  const int s = tid % S, j = tid / S;
  const bool unit = j < H;  // lanes past H (whole slice groups) pad the last warp
  const int G = 3 * H;

  float wz[4 * NC], wr[4 * NC], wn[4 * NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * (c * S + s) + e;
      const bool in = unit && k < H;
      wz[4 * c + e] = in ? r_zr[k * 2 * H + j] : 0.0f;
      wr[4 * c + e] = in ? r_zr[k * 2 * H + H + j] : 0.0f;
      wn[4 * c + e] = in ? rn[k * H + j] : 0.0f;
    }
  }
  const float bz = unit ? b_hzr[j] : 0.0f;
  const float br = unit ? b_hzr[H + j] : 0.0f;
  const float bn = unit ? bhn[j] : 0.0f;
  {
    float* hf = reinterpret_cast<float*>(&hbuf[0][0][0]);
    for (int i = tid; i < 2 * ROWS * HP; i += blockDim.x) hf[i] = 0.0f;
    float* xf = &xq[0][0][0][0];
    for (int i = tid; i < D * SLOT; i += blockDim.x) xf[i] = 0.0f;
  }

  const int t0 = reverse ? T - 1 : 0;
  const int dt = reverse ? -1 : 1;
  // this lane's own rows: s, s + S, ... of the block
  bool live[OWN];
  const float* xrow[OWN];
  float* yrow[OWN];
  const float* qp[OWN];  // its ring entries (slot 0); lanes without a row read row 0's
  unsigned qa[OWN];      // the same as a shared-space address, for cp.async
  float h[OWN];
#pragma unroll
  for (int i = 0; i < OWN; ++i) {
    const int b = blockIdx.x * ROWS + s + S * i;
    live[i] = unit && s + S * i < ROWS && b < B;
    xrow[i] = xg + (live[i] ? (size_t)b * T * G + j : 0);
    yrow[i] = ys + (live[i] ? (size_t)b * T * H + j : 0);
    qp[i] = &xq[0][live[i] ? s + S * i : 0][0][unit ? j : 0];
    qa[i] = static_cast<unsigned>(__cvta_generic_to_shared(qp[i]));
    h[i] = 0.0f;
  }
  __syncthreads();  // the zeroed ring before any copy into it

  // the own rows' gate inputs of step `step`, into ring slot step % D
  auto fetch = [&](int step) {
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      if (live[i] && step < T) {
        const float* p = xrow[i] + (size_t)(t0 + step * dt) * G;
        const unsigned q = qa[i] + (step % D) * SLOT * 4;
        cp_async4(q, p);
        cp_async4(q + 4 * HP, p + H);
        cp_async4(q + 8 * HP, p + 2 * H);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // empty past T
  };
  for (int d = 0; d + 1 < D; ++d) fetch(d);

  for (int step = 0; step < T; ++step) {
    const int t = t0 + step * dt;
    const int cur = step & 1;
    fetch(step + D - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(D - 1) : "memory");
    float cz[OWN], cr[OWN], cn[OWN];  // this step's gate inputs
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const float* q = qp[i] + (step % D) * SLOT;
      cz[i] = q[0];
      cr[i] = q[HP];
      cn[i] = q[2 * HP];
    }
    // Each lane sums its chunks in two chains, even and odd c, and the
    // chains of the unit's lanes meet in a tree.  With S = 2 it is the
    // tree (v0 + v1) + (v2 + v3) over the chunk classes v_m (q = c*S + s,
    // m = q mod 4) that four lanes of one chain each would form (header).
    float az[ROWS], ar[ROWS], an[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float a[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 hv = hbuf[cur][r][c * S + s];
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
        float* p = a[c & 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[0] = fmaf(hk[e], wz[4 * c + e], p[0]);
          p[1] = fmaf(hk[e], wr[4 * c + e], p[1]);
          p[2] = fmaf(hk[e], wn[4 * c + e], p[2]);
        }
      }
      float v[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        if (S == 2) {
          v[g] = (a[0][g] + __shfl_xor_sync(0xffffffffu, a[0][g], 1)) +
                 (a[1][g] + __shfl_xor_sync(0xffffffffu, a[1][g], 1));
        } else {
          v[g] = a[0][g] + a[1][g];
#pragma unroll
          for (int o = 1; o < S; o <<= 1) v[g] += __shfl_xor_sync(0xffffffffu, v[g], o);
        }
      }
      az[r] = v[0];
      ar[r] = v[1];
      an[r] = v[2];
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      // row s + S*i's sums, picked by predicated moves (no register indexing)
      float sz = 0.0f, sr = 0.0f, sn = 0.0f;
#pragma unroll
      for (int r = S * i; r < ROWS && r < S * (i + 1); ++r) {
        if (r - S * i == s) {
          sz = az[r];
          sr = ar[r];
          sn = an[r];
        }
      }
      const float z = sigmoidf_(cz[i] + (sz + bz));
      const float rg = sigmoidf_(cr[i] + (sr + br));
      const float n = tanhf(cn[i] + rg * (sn + bn));
      h[i] = (1.0f - z) * n + z * h[i];
      const int lr = s + S * i;
      if (unit && lr < ROWS) reinterpret_cast<float*>(&hbuf[cur ^ 1][lr][0])[j] = h[i];
      if (live[i]) yrow[i][(size_t)t * H] = h[i];
    }
    __syncthreads();
  }
}

typedef void (*GruKernel)(const float*, const float*, const float*, const float*,
                          const float*, float*, int, int, int, int);

template <int S, int NC>
GruKernel kernel_for_rows(int row_choice) {
  switch (row_choice) {
    case 0: return gru_layer_kernel<S, NC, 1>;
    case 1: return gru_layer_kernel<S, NC, 2>;
    case 2: return gru_layer_kernel<S, NC, 4>;
    default: return gru_layer_kernel<S, NC, 8>;
  }
}

// S = 2 for H <= 48 (NC = 1..6), S = 4 above (NC = 4..6)
GruKernel kernel_for(int slices, int nc, int row_choice) {
  if (slices == 2) {
    switch (nc) {
      case 1: return kernel_for_rows<2, 1>(row_choice);
      case 2: return kernel_for_rows<2, 2>(row_choice);
      case 3: return kernel_for_rows<2, 3>(row_choice);
      case 4: return kernel_for_rows<2, 4>(row_choice);
      case 5: return kernel_for_rows<2, 5>(row_choice);
      default: return kernel_for_rows<2, 6>(row_choice);
    }
  }
  switch (nc) {
    case 4: return kernel_for_rows<4, 4>(row_choice);
    case 5: return kernel_for_rows<4, 5>(row_choice);
    default: return kernel_for_rows<4, 6>(row_choice);
  }
}

struct GruLaunch {
  GruKernel fn;
  int rows, slices, threads, grid, nc, per_sm;
};

// The launch for (B, H) (see Configuration above), from the SM count and
// the occupancy query, asked at every launch.
cudaError_t pick_launch(int B, int H, GruLaunch* out) {
  if (H <= 0 || H > kMaxHidden || B <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  out->slices = H <= 48 ? 2 : 4;
  out->nc = (H + 4 * out->slices - 1) / (4 * out->slices);
  out->threads = (H * out->slices + 31) / 32 * 32;
  int want = (B + sms - 1) / sms;
  if (want > out->slices) want = out->slices;
  int choice = 0;
  while (choice + 1 < kRowChoices && (1 << choice) < want) ++choice;
  for (;; ++choice) {
    out->fn = kernel_for(out->slices, out->nc, choice);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out->per_sm, reinterpret_cast<const void*>(out->fn), out->threads, 0);
    if (err != cudaSuccess) return err;
    out->rows = 1 << choice;
    out->grid = (B + out->rows - 1) / out->rows;
    if (out->grid <= sms * out->per_sm || choice + 1 == kRowChoices) break;
  }
  return out->per_sm < 1 ? cudaErrorLaunchOutOfResources : cudaSuccess;
}

}  // namespace

extern "C" {

// The launch rb_gru_layer makes for (B, H), into cfg[0..8]: batch rows per
// block, slices S, threads per block, blocks, float4 chunks NC per slice,
// registers per thread, local memory bytes per thread, static shared
// memory bytes per block, blocks that fit one SM.
int rb_gru_config(int B, int H, void* cfg) {
  GruLaunch l;
  cudaError_t err = pick_launch(B, H, &l);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(l.fn));
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(cfg);
  o[0] = l.rows;
  o[1] = l.slices;
  o[2] = l.threads;
  o[3] = l.grid;
  o[4] = l.nc;
  o[5] = attr.numRegs;
  o[6] = (int)attr.localSizeBytes;
  o[7] = (int)attr.sharedSizeBytes;
  o[8] = l.per_sm;
  return cudaSuccess;
}

int rb_gru_layer(const void* xg, const void* r_zr, const void* b_hzr, const void* rn,
                 const void* bhn, void* ys, int B, int T, int H, int reverse, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  GruLaunch l;
  cudaError_t err = pick_launch(B, H, &l);
  if (err != cudaSuccess) return err;
  l.fn<<<l.grid, l.threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xg), static_cast<const float*>(r_zr),
      static_cast<const float*>(b_hzr), static_cast<const float*>(rn),
      static_cast<const float*>(bhn), static_cast<float*>(ys), B, T, H, reverse);
  return cudaGetLastError();
}

const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
