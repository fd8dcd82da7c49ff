// Fused ReLU-MLP chain for Hopper (sm_90a):
//   out = relu(...relu(x·W1ᵀ + b1)...)·Wnᵀ + bn   in ONE launch.
//
// Replaces the TPU kernel mmtpu/ops/fused_mlp.py::_pallas_forward (the
// AVMNIST fusion head 192→128→64→10 on the eval path). Same function:
// every layer in one kernel, activations never written to device memory,
// fp32 accumulation, ReLU after every layer but the last.
//
// What bounds it on this card: at the head's shapes the work is tiny
// (B=1024: 2·1024·(192·128 + 128·64 + 64·10) ≈ 68 MFLOP, and 0.97 MB of
// x, weights and logits), so the bound is bytes — well under a
// microsecond at 3.35 TB/s — and a launch costs more than that. The plain
// chain pays five launches (three GEMMs, two ReLUs) and a device-memory
// round trip per intermediate activation; this kernel pays one launch and
// keeps the activations in shared memory.
//
// Design (first, simple version):
//   - one block of THREADS threads per tile of `block_rows` batch rows;
//   - two shared-memory buffers hold the x tile and each layer's
//     activations, ping-ponged across layers with a __syncthreads() between;
//   - each thread computes one output column for ROWS_PER_THREAD rows with
//     an fp32 FMA loop over K, so each weight it loads is reused for
//     ROWS_PER_THREAD rows; all threads of a warp read the same activation
//     address (shared-memory broadcast);
//   - weights are read as they lie in nn.Linear's (out, in) layout, through
//     the read-only L1/L2 path; no transposed copy per call;
//   - layer count and dims arrive by value in a small struct (≤ 8 layers).
// wgmma, TMA and weights resident in shared memory are for a later version.

#include <cuda_runtime.h>

#define MMTPU_MLP_MAX_LAYERS 8
#define MMTPU_MLP_THREADS 256
#define MMTPU_MLP_ROWS_PER_THREAD 4

struct MlpParams {
  const float* w[MMTPU_MLP_MAX_LAYERS];  // layer i: (dims[i+1], dims[i]) row-major
  const float* b[MMTPU_MLP_MAX_LAYERS];  // layer i: (dims[i+1],)
  int dims[MMTPU_MLP_MAX_LAYERS + 1];
  int n_layers;
  int batch;
  int block_rows;  // a multiple of MMTPU_MLP_ROWS_PER_THREAD
  int max_dim;     // max(dims[0..n_layers-1]): the widest activation kept
};

__global__ void __launch_bounds__(MMTPU_MLP_THREADS)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, MlpParams p) {
  constexpr int RPT = MMTPU_MLP_ROWS_PER_THREAD;
  extern __shared__ float smem[];
  float* bufs[2] = {smem, smem + p.block_rows * p.max_dim};

  const int row0 = blockIdx.x * p.block_rows;
  const int rows = min(p.block_rows, p.batch - row0);
  const int groups = (rows + RPT - 1) / RPT;
  const int padded = groups * RPT;  // rows computed; the tail is zero-filled

  // x tile: rows row0..row0+rows-1 are one contiguous run of x
  {
    const int d0 = p.dims[0];
    const float* xt = x + (size_t)row0 * d0;
    const int n_real = rows * d0;
    for (int i = threadIdx.x; i < padded * d0; i += blockDim.x)
      bufs[0][i] = i < n_real ? xt[i] : 0.0f;
  }
  __syncthreads();

  for (int l = 0; l < p.n_layers; ++l) {
    const int K = p.dims[l];
    const int N = p.dims[l + 1];
    const float* __restrict__ W = p.w[l];
    const float* __restrict__ bias = p.b[l];
    const float* in = bufs[l & 1];
    float* nxt = bufs[(l + 1) & 1];
    const bool last = l == p.n_layers - 1;

    for (int o = threadIdx.x; o < groups * N; o += blockDim.x) {
      const int col = o % N;
      const int r0 = (o / N) * RPT;
      const float* wrow = W + (size_t)col * K;
      const float* a = in + r0 * K;
      float acc[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float wv = __ldg(wrow + k);
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r] = fmaf(a[r * K + k], wv, acc[r]);
      }
      const float bv = __ldg(bias + col);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float v = acc[r] + bv;
        if (last) {
          if (r0 + r < rows) out[(size_t)(row0 + r0 + r) * N + col] = v;
        } else {
          nxt[(r0 + r) * N + col] = fmaxf(v, 0.0f);
        }
      }
    }
    __syncthreads();
  }
}

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// dims: n_layers + 1 ints; w, b: n_layers device pointers each.
// smem_bytes = 2 * block_rows * max_dim * 4, chosen by the caller.
int mmtpu_fused_mlp_forward(const void* x, void* out, int batch, int n_layers,
                            const int* dims, const void* const* w,
                            const void* const* b, int block_rows,
                            int smem_bytes, void* stream) {
  if (n_layers < 1 || n_layers > MMTPU_MLP_MAX_LAYERS || batch < 1 ||
      block_rows < MMTPU_MLP_ROWS_PER_THREAD ||
      block_rows % MMTPU_MLP_ROWS_PER_THREAD != 0)
    return (int)cudaErrorInvalidValue;
  MlpParams p;
  p.n_layers = n_layers;
  p.batch = batch;
  p.block_rows = block_rows;
  p.max_dim = 0;
  for (int i = 0; i <= n_layers; ++i) {
    p.dims[i] = dims[i];
    if (i < n_layers && dims[i] > p.max_dim) p.max_dim = dims[i];
  }
  for (int i = 0; i < n_layers; ++i) {
    p.w[i] = static_cast<const float*>(w[i]);
    p.b[i] = static_cast<const float*>(b[i]);
  }
  if ((long long)2 * block_rows * p.max_dim * (long long)sizeof(float) > smem_bytes)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (batch + block_rows - 1) / block_rows;
  fused_mlp_kernel<<<grid, MMTPU_MLP_THREADS, smem_bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

}  // extern "C"
