// Fused ReLU-MLP chain for Hopper (sm_90a):
//   out = relu(...relu(x·W1ᵀ + b1)...)·Wnᵀ + bn   in ONE launch.
//
// Replaces the TPU kernel mmtpu/ops/fused_mlp.py::_pallas_forward (the
// AVMNIST fusion head 192→128→64→10 on the eval path). Same function:
// every layer in one kernel, activations never written to device memory,
// fp32 accumulation, ReLU after every layer but the last.
//
// What bounds it on this card: at the head's shapes the work is tiny
// (B=1024: 2·1024·33,408 ≈ 68 MFLOP and 0.97 MB of x, weights and logits:
// a microsecond by operations, less by bytes), so what a design can lose is
// latency: how the 134 KB of weights reach the arithmetic, and how long the
// chain of dependent FMAs is. The first version ran a K-long chain per
// thread whose weight loads, W[col][k] for neighbouring columns, were 4·K
// bytes apart across a warp: 32 sectors per load through L1/L2, in every
// block, for every row group.
//
// Design:
//   - weights live in shared memory as they lie in device memory, row-major
//     (out, in), rows K rounded up to a multiple of 4 floats apart. A layer
//     comes by ONE cp.async.bulk (the 1-D bulk copy of the TMA, started by one
//     thread, completion counted in bytes on the layer's mbarrier), all
//     layers at kernel entry, so layers 2.. arrive while layer 1 computes.
//     A bulk copy needs 16-byte alignment and a multiple of 16 bytes: a
//     layer whose K is no multiple of 4 or whose matrix starts off a 16-byte
//     boundary is copied by all threads with plain loads instead, here in
//     the kernel. (One copy per padded row, 202 for the head, was measured
//     first: the copies' fixed cost, not their bytes, then set the time.)
//     Biases are copied to shared memory once, too;
//   - a block is persistent: it walks over tiles of R batch rows (R = 1, 2, 4
//     or 8, the smallest that leaves at most a tile per two SMs; the grid is
//     at most one block per SM) and keeps the weights for all of them;
//   - a warp works on a task of 16 output columns × R rows × all of K. Its
//     lanes are 8 column groups × 4 slices of K: lane (cg, kg) owns columns
//     cg and cg + 8 of the task and the float4 chunks ≡ kg (mod 4) of K.
//     K = 192, 128, 64 are multiples of 32, so neighbouring columns start in
//     the same bank: the odd column groups therefore walk their chunks one
//     group of four ahead of the even ones (and wrap), and the eight lanes of
//     a quarter warp (two columns × four consecutive chunks) read 8 distinct
//     16-byte bank groups: conflict-free without padding. Each weight is
//     read from shared memory once per tile. Each thread runs 2·R sums over
//     K/4; at R ≤ 2, where latency and not throughput is the limit, a chunk's four
//     products are summed as a tree, so that the chain through an accumulator
//     is one add per chunk. Two shuffle rounds sum the four slices; lane kg
//     writes the rows r ≡ kg (mod 4) with bias and ReLU into the other
//     activation buffer, or the logits to device memory;
//   - activations ping-pong between two shared-memory buffers, one
//     __syncthreads() per layer;
//   - a chain whose weights do not all fit is streamed: layer by layer, in
//     runs of whole columns as large as the weights region allows, each run
//     brought (bulk or plain) after the previous one has been used. Only a
//     chain so wide that one row's two activation buffers, the biases and
//     one weight row do not fit is refused, by the wrapper.
//
// Member axis (the counterpart of Pallas's batching rule, which adds a grid
// axis): K independent chains of the same dims in one launch, grid
// (blocks, K). Block (i, m) runs chain m: its x, logits, weights and biases
// start `m·stride` floats after the given bases, where a stride of 0 shares
// one tensor among all members. With K = 1 and no strides it is the plain
// call.
//
// Chosen against: lanes along k with one shuffle reduction per accumulator
// (five shuffle rounds for every output); rows padded to a stride ≡ 16 mod 32
// (conflict-free too, but one bulk copy per row); wgmma (64-row tiles: two
// blocks at B = 128) and mma.sync TF32 (breaks 1e-5 without a 3-pass split;
// the launch and the weights' way from L2 cost more than the FMAs).

#include <cuda_runtime.h>
#include <stdint.h>

#define MMTPU_MLP_MAX_LAYERS 8
#define MMTPU_MLP_THREADS 256
#define MMTPU_MLP_TASK_COLS 16
#define MMTPU_MLP_HEADER_BYTES 64      // the mbarriers, one per layer
#define MMTPU_MLP_SMEM_LIMIT 232448    // bytes a block may use on sm_90
#define MMTPU_MLP_MAX_DEVICES 64

struct MlpParams {
  const float* w[MMTPU_MLP_MAX_LAYERS];  // layer i: (dims[i+1], dims[i]) row-major
  const float* b[MMTPU_MLP_MAX_LAYERS];  // layer i: (dims[i+1],)
  int dims[MMTPU_MLP_MAX_LAYERS + 1];
  int n_layers;
  int batch;
  int bulk_mask;   // bit i: layer i's rows are 16-byte aligned multiples of 16 bytes
  int resident;    // all layers fit the weights region together: brought once, at entry
  int act_stride;  // floats between rows of an activation buffer, a multiple of 4
  int bias_floats; // all layers' outputs, rounded up to a multiple of 4
  int w_floats;    // size of the weights region
  long long w_ms[MMTPU_MLP_MAX_LAYERS];  // floats between members' weights (0: shared)
  long long b_ms[MMTPU_MLP_MAX_LAYERS];  // floats between members' biases (0: shared)
  long long x_ms, out_ms;                // floats between members' inputs and outputs
};

// Floats between weight rows in shared memory: K rounded up to a multiple of 4.
__host__ __device__ __forceinline__ int weight_stride(int K) { return (K + 3) & ~3; }

// Columns of a layer that one streamed run holds: all N if they fit, else a
// multiple of the task width, else what fits (the wrapper made sure of one).
__host__ __device__ __forceinline__ int run_cols(int N, int S, int w_floats) {
  const int fit = w_floats / S;
  if (fit >= N) return N;
  return fit >= MMTPU_MLP_TASK_COLS ? fit / MMTPU_MLP_TASK_COLS * MMTPU_MLP_TASK_COLS : fit;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Called by one thread: `bytes` (a multiple of 16) from src to dst, both
// 16-byte aligned, as one bulk copy counted on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <int R>
__global__ void __launch_bounds__(MMTPU_MLP_THREADS)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, MlpParams p) {
  constexpr int NWARPS = MMTPU_MLP_THREADS / 32;
  // shared memory: the mbarriers, the biases of all layers, two activation
  // buffers of R rows, the weights region
  extern __shared__ float4 smem4[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem4);
  float* bias_s = reinterpret_cast<float*>(smem4) + MMTPU_MLP_HEADER_BYTES / 4;
  float* acts = bias_s + p.bias_floats;
  const int AS = p.act_stride;
  float* w_region = acts + 2 * R * AS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = lane >> 2, kg = lane & 3;
  const int n_tiles = (p.batch + R - 1) / R;
  const long long member = blockIdx.y;
  x += member * p.x_ms;
  out += member * p.out_ms;

  if (tid == 0) {
    for (int l = 0; l < p.n_layers; ++l)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(mbar + l)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (p.resident && tid == 0) {  // every layer that may come by bulk copy, now
    size_t off = 0;
    for (int l = 0; l < p.n_layers; ++l) {
      const int K = p.dims[l], N = p.dims[l + 1];
      if (p.bulk_mask >> l & 1)
        bulk_copy(w_region + off, p.w[l] + member * p.w_ms[l], 4u * N * K,
                  smem_addr(mbar + l));
      off += (size_t)N * weight_stride(K);
    }
  }
  for (int l = 0, off = 0; l < p.n_layers; ++l) {
    const int N = p.dims[l + 1];
    const float* bl = p.b[l] + member * p.b_ms[l];
    for (int i = tid; i < N; i += MMTPU_MLP_THREADS) bias_s[off + i] = __ldg(bl + i);
    off += N;
  }

  uint32_t stream_parity = 0;  // of mbar[0], which every streamed run reuses
  bool first_tile = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first_tile = false) {
    const int row0 = tile * R;
    const int rows = min(R, p.batch - row0);
    {  // x tile, zero beyond the batch and up to the next multiple of 4
      const int K0 = p.dims[0], K0P = (K0 + 3) & ~3;
      for (int i = tid; i < R * K0P; i += MMTPU_MLP_THREADS) {
        const int r = i / K0P, k = i - r * K0P;
        acts[r * AS + k] = (r < rows && k < K0) ? x[(size_t)(row0 + r) * K0 + k] : 0.0f;
      }
    }
    __syncthreads();  // also: the biases are in place

    size_t off = 0;
    int bias_off = 0;
    for (int l = 0; l < p.n_layers; ++l) {
      const int K = p.dims[l], N = p.dims[l + 1], S = weight_stride(K);
      const int chunks = S >> 2, n_groups = (chunks + 3) >> 2;
      const float* __restrict__ W = p.w[l] + member * p.w_ms[l];
      const float* in = acts + (l & 1) * R * AS;
      float* nxt = acts + ((l + 1) & 1) * R * AS;
      const bool last = l == p.n_layers - 1;
      const bool bulk = p.bulk_mask >> l & 1;
      if (!last) {  // the next layer reads whole float4 chunks: zero N..round4(N)
        const int pad = ((N + 3) & ~3) - N;
        for (int i = tid; i < R * pad; i += MMTPU_MLP_THREADS)
          nxt[(i / pad) * AS + N + i % pad] = 0.0f;
      }
      const int per_run = p.resident ? N : run_cols(N, S, p.w_floats);
      for (int col0 = 0; col0 < N; col0 += per_run) {
        const int ncols = min(per_run, N - col0);
        float* w_s = w_region + (p.resident ? off : 0);
        if (!p.resident || (first_tile && !bulk)) {  // bring this run now
          if (!p.resident) __syncthreads();  // the region's previous run has been read
          const float* src = W + (size_t)col0 * K;
          if (bulk) {
            if (tid == 0) {
              asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
              bulk_copy(w_s, src, 4u * ncols * K, smem_addr(mbar));
            }
          } else {
            for (int i = tid; i < ncols * S; i += MMTPU_MLP_THREADS) {
              const int c = i / S, k = i - c * S;
              w_s[i] = k < K ? __ldg(src + (size_t)c * K + k) : 0.0f;
            }
            __syncthreads();
          }
        }
        if (bulk) {
          if (p.resident) {
            mbar_wait(smem_addr(mbar + l), 0);
          } else {
            mbar_wait(smem_addr(mbar), stream_parity);
            stream_parity ^= 1;
          }
        }

        const int n_tasks = (ncols + MMTPU_MLP_TASK_COLS - 1) / MMTPU_MLP_TASK_COLS;
        for (int task = warp; task < n_tasks; task += NWARPS) {
          const int c0 = task * MMTPU_MLP_TASK_COLS + cg, c1 = c0 + 8;
          const bool ok0 = c0 < ncols, ok1 = c1 < ncols;
          const float* w0 = w_s + (size_t)c0 * S;
          const float* w1 = w_s + (size_t)c1 * S;
          float acc0[R], acc1[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc0[r] = 0.0f;
            acc1[r] = 0.0f;
          }
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
          for (int j = 0; j < n_groups; ++j) {
            // odd column groups walk one group of four chunks ahead: with K a
            // multiple of 32 their rows start in the same bank as their neighbour's
            int group = j + (cg & 1);
            if (group >= n_groups) group -= n_groups;
            const int c = 4 * group + kg;
            const bool live = c < chunks;
            const int at = live ? 4 * c : 0;
            const float4 wa = (ok0 && live) ? *reinterpret_cast<const float4*>(w0 + at) : zero;
            const float4 wb = (ok1 && live) ? *reinterpret_cast<const float4*>(w1 + at) : zero;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 a = *reinterpret_cast<const float4*>(in + r * AS + at);
              if (R <= 2) {  // a tree per chunk: the chain through acc is one add
                acc0[r] += fmaf(a.x, wa.x, a.y * wa.y) + fmaf(a.z, wa.z, a.w * wa.w);
                acc1[r] += fmaf(a.x, wb.x, a.y * wb.y) + fmaf(a.z, wb.z, a.w * wb.w);
              } else {
                acc0[r] = fmaf(a.x, wa.x, acc0[r]);
                acc1[r] = fmaf(a.x, wb.x, acc1[r]);
                acc0[r] = fmaf(a.y, wa.y, acc0[r]);
                acc1[r] = fmaf(a.y, wb.y, acc1[r]);
                acc0[r] = fmaf(a.z, wa.z, acc0[r]);
                acc1[r] = fmaf(a.z, wb.z, acc1[r]);
                acc0[r] = fmaf(a.w, wa.w, acc0[r]);
                acc1[r] = fmaf(a.w, wb.w, acc1[r]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc0[r] += __shfl_xor_sync(0xffffffffu, acc0[r], 1);
            acc1[r] += __shfl_xor_sync(0xffffffffu, acc1[r], 1);
            acc0[r] += __shfl_xor_sync(0xffffffffu, acc0[r], 2);
            acc1[r] += __shfl_xor_sync(0xffffffffu, acc1[r], 2);
          }
          const float b0 = ok0 ? bias_s[bias_off + col0 + c0] : 0.0f;
          const float b1 = ok1 ? bias_s[bias_off + col0 + c1] : 0.0f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if ((r & 3) != kg) continue;
            const float v0 = acc0[r] + b0, v1 = acc1[r] + b1;
            if (last) {
              if (r < rows) {
                float* o = out + (size_t)(row0 + r) * N + col0;
                if (ok0) o[c0] = v0;
                if (ok1) o[c1] = v1;
              }
            } else {
              if (ok0) nxt[r * AS + col0 + c0] = fmaxf(v0, 0.0f);
              if (ok1) nxt[r * AS + col0 + c1] = fmaxf(v1, 0.0f);
            }
          }
        }
      }
      off += (size_t)N * S;
      bias_off += N;
      __syncthreads();  // nxt is whole, and `in` may be written again
    }
  }
}

template <int R>
static int launch(const float* x, float* out, const MlpParams& p, int grid, int members,
                  int smem_bytes, cudaStream_t stream) {
  // the attribute is kept per device: set it when a launch needs more than
  // this process has allowed there so far (the wrapper serialises launches)
  static int allowed[MMTPU_MLP_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MMTPU_MLP_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem_bytes > 48 * 1024 && smem_bytes > allowed[dev]) {
    e = cudaFuncSetAttribute(fused_mlp_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = smem_bytes;
  }
  fused_mlp_kernel<R><<<dim3(grid, members), MMTPU_MLP_THREADS, smem_bytes, stream>>>(x, out, p);
  return (int)cudaGetLastError();
}

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// dims: n_layers + 1 ints; w, b: n_layers device pointers each. rows ∈ {1, 2,
// 4, 8}: batch rows per tile; grid: blocks (each walks over tiles); act_stride:
// floats between activation rows, ≥ every dims[i] with i < n_layers rounded
// up to 4; bulk_mask: bit i set where layer i's base pointer and 4·dims[i] are
// multiples of 16; smem_bytes: header + biases + two activation buffers + the
// weights region; resident: the region holds every layer at once. members:
// chains in the launch (grid.y); x_ms, out_ms and the n_layers entries of w_ms
// and b_ms: floats between two members' tensors, 0 where all share one (a
// bulk-copied layer's w_ms must keep 16-byte alignment). The caller sizes
// them (`chain_plan` in the wrapper); this checks again.
int mmtpu_fused_mlp_forward(const void* x, void* out, int batch, int n_layers,
                            const int* dims, const void* const* w,
                            const void* const* b, int rows, int grid, int act_stride,
                            int bulk_mask, int resident, int smem_bytes, int members,
                            long long x_ms, long long out_ms, const long long* w_ms,
                            const long long* b_ms, void* stream) {
  if (n_layers < 1 || n_layers > MMTPU_MLP_MAX_LAYERS || batch < 1 || grid < 1 ||
      act_stride % 4 != 0 || smem_bytes > MMTPU_MLP_SMEM_LIMIT || members < 1 ||
      members > 65535 || x_ms < 0 || out_ms < 0)
    return (int)cudaErrorInvalidValue;
  MlpParams p;
  p.n_layers = n_layers;
  p.batch = batch;
  p.bulk_mask = bulk_mask;
  p.resident = resident;
  p.act_stride = act_stride;
  p.x_ms = x_ms;
  p.out_ms = out_ms;
  long long all = 0, outs = 0;
  for (int i = 0; i <= n_layers; ++i) {
    p.dims[i] = dims[i];
    if (dims[i] < 1) return (int)cudaErrorInvalidValue;
    if (i > 0) outs += dims[i];
  }
  p.bias_floats = (int)((outs + 3) & ~3LL);
  const long long fixed =
      MMTPU_MLP_HEADER_BYTES + 4LL * p.bias_floats + 2LL * rows * act_stride * 4;
  p.w_floats = (int)((smem_bytes - fixed) / 4);
  for (int i = 0; i < n_layers; ++i) {
    const int S = weight_stride(dims[i]);
    if (S > act_stride || S > p.w_floats) return (int)cudaErrorInvalidValue;
    if (w_ms[i] < 0 || b_ms[i] < 0) return (int)cudaErrorInvalidValue;
    if (bulk_mask >> i & 1) {
      if (dims[i] % 4 != 0 || reinterpret_cast<uintptr_t>(w[i]) % 16 != 0 || w_ms[i] % 4 != 0)
        return (int)cudaErrorInvalidValue;
    }
    p.w_ms[i] = w_ms[i];
    p.b_ms[i] = b_ms[i];
    all += (long long)dims[i + 1] * S;
    p.w[i] = static_cast<const float*>(w[i]);
    p.b[i] = static_cast<const float*>(b[i]);
  }
  if (resident && all > p.w_floats) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch<1>(xf, of, p, grid, members, smem_bytes, s);
    case 2: return launch<2>(xf, of, p, grid, members, smem_bytes, s);
    case 4: return launch<4>(xf, of, p, grid, members, smem_bytes, s);
    case 8: return launch<8>(xf, of, p, grid, members, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
