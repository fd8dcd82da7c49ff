// Full-sequence LSTM recurrence for Hopper (sm_90a): G independent LSTMs,
// each over its whole sequence, in ONE launch, h and c on chip from t = 0 to T.
//
// Replaces the TPU kernel mmtpu/ops/lstm.py::_pallas_lstm, and with the
// group dimension also the stacked scan lstm_sequence_stacked, which the TPU
// package runs as plain XLA. Same function per group:
//   pre = xw[:, t] + h·wh          xw (B, T, 4H) already holds x·Wi + b
//   i, f, g, o = σ, σ, tanh, σ     of the four H-wide blocks of pre
//   c' = f·c + i·g ;  h' = o·tanh(c')
//   rows with t ≥ len keep h and c (and still write their h to out[:, t]).
// The h·wh product and the gate pass are both computed here, in fp32, in a
// fixed k-order; nothing but xw, the outputs and the final state touches
// device memory.
//
// What bounds it on this card: neither bytes nor operations. At the
// UttFusion shapes (G=2, B=32, T=50, H=64) the work is 105 MFLOP and 4.3 MB,
// about 1.6 µs at the fp32 rate; the time goes into the chain of T
// dependent steps. The design therefore keeps a step short rather than the
// card full:
//   - grid (batch tiles, G); a block owns ROWS batch rows of one group for
//     all T steps. ROWS (1, 2, 4 or 8) is the smallest that lets every block
//     be resident at once, so a small batch spreads over many SMs;
//   - one thread per gate column (a loop over columns when 4H > 1024),
//     numbered so that the four gates of a hidden unit sit in four
//     neighbouring lanes: thread slot = 4·unit + gate owns column
//     gate·H + unit of wh. It accumulates Σk h[r][k]·wh[k][column] for its
//     ROWS rows, applies its own gate's σ or tanh, and the four lanes
//     exchange their results by warp shuffles; lane 0 of the four combines
//     them, applies the length freeze and writes out[:, t] and the new
//     state. So the transcendental work is spread over all 4H threads and a
//     step has ONE block-wide barrier: h is double-buffered in shared
//     memory, c lives there too and is only ever touched by its own thread;
//   - where each row of wh lives, by k: the first KREG rows (32 or 64) in
//     the thread's registers, loaded once — reading wh from shared memory
//     every step costs 16·H² bytes of shared-memory traffic per step, which
//     alone is about 500 cycles at H = 64; the next stage_k rows in shared
//     memory (stored in slot order, so a warp reads consecutive words); the
//     rest, if any, through L1/L2 every step. Register rows need one column
//     per thread and at most 512 threads, i.e. H ≤ 128; at H = 128 rows
//     0..63 are in registers and 64..127 in shared memory;
//   - h is read as float4 broadcasts in the register part, and the product
//     runs over two accumulators, which halves the chain of dependent FMAs;
//   - with one column per thread, xw of step t+1 is loaded during step t.
// No padding of H to a lane width, no whole-sequence block on chip, no
// tensor cores: mma over (rows × H)·(H × 4H) is for a later version.

#include <cuda_runtime.h>

#define MMTPU_LSTM_MAX_GROUPS 8
#define MMTPU_LSTM_MAX_THREADS 1024
#define MMTPU_LSTM_KREG_THREADS 512   // most threads a block with register rows may have
#define MMTPU_LSTM_SMEM_LIMIT 232448  // bytes a block may use on sm_90

struct LstmParams {
  const float* xw[MMTPU_LSTM_MAX_GROUPS];  // group g: (B, T, 4H) row-major
  const float* wh[MMTPU_LSTM_MAX_GROUPS];  // group g: (H, 4H) row-major
  const float* h0;     // (G, B, H)
  const float* c0;     // (G, B, H)
  const int* lengths;  // (G, B), or null: every row runs to T
  float* out;          // (G, B, T, H)
  float* hT;           // (G, B, H)
  float* cT;           // (G, B, H)
  int B, T, H;
  int h_stride;  // floats between rows of h in shared memory: ≥ H and ≥ KREG, a multiple of 4
  int stage_k;   // rows [KREG, KREG + stage_k) of wh are copied into shared memory once
};

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// Bytes of dynamic shared memory: h twice (ROWS·h_stride each), c (ROWS·H),
// the staged rows of wh (stage_k·4H), len (ROWS ints).
static long long lstm_smem_bytes(int rows, int H, int h_stride, int stage_k) {
  long long words = 2LL * rows * h_stride + (long long)rows * H + 4LL * stage_k * H + rows;
  return 4 * words;
}

// For k in [k0, k1): a0[r] += h[r][k]·w[(k - k0)·H4] where k - k0 is even,
// a1[r] where it is odd.
template <int ROWS>
__device__ __forceinline__ void dot_rows(const float* __restrict__ w, int H4, const float* h,
                                         int h_stride, int k0, int k1, float (&a0)[ROWS],
                                         float (&a1)[ROWS]) {
  int k = k0;
#pragma unroll 4
  for (; k + 1 < k1; k += 2) {
    const float w0 = w[(size_t)(k - k0) * H4];
    const float w1 = w[(size_t)(k - k0 + 1) * H4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      a0[r] = fmaf(h[r * h_stride + k], w0, a0[r]);
      a1[r] = fmaf(h[r * h_stride + k + 1], w1, a1[r]);
    }
  }
  if (k < k1) {
    const float w0 = w[(size_t)(k - k0) * H4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) a0[r] = fmaf(h[r * h_stride + k], w0, a0[r]);
  }
}

// KREG > 0 requires 4H ≤ blockDim.x ≤ MMTPU_LSTM_KREG_THREADS (one column per thread).
template <int ROWS, int KREG>
__global__ void __launch_bounds__(KREG > 0 ? MMTPU_LSTM_KREG_THREADS : MMTPU_LSTM_MAX_THREADS)
lstm_kernel(LstmParams p) {
  extern __shared__ float4 smem4[];  // 16-byte aligned: rows of h are read as float4
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = p.H, H4 = 4 * p.H, T = p.T, HS = p.h_stride, ks = p.stage_k;
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, p.B - row0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int quad0 = (tid & 31) & ~3;  // the lane that holds gate i of this thread's unit

  float* h_cur = smem;                // (ROWS, HS): h of step t - 1
  float* h_nxt = h_cur + ROWS * HS;   // (ROWS, HS): h of step t
  float* c_s = h_nxt + ROWS * HS;     // (ROWS, H)
  float* w_s = c_s + ROWS * H;        // (stage_k, 4H) in slot order
  int* len_s = reinterpret_cast<int*>(w_s + (size_t)ks * H4);

  const float* __restrict__ w_g = p.wh[g];
  // column gate·H + unit of rows [KREG, KREG + ks) → w_s[row][4·unit + gate]
  for (int i = tid; i < ks * H4; i += nthr) {
    const int k = i / H4, j = i - k * H4;
    const int gate = j / H, unit = j - gate * H;
    w_s[k * H4 + 4 * unit + gate] = __ldg(w_g + (size_t)(KREG + k) * H4 + j);
  }
  const size_t state0 = ((size_t)g * p.B + row0) * H;  // this tile's rows in (G, B, H)
  for (int i = tid; i < ROWS * HS; i += nthr) {  // the padding of h stays zero
    const int r = i / HS, k = i - r * HS;
    h_cur[i] = (r < rows && k < H) ? p.h0[state0 + r * H + k] : 0.0f;
    h_nxt[i] = 0.0f;
  }
  for (int i = tid; i < ROWS * H; i += nthr) c_s[i] = i < rows * H ? p.c0[state0 + i] : 0.0f;
  if (tid < ROWS)
    len_s[tid] = (tid < rows && p.lengths) ? p.lengths[(size_t)g * p.B + row0 + tid] : T;

  const float* __restrict__ xw = p.xw[g] + (size_t)row0 * T * H4;
  float* __restrict__ out = p.out + ((size_t)g * p.B + row0) * T * H;

  // register rows of wh and the prefetched xw, for this thread's one column
  float w_r[KREG > 0 ? KREG : 1];
  float x_next[ROWS];
  if (KREG > 0) {
    const int gate = tid & 3, unit = tid >> 2, j = gate * H + unit;
#pragma unroll
    for (int k = 0; k < KREG; ++k)
      w_r[k] = (tid < H4 && k < H) ? __ldg(w_g + (size_t)k * H4 + j) : 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      x_next[r] = (tid < H4 && r < rows) ? __ldg(xw + (size_t)r * T * H4 + j) : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // every thread of a warp runs every iteration (the shuffles need them all)
    for (int base = 0; base < H4; base += nthr) {
      const int slot = base + tid;
      const bool active = slot < H4;
      const int gate = slot & 3, unit = slot >> 2, j = gate * H + unit;
      float x[ROWS], a0[ROWS], a1[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        a0[r] = 0.0f;
        a1[r] = 0.0f;
        if (KREG > 0) {
          x[r] = x_next[r];
          if (t + 1 < T && active && r < rows)
            x_next[r] = __ldg(xw + ((size_t)r * T + t + 1) * H4 + j);
        } else {
          x[r] = (active && r < rows) ? __ldg(xw + ((size_t)r * T + t) * H4 + j) : 0.0f;
        }
      }
      if (KREG > 0) {
#pragma unroll
        for (int k = 0; k < KREG; k += 4) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(h_cur + r * HS + k);
            a0[r] = fmaf(hv.x, w_r[k], a0[r]);
            a1[r] = fmaf(hv.y, w_r[k + 1], a1[r]);
            a0[r] = fmaf(hv.z, w_r[k + 2], a0[r]);
            a1[r] = fmaf(hv.w, w_r[k + 3], a1[r]);
          }
        }
      }
      if (active) {
        dot_rows<ROWS>(w_s + slot, H4, h_cur, HS, KREG, KREG + ks, a0, a1);
        dot_rows<ROWS>(w_g + (size_t)(KREG + ks) * H4 + j, H4, h_cur, HS, KREG + ks, H, a0, a1);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pre = x[r] + (a0[r] + a1[r]);
        const float v = gate == 2 ? tanhf(pre) : sigmoid_f32(pre);
        const float ig = __shfl_sync(0xffffffffu, v, quad0);
        const float fg = __shfl_sync(0xffffffffu, v, quad0 + 1);
        const float gg = __shfl_sync(0xffffffffu, v, quad0 + 2);
        const float og = __shfl_sync(0xffffffffu, v, quad0 + 3);
        if (active && gate == 0 && r < rows) {
          const float c_old = c_s[r * H + unit];
          const float h_old = h_cur[r * HS + unit];
          // separate roundings, as the plain version has them (no contraction)
          const float c_new = __fadd_rn(__fmul_rn(fg, c_old), __fmul_rn(ig, gg));
          const float h_new = __fmul_rn(og, tanhf(c_new));
          const bool keep = t < len_s[r];
          const float h_out = keep ? h_new : h_old;
          c_s[r * H + unit] = keep ? c_new : c_old;
          h_nxt[r * HS + unit] = h_out;
          out[((size_t)r * T + t) * H + unit] = h_out;
        }
      }
    }
    __syncthreads();
    float* swap = h_cur;
    h_cur = h_nxt;
    h_nxt = swap;
  }

  for (int i = tid; i < rows * H; i += nthr) {
    const int r = i / H, k = i - r * H;
    p.hT[state0 + i] = h_cur[r * HS + k];
    p.cT[state0 + i] = c_s[i];
  }
}

template <int ROWS, int KREG>
static int launch(const LstmParams& p, int G, int threads, int smem_bytes,
                  cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lstm_kernel<ROWS, KREG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.B + ROWS - 1) / ROWS, G);
  lstm_kernel<ROWS, KREG><<<grid, threads, smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int ROWS>
static int launch_rows(const LstmParams& p, int G, int kreg, int threads, int smem_bytes,
                       cudaStream_t stream) {
  switch (kreg) {
    case 0: return launch<ROWS, 0>(p, G, threads, smem_bytes, stream);
    case 32: return launch<ROWS, 32>(p, G, threads, smem_bytes, stream);
    case 64: return launch<ROWS, 64>(p, G, threads, smem_bytes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// xw, wh: G device pointers each (per-group bases, so the caller need not
// stack its groups into one buffer); h0, c0, out, hT, cT: one contiguous
// buffer over all groups; lengths: (G, B) int32 or null.
// rows ∈ {1, 2, 4, 8}: batch rows per block; kreg ∈ {0, 32, 64}: rows of wh
// held in registers (needs 4H ≤ threads ≤ 512); stage_k: the next rows of
// wh, copied into shared memory; h_stride: floats between rows of h in
// shared memory; threads: a multiple of 32 up to 1024. The caller sizes them
// so the block's shared memory fits (see lstm_smem_bytes); this checks again.
int mmtpu_lstm_forward(const void* const* xw, const void* const* wh,
                       const void* h0, const void* c0, const int* lengths,
                       void* out, void* hT, void* cT, int G, int B, int T,
                       int H, int rows, int kreg, int stage_k, int h_stride,
                       int threads, void* stream) {
  if (G < 1 || G > MMTPU_LSTM_MAX_GROUPS || B < 1 || T < 1 || H < 1 ||
      threads < 32 || threads > MMTPU_LSTM_MAX_THREADS || threads % 32 != 0 ||
      stage_k < 0 || kreg + stage_k > (H > kreg ? H : kreg) ||
      h_stride < H || h_stride < kreg || h_stride % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (kreg > 0 && (4 * H > threads || threads > MMTPU_LSTM_KREG_THREADS))
    return (int)cudaErrorInvalidValue;
  const long long smem = lstm_smem_bytes(rows, H, h_stride, stage_k);
  if (smem > MMTPU_LSTM_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  LstmParams p;
  for (int g = 0; g < G; ++g) {
    p.xw[g] = static_cast<const float*>(xw[g]);
    p.wh[g] = static_cast<const float*>(wh[g]);
  }
  p.h0 = static_cast<const float*>(h0);
  p.c0 = static_cast<const float*>(c0);
  p.lengths = lengths;
  p.out = static_cast<float*>(out);
  p.hT = static_cast<float*>(hT);
  p.cT = static_cast<float*>(cT);
  p.B = B;
  p.T = T;
  p.H = H;
  p.h_stride = h_stride;
  p.stage_k = stage_k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch_rows<1>(p, G, kreg, threads, (int)smem, s);
    case 2: return launch_rows<2>(p, G, kreg, threads, (int)smem, s);
    case 4: return launch_rows<4>(p, G, kreg, threads, (int)smem, s);
    case 8: return launch_rows<8>(p, G, kreg, threads, (int)smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
