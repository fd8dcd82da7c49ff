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
// fixed order; nothing but xw, the outputs and the final state touches
// device memory. A null h0 or c0 stands for zeros.
//
// What bounds it on this card: neither bytes nor operations. At the
// UttFusion shapes (G=2, B=32, T=50, H=64) the work is 105 MFLOP and 4.3 MB,
// about 1.6 µs at the fp32 rate; the time goes into T dependent steps, and a
// step is one chain of dependent instructions that nothing overlaps (one
// row, one block per SM, every warp at the same point). So the design keeps
// that chain short rather than the card full:
//   - grid (batch tiles, G); a block owns ROWS batch rows of one group for
//     all T steps. ROWS (1, 2, 4 or 8) is the smallest that lets every block
//     be resident at once, so a small batch spreads over many SMs;
//   - four neighbouring lanes (a quad) own one hidden unit, and K is split
//     across them: lane s holds, in registers and loaded once, the rows
//     k ∈ {16c + 4s .. 16c + 4s + 3} of all four gate columns of its unit
//     (32 or 64 values, H ≤ 64: all of wh). A step reads h as float4s (the
//     four lanes read 64 consecutive bytes: no bank conflict) and runs four
//     independent FMA chains of H/4, one per gate, each float4 of h feeding
//     16 FMAs. A warp is 8 units × 4 slices, so 4H/32 warps meet at the
//     step's one barrier;
//   - every warp repeats the step's fixed part (reduce, activate, exchange,
//     update, loop: some 90 instructions beside the FMAs) and all meet at
//     the barrier, so fewer warps make a shorter step. At 32 < H ≤ 64 with
//     one or two rows a quad therefore serves TWO units (u and u +
//     threads/4): 128 threads, one warp per scheduler, 128 weights per lane,
//     each float4 of h read once for 32 FMAs in eight chains (5–8% at
//     H = 64). Lane constants and shared-memory offsets are pinned in
//     registers (`keep`), or the compiler computes them again in every step
//     (a tenth of the step);
//   - the four partial sums meet by a reduce-scatter over the quad: three
//     shuffles in two rounds, after which lane s holds the whole
//     pre-activation of ONE gate, gate(s) = 2·(s & 1) + (s >> 1). It adds
//     that gate's xw (loaded during the previous step) and evaluates that
//     gate's activation, so a unit's four transcendentals run in parallel;
//   - one instruction sequence serves σ and tanh, with no branch inside a
//     warp: σ(x) = 1/(1 + 2^(−x·log2 e)) and tanh(x) = 2σ(2x) − 1, through
//     ex2.approx and rcp.approx (about 1e-7 absolute, which the recurrence
//     carries to 1e-6 at most over 400 steps). The first version's expf, IEEE
//     division and tanhf cost several times as many dependent instructions,
//     and its `gate == 2 ? tanhf : sigmoid` ran both sides one after the
//     other in every warp;
//   - four shuffles then give every lane of the quad i, g, f and o; lane
//     r mod 4 updates row r (c' = f·c + i·g with separate roundings, as the
//     plain version has them; h' = o·tanh(c'); the length freeze) and stores
//     h to shared memory, out[:, t] to device memory and c to shared
//     memory. Its reads of c, of the old h and of the length are started at
//     the top of the step, so they are off the chain;
//   - h is double-buffered in shared memory: one __syncthreads() per step.
// Beyond the register rows (H > 64) each lane adds, for its own gate column,
// the next stage_k rows of wh from shared memory (stored in lane order, so a
// warp reads consecutive words) and the rest, if any, through L1/L2 — as the
// first version did: at H = 128 rows 0..63 are in registers and 64..127 in
// shared memory; 4H > 512 threads has no register rows and loops over
// columns beyond 1024.
//
// Weighed and not taken: c and the old h in registers of the updating lane
// (their shared-memory reads are already off the chain, and registers would
// need a second code path for the column loop); all-reduce over the quad
// with every lane evaluating all four activations (eight shuffles and four
// times the special-function work for one shuffle round less);
// tanh.approx.f32 (2^-11 cannot hold 1e-5). Not built: tensor cores
// (mma.sync.m16n8k8 TF32 with a 3-pass hi/lo split) pay only when a block
// owns 16 rows or more, which no shape has while blocks < SMs.
//
// Where this design stops: every block holds all of wh, so past the rows
// that fit beside the state (H > 128) each block reads the rest from L2 at
// every step, blocks × T × (H, 4H) floats, and at small B one SM walks an
// H × 4H product per step. The wrapper (ops/lstm.py `wide_plan`) therefore
// takes this design only at H ≤ 100, where it was measured faster than the
// cluster design (H = 64 and 100; at H = 128 the cluster design was faster:
// PERF.md §6), and the weight-stationary designs of lstm_wide.cu above.

#include <cuda_runtime.h>

#define MMTPU_LSTM_MAX_GROUPS 64  // the pointer tables are kernel parameters: 1 KB
#define MMTPU_LSTM_MAX_THREADS 1024
#define MMTPU_LSTM_KREG_THREADS 512   // most threads a block with register rows may have
#define MMTPU_LSTM_SMEM_LIMIT 232448  // bytes a block may use on sm_90

struct LstmParams {
  const float* xw[MMTPU_LSTM_MAX_GROUPS];  // group g: (B, T, 4H) row-major
  const float* wh[MMTPU_LSTM_MAX_GROUPS];  // group g: (H, 4H) row-major
  const float* h0;     // (G, B, H), or null: zeros
  const float* c0;     // (G, B, H), or null: zeros
  const int* lengths;  // (G, B), or null: every row runs to T
  float* out;          // (G, B, T, H)
  float* hT;           // (G, B, H)
  float* cT;           // (G, B, H)
  int B, T, H;
  int h_stride;  // floats between rows of h in shared memory: ≥ H and ≥ KREG, a multiple of 4
  int stage_k;   // rows [KREG, KREG + stage_k) of wh are copied into shared memory once
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define MMTPU_LOG2E 1.4426950408889634f

// a·σ(−m·x / log2 e) + d: σ(x) with (m, a, d) = (−log2 e, 1, 0), tanh(x)
// with (−2·log2 e, 2, −1). x → −∞ gives 2^∞ = ∞, rcp 0, and so d.
__device__ __forceinline__ float gate_act(float x, float m, float a, float d) {
  return fmaf(a, rcp_approx(1.0f + ex2_approx(x * m)), d);
}

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

// v[s] for a lane-varying s in 0..3 (entries beyond N do not exist).
template <int N>
__device__ __forceinline__ float pick_lane(const float (&v)[N], int s) {
  float r = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) r = s == i ? v[i] : r;
  return r;
}

// The value, made opaque to the compiler: it then holds it in a register
// over the loop instead of computing it again in every step.
__device__ __forceinline__ float keep(float v) {
  asm volatile("" : "+f"(v));
  return v;
}
__device__ __forceinline__ int keep(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// What one lane needs for the unit it serves. With a quad per unit it is
// computed once, before the loop over t, and out_ptr then moves with t.
template <int NT>
struct Lane {
  bool active;          // the lane's slot 4·unit + s is a column of this LSTM
  int unit;
  const float* x_col;   // xw of row 0, step 0, this lane's gate column
  bool mine[NT];        // row 4·jj + s exists in this tile: this lane updates it
  int c_off[NT];        // its c, as an offset into shared memory
  int h_off[NT];        // its h, as an offset into either h buffer
  float* out_ptr[NT];   // its out[:, t]
  int len[NT];
};

template <int NT>
__device__ __forceinline__ Lane<NT> make_lane(int slot, int s, int gate, int rows, int H, int HS,
                                              int T, int t, int c_base, const int* len_s,
                                              const float* xw, float* out) {
  Lane<NT> L;
  L.active = slot < 4 * H;
  L.unit = slot >> 2;
  L.x_col = xw + gate * H + L.unit;
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    const int r = 4 * jj + s;
    L.mine[jj] = L.active && r < rows;
    L.c_off[jj] = keep(c_base + r * H + L.unit);
    L.h_off[jj] = keep(r * HS + L.unit);
    L.out_ptr[jj] = out + ((size_t)r * T + t) * H + L.unit;
    L.len[jj] = L.mine[jj] ? len_s[r] : 0;
  }
  return L;
}

// NCH: float4 chunks of k that each lane holds in registers for all four
// gates of a unit, so rows [0, KREG) of wh with KREG = 16·NCH. UPT: units a
// quad serves (slots tid, tid + blockDim.x, ..), all from registers. NCH > 0
// requires 4H ≤ UPT·blockDim.x; UPT > 1 requires H ≤ KREG; MAXT ≥ blockDim.x.
template <int ROWS, int NCH, int UPT, int MAXT>
__global__ void __launch_bounds__(MAXT) lstm_kernel(LstmParams p) {
  constexpr int KREG = 16 * NCH;
  constexpr int NT = (ROWS + 3) / 4;  // rows a lane may update: r = 4·jj + s
  constexpr int RG = ROWS < 4 ? ROWS : 4;  // rows that meet in one exchange
  extern __shared__ float4 smem4[];   // 16-byte aligned: rows of h are read as float4
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = p.H, H4 = 4 * p.H, T = p.T, HS = p.h_stride, ks = p.stage_k;
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, p.B - row0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int s = tid & 3;                      // this lane's slice of K, and:
  const int gate = ((s & 1) << 1) | (s >> 1);  // the gate it activates
  const int quad0 = keep((tid & 31) & ~3);
  const float act_m = keep(gate == 2 ? -2.0f * MMTPU_LOG2E : -MMTPU_LOG2E);
  const float act_a = keep(gate == 2 ? 2.0f : 1.0f);
  const float act_d = keep(gate == 2 ? -1.0f : 0.0f);

  // shared memory, in floats from `smem`: h of step t - 1 and h of step t
  // (ROWS·HS each; `cur` says which is which), c (ROWS, H), the staged rows
  // of wh (stage_k, 4H) in lane order, the lengths (ROWS ints)
  const int h_buf = ROWS * HS, c_base = 2 * h_buf;
  float* c_s = smem + c_base;
  float* w_s = c_s + ROWS * H;
  int* len_s = reinterpret_cast<int*>(w_s + (size_t)ks * H4);

  const float* __restrict__ w_g = p.wh[g];
  // column gate·H + unit of rows [KREG, KREG + ks) → w_s[row][4·unit + s]
  for (int i = tid; i < ks * H4; i += nthr) {
    const int k = i / H4, slot = i - k * H4;
    const int ss = slot & 3, col = (((ss & 1) << 1) | (ss >> 1)) * H + (slot >> 2);
    w_s[i] = __ldg(w_g + (size_t)(KREG + k) * H4 + col);
  }
  const size_t state0 = ((size_t)g * p.B + row0) * H;  // this tile's rows in (G, B, H)
  for (int i = tid; i < h_buf; i += nthr) {  // the padding of h stays zero
    const int r = i / HS, k = i - r * HS;
    smem[i] = (p.h0 && r < rows && k < H) ? p.h0[state0 + r * H + k] : 0.0f;
    smem[h_buf + i] = 0.0f;
  }
  for (int i = tid; i < ROWS * H; i += nthr)
    c_s[i] = (p.c0 && i < rows * H) ? p.c0[state0 + i] : 0.0f;
  if (tid < ROWS)
    len_s[tid] = (tid < rows && p.lengths) ? p.lengths[(size_t)g * p.B + row0 + tid] : T;

  const float* __restrict__ xw = p.xw[g] + (size_t)row0 * T * H4;
  float* __restrict__ out = p.out + ((size_t)g * p.B + row0) * T * H;
  const size_t xw_row = (size_t)T * H4;  // floats between batch rows of xw

  // this lane's register rows of wh, [unit][chunk][k in the chunk][gate]
  float w_r[UPT][NCH > 0 ? NCH : 1][4][4];
  if (NCH > 0) {
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int slot = tid + u * nthr, unit = slot >> 2;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 4 * (4 * c + s) + i;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w_r[u][c][i][q] =
                (slot < H4 && k < H) ? __ldg(w_g + (size_t)k * H4 + q * H + unit) : 0.0f;
        }
    }
  }
  __syncthreads();

  // with its units in registers: the lane's fixed part, and xw of step 0
  // (from then on xw of step t + 1 is loaded during step t)
  Lane<NT> L[UPT];
  float x_next[UPT][ROWS];
  const float* x_run = nullptr;  // unit 0's column of xw, row 0, step t + 1
  const int unit_step = keep(nthr >> 2);  // from one of this quad's units to the next
  if (NCH > 0) {
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      L[u] = make_lane<NT>(tid + u * nthr, s, gate, rows, H, HS, T, 0, c_base, len_s, xw, out);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        x_next[u][r] = (L[u].active && r < rows) ? __ldg(L[u].x_col + r * xw_row) : 0.0f;
    }
    x_run = L[0].x_col + H4;
  }
  const int h_quad = keep(4 * s);  // where this lane's chunks of h start
  const bool b0 = s & 1, b1 = s & 2;
  int cur = 0;  // offset of the h buffer that holds step t - 1

  for (int t = 0; t < T; ++t) {
    const float* h_cur = smem + cur;
    float* h_nxt = smem + (h_buf - cur);
    // every thread of a warp runs every iteration (the shuffles need them
    // all); with the units in registers there is one iteration
    for (int base = 0; base < (NCH > 0 ? 1 : H4); base += (NCH > 0 ? 1 : nthr)) {
      if (NCH == 0)
        L[0] = make_lane<NT>(base + tid, s, gate, rows, H, HS, T, t, c_base, len_s, xw, out);
      // what the update of row 4·jj + s will need, asked for before the product
      float c_old[UPT][NT], h_old[UPT][NT];
      float x[UPT][ROWS], a0[UPT][ROWS], a1[ROWS];
#pragma unroll
      for (int u = 0; u < UPT; ++u) {
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
          c_old[u][jj] = L[u].mine[jj] ? smem[L[u].c_off[jj]] : 0.0f;
          h_old[u][jj] = L[u].mine[jj] ? h_cur[L[u].h_off[jj]] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          a0[u][r] = 0.0f;
          if (NCH > 0) {
            x[u][r] = x_next[u][r];
            if (t + 1 < T && L[u].active && r < rows)
              x_next[u][r] = __ldg(x_run + u * unit_step + r * xw_row);
          } else {
            x[u][r] = (L[u].active && r < rows)
                          ? __ldg(L[u].x_col + r * xw_row + (size_t)t * H4) : 0.0f;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) a1[r] = 0.0f;
      if (NCH > 0) {
        // the quad's product over rows [0, KREG): four chains per unit and
        // row, each float4 of h read once for all of the quad's units, then
        // the reduce-scatter that leaves this lane its own gate's sum in a0
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float q[UPT][4];
#pragma unroll
          for (int u = 0; u < UPT; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i) q[u][i] = 0.0f;
          const float4* h4 = reinterpret_cast<const float4*>(h_cur + r * HS + h_quad);
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const float4 hv = h4[4 * c];
            const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
            // unit and gate innermost: neighbouring FMAs belong to different chains
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int u = 0; u < UPT; ++u)
#pragma unroll
                for (int i = 0; i < 4; ++i) q[u][i] = fmaf(hk[k], w_r[u][c][k][i], q[u][i]);
          }
#pragma unroll
          for (int u = 0; u < UPT; ++u) {
            const float u0 = (b0 ? q[u][2] : q[u][0]) +
                             __shfl_xor_sync(0xffffffffu, b0 ? q[u][0] : q[u][2], 1);
            const float u1 = (b0 ? q[u][3] : q[u][1]) +
                             __shfl_xor_sync(0xffffffffu, b0 ? q[u][1] : q[u][3], 1);
            a0[u][r] = (b1 ? u1 : u0) + __shfl_xor_sync(0xffffffffu, b1 ? u0 : u1, 2);
          }
        }
        x_run += H4;
      }
      if (UPT == 1 && H > KREG && L[0].active) {
        const int slot = base + tid, j = gate * H + L[0].unit;
        dot_rows<ROWS>(w_s + slot, H4, h_cur, HS, KREG, KREG + ks, a0[0], a1);
        dot_rows<ROWS>(w_g + (size_t)(KREG + ks) * H4 + j, H4, h_cur, HS, KREG + ks, H, a0[0], a1);
      }
#pragma unroll
      for (int u = 0; u < UPT; ++u) {
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
          // four rows at a time: activate, give the quad all four gates of
          // each row, then lane s updates row 4·jj + s
          float vi[RG], vg[RG], vf[RG], vo[RG];
#pragma unroll
          for (int i = 0; i < RG; ++i) {
            const int r = 4 * jj + i;
            const float v = gate_act(x[u][r] + (a0[u][r] + a1[r]), act_m, act_a, act_d);
            vi[i] = __shfl_sync(0xffffffffu, v, quad0);      // lane 0: gate 0, i
            vg[i] = __shfl_sync(0xffffffffu, v, quad0 + 1);  // lane 1: gate 2, g
            vf[i] = __shfl_sync(0xffffffffu, v, quad0 + 2);  // lane 2: gate 1, f
            vo[i] = __shfl_sync(0xffffffffu, v, quad0 + 3);  // lane 3: gate 3, o
          }
          if (L[u].mine[jj]) {
            const float ig = pick_lane<RG>(vi, s), gg = pick_lane<RG>(vg, s);
            const float fg = pick_lane<RG>(vf, s), og = pick_lane<RG>(vo, s);
            // separate roundings, as the plain version has them (no contraction)
            const float c_new = __fadd_rn(__fmul_rn(fg, c_old[u][jj]), __fmul_rn(ig, gg));
            const float h_new =
                __fmul_rn(og, gate_act(c_new, -2.0f * MMTPU_LOG2E, 2.0f, -1.0f));
            const bool keep_going = t < L[u].len[jj];
            const float h_out = keep_going ? h_new : h_old[u][jj];
            smem[L[u].c_off[jj]] = keep_going ? c_new : c_old[u][jj];
            h_nxt[L[u].h_off[jj]] = h_out;
            *L[u].out_ptr[jj] = h_out;
            if (NCH > 0) L[u].out_ptr[jj] += H;
          }
        }
      }
    }
    __syncthreads();
    cur = h_buf - cur;
  }

  const float* h_last = smem + cur;
  for (int i = tid; i < rows * H; i += nthr) {
    const int r = i / H, k = i - r * H;
    p.hT[state0 + i] = h_last[r * HS + k];
    p.cT[state0 + i] = c_s[i];
  }
}

template <int ROWS, int NCH, int UPT, int MAXT>
static int launch(const LstmParams& p, int G, int threads, int smem_bytes,
                  cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lstm_kernel<ROWS, NCH, UPT, MAXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((p.B + ROWS - 1) / ROWS, G);
  lstm_kernel<ROWS, NCH, UPT, MAXT><<<grid, threads, smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The variant follows from the plan: no register rows; a quad per unit; or,
// where the block has half as many quads as units (4H = 2·threads), two
// units per quad. Each is compiled for the least thread limit that holds
// the block, so that a block of 128 threads may use four times the registers
// of one of 512.
template <int ROWS>
static int launch_rows(const LstmParams& p, int G, int kreg, int threads, int smem_bytes,
                       cudaStream_t stream) {
  const int H4 = 4 * p.H;
  if (kreg == 0)
    return launch<ROWS, 0, 1, MMTPU_LSTM_MAX_THREADS>(p, G, threads, smem_bytes, stream);
  if (kreg == 32 && H4 <= threads && threads <= 128)
    return launch<ROWS, 2, 1, 128>(p, G, threads, smem_bytes, stream);
  if (kreg == 64 && H4 <= threads && threads <= 256)
    return launch<ROWS, 4, 1, 256>(p, G, threads, smem_bytes, stream);
  if (kreg == 64 && H4 <= threads && threads <= MMTPU_LSTM_KREG_THREADS)
    return launch<ROWS, 4, 1, MMTPU_LSTM_KREG_THREADS>(p, G, threads, smem_bytes, stream);
  if (kreg == 64 && ROWS <= 2 && p.H <= 64 && H4 <= 2 * threads && threads <= 128)
    return launch<(ROWS <= 2 ? ROWS : 1), 4, 2, 128>(p, G, threads, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// xw, wh: G device pointers each (per-group bases, so the caller need not
// stack its groups into one buffer); h0, c0: one contiguous buffer over all
// groups, or null for zeros; out, hT, cT: one contiguous buffer each over
// all groups; lengths: (G, B) int32 or null.
// rows ∈ {1, 2, 4, 8}: batch rows per block; kreg ∈ {0, 32, 64}: rows of wh
// held in registers (needs 4H ≤ threads ≤ 512, or, with rows ≤ 2 and H ≤ 64,
// 4H ≤ 2·threads ≤ 256: two units per quad); stage_k: the next rows of
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
  if (kreg > 0 && threads > MMTPU_LSTM_KREG_THREADS) return (int)cudaErrorInvalidValue;
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
