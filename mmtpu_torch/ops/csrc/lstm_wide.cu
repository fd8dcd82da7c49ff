// Full-sequence LSTM recurrence for Hopper (sm_90a) at wide hidden sizes:
// the two weight-stationary designs beside lstm.cu's narrow one. Same
// function as lstm.cu (and the TPU kernel mmtpu/ops/lstm.py::_pallas_lstm),
// G independent LSTMs in ONE launch:
//   pre = xw[:, t] + h·wh          xw (B, T, 4H) already holds x·Wi + b
//   i, f, g, o = σ, σ, tanh, σ     of the four H-wide blocks of pre
//   c' = f·c + i·g ;  h' = o·tanh(c')
//   rows with t ≥ len keep h and c (and still write their h to out[:, t]).
// A null h0 or c0 stands for zeros. fp32 throughout.
//
// What bounds the narrow design (lstm.cu) past H = 128 on this card: it
// splits the batch across blocks and gives every block all of wh, so beyond
// the rows that fit beside the state every block reads the rest of wh from
// L2 at every step: blocks × T × (H, 4H) floats, 135.8 GB at G=2, B=128,
// T=64, H=1024, where the work itself needs 137 GFLOP (2.06 ms at 67
// TFLOP/s). Both designs here keep the weights still and move the batch
// past them: a block owns the hidden units [u0, u1) of one group, all four
// gate columns of each (an H × 4(u1 − u0) slice of wh), for all T steps,
// and computes their pre-activations for every row of its batch tile, so
// that wh is read once per call (cluster) or once per step (grid) instead
// of once per block and step.
//
// Thread layout, both designs: tid = (rg·NU + u)·KS + q. Unit slot u (NU
// slots ≥ the largest slice; slots beyond the slice compute on zeros and
// store nothing) and row group rg (rows rg + nrg·r for r < RPT, nrg =
// Bt/RPT: interleaved, so that the row groups a warp spans read different
// banks) own a tile of RPT rows × 4 gates; the K = H axis is split over KS
// neighbouring lanes q, lane q taking k = 4(q + KS·j) + i. A step's product
// reads four k of h as one float4 per row and, per k, the four gates of its
// unit as one float4 of wh from shared memory, stored in lane order (k-step
// 4j + i, slot u·KS + q), so a warp's loads of wh are consecutive 16-byte
// words and those of h consecutive or broadcast: 4·RPT FMAs per float4 of
// wh, 16 per float4 of h. The KS partial sums meet in a reduce-scatter over
// the lanes (log2 KS rounds of shuffles), after which lane q holds all four
// gates of RPT/KS of the row group's rows for its unit and updates them
// itself. Activations as in lstm.cu: ex2.approx and rcp.approx, about 1e-7
// absolute; the cell update with separate roundings, as the plain version.
//
// lstm_kernel_cluster — one cluster of S ≤ 16 blocks per (group, batch
// tile) holds all of the group's wh in shared memory (1.78 MiB at H = 342
// over 16 blocks), block s's slice copied once at entry and resident for
// all T steps; c, the old h, the length and the next step's xw of a lane's
// rows stay in its registers. h of the tile (Bt × H) is double-buffered in
// every block's shared memory; each step a block writes its new h columns
// into every peer's next buffer through distributed shared memory (stores
// to map_shared_rank addresses), then one barrier.cluster arrive.release /
// wait.acquire. A step costs the product (Bt·H·4U FMAs per SM) and a fixed
// part (the exchange, the cluster barrier, the gates) that is larger than
// the narrow design's, which is why it loses at H ≤ 100 (PERF.md §6). The planner
// (ops/lstm.py `wide_plan`) sizes S and Bt against what the card holds at
// once (cudaOccupancyMaxActiveClusters: 16-block clusters need 16 SMs of
// one GPC, and an H100 holds 7 of them), counting further waves.
//
// lstm_kernel_grid — where no cluster holds wh (H = 1024: 16 MiB per
// group): one cooperative launch of at most one block per SM walks the
// work items (group, batch tile, unit slice). The prologue writes wpack,
// the (Hp, H) float4 transpose of wh, so that a slice's k-row is contiguous.
// Each step, per item, h of the tile's rows (from the global double buffer
// hbuf) and the slice's rows of wh are streamed through shared memory in
// chunks of 64 k by cp.async.cg (L2 only: hbuf is written by other blocks
// between steps) in a three-stage ring that runs ahead across the block's
// items, each block starting at a different chunk; c lives in cT, the old h
// in hbuf, and both are asked for with the step's xw before the item's last
// chunk; one grid-wide barrier per step. wh is read from L2 once per step
// per item: 32 MiB × 64 steps = 2.1 GB at the SeqEncoder text shape instead
// of 135.8 GB. Its time is still about 2.5 times its bound, the FMAs at
// the full fp32 rate (chip_smoke.py phase 2, PERF.md §6); exploratory runs
// point at the product's shared-memory loads and the copies into shared
// memory overlapping little (PERF.md §7).
//
// Tried and not kept: the copies as 1-D bulk copies (TMA), one per 256- or
// 128-byte run of a slice's k-row or of h's row, slower; the product on
// tensor cores (mma.sync.m16n8k8 TF32 with a 3-pass hi/lo split), no faster
// at H = 1024 and further from the plain scan than fp32 FMAs; a register
// prefetch of the next chunk's operands, more stages, or the same chunk
// order in every block, no faster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define MMTPU_WIDE_MAX_GROUPS 64     // the pointer tables are kernel parameters: 1 KB
#define MMTPU_WIDE_MAX_THREADS 512
#define MMTPU_WIDE_SMEM_LIMIT 232448  // bytes a block may use on sm_90
#define MMTPU_GRID_CHUNK 64  // k per streamed chunk (a multiple of 4·KS)
#define MMTPU_GRID_STAGES 3

struct WideParams {
  const float* xw[MMTPU_WIDE_MAX_GROUPS];  // group g: (B, T, 4H) row-major
  const float* wh[MMTPU_WIDE_MAX_GROUPS];  // group g: (H, 4H) row-major
  const float* h0;     // (G, B, H), or null: zeros
  const float* c0;     // (G, B, H), or null: zeros
  const int* lengths;  // (G, B), or null: every row runs to T
  float* out;          // (G, B, T, H)
  float* hT;           // (G, B, H)
  float* cT;           // (G, B, H); the grid design keeps c there between steps
  float* hbuf;         // grid: (2, G, B, Hp), h of steps t − 1 and t; columns ≥ H zero
  float4* wpack;       // grid: (G, Hp, H), wpack[g][k][u] = the four gates of unit u, row k
  int G, B, T, H;
  int Hp;      // H padded: cluster 4·KS·nj, grid a multiple of the chunk
  int slices;  // unit slices of one group (the cluster size in the cluster design)
  int rows;    // Bt: batch rows of a tile
  int nu;      // unit slots of a block: threads = (rows / RPT)·nu·KS
  int hs;      // cluster: floats between rows of h in shared memory
  int items;   // grid: G · tiles · slices
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

__device__ __forceinline__ float sigmoid_approx(float x) {
  return rcp_approx(1.0f + ex2_approx(-MMTPU_LOG2E * x));
}

__device__ __forceinline__ float tanh_approx(float x) {
  return fmaf(2.0f, rcp_approx(1.0f + ex2_approx(-2.0f * MMTPU_LOG2E * x)), -1.0f);
}

// acc[r][gate] += Σ_k h[r][k]·w[k][gate] over this lane's k: nj float4s of
// h per row (h: the lane's first row at its column 4q, hs floats between
// rows, 4·KS floats between its chunks) and 4·nj float4s of w (w: the
// lane's slot in k-step 0, wrow float4s between k-steps).
template <int RPT, int KS>
__device__ __forceinline__ void load_chunk(float4 (&hv)[RPT], float4 (&wv)[4],
                                           const float* __restrict__ h, int hs,
                                           const float4* __restrict__ w, int wrow, int j) {
#pragma unroll
  for (int r = 0; r < RPT; ++r) hv[r] = *reinterpret_cast<const float4*>(h + r * hs + 4 * KS * j);
#pragma unroll
  for (int i = 0; i < 4; ++i) wv[i] = w[(4 * j + i) * wrow];
}

template <int RPT>
__device__ __forceinline__ void fma_chunk(float (&acc)[RPT][4], const float4 (&hv)[RPT],
                                          const float4 (&wv)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float hk = i == 0 ? hv[r].x : i == 1 ? hv[r].y : i == 2 ? hv[r].z : hv[r].w;
      acc[r][0] = fmaf(hk, wv[i].x, acc[r][0]);
      acc[r][1] = fmaf(hk, wv[i].y, acc[r][1]);
      acc[r][2] = fmaf(hk, wv[i].z, acc[r][2]);
      acc[r][3] = fmaf(hk, wv[i].w, acc[r][3]);
    }
}

template <int RPT, int KS>
__device__ __forceinline__ void product(float (&acc)[RPT][4], const float* __restrict__ h,
                                        int hs, const float4* __restrict__ w, int wrow,
                                        int nj) {
#pragma unroll 2
  for (int j = 0; j < nj; ++j) {
    float4 hv[RPT], wv[4];
    load_chunk<RPT, KS>(hv, wv, h, hs, w, wrow, j);
    fma_chunk<RPT>(acc, hv, wv);
  }
}

// One round of the reduce-scatter over lanes q and q ^ M with N rows per
// half: the lane with bit M set keeps rows [N, 2N), its partner [0, N), each
// summed with the other's; then the next round. After all rounds lane q
// holds rows RPT/KS·q + [0, RPT/KS) in acc[0 .. RPT/KS).
template <int RPT, int M, int N>
struct ReduceRows {
  static __device__ __forceinline__ void run(float (&acc)[RPT][4], int q) {
    const bool up = q & M;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float send = up ? acc[i][g] : acc[i + N][g];
        const float keep = up ? acc[i + N][g] : acc[i][g];
        acc[i][g] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
    ReduceRows<RPT, M / 2, N / 2>::run(acc, q);
  }
};

template <int RPT, int N>
struct ReduceRows<RPT, 0, N> {
  static __device__ __forceinline__ void run(float (&)[RPT][4], int) {}
};

// The cell update of one (row, unit) from its four pre-activations, where
// the row still runs (`live`); a frozen row keeps its h and c.
__device__ __forceinline__ void cell(const float (&pre)[4], float& c, float& h, bool live) {
  const float ig = sigmoid_approx(pre[0]);
  const float fg = sigmoid_approx(pre[1]);
  const float gg = tanh_approx(pre[2]);
  const float og = sigmoid_approx(pre[3]);
  // separate roundings, as the plain version has them (no contraction)
  const float c_new = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, gg));
  const float h_new = __fmul_rn(og, tanh_approx(c_new));
  if (live) {
    c = c_new;
    h = h_new;
  }
}

// Where the float4 of wh for (k, unit slot u) lies in a lane-ordered block
// of wh whose first k is k0 (k − k0 = 4(q + KS·j) + i → k-step 4j + i,
// slot u·KS + q).
template <int KS>
__device__ __forceinline__ int lane_order(int k_rel, int u, int nu) {
  const int c4 = k_rel >> 2, q = c4 % KS, j = c4 / KS;
  return (4 * j + (k_rel & 3)) * (nu * KS) + u * KS + q;
}

template <int RPT, int KS, int MAXT>
__global__ void __launch_bounds__(MAXT) lstm_kernel_cluster(WideParams p) {
  constexpr int NR = RPT / KS;  // rows a lane updates
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.slices;
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.y, g = blockIdx.z;
  const int H = p.H, H4 = 4 * p.H, T = p.T, B = p.B, Hp = p.Hp, hs = p.hs, NU = p.nu;
  const int Bt = p.rows;
  const int u0 = rank * H / S, U = (rank + 1) * H / S - u0;
  const int row0 = tile * Bt, rows = min(Bt, B - row0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int q = tid % KS, u = (tid / KS) % NU, rg = tid / (KS * NU);
  const int wrow = NU * KS, nj = Hp / (4 * KS);

  extern __shared__ float4 smem4[];
  float4* w_s = smem4;                                       // Hp·NU float4, lane order
  float* h_s = reinterpret_cast<float*>(w_s + (size_t)Hp * NU);  // 2 buffers of Bt·hs
  const int hbuf_floats = Bt * hs;

  // the slice of wh, once: (k, slot) ← the four gate columns of unit u0 + slot
  const float* __restrict__ w_g = p.wh[g];
  for (int i = tid; i < Hp * NU; i += nthr) {
    const int k = i / NU, us = i - k * NU;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < H && us < U) {
      const float* row = w_g + (size_t)k * H4 + u0 + us;
      v = make_float4(__ldg(row), __ldg(row + H), __ldg(row + 2 * H), __ldg(row + 3 * H));
    }
    w_s[lane_order<KS>(k, us, NU)] = v;
  }
  // h of step −1 in buffer 0; padding and rows beyond the batch stay zero
  const size_t state0 = ((size_t)g * B + row0) * H;
  for (int i = tid; i < 2 * hbuf_floats; i += nthr) {
    const int r = (i % hbuf_floats) / hs, k = (i % hbuf_floats) - r * hs;
    h_s[i] = (i < hbuf_floats && p.h0 && r < rows && k < H) ? p.h0[state0 + r * H + k] : 0.0f;
  }

  // this lane's rows: rg + nrg·(NR·q + i) for i < NR, unit u0 + u (read and
  // written only where `mine`)
  const int nrg = Bt / RPT, r_own = rg + nrg * NR * q, h_col = u0 + u;
  const size_t x_row = (size_t)T * H4, o_row = (size_t)T * H;  // floats between rows
  const float* x_base = p.xw[g] + (size_t)(row0 + r_own) * x_row + h_col;
  float* o_base = p.out + ((size_t)g * B + row0 + r_own) * o_row + h_col;
  bool mine[NR];
  int len[NR];
  float c[NR], h[NR], x_next[NR][4];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = r_own + nrg * i;
    mine[i] = u < U && r < rows;
    const size_t sidx = state0 + (size_t)r * H + h_col;
    c[i] = (mine[i] && p.c0) ? p.c0[sidx] : 0.0f;
    h[i] = (mine[i] && p.h0) ? p.h0[sidx] : 0.0f;
    len[i] = !mine[i] ? 0 : (p.lengths ? p.lengths[(size_t)g * B + row0 + r] : T);
#pragma unroll
    for (int gt = 0; gt < 4; ++gt)
      x_next[i][gt] = mine[i] ? __ldg(x_base + nrg * i * x_row + gt * H) : 0.0f;
  }
  cluster.sync();  // every block of the cluster is running and has its state

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_s + cur * hbuf_floats;
    float* h_nxt = h_s + (hbuf_floats - cur * hbuf_floats);
    float acc[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) acc[r][gt] = 0.0f;
    float x[NR][4];
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int gt = 0; gt < 4; ++gt) {
        x[i][gt] = x_next[i][gt];
        if (mine[i] && t + 1 < T)
          x_next[i][gt] = __ldg(x_base + nrg * i * x_row + (size_t)(t + 1) * H4 + gt * H);
      }
    product<RPT, KS>(acc, h_cur + rg * hs + 4 * q, nrg * hs, w_s + u * KS + q, wrow, nj);
    ReduceRows<RPT, KS / 2, RPT / 2>::run(acc, q);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (!mine[i]) continue;
      const float pre[4] = {acc[i][0] + x[i][0], acc[i][1] + x[i][1], acc[i][2] + x[i][2],
                            acc[i][3] + x[i][3]};
      cell(pre, c[i], h[i], t < len[i]);
      o_base[nrg * i * o_row + (size_t)t * H] = h[i];
      float* dst = h_nxt + (r_own + nrg * i) * hs + h_col;
      for (int peer = 0; peer < S; ++peer) *cluster.map_shared_rank(dst, peer) = h[i];
    }
    cluster.sync();  // barrier.cluster arrive.release / wait.acquire: h_nxt complete everywhere
    cur ^= 1;
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (!mine[i]) continue;
    const size_t sidx = state0 + (size_t)(r_own + nrg * i) * H + h_col;
    p.hT[sidx] = h[i];
    p.cT[sidx] = c[i];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int RPT, int KS, int MAXT>
__global__ void __launch_bounds__(MAXT) lstm_kernel_grid(WideParams p) {
  constexpr int NR = RPT / KS;
  constexpr int KC = MMTPU_GRID_CHUNK, ST = MMTPU_GRID_STAGES, HSC = KC + 4;
  cg::grid_group grid = cg::this_grid();
  const int H = p.H, H4 = 4 * p.H, T = p.T, B = p.B, G = p.G, Hp = p.Hp, NU = p.nu;
  const int Bt = p.rows, NS = p.slices, tiles = (B + Bt - 1) / Bt;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int q = tid % KS, u = (tid / KS) % NU, rg = tid / (KS * NU);
  const int wrow = NU * KS, nch = Hp / KC, nrg = Bt / RPT;
  const size_t plane = (size_t)G * B * Hp;  // one buffer of hbuf

  // prologue, over the whole grid: wpack, h of step −1 in hbuf[0] (padding
  // of both buffers zero), c0 into cT
  {
    const size_t gtid = (size_t)blockIdx.x * nthr + tid, gstride = (size_t)gridDim.x * nthr;
    const size_t packed = (size_t)G * Hp * H;
    for (size_t i = gtid; i < packed; i += gstride) {
      const int gg = (int)(i / ((size_t)Hp * H));
      const size_t rem = i - (size_t)gg * Hp * H;
      const int k = (int)(rem / H), uu = (int)(rem - (size_t)k * H);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < H) {
        const float* row = p.wh[gg] + (size_t)k * H4 + uu;
        v = make_float4(__ldg(row), __ldg(row + H), __ldg(row + 2 * H), __ldg(row + 3 * H));
      }
      p.wpack[i] = v;
    }
    for (size_t i = gtid; i < 2 * plane; i += gstride) {
      const size_t ri = i % plane, gb = ri / Hp;
      const int k = (int)(ri - gb * Hp);
      p.hbuf[i] = (i < plane && p.h0 && k < H) ? p.h0[gb * H + k] : 0.0f;
    }
    for (size_t i = gtid; i < (size_t)G * B * H; i += gstride)
      p.cT[i] = p.c0 ? p.c0[i] : 0.0f;
  }
  grid.sync();

  extern __shared__ float4 smem4[];
  float4* w_st = smem4;                                            // ST × KC·NU float4
  float* h_st = reinterpret_cast<float*>(w_st + (size_t)ST * KC * NU);  // ST × Bt·HSC

  // The block's work in a step is one stream of chunks: chunk c is k-chunk
  // (c + blockIdx.x) % nch of its item c / nch (items blockIdx.x, +
  // gridDim.x, ...): the copies run ST − 1 chunks ahead across the items'
  // boundaries, and the blocks that share a tile's rows of h start on
  // different chunks of them.
  const int total = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * nch;
  struct Item {
    int g, u0, U, row0, rows;
  };
  auto item_of = [&](int c) {
    const int item = blockIdx.x + (c / nch) * gridDim.x;
    const int s = item % NS, tile = (item / NS) % tiles;
    Item it;
    it.g = item / (NS * tiles);
    it.u0 = s * H / NS;
    it.U = (s + 1) * H / NS - it.u0;
    it.row0 = tile * Bt;
    it.rows = min(Bt, B - it.row0);
    return it;
  };

  for (int t = 0; t < T; ++t) {
    const float* h_src = p.hbuf + (size_t)(t & 1) * plane;
    float* h_dst = p.hbuf + (size_t)((t + 1) & 1) * plane;
    // chunk c: h of the item's rows (Bt × KC) and the slice's rows of wh
    // (KC × NU, lane order) into stage c % ST
    auto fetch = [&](int c) {
      if (c < total) {
        const Item it = item_of(c);
        const int k0 = (c % nch + (int)blockIdx.x) % nch * KC, st = c % ST;
        const float4* w_rows = p.wpack + ((size_t)it.g * Hp + k0) * H + it.u0;
        float4* wd = w_st + (size_t)st * KC * NU;
        for (int i = tid; i < KC * NU; i += nthr) {
          const int kr = i / NU, us = i - kr * NU;
          const bool ok = us < it.U;
          cp_async16(wd + lane_order<KS>(kr, us, NU), w_rows + (size_t)kr * H + (ok ? us : 0),
                     ok);
        }
        const float* h_rows = h_src + ((size_t)it.g * B + it.row0) * Hp + k0;
        float* hd = h_st + (size_t)st * Bt * HSC;
        for (int i = tid; i < Bt * (KC / 4); i += nthr) {
          const int r = i / (KC / 4), c4 = i - r * (KC / 4);
          const bool ok = r < it.rows;
          cp_async16(hd + r * HSC + 4 * c4, h_rows + (size_t)(ok ? r : 0) * Hp + 4 * c4, ok);
        }
      }
      cp_async_commit();
    };

    float acc[RPT][4];
#pragma unroll
    for (int c = 0; c < ST - 1; ++c) fetch(c);
    for (int c = 0; c < total; ++c) {
      cp_async_wait<ST - 2>();  // chunk c has landed (this thread's copies)
      __syncthreads();          // everyone's copies, and stage (c − 1) % ST is free
      fetch(c + ST - 1);
      if (c % nch == 0) {
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) acc[r][gt] = 0.0f;
      }
      // an item's last chunk: what its update reads is asked for before the product
      const bool last = c % nch == nch - 1;
      const Item it = item_of(c);
      float px[NR][4], pc[NR], ph[NR];
      int pl[NR];
      if (last) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int r = rg + nrg * (NR * q + i);
          const bool mine = u < it.U && r < it.rows;
          const size_t row = (size_t)it.g * B + it.row0 + (mine ? r : 0);
          const int col = it.u0 + (mine ? u : 0);
          const float* xr = p.xw[it.g] + ((size_t)(it.row0 + (mine ? r : 0)) * T + t) * H4 + col;
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) px[i][gt] = mine ? __ldg(xr + gt * H) : 0.0f;
          pc[i] = mine ? __ldcg(p.cT + row * H + col) : 0.0f;
          ph[i] = mine ? __ldcg(h_src + row * Hp + col) : 0.0f;
          pl[i] = mine ? (p.lengths ? p.lengths[row] : T) : -1;
        }
      }
      const int st = c % ST;
      product<RPT, KS>(acc, h_st + (size_t)st * Bt * HSC + rg * HSC + 4 * q, nrg * HSC,
                       w_st + (size_t)st * KC * NU + u * KS + q, wrow, KC / (4 * KS));
      if (!last) continue;
      ReduceRows<RPT, KS / 2, RPT / 2>::run(acc, q);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (pl[i] < 0) continue;  // not this lane's (row, unit)
        const int r = rg + nrg * (NR * q + i);
        const size_t row = (size_t)it.g * B + it.row0 + r;
        const int col = it.u0 + u;
        const float pre[4] = {acc[i][0] + px[i][0], acc[i][1] + px[i][1], acc[i][2] + px[i][2],
                              acc[i][3] + px[i][3]};
        float c_ = pc[i], h_ = ph[i];
        cell(pre, c_, h_, t < pl[i]);
        p.cT[row * H + col] = c_;
        h_dst[row * Hp + col] = h_;
        p.out[(row * T + t) * H + col] = h_;
        if (t == T - 1) p.hT[row * H + col] = h_;
      }
    }
    grid.sync();  // h of step t everywhere (and every stage free)
  }
}

// --- launch ------------------------------------------------------------------

// The thread limit a variant is compiled for (the registers it may use): a
// cluster design's lane keeps c, h, the length and the next xw of its RPT/KS
// rows in registers for all T steps, so four rows or more get 256 threads; a
// grid design's lane with eight rows holds their operands and what its
// update reads, so 256 too.
template <int RPT, int KS>
static constexpr int max_threads(int design) {
  return (design == 0 ? RPT / KS >= 4 : RPT == 8) ? 256 : MMTPU_WIDE_MAX_THREADS;
}

template <int RPT, int KS>
static int launch_cluster(const WideParams& p, int cluster, int threads, int smem,
                          cudaStream_t stream, int* occupancy) {
  auto kernel = lstm_kernel_cluster<RPT, KS, max_threads<RPT, KS>(0)>;
  if (threads > max_threads<RPT, KS>(0)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, (p.B + p.rows - 1) / p.rows, p.G);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  if (occupancy) return (int)cudaOccupancyMaxActiveClusters(occupancy, kernel, &config);
  e = cudaLaunchKernelEx(&config, kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int RPT, int KS>
static int launch_grid(const WideParams& p, int blocks, int threads, int smem,
                       cudaStream_t stream, int* occupancy) {
  auto kernel = lstm_kernel_grid<RPT, KS, max_threads<RPT, KS>(1)>;
  if (threads > max_threads<RPT, KS>(1)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (occupancy)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, threads, smem);
  WideParams local = p;
  void* args[] = {&local};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(threads), args, smem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// (rows per thread, k-slices) → the instantiation; design 0 cluster, 1 grid
static int dispatch(int design, int rpt, int ks, const WideParams& p, int cluster_or_blocks,
                    int threads, int smem, cudaStream_t stream, int* occupancy) {
#define MMTPU_WIDE_CASE(R, K)                                                              \
  if (rpt == R && ks == K)                                                                 \
    return design == 0 ? launch_cluster<R, K>(p, cluster_or_blocks, threads, smem, stream, \
                                              occupancy)                                   \
                       : launch_grid<R, K>(p, cluster_or_blocks, threads, smem, stream,    \
                                           occupancy);
  MMTPU_WIDE_CASE(4, 1)
  MMTPU_WIDE_CASE(4, 2)
  MMTPU_WIDE_CASE(4, 4)
  MMTPU_WIDE_CASE(8, 1)
  MMTPU_WIDE_CASE(8, 2)
  MMTPU_WIDE_CASE(8, 4)
  MMTPU_WIDE_CASE(8, 8)
#undef MMTPU_WIDE_CASE
  return (int)cudaErrorInvalidValue;
}

static WideParams make_params(const void* const* xw, const void* const* wh, const void* h0,
                              const void* c0, const int* lengths, void* out, void* hT, void* cT,
                              int G, int B, int T, int H) {
  WideParams p = {};
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
  p.G = G;
  p.B = B;
  p.T = T;
  p.H = H;
  return p;
}

static bool valid_layout(int G, int B, int T, int H, int rpt, int ks, int rows, int nu,
                         int threads, int smem) {
  return G >= 1 && G <= MMTPU_WIDE_MAX_GROUPS && B >= 1 && T >= 1 && H >= 1 && ks >= 1 &&
         rpt % ks == 0 && rows % rpt == 0 && nu >= 1 && threads % 32 == 0 &&
         threads == rows / rpt * nu * ks && threads <= MMTPU_WIDE_MAX_THREADS &&
         smem <= MMTPU_WIDE_SMEM_LIMIT;
}

extern "C" {

// Occupancy of a layout (nothing is launched): design 0 writes to *result
// cudaOccupancyMaxActiveClusters for clusters of `cluster` blocks, design 1
// cudaOccupancyMaxActiveBlocksPerMultiprocessor. Returns the CUDA error.
int mmtpu_lstm_wide_occupancy(int design, int rpt, int ks, int cluster, int threads, int smem,
                              int* result) {
  WideParams p = {};
  p.G = 1;
  p.B = 1;
  p.rows = rpt;
  *result = 0;
  return dispatch(design, rpt, ks, p, cluster, threads, smem, nullptr, result);
}

// The cluster design on `stream`; returns cudaGetLastError() (0 = ok).
// Pointers as in lstm.cu's mmtpu_lstm_forward. cluster: S blocks per
// (group, tile), each owning units [s·H/S, (s+1)·H/S); rows: Bt, a multiple
// of rpt; units: NU slots ≥ ⌈H/S⌉; h_pad: 4·ks·⌈H/(4·ks)⌉; h_stride: floats
// between rows of h in shared memory (≥ h_pad, a multiple of 4); threads =
// rows/rpt · units · ks; smem = h_pad·units·16 + 2·rows·h_stride·4 bytes.
int mmtpu_lstm_cluster_forward(const void* const* xw, const void* const* wh, const void* h0,
                               const void* c0, const int* lengths, void* out, void* hT,
                               void* cT, int G, int B, int T, int H, int cluster, int rows,
                               int rpt, int ks, int units, int h_pad, int h_stride,
                               int threads, int smem, void* stream) {
  if (!valid_layout(G, B, T, H, rpt, ks, rows, units, threads, smem) || cluster < 1 ||
      cluster > 16 || cluster > H || units * cluster < H || h_pad < H ||
      h_pad % (4 * ks) != 0 || h_stride < h_pad || h_stride % 4 != 0 ||
      (long long)h_pad * units * 16 + 8LL * rows * h_stride > smem)
    return (int)cudaErrorInvalidValue;
  WideParams p = make_params(xw, wh, h0, c0, lengths, out, hT, cT, G, B, T, H);
  p.Hp = h_pad;
  p.slices = cluster;
  p.rows = rows;
  p.nu = units;
  p.hs = h_stride;
  return dispatch(0, rpt, ks, p, cluster, threads, smem, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// The grid design on `stream` (one cooperative launch of `blocks` blocks,
// which must all be resident); returns the CUDA error (0 = ok). hbuf: 2·G·B
// ·h_pad floats and wpack: G·h_pad·H float4 of scratch the caller
// allocates; h_pad a multiple of the chunk (64) ≥ H; slices: unit slices of
// a group, each with at most `units` units; smem = stages (3) · (64·units·16
// + rows·68·4) bytes.
int mmtpu_lstm_grid_forward(const void* const* xw, const void* const* wh, const void* h0,
                            const void* c0, const int* lengths, void* out, void* hT, void* cT,
                            void* hbuf, void* wpack, int G, int B, int T, int H, int slices,
                            int rows, int rpt, int ks, int units, int h_pad, int blocks,
                            int threads, int smem, void* stream) {
  const long long need = (long long)MMTPU_GRID_STAGES *
                         (MMTPU_GRID_CHUNK * units * 16LL + rows * (MMTPU_GRID_CHUNK + 4) * 4LL);
  if (!valid_layout(G, B, T, H, rpt, ks, rows, units, threads, smem) || slices < 1 ||
      slices > H || (long long)units * slices < H || h_pad < H ||
      h_pad % MMTPU_GRID_CHUNK != 0 || MMTPU_GRID_CHUNK % (4 * ks) != 0 || need > smem ||
      blocks < 1 || hbuf == nullptr || wpack == nullptr)
    return (int)cudaErrorInvalidValue;
  WideParams p = make_params(xw, wh, h0, c0, lengths, out, hT, cT, G, B, T, H);
  p.hbuf = static_cast<float*>(hbuf);
  p.wpack = static_cast<float4*>(wpack);
  p.Hp = h_pad;
  p.slices = slices;
  p.rows = rows;
  p.nu = units;
  p.items = G * ((B + rows - 1) / rows) * slices;
  if (blocks > p.items) return (int)cudaErrorInvalidValue;
  return dispatch(1, rpt, ks, p, blocks, threads, smem, static_cast<cudaStream_t>(stream),
                  nullptr);
}

}  // extern "C"
