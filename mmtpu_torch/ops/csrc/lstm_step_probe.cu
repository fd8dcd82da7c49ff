// Where one step of the LSTM recurrence spends its cycles on Hopper (sm_90a).
//
// A measuring copy of the two one-row step designs of csrc/lstm.cu, with
// clock64() stamps taken by lane 0 of warp 0 of block 0 around the parts of a
// step; it is not on any model's path. `design` 0 is the first design (one
// thread per gate column, each thread a 2-chain product over all of K, expf
// and an IEEE division or tanhf per gate, four shuffles, one lane in four
// updates c and h from shared memory); `design` 1 is the K-split design of
// csrc/lstm.cu with a quad per unit (see its head note). Both run with one
// batch row per block, all of wh in registers (H = 32 or 64), no lengths,
// zero state.
//
// cycles[0..4] receive the sum over the T steps of: the product (h reads and
// FMAs), the reduction across the quad (design 1 only), the gate activation,
// the gate exchange by shuffles, the c/h update with its stores, and
// cycles[5] the barrier; cycles[6] is the whole loop. Stamps order the code
// around them only loosely (the compiler may move arithmetic across a
// stamp), so read the split as an indication, not to the cycle.

#include <cuda_runtime.h>

#define N_STAMPS 7

__device__ __forceinline__ float sigmoid_ieee(float x) { return 1.0f / (1.0f + expf(-x)); }

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

struct Stamps {
  long long sum[N_STAMPS];
  long long last;
  bool on;
  __device__ void start() { last = clock64(); }
  __device__ void mark(int i) {
    if (on) {
      const long long now = clock64();
      sum[i] += now - last;
      last = now;
    }
  }
};

// design 0: thread slot = 4·unit + gate owns column gate·H + unit of wh.
template <int H>
__global__ void __launch_bounds__(4 * H)
probe_first(const float* __restrict__ xw, const float* __restrict__ wh, float* __restrict__ out,
            int T, long long* cycles) {
  __shared__ float4 hbuf[2][H / 4];
  __shared__ float c_s[H];
  constexpr int H4 = 4 * H;
  const int tid = threadIdx.x, gate = tid & 3, unit = tid >> 2, j = gate * H + unit;
  const int quad0 = (tid & 31) & ~3;
  float* h_cur = reinterpret_cast<float*>(hbuf[0]);
  float* h_nxt = reinterpret_cast<float*>(hbuf[1]);
  const float* x_row = xw + (size_t)blockIdx.x * T * H4;
  float* o_row = out + (size_t)blockIdx.x * T * H;
  float w_r[H];
#pragma unroll
  for (int k = 0; k < H; ++k) w_r[k] = __ldg(wh + (size_t)k * H4 + j);
  if (tid < H) {
    h_cur[tid] = 0.0f;
    h_nxt[tid] = 0.0f;
    c_s[tid] = 0.0f;
  }
  float x_next = __ldg(x_row + j);
  Stamps st = {};
  st.on = blockIdx.x == 0 && tid == 0;
  __syncthreads();
  const long long t_begin = clock64();
  st.start();
  for (int t = 0; t < T; ++t) {
    const float x = x_next;
    if (t + 1 < T) x_next = __ldg(x_row + (size_t)(t + 1) * H4 + j);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int k = 0; k < H; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(h_cur + k);
      a0 = fmaf(hv.x, w_r[k], a0);
      a1 = fmaf(hv.y, w_r[k + 1], a1);
      a0 = fmaf(hv.z, w_r[k + 2], a0);
      a1 = fmaf(hv.w, w_r[k + 3], a1);
    }
    const float pre = x + (a0 + a1);
    st.mark(0);
    const float v = gate == 2 ? tanhf(pre) : sigmoid_ieee(pre);
    st.mark(2);
    const float ig = __shfl_sync(0xffffffffu, v, quad0);
    const float fg = __shfl_sync(0xffffffffu, v, quad0 + 1);
    const float gg = __shfl_sync(0xffffffffu, v, quad0 + 2);
    const float og = __shfl_sync(0xffffffffu, v, quad0 + 3);
    st.mark(3);
    if (gate == 0) {
      const float c_new = __fadd_rn(__fmul_rn(fg, c_s[unit]), __fmul_rn(ig, gg));
      const float h_new = __fmul_rn(og, tanhf(c_new));
      c_s[unit] = c_new;
      h_nxt[unit] = h_new;
      o_row[(size_t)t * H + unit] = h_new;
    }
    st.mark(4);
    __syncthreads();
    st.mark(5);
    float* swap = h_cur;
    h_cur = h_nxt;
    h_nxt = swap;
  }
  if (st.on) {
    for (int i = 0; i < 6; ++i) cycles[i] = st.sum[i];
    cycles[6] = clock64() - t_begin;
  }
}

// design 1: thread (unit, s) of a quad owns the k-chunks 4j + s of all four
// gate columns of its unit; after the reduce-scatter lane s holds the
// pre-activation of gate ((s & 1) << 1) | (s >> 1).
template <int H>
__global__ void __launch_bounds__(4 * H)
probe_ksplit(const float* __restrict__ xw, const float* __restrict__ wh, float* __restrict__ out,
             int T, long long* cycles) {
  __shared__ float4 hbuf[2][H / 4];
  constexpr int H4 = 4 * H, NCH = H / 16;
  const int tid = threadIdx.x, s = tid & 3, unit = tid >> 2;
  const int gate = ((s & 1) << 1) | (s >> 1), j = gate * H + unit;
  const int quad0 = (tid & 31) & ~3;
  float* h_cur = reinterpret_cast<float*>(hbuf[0]);
  float* h_nxt = reinterpret_cast<float*>(hbuf[1]);
  const float* x_row = xw + (size_t)blockIdx.x * T * H4;
  float* o_row = out + (size_t)blockIdx.x * T * H;
  float w_r[NCH][4][4];  // [chunk][k within the chunk][gate]
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        w_r[c][i][g] = __ldg(wh + (size_t)(4 * (4 * c + s) + i) * H4 + g * H + unit);
  if (tid < H) {
    h_cur[tid] = 0.0f;
    h_nxt[tid] = 0.0f;
  }
  // σ(x) = 1/(1 + 2^(−x·log2 e)); tanh(x) = 2σ(2x) − 1
  const float LOG2E = 1.4426950408889634f;
  const float act_m = gate == 2 ? -2.0f * LOG2E : -LOG2E;
  const float act_a = gate == 2 ? 2.0f : 1.0f, act_d = gate == 2 ? -1.0f : 0.0f;
  float c_reg = 0.0f;
  float x_next = __ldg(x_row + j);
  Stamps st = {};
  st.on = blockIdx.x == 0 && tid == 0;
  __syncthreads();
  const long long t_begin = clock64();
  st.start();
  for (int t = 0; t < T; ++t) {
    const float x = x_next;
    if (t + 1 < T) x_next = __ldg(x_row + (size_t)(t + 1) * H4 + j);
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float4 hv = *reinterpret_cast<const float4*>(h_cur + 4 * (4 * c + s));
#pragma unroll
      for (int g = 0; g < 4; ++g) p[g] = fmaf(hv.x, w_r[c][0][g], p[g]);
#pragma unroll
      for (int g = 0; g < 4; ++g) p[g] = fmaf(hv.y, w_r[c][1][g], p[g]);
#pragma unroll
      for (int g = 0; g < 4; ++g) p[g] = fmaf(hv.z, w_r[c][2][g], p[g]);
#pragma unroll
      for (int g = 0; g < 4; ++g) p[g] = fmaf(hv.w, w_r[c][3][g], p[g]);
    }
    st.mark(0);
    const bool b0 = s & 1, b1 = s & 2;
    const float q0 = (b0 ? p[2] : p[0]) + __shfl_xor_sync(0xffffffffu, b0 ? p[0] : p[2], 1);
    const float q1 = (b0 ? p[3] : p[1]) + __shfl_xor_sync(0xffffffffu, b0 ? p[1] : p[3], 1);
    const float sum = (b1 ? q1 : q0) + __shfl_xor_sync(0xffffffffu, b1 ? q0 : q1, 2);
    const float pre = x + sum;
    st.mark(1);
    const float v = fmaf(act_a, rcp_approx(1.0f + ex2_approx(pre * act_m)), act_d);
    st.mark(2);
    const float ig = __shfl_sync(0xffffffffu, v, quad0);
    const float gg = __shfl_sync(0xffffffffu, v, quad0 + 1);
    const float fg = __shfl_sync(0xffffffffu, v, quad0 + 2);
    const float og = __shfl_sync(0xffffffffu, v, quad0 + 3);
    st.mark(3);
    if (s == 0) {
      const float c_new = __fadd_rn(__fmul_rn(fg, c_reg), __fmul_rn(ig, gg));
      const float th = fmaf(2.0f, rcp_approx(1.0f + ex2_approx(c_new * (-2.0f * LOG2E))), -1.0f);
      const float h_new = __fmul_rn(og, th);
      c_reg = c_new;
      h_nxt[unit] = h_new;
      o_row[(size_t)t * H + unit] = h_new;
    }
    st.mark(4);
    __syncthreads();
    st.mark(5);
    float* swap = h_cur;
    h_cur = h_nxt;
    h_nxt = swap;
  }
  if (st.on) {
    for (int i = 0; i < 6; ++i) cycles[i] = st.sum[i];
    cycles[6] = clock64() - t_begin;
  }
}

extern "C" {

// One launch of the probe: xw (B, T, 4H), wh (H, 4H), out (B, T, H), cycles
// (7 int64 on the device). design 0 or 1, H 32 or 64. Returns cudaGetLastError().
int mmtpu_lstm_step_probe(const void* xw, const void* wh, void* out, void* cycles, int B, int T,
                          int H, int design, void* stream) {
  const float* x = static_cast<const float*>(xw);
  const float* w = static_cast<const float*>(wh);
  float* o = static_cast<float*>(out);
  long long* cy = static_cast<long long*>(cycles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || (H != 32 && H != 64) || (design != 0 && design != 1))
    return (int)cudaErrorInvalidValue;
  if (design == 0) {
    if (H == 32) probe_first<32><<<B, 128, 0, s>>>(x, w, o, T, cy);
    else probe_first<64><<<B, 256, 0, s>>>(x, w, o, T, cy);
  } else {
    if (H == 32) probe_ksplit<32><<<B, 128, 0, s>>>(x, w, o, T, cy);
    else probe_ksplit<64><<<B, 256, 0, s>>>(x, w, o, T, cy);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
