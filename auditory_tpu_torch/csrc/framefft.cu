// Fused frame extraction + DFT power + log power + log-mel filterbank.
//
// Replaces the Pallas TPU kernel auditory_tpu/ops/framefft.py::
// fused_frame_power_mel (its grouped, masked and merged modes). For every
// window i < n_windows starting at step*i + offset0 of signal row b (zero
// fill left of sample 0 and past the buffer end S):
//
//   power[b,i,k]     = re^2 + im^2 of the unnormalized win-point DFT, k < n_bins
//   log_power[b,i,k] = ln(power + log_offset), exactly-zero argument -> log_min
//   mel[b,i,f]       = ln(sum_k melw[k,f] * power[b,i,k] + mel_log_off),
//                      exactly-zero argument -> mel_log_min
//
// An analysis window, if any, is folded into the basis rows by the caller.
// NaN mel weights (the reference's 0/0 triangle quirk) propagate: the mel sum
// runs over every bin and never skips a zero or NaN weight.
//
// What bounds it on the H100: at B=512 x 3 s, 16 kHz, the grid has 155,648
// windows, each a 400 x 201 DFT contraction for re and for im -- about
// 155.6k * 2 * 400 * 201 FMA = 25 G FMA (50 GFLOP) of FP32 against a 98 MB
// signal read and 0.27 GB of outputs. That is compute-bound on the FP32 CUDA
// cores (67 TFLOP/s peak) until a later version moves the contraction onto
// the tensor cores.
//
// What this simple design does about it: one block owns TW consecutive
// windows of one row. It stages their shared signal span once into shared
// memory (the windows overlap 2.5x at the default geometry, so each sample
// is read from device memory once per block instead of once per window),
// and each thread keeps TW x KB re/im accumulators in registers for KB bins,
// so one shared-memory broadcast of a sample feeds 2*KB FMAs and one basis
// load from L2 feeds 2*TW FMAs. Sums run in a fixed order (n = 0..win-1,
// k = 0..n_bins-1) with no atomics, so the result is deterministic. The
// power of the block's windows stays in shared memory for the mel sums: it
// leaves the chip only when the caller asks for it.
//
// No --use_fast_math: logf must be the accurate one, because the exact-zero
// floors and the log-domain parity with the plain version depend on it.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 16;        // windows per block
constexpr int KB = 2;         // bins per thread per pass
constexpr int THREADS = 128;  // bins per pass = THREADS * KB

__device__ __forceinline__ float floored_log(float x, float floor_value) {
  return x == 0.0f ? floor_value : logf(x);
}

__global__ void __launch_bounds__(THREADS)
framefft_kernel(const float* __restrict__ sig, const float* __restrict__ cosb,
                const float* __restrict__ sinb, const float* __restrict__ melw,
                float* __restrict__ power_out, float* __restrict__ logp_out,
                float* __restrict__ mel_out, int S, int step, int offset0,
                int n_windows, int win, int n_bins, int k_pad, int n_mel,
                int m_pad, float log_offset, float log_min, float mel_log_off,
                float mel_log_min, int comp_log) {
  extern __shared__ float smem[];
  const int span = (TW - 1) * step + win;
  float* sig_s = smem;             // [span]
  float* pow_s = smem + span;      // [TW][n_bins]

  const int b = blockIdx.y;
  const int w0 = blockIdx.x * TW;  // first window of this block
  const int tw = min(TW, n_windows - w0);
  const long long start0 = (long long)offset0 + (long long)w0 * step;
  const float* row = sig + (long long)b * S;

  for (int t = threadIdx.x; t < span; t += THREADS) {
    const long long idx = start0 + t;
    sig_s[t] = (idx >= 0 && idx < S) ? row[idx] : 0.0f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < n_bins; k0 += THREADS * KB) {
    float re[TW][KB], im[TW][KB];
#pragma unroll
    for (int w = 0; w < TW; ++w)
#pragma unroll
      for (int j = 0; j < KB; ++j) re[w][j] = im[w][j] = 0.0f;

    int kk[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) kk[j] = k0 + threadIdx.x + j * THREADS;

    for (int n = 0; n < win; ++n) {
      float c[KB], s[KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const bool in = kk[j] < n_bins;
        c[j] = in ? __ldg(cosb + (long long)n * k_pad + kk[j]) : 0.0f;
        s[j] = in ? __ldg(sinb + (long long)n * k_pad + kk[j]) : 0.0f;
      }
#pragma unroll
      for (int w = 0; w < TW; ++w) {
        const float x = sig_s[w * step + n];
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          re[w][j] = fmaf(x, c[j], re[w][j]);
          im[w][j] = fmaf(x, s[j], im[w][j]);
        }
      }
    }

#pragma unroll
    for (int w = 0; w < TW; ++w) {
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int k = kk[j];
        if (w < tw && k < n_bins) {
          const float p = re[w][j] * re[w][j] + im[w][j] * im[w][j];
          pow_s[w * n_bins + k] = p;
          const long long o = ((long long)b * n_windows + w0 + w) * n_bins + k;
          if (power_out) power_out[o] = p;
          if (logp_out)
            logp_out[o] = comp_log ? floored_log(p + log_offset, log_min) : 0.0f;
        }
      }
    }
  }
  __syncthreads();

  // mel: threads stride over (window, filter) pairs; consecutive lanes take
  // consecutive filters of one window, so the power read is a shared-memory
  // broadcast and the weight read is coalesced
  for (int q = threadIdx.x; q < tw * n_mel; q += THREADS) {
    const int w = q / n_mel;
    const int f = q - w * n_mel;
    const float* p = pow_s + w * n_bins;
    float acc = 0.0f;
    for (int k = 0; k < n_bins; ++k)
      acc = fmaf(__ldg(melw + (long long)k * m_pad + f), p[k], acc);
    mel_out[((long long)b * n_windows + w0 + w) * n_mel + f] =
        floored_log(acc + mel_log_off, mel_log_min);
  }
}

}  // namespace

extern "C" int framefft_shared_bytes(int step, int win, int n_bins) {
  return (int)(sizeof(float) * ((TW - 1) * step + win + TW * n_bins));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// power / logp may be null: those outputs are then not written.
extern "C" int framefft_launch(const float* sig, const float* cosb,
                               const float* sinb, const float* melw,
                               float* power, float* logp, float* mel, int B,
                               int S, int step, int offset0, int n_windows,
                               int win, int n_bins, int k_pad, int n_mel,
                               int m_pad, float log_offset, float log_min,
                               float mel_log_off, float mel_log_min,
                               int comp_log, void* stream) {
  const int smem = framefft_shared_bytes(step, win, n_bins);
  cudaError_t err = cudaFuncSetAttribute(
      framefft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_windows + TW - 1) / TW, B);
  framefft_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      sig, cosb, sinb, melw, power, logp, mel, S, step, offset0, n_windows,
      win, n_bins, k_pad, n_mel, m_pad, log_offset, log_min, mel_log_off,
      mel_log_min, comp_log);
  return (int)cudaGetLastError();
}
