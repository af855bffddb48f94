// Fused frame extraction + DFT power + log power + log-mel filterbank on the
// Hopper tensor cores.
//
// Replaces the Pallas TPU kernel auditory_tpu/ops/framefft.py::
// fused_frame_power_mel (its grouped, masked and merged modes, and its
// `passes` grades). For every window i < n_windows starting at step*i +
// offset0 of signal row b (zero fill left of sample 0 and past the buffer
// end S):
//
//   power[b,i,k]     = re^2 + im^2 of the unnormalized win-point DFT, k < n_bins
//   log_power[b,i,k] = ln(power + log_offset), exactly-zero argument -> log_min
//   mel[b,i,f]       = ln(sum_k melw[k,f] * power[b,i,k] + mel_log_off),
//                      exactly-zero argument -> mel_log_min
//
// An analysis window, if any, is folded into the basis rows by the caller.
// NaN mel weights (the reference's 0/0 triangle quirk) propagate: the mel sum
// runs over every real bin and never skips a zero or NaN weight.
//
// Precision grades (JAX's `passes`): each float32 operand is split into
// NL = 1, 2 or 3 bf16 limbs (x = x0 + x1 + x2 exactly at 3 limbs) and the
// products x_i * c_j with i + j < NL are summed, smallest terms first in the
// order of JAX's _limb_dot: 6 products at NL = 3 (the exact float32 grade),
// 3 at NL = 2 (~2^-16 relative), 1 at NL = 1 (bf16-rounded operands). A
// product of two bf16 values is exact in FP32.
//
// What bounds it on the H100: at B=512 x 3 s, 16 kHz, 155,648 windows, the
// DFT contraction is 2 * 155,648 * 400 * 402 = 50.1 GFLOP per product; 6
// products at the dense bf16 rate (989 TFLOP/s) take 0.30 ms, and the mel
// sum (2.0 GFLOP of FP32 FMA, 0.03 ms at 67 TFLOP/s) and the 0.37 GB of
// signal and outputs (0.11 ms at 3.35 TB/s) fit under that. The FP32-core
// version this replaces could not go under 0.78 ms.
//
// The design: the contraction is a GEMM with M = the (row, window) pairs
// flattened over rows (so one tile packs several rows of a serving poll), K
// = win padded to 64, N = re|im of NB = 56 bins per pass.
//
// - B (the basis limbs): a small prologue kernel (framefft_pack) splits
//   the live cos/sin tensors on every call (a parameter may have changed)
//   into [limb][pass][112 rows][K_pad] bf16, rows = 7 groups of (8 cos
//   bins, 8 sin bins), so the re and im of one bin land in one thread's
//   accumulator registers. A producer warp streams [64 k x 112 rows] tiles
//   of it with TMA (128-byte swizzle) into a ring of 4-6 shared-memory
//   stages (as many as fit) guarded by mbarriers, one stage per (k chunk,
//   limb). Each basis byte loaded feeds the block's 64 or 128 windows (one
//   or two consumer warpgroups), where the FP32-core version reloaded the
//   basis from L2 for every 16 windows (~8 GB of L2 traffic per flagship
//   call; 1.5 GB now at 128 windows and 6 passes).
// - A (the windows) comes from registers: the block stages the signal span
//   of its windows once in shared memory as float32 with asynchronous
//   copies (zero fill at both edges), and each thread reads its fragment at
//   row stride `step`, so no frame is materialized and no alignment is
//   needed (step = 441 at 44.1 kHz is odd). The span is skewed (`pad`
//   floats after every `step` samples) so that the 8 windows a warp reads
//   at once fall 8 banks apart instead of on one bank (step = 160). The
//   fragment is split into its bf16 limbs in registers, and the next k16
//   step's fragment is loaded while the current products run. Holding the
//   limbs of the span instead (6 bytes a sample at 3 limbs) would not fit
//   227 KB beside the ring at 44.1 kHz (177 KB for 64 windows).
// - Where the whole span does not fit (a long step: 64 windows of 96 kHz
//   span 257 KB), the block stages it in pieces: `piece` samples of each
//   window at a time (a multiple of the k chunk), one row per window with
//   a row stride of piece + 8 floats (8 banks apart again), in a ring of
//   `pbufs` (3-4) piece buffers owned by a stager of STAGER_WARPS (2) warps
//   beside the producer warp. The stager walks the pieces in consumption
//   order (every pass walks all pieces; the ring wraps across passes),
//   waits for a buffer's `pempty` mbarrier and copies each window's row
//   from the 16-byte boundary before its piece, so that every row is
//   16-byte aligned at both ends whatever the step (441 and 882 are odd):
//   one bulk copy a row (cp.async.bulk, its bytes completing on the
//   buffer's `pfull` mbarrier), and 16- and 4-byte cp.async with zero fill
//   for a row across the signal's edges, landed on `pfull` by
//   cp.async.mbarrier.arrive.noinc. A bulk copy costs its warp ~55 cycles
//   to issue, so one warp could not keep up with two warpgroups (~7,000
//   cycles for a piece of 128 rows, against a k chunk's ~5,000). The
//   consumers wait on a piece's parity and each warp arrives on its
//   `pempty` when done with it: the k loop has no block-wide barrier and no
//   wait for copies, and the two warpgroups drift apart as in the whole
//   span. Each warpgroup's power tile overlays its own rows of the pass's
//   last piece buffer, which goes back to the stager after the epilogue;
//   the 29 KB that frees is what lets two warpgroups keep a deep basis
//   ring beside three piece buffers. Where the mel sums do not fit either
//   (many filters), `mel_glob` keeps the partial sums across passes in the
//   mel output itself and reads the weight rows from global memory
//   (L1/L2). ops/framefft.py::plan_layout picks a layout that fits
//   (framefft_shared_bytes gives its bytes), so every uniform grid runs
//   here; each layout is its own instantiation.
// - Products: wgmma m64n112k16, bf16 x bf16 -> FP32, into a partial sum of
//   one k16 step that is then added in FP32 (round to nearest) into the
//   pass's accumulator: the tensor core's internal sum of products rounds
//   coarser than an FP32 add. Summed over a whole pass inside the tensor
//   core, the 44.1 kHz power leaves the float32 bounds; over two k16 steps,
//   the 8 kHz log mel of quiet bands does; promoted every step, every
//   geometry stays within them. 56 + 56 accumulator registers a thread.
// - Epilogue per pass: power = re^2 + im^2 in registers (IEEE mul and add,
//   as the plain version), into shared memory; power and log power stored
//   row-contiguous when emitted; the mel sum is FP32 FMA on the CUDA cores
//   over the real bins in ascending order, with the pass's weight rows
//   copied into shared memory during the products and the partial sums
//   carried across passes in shared memory, so NaN weights and exact zeros
//   behave as in the plain version.
// - No atomics and no split-K: every sum has a fixed order, so results are
//   deterministic.
//
// Known limits, for later work: every k16 step waits for its products
// before the partial sum is promoted, so one warpgroup's wgmma latency is
// hidden only by the other's; the epilogue of a pass (stores, mel) runs
// while the tensor cores idle; one block fills an SM's shared memory; in
// pieces every pass stages the whole span again (1.2 MB a block and pass
// at 96 kHz), so a k chunk costs ~1.25x the whole span's; the mel sums in
// global memory make the epilogue ~3x as long.
//
// No --use_fast_math: logf must be the accurate one, because the exact-zero
// floors and the log-domain parity with the plain version depend on it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NB = 56;                 // bins per pass
constexpr int NCOL = 2 * NB;           // B rows (re|im columns) per pass
constexpr int NACC = NCOL / 2;         // accumulator floats a thread, m64n112
constexpr int KC = 64;                 // k per TMA tile (128 bytes of bf16)
constexpr int MAX_RING = 6;            // shared-memory stages, at most
constexpr int STAGE_BYTES = NCOL * KC * 2;  // 14,336 = 14 x 1024
constexpr int MIN_PBUF = 3;            // piece buffers of the stager's ring
constexpr int MAX_PBUF = 4;
constexpr int PLD = NB + 1;            // power row stride in shared memory
constexpr int MF = 16;                 // mel filters a thread sums at once
// the stager's warps: a bulk copy costs its warp ~55 cycles to issue, so
// one warp issues a piece of 128 rows in ~7,000 cycles, more than the k
// chunk it feeds (three spill registers)
constexpr int STAGER_WARPS = 2;
constexpr int STAGERS = 32 * STAGER_WARPS;  // stager threads

// threads of a block: the consumer warpgroups, the producer warp and, in
// pieces, the stager's warps
__host__ __device__ constexpr int side_threads(bool pieced) {
  return pieced ? 32 + STAGERS : 32;
}

struct Params {
  const float* sig;
  const float* melw;
  float* power;
  float* logp;
  float* mel;
  long long total;  // B * n_windows
  int S, step, offset0, n_windows, win, n_bins, n_mel, m_pad;
  int n_pass, n_kc, span_cap, pad, ring, comp_log;
  // staged piece (0: the whole span), its row stride, the piece buffers
  int piece, rs, pbufs, mel_glob;
  float log_offset, log_min, mel_log_off, mel_log_min;
};

#ifdef FRAMEFFT_PHASES
// clock64 of thread 0 at a block's phase boundaries, and the cycles thread
// 0 waited on the piece ring (16) and on the basis ring (17), read by
// framefft_phases.py; the default build has no stamps
constexpr int PHASE_SLOTS = 18;
__device__ long long g_phase_clock[8192][PHASE_SLOTS];
#define PHASE_MARK(i)                                          \
  do {                                                         \
    if (threadIdx.x == 0 && blockIdx.x < 8192)                 \
      g_phase_clock[blockIdx.x][i] = clock64();                \
  } while (0)
#define TIMED_WAIT(bar, parity, acc)                           \
  do {                                                         \
    const long long t_ = clock64();                            \
    mbar_wait(bar, parity);                                    \
    acc += clock64() - t_;                                     \
  } while (0)
#define PHASE_STORE(i, v)                                      \
  do {                                                         \
    if (threadIdx.x == 0 && blockIdx.x < 8192)                 \
      g_phase_clock[blockIdx.x][i] = (v);                      \
  } while (0)
#else
#define PHASE_MARK(i) \
  do {               \
  } while (0)
#define TIMED_WAIT(bar, parity, acc) mbar_wait(bar, parity)
#define PHASE_STORE(i, v) \
  do {                   \
  } while (0)
#endif

__device__ __forceinline__ float floored_log(float x, float floor_value) {
  return x == 0.0f ? floor_value : logf(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// adds `bytes` to the transactions `bar`'s phase waits for, without an
// arrive
__device__ __forceinline__ void mbar_expect_tx_only(uint64_t* bar,
                                                    uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, by the copy engine; completes its bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// 4-byte asynchronous copy global -> shared; zero fill when !valid. No
// memory clobber: the copies land only at a wait_group, and every wait and
// barrier below is one, so loads of other shared data may move past them.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// 16-byte asynchronous copy (both addresses 16-byte aligned); zero fill
// when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// An arrive on `bar` once every cp.async this thread issued so far has
// landed; .noinc: the barrier's expected count includes this arrive
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Shared-memory length of a span segment of L samples: `pad` floats after
// every `step` samples, so that consecutive windows start `step + pad`
// apart, 8 banks apart, and a warp's fragment loads hit distinct banks.
__device__ __host__ __forceinline__ int skewed_len(int L, int step, int pad) {
  return L + pad * ((L + step - 1) / step);
}

// K-major B tile of 112 rows x 128 bytes, 128-byte swizzle: 8-row groups
// 1024 bytes apart; a k16 step advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// d (+)= A(registers, m64 x k16 bf16) * B(shared, k16 x n112 bf16), FP32
__device__ __forceinline__ void wgmma_m64n112(float (&d)[NACC],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55},"
      " {%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The thread's A fragment of one k16 step, split into NL bf16 limbs: register
// q holds rows g (q even) / g + 8 (q odd) at k = k0 + 2*tig + 8*(q >> 1) and
// the next k (lower half first). Positions at or past win read as zero.
template <int NL>
__device__ __forceinline__ void load_a(const float* span, const int (&base)[2],
                                       const bool (&valid)[2], int k0, int tig,
                                       int win, int step, int pad,
                                       uint32_t (&a)[NL][4]) {
  // sample k of a window lies at base + k + pad * (k / step); within a k16
  // step k / step is k0 / step or one more where pad > 0 (step >= 16; a
  // shorter step, and a staged piece, are unskewed: pad = 0)
  const int kb = k0 / step, next = (kb + 1) * step;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int h = q & 1;
    const int k = k0 + 2 * tig + 8 * (q >> 1);
    const int ax = base[h] + k + pad * kb + (k >= next ? pad : 0);
    const int ay = ax + 1 + (k + 1 == next ? pad : 0);
    float x = (valid[h] && k < win) ? span[ax] : 0.0f;
    float y = (valid[h] && k + 1 < win) ? span[ay] : 0.0f;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const __nv_bfloat162 hb = __floats2bfloat162_rn(x, y);
      a[l][q] = bf2_bits(hb);
      if (l + 1 < NL) {
        const float2 f = __bfloat1622float2(hb);
        x -= f.x;  // exact: the residual of a bf16 rounding
        y -= f.y;
      }
    }
  }
}

// The limb products of JAX's _limb_dot, smallest first: product t of NL
// limbs is x limb term_i(NL, t) times basis limb term_j(NL, t).
__host__ __device__ constexpr int n_terms(int nl) { return nl * (nl + 1) / 2; }
__host__ __device__ constexpr int term_i(int nl, int t) {
  return nl == 3 ? (t == 0 ? 2 : t == 1 ? 1 : t == 3 ? 1 : 0)
       : nl == 2 ? (t == 0 ? 1 : 0) : 0;
}
__host__ __device__ constexpr int term_j(int nl, int t) {
  return nl == 3 ? (t == 1 ? 1 : t == 2 ? 2 : t == 4 ? 1 : 0)
       : nl == 2 ? (t == 1 ? 1 : 0) : 0;
}

// sum[i] += w[k * ld + i] * pr[k] over k < nbp in ascending order (FP32
// FMA), for MF filters; w 16-byte aligned, ld a multiple of 4
__device__ __forceinline__ void mel_sum(float (&sum)[MF], const float* pr,
                                        const float* w, int ld, int nbp) {
#pragma unroll 2
  for (int k = 0; k < nbp; ++k) {
    const float pv = pr[k];
    const float4* w4 = reinterpret_cast<const float4*>(w + k * ld);
#pragma unroll
    for (int v = 0; v < MF / 4; ++v) {
      const float4 x = w4[v];
      sum[4 * v + 0] = fmaf(x.x, pv, sum[4 * v + 0]);
      sum[4 * v + 1] = fmaf(x.y, pv, sum[4 * v + 1]);
      sum[4 * v + 2] = fmaf(x.z, pv, sum[4 * v + 2]);
      sum[4 * v + 3] = fmaf(x.w, pv, sum[4 * v + 3]);
    }
  }
}

// The 16-byte group j of window r's piece row `dst`: samples idx .. idx + 3
// of its signal row (at `off` in the batch), idx = f - sh + 4 j, zero
// filled outside [0, S)
__device__ __forceinline__ void stage_group(const Params& p, float* dst,
                                            long long off, int f, int sh,
                                            int j) {
  const int idx = f - sh + 4 * j;  // the row's sample at dst[4 j]
  if (idx >= 0 && idx + 4 <= p.S) {
    cp_async16(dst + 4 * j, p.sig + off + idx, true);
  } else if (idx + 4 <= 0 || idx >= p.S) {
    cp_async16(dst + 4 * j, p.sig, false);
  } else {
    for (int e = 0; e < 4; ++e) {
      const bool in = idx + e >= 0 && idx + e < p.S;
      cp_async4(dst + 4 * j + e, p.sig + (in ? off + idx + e : 0), in);
    }
  }
}

// The stager's copies of samples [k_lo, k_lo + piece) of each of the
// block's M windows into row r of `buf` (stride rs), zero filled outside
// the signal, from the 16-byte boundary at or before the window's sample
// k_lo: sample k_lo + c lands at r * rs + sh + c, sh = that sample's flat
// index mod 4 (the same for every piece), so a row is piece / 4 + 1
// 16-byte groups, aligned at both ends whatever the step. Stager thread
// `st` takes every STAGERS-th row: a row inside [0, S) is one bulk copy
// (the copy engine moves it and reports its bytes to `full`, so the thread
// issues one instruction a row), a row across the signal's edges 16- and
// 4-byte copies with zero fill, which reach `full` through the thread's
// arrive after them. Window r starts at sample first[r] of batch row
// rowb[r] (< 0: past the batch, left as it is: load_a reads no such
// window), the block's table built once, so that no copy waits on a
// division.
__device__ __forceinline__ void stage_piece(const Params& p, float* buf,
                                            const int* rowb, const int* first,
                                            int M, int k_lo, int st,
                                            uint64_t* full) {
  const int groups = p.piece / 4 + 1;
  // a row's first sample (16-byte aligned) and whether it is a bulk copy
  auto start = [&](int r, long long& off, int& f, int& sh) {
    off = (long long)rowb[r] * p.S;
    f = first[r] + k_lo;
    sh = (int)((off + f) & 3);
    return rowb[r] >= 0 && f - sh >= 0 && f - sh + 4 * groups <= p.S;
  };
  // one expect-tx for the warp's bulk bytes, before any of them is issued
  unsigned n_bulk = 0;
  for (int r = st; r < M; r += STAGERS) {
    long long off;
    int f, sh;
    n_bulk += start(r, off, f, sh);
  }
  n_bulk = __reduce_add_sync(0xffffffffu, n_bulk);
  if (st % 32 == 0 && n_bulk) mbar_expect_tx_only(full, 16 * groups * n_bulk);
  __syncwarp();
  for (int r = st; r < M; r += STAGERS) {
    long long off;
    int f, sh;
    float* dst = buf + r * p.rs;
    if (start(r, off, f, sh))
      bulk_load(dst, p.sig + off + f - sh, 16 * groups, full);
    else if (rowb[r] >= 0)
      for (int j = 0; j < groups; ++j) stage_group(p, dst, off, f, sh, j);
  }
}

// PIECED: the signal staged in pieces (p.piece > 0); MEL_GLOB: the mel
// sums in global memory (p.mel_glob). Separate instantiations, so that the
// whole-span, shared-memory layout carries none of their code.
template <int NL, bool PIECED, bool MEL_GLOB>
__global__ void __launch_bounds__(2 * 128 + side_threads(PIECED), 1)
framefft_wgmma(const __grid_constant__ CUtensorMap bmap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  PHASE_MARK(15);
  const int consumers = (blockDim.x - side_threads(PIECED)) / 128;
  const int M = 64 * consumers;  // windows per block
  unsigned char* ring = smem;
  const int ring_n = p.ring;
  float* span = reinterpret_cast<float*>(smem + ring_n * STAGE_BYTES);
  const int n_mel16 = (p.n_mel + MF - 1) / MF * MF;
  const int mel_sm = MEL_GLOB ? 0 : n_mel16;  // mel floats in shared memory
  // per warpgroup [64][PLD]; in pieces it overlays the warpgroup's own rows
  // of the pass's last piece buffer instead
  float* pow_s = span + p.span_cap;
  float* mel_s = pow_s + (PIECED ? 0 : M * PLD);  // per warpgroup [n_mel16][64]
  float* ws = mel_s + M * mel_sm;        // [NB][n_mel16], both warpgroups
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + NB * mel_sm);
  uint64_t* empty = full + MAX_RING;
  // piece mode: the stager's ring (pfull: one arrive per stager thread
  // once its cp.async copies have landed, and the bulk copies' bytes;
  // pempty: one arrive per consumer warp), after the piece buffers the
  // table of the block's windows: batch row (< 0: past the batch) and
  // first sample
  uint64_t* pfull = empty + MAX_RING;
  uint64_t* pempty = pfull + MAX_PBUF;
  const int buf_floats = M * p.rs;
  int* rowb = reinterpret_cast<int*>(span + p.pbufs * buf_floats);
  int* first = rowb + M;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = p.n_windows, step = p.step, win = p.win;
  const long long m0 = (long long)blockIdx.x * M;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring_n; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * consumers);  // one arrive per consumer warp
    }
    for (int s = 0; s < (PIECED ? p.pbufs : 0); ++s) {
      mbar_init(&pfull[s], STAGERS);
      mbar_init(&pempty[s], 4 * consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (PIECED) {
    for (int r = threadIdx.x; r < M; r += blockDim.x) {
      const long long gm = m0 + r;
      const long long b = gm / nw;
      rowb[r] = gm < p.total ? (int)b : -1;
      first[r] = p.offset0 + (int)(gm - b * nw) * step;
    }
  }
  __syncthreads();

  // piece mode: chunks per piece, pieces per pass
  const int piece_kc = p.piece / KC;
  const int n_pieces = PIECED ? (p.n_kc + piece_kc - 1) / piece_kc : 1;
  if (PIECED && warp > 4 * consumers) {
    // stager: every pass's pieces in consumption order through the ring
    int s = 0;
    uint32_t phase = 0;
    for (int pass = 0; pass < p.n_pass; ++pass)
      for (int pc = 0; pc < n_pieces; ++pc) {
        mbar_wait(&pempty[s], phase ^ 1);
        stage_piece(p, span + s * buf_floats, rowb, first, M, pc * p.piece,
                    threadIdx.x - 128 * consumers - 32, &pfull[s]);
        cp_async_arrive_noinc(&pfull[s]);
        if (++s == p.pbufs) { s = 0; phase ^= 1; }
      }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  if (warp == 4 * consumers) {
    // producer: the (pass, k chunk, limb) tiles of B in consumption order
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int pass = 0; pass < p.n_pass; ++pass)
        for (int kc = 0; kc < p.n_kc; ++kc)
          for (int l = 0; l < NL; ++l) {
            mbar_wait(&empty[s], phase ^ 1);
            mbar_expect_tx(&full[s], STAGE_BYTES);
            tma_load_2d(ring + s * STAGE_BYTES, &bmap, &full[s], kc * KC,
                        (l * p.n_pass + pass) * NCOL);
            if (++s == ring_n) { s = 0; phase ^= 1; }
          }
    }
    return;
  }

  // ---- consumers --------------------------------------------------------
  PHASE_MARK(0);
  const long long b0 = m0 / nw;
  const int wlo0 = (int)(m0 - b0 * nw);
  const long long m_last = min(m0 + M, p.total) - 1;
  const int nseg = (int)(m_last / nw - b0) + 1;
  const int L0 = (min(nw - 1, wlo0 + M - 1) - wlo0) * step + win;
  const int Lf = (nw - 1) * step + win;
  const int last_w = (int)(m_last % nw);

  // the span of the block's windows, one segment per row, zero filled, in
  // the skewed layout (skewed_len); asynchronous copies, all in flight
  const int pad = p.pad;
  const int S0 = skewed_len(L0, step, pad), Sf = skewed_len(Lf, step, pad);
  const int nthr = 128 * consumers;
  const float inv_step = 1.0f / step;
  if (!PIECED) {
    for (int r = 0; r < nseg; ++r) {
      const int wstart = r == 0 ? wlo0 : 0;
      const int len = ((r == nseg - 1 ? last_w : nw - 1) - wstart) * step + win;
      float* dst = span + (r == 0 ? 0 : S0 + (r - 1) * Sf);
      const long long start = (long long)p.offset0 + (long long)wstart * step;
      const float* row = p.sig + (b0 + r) * (long long)p.S;
      for (int t = threadIdx.x; t < len; t += nthr) {
        const long long idx = start + t;
        const bool in = idx >= 0 && idx < p.S;
        int q = (int)(t * inv_step);  // t / step, corrected for rounding
        q -= q * step > t;
        q += (q + 1) * step <= t;
        cp_async4(dst + t + pad * q, in ? row + idx : row, in);
      }
    }
    cp_async_wait_all();
    named_bar(1, nthr);
  }
  PHASE_MARK(1);

  const int wg = warp / 4, wl = warp % 4;
  const int g = lane >> 2, tig = lane & 3;
  const int tid_wg = threadIdx.x - 128 * wg;
  int base[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = 64 * wg + 16 * wl + g + 8 * h;  // the block's window
    const long long gm = m0 + rl;
    valid[h] = gm < p.total;
    const long long b = gm / nw;
    const int w = (int)(gm - b * nw);
    const int seg = (int)(b - b0);
    base[h] = !valid[h] ? 0
              : PIECED ? rl * p.rs + (int)(((long long)rowb[rl] * p.S + first[rl]) & 3)
              : seg == 0 ? (w - wlo0) * (step + pad)
                         : S0 + (seg - 1) * Sf + w * (step + pad);
  }
  // piece mode: the piece ring's slot and parity, the slot being read and
  // its first k, the slot of the pass's last piece (held through the
  // epilogue: the power tile overlays it); the staged rows are unskewed
  int ps = 0, cur_buf = 0, cur_k = 0, held = 0;
  uint32_t pphase = 0;
  const int apad = PIECED ? 0 : pad;
#ifdef FRAMEFFT_PHASES
  long long wait_piece = 0, wait_basis = 0;
#endif

  float* ms = mel_s + 64 * wg * n_mel16;
  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) part[i] = 0.0f;
  int s = 0;
  uint32_t phase = 0;

  for (int pass = 0; pass < p.n_pass; ++pass) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
    // this pass's mel weight rows, for broadcast reads in the epilogue, once
    // both warpgroups are done with the previous pass's (and with pw)
    const int nbp = min(NB, p.n_bins - pass * NB);
    if (pass > 0) named_bar(1, nthr);
    for (int idx = threadIdx.x; idx < nbp * mel_sm; idx += nthr) {
      const int k = idx / n_mel16, f = idx - k * n_mel16;
      cp_async4(ws + idx, p.melw + (long long)(pass * NB + k) * p.m_pad + f, true);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int kc = 0; kc < p.n_kc; ++kc) {
      int abase[2] = {base[0], base[1]};
      if (PIECED && kc % piece_kc == 0) {
        // entering a piece: wait until the stager's copies have landed
        TIMED_WAIT(&pfull[ps], pphase, wait_piece);
        cur_buf = ps;
        cur_k = kc / piece_kc * p.piece;
      }
      if (PIECED) {
        abase[0] += cur_buf * buf_floats - cur_k;
        abase[1] += cur_buf * buf_floats - cur_k;
      }
      unsigned char* tile[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        int sl = s + l;
        uint32_t ph = phase;
        if (sl >= ring_n) { sl -= ring_n; ph ^= 1; }
        TIMED_WAIT(&full[sl], ph, wait_basis);
        tile[l] = ring + sl * STAGE_BYTES;
      }
      // A fragments in two register sets: step j + 1's are loaded while
      // step j's products run
      uint32_t a[2][NL][4];
      load_a<NL>(span, abase, valid, kc * KC, tig, win, step, apad, a[0]);
#pragma unroll
      for (int j = 0; j < KC / 16; ++j) {
        const int k0 = kc * KC + 16 * j;
        if (k0 >= win) break;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int t = 0; t < n_terms(NL); ++t) {
          wgmma_m64n112(part, a[j & 1][term_i(NL, t)],
                        b_desc(tile[term_j(NL, t)] + 32 * j), t > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (j + 1 < KC / 16 && k0 + 16 < win)
          load_a<NL>(span, abase, valid, k0 + 16, tig, win, step, apad,
                     a[(j + 1) & 1]);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(part);
#pragma unroll
        for (int l = 0; l < NL; ++l) fence_frag(a[j & 1][l]);
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] += part[i];
      }
      // this warp is done with the chunk's tiles
      if (lane == 0) {
#pragma unroll
        for (int l = 0; l < NL; ++l) mbar_arrive(&empty[(s + l) % ring_n]);
      }
      s += NL;
      if (s >= ring_n) { s -= ring_n; phase ^= 1; }
      if (PIECED && ((kc + 1) % piece_kc == 0 || kc + 1 == p.n_kc)) {
        // and with the piece: its buffer goes back to the stager, but for
        // the pass's last, which goes back after the epilogue
        if (kc + 1 == p.n_kc)
          held = ps;
        else if (lane == 0)
          mbar_arrive(&pempty[ps]);
        if (++ps == p.pbufs) { ps = 0; pphase ^= 1; }
      }
    }

    if (pass < 6) PHASE_MARK(2 + 2 * pass);
    float* pw = PIECED ? span + held * buf_floats + 64 * wg * p.rs
                       : pow_s + 64 * wg * PLD;
    // (in pieces, once every warp of the warpgroup is done reading its rows)
    if (PIECED) named_bar(2 + wg, 128);
    // power of this pass's bins, [64 windows][NB] of this warpgroup
#pragma unroll
    for (int q = 0; q < NB / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float re = acc[8 * q + 2 * h + e];
          const float im = acc[8 * q + 4 + 2 * h + e];
          pw[(16 * wl + g + 8 * h) * PLD + 8 * q + 2 * tig + e] =
              __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    named_bar(1, nthr);

    if (p.power || p.logp) {
      for (int idx = tid_wg; idx < 64 * NB; idx += 128) {
        const int r = idx / NB, c = idx - r * NB;
        const long long gm = m0 + 64 * wg + r;
        if (c < nbp && gm < p.total) {
          const float pv = pw[r * PLD + c];
          const long long o = gm * p.n_bins + pass * NB + c;
          if (p.power) p.power[o] = pv;
          if (p.logp)
            p.logp[o] = p.comp_log ? floored_log(pv + p.log_offset, p.log_min)
                                   : 0.0f;
        }
      }
    }
    // mel: each thread sums MF filters of one window (warp-uniform filters,
    // so the weight loads are broadcasts), over this pass's bins in order
    const bool last = pass == p.n_pass - 1;
    const int r = tid_wg & 63;
    const long long gm = m0 + 64 * wg + r;
    const float* pr = pw + r * PLD;
    // (mel_glob: the partial sums of the earlier passes are in the mel
    // output, written by this thread, and the weights are read from global
    // memory)
    float* mrow = p.mel + gm * p.n_mel;
    for (int f0 = (tid_wg >> 6) * MF; f0 < p.n_mel; f0 += 2 * MF) {
      float sum[MF];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        sum[i] = pass == 0 ? 0.0f
                 : !MEL_GLOB ? ms[(f0 + i) * 64 + r]
                 : (gm < p.total && f0 + i < p.n_mel) ? mrow[f0 + i] : 0.0f;
      // the pass's weight rows: from shared memory, or global (MEL_GLOB)
      if (!MEL_GLOB)
        mel_sum(sum, pr, ws + f0, n_mel16, nbp);
      else
        mel_sum(sum, pr, p.melw + (long long)pass * NB * p.m_pad + f0, p.m_pad,
                nbp);
      if (!last && !MEL_GLOB) {
#pragma unroll
        for (int i = 0; i < MF; ++i) ms[(f0 + i) * 64 + r] = sum[i];
      } else if (!last) {
        if (gm < p.total) {
#pragma unroll
          for (int i = 0; i < MF; ++i)
            if (f0 + i < p.n_mel) mrow[f0 + i] = sum[i];
        }
      } else if (gm < p.total) {
#pragma unroll
        for (int i = 0; i < MF; ++i)
          if (f0 + i < p.n_mel)
            p.mel[gm * p.n_mel + f0 + i] =
                floored_log(sum[i] + p.mel_log_off, p.mel_log_min);
      }
    }
    if (PIECED) {
      // this warp is done with the power tile: the held buffer goes back
      // (its stores ordered before the copy engine's next writes there)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&pempty[held]);
    }
    if (pass < 6) PHASE_MARK(3 + 2 * pass);
  }
  PHASE_STORE(16, wait_piece);
  PHASE_STORE(17, wait_basis);
}

// The B operand from the float32 basis [win, ld] (cos and sin): bf16 limbs
// [nl][n_pass][112][k_pad], rows of pass p = 7 groups of (8 cos bins, 8 sin
// bins) from bin 56p; bins >= n_bins and k >= win are zero. The plain
// version is ops/framefft.py::pack_basis_limbs.
__global__ void framefft_pack(const float* __restrict__ cosb,
                              const float* __restrict__ sinb, int ld, int win,
                              int n_bins, int n_pass, int k_pad, int nl,
                              __nv_bfloat16* __restrict__ out) {
  const long long n = (long long)n_pass * NCOL * k_pad;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i % k_pad);
    const int row = (int)(i / k_pad);
    const int pass = row / NCOL, rr = row - pass * NCOL;
    const int bin = pass * NB + (rr / 16) * 8 + rr % 8;
    const float* src = (rr / 8) % 2 ? sinb : cosb;
    float x = (bin < n_bins && k < win) ? src[(long long)k * ld + bin] : 0.0f;
    for (int l = 0; l < nl; ++l) {
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      out[l * n + i] = h;
      x -= __bfloat162float(h);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// pad floats after every `step` samples: consecutive windows 8 banks apart
// (a step shorter than a k16 step stays unskewed, as load_a requires)
int skew_pad(int step) { return step < 16 ? 0 : ((8 - step) % 32 + 32) % 32; }

int span_cap(int step, int win, int n_windows, int consumers) {
  const int M = 64 * consumers;
  const int nseg = min(M, 2 + (M - 2) / n_windows);
  const int cap = M * step + nseg * max(win - step, 0);
  const int skewed = cap + skew_pad(step) * (cap / step + nseg + 1);
  return (skewed + 3) / 4 * 4;
}

// floats of one block's staged signal: the whole span of its windows, or
// (piece > 0) `pbufs` buffers of one row of piece + 8 floats per window and
// the windows' table (two ints each)
int staged_floats(int step, int win, int n_windows, int consumers, int piece,
                  int pbufs) {
  return piece ? 64 * consumers * (pbufs * (piece + 8) + 2)
               : span_cap(step, win, n_windows, consumers);
}

template <int NL, bool PIECED, bool MEL_GLOB>
int launch_wgmma(dim3 grid, dim3 block, int smem, cudaStream_t st,
                 const CUtensorMap& map, const Params& p) {
  const cudaError_t err = cudaFuncSetAttribute(
      framefft_wgmma<NL, PIECED, MEL_GLOB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  framefft_wgmma<NL, PIECED, MEL_GLOB><<<grid, block, smem, st>>>(map, p);
  return (int)cudaGetLastError();
}

template <int NL>
int launch_layout(dim3 grid, dim3 block, int smem, cudaStream_t st,
                  const CUtensorMap& map, const Params& p) {
  if (p.piece > 0)
    return p.mel_glob ? launch_wgmma<NL, true, true>(grid, block, smem, st, map, p)
                      : launch_wgmma<NL, true, false>(grid, block, smem, st, map, p);
  return p.mel_glob ? launch_wgmma<NL, false, true>(grid, block, smem, st, map, p)
                    : launch_wgmma<NL, false, false>(grid, block, smem, st, map, p);
}

}  // namespace

extern "C" int framefft_bins_per_pass() { return NB; }
extern "C" int framefft_k_chunk() { return KC; }

// Packs the basis limbs into `out` (bf16, n_limbs * n_pass * 112 * k_pad
// values) on `stream`; returns cudaGetLastError().
extern "C" int framefft_pack_launch(const float* cosb, const float* sinb,
                                    int ld, int win, int n_bins, int n_limbs,
                                    int k_pad, void* out, void* stream) {
  const int n_pass = (n_bins + NB - 1) / NB;
  const long long n = (long long)n_pass * NCOL * k_pad;
  const int blocks = (int)min((n + 255) / 256, 1024LL);
  framefft_pack<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      cosb, sinb, ld, win, n_bins, n_pass, k_pad, n_limbs,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block with `consumers` (1 or 2) warpgroups,
// `ring` stages, the signal staged whole (piece 0) or in `pbufs` buffers of
// `piece` samples, and the mel sums in shared (mel_glob 0) or global memory.
extern "C" int framefft_shared_bytes(int step, int win, int n_mel,
                                     int n_windows, int consumers, int ring,
                                     int piece, int pbufs, int mel_glob) {
  const int M = 64 * consumers;
  const int mel_sm = mel_glob ? 0 : (n_mel + MF - 1) / MF * MF;
  // (in pieces the power tiles overlay a piece buffer)
  return 1024 + ring * STAGE_BYTES +
         4 * (staged_floats(step, win, n_windows, consumers, piece, pbufs) +
              (piece ? 0 : M * PLD) + M * mel_sm + NB * mel_sm) +
         2 * (MAX_RING + (piece ? MAX_PBUF : 0)) * 8;
}

// Launches on `stream` with a layout of ops/framefft.py::plan_layout.
// Returns 0 when launched, a CUDA error code, or -1 (no
// cuTensorMapEncodeTiled entry point) / -1000 - CUresult (the tensor map
// was refused). basis: bf16
// [n_limbs * n_pass * 112, k_pad], k_pad a multiple of 64; melw: m_pad a
// multiple of 16, 16-byte aligned. power / logp may be null: those outputs
// are not written.
extern "C" int framefft_launch(const float* sig, const void* basis, int k_pad,
                               const float* melw, float* power, float* logp,
                               float* mel, int B, int S, int step, int offset0,
                               int n_windows, int win, int n_bins, int n_mel,
                               int m_pad, int n_limbs, int consumers, int ring,
                               int piece, int pbufs, int mel_glob,
                               float log_offset,
                               float log_min, float mel_log_off,
                               float mel_log_min, int comp_log, void* stream) {
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return -1;
  const int n_pass = (n_bins + NB - 1) / NB;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad,
                              (cuuint64_t)n_limbs * n_pass * NCOL};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad * 2};
  const cuuint32_t box[2] = {KC, NCOL};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(basis),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -1000 - (int)res;

  Params p;
  p.sig = sig;
  p.melw = melw;
  p.power = power;
  p.logp = logp;
  p.mel = mel;
  p.total = (long long)B * n_windows;
  p.S = S;
  p.step = step;
  p.offset0 = offset0;
  p.n_windows = n_windows;
  p.win = win;
  p.n_bins = n_bins;
  p.n_mel = n_mel;
  p.m_pad = m_pad;
  p.n_pass = n_pass;
  p.n_kc = k_pad / KC;
  p.span_cap = staged_floats(step, win, n_windows, consumers, piece, pbufs);
  p.pad = skew_pad(step);
  p.piece = piece;
  p.rs = piece + 8;
  p.pbufs = piece ? pbufs : 0;
  p.mel_glob = mel_glob != 0;
  p.ring = ring;
  p.comp_log = comp_log;
  p.log_offset = log_offset;
  p.log_min = log_min;
  p.mel_log_off = mel_log_off;
  p.mel_log_min = mel_log_min;

  if (ring < n_limbs || ring > MAX_RING || piece < 0 || piece % KC ||
      m_pad % MF || (piece && (pbufs < MIN_PBUF || pbufs > MAX_PBUF)))
    return (int)cudaErrorInvalidValue;
  const int smem = framefft_shared_bytes(step, win, n_mel, n_windows,
                                         consumers, ring, piece, pbufs,
                                         mel_glob);
  const int M = 64 * consumers;
  const dim3 grid((unsigned)((p.total + M - 1) / M));
  const dim3 block(128 * consumers + side_threads(piece > 0));
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_limbs) {
    case 1: return launch_layout<1>(grid, block, smem, st, map, p);
    case 2: return launch_layout<2>(grid, block, smem, st, map, p);
    case 3: return launch_layout<3>(grid, block, smem, st, map, p);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef FRAMEFFT_PHASES
extern "C" int framefft_phase_clock(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase_clock, sizeof(g_phase_clock));
}
#endif
