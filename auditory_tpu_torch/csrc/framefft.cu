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
// The mel sum is, bit for bit, the dense sum over every real bin in
// ascending order (FP32 FMA), so NaN mel weights (the reference's 0/0
// triangle quirk) propagate and exact zeros floor as in the plain version;
// it runs only over each filter's band (below).
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
// sum (351 nonzero weights a window: 0.11 GFLOP of FP32 FMA) and the 0.37
// GB of signal and outputs (0.11 ms at 3.35 TB/s) fit under that. The
// FP32-core version this replaces could not go under 0.78 ms.
//
// The design: the contraction is a GEMM with M = the (row, window) pairs
// flattened over rows (so one tile packs several rows of a serving poll), K
// = win padded to 64, N = re|im of NB = 56 bins per pass.
//
// - B (the basis limbs): a small prologue kernel (framefft_prologue) splits
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
//   ring beside three piece buffers. ops/framefft.py::plan_layout picks a
//   layout that fits (framefft_shared_bytes gives its bytes), so every
//   uniform grid runs here; the whole span and pieces are two
//   instantiations, each at three limb counts.
// - Products: wgmma m64n112k16, bf16 x bf16 -> FP32, into a partial sum of
//   one k16 step that is then added in FP32 (round to nearest) into the
//   pass's accumulator: the tensor core's internal sum of products rounds
//   coarser than an FP32 add. Summed over a whole pass inside the tensor
//   core, the 44.1 kHz power leaves the float32 bounds; over two k16 steps,
//   the 8 kHz log mel of quiet bands does; promoted every step, every
//   geometry stays within them. 56 + 56 accumulator registers a thread.
// - Epilogue per pass: power = re^2 + im^2 in registers (IEEE mul and add,
//   as the plain version), into shared memory; power and log power stored
//   row-contiguous when emitted; then the mel sums, FP32 FMA on the CUDA
//   cores.
// - The mel sums are banded. A mel bank is sparse (the repo's triangles
//   end at 8 kHz: 351 nonzero weights of 6,432 at 16 kHz with 32 filters,
//   363 of 384,320 at 96 kHz with 320), so the dense sum wasted nearly all
//   its FMAs, and its partial sums (one a filter and window) outgrew
//   shared memory at 256 filters. The prologue's last block reads the live
//   weights on every call (they take gradients) and writes the band table:
//   for each filter the band from its first to its last nonzero or NaN
//   weight, and for each pass the filters whose band meets its bins, in
//   ascending filter order, each with its sub-band, its weights packed
//   contiguously, whether it opens or closes in the pass, and a carry
//   slot numbered among the filters open across the pass's end. The
//   consumers stage a pass's table (up to TAB_E entries and TAB_W weights;
//   the rest is read from global memory) during the k loop. Each window's
//   two epilogue threads split the pass's entries at the half of their
//   nonzeros; each filter is summed over its sub-band in ascending bin
//   order and either closed (logged, stored) or carried to the next pass
//   in one of CARRY shared slots a window, double-buffered by the pass's
//   parity (the numbering changes from boundary to boundary), or past the
//   slots in the mel output itself. A pass that no band meets (96 kHz,
//   passes 4-21) does no mel work. Filters with an empty band close in the
//   last pass with a +0 sum, so they take the floor as the dense sum does.
//   Why this is the dense sum bit for bit: power is __fadd_rn(re^2, im^2),
//   +0 or more, so a term skipped outside the band is fmaf(+-0, p, s) = s
//   exactly for finite p (and s is never -0); the band holds every NaN
//   weight; the sums inside it keep their order.
// - Non-finite power breaks that (0 * inf is NaN): a window whose pass
//   holds a NaN or inf power takes the dense sum over every filter for
//   that pass, and from then on keeps every filter's sum in the mel
//   output, dense, to the last pass (rare; right, not fast). A filter
//   closed earlier or not yet open has only +-0 weights in the pass, so
//   its dense result there is NaN whatever the sum it starts from.
// - No atomics in the sums and no split-K: every sum has a fixed order, so
//   results are deterministic.
//
// Known limits, for later work: every k16 step waits for its products
// before the partial sum is promoted, so one warpgroup's wgmma latency is
// hidden only by the other's; the epilogue of a pass (power tile, stores,
// mel) runs while the tensor cores idle; one block fills an SM's shared
// memory; in pieces every pass stages the whole span again (1.2 MB a block
// and pass at 96 kHz), so a k chunk costs ~1.25x the whole span's; a mel
// store is one float a lane, n_mel floats apart (32 cache lines a warp's
// store); a mel-only call at a high rate still computes the passes above
// the mel bank's last bin.
//
// No --use_fast_math: logf must be the accurate one, because the exact-zero
// floors and the log-domain parity with the plain version depend on it.

#include <cfloat>
#include <climits>
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
// the banded mel epilogue: carry slots a window (per pass parity; the
// repo's banks keep at most 2 filters open across a pass boundary), and
// the band table's entries (a header first) and weights staged a pass
// (the repo's banks: at most 193 entries and 193 weights a pass)
constexpr int CARRY = 4;
constexpr int TAB_E = 256;
constexpr int TAB_W = 512;
// a band entry's flags, beside its first bin (8 bits) and length (8 bits)
constexpr int OPENS = 1 << 16;   // the filter's first bin is in this pass
constexpr int CLOSES = 1 << 17;  // and its last
// the cost of an entry beside its weights, when the pass's entries are
// split between a window's two epilogue threads
constexpr int ENTRY_COST = 4;
// the prologue's threads a block, and the most filters its band table
// takes (two ints a filter in shared memory)
constexpr int PROLOGUE_THREADS = 512;
constexpr int MAX_MEL = 16384;
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

// The band table's words a pass: entries (int4, the header first) and
// weights, each at least what the consumers stage, so that a pass's
// staging copy stays inside the table
__host__ __device__ inline int tab_e_stride(int n_mel) {
  return n_mel + 1 > TAB_E ? n_mel + 1 : TAB_E;
}
__host__ __device__ inline int tab_w_stride(int n_mel) {
  return NB * n_mel > TAB_W ? NB * n_mel : TAB_W;
}

struct Params {
  const float* sig;
  const float* melw;
  const int4* tab;    // the band table: [n_pass][e_stride] entries
  const float* tabw;  // and [n_pass][w_stride] weights
  float* power;
  float* logp;
  float* mel;
  long long total;  // B * n_windows
  int S, step, offset0, n_windows, win, n_bins, n_mel, m_pad;
  int n_pass, n_kc, span_cap, pad, ring, comp_log, e_stride, w_stride;
  // staged piece (0: the whole span), its row stride, the piece buffers
  int piece, rs, pbufs;
  float log_offset, log_min, mel_log_off, mel_log_min;
};

#ifdef FRAMEFFT_PHASES
// clock64 of thread 0 at a block's phase boundaries: the consumers' start
// (0), the staged span (1), the block's start (2), and for each of the first
// six passes the end of its k loop, power tile, stores and mel sums (5 + 4
// pass + 0..3); and the cycles thread 0 waited on the piece ring (3) and on
// the basis ring (4). Read by framefft_phases.py; the default build has no
// stamps
constexpr int PHASE_SLOTS = 29;
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

// sum += w[j] * pk[j] over j < n in ascending order (FP32 FMA): one
// filter's sum over its sub-band of a pass
__device__ __forceinline__ float band_sum(const float* w, const float* pk,
                                          int n, float sum) {
  for (int j = 0; j < n; ++j) sum = fmaf(w[j], pk[j], sum);
  return sum;
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

// PIECED: the signal staged in pieces (p.piece > 0), a separate
// instantiation, so that the whole-span layout carries none of its code.
template <int NL, bool PIECED>
__global__ void __launch_bounds__(2 * 128 + side_threads(PIECED), 1)
framefft_wgmma(const __grid_constant__ CUtensorMap bmap, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  PHASE_MARK(2);
  const int consumers = (blockDim.x - side_threads(PIECED)) / 128;
  const int M = 64 * consumers;  // windows per block
  unsigned char* ring = smem;
  const int ring_n = p.ring;
  float* span = reinterpret_cast<float*>(smem + ring_n * STAGE_BYTES);
  // per warpgroup [64][PLD]; in pieces it overlays the warpgroup's own rows
  // of the pass's last piece buffer instead
  float* pow_s = span + p.span_cap;
  // the mel epilogue's carry slots, per warpgroup [2 parities][CARRY][64],
  // and a flag a window: its pass holds a non-finite power
  float* slots = pow_s + (PIECED ? 0 : M * PLD);
  int* nonfinite = reinterpret_cast<int*>(slots + M * 2 * CARRY);
  // the pass's band table as staged, both warpgroups: entries, weights
  int4* tab_s = reinterpret_cast<int4*>(nonfinite + M);
  float* tabw_s = reinterpret_cast<float*>(tab_s + TAB_E);
  uint64_t* full = reinterpret_cast<uint64_t*>(tabw_s + TAB_W);
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

  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) part[i] = 0.0f;
  int s = 0;
  uint32_t phase = 0;
  // the mel epilogue: this thread's window, and which half of the pass's
  // band entries it sums (warp-uniform, so the table's loads are
  // broadcasts); `dense`: the window met a non-finite power, and its sums
  // are dense and kept in the mel output from then on
  const int r = tid_wg & 63, half = tid_wg >> 6;
  const long long gm = m0 + 64 * wg + r;
  const bool live = gm < p.total;
  float* mrow = p.mel + (live ? gm : 0) * p.n_mel;
  bool dense = false;

  for (int pass = 0; pass < p.n_pass; ++pass) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
    // this pass's band table (its first TAB_E entries and TAB_W weights),
    // for the epilogue, once both warpgroups are done with the previous
    // pass's (and with pw)
    const int nbp = min(NB, p.n_bins - pass * NB);
    const int4* tab_g = p.tab + (long long)pass * p.e_stride;
    const float* tabw_g = p.tabw + (long long)pass * p.w_stride;
    if (pass > 0) named_bar(1, nthr);
    for (int i = threadIdx.x; i < TAB_E + TAB_W / 4; i += nthr) {
      if (i < TAB_E)
        cp_async16(reinterpret_cast<float*>(tab_s + i),
                   reinterpret_cast<const float*>(tab_g + i), true);
      else
        cp_async16(tabw_s + 4 * (i - TAB_E), tabw_g + 4 * (i - TAB_E), true);
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

    if (pass < 6) PHASE_MARK(5 + 4 * pass);
    float* pw = PIECED ? span + held * buf_floats + 64 * wg * p.rs
                       : pow_s + 64 * wg * PLD;
    // (in pieces, once every warp of the warpgroup is done reading its rows)
    if (PIECED) named_bar(2 + wg, 128);
    // power of this pass's bins, [64 windows][NB] of this warpgroup, and
    // whether a window's pass holds a NaN or inf power (the quad of threads
    // holding its row reduces it)
    unsigned bad[2] = {0u, 0u};
#pragma unroll
    for (int q = 0; q < NB / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float re = acc[8 * q + 2 * h + e];
          const float im = acc[8 * q + 4 + 2 * h + e];
          const float pv = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
          bad[h] |= !(pv <= FLT_MAX);
          pw[(16 * wl + g + 8 * h) * PLD + 8 * q + 2 * tig + e] = pv;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bad[h] |= __shfl_xor_sync(0xffffffffu, bad[h], 1);
      bad[h] |= __shfl_xor_sync(0xffffffffu, bad[h], 2);
      if (tig == 0) nonfinite[64 * wg + 16 * wl + g + 8 * h] = bad[h];
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    named_bar(1, nthr);
    if (pass < 6) PHASE_MARK(6 + 4 * pass);

    if (p.power || p.logp) {
      for (int idx = tid_wg; idx < 64 * NB; idx += 128) {
        const int row = idx / NB, c = idx - row * NB;
        const long long gw = m0 + 64 * wg + row;
        if (c < nbp && gw < p.total) {
          const float pv = pw[row * PLD + c];
          const long long o = gw * p.n_bins + pass * NB + c;
          if (p.power) p.power[o] = pv;
          if (p.logp)
            p.logp[o] = p.comp_log ? floored_log(pv + p.log_offset, p.log_min)
                                   : 0.0f;
        }
      }
    }
    if (pass < 6) PHASE_MARK(7 + 4 * pass);
    // mel: this thread's window, its half of the pass's band entries
    const bool last = pass == p.n_pass - 1;
    const float* pr = pw + r * PLD;
    const int4 head = tab_s[0];  // entries, the first of the second half
    auto entry = [&](int e) {
      return 1 + e < TAB_E ? tab_s[1 + e] : __ldg(tab_g + 1 + e);
    };
    // the carry slots this pass reads and those it writes
    float* c_in = slots + (2 * wg + (pass & 1)) * CARRY * 64 + r;
    float* c_out = slots + (2 * wg + (~pass & 1)) * CARRY * 64 + r;
    // a filter's sum carried in: a shared slot, past the slots the mel
    // output (the window's row, written by one of its two threads)
    auto carried = [&](const int4& E) {
      const int slot = E.w & 0xffff;
      return slot < CARRY ? c_in[slot * 64] : live ? mrow[E.x] : 0.0f;
    };
    if (!dense && !nonfinite[64 * wg + r]) {
      // each filter over its sub-band of the pass, in ascending bin order:
      // the dense sum bit for bit, for finite power (see the header)
      const int e_end = half ? head.x : head.y;
      for (int e = half ? head.y : 0; e < e_end; ++e) {
        const int4 E = entry(e);
        const int kb = E.y & 0xff, n = (E.y >> 8) & 0xff;
        float sum = E.y & OPENS ? 0.0f : carried(E);
        sum = E.z + n <= TAB_W ? band_sum(tabw_s + E.z, pr + kb, n, sum)
                               : band_sum(tabw_g + E.z, pr + kb, n, sum);
        if (E.y & CLOSES) {
          if (live) mrow[E.x] = floored_log(sum + p.mel_log_off, p.mel_log_min);
        } else {
          const int slot = E.w >> 16;
          if (slot < CARRY)
            c_out[slot * 64] = sum;
          else if (live)
            mrow[E.x] = sum;
        }
      }
    } else {
      // a non-finite power in this pass or an earlier one: the dense sum
      // of every filter over the pass's bins (fmaf(0, inf, s) is NaN), its
      // state in the mel output; the window's two threads take alternate
      // filters. At the first such pass a filter starts from its carried
      // sum if it is open there, else from +0: a filter closed earlier or
      // not yet open has only +-0 weights in this pass, so it ends NaN
      // whatever it starts from, as the dense sum does.
      int e = 0;
      for (int f = half; f < p.n_mel; f += 2) {
        float sum = 0.0f;
        if (dense) {
          sum = live ? mrow[f] : 0.0f;
        } else {
          while (e < head.x && entry(e).x < f) ++e;
          if (e < head.x) {
            const int4 E = entry(e);
            if (E.x == f && !(E.y & OPENS)) sum = carried(E);
          }
        }
        const float* w = p.melw + (long long)pass * NB * p.m_pad + f;
        for (int k = 0; k < nbp; ++k)
          sum = fmaf(w[(long long)k * p.m_pad], pr[k], sum);
        if (live)
          mrow[f] = last ? floored_log(sum + p.mel_log_off, p.mel_log_min) : sum;
      }
      dense = true;
    }
    if (PIECED) {
      // this warp is done with the power tile: the held buffer goes back
      // (its stores ordered before the copy engine's next writes there)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&pempty[held]);
    }
    if (pass < 6) PHASE_MARK(8 + 4 * pass);
  }
  PHASE_STORE(3, wait_piece);
  PHASE_STORE(4, wait_basis);
}

// The band table (see the header) from the live mel weights melw [k, f]
// (row stride m_pad; bins k < n_bins and filters f < n_mel), by one block:
// tab [n_pass][e_stride] int4 entries, tabw [n_pass][w_stride] weights.
// Entry 0 of a pass is its header {entries, the first entry of the second
// half, weights, 0}; entry 1 + e is {filter, first bin in the pass | length
// << 8 | OPENS | CLOSES, offset of its weights, carry slot in | carry slot
// out << 16}, the slots numbered among the pass's entries carried in and
// out (so among the filters open across its start and its end). The plain
// version is ops/framefft.py::band_table.
__device__ void build_band_table(const float* __restrict__ melw, int m_pad,
                                 int n_bins, int n_mel, int n_pass,
                                 int4* __restrict__ tab,
                                 float* __restrict__ tabw) {
  extern __shared__ int band_s[];  // first and last bin a filter, [2][n_mel]
  int* lo = band_s;
  int* hi = band_s + n_mel;
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int f = tid; f < n_mel; f += nthr) {
    lo[f] = INT_MAX;
    hi[f] = -1;
  }
  __syncthreads();
  // each filter's band: a thread takes a 16-byte column of 4 filters and
  // every rows-th bin from r0 (neighbouring threads on neighbouring
  // columns), then merges its first and last nonzero or NaN bin (NaN != 0)
  const int n4 = (n_mel + 3) / 4;
  const int cols = min(n4, nthr), rows = nthr / cols;
  const int c = tid % cols, r0 = tid / cols;
  const float4* w4 = reinterpret_cast<const float4*>(melw);
  const int ld4 = m_pad / 4;
  if (r0 < rows) {
    for (int f4 = c; f4 < n4; f4 += cols) {
      int l[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX}, h[4] = {-1, -1, -1, -1};
      auto note = [&](const float4& w, int k) {
        const float v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (v[i] != 0.0f) {
            l[i] = min(l[i], k);
            h[i] = max(h[i], k);
          }
      };
      int k = r0;
      for (; k + 3 * rows < n_bins; k += 4 * rows) {
        float4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = __ldg(w4 + (long long)(k + u * rows) * ld4 + f4);
#pragma unroll
        for (int u = 0; u < 4; ++u) note(w[u], k + u * rows);
      }
      for (; k < n_bins; k += rows) note(__ldg(w4 + (long long)k * ld4 + f4), k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = 4 * f4 + i;
        if (f < n_mel && h[i] >= 0) {
          atomicMin(&lo[f], l[i]);
          atomicMax(&hi[f], h[i]);
        }
      }
    }
  }
  __syncthreads();
  // each pass's entries, a warp a pass: the filters in chunks of 32, their
  // positions, weight offsets and slots by ballot and scan
  const int warp = tid / 32, lane = tid % 32;
  const unsigned below = (1u << lane) - 1;
  const int es = tab_e_stride(n_mel), wsd = tab_w_stride(n_mel);
  for (int q = warp; q < n_pass; q += nthr / 32) {
    const int qs = q * NB, qe = min(qs + NB, n_bins) - 1;
    const bool last = q == n_pass - 1;
    int4* ent = tab + (long long)q * es;
    float* wq = tabw + (long long)q * wsd;
    int n_ent = 0, nz = 0, n_in = 0, n_out = 0;
    // (f, touches, first bin in the pass, length, opens, closes)
    auto band = [&](int f, bool& touch, int& kb, int& n, bool& opens,
                    bool& closes) {
      const int l = f < n_mel ? lo[f] : 0, h = f < n_mel ? hi[f] : 0;
      const bool empty = h < 0;  // closes in the last pass, with no bins
      touch = f < n_mel && (empty ? last : l <= qe && h >= qs);
      kb = empty ? 0 : max(l, qs) - qs;
      n = empty || !touch ? 0 : min(h, qe) - qs - kb + 1;
      opens = empty || l >= qs;
      closes = empty || h <= qe;
    };
    for (int f0 = 0; f0 < n_mel; f0 += 32) {
      const int f = f0 + lane;
      bool touch, opens, closes;
      int kb, n;
      band(f, touch, kb, n, opens, closes);
      const unsigned m_t = __ballot_sync(0xffffffffu, touch);
      const unsigned m_in = __ballot_sync(0xffffffffu, touch && !opens);
      const unsigned m_out = __ballot_sync(0xffffffffu, touch && !closes);
      int incl = n;  // inclusive scan of the lengths
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      if (touch) {
        const int woff = nz + incl - n;
        ent[1 + n_ent + __popc(m_t & below)] = make_int4(
            f, kb | n << 8 | (opens ? OPENS : 0) | (closes ? CLOSES : 0), woff,
            (n_in + __popc(m_in & below)) | (n_out + __popc(m_out & below)) << 16);
        for (int j = 0; j < n; ++j)
          wq[woff + j] = melw[(long long)(qs + kb + j) * m_pad + f];
      }
      n_ent += __popc(m_t);
      n_in += __popc(m_in);
      n_out += __popc(m_out);
      nz += __shfl_sync(0xffffffffu, incl, 31);
    }
    // the split: an entry goes to the first half where the middle of its
    // cost (its weights + ENTRY_COST) lies in the first half of the pass's
    const int total = nz + ENTRY_COST * n_ent;
    int split = 0, before = 0;
    for (int f0 = 0; f0 < n_mel; f0 += 32) {
      bool touch, opens, closes;
      int kb, n;
      band(f0 + lane, touch, kb, n, opens, closes);
      const int cost = touch ? n + ENTRY_COST : 0;
      int incl = cost;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      split += __popc(__ballot_sync(
          0xffffffffu, touch && 2 * (before + incl - cost) + cost <= total));
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) ent[0] = make_int4(n_ent, split, nz, 0);
  }
}

// The prologue of a call: the last block builds the band table
// (build_band_table), the others pack the B operand from the float32 basis
// [win, ld] (cos and sin) into bf16 limbs [nl][n_pass][112][k_pad], rows of
// pass p = 7 groups of (8 cos bins, 8 sin bins) from bin 56p; bins >=
// n_bins and k >= win are zero. The plain versions are
// ops/framefft.py::band_table and ::pack_basis_limbs.
__global__ void __launch_bounds__(PROLOGUE_THREADS)
framefft_prologue(const float* __restrict__ cosb,
                  const float* __restrict__ sinb, int ld, int win, int n_bins,
                  int n_pass, int k_pad, int nl,
                  __nv_bfloat16* __restrict__ out,
                  const float* __restrict__ melw, int m_pad, int n_mel,
                  int* __restrict__ tab) {
  if (blockIdx.x == gridDim.x - 1) {
    int4* t4 = reinterpret_cast<int4*>(tab);
    float* tw = reinterpret_cast<float*>(
        tab + 4LL * n_pass * tab_e_stride(n_mel));
    build_band_table(melw, m_pad, n_bins, n_mel, n_pass, t4, tw);
    return;
  }
  const long long n = (long long)n_pass * NCOL * k_pad;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)(gridDim.x - 1) * blockDim.x) {
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

template <int NL, bool PIECED>
int launch_wgmma(dim3 grid, dim3 block, int smem, cudaStream_t st,
                 const CUtensorMap& map, const Params& p) {
  const cudaError_t err = cudaFuncSetAttribute(
      framefft_wgmma<NL, PIECED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  framefft_wgmma<NL, PIECED><<<grid, block, smem, st>>>(map, p);
  return (int)cudaGetLastError();
}

template <int NL>
int launch_layout(dim3 grid, dim3 block, int smem, cudaStream_t st,
                  const CUtensorMap& map, const Params& p) {
  return p.piece > 0 ? launch_wgmma<NL, true>(grid, block, smem, st, map, p)
                     : launch_wgmma<NL, false>(grid, block, smem, st, map, p);
}

}  // namespace

extern "C" int framefft_bins_per_pass() { return NB; }
extern "C" int framefft_k_chunk() { return KC; }
// the mel epilogue's carry slots a window and the band table's entries and
// weights staged a pass
extern "C" int framefft_carry_slots() { return CARRY; }
extern "C" int framefft_staged_entries() { return TAB_E; }
extern "C" int framefft_staged_weights() { return TAB_W; }

// int32 words of the band table at this geometry: n_pass x (e_stride int4
// entries + w_stride weights)
extern "C" long long framefft_table_words(int n_bins, int n_mel) {
  const int n_pass = (n_bins + NB - 1) / NB;
  return (long long)n_pass * (4LL * tab_e_stride(n_mel) + tab_w_stride(n_mel));
}

// The prologue on `stream`, one launch: packs the basis limbs into `out`
// (bf16, n_limbs * n_pass * 112 * k_pad values) and builds the band table
// of melw ([n_bins.., m_pad] float32, m_pad a multiple of 4, 16-byte
// aligned) into `tab` (framefft_table_words int32); returns
// cudaGetLastError().
extern "C" int framefft_prologue_launch(const float* cosb, const float* sinb,
                                        int ld, int win, int n_bins,
                                        int n_limbs, int k_pad, void* out,
                                        const float* melw, int m_pad,
                                        int n_mel, int* tab, void* stream) {
  if (n_mel <= 0 || n_mel > MAX_MEL || m_pad < n_mel || m_pad % 4)
    return (int)cudaErrorInvalidValue;
  const int n_pass = (n_bins + NB - 1) / NB;
  const long long n = (long long)n_pass * NCOL * k_pad;
  const int blocks =
      (int)min((n + PROLOGUE_THREADS - 1) / PROLOGUE_THREADS, 1024LL) + 1;
  const int smem = 8 * n_mel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        framefft_prologue, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  framefft_prologue<<<blocks, PROLOGUE_THREADS, smem, (cudaStream_t)stream>>>(
      cosb, sinb, ld, win, n_bins, n_pass, k_pad, n_limbs,
      static_cast<__nv_bfloat16*>(out), melw, m_pad, n_mel, tab);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block with `consumers` (1 or 2) warpgroups,
// `ring` stages, and the signal staged whole (piece 0) or in `pbufs`
// buffers of `piece` samples; the mel epilogue's share (carry slots, flags,
// the staged band table) does not depend on the mel bank.
extern "C" int framefft_shared_bytes(int step, int win, int n_windows,
                                     int consumers, int ring, int piece,
                                     int pbufs) {
  const int M = 64 * consumers;
  // (in pieces the power tiles overlay a piece buffer)
  return 1024 + ring * STAGE_BYTES +
         4 * (staged_floats(step, win, n_windows, consumers, piece, pbufs) +
              (piece ? 0 : M * PLD) + M * (2 * CARRY + 1) + 4 * TAB_E + TAB_W) +
         2 * (MAX_RING + (piece ? MAX_PBUF : 0)) * 8;
}

// Launches on `stream` with a layout of ops/framefft.py::plan_layout.
// Returns 0 when launched, a CUDA error code, or -1 (no
// cuTensorMapEncodeTiled entry point) / -1000 - CUresult (the tensor map
// was refused). basis: bf16 [n_limbs * n_pass * 112, k_pad], k_pad a
// multiple of 64; tab: the band table the prologue built from melw (m_pad
// a multiple of 4). power / logp may be null: those outputs are not
// written.
extern "C" int framefft_launch(const float* sig, const void* basis, int k_pad,
                               const float* melw, const int* tab, float* power,
                               float* logp, float* mel, int B, int S, int step,
                               int offset0, int n_windows, int win, int n_bins,
                               int n_mel, int m_pad, int n_limbs, int consumers,
                               int ring, int piece, int pbufs,
                               float log_offset, float log_min,
                               float mel_log_off, float mel_log_min,
                               int comp_log, void* stream) {
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
  p.e_stride = tab_e_stride(n_mel);
  p.w_stride = tab_w_stride(n_mel);
  p.tab = reinterpret_cast<const int4*>(tab);
  p.tabw = reinterpret_cast<const float*>(tab + 4LL * n_pass * p.e_stride);
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
  p.ring = ring;
  p.comp_log = comp_log;
  p.log_offset = log_offset;
  p.log_min = log_min;
  p.mel_log_off = mel_log_off;
  p.mel_log_min = mel_log_min;

  if (ring < n_limbs || ring > MAX_RING || piece < 0 || piece % KC ||
      n_mel <= 0 || n_mel > MAX_MEL || m_pad < n_mel || m_pad % 4 ||
      (piece && (pbufs < MIN_PBUF || pbufs > MAX_PBUF)))
    return (int)cudaErrorInvalidValue;
  const int smem = framefft_shared_bytes(step, win, n_windows, consumers,
                                         ring, piece, pbufs);
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
