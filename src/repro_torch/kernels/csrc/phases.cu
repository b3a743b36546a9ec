// The three-phase BLCO MTTKRP pipeline for Hopper (sm_90a): the kernels of
// repro_torch.kernels.ops.cuda_mttkrp_phases, with a plain C interface
// loaded through ctypes (repro_torch/kernels/build.py,
// repro_torch/kernels/delinearize.py, repro_torch/kernels/blco_mttkrp.py).
// Between K3 and K4/K5 the caller gathers the N-1 non-target factor rows
// with torch.index_select, and after K4 it scatters one update per run with
// index_add_: the pipeline the fused K1/K2 (fused_mttkrp.cu) are measured
// against.
//
// What each kernel replaces (the JAX package's Pallas kernels):
//   delinearize_kernel   K3  src/repro/kernels/delinearize.py:44 _kernel
//                             (wrapper delinearize :57)
//   segments_kernel      K4  src/repro/kernels/blco_mttkrp.py:49
//                             _segment_kernel (wrapper mttkrp_segments :70)
//   stash_phases_kernel  K5  src/repro/kernels/blco_mttkrp.py:96
//                             _stash_kernel (wrapper mttkrp_stash :117)
//
// What bounds them: bytes, all three.  K3 reads hi + lo + N int32 bases and
// writes N int32 coordinates per non-zero; a handful of integer operations
// per field.  K4 and K5 read the value, the target and N-1 gathered rows of
// R values per non-zero (at R = 32, f32, order 3: 264 B per non-zero) and do
// N*R multiply-adds on them, far below the 67 TFLOP/s f32 rate; K4 also
// writes a (T, R) output as large as one gathered input (at NELL-2 size,
// 33.2 GB per call, 9.9 ms at 3.35 TB/s).  So K4 is a stream: the only gain
// is to keep enough bytes in flight that HBM never waits.
//
// What the designs do about it:
//   * K3: one thread per non-zero (grid-stride), each field extracted from
//     the uint32 words as they are (extract_field_words, fields.cuh), no
//     64-bit widening.  Loads of hi/lo are coalesced; the (T, N) bases and
//     coordinates are row-major, so a warp touches one contiguous span.
//   * K4: the output layout is the reference's exactly: row k of tile j is
//     the k-th run of equal target in that tile, in stream order; the rows
//     after the last run hold seg_tgt = -1 and zero sums.  A run starts at
//     the tile's first element and wherever the target differs from the
//     element before it; a target that comes back later in the tile starts
//     a new run (the stream is in ALTO order, not sorted, and runs are
//     never merged by key).  The launch is one wave of CTAs of K4_WARPS
//     warps (the wrapper sizes it from phases_occupancy), and every warp is
//     its own pipeline: it takes tasks (one tile, or a stage's worth of
//     whole tiles when the tile is short) in a grid-stride over the stream
//     and splits each into pieces of `rows` slots.  A piece's spans are
//     contiguous -- vals, tgt and a block of rows in each gathered matrix --
//     so lane 0 fills a stage of the warp's ring of 2 or 3 stages with
//     2 + (N-1) 1-D bulk copies (cp.async.bulk ... complete_tx) counted by
//     the stage's mbarrier; while the ring's other pieces are in flight, the
//     warp sums the oldest out of shared memory, then refills its stage.
//     The sum: lanes own columns (a loop over groups of 32 when R > 32).
//     For a batch of up to 32 rows, lane l loads row l's target and value;
//     one ballot over "my target differs from the row before" marks the run
//     starts, and a popcount gives each finished run its row.  The batch's
//     products are multiplied out into registers first (the shared-memory
//     loads are independent), then added in stream order; where a run ends
//     the lanes store its row (a coalesced 128 B line at R = 32, f32), the
//     batch's run targets leave in one store, and after a tile's last run
//     its -1 / zero rows.  A run that crosses a piece boundary carries its
//     partial sums over in shared memory.  Each run is summed by one lane
//     per column in stream order, without atomics: two calls give the same
//     bits.  No block-wide barrier; no division by a run-time R; the walk
//     branches only on the batch's run-end mask, the same in every lane.
//     A bulk copy needs 16-byte-aligned addresses and sizes; where some
//     span is not (a tile or a stream length that is no multiple of 4, a
//     pointer into the middle of a tensor), the same kernel fills its
//     stages with cp.async of 4 or 8 B per element, each lane a strided
//     share, one commit group per stage.  The wrapper picks the fill, the
//     stage's rows and the ring's depth per launch (segments_layout in
//     blco_mttkrp.py): 32-slot stages, 3 of them per warp where two CTAs
//     still share an SM, else 2.  The walk's latency matters as much as the
//     ring: on an H100, one CTA of 4 warps per SM left K4 well short of two
//     at the same bytes in flight, and integer divisions per piece (for the
//     ring's stage and the piece's task) slowed it visibly, so each warp
//     keeps its place in counters (PERF.md, PR 15).
//     Bytes in flight: at f32, order 3, R = 32 (NELL-2), a stage is 8,448 B
//     and two CTAs of 4 warps with 3 stages each keep 8 x 2 stages = 135 KB
//     in flight per SM while a stage is summed; at order 4 (Uber), 12,544 B
//     stages, 2 per warp, 100 KB.  HBM's rate times its latency asks for
//     roughly 25-30 KB per SM.
//   * K5: the Pallas body zeroes its output at program_id == 0 and adds to
//     it across grid steps, right only on the TPU's sequential grid.  Here,
//     as in K2, every CTA zeroes a shared-memory stash of (out_rows, R),
//     its warps walk contiguous ranges of the stream (lanes own columns)
//     with one shared atomicAdd per run of equal target, and the CTA merges
//     its stash with one global atomicAdd per non-zero element.  The stash
//     must fit 227 KB; the wrapper refuses a larger one.
// Host queries (the SM count, the occupancy of a K4 instance, the raised
// shared-memory limit of K4 and K5) are made once per key through
// phases_occupancy and cached by the Python wrappers; the launches take
// their grid from the caller.
// What a later PR should do if K4 falls short of its bound: write the run
// rows through shared memory with TMA stores (cp.async.bulk global <-
// shared), so that the stores leave as whole bulk transfers; or pair CTAs in
// a 2-CTA cluster, one multicast fill per pair, to halve the copy requests.
//
// Types: (vals, gathered rows) in {f32 x f32, f64 x f64, f64 x f32}; sums
// at the promoted type.  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fields.cuh"

#define FULL_MASK 0xffffffffu
#define THREADS 256
#define MAX_TILE 256
// K4's shape, mirrored in blco_mttkrp.py: warps per CTA, stages in each
// warp's ring at most (the launch picks 2 or 3), slots per stage at most
// (one batch of the walk), and the bytes of the ring's mbarriers
// (K4_MAX_STAGES x 8, rounded up to 16)
#define K4_WARPS 4
#define K4_THREADS (K4_WARPS * 32)
#define K4_MAX_STAGES 3
#define K4_MAX_ROWS 32
#define K4_BAR_BYTES 32

struct FieldSpec {
  int n;                    // tensor order
  int shift[MAX_ORDER];     // LSB of each mode's field in the 64-bit index
  int width[MAX_ORDER];     // bits of each mode's field
};

template <typename FT>
struct Rows {
  const FT* p[MAX_ORDER - 1];   // N-1 gathered (T, R) row-major matrices
};

// K3: (T,) hi/lo words + (T, N) bases -> (T, N) int32 coordinates.
__global__ void __launch_bounds__(THREADS) delinearize_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const int32_t* __restrict__ bases, FieldSpec fs, int64_t T,
    int32_t* __restrict__ coords) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < T;
       e += step) {
    const uint32_t h = hi[e];
    const uint32_t l = lo[e];
#pragma unroll
    for (int m = 0; m < MAX_ORDER; ++m) {
      if (m < fs.n) {
        const int64_t at = e * fs.n + m;
        coords[at] = (int32_t)extract_field_words(h, l, fs.shift[m],
                                                  fs.width[m]) + bases[at];
      }
    }
  }
}

// ------------------------------------------------------------------- K4
// One warp's region of dynamic shared memory, in bytes: K4_MAX_STAGES
// mbarriers, the carried partial sums of a run that crosses a piece (R
// values at the output type), then the ring.  Inside a stage: vals, tgt,
// then each gathered matrix's block of rows, every part 16-byte aligned.
// blco_mttkrp.py::segments_layout computes the same sizes.
struct SegLayout {
  int rows;                 // slots per stage
  int stages;               // stages in the ring
  int off_tgt;              // offsets inside a stage
  int off_g;
  int g_stride;
  int stage_bytes;
  int off_carry;            // offsets inside a warp's region
  int off_stages;
  int warp_bytes;
};

static int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// False when K4_WARPS regions would not fit one CTA's shared memory.
static bool seg_layout(int vi, int fi, int oi, int ng, int R, int rows,
                       int stages, SegLayout* L) {
  if (rows < 1 || rows > K4_MAX_ROWS || R < 1 || ng < 1 || stages < 2 ||
      stages > K4_MAX_STAGES)
    return false;
  const int64_t v = round16((int64_t)rows * vi);
  const int64_t t = round16((int64_t)rows * 4);
  const int64_t g = round16((int64_t)rows * R * fi);
  const int64_t stage = v + t + ng * g;
  const int64_t carry = round16((int64_t)R * oi);
  const int64_t warp = K4_BAR_BYTES + carry + stages * stage;
  if (K4_WARPS * warp > STASH_MAX_BYTES) return false;
  L->rows = rows;
  L->stages = stages;
  L->off_tgt = (int)v;
  L->off_g = (int)(v + t);
  L->g_stride = (int)g;
  L->stage_bytes = (int)stage;
  L->off_carry = K4_BAR_BYTES;
  L->off_stages = (int)(K4_BAR_BYTES + carry);
  L->warp_bytes = (int)warp;
  return true;
}

template <typename VT, typename FT, typename OT>
struct SegArgs {
  const VT* vals;
  const int32_t* tgt;
  Rows<FT> g;
  int ng;
  int R;
  int tile;
  int ppt;                  // pieces per task
  int64_t T;
  int64_t span;             // slots per task: a tile, or `rows` whole tiles
  int64_t tasks;
  int bulk;                 // 1: bulk copies; 0: cp.async per element
  SegLayout L;
  int32_t* seg_tgt;
  OT* seg_sums;
};

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

static __device__ __forceinline__ void bulk_copy(uint32_t dst,
                                                 const void* src,
                                                 uint32_t bytes,
                                                 uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int BYTES>
static __device__ __forceinline__ void cp_async(uint32_t dst,
                                                const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(BYTES)
               : "memory");
}

// A piece of the stream: [start, start + len).
struct Piece {
  int64_t start;
  int len;
};

// The walk's state, carried from piece to piece; the same in every lane.
struct Walk {
  int k;                    // the current run's row in its tile
  int32_t c;                // the current run's target
  int pos;                  // slots of the current tile walked; 0: none
  int64_t tb;               // the current tile's first slot
};

// Fill a stage with a piece: one elected lane issues
// 2 + ng bulk copies on the stage's barrier, or every lane issues cp.async
// of one element each for a strided share (the caller commits the group).
template <typename VT, typename FT, typename OT, int NGT>
static __device__ __forceinline__ void fill_stage(
    const SegArgs<VT, FT, OT>& a, int ng, unsigned char* stage,
    uint64_t* bar, Piece pc, int lane) {
  const int64_t start = pc.start;
  const int len = pc.len;
  constexpr int NGMAX = NGT ? NGT : MAX_ORDER - 1;
  const int R = a.R;
  if (a.bulk) {
    if (lane != 0) return;
    const uint32_t vb = (uint32_t)len * (uint32_t)sizeof(VT);
    const uint32_t tb = (uint32_t)len * 4u;
    const uint32_t gb = (uint32_t)len * (uint32_t)R * (uint32_t)sizeof(FT);
    const uint32_t b = smem_u32(bar);
    mbar_expect_tx(b, vb + tb + (uint32_t)ng * gb);
    bulk_copy(smem_u32(stage), a.vals + start, vb, b);
    bulk_copy(smem_u32(stage + a.L.off_tgt), a.tgt + start, tb, b);
#pragma unroll
    for (int m = 0; m < NGMAX; ++m)
      if (m < ng)
        bulk_copy(smem_u32(stage + a.L.off_g + m * a.L.g_stride),
                  a.g.p[m] + start * R, gb, b);
    return;
  }
  const uint32_t sv = smem_u32(stage);
  const uint32_t st = smem_u32(stage + a.L.off_tgt);
  for (int j = lane; j < len; j += 32) {
    cp_async<sizeof(VT)>(sv + j * (uint32_t)sizeof(VT), a.vals + start + j);
    cp_async<4>(st + j * 4u, a.tgt + start + j);
  }
  const int n = len * R;
#pragma unroll
  for (int m = 0; m < NGMAX; ++m) {
    if (m < ng) {
      const uint32_t dst = smem_u32(stage + a.L.off_g + m * a.L.g_stride);
      const FT* src = a.g.p[m] + start * R;
      for (int j = lane; j < n; j += 32)
        cp_async<sizeof(FT)>(dst + j * (uint32_t)sizeof(FT), src + j);
    }
  }
}

// Rows [from, tile) of the tile at slot tb: seg_tgt -1, zero sums.
template <typename VT, typename FT, typename OT>
static __device__ __forceinline__ void pad_tile(
    const SegArgs<VT, FT, OT>& a, int64_t tb, int from, int lane) {
  const int R = a.R;
  OT* out = a.seg_sums + tb * R;
  for (int i = from * R + lane; i < a.tile * R; i += 32) out[i] = OT(0);
  for (int i = from + lane; i < a.tile; i += 32) a.seg_tgt[tb + i] = -1;
}

// Sum the piece held in `stage`, continuing `w`; returns the walk's state
// after it.
template <typename VT, typename FT, typename OT, int NGT>
static __device__ __forceinline__ Walk sum_stage(
    const SegArgs<VT, FT, OT>& a, int ng, const unsigned char* stage,
    OT* carry, Piece pc, int lane, const Walk w) {
  const int64_t start = pc.start;
  const int len = pc.len;
  constexpr int NGMAX = NGT ? NGT : MAX_ORDER - 1;
  const int R = a.R;
  const int tile = a.tile;
  const VT* sv = reinterpret_cast<const VT*>(stage);
  const int32_t* st = reinterpret_cast<const int32_t*>(stage + a.L.off_tgt);
  const FT* sg[NGMAX];
#pragma unroll
  for (int m = 0; m < NGMAX; ++m)
    sg[m] = reinterpret_cast<const FT*>(stage + a.L.off_g +
                                        m * a.L.g_stride);
  Walk s = w;
  for (int c0 = 0; c0 < R; c0 += 32) {      // one group of 32 columns
    const int col = c0 + lane;
    const bool act = col < R;
    const bool lead = c0 == 0;      // writes seg_tgt and the padding
    s = w;
    OT acc = (s.pos > 0 && act) ? carry[col] : OT(0);
    for (int j0 = 0; j0 < len;) {
      // a batch: at most 32 rows, never across the end of a tile; lane l
      // holds row j0 + l's target and value
      int cnt = len - j0 < 32 ? len - j0 : 32;
      if (cnt > tile - s.pos) cnt = tile - s.pos;
      const bool in = lane < cnt;
      const int32_t t_l = in ? st[j0 + lane] : 0;
      const VT v_l = in ? sv[j0 + lane] : VT(0);
      // runs start at a tile's first slot and where the target changes;
      // one ends before each start and at the tile's last slot
      const int32_t t_up = __shfl_up_sync(FULL_MASK, t_l, 1);
      const bool starts =
          in && (lane ? t_l != t_up : (s.pos == 0 || t_l != s.c));
      const unsigned M = __ballot_sync(FULL_MASK, starts);
      const bool tile_ends = s.pos + cnt == tile;
      const unsigned E = (M >> 1) | (tile_ends ? 1u << (cnt - 1) : 0u);
      if (s.pos == 0) s.tb = start + j0;
      const int kb = s.pos == 0 ? -1 : s.k;   // the run open before it
      // every row's product first: the shared-memory loads are independent
      OT p[32];
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        OT x = (OT)__shfl_sync(FULL_MASK, v_l, jj);
        if (act && jj < cnt) {
          const int at = (j0 + jj) * R + col;
#pragma unroll
          for (int m = 0; m < NGMAX; ++m)
            if (m < ng) x *= (OT)sg[m][at];
        }
        p[jj] = x;
      }
      OT* out = a.seg_sums + s.tb * R + col;
      if (kb >= 0 && (M & 1u)) {    // the open run ended with the last batch
        if (act) out[kb * R] = acc;
        if (lead && lane == 0) a.seg_tgt[s.tb + kb] = s.c;
        acc = OT(0);
      }
      // then the rows in stream order; a run's row is kb + the starts up
      // to its last slot ((2u << 31) is 0 in 32 bits: every lane)
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        if (jj < cnt) {
          acc += p[jj];
          if ((E >> jj) & 1u) {
            const int k = kb + __popc(M & ((2u << jj) - 1u));
            if (act) out[k * R] = acc;
            acc = OT(0);
          }
        }
      }
      if (lead && ((E >> lane) & 1u))
        a.seg_tgt[s.tb + kb + __popc(M & ((2u << lane) - 1u))] = t_l;
      s.k = kb + __popc(M);
      s.c = __shfl_sync(FULL_MASK, t_l, cnt - 1);
      s.pos += cnt;
      j0 += cnt;
      if (tile_ends) {                      // the rows after the last run
        if (lead) pad_tile(a, s.tb, s.k + 1, lane);
        s.pos = 0;
      }
    }
    if (s.pos > 0 && act) carry[col] = acc;  // the run goes on next piece
  }
  return s;
}

// K4: one wave of CTAs of K4_WARPS warps; every warp streams its tasks'
// pieces through its own ring of stages.  No block-wide barrier.
template <typename VT, typename FT, typename OT, int NGT>
__global__ void __launch_bounds__(K4_THREADS) segments_kernel(
    const SegArgs<VT, FT, OT> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ng = NGT ? NGT : a.ng;
  unsigned char* region = smem_raw + warp * a.L.warp_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(region);
  OT* carry = reinterpret_cast<OT*>(region + a.L.off_carry);
  unsigned char* ring = region + a.L.off_stages;
  const int64_t gw = (int64_t)blockIdx.x * K4_WARPS + warp;
  const int64_t nw = (int64_t)gridDim.x * K4_WARPS;
  // tasks gw, gw + nw, ...; a.ppt pieces each
  const int pieces =
      gw < a.tasks ? (int)((a.tasks - gw + nw - 1) / nw) * a.ppt : 0;
  if (pieces == 0) return;
  if (a.bulk) {
    if (lane == 0) {
      for (int s = 0; s < a.L.stages; ++s) mbar_init(smem_u32(bars + s));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }
  // the producer's and the consumer's place: a piece is the p-th of the
  // warp's q-th task, in stage s; counters, no division per piece
  struct Cursor {
    int q, p, s;
  };
  const auto piece = [&](const Cursor& c) {
    const int64_t off = (int64_t)c.p * a.L.rows;
    Piece pc;
    pc.start = (gw + c.q * nw) * a.span + off;
    int64_t n = a.span - off < a.L.rows ? a.span - off : a.L.rows;
    if (n > a.T - pc.start) n = a.T - pc.start;
    pc.len = (int)n;
    return pc;
  };
  const auto advance = [&](Cursor& c) {
    if (++c.p == a.ppt) {
      c.p = 0;
      ++c.q;
    }
    if (++c.s == a.L.stages) c.s = 0;
  };
  Cursor prod = {0, 0, 0};
  int issued = 0;
  const auto issue = [&]() {
    if (issued++ < pieces)
      fill_stage<VT, FT, OT, NGT>(a, ng, ring + prod.s * a.L.stage_bytes,
                                  bars + prod.s, piece(prod), lane);
    if (!a.bulk) asm volatile("cp.async.commit_group;\n" ::: "memory");
    advance(prod);
  };
  for (int i = 0; i < a.L.stages; ++i) issue();
  Cursor cons = {0, 0, 0};
  uint32_t parity = 0;      // flips each time the consumer wraps the ring
  Walk w = {0, 0, 0, 0};
  for (int i = 0; i < pieces; ++i) {
    if (a.bulk) {
      mbar_wait(smem_u32(bars + cons.s), parity);
    } else {        // piece i's group is done when stages - 1 are pending
      if (a.L.stages == 3)
        asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncwarp();
    }
    w = sum_stage<VT, FT, OT, NGT>(a, ng, ring + cons.s * a.L.stage_bytes,
                                   carry, piece(cons), lane, w);
    // every lane's reads of the stage are done (their values are used)
    // before lane 0 has it refilled
    __syncwarp();
    issue();                // into the stage just summed
    advance(cons);
    if (cons.s == 0) parity ^= 1u;
  }
}

// ------------------------------------------------------------------- K5
// Every CTA folds `per_cta` non-zeros into a shared (out_rows, R) stash,
// then merges the stash into the global output.
template <typename VT, typename FT, typename OT>
__global__ void __launch_bounds__(THREADS) stash_phases_kernel(
    const VT* __restrict__ vals, const int32_t* __restrict__ tgt, Rows<FT> g,
    int ng, int64_t T, int R, int out_rows, int64_t per_cta, OT* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OT* stash = reinterpret_cast<OT*>(smem_raw);
  const int n = out_rows * R;
  for (int i = threadIdx.x; i < n; i += blockDim.x) stash[i] = OT(0);
  __syncthreads();
  const int64_t cta_start = (int64_t)blockIdx.x * per_cta;
  const int64_t cta_end = cta_start + per_cta < T ? cta_start + per_cta : T;
  const int warps = blockDim.x >> 5;
  const int64_t per_warp = (per_cta + warps - 1) / warps;
  const int64_t start = cta_start + (int64_t)(threadIdx.x >> 5) * per_warp;
  const int64_t end = start + per_warp < cta_end ? start + per_warp : cta_end;
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < R && start < end; c0 += 32) {
    const int col = c0 + lane;
    const bool active = col < R;
    int32_t cur = -1;
    OT acc = OT(0);
    for (int64_t batch = start; batch < end; batch += 32) {
      // each lane loads one non-zero of the batch ...
      const int64_t e = batch + lane;
      int32_t t = -1;
      VT v = VT(0);
      if (e < end) {
        t = tgt[e];
        v = vals[e];
      }
      // ... then the warp steps through the batch in stream order
      const int cnt = (int)(end - batch < 32 ? end - batch : 32);
      for (int j = 0; j < cnt; ++j) {
        const int32_t tj = __shfl_sync(FULL_MASK, t, j);
        OT p = (OT)__shfl_sync(FULL_MASK, v, j);
#pragma unroll
        for (int m = 0; m < MAX_ORDER - 1; ++m)
          if (m < ng && active) p *= (OT)g.p[m][(batch + j) * R + col];
        if (tj != cur) {            // a run ends: one update for all of it
          if (cur >= 0 && cur < out_rows && active)
            atomicAdd(stash + (int64_t)cur * R + col, acc);
          cur = tj;
          acc = OT(0);
        }
        acc += p;
      }
    }
    if (cur >= 0 && cur < out_rows && active)
      atomicAdd(stash + (int64_t)cur * R + col, acc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const OT s = stash[i];
    if (s != OT(0)) atomicAdd(out + i, s);
  }
}

// ----------------------------------------------------------------- host
template <typename FT>
static Rows<FT> rows_of(const void* const* gathered, int ng) {
  Rows<FT> g;
  for (int m = 0; m < MAX_ORDER - 1; ++m)
    g.p[m] = m < ng ? static_cast<const FT*>(gathered[m]) : nullptr;
  return g;
}

// One K4 call: a launch, or (blocks_per_sm set) an occupancy query.
struct SegCall {
  const void* vals;
  const void* tgt;
  const void* const* gathered;
  int ng;
  int64_t T;
  int R;
  int tile;
  int rows;
  int stages;
  int64_t span;
  int bulk;
  int blocks;
  void* seg_tgt;
  void* seg_sums;
  cudaStream_t stream;
  int* blocks_per_sm;       // query: out
  int* smem_bytes;          // query: out
};

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename VT, typename FT, typename OT, int NGT>
static cudaError_t segments_typed(const SegCall& c) {
  SegLayout L;
  if (!seg_layout(sizeof(VT), sizeof(FT), sizeof(OT), c.ng, c.R, c.rows,
                  c.stages, &L))
    return cudaErrorInvalidValue;
  const int smem = K4_WARPS * L.warp_bytes;
  if (c.blocks_per_sm) {
    *c.smem_bytes = smem;
    const cudaError_t err = cudaFuncSetAttribute(
        segments_kernel<VT, FT, OT, NGT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, STASH_MAX_BYTES);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        c.blocks_per_sm, segments_kernel<VT, FT, OT, NGT>, K4_THREADS,
        (size_t)smem);
  }
  SegArgs<VT, FT, OT> a;
  a.vals = static_cast<const VT*>(c.vals);
  a.tgt = static_cast<const int32_t*>(c.tgt);
  a.g = rows_of<FT>(c.gathered, c.ng);
  a.ng = c.ng;
  a.R = c.R;
  a.tile = c.tile;
  a.ppt = (int)((c.span + c.rows - 1) / c.rows);
  a.T = c.T;
  a.span = c.span;
  a.tasks = (c.T + c.span - 1) / c.span;
  a.bulk = c.bulk;
  a.L = L;
  a.seg_tgt = static_cast<int32_t*>(c.seg_tgt);
  a.seg_sums = static_cast<OT*>(c.seg_sums);
  const int64_t warps = (int64_t)c.blocks * K4_WARPS;
  if ((a.tasks + warps - 1) / warps * a.ppt > 0x7fffffffLL)
    return cudaErrorInvalidValue;   // a warp counts its pieces in 32 bits
  if (c.bulk) {   // every span 16-byte aligned: the pointers, and every
                  // piece's first slot and length a multiple of 4
    bool ok = aligned16(c.vals) && aligned16(c.tgt) && c.T % 4 == 0 &&
              (a.tasks == 1 || c.span % 4 == 0) &&
              (a.ppt == 1 || c.rows % 4 == 0);
    for (int m = 0; m < c.ng; ++m) ok = ok && aligned16(c.gathered[m]);
    if (!ok) return cudaErrorInvalidValue;
  }
  segments_kernel<VT, FT, OT, NGT><<<c.blocks, K4_THREADS, smem, c.stream>>>(
      a);
  return cudaGetLastError();
}

template <typename VT, typename FT, typename OT>
static cudaError_t segments_by_ng(const SegCall& c) {
  switch (c.ng) {
    case 2:
      return segments_typed<VT, FT, OT, 2>(c);
    case 3:
      return segments_typed<VT, FT, OT, 3>(c);
    default:
      return segments_typed<VT, FT, OT, 0>(c);
  }
}

static cudaError_t segments_by_pair(int dtype_pair, const SegCall& c) {
  switch (dtype_pair) {
    case 0:
      return segments_by_ng<float, float, float>(c);
    case 1:
      return segments_by_ng<double, double, double>(c);
    case 2:
      return segments_by_ng<double, float, double>(c);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename VT, typename FT, typename OT>
static cudaError_t stash_typed(const void* vals, const void* tgt,
                               const void* const* gathered, int ng, int64_t T,
                               int R, int out_rows, int blocks, void* out,
                               cudaStream_t stream) {
  const size_t smem = (size_t)out_rows * R * sizeof(OT);
  if (smem > STASH_MAX_BYTES) return cudaErrorInvalidValue;
  const int64_t per_cta = (T + blocks - 1) / blocks;
  stash_phases_kernel<VT, FT, OT><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const VT*>(vals), static_cast<const int32_t*>(tgt),
      rows_of<FT>(gathered, ng), ng, T, R, out_rows, per_cta,
      static_cast<OT*>(out));
  return cudaGetLastError();
}

template <typename VT, typename FT, typename OT>
static cudaError_t stash_raise_limit() {
  return cudaFuncSetAttribute(stash_phases_kernel<VT, FT, OT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              STASH_MAX_BYTES);
}

extern "C" {

// (T,) hi/lo uint32 + (T, n_modes) int32 bases -> (T, n_modes) int32 coords,
// on a grid of `blocks` CTAs of THREADS threads (grid-stride).
int phases_delinearize_launch(const void* hi, const void* lo,
                              const void* bases, int n_modes,
                              const int* shifts, const int* widths,
                              long long T, int blocks, void* coords,
                              void* stream) {
  if (n_modes < 1 || n_modes > MAX_ORDER || T < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  FieldSpec fs;
  fs.n = n_modes;
  for (int m = 0; m < MAX_ORDER; ++m) {
    fs.shift[m] = m < n_modes ? shifts[m] : 0;
    fs.width[m] = m < n_modes ? widths[m] : 0;
  }
  if (T == 0) return (int)cudaSuccess;
  delinearize_kernel<<<(unsigned)blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const int32_t*>(bases), fs, T,
      static_cast<int32_t*>(coords));
  return (int)cudaGetLastError();
}

// dtype_pair: 0 = f32 vals x f32 rows, 1 = f64 x f64, 2 = f64 x f32.
// seg_tgt (T,) int32 and seg_sums (T, R) at the promoted type are written in
// full (no zeroing needed).  T % tile == 0, 1 <= tile <= 256.  The warps
// take tasks of `span` slots (a tile with rows < tile, or rows whole tiles
// with span == rows) in pieces of `rows` <= K4_MAX_ROWS slots, through
// rings of `stages` (2 or 3) stages; `bulk`
// fills the stages with bulk copies (every span 16-byte aligned, else the
// call is refused), 0 with cp.async.  `blocks` CTAs of K4_THREADS threads;
// the occupancy query below must have run first for this kernel instance
// on this device (it raises the kernel's shared-memory limit).
int phases_segments_launch(int dtype_pair, const void* vals, const void* tgt,
                           const void* const* gathered, int n_gathered,
                           long long T, int R, int tile, int rows,
                           int stages, long long span, int bulk, int blocks,
                           void* seg_tgt, void* seg_sums, void* stream) {
  if (n_gathered < 1 || n_gathered > MAX_ORDER - 1 || R < 1 || T < 0 ||
      tile < 1 || tile > MAX_TILE || T % tile != 0 || blocks < 1 ||
      (bulk != 0 && bulk != 1) ||
      !((span == tile && rows < tile) ||
        (span == rows && rows % tile == 0)))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  SegCall c = {};
  c.vals = vals;
  c.tgt = tgt;
  c.gathered = gathered;
  c.ng = n_gathered;
  c.T = T;
  c.R = R;
  c.tile = tile;
  c.rows = rows;
  c.stages = stages;
  c.span = span;
  c.bulk = bulk;
  c.blocks = blocks;
  c.seg_tgt = seg_tgt;
  c.seg_sums = seg_sums;
  c.stream = static_cast<cudaStream_t>(stream);
  return (int)segments_by_pair(dtype_pair, c);
}

// `out` is (out_rows, R) at the promoted type and must be zeroed; targets
// outside [0, out_rows) are dropped, as the reference's scatter drops them.
// `blocks` CTAs of THREADS threads each fold a contiguous share of the
// stream; the occupancy query below must have run first for this dtype
// pair on this device (it raises the kernel's shared-memory limit).
int phases_stash_launch(int dtype_pair, const void* vals, const void* tgt,
                        const void* const* gathered, int n_gathered,
                        long long T, int R, int out_rows, int blocks,
                        void* out, void* stream) {
  if (n_gathered < 1 || n_gathered > MAX_ORDER - 1 || R < 1 || T < 0 ||
      out_rows < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_pair) {
    case 0:
      return (int)stash_typed<float, float, float>(
          vals, tgt, gathered, n_gathered, T, R, out_rows, blocks, out, s);
    case 1:
      return (int)stash_typed<double, double, double>(
          vals, tgt, gathered, n_gathered, T, R, out_rows, blocks, out, s);
    case 2:
      return (int)stash_typed<double, float, double>(
          vals, tgt, gathered, n_gathered, T, R, out_rows, blocks, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The current device's SM count, and what a kernel needs asked once per
// device and instance.  kernel 0 (K3): nothing more.  kernel 1 (K4): raises
// the shared-memory limit of the instance for (dtype_pair, n_gathered) and
// returns the CTAs of it resident per SM and the dynamic shared memory of a
// CTA with rings of `stages` stages of `rows` slots at rank R.  kernel 2
// (K5): raises the shared-memory limit of the instance for dtype_pair.
int phases_occupancy(int kernel, int dtype_pair, int n_gathered, int R,
                     int rows, int stages, int* sms, int* blocks_per_sm,
                     int* smem_bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *blocks_per_sm = 0;
  *smem_bytes = 0;
  switch (kernel) {
    case 0:
      return (int)cudaSuccess;
    case 1: {
      if (n_gathered < 1 || n_gathered > MAX_ORDER - 1)
        return (int)cudaErrorInvalidValue;
      SegCall c = {};
      c.ng = n_gathered;
      c.R = R;
      c.rows = rows;
      c.stages = stages;
      c.blocks_per_sm = blocks_per_sm;
      c.smem_bytes = smem_bytes;
      return (int)segments_by_pair(dtype_pair, c);
    }
    case 2:
      switch (dtype_pair) {
        case 0:
          return (int)stash_raise_limit<float, float, float>();
        case 1:
          return (int)stash_raise_limit<double, double, double>();
        case 2:
          return (int)stash_raise_limit<double, float, double>();
        default:
          return (int)cudaErrorInvalidValue;
      }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* phases_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int phases_max_order(void) { return MAX_ORDER; }

int phases_max_tile(void) { return MAX_TILE; }

int phases_stash_max_bytes(void) { return STASH_MAX_BYTES; }

}  // extern "C"
