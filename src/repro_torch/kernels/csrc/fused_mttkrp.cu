// Fused BLCO MTTKRP for Hopper (sm_90a): the two kernels of the in-memory
// main path, with a plain C interface loaded through ctypes
// (repro_torch/kernels/build.py, repro_torch/kernels/fused.py).
//
// What each kernel replaces (the JAX package's Pallas kernels):
//   segment_kernel  K1  src/repro/kernels/fused.py:82  _fused_segment_kernel
//                        (+ the scatter-add XLA fused after it, :170-172)
//   stash_kernel    K2  src/repro/kernels/fused.py:106 _fused_stash_kernel
// Both start from the same per-non-zero work as the Pallas kernels'
// _partial_and_target (fused.py:62): extract every mode's field from the
// (hi, lo) uint32 index words with extract_field_words (fields.cuh, the
// port of src/repro/kernels/delinearize.py:22; a field may straddle the two
// words), add the int32 block base, gather the N-1 non-target factor rows
// and multiply them with the value at the promoted type.
//
// What bounds them: traffic through L2.  Each non-zero reads N-1 factor
// rows of R values (256 B at order 3, R = 32, f32), each a separate 128 B
// request; the factor matrices are MBs and stay in the 50 MB L2, so the
// gathers cost L2 bandwidth, not HBM bandwidth.  Each run of equal target
// adds one 128 B reduction (RED) to L2, and runs are about one non-zero
// long on FROSTT-like data, so the updates add half as much again.  Updates
// to one row queue on one L2 line: on skewed data, where a few rows take a
// large share of the runs, those rows alone can outlast everything else.
// The stream itself (hi + lo + value + N bases, 24 B per non-zero at order
// 3) is read once from HBM.  The arithmetic, N*R multiply-adds per non-zero
// and no product of two matrices, is far below the 67 TFLOP/s f32 rate:
// tensor cores have nothing to do here.  The bound that chip_smoke.py
// reports counts each factor row once (bytes over the HBM rate), which no
// gather design approaches; it also prints the L2 bytes per call.
//
// What the design does about it:
//   * exactly one wave: the wrapper sizes the grid from the occupancy of the
//     kernel it launches (fused_mttkrp_occupancy) times the SM count.  The
//     warps take contiguous pieces of the stream, a multiple of 32
//     non-zeros and about 8 per warp (fused.py::launch_geometry), in turn
//     from one counter, so that an SM that runs ahead takes more: with one
//     static piece per warp the slowest SM would set the end;
//   * a warp takes a piece in batches of B slots (B = 32 for f32 at
//     orders 3 and 4, else 16, see batch_depth).  Each lane loads and
//     decodes one slot (coalesced stream loads).  Stage A: every lane, one
//     column of R, gathers and multiplies all B slots' rows into registers
//     p[0..B) -- B * (N-1) independent read-only loads (ld.global.nc) with
//     no store between them, so they are all in flight at once;
//   * stage B walks p[] in stream order in registers.  Run starts come from
//     one ballot over "my target != my left neighbour's"; the running sum of
//     the current run is carried across batches, and ONE add per column
//     ends each run (paper §5.2: one update per run, not per non-zero).
//     This also fuses the scatter that the JAX package leaves to XLA.  A
//     piece boundary only splits a run into two updates;
//   * K1 sends a run's sum to a small per-CTA table in shared memory
//     (TableSink) when the run's target holds a slot there, else to the
//     output with a global atomicAdd; the table is merged into the output
//     once per CTA.  Targets claim slots as the CTA meets them and keep
//     them, so a hot row's updates reach L2 once per CTA instead of once
//     per run.  Each lane that starts a run looks its target up at once for
//     the whole batch; the walk only reads a bit;
//   * the next batch's stream words are loaded before this batch's gathers,
//     so their HBM latency hides behind the L2 gathers;
//   * the order is a template parameter (3 and 4, NELL-2 and Uber, and one
//     MAX_ORDER instantiation for the rest), and the target mode is moved to
//     slot 0 on the host, so the loops over modes unroll without predicates;
//   * lanes own columns of R (a loop over 32-column groups when R > 32), so
//     neighbouring lanes read neighbouring addresses of a factor row;
//   * K2 cannot copy the Pallas kernel, which zeroes its revisited output
//     block at program_id == 0 and adds to it across grid steps: correct on
//     the TPU's sequential grid, a race on a GPU.  Each CTA instead keeps a
//     shared-memory stash of (out_rows, R), zeroes it, folds its warps'
//     pieces into it by the same walk (StashSink: one shared-memory atomic
//     per run per column), and then merges it with one global atomicAdd per
//     non-zero stash element (paper §5.1 steps 5-7).  The stash is bounded
//     by shared memory: out_rows * R * sizeof(out) <= 227 KB (the wrapper
//     picks K1 beyond).
// What a later PR could do: stage factor matrices small enough for shared
// memory (Uber modes 0 and 1) and gather from there; group equal targets
// that are not adjacent in a batch with __match_any_sync, for fewer
// updates; several columns per lane with 16 B loads, for fewer load and
// shuffle instructions per byte; decode the stream once for all column
// groups when R > 32; a larger table shared by more warps (bigger CTAs),
// since a CTA's stretch of the ALTO-ordered stream meets a narrow range of
// rows, each many times.
//
// Padding slots carry value 0 at coordinate 0 with base 0: they add +0.0 to
// row 0, exactly as in the reference, and 0 * inf stays NaN.  Slots past
// the end of the stream are masked, never gathered into a sum.  Atomics
// reorder float additions from run to run, so results are compared at a
// tolerance, never bit for bit; within a column a warp sums each run in
// stream order.
//
// Types: (vals, factors) in {f32 x f32, f64 x f64, f64 x f32}; the output
// is at the promoted type.  Every entry point returns a cudaError_t code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fields.cuh"

#define FULL_MASK 0xffffffffu
#define THREADS 256
#define EMPTY (-1)                  // an unclaimed slot of K1's table
// K1's table: 2^6 targets x 32 columns (8.4 KB in f32, 16.6 KB in f64 with
// the keys), which leaves most of an SM's shared memory to L1 for the
// gathers; each target may take either of 2 slots, so a hot row whose first
// slot an early cold target took still finds one.
#define TABLE_LOG2 6
#define TABLE_PROBES 2

// Slot 0 is the target mode, slots 1..n-1 the other modes in mode order
// (the order in which the reference multiplies their rows).
struct Fields {
  int n;                    // tensor order
  int shift[MAX_ORDER];     // LSB of each slot's field in the 64-bit index
  int width[MAX_ORDER];     // bits of each slot's field
  int col[MAX_ORDER];       // the slot's mode: its column of `bases`
};

template <typename FT>
struct Factors {
  const FT* p[MAX_ORDER];   // (I_m, R) row-major factor of slot k; p[0] unused
};

// Slots per batch: 32 keeps 32 * (N-1) gathers in flight per lane; f64 sums
// and the generic order take 16, which halves the registers p[] and the
// loads in flight hold.
template <typename OT, int NM>
__host__ __device__ constexpr int batch_depth() {
  return sizeof(OT) == 4 && NM <= 4 ? 32 : 16;
}

// One lane's stream words of one slot, not yet decoded.
template <typename VT, int NM>
struct Words {
  uint32_t h, l;
  VT v;
  int32_t b[NM];            // bases of slot k's mode
};

template <typename VT, int NM>
__device__ __forceinline__ void load_words(
    Words<VT, NM>& w, const uint32_t* __restrict__ hi,
    const uint32_t* __restrict__ lo, const VT* __restrict__ vals,
    const int32_t* __restrict__ bases, const Fields& fl, int n, int64_t e,
    bool ok) {
  w.h = 0u;
  w.l = 0u;
  w.v = VT(0);
#pragma unroll
  for (int k = 0; k < NM; ++k) w.b[k] = 0;
  if (ok) {
    w.h = __ldg(hi + e);
    w.l = __ldg(lo + e);
    w.v = __ldg(vals + e);
#pragma unroll
    for (int k = 0; k < NM; ++k)
      if (k < n) w.b[k] = __ldg(bases + e * n + fl.col[k]);
  }
}

// Where K2 sends a run's sum: the CTA's shared (out_rows, R) stash, which
// holds every target.
template <typename OT>
struct StashSink {
  OT* stash;
  int R;
  __device__ __forceinline__ int claim(int32_t t) const { return 0; }
  __device__ __forceinline__ void add(int32_t t, int probe, OT s, int col,
                                      int lane) const {
    atomicAdd(stash + (int64_t)t * R + col, s);
  }
};

// Where K1 sends a run's sum: the CTA's shared table where the target holds
// a slot there, else the global output.  The table keeps one column group's
// 32 columns for up to 2^TABLE_LOG2 targets: a target takes the first free
// one of its TABLE_PROBES slots and keeps it.  So the targets a CTA meets
// early and often -- on skewed data the hot rows, whose updates would
// otherwise queue on one L2 line from every SM -- are summed in shared
// memory and reach the output once per CTA.
template <typename OT>
struct TableSink {
  static_assert(TABLE_PROBES == 1 || TABLE_PROBES == 2, "one probe bit");
  int32_t* keys;            // 2^TABLE_LOG2 targets, EMPTY where unclaimed
  OT* sums;                 // 2^TABLE_LOG2 x 32 run sums
  OT* out;                  // the global output, row stride R
  int R;
  __device__ __forceinline__ static int slot(int32_t t, int probe) {
    constexpr uint32_t n = 1u << TABLE_LOG2;
    const uint32_t h = ((uint32_t)t * 2654435769u) >> (32 - TABLE_LOG2);
    return (int)((h + probe * (n / TABLE_PROBES)) & (n - 1));
  }
  // the probe whose slot t holds, claiming the first free one, or -1; no
  // slot is ever released, so a later lookup finds the same probe
  __device__ __forceinline__ int claim(int32_t t) const {
#pragma unroll
    for (int i = 0; i < TABLE_PROBES; ++i) {
      const int h = slot(t, i);
      int32_t k = *(volatile int32_t*)(keys + h);
      if (k == EMPTY) {
        k = atomicCAS(keys + h, EMPTY, t);
        if (k == EMPTY) k = t;
      }
      if (k == t) return i;
    }
    return -1;
  }
  __device__ __forceinline__ void add(int32_t t, int probe, OT s, int col,
                                      int lane) const {
    if (probe >= 0)
      atomicAdd(sums + slot(t, probe) * 32 + lane, s);
    else
      atomicAdd(out + (int64_t)t * R + col, s);
  }
};

// One warp folds column group [c0, c0 + 32) of the non-zeros [start, end)
// into `sink`, one add per run of equal target.
template <typename VT, typename FT, typename OT, int NM, typename Sink>
__device__ __forceinline__ void walk_range(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const VT* __restrict__ vals, const int32_t* __restrict__ bases,
    const Factors<FT>& f, const Fields& fl, int R, int c0, int64_t start,
    int64_t end, const Sink& sink) {
  constexpr int B = batch_depth<OT, NM>();
  const int n = NM == MAX_ORDER ? fl.n : NM;
  const int lane = threadIdx.x & 31;
  const int col = c0 + lane;
  const bool active = col < R;
  // inactive lanes gather inside their warp's row (no extra sector) and
  // never add to the output
  const int gcol = active ? col : R - 1;
  int32_t cur = -1;                 // target of the open run, warp-uniform
  int probe = -1;                   // cur's probe in `sink`, -1 if none
  OT acc = OT(0);
  Words<VT, NM> w;
  load_words<VT, NM>(w, hi, lo, vals, bases, fl, n, start + lane,
                     lane < B && start + lane < end);
  for (int64_t batch = start; batch < end; batch += B) {
    const int cnt = end - batch < B ? (int)(end - batch) : B;
    // decode this lane's slot; lanes past the end hold coordinate 0 and
    // value 0
    int32_t crd[NM];
#pragma unroll
    for (int k = 0; k < NM; ++k)
      crd[k] = k < n ? (int32_t)extract_field_words(w.h, w.l, fl.shift[k],
                                                     fl.width[k]) + w.b[k]
                     : 0;
    const VT v = w.v;
    // the next batch's words are in flight during this batch's gathers
    const int64_t next = batch + B + lane;
    load_words<VT, NM>(w, hi, lo, vals, bases, fl, n, next,
                       lane < B && next < end);

    // stage A: all B slots' products, B * (N-1) independent gathers
    OT p[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      OT x = (OT)__shfl_sync(FULL_MASK, v, j);
#pragma unroll
      for (int k = 1; k < NM; ++k) {
        if (k < n) {
          const int32_t c = __shfl_sync(FULL_MASK, crd[k], j);
          const FT y = __ldg(f.p[k] + (int64_t)c * R + gcol);
          if (j < cnt) x *= (OT)y;      // a masked slot stays 0
        }
      }
      p[j] = x;
    }

    // stage B: run starts from one ballot; each lane that starts a run
    // looks its target up in the sink at once, then the warp walks p[] in
    // stream order
    int32_t left = __shfl_up_sync(FULL_MASK, crd[0], 1);
    if (lane == 0) left = cur;
    const bool starts_run = lane < cnt && crd[0] != left;
    const uint32_t starts = __ballot_sync(FULL_MASK, starts_run);
    const int mine = starts_run ? sink.claim(crd[0]) : -1;
    const uint32_t held = __ballot_sync(FULL_MASK, mine >= 0);
    const uint32_t second = __ballot_sync(FULL_MASK, mine == 1);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (starts & (1u << j)) {         // warp-uniform
        if (cur >= 0 && active) sink.add(cur, probe, acc, col, lane);
        cur = __shfl_sync(FULL_MASK, crd[0], j);
        probe = (held >> j) & 1u ? (int)((second >> j) & 1u) : -1;
        acc = OT(0);
      }
      acc += p[j];
    }
  }
  if (cur >= 0 && active) sink.add(cur, probe, acc, col, lane);
}

// One warp folds column group [c0, c0 + 32) of the pieces it takes from
// `next` (pieces of `chunk` non-zeros, handed out in stream order) into
// `sink`: the warps of one wave share the stream by how fast they go.
template <typename VT, typename FT, typename OT, int NM, typename Sink>
__device__ __forceinline__ void walk_pieces(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const VT* __restrict__ vals, const int32_t* __restrict__ bases,
    const Factors<FT>& f, const Fields& fl, int64_t T, int R, int c0,
    int64_t chunk, unsigned long long* next, const Sink& sink) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    unsigned long long piece = 0;
    if (lane == 0) piece = atomicAdd(next, 1ull);
    const int64_t start =
        (int64_t)__shfl_sync(FULL_MASK, piece, 0) * chunk;
    if (start >= T) return;
    const int64_t end = start + chunk < T ? start + chunk : T;
    walk_range<VT, FT, OT, NM>(hi, lo, vals, bases, f, fl, R, c0, start, end,
                               sink);
  }
}

// K1: the warps fold the stream's pieces into the global output, through
// their CTA's table; the table is merged into the output once per column
// group.  next[g] counts the pieces handed out for column group g.
template <typename VT, typename FT, typename OT, int NM>
__global__ void __launch_bounds__(THREADS) segment_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const VT* __restrict__ vals, const int32_t* __restrict__ bases,
    Factors<FT> f, Fields fl, int64_t T, int R, int64_t chunk,
    unsigned long long* next, OT* __restrict__ out) {
  constexpr int H = 1 << TABLE_LOG2;
  __shared__ int32_t keys[H];
  __shared__ OT sums[H * 32];
  const int lane = threadIdx.x & 31;
  const TableSink<OT> sink{keys, sums, out, R};
  for (int c0 = 0; c0 < R; c0 += 32) {
    for (int i = threadIdx.x; i < H; i += blockDim.x) keys[i] = EMPTY;
    for (int i = threadIdx.x; i < H * 32; i += blockDim.x) sums[i] = OT(0);
    __syncthreads();
    walk_pieces<VT, FT, OT, NM>(hi, lo, vals, bases, f, fl, T, R, c0, chunk,
                                next + c0 / 32, sink);
    __syncthreads();
    for (int h = threadIdx.x >> 5; h < H; h += THREADS / 32) {
      const int32_t k = keys[h];
      if (k != EMPTY && c0 + lane < R)
        atomicAdd(out + (int64_t)k * R + c0 + lane, sums[h * 32 + lane]);
    }
    __syncthreads();
  }
}

// K2: the same pieces, folded into the CTA's shared (out_rows, R) stash,
// which is then merged into the global output.
template <typename VT, typename FT, typename OT, int NM>
__global__ void __launch_bounds__(THREADS) stash_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const VT* __restrict__ vals, const int32_t* __restrict__ bases,
    Factors<FT> f, Fields fl, int64_t T, int R, int out_rows, int64_t chunk,
    unsigned long long* next, OT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OT* stash = reinterpret_cast<OT*>(smem_raw);
  const int n = out_rows * R;
  for (int i = threadIdx.x; i < n; i += blockDim.x) stash[i] = OT(0);
  __syncthreads();
  const StashSink<OT> sink{stash, R};
  for (int c0 = 0; c0 < R; c0 += 32)
    walk_pieces<VT, FT, OT, NM>(hi, lo, vals, bases, f, fl, T, R, c0, chunk,
                                next + c0 / 32, sink);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const OT s = stash[i];
    if (s != OT(0)) atomicAdd(out + i, s);
  }
}

// One call of the C interface: a launch, or an occupancy query.
struct Call {
  int variant;              // 0 = segment (K1), 1 = stash (K2)
  const void* hi;
  const void* lo;
  const void* vals;
  const void* bases;
  const void* factors[MAX_ORDER];   // by slot, as Fields
  Fields fl;
  int64_t T;
  int R;
  int out_rows;
  int blocks;
  int64_t chunk;
  void* next;
  void* out;
  cudaStream_t stream;
  cudaEvent_t start;        // recorded just before the kernel, or null
  int smem;                 // query: K2's dynamic shared memory
  int* blocks_per_sm;       // query: out
  int* batch;               // query: out
};

template <typename VT, typename FT, typename OT, int NM>
static cudaError_t run(const Call& c) {
  if (c.blocks_per_sm) {
    *c.batch = batch_depth<OT, NM>();
    if (c.variant == 0)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          c.blocks_per_sm, segment_kernel<VT, FT, OT, NM>, THREADS, 0);
    const cudaError_t err = cudaFuncSetAttribute(
        stash_kernel<VT, FT, OT, NM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, STASH_MAX_BYTES);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        c.blocks_per_sm, stash_kernel<VT, FT, OT, NM>, THREADS,
        (size_t)c.smem);
  }
  Factors<FT> f;
  for (int k = 0; k < MAX_ORDER; ++k)
    f.p[k] = static_cast<const FT*>(c.factors[k]);
  const uint32_t* h = static_cast<const uint32_t*>(c.hi);
  const uint32_t* l = static_cast<const uint32_t*>(c.lo);
  const VT* v = static_cast<const VT*>(c.vals);
  const int32_t* b = static_cast<const int32_t*>(c.bases);
  OT* o = static_cast<OT*>(c.out);
  unsigned long long* next = static_cast<unsigned long long*>(c.next);
  if (c.start) {
    const cudaError_t err = cudaEventRecord(c.start, c.stream);
    if (err != cudaSuccess) return err;
  }
  if (c.variant == 0) {
    segment_kernel<VT, FT, OT, NM><<<c.blocks, THREADS, 0, c.stream>>>(
        h, l, v, b, f, c.fl, c.T, c.R, c.chunk, next, o);
  } else {
    const size_t smem = (size_t)c.out_rows * c.R * sizeof(OT);
    if (smem > STASH_MAX_BYTES) return cudaErrorInvalidValue;
    stash_kernel<VT, FT, OT, NM><<<c.blocks, THREADS, smem, c.stream>>>(
        h, l, v, b, f, c.fl, c.T, c.R, c.out_rows, c.chunk, next, o);
  }
  return cudaGetLastError();
}

template <typename VT, typename FT, typename OT>
static cudaError_t by_order(const Call& c) {
  switch (c.fl.n) {
    case 3:
      return run<VT, FT, OT, 3>(c);
    case 4:
      return run<VT, FT, OT, 4>(c);
    default:
      return run<VT, FT, OT, MAX_ORDER>(c);
  }
}

static cudaError_t by_pair(int dtype_pair, const Call& c) {
  switch (dtype_pair) {
    case 0:
      return by_order<float, float, float>(c);
    case 1:
      return by_order<double, double, double>(c);
    case 2:
      return by_order<double, float, double>(c);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" {

// variant: 0 = segment (K1), 1 = stash (K2).
// dtype_pair: 0 = f32 vals x f32 factors, 1 = f64 x f64, 2 = f64 x f32.
// `out` is (out_rows, R) at the promoted type and must be zeroed.  The grid
// is `blocks` CTAs of THREADS threads; the warps take pieces of `chunk`
// non-zeros (a multiple of 32) in turn, counting them in `next`, one zeroed
// uint64 per column group of 32 columns (ceil(R / 32) of them).  For K2
// the occupancy query below must have run first on this device (it raises
// the kernel's shared-memory limit).
int fused_mttkrp_launch(int variant, int dtype_pair, const void* hi,
                        const void* lo, const void* vals, const void* bases,
                        const void* const* factors, int n_modes, int mode,
                        const int* shifts, const int* widths, long long T,
                        int R, int out_rows, int blocks, long long chunk,
                        void* next, void* out, void* stream,
                        void* start_event) {
  if (n_modes < 1 || n_modes > MAX_ORDER || mode < 0 || mode >= n_modes ||
      R < 1 || T < 0 || out_rows < 1 || (variant != 0 && variant != 1) ||
      blocks < 1 || chunk < 32 || chunk % 32 || next == nullptr)
    return (int)cudaErrorInvalidValue;
  Call c = {};
  c.variant = variant;
  c.fl.n = n_modes;
  c.fl.shift[0] = shifts[mode];
  c.fl.width[0] = widths[mode];
  c.fl.col[0] = mode;
  for (int m = 0, k = 1; m < n_modes; ++m) {
    if (m == mode) continue;
    c.fl.shift[k] = shifts[m];
    c.fl.width[k] = widths[m];
    c.fl.col[k] = m;
    c.factors[k] = factors[m];
    ++k;
  }
  if (T == 0) return (int)cudaSuccess;
  c.hi = hi;
  c.lo = lo;
  c.vals = vals;
  c.bases = bases;
  c.T = T;
  c.R = R;
  c.out_rows = out_rows;
  c.blocks = blocks;
  c.chunk = chunk;
  c.next = next;
  c.out = out;
  c.stream = static_cast<cudaStream_t>(stream);
  c.start = static_cast<cudaEvent_t>(start_event);
  return (int)by_pair(dtype_pair, c);
}

// The current device's SM count, and how many CTAs of the kernel that
// fused_mttkrp_launch would pick for (variant, dtype_pair, n_modes) are
// resident on one SM with `smem_bytes` of dynamic shared memory (K2's
// stash; 0 for K1), and the kernel's batch depth B.  For K2 it also raises
// the kernel's dynamic shared-memory limit to STASH_MAX_BYTES.
int fused_mttkrp_occupancy(int variant, int dtype_pair, int n_modes,
                           int smem_bytes, int* sms, int* blocks_per_sm,
                           int* batch) {
  if (n_modes < 1 || n_modes > MAX_ORDER || (variant != 0 && variant != 1) ||
      smem_bytes < 0 || smem_bytes > STASH_MAX_BYTES ||
      (variant == 0 && smem_bytes))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Call c = {};
  c.variant = variant;
  c.fl.n = n_modes;
  c.smem = smem_bytes;
  c.blocks_per_sm = blocks_per_sm;
  c.batch = batch;
  return (int)by_pair(dtype_pair, c);
}

const char* fused_mttkrp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fused_mttkrp_max_order(void) { return MAX_ORDER; }

int fused_mttkrp_stash_max_bytes(void) { return STASH_MAX_BYTES; }

int fused_mttkrp_threads(void) { return THREADS; }

}  // extern "C"
