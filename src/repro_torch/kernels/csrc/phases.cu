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
// writes a (T, R) output as large as one gathered input.
//
// What the simple designs do about it:
//   * K3: one thread per non-zero (grid-stride), each field extracted from
//     the uint32 words as they are (extract_field_words, fields.cuh), no
//     64-bit widening.  Loads of hi/lo are coalesced; the (T, N) bases and
//     coordinates are row-major, so a warp touches one contiguous span.
//   * K4: one CTA per tile of `tile` non-zeros (any divisor of T up to 256).
//     The output layout is the reference's exactly: row k of tile j is the
//     k-th run of equal target in that tile, in stream order; the rows after
//     the last run hold seg_tgt = -1 and zero sums.  A run starts at the
//     tile's first element and wherever the target differs from the element
//     before it; a target that comes back later in the tile starts a new
//     run (the stream is in ALTO order, not sorted, and runs are never
//     merged by key).  Run ids come from warp ballots plus a prefix over the
//     warps' counts; each run's leader records where the run starts, and
//     then thread (k, col) sums run k's column col in stream order, so the
//     gathered rows are read once, neighbouring threads on neighbouring
//     columns.  No atomics: the output is the same from run to run.
//   * K5: the Pallas body zeroes its output at program_id == 0 and adds to
//     it across grid steps, right only on the TPU's sequential grid.  Here,
//     as in K2, every CTA zeroes a shared-memory stash of (out_rows, R),
//     its warps walk contiguous ranges of the stream (lanes own columns)
//     with one shared atomicAdd per run of equal target, and the CTA merges
//     its stash with one global atomicAdd per non-zero element.  The stash
//     must fit 227 KB; the wrapper refuses a larger one.
// What a later PR should do: these kernels are the baseline the fused path
// is compared with, so they stay simple; K4's per-run column sums could
// stage the tile's rows in shared memory with cp.async/TMA.
//
// Types: (vals, gathered rows) in {f32 x f32, f64 x f64, f64 x f32}; sums
// at the promoted type.  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fields.cuh"

#define FULL_MASK 0xffffffffu
#define THREADS 256
#define MAX_TILE 256

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

// K4: one CTA per tile; blockDim is the tile rounded up to a warp.
template <typename VT, typename FT, typename OT>
__global__ void __launch_bounds__(THREADS) segments_kernel(
    const VT* __restrict__ vals, const int32_t* __restrict__ tgt, Rows<FT> g,
    int ng, int R, int tile, int32_t* __restrict__ seg_tgt,
    OT* __restrict__ seg_sums) {
  __shared__ int run_start[MAX_TILE + 1];   // then the tile's end
  __shared__ int warp_runs[THREADS / 32];
  const int64_t base = (int64_t)blockIdx.x * tile;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  int32_t t = 0;
  bool starts = false;
  if (i < tile) {
    t = tgt[base + i];
    starts = i == 0 || t != tgt[base + i - 1];
  }
  const unsigned ballot = __ballot_sync(FULL_MASK, starts);
  if (lane == 0) warp_runs[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  int runs = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) before += warp_runs[w];
    runs += warp_runs[w];
  }
  // (2u << 31) is 0 in 32 bits, so lane 31's mask is every lane
  const int run = before + __popc(ballot & ((2u << lane) - 1u)) - 1;
  if (starts) {
    run_start[run] = i;
    seg_tgt[base + run] = t;
  }
  if (i == 0) run_start[runs] = tile;
  if (i < tile && i >= runs) seg_tgt[base + i] = -1;
  __syncthreads();
  for (int idx = i; idx < tile * R; idx += blockDim.x) {
    const int k = idx / R;
    const int col = idx - k * R;
    OT acc = OT(0);
    if (k < runs) {
      for (int j = run_start[k]; j < run_start[k + 1]; ++j) {
        const int64_t e = base + j;
        OT p = (OT)vals[e];
#pragma unroll
        for (int m = 0; m < MAX_ORDER - 1; ++m)
          if (m < ng) p *= (OT)g.p[m][e * R + col];
        acc += p;
      }
    }
    seg_sums[(base + k) * R + col] = acc;
  }
}

// K5: every CTA folds `per_cta` non-zeros into a shared (out_rows, R) stash,
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

static cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename FT>
static Rows<FT> rows_of(const void* const* gathered, int ng) {
  Rows<FT> g;
  for (int m = 0; m < MAX_ORDER - 1; ++m)
    g.p[m] = m < ng ? static_cast<const FT*>(gathered[m]) : nullptr;
  return g;
}

template <typename VT, typename FT, typename OT>
static cudaError_t segments_typed(const void* vals, const void* tgt,
                                  const void* const* gathered, int ng,
                                  int64_t T, int R, int tile, void* seg_tgt,
                                  void* seg_sums, cudaStream_t stream) {
  const int threads = ((tile + 31) / 32) * 32;
  segments_kernel<VT, FT, OT><<<(unsigned)(T / tile), threads, 0, stream>>>(
      static_cast<const VT*>(vals), static_cast<const int32_t*>(tgt),
      rows_of<FT>(gathered, ng), ng, R, tile, static_cast<int32_t*>(seg_tgt),
      static_cast<OT*>(seg_sums));
  return cudaGetLastError();
}

template <typename VT, typename FT, typename OT>
static cudaError_t stash_typed(const void* vals, const void* tgt,
                               const void* const* gathered, int ng, int64_t T,
                               int R, int out_rows, void* out,
                               cudaStream_t stream) {
  const size_t smem = (size_t)out_rows * R * sizeof(OT);
  if (smem > STASH_MAX_BYTES) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stash_phases_kernel<VT, FT, OT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int64_t blocks = (int64_t)sms * 4;
  const int64_t by_work = (T + 2047) / 2048;
  if (by_work < blocks) blocks = by_work;
  if (blocks < 1) blocks = 1;
  const int64_t per_cta = (T + blocks - 1) / blocks;
  stash_phases_kernel<VT, FT, OT><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const VT*>(vals), static_cast<const int32_t*>(tgt),
      rows_of<FT>(gathered, ng), ng, T, R, out_rows, per_cta,
      static_cast<OT*>(out));
  return cudaGetLastError();
}

extern "C" {

// (T,) hi/lo uint32 + (T, n_modes) int32 bases -> (T, n_modes) int32 coords.
int phases_delinearize_launch(const void* hi, const void* lo,
                              const void* bases, int n_modes,
                              const int* shifts, const int* widths,
                              long long T, void* coords, void* stream) {
  if (n_modes < 1 || n_modes > MAX_ORDER || T < 0)
    return (int)cudaErrorInvalidValue;
  FieldSpec fs;
  fs.n = n_modes;
  for (int m = 0; m < MAX_ORDER; ++m) {
    fs.shift[m] = m < n_modes ? shifts[m] : 0;
    fs.width[m] = m < n_modes ? widths[m] : 0;
  }
  if (T == 0) return (int)cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (T + THREADS - 1) / THREADS;
  if (blocks > (int64_t)sms * 16) blocks = (int64_t)sms * 16;
  delinearize_kernel<<<(unsigned)blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const int32_t*>(bases), fs, T,
      static_cast<int32_t*>(coords));
  return (int)cudaGetLastError();
}

// dtype_pair: 0 = f32 vals x f32 rows, 1 = f64 x f64, 2 = f64 x f32.
// seg_tgt (T,) int32 and seg_sums (T, R) at the promoted type are written in
// full (no zeroing needed).  T % tile == 0, 1 <= tile <= 256.
int phases_segments_launch(int dtype_pair, const void* vals, const void* tgt,
                           const void* const* gathered, int n_gathered,
                           long long T, int R, int tile, void* seg_tgt,
                           void* seg_sums, void* stream) {
  if (n_gathered < 1 || n_gathered > MAX_ORDER - 1 || R < 1 || T < 0 ||
      tile < 1 || tile > MAX_TILE || T % tile != 0 ||
      T / tile > 0x7fffffffLL)      // one CTA per tile: gridDim.x's limit
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_pair) {
    case 0:
      return (int)segments_typed<float, float, float>(
          vals, tgt, gathered, n_gathered, T, R, tile, seg_tgt, seg_sums, s);
    case 1:
      return (int)segments_typed<double, double, double>(
          vals, tgt, gathered, n_gathered, T, R, tile, seg_tgt, seg_sums, s);
    case 2:
      return (int)segments_typed<double, float, double>(
          vals, tgt, gathered, n_gathered, T, R, tile, seg_tgt, seg_sums, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// `out` is (out_rows, R) at the promoted type and must be zeroed; targets
// outside [0, out_rows) are dropped, as the reference's scatter drops them.
int phases_stash_launch(int dtype_pair, const void* vals, const void* tgt,
                        const void* const* gathered, int n_gathered,
                        long long T, int R, int out_rows, void* out,
                        void* stream) {
  if (n_gathered < 1 || n_gathered > MAX_ORDER - 1 || R < 1 || T < 0 ||
      out_rows < 1)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_pair) {
    case 0:
      return (int)stash_typed<float, float, float>(
          vals, tgt, gathered, n_gathered, T, R, out_rows, out, s);
    case 1:
      return (int)stash_typed<double, double, double>(
          vals, tgt, gathered, n_gathered, T, R, out_rows, out, s);
    case 2:
      return (int)stash_typed<double, float, double>(
          vals, tgt, gathered, n_gathered, T, R, out_rows, out, s);
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
