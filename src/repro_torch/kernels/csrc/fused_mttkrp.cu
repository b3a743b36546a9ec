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
// words),
// add the int32 block base, gather the N-1 non-target factor rows and
// multiply them with the value at the promoted type.
//
// What bounds them: bytes.  Per non-zero the stream is hi + lo + value +
// N int32 bases (24 B at order 3 in f32), and the gathers read (N-1) factor
// rows of R values each.  The rows land in L2 often (factor matrices are
// MBs, L2 is 50 MB) but every gather is a separate 128 B transaction, so the
// card's 3.35 TB/s is the roof and the gathers, not the stream, fill it.
// The arithmetic, N*R multiply-adds per non-zero, is far below the 67
// TFLOP/s f32 rate.
//
// What this simple design does about it:
//   * a warp walks one contiguous chunk of the stream; each lane loads one
//     non-zero of a 32-wide batch (coalesced stream loads), decodes it, and
//     the warp then steps through the batch with shuffles;
//   * lanes own columns of R (a loop over 32-column groups when R > 32), so
//     neighbouring lanes read neighbouring addresses of a factor row;
//   * the running sum of the current run of equal target index stays in a
//     register; when the target changes or the chunk ends the warp issues
//     ONE atomicAdd per column (paper §5.2: one update per run, not per
//     non-zero).  This also fuses the scatter that the JAX package leaves
//     to XLA.  Factor matrices are read from global memory / L2: the Pallas
//     kernel's whole-factor-in-VMEM limit does not apply here;
//   * K2 cannot copy the Pallas kernel, which zeroes its revisited output
//     block at program_id == 0 and adds to it across grid steps: correct on
//     the TPU's sequential grid, a race on a GPU.  Each CTA instead keeps a
//     shared-memory stash of (out_rows, R), zeroes it, folds its range of
//     the stream into it with shared-memory atomics (one per run), and then
//     merges it with one global atomicAdd per non-zero stash element
//     (paper §5.1 steps 5-7).  The grid is a small multiple of the SM count
//     so the merge stays cheap.  The stash is bounded by shared memory:
//     out_rows * R * sizeof(out) <= 227 KB (the wrapper picks K1 beyond).
// What a later PR should do: a warp-shuffle segmented reduction over the
// batch instead of the serial walk, cp.async prefetch of the next batch of
// the index stream, and several columns per lane to raise bytes in flight.
//
// Padding slots carry value 0 at coordinate 0 with base 0: they add +0.0 to
// row 0, exactly as in the reference.  Atomics reorder float additions from
// run to run, so results are compared at a tolerance, never bit for bit.
//
// Types: (vals, factors) in {f32 x f32, f64 x f64, f64 x f32}; the output
// is at the promoted type.  Every entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "fields.cuh"

#define FULL_MASK 0xffffffffu
#define THREADS 256

struct Fields {
  int n;                    // tensor order
  int mode;                 // target mode
  int shift[MAX_ORDER];     // LSB of each mode's field in the 64-bit index
  int width[MAX_ORDER];     // bits of each mode's field
};

template <typename FT>
struct Factors {
  const FT* p[MAX_ORDER];   // (I_m, R) row-major factor matrices
};

// One warp folds the non-zeros [start, end) into `out` (row stride R),
// which is the global output (K1) or the CTA's shared stash (K2).
template <typename VT, typename FT, typename OT>
__device__ __forceinline__ void walk_range(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const VT* __restrict__ vals, const int32_t* __restrict__ bases,
    const Factors<FT>& f, const Fields& fl, int R, int64_t start,
    int64_t end, OT* out) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < R; c0 += 32) {
    const int col = c0 + lane;
    const bool active = col < R;
    int32_t cur = -1;
    OT acc = OT(0);
    for (int64_t batch = start; batch < end; batch += 32) {
      // each lane loads and decodes one non-zero of the batch
      const int64_t e = batch + lane;
      int32_t crd[MAX_ORDER];
      int32_t tgt = 0;
      VT v = VT(0);
#pragma unroll
      for (int m = 0; m < MAX_ORDER; ++m) crd[m] = 0;
      if (e < end) {
        const uint32_t h = hi[e];
        const uint32_t l = lo[e];
        v = vals[e];
#pragma unroll
        for (int m = 0; m < MAX_ORDER; ++m) {
          if (m < fl.n) {
            crd[m] = (int32_t)extract_field_words(h, l, fl.shift[m], fl.width[m]) +
                     bases[e * fl.n + m];
            if (m == fl.mode) tgt = crd[m];
          }
        }
      }
      // then the warp steps through the batch in stream order
      const int cnt = (int)(end - batch < 32 ? end - batch : 32);
      for (int j = 0; j < cnt; ++j) {
        const int32_t t = __shfl_sync(FULL_MASK, tgt, j);
        OT p = (OT)__shfl_sync(FULL_MASK, v, j);
#pragma unroll
        for (int m = 0; m < MAX_ORDER; ++m) {
          if (m < fl.n && m != fl.mode) {
            const int32_t c = __shfl_sync(FULL_MASK, crd[m], j);
            if (active) p *= (OT)f.p[m][(int64_t)c * R + col];
          }
        }
        if (t != cur) {             // a run ends: one update for all of it
          if (cur >= 0 && active) atomicAdd(out + (int64_t)cur * R + col, acc);
          cur = t;
          acc = OT(0);
        }
        acc += p;
      }
    }
    if (cur >= 0 && active) atomicAdd(out + (int64_t)cur * R + col, acc);
  }
}

// K1: every warp folds one chunk of `chunk` non-zeros into the global output.
template <typename VT, typename FT, typename OT>
__global__ void __launch_bounds__(THREADS) segment_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const VT* __restrict__ vals, const int32_t* __restrict__ bases,
    Factors<FT> f, Fields fl, int64_t T, int R, int64_t chunk, OT* out) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t start = warp * chunk;
  if (start >= T) return;
  const int64_t end = start + chunk < T ? start + chunk : T;
  walk_range<VT, FT, OT>(hi, lo, vals, bases, f, fl, R, start, end, out);
}

// K2: every CTA folds `per_cta` non-zeros into a shared (out_rows, R) stash,
// then merges the stash into the global output.
template <typename VT, typename FT, typename OT>
__global__ void __launch_bounds__(THREADS) stash_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const VT* __restrict__ vals, const int32_t* __restrict__ bases,
    Factors<FT> f, Fields fl, int64_t T, int R, int out_rows,
    int64_t per_cta, OT* out) {
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
  if (start < end)
    walk_range<VT, FT, OT>(hi, lo, vals, bases, f, fl, R, start, end, stash);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const OT s = stash[i];
    if (s != OT(0)) atomicAdd(out + i, s);
  }
}

template <typename VT, typename FT, typename OT>
static cudaError_t launch_typed(int variant, const void* hi, const void* lo,
                                const void* vals, const void* bases,
                                const void* const* factors, const Fields& fl,
                                int64_t T, int R, int out_rows, void* out,
                                cudaStream_t stream) {
  Factors<FT> f;
  for (int m = 0; m < MAX_ORDER; ++m)
    f.p[m] = m < fl.n ? static_cast<const FT*>(factors[m]) : nullptr;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const uint32_t* h = static_cast<const uint32_t*>(hi);
  const uint32_t* l = static_cast<const uint32_t*>(lo);
  const VT* v = static_cast<const VT*>(vals);
  const int32_t* b = static_cast<const int32_t*>(bases);
  OT* o = static_cast<OT*>(out);
  if (variant == 0) {
    // about 64 resident warps per SM, each over one chunk (a multiple of 32)
    const int64_t want = (int64_t)sms * 64;
    int64_t chunk = (T + want - 1) / want;
    chunk = ((chunk + 31) / 32) * 32;
    const int64_t warps = (T + chunk - 1) / chunk;
    const int64_t blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
    segment_kernel<VT, FT, OT><<<(unsigned)blocks, THREADS, 0, stream>>>(
        h, l, v, b, f, fl, T, R, chunk, o);
  } else {
    const size_t smem = (size_t)out_rows * R * sizeof(OT);
    if (smem > STASH_MAX_BYTES) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(stash_kernel<VT, FT, OT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    int64_t blocks = (int64_t)sms * 4;
    const int64_t by_work = (T + 2047) / 2048;
    if (by_work < blocks) blocks = by_work;
    if (blocks < 1) blocks = 1;
    const int64_t per_cta = (T + blocks - 1) / blocks;
    stash_kernel<VT, FT, OT><<<(unsigned)blocks, THREADS, smem, stream>>>(
        h, l, v, b, f, fl, T, R, out_rows, per_cta, o);
  }
  return cudaGetLastError();
}

extern "C" {

// variant: 0 = segment (K1), 1 = stash (K2).
// dtype_pair: 0 = f32 vals x f32 factors, 1 = f64 x f64, 2 = f64 x f32.
// `out` is (out_rows, R) at the promoted type and must be zeroed.
int fused_mttkrp_launch(int variant, int dtype_pair, const void* hi,
                        const void* lo, const void* vals, const void* bases,
                        const void* const* factors, int n_modes, int mode,
                        const int* shifts, const int* widths, long long T,
                        int R, int out_rows, void* out, void* stream) {
  if (n_modes < 1 || n_modes > MAX_ORDER || mode < 0 || mode >= n_modes ||
      R < 1 || T < 0 || out_rows < 1 || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  Fields fl;
  fl.n = n_modes;
  fl.mode = mode;
  for (int m = 0; m < MAX_ORDER; ++m) {
    fl.shift[m] = m < n_modes ? shifts[m] : 0;
    fl.width[m] = m < n_modes ? widths[m] : 0;
  }
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_pair) {
    case 0:
      return (int)launch_typed<float, float, float>(variant, hi, lo, vals, bases,
                                                    factors, fl, T, R, out_rows,
                                                    out, s);
    case 1:
      return (int)launch_typed<double, double, double>(variant, hi, lo, vals,
                                                       bases, factors, fl, T, R,
                                                       out_rows, out, s);
    case 2:
      return (int)launch_typed<double, float, double>(variant, hi, lo, vals,
                                                      bases, factors, fl, T, R,
                                                      out_rows, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* fused_mttkrp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int fused_mttkrp_max_order(void) { return MAX_ORDER; }

int fused_mttkrp_stash_max_bytes(void) { return STASH_MAX_BYTES; }

}  // extern "C"
