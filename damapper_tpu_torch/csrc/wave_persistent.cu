// Persistent wave lanes with their sequence windows in shared memory, for
// Hopper (sm_90a).
//
// Replaces the TPU persistent wave kernels of damapper_tpu/ops/wave_pallas.py,
// all three launched by make_persistent_driver over the body
// make_persistent_kernel.kernel_fn and wrapped by make_persistent_wrapped:
//   wave_persistent_launch          <- kernel_pallas, the pallas_call at
//                                      wave_pallas.py:2104 (state as separate
//                                      operands)
//   wave_persistent_packed_launch   <- kernel_pallas_packed, the pallas_call
//                                      at wave_pallas.py:2031 (packed operands)
//   wave_persistent_launch at W=64  <- kernel_pallas_lp, the pallas_call at
//                                      wave_pallas.py:1981 (two lanes per
//                                      row; the lanepack layout below)
// The result is the driver's output contract (wave_pallas.py:2196-2206):
// trim point, REACH point, pebble pool, avail, overflow and wave count per
// lane, as wave.cu gives it; on every lane that no kernel flags as overflowed
// it equals wave.cu's.
//
// Design.  The TPU kernel keeps each lane's A and B sequence window (L bases
// each, placed around the seed by the wrapper: ops/wave_persistent.py
// persistent_windows) resident in VMEM and runs the lane to its end against
// it.  Here one block stages the lane's two windows [awst, awst + L) and
// [bwst, bwst + L) into dynamic shared memory with 16-byte coalesced loads
// (bytes past the end of the sequence memory read 4, as the JAX padding to
// LAp does), and then runs wave_body.cuh's wave_lane() with the window
// policy: every snake step and REACH byte is a shared-memory read.  A lane
// that needs a byte outside its window is flagged as overflowed and stops
// (the engine re-runs it on wave.cu).  The windows stay in global
// coordinates and in forward order: the TPU flip of the reverse window is a
// layout detail of Mosaic slicing.  The reload loop, the REACH rest stall
// and the drop buffer of the TPU kernel have no counterpart: the lane reads
// what it needs, and pebbles go straight to its pool rows, so each direction
// is one launch.
//   * plain:    one block of W=64 threads per lane (the band the persistent
//               engine runs), inputs and outputs as wave.cu's (one int32
//               array per field).
//   * packed:   one (N, 8) int32 record per lane in (abase, bbase, mida, k0,
//               aoffp, boffp, awst, bwst), read as two 16-byte loads, and one
//               (N, 16) record out (the 14 fields and 2 pad words) written as
//               four 16-byte stores, so the caller moves one array each way.
//   * lanepack: the plain layout, one block of W=64 threads per lane (the
//               wrapper launches wave_persistent_launch).  The TPU runs two
//               lanes per 128-wide row because of its vector width.  Here
//               two lanes in a 128-thread block wait on named half-block
//               barriers, and their 4L bytes of windows leave shared memory
//               at L = 65,536; one lane on one warp issues the lane's whole
//               wave from one warp.  Both lost to one lane a block (PERF.md
//               §6), which keeps its 2L bytes of windows in shared memory up
//               to L = 65,536.
// Windows that do not fit the 227 KB of shared memory a block may use (2L
// bytes per lane, plus the body's static state) take the same policy with
// the bytes read in place from global memory (SMEM=false below): same
// bounds, same miss flags, same outputs.  The wrapper picks the route by
// size, or as its caller asks.
//
// What bounds it on this card: latency.  The bytes are the two windows per
// lane and the pool rows (tens of kilobytes per lane, microseconds per round
// at 3.35 TB/s), the arithmetic a few hundred integer operations per slot
// per wave; but the waves of a lane are a chain of dependent steps, each
// ending in barriers, and each snake step waits on the byte before it.  The
// shared-memory window turns those waits from L2/device-memory latency into
// ~30-cycle shared-memory reads; the price is 2L bytes of shared memory per
// lane, which caps the lanes resident per SM (about six at L = 16384).

#include <cstdint>
#include <cuda_runtime.h>

#include "wave_body.cuh"

namespace {

using namespace wavebody;

// Stage one window [wst, wst + L) of the sequence memory mem[0, LM) into
// shared memory; bytes past LM read 4.  t/nt: this thread and the stride.
// The snake's word walks need no padding around it: they load an 8-byte
// word whole only when it lies inside [0, L) and read the rest byte by byte
// (wave_body.cuh WordWalk); each window starts 16-byte aligned (L is a
// multiple of 128), so every word inside is whole.
__device__ __forceinline__ void stage_window(uint8_t* dst,
                                             const uint8_t* __restrict__ mem,
                                             long long LM, long long wst,
                                             int L, int t, int nt) {
  const long long av = LM - wst;
  const int full = av >= L ? L : (av > 0 ? (int)av : 0);
  const uint8_t* src = mem + wst;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = full >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = t; i < nv; i += nt) d4[i] = __ldg(s4 + i);
    done = nv << 4;
  }
  for (int i = done + t; i < L; i += nt)
    dst[i] = i < full ? __ldg(src + i) : (uint8_t)4;
}

// The window policy of one lane: staged into win[0, 2L) when SMEM (the
// caller synchronises before the first read), else read in place.
template <bool SMEM>
__device__ __forceinline__ WindowSeq<SMEM> make_window(
    uint8_t* win, const uint8_t* A, long long LA, const uint8_t* B,
    long long LB, long long awst, long long bwst, int L, int t, int nt) {
  WindowSeq<SMEM> s;
  s.awst = awst;
  s.bwst = bwst;
  s.L = L;
  if (SMEM) {
    stage_window(win, A, LA, awst, L, t, nt);
    stage_window(win + L, B, LB, bwst, L, t, nt);
    s.wa = win;
    s.wb = win + L;
    s.valida = s.validb = L;
  } else {
    s.wa = A + awst;
    s.wb = B + bwst;
    s.valida = LA - awst;
    s.validb = LB - bwst;
  }
  return s;
}

// plain and packed: one block of W threads per lane
template <int W, bool REV, bool SMEM, class IO>
__global__ void __launch_bounds__(W)
persistent_kernel(IO io, const uint8_t* __restrict__ A, long long LA,
                  const uint8_t* __restrict__ B, long long LB, int L,
                  Consts cs, int* __restrict__ pool) {
  extern __shared__ __align__(16) uint8_t g_win[];
  __shared__ LaneShared<W> sh;
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  long long awst, bwst;
  io.window(lane, awst, bwst);
  const WindowSeq<SMEM> seq =
      make_window<SMEM>(g_win, A, LA, B, LB, awst, bwst, L, t, W);
  if (SMEM) __syncthreads();
  int vals[NOUT];
  wave_lane<W, REV>(io.load(lane), seq, sh, t, cs,
                    reinterpret_cast<int4*>(pool) + (long long)lane * cs.P,
                    vals);
  if (t == 0) io.store(lane, vals);
}

// Launch one instantiation on `blocks` blocks of `threads` threads, with
// `dyn` bytes of dynamic shared memory (0 for the global route).
template <class Kern, class IO>
cudaError_t launch(Kern kern, int blocks, int threads, size_t dyn, IO io,
                   const uint8_t* A, long long LA, const uint8_t* B,
                   long long LB, int L, Consts cs, int* pool,
                   cudaStream_t st) {
  if (dyn > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) {
      cudaGetLastError();   // leave no stale error for the next launch
      return e;
    }
  }
  kern<<<blocks, threads, dyn, st>>>(io, A, LA, B, LB, L, cs, pool);
  return cudaGetLastError();
}

// plain and packed: W=64, the persistent engine's band
template <class IO>
cudaError_t launch_lanes(IO io, int n, int W, int reverse, int smem,
                         const uint8_t* A, long long LA, const uint8_t* B,
                         long long LB, int L, Consts cs, int* pool,
                         cudaStream_t st) {
  if (W != 64) return cudaErrorInvalidValue;
  const size_t dyn = smem ? 2 * (size_t)L : 0;
#define WP_LAUNCH(R_, S_)                                                  \
  return launch(persistent_kernel<64, R_, S_, IO>, n, 64, dyn, io, A, LA, \
                B, LB, L, cs, pool, st)
  if (reverse) {
    if (smem) WP_LAUNCH(true, true);
    WP_LAUNCH(true, false);
  }
  if (smem) WP_LAUNCH(false, true);
  WP_LAUNCH(false, false);
#undef WP_LAUNCH
}

}  // namespace

extern "C" int wave_persistent_launch(
    const int* abase, const int* bbase, const int* mida, const int* k0,
    const int* aoffp, const int* boffp, const int* awst, const int* bwst,
    const uint8_t* A, long long LA, const uint8_t* B, long long LB, int n,
    int W, int P, int L, int reverse, int smem, int ts, int pave, int msc,
    int dsc, int max_waves, int* out, int* pool, void* stream) {
  if (n <= 0) return 0;
  const SplitIO io{abase, bbase, mida, k0, aoffp, boffp, awst, bwst, out, n};
  return (int)launch_lanes(io, n, W, reverse, smem, A, LA, B, LB, L,
                           Consts{P, ts, pave, msc, dsc, max_waves}, pool,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int wave_persistent_packed_launch(
    const int* rec_in, const uint8_t* A, long long LA, const uint8_t* B,
    long long LB, int n, int W, int P, int L, int reverse, int smem, int ts,
    int pave, int msc, int dsc, int max_waves, int* rec_out, int* pool,
    void* stream) {
  if (n <= 0) return 0;
  const PackedIO io{reinterpret_cast<const int4*>(rec_in),
                    reinterpret_cast<int4*>(rec_out), n};
  return (int)launch_lanes(io, n, W, reverse, smem, A, LA, B, LB, L,
                           Consts{P, ts, pave, msc, dsc, max_waves}, pool,
                           static_cast<cudaStream_t>(stream));
}

extern "C" const char* wave_persistent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
