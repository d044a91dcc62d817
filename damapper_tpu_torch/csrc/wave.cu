// Batched O(nd) trace-point wave lanes for Hopper (sm_90a).
//
// Replaces the TPU classic wave segment kernels of
// damapper_tpu/ops/wave_pallas.py, all three launched by make_driver over the
// body make_segment, together with their XLA companions make_prologue,
// make_reload, the REACH rest test, the drop-buffer flush and _trim_extract:
//   wave_lanes_launch          <- segment_pallas, the pallas_call at
//                                 wave_pallas.py:1524 (state as ~60 operands)
//   wave_lanes_packed_launch   <- segment_pallas_packed, the pallas_call at
//                                 wave_pallas.py:1457 (state packed into a
//                                 few buffers)
//   wave_lanes_launch at W=64  <- segment_pallas_lp, the pallas_call at
//                                 wave_pallas.py:1413 (two W=64 lanes per
//                                 128-wide row; the lanepack layout below)
// The result is the driver's output contract (wave_pallas.py:1634-1640):
// trim point, REACH point, pebble pool, avail, overflow and wave count per
// lane, cell for cell; the three layouts compute one function.
//
// Design.  One thread block per lane, W threads; thread t owns ring slot t
// (diagonal k with k mod W == t) and keeps that slot's band state (V, M,
// NA, NB, HA, HB, MA, MB, the 61-bit match history T, the lazy trim
// candidate) in registers.  A lane runs from its prologue to its end in one
// launch.  Ring-neighbour reads of the wave start (border inheritance and
// pick3) go through shared memory; every lane-wide result (votes, drop
// ranks, the trim-trigger scan's warp totals, maxima, minima, sums) is a
// warp's shuffles plus one record per warp in a barrier round, and a wave
// without clip or drop trip meets at three barriers (the note in
// wave_body.cuh).  The snake reads the sequences 8 bases per aligned word
// straight from global memory (the TPU kernel's bitmask match
// planes, window reloads and reload stalls exist only because Mosaic had
// neither gathers nor DMA), pebbles go straight to the lane's pool rows in
// global memory (no drop buffer), and the REACH rest test reads its two
// bytes inline after the clip.
//   * plain:    inputs and outputs as one int32 array per field.
//   * packed:   one (N, 8) int32 record per lane in (abase, bbase, mida, k0,
//               aoffp, boffp and two words the classic kernel does not read)
//               and one (N, 16) record out, so the caller moves one array
//               each way: the TPU layout packed its operands for the same
//               reason, fewer transfers.
//   * lanepack: the plain layout at W=64, one block of 64 threads per
//               lane (the wrapper launches wave_lanes_launch).  The TPU packs
//               two W=64 lanes into one 128-row tile because its vector
//               registers are 128 wide.  On this card the packing only
//               costs: two lanes in a 128-thread block wait on named
//               half-block barriers dearer than __syncthreads, and a
//               finished half holds its registers until the other ends;
//               one lane on one warp (two slots a thread, no barrier) is
//               slower still, since one warp then issues the lane's whole
//               wave.  Both lost to one lane a block at every launch size
//               measured (PERF.md §6).
//
// What bounds it on this card: neither bytes nor arithmetic.  A lane reads
// each base of its A and B spans a few times and writes 16 bytes per
// pebble, which at the H100's 3.35 TB/s is microseconds per round; its
// integer work is a few hundred operations per slot per wave.  The waves of
// a lane are a chain of dependent steps, each ending in block barriers, and
// the snake waits on its loads, so the kernel is bound by latency and
// instruction issue.  The design keeps everything but the sequence bytes
// and the pool on chip, runs many lanes per SM (one 64- or 128-thread block
// per lane) so that the SM can switch between lanes while one waits on a
// load or a barrier, and shortens each wave's chain: 8 bases per pair of
// loads in the snake, three barrier rounds a wave where there were sixteen.
//
// The lane itself is wave_body.cuh's wave_lane(), here with the classic
// sequence access (global memory, sentinel 4 outside it); the persistent
// window kernels (wave_persistent.cu) run the same body.  Semantics that
// must match the JAX driver exactly: floor division and modulo on negative
// diagonals (floordiv/floormod), the 61-bit T as one uint64 shifted by the
// whole snake run (the same bit stream as the JAX 16-column chunks), pebble
// drops in trips of DRANK ranks over the [A slots 0..W-1 | B slots 0..W-1]
// order, the band prune on the post-clip band, and the overflow tests at
// the wave start and after every trip.

#include <cstdint>
#include <cuda_runtime.h>

#include "wave_body.cuh"

namespace {

using namespace wavebody;

// plain and packed: one block of W threads per lane
template <int W, bool REV, class IO>
__device__ __forceinline__ void classic_lane(IO io, const uint8_t* A,
                                             long long LA, const uint8_t* B,
                                             long long LB, Consts cs,
                                             int* pool) {
  __shared__ LaneShared<W> sh;
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  int vals[NOUT];
  wave_lane<W, REV>(io.load(lane), ClassicSeq{A, LA, B, LB}, sh, t, cs,
                    reinterpret_cast<int4*>(pool) + (long long)lane * cs.P,
                    vals);
  if (t == 0) io.store(lane, vals);
}

template <int W, bool REV, class IO>
__global__ void __launch_bounds__(W)
wave_lanes_kernel(IO io, const uint8_t* __restrict__ A, long long LA,
                  const uint8_t* __restrict__ B, long long LB, Consts cs,
                  int* __restrict__ pool) {
  classic_lane<W, REV>(io, A, LA, B, LB, cs, pool);
}

// The same lane at W=128 in at most 72 registers, so that an SM holds 7
// lanes where wave_lanes_kernel's 96-111 registers leave room for 4-5.  A
// launch of more lanes than the card holds at once is bound by the
// lane-waves an SM retires rather than by one wave's latency, and there
// the denser kernel wins despite its spilled bytes: on the H100 (700 W),
// 1-9% at 4,096-16,384 lanes; with every lane resident (128 lanes) it
// lost 7-12%.  launch_w picks it only for such launches.
template <bool REV, class IO>
__global__ void __launch_bounds__(128, 7)
wave_lanes_dense_kernel(IO io, const uint8_t* __restrict__ A, long long LA,
                        const uint8_t* __restrict__ B, long long LB,
                        Consts cs, int* __restrict__ pool) {
  classic_lane<128, REV>(io, A, LA, B, LB, cs, pool);
}

// At W=128, a launch of more lanes than wave_lanes_kernel holds on the
// card at once runs wave_lanes_dense_kernel.  A build with
// -DWAVE_DENSE_ABOVE=N (tools/wave_sweep.py's, never the default build)
// runs it for launches of more than N lanes instead, so that the switch can
// be timed on both sides.
template <int W, bool REV, class IO>
cudaError_t launch_w(IO io, const uint8_t* A, long long LA, const uint8_t* B,
                     long long LB, int n, Consts cs, int* pool,
                     cudaStream_t st) {
#ifdef WAVE_DENSE_ABOVE
  if constexpr (W == 128) {
    if ((long long)n > (long long)(WAVE_DENSE_ABOVE)) {
      wave_lanes_dense_kernel<REV, IO><<<n, W, 0, st>>>(io, A, LA, B, LB, cs,
                                                        pool);
      return cudaGetLastError();
    }
  }
#else
  if constexpr (W == 128) {
    int dev = 0, sms = 0, fit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &fit, wave_lanes_kernel<W, REV, IO>, W, 0);
    if (e != cudaSuccess) return e;
    if (n > fit * sms) {
      wave_lanes_dense_kernel<REV, IO><<<n, W, 0, st>>>(io, A, LA, B, LB, cs,
                                                        pool);
      return cudaGetLastError();
    }
  }
#endif
  wave_lanes_kernel<W, REV, IO><<<n, W, 0, st>>>(io, A, LA, B, LB, cs, pool);
  return cudaGetLastError();
}

template <class IO>
cudaError_t launch_lanes(IO io, const uint8_t* A, long long LA,
                         const uint8_t* B, long long LB, int n, int W,
                         int reverse, Consts cs, int* pool,
                         cudaStream_t st) {
  if (W == 64)
    return reverse ? launch_w<64, true>(io, A, LA, B, LB, n, cs, pool, st)
                   : launch_w<64, false>(io, A, LA, B, LB, n, cs, pool, st);
  if (W == 128)
    return reverse ? launch_w<128, true>(io, A, LA, B, LB, n, cs, pool, st)
                   : launch_w<128, false>(io, A, LA, B, LB, n, cs, pool, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int wave_lanes_launch(
    const int* abase, const int* bbase, const int* mida, const int* k0,
    const int* aoffp, const int* boffp, const uint8_t* A, long long LA,
    const uint8_t* B, long long LB, int n, int W, int P, int reverse, int ts,
    int pave, int msc, int dsc, int max_waves, int* out, int* pool,
    void* stream) {
  if (n <= 0) return 0;
  const SplitIO io{abase, bbase, mida, k0, aoffp, boffp, nullptr, nullptr,
                   out, n};
  return (int)launch_lanes(io, A, LA, B, LB, n, W, reverse,
                           Consts{P, ts, pave, msc, dsc, max_waves}, pool,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int wave_lanes_packed_launch(
    const int* rec_in, const uint8_t* A, long long LA, const uint8_t* B,
    long long LB, int n, int W, int P, int reverse, int ts, int pave, int msc,
    int dsc, int max_waves, int* rec_out, int* pool, void* stream) {
  if (n <= 0) return 0;
  const PackedIO io{reinterpret_cast<const int4*>(rec_in),
                    reinterpret_cast<int4*>(rec_out), n};
  return (int)launch_lanes(io, A, LA, B, LB, n, W, reverse,
                           Consts{P, ts, pave, msc, dsc, max_waves}, pool,
                           static_cast<cudaStream_t>(stream));
}

extern "C" const char* wave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
