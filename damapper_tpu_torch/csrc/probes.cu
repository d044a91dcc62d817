// Op-cost probes for Hopper (sm_90a): the loops of the JAX package's three
// Mosaic microbenchmarks, each a kernel that runs `n` iterations of one
// pattern of the wave body's inner loop on a (G, W) int32 array.
//
//   probe_floor_launch <- tools/mosaic_floor.py:32 bench.kernel (pallas_call
//                         at :62): nops/4 quads per iteration, "mix" (x+1;
//                         where(x>100000, x-100000, x); roll(x, 1, axis=1);
//                         max(x, x^2)) or "add" (x+1, ^3, +7, ^5).
//   probe_ops_launch   <- tools/mosaic_ops.py:102 bench.kernel (pallas_call
//                         at :123) over mk_patterns (:32-99): one pattern
//                         applied `reps` times per iteration (butterfly
//                         max(1, reps/7) times).
//   probe_carry_launch <- tools/mosaic_carry.py:27 bench.kernel (pallas_call
//                         at :44) over the five bodies of main (:73-136).
//
// Layouts, one per barrier policy (each kernel serves two of them):
//   BlockBar  one row g per block of W threads, thread t owns column t, as
//             the wave kernels own one lane per W threads; every step across
//             columns goes through shared memory and __syncthreads: a roll
//             is exchange() (a store, a barrier, a neighbour read, a
//             barrier), a row max or sum block_reduce() (a warp butterfly,
//             then the warps' values through shared memory between two
//             barriers), a vote __syncthreads_or.  These are the block rounds
//             the wave body runs, so the block policy prices them.  All three
//             kernels serve it.
//   WarpBar   one row g on one warp, kWarpRows rows a block: lane l holds the
//             V = W/32 consecutive columns [l*V, l*V + V) in V registers,
//             and no step meets a barrier.  A roll by one column moves the
//             registers up by one and takes register V-1 of lane l-1 with one
//             __shfl_sync; a row max folds the V registers, then one
//             redux.sync (every lane gets the result: the broadcast); the
//             one-hot grab of column c is register c mod V of lane c/V (a
//             tree of selects, then one shuffle); cond votes with __any_sync;
//             the butterfly's shifts below V move within the registers, one
//             shuffle from lane l+1 for each register that crosses, and a
//             shift of d*V takes each register from d lanes down.  The carry
//             bodies carry V columns a lane; the dbuf bodies take column 0's
//             slot from lane 0 by one shuffle and store the row max from
//             lanes 0-3 into the row's own slice of shared memory, which
//             nothing reads before the loop ends.  So the warp policy prices
//             the warp-wide steps against the block rounds they would
//             replace.  All three kernels serve it.
//
// int32 arithmetic wraps in two's complement, as in JAX: every add that can
// overflow goes through unsigned (wadd), since signed overflow is undefined
// in C++ and nvcc exploits it.  The iteration count n (and reps, nquads)
// are runtime arguments, as the Pallas kernels read n from SMEM, so nvcc
// cannot fold the loop.  keep() ends every iteration by making the carried
// registers opaque to the front end, so no iteration is folded into a
// closed form (x += 1 repeated n times would otherwise become x += n); it
// emits nothing, so ptxas still sees through it, and the iteration loop
// runs one iteration per trip (#pragma unroll 1, as the Pallas while_loop
// does) so that ptxas cannot merge two iterations' adds either (unrolled
// by two, carry60's sixty +1s became thirty +2s).  chip_smoke.py checks
// the SASS of every loop body for the pattern's instructions, and that no
// warp-policy kernel holds a barrier.
//
// What bounds them on this card: none is bound by bytes (each reads and
// writes its (G, W) arrays once) or by the integer issue rate (at most a
// few hundred operations per thread per iteration on 132 SMs; carry60
// comes nearest, see probe_carry below).  They are bound
// by the latency of dependent chains.  Under the block policy the
// elementwise chains wait on the ALU latency of one thread, and the rolls,
// votes and reductions on barrier and shared-memory round trips (PERF.md
// section 6: a vote ~26 ns, an exchange 33-46, a block reduction 104-121,
// a butterfly 214-294).  The warp policy removes the round trips: a roll
// or a grab is one shuffle, a reduction a fold and one redux.sync, a vote
// one VOTE (at W=128: ~8, ~29, ~32 and ~7 ns; a butterfly ~129).  What is
// left is the shuffle and redux latency and the ALU chains, which now
// interleave V columns a thread: issue, not latency, bounds them once V
// times the chain's instructions pass its latency (elemwise at W=128:
// ~11 ns an application against the block policy's ~7).  At G=128 a launch fills about one SM per row (one
// warp under the warp policy), so no other warp hides that latency, as in
// a wave launch of 128 lanes.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "wave_body.cuh"

namespace {

using namespace wavebody;

// the barrier policies: the whole block, or none (one row a warp)
struct BlockBar {
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

struct WarpBar {};

// rows (warps) in a block under the warp policy: 1 and 4 ran within 5% of
// each other on every pattern and shape on the H100 (PERF.md section 6)
constexpr int kWarpRows = 4;

template <int V>
struct Int {
  static constexpr int value = V;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// the register holds a value the compiler may not reason about
__device__ __forceinline__ void keep(int& v) { asm volatile("" : "+r"(v)); }

struct OpWrapSum {
  __device__ int operator()(int a, int b) const { return wadd(a, b); }
};

// the block's vote over the row's threads
__device__ __forceinline__ int vote_any(const BlockBar&, int p) {
  return __syncthreads_or(p);
}

// the op over the row's W values: a warp butterfly, then the NW warps'
// values through red between two barriers (the first waits for the
// earlier readers of red)
template <int NW, class Bar, class Op>
__device__ __forceinline__ int block_reduce(int v, int* red, const Bar& bar,
                                            int t, Op op) {
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  bar.sync();
  if ((t & 31) == 0) red[t >> 5] = v;
  bar.sync();
  int r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r = op(r, red[i]);
  return r;
}

// row geometry of a barrier policy
template <int W, class Bar>
struct Row;

template <int W>
struct Row<W, BlockBar> {
  static constexpr int kThreads = W, kRows = 1;
  __device__ static int half() { return 0; }
  __device__ static int g() { return blockIdx.x; }
  __device__ static int t() { return threadIdx.x; }
  __device__ static BlockBar bar() { return BlockBar{}; }
};

// the row's value at column src: a store to shared memory, a barrier, a
// neighbour read, and a barrier before the buffer is written again
template <class Bar>
__device__ __forceinline__ int exchange(int v, int src, int* buf,
                                        const Bar& bar, int t) {
  buf[t] = v;
  bar.sync();
  const int r = buf[src];
  bar.sync();
  return r;
}

// the warp policy's row: warp threadIdx.x / 32 of the block, lane l holding
// columns [l*V, l*V + V); a warp whose row is past G returns at once
template <int W>
struct Row<W, WarpBar> {
  static constexpr int kThreads = 32 * kWarpRows, kRows = kWarpRows;
  __device__ static int g() {
    return blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  }
  __device__ static int t() { return threadIdx.x & 31; }
};

// roll(x, 1) along a warp's row: column j takes column j - 1 (mod W), so
// the registers move up by one and register 0 takes register V-1 of lane
// l-1 (lane 0 that of lane 31: column W-1)
template <int V>
__device__ __forceinline__ void warp_roll(int (&v)[V], int l) {
  const int c = __shfl_sync(FULL, v[V - 1], (l + 31) & 31);
#pragma unroll
  for (int k = V - 1; k > 0; --k) v[k] = v[k - 1];
  v[0] = c;
}

// the row's max, in every lane: fold the V registers, then one redux.sync
template <int V>
__device__ __forceinline__ int warp_row_max(const int (&v)[V]) {
  int m = v[0];
#pragma unroll
  for (int k = 1; k < V; ++k) m = max(m, v[k]);
  return __reduce_max_sync(FULL, m);
}

// the row's value at column c, which the whole warp agrees on: register
// c mod V of lane c / V.  The register is picked by a tree of selects on
// the bits of c (log2 V deep), then one shuffle brings it from its lane.
// A chain of selects on c mod V == k compiled at V=4 to the lowering of a
// dynamically indexed array (branches), 2.7x slower.  The one-hot sum of the Pallas pattern has exactly one
// non-zero term, so this is that sum.
template <int V>
__device__ __forceinline__ int warp_grab(const int (&v)[V], unsigned c) {
  int t[V];
#pragma unroll
  for (int k = 0; k < V; ++k) t[k] = v[k];
#pragma unroll
  for (int w = 1; w < V; w <<= 1)
#pragma unroll
    for (int k = 0; k < V; k += 2 * w) t[k] = (c & w) ? t[k + w] : t[k];
  return __shfl_sync(FULL, t[0], c / V);
}

// one application of the revcummax scan on a warp's row: for sft = 1, 2,
// ..., W/2, o[j] = max(o[j], j + sft < W ? o[j + sft] : NEG_BIG), every
// shift's values taken before it writes.  sft < V: register k takes
// register k+sft of its own lane, or register k+sft-V of lane l+1 (one
// shuffle a crossing register; past the row's end only for lane 31, whose
// shuffle returns its own value, masked).  sft = d*V: register k takes
// register k of lane l+d, past the row's end for l + d >= 32.
template <int W>
__device__ __forceinline__ void warp_butterfly(int (&o)[W / 32], int l) {
  constexpr int V = W / 32;
#pragma unroll
  for (int sft = 1; sft < V; sft <<= 1) {
    int sh[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int src = o[(k + sft) & (V - 1)];
      sh[k] = k + sft < V ? src : __shfl_down_sync(FULL, src, 1);
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      o[k] = max(o[k], (k + sft < V || l < 31) ? sh[k] : NEG_BIG);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int sh = __shfl_down_sync(FULL, o[k], d);
      o[k] = max(o[k], l + d < 32 ? sh : NEG_BIG);
    }
  }
}

// ---------------------------------------------------------------------------
// probe_floor: tools/mosaic_floor.py:32.  Carried state: x, all of it in the
// output.  Bound: latency; "mix" one exchange per quad (block policy) or
// one shuffle (warp policy), "add" a chain of four dependent ALU
// operations per quad.
// ---------------------------------------------------------------------------

template <int W, class Bar, bool ADD>
__global__ void __launch_bounds__((Row<W, Bar>::kThreads))
floor_kernel(const int* __restrict__ xin, int* __restrict__ out, int G,
             int n, int nquads) {
  using R = Row<W, Bar>;
  __shared__ int buf[R::kRows][W];
  const int g = R::g(), t = R::t();
  if (g >= G) return;
  const Bar bar = R::bar();
  int* const b = buf[R::half()];
  const int left = (t - 1) & (W - 1);   // roll(x, 1): x[j - 1]
  const long long i0 = (long long)g * W + t;
  int x = xin[i0];
#pragma unroll 1
  for (int it = 0; it < n; ++it) {
    for (int q = 0; q < nquads; ++q) {
      if (ADD) {
        x = wadd(x, 1);
        x ^= 3;
        x = wadd(x, 7);
        x ^= 5;
      } else {
        x = wadd(x, 1);
        x = x > 100000 ? x - 100000 : x;
        x = exchange(x, left, b, bar, t);
        x = max(x, x ^ 2);
      }
    }
    keep(x);
  }
  out[i0] = x;
}

// the warp policy: V chains a thread; "mix" rolls with one shuffle a quad
template <int W, bool ADD>
__global__ void __launch_bounds__((Row<W, WarpBar>::kThreads))
floor_warp_kernel(const int* __restrict__ xin, int* __restrict__ out, int G,
                  int n, int nquads) {
  using R = Row<W, WarpBar>;
  constexpr int V = W / 32;
  const int g = R::g(), l = R::t();
  if (g >= G) return;
  const long long i0 = (long long)g * W + l * V;
  int x[V];
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = xin[i0 + k];
#pragma unroll 1
  for (int it = 0; it < n; ++it) {
    for (int q = 0; q < nquads; ++q) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (ADD) {
          x[k] = wadd(x[k], 1);
          x[k] ^= 3;
          x[k] = wadd(x[k], 7);
          x[k] ^= 5;
        } else {
          x[k] = wadd(x[k], 1);
          x[k] = x[k] > 100000 ? x[k] - 100000 : x[k];
        }
      }
      if (!ADD) {
        warp_roll(x, l);
#pragma unroll
        for (int k = 0; k < V; ++k) x[k] = max(x[k], x[k] ^ 2);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) keep(x[k]);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) out[i0 + k] = x[k];
}

// ---------------------------------------------------------------------------
// probe_ops: tools/mosaic_ops.py:102.  Carried state: x and s, both in the
// outputs (scal_arith changes only s; x passes through).  cond: s is an
// input and never changes, so each block reduces (s > 0).any() over all G
// rows once before its loop; every application then votes on it with
// vote_any() (__syncthreads_or) and takes the branch.  Bound: latency of
// the pattern's chain (see top).
// ---------------------------------------------------------------------------

enum { ELEMWISE, ROLL, REDUCE_ROW, REDUCE_SCAL, ONEHOT_GRAB, SCAL_ARITH, COND,
       BUTTERFLY, NPAT };

template <int W, class Bar, int PAT>
__global__ void __launch_bounds__((Row<W, Bar>::kThreads))
ops_kernel(const int* __restrict__ xin, const int* __restrict__ s_in,
           int* __restrict__ xout, int* __restrict__ sout, int G, int n,
           int reps) {
  using R = Row<W, Bar>;
  constexpr int NW = W / 32;
  __shared__ int buf[R::kRows][W];
  __shared__ int red[R::kRows][NW];
  const int g = R::g(), t = R::t();
  if (g >= G) return;
  const Bar bar = R::bar();
  int* const b = buf[R::half()];
  int* const rd = red[R::half()];
  const long long i0 = (long long)g * W + t;
  int x = xin[i0];
  int s = s_in[g];
  int pred = 0;
  if (PAT == COND)
    for (int i = 0; i < G; ++i) pred |= s_in[i] > 0;
  const int left = (t - 1) & (W - 1);
  const int nbf = reps / 7 > 1 ? reps / 7 : 1;
#pragma unroll 1
  for (int it = 0; it < n; ++it) {
    if (PAT == BUTTERFLY) {
      // log2(W) masked rolls: out[j] = max(out[j], out[j + sft]) where
      // j + sft < W (the revcummax pattern)
      for (int r = 0; r < nbf; ++r) {
        int o = x;
#pragma unroll
        for (int sft = 1; sft < W; sft <<= 1) {
          const int sh = exchange(o, (t + sft) & (W - 1), b, bar, t);
          o = max(o, t + sft < W ? sh : NEG_BIG);
        }
        x = o;
      }
    } else {
      for (int r = 0; r < reps; ++r) {
        if (PAT == ELEMWISE) {
          x = max(wadd(x, 1), x ^ 3);
        } else if (PAT == ROLL) {
          x = wadd(exchange(x, left, b, bar, t), 1);
        } else if (PAT == REDUCE_ROW) {
          x = wadd(x, block_reduce<NW>(x, rd, bar, t, OpMax()));
        } else if (PAT == REDUCE_SCAL) {
          s = wadd(s, block_reduce<NW>(x, rd, bar, t, OpMax()));
          x = wadd(x, s);
        } else if (PAT == ONEHOT_GRAB) {
          // x[g, s & (W-1)] as the one-hot sum, wrapping as JAX's does
          s = wadd(s, block_reduce<NW>(t == (s & (W - 1)) ? x : 0, rd, bar, t,
                                       OpWrapSum()));
        } else if (PAT == SCAL_ARITH) {
          s = max(wadd(s, 1), s ^ 3);
        } else {   // COND
          x = vote_any(bar, pred) ? wadd(x, 1) : wadd(x, -1);
        }
      }
    }
    keep(x);
    keep(s);
  }
  xout[i0] = x;
  if (t == 0) sout[g] = s;
}

// the warp policy.  s is the row's scalar, held alike by every lane.  cond:
// each lane ors (s > 0) over rows l, l+32, ... before the loop, and every
// application votes on that with __any_sync, which gives the whole
// (s > 0).any(); keep() makes the predicate opaque at each application so
// that the front end cannot take the vote out of the loop.
template <int W, int PAT>
__global__ void __launch_bounds__((Row<W, WarpBar>::kThreads))
ops_warp_kernel(const int* __restrict__ xin, const int* __restrict__ s_in,
                int* __restrict__ xout, int* __restrict__ sout, int G, int n,
                int reps) {
  using R = Row<W, WarpBar>;
  constexpr int V = W / 32;
  const int g = R::g(), l = R::t();
  if (g >= G) return;
  const long long i0 = (long long)g * W + l * V;
  int x[V];
#pragma unroll
  for (int k = 0; k < V; ++k) x[k] = xin[i0 + k];
  int s = s_in[g];
  int pred = 0;
  if (PAT == COND)
    for (int i = l; i < G; i += 32) pred |= s_in[i] > 0;
  const int nbf = reps / 7 > 1 ? reps / 7 : 1;
#pragma unroll 1
  for (int it = 0; it < n; ++it) {
    if (PAT == BUTTERFLY) {
      for (int r = 0; r < nbf; ++r) warp_butterfly<W>(x, l);
    } else {
      for (int r = 0; r < reps; ++r) {
        if (PAT == ELEMWISE) {
#pragma unroll
          for (int k = 0; k < V; ++k) x[k] = max(wadd(x[k], 1), x[k] ^ 3);
        } else if (PAT == ROLL) {
          warp_roll(x, l);
#pragma unroll
          for (int k = 0; k < V; ++k) x[k] = wadd(x[k], 1);
        } else if (PAT == REDUCE_ROW) {
          const int m = warp_row_max(x);
#pragma unroll
          for (int k = 0; k < V; ++k) x[k] = wadd(x[k], m);
        } else if (PAT == REDUCE_SCAL) {
          s = wadd(s, warp_row_max(x));
#pragma unroll
          for (int k = 0; k < V; ++k) x[k] = wadd(x[k], s);
        } else if (PAT == ONEHOT_GRAB) {
          s = wadd(s, warp_grab(x, (unsigned)s & (W - 1)));
        } else if (PAT == SCAL_ARITH) {
          s = max(wadd(s, 1), s ^ 3);
        } else {   // COND
          keep(pred);
          const int d = __any_sync(FULL, pred) ? 1 : -1;
#pragma unroll
          for (int k = 0; k < V; ++k) x[k] = wadd(x[k], d);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) keep(x[k]);
    keep(s);
  }
#pragma unroll
  for (int k = 0; k < V; ++k) xout[i0 + k] = x[k];
  if (l == 0) sout[g] = s;
}

// ---------------------------------------------------------------------------
// probe_carry: tools/mosaic_carry.py:27.  The Pallas kernel makes its state
// inside the kernel and returns only st[0]; here the state is made from one
// input x0 (G, W), which gives the Pallas state when x0 is 0: carry60 x0+k
// for k < 60; 3d_minor4 (x0, r = 0 (G, W, 4)); concat2w (x0, x0+1);
// dbuf_write (x0, db = 0 (G, 192, 4)); dbuf_soa (x0, four 0 (G, 192)
// planes).  out is st[0], exactly the Pallas output; the rest of the state,
// which the Pallas kernel leaves dead, goes to aux so that nvcc keeps it:
// carry60 the other 59 arrays (59, G, W); 3d_minor4 r; concat2w the second
// array; dbuf_write db; dbuf_soa the planes (4, G, 192).  The dbuf buffers
// live in shared memory, as the Pallas kernel's db lives in VMEM: each
// iteration writes the one row slot `at` (what the masked where computes)
// with the row max.  Bound: issue of the carried adds (carry60: 60
// independent adds per column per iteration, 64 instructions a loop trip;
// a row on four warps issues them on four schedulers, a row on one warp on
// one), else, for the dbuf bodies, the row max: under the block policy its
// two barriers and shared-memory round trip, under the warp policy the
// fold and one redux.sync, with the slot broadcast by one shuffle.
// ---------------------------------------------------------------------------

enum { CARRY60, MINOR4, CONCAT2W, DBUF_WRITE, DBUF_SOA, NBODY };
constexpr int DBUF = 192;

template <int W, class Bar, int BODY>
__global__ void __launch_bounds__((Row<W, Bar>::kThreads))
carry_kernel(const int* __restrict__ x0, int* __restrict__ out,
             int* __restrict__ aux, int G, int n) {
  using R = Row<W, Bar>;
  constexpr int NW = W / 32;
  __shared__ int db[BODY == DBUF_WRITE || BODY == DBUF_SOA ? R::kRows : 1]
                   [BODY == DBUF_WRITE || BODY == DBUF_SOA ? 4 * DBUF : 1];
  __shared__ int red[R::kRows][NW];
  __shared__ int at_s[R::kRows][2];
  const int g = R::g(), t = R::t();
  if (g >= G) return;
  const Bar bar = R::bar();
  const long long gw = (long long)G * W, i0 = (long long)g * W + t;
  int x = x0[i0];
  if constexpr (BODY == CARRY60) {
    int st[60];
#pragma unroll
    for (int k = 0; k < 60; ++k) st[k] = wadd(x, k);
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
#pragma unroll
      for (int k = 0; k < 60; ++k) {
        st[k] = wadd(st[k], 1);
        keep(st[k]);
      }
    }
    out[i0] = st[0];
#pragma unroll
    for (int k = 1; k < 60; ++k) aux[(k - 1) * gw + i0] = st[k];
  } else if constexpr (BODY == MINOR4) {
    int r[4] = {0, 0, 0, 0};
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
      x = wadd(x, 1);
      const bool m = (x & 7) == 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        r[c] = m ? wadd(r[c], 1) : r[c];
        keep(r[c]);
      }
      keep(x);
    }
    out[i0] = x;
#pragma unroll
    for (int c = 0; c < 4; ++c) aux[4 * i0 + c] = r[c];
  } else if constexpr (BODY == CONCAT2W) {
    int bb = wadd(x, 1);
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
      x = wadd(x, 1);
      bb = wadd(bb, 1);
      keep(x);
      keep(bb);
    }
    out[i0] = x;
    aux[i0] = bb;
  } else {   // DBUF_WRITE, DBUF_SOA
    int* const d = db[R::half()];
    int* const rd = red[R::half()];
    int* const at = at_s[R::half()];
    for (int i = t; i < 4 * DBUF; i += W) d[i] = 0;
    bar.sync();
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
      x = wadd(x, 1);
      // column 0's slot, double-buffered by parity: the readers of the
      // previous iteration's slot have passed this iteration's barriers
      // before column 0 writes it again
      if (t == 0) at[it & 1] = x & 127;
      const int m = block_reduce<NW>(x, rd, bar, t, OpMax());
      const int a = at[it & 1];
      if (t < 4) d[BODY == DBUF_WRITE ? 4 * a + t : t * DBUF + a] = m;
      keep(x);
    }
    bar.sync();
    out[i0] = x;
    for (int i = t; i < 4 * DBUF; i += W) {
      if (BODY == DBUF_WRITE)
        aux[(long long)g * 4 * DBUF + i] = d[i];
      else   // plane c = i / DBUF of (4, G, DBUF)
        aux[(long long)(i / DBUF) * G * DBUF + (long long)g * DBUF +
            i % DBUF] = d[i];
    }
  }
}

// the warp policy: lane l carries columns [l*V, l*V + V) of its row, V of
// every carried array a lane.  dbuf: column 0 is lane 0's register 0, so
// one shuffle gives every lane the slot `at`; lanes 0-3 store the row max
// (the fold and one redux.sync) to column `lane` of the slot in the row's
// own slice of shared memory.  Each address is stored by one lane only, and
// nothing reads the slice inside the loop, so the loop holds no barrier and
// no shared-memory load; one __syncwarp() after the zeroing and one after
// the loop order the lanes' stores before the copy-out reads them.
template <int W, int BODY>
__global__ void __launch_bounds__((Row<W, WarpBar>::kThreads))
carry_warp_kernel(const int* __restrict__ x0, int* __restrict__ out,
                  int* __restrict__ aux, int G, int n) {
  using R = Row<W, WarpBar>;
  constexpr int V = W / 32;
  constexpr bool DB = BODY == DBUF_WRITE || BODY == DBUF_SOA;
  __shared__ int db[DB ? R::kRows : 1][DB ? 4 * DBUF : 1];
  const int g = R::g(), l = R::t();
  if (g >= G) return;
  const long long gw = (long long)G * W, i0 = (long long)g * W + l * V;
  int x[V];
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = x0[i0 + j];
  if constexpr (BODY == CARRY60) {
    int st[60][V];
#pragma unroll
    for (int k = 0; k < 60; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) st[k][j] = wadd(x[j], k);
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
#pragma unroll
      for (int k = 0; k < 60; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          st[k][j] = wadd(st[k][j], 1);
          keep(st[k][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) out[i0 + j] = st[0][j];
#pragma unroll
    for (int k = 1; k < 60; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) aux[(k - 1) * gw + i0 + j] = st[k][j];
  } else if constexpr (BODY == MINOR4) {
    int r[V][4] = {};
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        x[j] = wadd(x[j], 1);
        const bool m = (x[j] & 7) == 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          r[j][c] = m ? wadd(r[j][c], 1) : r[j][c];
          keep(r[j][c]);
        }
        keep(x[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[i0 + j] = x[j];
#pragma unroll
      for (int c = 0; c < 4; ++c) aux[4 * (i0 + j) + c] = r[j][c];
    }
  } else if constexpr (BODY == CONCAT2W) {
    int bb[V];
#pragma unroll
    for (int j = 0; j < V; ++j) bb[j] = wadd(x[j], 1);
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        x[j] = wadd(x[j], 1);
        bb[j] = wadd(bb[j], 1);
        keep(x[j]);
        keep(bb[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[i0 + j] = x[j];
      aux[i0 + j] = bb[j];
    }
  } else {   // DBUF_WRITE, DBUF_SOA
    // lane l zeroes and copies out the words l + 32k of the slice, k < 24,
    // unrolled: the iteration loop is the kernel's only loop
    constexpr int K = 4 * DBUF / 32;
    int* const d = db[threadIdx.x >> 5];
#pragma unroll
    for (int k = 0; k < K; ++k) d[l + 32 * k] = 0;
    __syncwarp();
#pragma unroll 1
    for (int it = 0; it < n; ++it) {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = wadd(x[j], 1);
      const int m = warp_row_max(x);
      const int a = __shfl_sync(FULL, x[0], 0) & 127;
      if (l < 4) d[BODY == DBUF_WRITE ? 4 * a + l : l * DBUF + a] = m;
#pragma unroll
      for (int j = 0; j < V; ++j) keep(x[j]);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < V; ++j) out[i0 + j] = x[j];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = l + 32 * k;
      if (BODY == DBUF_WRITE)
        aux[(long long)g * 4 * DBUF + i] = d[i];
      else   // plane c = i / DBUF of (4, G, DBUF)
        aux[(long long)(i / DBUF) * G * DBUF + (long long)g * DBUF +
            i % DBUF] = d[i];
    }
  }
}

// ---------------------------------------------------------------------------
// dispatch: (W, barrier) -> the instantiation; barrier 0 block, 2 warp (1
// was a half-block policy, now retired: the ids stay, so that a build of an
// older probes.cu keeps its policies' ids in tools/probe_ab.py); W=256 only
// where W256.
// ---------------------------------------------------------------------------

template <bool W256, class F>
cudaError_t by_width(int W, F&& f) {
  if (W == 64) return f(Int<64>{});
  if (W == 128) return f(Int<128>{});
  if constexpr (W256) {
    if (W == 256) return f(Int<256>{});
  }
  return cudaErrorInvalidValue;
}

template <bool W256, class F>
cudaError_t by_shape(int W, int barrier, F&& f) {
  if (barrier == 2)
    return by_width<W256>(W, [&](auto w) { return f(w, WarpBar{}); });
  if (barrier != 0) return cudaErrorInvalidValue;
  return by_width<W256>(W, [&](auto w) { return f(w, BlockBar{}); });
}

template <int W, class Bar>
dim3 grid(int G) {
  return dim3((G + Row<W, Bar>::kRows - 1) / Row<W, Bar>::kRows);
}

template <int W, class Bar, int P>
void ops_one(const int* x, const int* s, int* xo, int* so, int G, int n,
             int reps, cudaStream_t st) {
  if constexpr (std::is_same<Bar, WarpBar>::value)
    ops_warp_kernel<W, P><<<grid<W, Bar>(G), Row<W, Bar>::kThreads, 0, st>>>(
        x, s, xo, so, G, n, reps);
  else
    ops_kernel<W, Bar, P><<<grid<W, Bar>(G), Row<W, Bar>::kThreads, 0, st>>>(
        x, s, xo, so, G, n, reps);
}

template <int W, class Bar, bool ADD>
void floor_one(const int* x, int* out, int G, int n, int nquads,
               cudaStream_t st) {
  if constexpr (std::is_same<Bar, WarpBar>::value)
    floor_warp_kernel<W, ADD>
        <<<grid<W, Bar>(G), Row<W, Bar>::kThreads, 0, st>>>(x, out, G, n,
                                                             nquads);
  else
    floor_kernel<W, Bar, ADD>
        <<<grid<W, Bar>(G), Row<W, Bar>::kThreads, 0, st>>>(x, out, G, n,
                                                             nquads);
}

template <int W, class Bar, int P>
void carry_one(const int* x0, int* out, int* aux, int G, int n,
               cudaStream_t st) {
  if constexpr (std::is_same<Bar, WarpBar>::value)
    carry_warp_kernel<W, P>
        <<<grid<W, Bar>(G), Row<W, Bar>::kThreads, 0, st>>>(x0, out, aux, G,
                                                             n);
  else
    carry_kernel<W, Bar, P>
        <<<grid<W, Bar>(G), Row<W, Bar>::kThreads, 0, st>>>(x0, out, aux, G,
                                                             n);
}

}  // namespace

extern "C" int probe_floor_launch(const int* x, int* out, int G, int W,
                                  int barrier, int add, int n, int nquads,
                                  void* stream) {
  if (G <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_shape<true>(W, barrier, [&](auto w, auto b) {
    constexpr int Wc = decltype(w)::value;
    using Bar = decltype(b);
    if (add)
      floor_one<Wc, Bar, true>(x, out, G, n, nquads, st);
    else
      floor_one<Wc, Bar, false>(x, out, G, n, nquads, st);
    return cudaGetLastError();
  });
}

extern "C" int probe_ops_launch(const int* x, const int* s, int* xout,
                                int* sout, int G, int W, int barrier,
                                int pattern, int n, int reps, void* stream) {
  if (G <= 0) return 0;
  if (pattern < 0 || pattern >= NPAT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_shape<false>(W, barrier, [&](auto w, auto b) {
    constexpr int Wc = decltype(w)::value;
    using Bar = decltype(b);
    switch (pattern) {
#define OPS_CASE(P_)                                          \
  case P_:                                                    \
    ops_one<Wc, Bar, P_>(x, s, xout, sout, G, n, reps, st);   \
    break
      OPS_CASE(ELEMWISE); OPS_CASE(ROLL); OPS_CASE(REDUCE_ROW);
      OPS_CASE(REDUCE_SCAL); OPS_CASE(ONEHOT_GRAB); OPS_CASE(SCAL_ARITH);
      OPS_CASE(COND); OPS_CASE(BUTTERFLY);
#undef OPS_CASE
    }
    return cudaGetLastError();
  });
}

extern "C" int probe_carry_launch(const int* x0, int* out, int* aux, int G,
                                  int W, int barrier, int body, int n,
                                  void* stream) {
  if (G <= 0) return 0;
  if (body < 0 || body >= NBODY) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_shape<false>(W, barrier, [&](auto w, auto b) {
    constexpr int Wc = decltype(w)::value;
    using Bar = decltype(b);
    switch (body) {
#define CARRY_CASE(B_)                                  \
  case B_:                                              \
    carry_one<Wc, Bar, B_>(x0, out, aux, G, n, st);     \
    break
      CARRY_CASE(CARRY60); CARRY_CASE(MINOR4); CARRY_CASE(CONCAT2W);
      CARRY_CASE(DBUF_WRITE); CARRY_CASE(DBUF_SOA);
#undef CARRY_CASE
    }
    return cudaGetLastError();
  });
}

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
