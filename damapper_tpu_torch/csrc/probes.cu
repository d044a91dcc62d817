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
// Layout: one row g per W threads, thread t owns column t, as the wave
// kernels own one lane per W threads.  Every cross-thread step goes through
// a barrier policy (below): BlockBar (one block of W threads per row,
// __syncthreads, as the wave kernels run) or HalfBar (W=64 only: rows 2b
// and 2b+1 in the two halves of a 128-thread block, each half on its own
// named barrier, as the lane-packed wave kernels once ran).  Votes
// (vote_any) and row reductions (block_reduce: a warp butterfly, then the
// warps' values through shared memory between two barriers) are the steps
// of the wave body before its barrier rounds (Rounds, redux.sync); a roll
// is a store to shared memory, a barrier, a neighbour read and a barrier.
// So each probe times a step of that body, under the policy it executed it
// with.
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
// the SASS of every loop body for the pattern's instructions.
//
// What bounds them on this card: none is bound by bytes (each reads and
// writes its (G, W) arrays once) or by the integer rate (at most a few
// hundred operations per thread per iteration on 132 SMs).  They are bound
// by the latency of dependent chains: elementwise chains by the ALU
// latency of one thread, the rolls, votes and reductions by barrier and
// shared-memory round trips.  At G=128 a launch fills one block per SM, so
// no other block hides that latency, as in a wave launch of 128 lanes.

#include <cstdint>
#include <cuda_runtime.h>

#include "wave_body.cuh"

namespace {

using namespace wavebody;

// the barrier policies: the whole block, or the named barrier of the 64
// threads of one half of a 128-thread block
struct BlockBar {
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

struct HalfBar {
  int id;   // named barrier 1 or 2 (barrier 0 is __syncthreads')

  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
  }
};

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

// the policy's vote over the row's threads
__device__ __forceinline__ int vote_any(const BlockBar&, int p) {
  return __syncthreads_or(p);
}
__device__ __forceinline__ int vote_any(const HalfBar& bar, int p) {
  int r;
  asm volatile(
      "{\n\t.reg .pred ip, op;\n\t"
      "setp.ne.s32 ip, %1, 0;\n\t"
      "bar.red.or.pred op, %2, 64, ip;\n\t"
      "selp.s32 %0, 1, 0, op;\n\t}"
      : "=r"(r)
      : "r"(p), "r"(bar.id)
      : "memory");
  return r;
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

template <>
struct Row<64, HalfBar> {
  static constexpr int kThreads = 128, kRows = 2;
  __device__ static int half() { return threadIdx.x >> 6; }
  __device__ static int g() { return 2 * blockIdx.x + half(); }
  __device__ static int t() { return threadIdx.x & 63; }
  __device__ static HalfBar bar() { return HalfBar{1 + half()}; }
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

// ---------------------------------------------------------------------------
// probe_floor: tools/mosaic_floor.py:32.  Carried state: x, all of it in the
// output.  Bound: latency; "mix" one exchange per quad, "add" a chain of
// four dependent ALU operations per quad.
// ---------------------------------------------------------------------------

template <int W, class Bar, bool ADD>
__global__ void __launch_bounds__((Row<W, Bar>::kThreads))
floor_kernel(const int* __restrict__ xin, int* __restrict__ out, int G,
             int n, int nquads) {
  using R = Row<W, Bar>;
  __shared__ int buf[R::kRows][W];
  const int g = R::g(), t = R::t();
  if (g >= G) return;   // HalfBar, odd G: the last half idles
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

// ---------------------------------------------------------------------------
// probe_ops: tools/mosaic_ops.py:102.  Carried state: x and s, both in the
// outputs (scal_arith changes only s; x passes through).  cond: s is an
// input and never changes, so each block reduces (s > 0).any() over all G
// rows once before its loop; every application then votes on it with the
// policy's vote_any() (__syncthreads_or / bar.red.or) and takes the
// branch.  Bound: latency of the pattern's chain (see top).
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
// live in shared memory: each iteration writes the one row slot `at` (what
// the masked where computes) with the row max from block_reduce.  Bound:
// issue of the carried adds (carry60: 60 independent adds per thread per
// iteration), else the row max's two barriers.
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

// ---------------------------------------------------------------------------
// dispatch: (W, barrier) -> the instantiation; barrier 0 block, 1 half
// (W=64 only); W=256 only where W256
// ---------------------------------------------------------------------------

template <bool W256, class F>
cudaError_t by_shape(int W, int barrier, F&& f) {
  if (barrier == 1)
    return W == 64 ? f(Int<64>{}, HalfBar{0}) : cudaErrorInvalidValue;
  if (barrier != 0) return cudaErrorInvalidValue;
  if (W == 64) return f(Int<64>{}, BlockBar{});
  if (W == 128) return f(Int<128>{}, BlockBar{});
  if constexpr (W256) {
    if (W == 256) return f(Int<256>{}, BlockBar{});
  }
  return cudaErrorInvalidValue;
}

template <int W, class Bar>
dim3 grid(int G) {
  return dim3((G + Row<W, Bar>::kRows - 1) / Row<W, Bar>::kRows);
}

template <int W, class Bar, int P>
void ops_one(const int* x, const int* s, int* xo, int* so, int G, int n,
             int reps, cudaStream_t st) {
  ops_kernel<W, Bar, P><<<grid<W, Bar>(G), Row<W, Bar>::kThreads, 0, st>>>(
      x, s, xo, so, G, n, reps);
}

template <int W, class Bar, int P>
void carry_one(const int* x0, int* out, int* aux, int G, int n,
               cudaStream_t st) {
  carry_kernel<W, Bar, P><<<grid<W, Bar>(G), Row<W, Bar>::kThreads, 0, st>>>(
      x0, out, aux, G, n);
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
    const dim3 gr = grid<Wc, Bar>(G);
    if (add)
      floor_kernel<Wc, Bar, true><<<gr, Row<Wc, Bar>::kThreads, 0, st>>>(
          x, out, G, n, nquads);
    else
      floor_kernel<Wc, Bar, false><<<gr, Row<Wc, Bar>::kThreads, 0, st>>>(
          x, out, G, n, nquads);
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
