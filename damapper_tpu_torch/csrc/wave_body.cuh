// The device-side body of one wave lane, shared by the classic kernels
// (wave.cu) and the persistent window kernels (wave_persistent.cu), which
// replace the TPU wave kernels of damapper_tpu/ops/wave_pallas.py (the
// segment kernels at :1524, :1457 and :1413, the persistent kernels at
// :2104, :2031 and :1981).
//
// wave_lane() runs one direction of Local_Alignment's adaptive wave for one
// lane, from the wave-0 prologue (seed snake, first pebbles, first boundary
// clip) to the lane's end, over the W threads of a block (thread t owns
// ring slot t; see the note at the top of wave.cu), which meet at
// __syncthreads.  Every wave kernel runs one lane a block, the TPU's
// lane-packed layouts included: two W=64 lanes in a 128-thread block on
// named half-block barriers, and one W=64 lane on one warp (two slots a
// thread, no barrier), both lost to it on the H100 (PERF.md §6; probes.cu
// keeps the half-block barrier to price it).  It is templated on one
// policy:
//
//   Seq  — sequence access: achar(i, miss) / bchar(i, miss) give the byte at
//          global index i of the A / B sequence memory; awalk<REV>(i) /
//          bwalk<REV>(i) a WordWalk (or a walk with its contract) from i
//          that gives 8 consecutive bases a step in the walk's direction;
//          amiss(i) / bmiss(i) whether i lies outside the lane's window;
//          advance(d, fa, fb), called by every thread after round B of wave
//          d with the A and B index of the band's best point, lets a policy
//          move what it caches.  ClassicSeq reads global memory, gives the sentinel 4
//          outside [0, len) and caches nothing.  wave_persistent.cu's
//          RingSeq reads the lane's window [wst, wst + L) through a ring
//          of shared-memory chunks; bytes of the window past the end of the
//          sequence memory read 4, and an index outside the window reads 4
//          and is a miss.  A windowed lane that needs such a byte is
//          flagged as overflowed and stops at the end of that wave; a byte
//          is needed when the snake stops on it (the B byte, and the A byte
//          when the B byte is a base) or when the REACH rest test reads it.
//
// With ClassicSeq the window tests and the hook compile away.  The
// lane-input layouts (SplitIO, PackedIO) at the end serve both files'
// kernels.
//
// A wave is bound by its latency: the band's longest snake, then the
// barriers its slots meet at.  So the snake compares 8 bases per pair of
// loads (WordWalk: one aligned 8-byte word of A and one of B a step;
// stop_bytes() flags the bytes where a != b or b == 4, and the walk stops
// at the first in walk order; only the stop's index is tested for a window
// miss), and a wave on the common path (no clip, no drop trip) meets at
// three barriers:
//   round 0 (:524): the band into shared memory for pick3;
//   round A (:679): after the snake, the clip and window votes, the
//     first drop test with the ranks of its trip, the trigger scan's warp
//     totals (the scan runs in slot order, segmented at the ring's wrap)
//     and each warp's best (c, rel), which give bandc and kstar;
//   round B (:817): lastc and the band prune's hi_rel and lo_rel
//     (one packed key under a per-halfword max).  Warp-wide maxima,
//     minima and sums are one redux.sync each.
// A drop trip adds one round (:753: the next trip's test and ranks), a
// clipped wave its ten clip reductions (one round each, Rounds::reduce)
// and a re-prune of the post-clip band (:876).  The rounds alternate
// two record buffers, so no barrier only guards a buffer's reuse.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wavebody {

constexpr int NEG_BIG = -(1 << 30);
constexpr int I32MAX = 0x7FFFFFFF;
constexpr int PATH_LEN = 60;
constexpr int TRIM_LEN = 15;
constexpr int TRIM_MLAG = 250;
constexpr int WAVE_LAG = 30;
constexpr int TRIM_RB = 10;
constexpr int DRANK = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t MASK61 = (1ull << 61) - 1;
constexpr int NOUT = 14;   // output fields, in wave_cuda.OUT_FIELDS order

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// ---------------------------------------------------------------------------
// sequence-access policies
// ---------------------------------------------------------------------------

// A walk over one sequence, 8 bases a step: bases() gives the step's bytes
// [p, p + 8) (REV: [p - 7, p]) in memory order, byte j at bits 8j, where p
// is the start index advanced by 8 a step (REV: moved back by 8); next()
// moves on.  Indices are relative to `base`; those outside [0, len) read 4.
// It holds the two 8-byte-aligned words that cover the step and joins them
// with a funnel shift, so each step loads one new word, and only when the
// walk goes on: a word loaded ahead and left pending at the walk's end
// stalls the next instruction that reuses its register (loading ahead
// made launches 2-8% slower on the H100).  A word is loaded
// whole only when it lies inside [0, len): a word that crosses an end (or
// lies outside) is read byte by byte, so no read leaves the allocation and
// the sequence memory needs no slack.  base is in global memory (__ldg).
template <bool REV>
struct WordWalk {
  const uint8_t* base;
  long long len;
  long long q;        // base + q is 8-byte aligned; w0 holds [q, q + 8)
  int s8;             // bit offset of the step's lowest byte in w0
  uint64_t w0, w1;    // the words at q and q + 8

  __device__ __forceinline__ uint64_t load(long long i) const {
    if (i >= 0 && i <= len - 8)
      return (uint64_t)__ldg(
          reinterpret_cast<const unsigned long long*>(base + i));
    uint64_t w = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long r = i + j;
      const uint64_t b =
          (unsigned long long)r < (unsigned long long)len
              ? (uint64_t)__ldg(base + r)
              : 4;
      w |= b << (8 * j);
    }
    return w;
  }
  __device__ __forceinline__ void start(long long p) {
    const long long lo = REV ? p - 7 : p;
    const int r = (int)((reinterpret_cast<uintptr_t>(base) +
                         (uintptr_t)lo) & 7);
    q = lo - r;
    s8 = 8 * r;
    w0 = load(q);
    w1 = load(q + 8);
  }
  // (w1 << 1) << (63 - s8) is w1 << (64 - s8), and 0 when s8 == 0
  __device__ __forceinline__ uint64_t bases() const {
    return (w0 >> s8) | ((w1 << 1) << (63 - s8));
  }
  __device__ __forceinline__ void next() {
    if (REV) {
      q -= 8;
      w1 = w0;
      w0 = load(q);
    } else {
      q += 8;
      w0 = w1;
      w1 = load(q + 8);
    }
  }
};

// 0x80 in each byte where a step stops: a != b, or b is the sentinel 4.
// Both tests are exact per byte (no carry crosses a byte), so the highest
// flagged byte is as trustworthy as the lowest.
__device__ __forceinline__ uint64_t stop_bytes(uint64_t a, uint64_t b) {
  constexpr uint64_t L7 = 0x7F7F7F7F7F7F7F7Full;
  constexpr uint64_t H = 0x8080808080808080ull;
  const uint64_t d = a ^ b, e = b ^ 0x0404040404040404ull;
  const uint64_t dne = ((d & L7) + L7) | d;   // high bit: byte of d != 0
  const uint64_t ene = ((e & L7) + L7) | e;   // high bit: byte of e != 0
  return (dne | ~ene) & H;
}

struct ClassicSeq {
  static constexpr bool kWindowed = false;
  const uint8_t* A;
  long long LA;
  const uint8_t* B;
  long long LB;

  // one unsigned compare tests 0 <= i < len
  __device__ __forceinline__ int achar(long long i, int&) const {
    return (unsigned long long)i < (unsigned long long)LA ? (int)__ldg(A + i)
                                                          : 4;
  }
  __device__ __forceinline__ int bchar(long long i, int&) const {
    return (unsigned long long)i < (unsigned long long)LB ? (int)__ldg(B + i)
                                                          : 4;
  }
  template <bool REV>
  __device__ __forceinline__ WordWalk<REV> awalk(long long i) const {
    WordWalk<REV> w{A, LA};
    w.start(i);
    return w;
  }
  template <bool REV>
  __device__ __forceinline__ WordWalk<REV> bwalk(long long i) const {
    WordWalk<REV> w{B, LB};
    w.start(i);
    return w;
  }
  __device__ __forceinline__ bool amiss(long long) const { return false; }
  __device__ __forceinline__ bool bmiss(long long) const { return false; }
  __device__ __forceinline__ void advance(int, long long, long long) const {}
};

// ---------------------------------------------------------------------------
// the lane
// ---------------------------------------------------------------------------

template <int W>
struct LaneShared {
  static constexpr int NW = W / 32;
  int sV[W], sNA[W], sNB[W], sM[W], sHA[W], sHB[W], sMA[W], sMB[W];
  uint64_t sT[W];
  int4 rec[2][2 * NW];   // Rounds: two buffers of one 8-int record per warp
  int pro[12];
};

struct LaneIn {
  long long abase, bbase;
  int mida, k0, aoffp, boffp;
};

struct Consts {
  int P, TS, pave, msc, dsc, max_waves;
};

// warp(v): the op over the warp's 32 values in one redux.sync
struct OpMax {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
  __device__ int warp(int v) const { return __reduce_max_sync(FULL, v); }
};
struct OpMin {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
  __device__ int warp(int v) const { return __reduce_min_sync(FULL, v); }
};
struct OpSum {
  __device__ int operator()(int a, int b) const { return a + b; }
  __device__ int warp(int v) const { return __reduce_add_sync(FULL, v); }
};

// The lane's barrier rounds: in meet() lane 0 of each warp posts the warp's
// record (two int4), the threads meet at one barrier, and every thread reads
// all NW records.  Rounds alternate between two buffers: round i + 2 writes
// round i's buffer only after its writer has passed round i + 1's barrier,
// which every reader of round i reaches after reading it, so no barrier
// exists only to guard a buffer's reuse.
template <int NW>
struct Rounds {
  int4 (*rec)[2 * NW];
  int wl, wi;
  int par;

  __device__ __forceinline__ const int4* meet(int4 r0, int4 r1) {
    int4* b = rec[par];
    par ^= 1;
    if (wl == 0) {
      b[2 * wi] = r0;
      b[2 * wi + 1] = r1;
    }
    __syncthreads();
    return b;
  }
  // a lane-wide op-reduction of v in one round
  template <class Op>
  __device__ __forceinline__ int reduce(int v, Op op) {
    v = op.warp(v);
    int4* b = rec[par];
    par ^= 1;
    if (wl == 0) b[2 * wi].x = v;
    __syncthreads();
    int r = b[0].x;
#pragma unroll
    for (int i = 1; i < NW; ++i) r = op(r, b[2 * i].x);
    return r;
  }
};

// ---------------------------------------------------------------------------
// section clocks, built only with -DWAVE_SECTION_CLOCKS (tools/wave_clocks.py)
// ---------------------------------------------------------------------------
// Every slot reads clock64() at the end of each section of the lane and adds
// the cycles since its last read to that section's counter; at the lane's end
// slot 0 adds its counters to the lane's row of wave_section_clocks.  Slot 0
// meets the lane's other slots at every barrier, so a section that ends in a
// barrier counts the lane's time: slot 0's own work and its wait for the
// slowest slot.  The clocked build meets once more after the snake, so that
// the snake section holds the band's longest snake and round A its own
// work.  Without the macro the counters, reads and that barrier are not
// compiled.

#ifdef WAVE_SECTION_CLOCKS
enum {
  SEC_PROLOGUE,   // wave 0: seed snake, first pebbles, first clip
  SEC_STORE,      // wave start: border init, band store, round 0
  SEC_PICK,       // pick3 from the ring neighbours (slot 0's own work)
  SEC_SNAKE,      // word-wide snake, history update, the band's longest
  SEC_ROUND_A,    // warp scan, reductions, ballots and votes; round A
  SEC_DROPS,      // pebble-drop trips (when taken), one round each
  SEC_TRIGGER,    // triggers, best, trim tables, lazy trim, band store
  SEC_ROUND_B,    // lastc and the packed prune key; round B
  SEC_CLIP,       // boundary clip, REACH grab, re-prune (when clipped)
  SEC_TAIL,       // prune, next-wave test, the REACH rest read (clipped)
  NSEC
};
constexpr int CLK_LANES = 4096;   // lanes of a launch that are counted
__device__ long long wave_section_clocks[CLK_LANES][NSEC];

#define WCLK_BEGIN                 \
  long long clk_[NSEC] = {};       \
  long long clk_last_ = clock64()
#define WCLK(sec)                  \
  do {                             \
    const long long c_ = clock64(); \
    clk_[sec] += c_ - clk_last_;   \
    clk_last_ = c_;                \
  } while (0)
// the lane's row: a block of W threads holds one lane
#define WCLK_END                                                       \
  do {                                                                 \
    const int row_ = blockIdx.x * (blockDim.x / W) + threadIdx.x / W; \
    if (t == 0 && row_ < CLK_LANES)                                    \
      clk_store(wave_section_clocks[row_], clk_);                      \
  } while (0)

// unrolled, so that the counters stay in registers
__device__ __forceinline__ void clk_store(long long* row,
                                          const long long (&c)[NSEC]) {
#pragma unroll
  for (int s = 0; s < NSEC; ++s) row[s] += c[s];
}
#else
#define WCLK_BEGIN
#define WCLK(sec)
#define WCLK_END
#endif

// suffix-positivity of a TRIM_LEN-column window (bit TRIM_LEN-1 oldest)
__device__ __forceinline__ void trim_table(int x, int msc, int dsc, int& t,
                                           int& s) {
  int cum = 0, maxp = 0;
#pragma unroll
  for (int ii = TRIM_LEN - 1; ii >= 0; --ii) {
    cum += ((x >> ii) & 1) ? msc : -dsc;
    maxp = cum > maxp ? cum : maxp;
  }
  t = cum - maxp;
  s = cum;
}

// One lane, prologue to end.  t: the thread's slot (0..W-1) among the W
// threads of the block.  lpool: the lane's P pool rows.  On return every
// thread holds the lane's NOUT results in vals.
template <int W, bool REV, class Seq>
__device__ __forceinline__ void wave_lane(const LaneIn in, const Seq& seq,
                                          LaneShared<W>& sh, const int t,
                                          const Consts cs,
                                          int4* __restrict__ lpool,
                                          int (&vals)[NOUT]) {
  constexpr int Wm = W - 1;
  constexpr int NW = W / 32;
  constexpr int sgn = REV ? -1 : 1;
  constexpr int soff = REV ? -1 : 0;
  constexpr int fill = REV ? I32MAX : NEG_BIG;

  WCLK_BEGIN;
  const int wl = t & 31, wi = t >> 5;
  const long long abase = in.abase, bbase = in.bbase;
  const int mida = in.mida, k0 = in.k0;
  const int aoffp = in.aoffp, boffp = in.boffp;
  const int P = cs.P, TS = cs.TS;
  int* const pro = sh.pro;
  Rounds<NW> rd{sh.rec, wl, wi, 0};

  // ---------------- wave 0: prologue (make_prologue) ----------------
  const int y0 = floordiv(mida - k0, 2);
  int na0, nb0, amark0, bmark0;
  if (!REV) {
    na0 = (floordiv(y0 + k0 + (TS - aoffp), TS) - 1) * TS + aoffp;
    nb0 = (floordiv(y0 + (TS - boffp), TS) - 1) * TS + boffp;
    amark0 = na0;
    bmark0 = nb0;
    na0 += TS;
    nb0 += TS;
  } else {
    na0 = (floordiv(y0 + k0 + (TS - aoffp) - 1, TS) - 1) * TS + aoffp;
    nb0 = (floordiv(y0 + (TS - boffp) - 1, TS) - 1) * TS + boffp;
    amark0 = y0 + k0;
    bmark0 = y0;
  }

  // seed snake, 32 columns per step over warp 0
  if (wi == 0) {
    long long pb = bbase + y0 + soff, pa = abase + (long long)y0 + k0 + soff;
    int run = 0, ca = 0, cb = 0, miss = 0;
    while (true) {
      long long j = (long long)sgn * (run + wl);
      int mb = 0, ma = 0;
      int b = seq.bchar(pb + j, mb), a = seq.achar(pa + j, ma);
      bool stop = (b == 4) || (a != b);
      unsigned m = __ballot_sync(FULL, stop);
      if (m) {
        int f = __ffs(m) - 1;
        int bf = __shfl_sync(FULL, b, f), af = __shfl_sync(FULL, a, f);
        if (Seq::kWindowed)
          miss = __shfl_sync(FULL, mb | ((b != 4) & ma), f);
        run += f;
        cb = bf == 4;
        ca = !cb && af == 4;
        break;
      }
      run += 32;
    }
    if (wl == 0) {
      pro[0] = y0 + sgn * run;
      pro[1] = ca;
      pro[2] = cb;
      pro[10] = miss;
    }
  }
  __syncthreads();
  const int y0f = pro[0];
  const bool clipA0 = pro[1], clipB0 = pro[2];
  int pmiss = Seq::kWindowed ? pro[10] : 0;
  const int c0 = 2 * y0f + k0;

  // initial pebbles: the A trace line first, then the B line
  if (t == 0) {
    lpool[0] = make_int4(-1, k0, 0, amark0);
    lpool[1] = make_int4(-1, k0, 0, bmark0);
    int av = 2;
    int x = y0f + k0, nn = na0, h = 0, mk = amark0;
    while (REV ? x <= nn : x >= nn) {
      if (av < P) lpool[av] = make_int4(h, k0, 0, nn);
      mk = nn;
      if (av < P) h = av;
      nn += REV ? -TS : TS;
      ++av;
    }
    pro[3] = nn; pro[4] = h; pro[5] = mk;
    x = y0f;
    nn = nb0;
    h = 1;
    mk = bmark0;
    while (REV ? x <= nn : x >= nn) {
      if (av < P) lpool[av] = make_int4(h, k0, 0, nn);
      mk = nn;
      if (av < P) h = av;
      nn += REV ? -TS : TS;
      ++av;
    }
    pro[6] = nn; pro[7] = h; pro[8] = mk; pro[9] = av;
  }
  __syncthreads();
  na0 = pro[3];
  const int ha0 = pro[4], amk0 = pro[5];
  nb0 = pro[6];
  const int hb0 = pro[7], bmk0 = pro[8];
  int avail = pro[9];

  const bool better0 = REV ? (c0 < mida) : (c0 > mida);
  int besta = better0 ? c0 : mida;
  int besty = better0 ? y0f : y0;
  int lasta = besta;
  const int trima0 = besta, trimy0 = besty;
  const int trimha0 = better0 ? ha0 : 0, trimhb0 = better0 ? hb0 : 1;

  const int s0 = k0 & Wm;
  int V = (t == s0) ? c0 : fill;
  uint64_t T = (1ull << 60) - 1;
  int M = PATH_LEN;
  int NA = (t == s0) ? na0 : 0, NB = (t == s0) ? nb0 : 0;
  int HA = (t == s0) ? ha0 : 0, HB = (t == s0) ? hb0 : 0;
  int MA = (t == s0) ? amk0 : 0, MB = (t == s0) ? bmk0 : 0;
  int ltk = 0, ltc = 0, lty = 0, ltha = 0, lthb = 0;

  int low = k0, hgh = k0;
  int morem = -1, morea = 0, morey = 0, mored = 0, moreha = 0, morehb = 0;
  int more = !(clipA0 || clipB0);
  // wave-0 clip: a hit boundary is the seed diagonal itself
  if (!more) {
    int mb = 0, ma = 0;
    const int rb = seq.bchar(bbase + besty + soff, mb);
    const int ra = seq.achar(abase + (long long)(besta - besty) + soff, ma);
    if (Seq::kWindowed) pmiss |= mb | ((rb != 4) & ma);
    const bool rest = rb != 4 && ra != 4;
    // the A clip is graded first, then the B clip (both at k0)
    for (int side = 0; side < 2; ++side) {
      const bool hit = side == 0 ? clipA0 : clipB0;
      if (hit && morem <= PATH_LEN) {
        morem = PATH_LEN;
        morea = c0;
        morey = floordiv(c0 - k0, 2);
        moreha = ha0;
        morehb = hb0;
      }
    }
    if (!REV) {
      if (clipA0) hgh = k0 - 1;
      if (clipB0) low = k0 + 1;
    } else {
      if (clipA0) low = k0 + 1;
      if (clipB0) hgh = k0 - 1;
    }
    more = rest;
  }
  int overflow = pmiss;
  int live = more && !overflow;
  int dif = 0;

  WCLK(SEC_PROLOGUE);

  // ---------------- waves 1, 2, ... ----------------
  while (live) {
    --low;
    ++hgh;
    ++dif;
    if (hgh - low + 4 >= W || avail + W >= P) overflow = 1;
    const int rel = floormod(t - low, W);
    const int k = low + rel;
    const bool inb = k <= hgh;
    const int sl = low & Wm, sh_ = hgh & Wm;

    // wave start: border init and pick3 inheritance from ring neighbours
    if (t == sl || t == sh_) V = fill;
    sh.sV[t] = V; sh.sNA[t] = NA; sh.sNB[t] = NB; sh.sM[t] = M;
    sh.sT[t] = T; sh.sHA[t] = HA; sh.sHB[t] = HB; sh.sMA[t] = MA;
    sh.sMB[t] = MB;
    __syncthreads();
    WCLK(SEC_STORE);
    const int tp = (t + 1) & Wm, tm = (t - 1) & Wm;
    if (t == sl) {
      NA = sh.sNA[tp];
      NB = sh.sNB[tp];
    } else if (t == sh_) {
      NA = sh.sNA[tm];
      NB = sh.sNB[tm];
    }
    int y = 0, sm = 0, wha = 0, whb = 0, wma = 0, wmb = 0;
    uint64_t sTv = 0;
    if (inb) {
      const int span = hgh - low;
      const int ap = floormod(tp - low, W) <= span ? sh.sV[tp] : fill;
      const int am = floormod(tm - low, W) <= span ? sh.sV[tm] : fill;
      const int ac = V;
      bool pickP, pickM;
      int cst;
      if (!REV) {
        const bool lt = ac < am;
        pickP = (lt && am < ap) || (!lt && ac < ap);
        pickM = lt && !pickP;
        cst = pickP ? ap + 1 : (pickM ? am + 1 : ac + 2);
      } else {
        const bool gt = ac > ap;
        pickM = (gt && ap > am) || (!gt && ac > am);
        pickP = gt && !pickM;
        cst = pickM ? am - 1 : (pickP ? ap - 1 : ac - 2);
      }
      const int src = pickP ? tp : (pickM ? tm : t);
      sm = sh.sM[src];
      sTv = sh.sT[src];
      wha = sh.sHA[src];
      whb = sh.sHB[src];
      wma = sh.sMA[src];
      wmb = sh.sMB[src];
      sm -= (int)((sTv >> 60) & 1);
      sTv = (sTv << 1) & MASK61;
      // int32 wrap-around as in the JAX driver (only reachable from an
      // emptied band whose border slots hold the fill value)
      y = floordiv((int)((unsigned)cst - (unsigned)k), 2);
    }

    WCLK(SEC_PICK);

    // snake: walk the diagonal to the first mismatch or sentinel, 8 bases a
    // step (one aligned word of A and one of B); the step's stop is its
    // first flagged byte in walk order, the lowest forward, the highest in
    // reverse
    bool sa = false, sb = false;
    int smiss = 0;
    if (inb) {
      const long long pb = bbase + y + soff;
      const long long pa = abase + (long long)y + k + soff;
      auto wa = seq.template awalk<REV>(pa);
      auto wb = seq.template bwalk<REV>(pb);
      int run = 0;
      while (true) {
        const uint64_t xa = wa.bases(), xb = wb.bases();
        const uint64_t stop = stop_bytes(xa, xb);
        if (stop) {
          const int j = REV ? (63 - __clzll((long long)stop)) >> 3
                            : (__ffsll((long long)stop) - 1) >> 3;
          run += REV ? 7 - j : j;
          const int b = (int)((xb >> (8 * j)) & 0xFF);
          const int a = (int)((xa >> (8 * j)) & 0xFF);
          if (b == 4) {
            sb = true;
            smiss = seq.bmiss(pb + (long long)sgn * run);
          } else {
            sa = a == 4;
            smiss = seq.amiss(pa + (long long)sgn * run);
          }
          break;
        }
        run += 8;
        wa.next();
        wb.next();
      }
      int pops;
      if (run >= 61) {
        pops = __popcll(sTv) + (run - 61);
        sTv = MASK61;
      } else {
        pops = __popcll(sTv >> (61 - run));
        sTv = ((sTv << run) | ((1ull << run) - 1)) & MASK61;
      }
      sm += run - pops;
      y += sgn * run;
    }
#ifdef WAVE_SECTION_CLOCKS
    __syncthreads();   // so that the section holds the band's longest snake
#endif
    WCLK(SEC_SNAKE);

    // Round A.  Everything the wave end needs that is ready after the
    // snake: the clip and window votes, the first drop test with its ranks,
    // the trigger scan's warp totals and each warp's best (c, rel).
    //
    // The trigger scan is the exclusive suffix max (reverse: prefix min) of
    // c over the band in rel order.  In slot order the rel order is two
    // segments, slots [sl, W) (segment A, rel t - sl) then [0, sl)
    // (segment B), so each warp scans its slots segmented at sl, and a
    // slot adds the totals of the warps after it (reverse: before it) in
    // its segment, and forward in segment A all of segment B (reverse in
    // segment B all of segment A).  Slots outside the band hold the fill,
    // which is neutral.
    //
    // bandc and kstar: forward, of the slots with c == bandc only the one
    // with the largest rel can trigger (every other has excl >= c), and it
    // does exactly when bandc > besta; reverse, the smallest rel.  So each
    // warp posts its max (reverse: min) c and the largest (smallest) rel
    // that holds it, and kstar = low + that rel when any0.
    const int c = (int)(2u * (unsigned)y + (unsigned)k);
    const bool cA = inb && sa, cB = inb && sb;
    const long long Xa = (long long)y + k;
    const int Xb = y;
    bool dA = inb && (REV ? Xa <= NA : Xa >= NA);
    bool dB = inb && (REV ? Xb <= NB : Xb >= NB);
    bool nA = dA && (REV ? wma > NA : wma < NA);
    bool nB = dB && (REV ? wmb > NB : wmb < NB);
    unsigned bA = __ballot_sync(FULL, nA), bB = __ballot_sync(FULL, nB);
    const int cm = inb ? c : fill;
    const bool segA = t >= sl;
    // op: max forward, min in reverse
    auto op = [](int a, int b) { return REV ? min(a, b) : max(a, b); };
    int ex;
    {
      int v = cm;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        if (!REV) {
          const int u = __shfl_down_sync(FULL, v, o);
          if (wl + o < 32 && (segA || t + o < sl)) v = op(u, v);
        } else {
          const int u = __shfl_up_sync(FULL, v, o);
          if (wl >= o && (!segA || t - o >= sl)) v = op(u, v);
        }
      }
      ex = REV ? __shfl_up_sync(FULL, v, 1) : __shfl_down_sync(FULL, v, 1);
      if (REV ? (wl == 0 || t == sl) : (wl == 31 || t + 1 == sl)) ex = fill;
    }
    // the warp's max (reverse: min) of c over segment A, segment B, both,
    // and the largest (smallest) rel that holds the last
    const int wA = REV ? __reduce_min_sync(FULL, segA ? cm : fill)
                       : __reduce_max_sync(FULL, segA ? cm : fill);
    const int wB = REV ? __reduce_min_sync(FULL, segA ? fill : cm)
                       : __reduce_max_sync(FULL, segA ? fill : cm);
    const int cw = op(wA, wB);
    const int rw = REV ? __reduce_min_sync(FULL, cm == cw ? rel : W)
                       : __reduce_max_sync(FULL, cm == cw ? rel : -1);
    const int fl = (__any_sync(FULL, cA || cB) ? 1 : 0) |
                   (__any_sync(FULL, smiss) ? 2 : 0) |
                   (__any_sync(FULL, dA || dB) ? 4 : 0);
    const int4* ra = rd.meet(make_int4(wA, wB, cw, rw),
                             make_int4(fl, (int)bA, (int)bB, 0));
    // branch-free: the warps after this one (reverse: before) in each
    // segment, and forward all of segment B (reverse all of segment A)
    int flags = 0, bandc = fill, aftA = fill, aftB = fill, other = fill;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int4 r0 = ra[2 * i];
      flags |= ra[2 * i + 1].x;
      const bool after = REV ? i < wi : i > wi;
      aftA = op(aftA, after ? r0.x : fill);
      aftB = op(aftB, after ? r0.y : fill);
      other = op(other, REV ? r0.x : r0.y);
      bandc = op(bandc, r0.z);
    }
    const int excl = REV ? (segA ? op(ex, aftA) : op(ex, op(aftB, other)))
                         : (segA ? op(ex, op(aftA, other)) : op(ex, aftB));
    int krel = REV ? W : -1;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int4 r0 = ra[2 * i];
      krel = r0.z == bandc ? op(krel, r0.w) : krel;
    }
    WCLK(SEC_ROUND_A);

    const int clip_any = flags & 1;
    if (Seq::kWindowed && (flags & 2)) overflow = 1;
    const int more_new = clip_any ? 0 : more;

    // wave end: pebble drops, DRANK ranks per trip over [A | B] slot order;
    // the first trip's ranks came with round A, each later trip's test and
    // ranks take one round
    if (flags & 4) {
      const unsigned ltmask = (1u << wl) - 1;
      const int4* rb = ra;
      while (true) {
        int preA = 0, preB = 0, totA = 0, totB = 0;
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const int pa = __popc((unsigned)rb[2 * i + 1].y);
          const int pb = __popc((unsigned)rb[2 * i + 1].z);
          if (i < wi) {
            preA += pa;
            preB += pb;
          }
          totA += pa;
          totB += pb;
        }
        const int rA = preA + __popc(bA & ltmask);
        const int rB = totA + preB + __popc(bB & ltmask);
        const bool pA = nA && rA < DRANK, pB = nB && rB < DRANK;
        if (pA) {
          const int pi = avail + rA;
          if (pi < P) lpool[pi] = make_int4(wha, k, dif, NA);
          wha = pi;
          wma = NA;
        }
        if (pB) {
          const int pi = avail + rB;
          if (pi < P) lpool[pi] = make_int4(whb, k, dif, NB);
          whb = pi;
          wmb = NB;
        }
        if (dA && (!nA || pA)) NA += REV ? -TS : TS;
        if (dB && (!nB || pB)) NB += REV ? -TS : TS;
        const int cnt = totA + totB;
        avail += cnt < DRANK ? cnt : DRANK;
        if (avail + W >= P) overflow = 1;
        dA = inb && (REV ? Xa <= NA : Xa >= NA);
        dB = inb && (REV ? Xb <= NB : Xb >= NB);
        nA = dA && (REV ? wma > NA : wma < NA);
        nB = dB && (REV ? wmb > NB : wmb < NB);
        bA = __ballot_sync(FULL, nA);
        bB = __ballot_sync(FULL, nB);
        rb = rd.meet(make_int4(0, 0, 0, 0),
                     make_int4(__any_sync(FULL, dA || dB), (int)bA, (int)bB,
                               0));
        int again = 0;
#pragma unroll
        for (int i = 0; i < NW; ++i) again |= rb[2 * i + 1].x;
        if (!again) break;
      }
    }
    WCLK(SEC_DROPS);

    // best / trim triggers against the best before this wave
    bool trigger;
    if (!REV) {
      const int runbase = besta > excl ? besta : excl;
      trigger = inb && c > runbase;
    } else {
      const int runbase = besta < excl ? besta : excl;
      trigger = inb && c < runbase;
    }
    int t1, s1, t2, s2;
    trim_table((int)(sTv & 0x7FFF), cs.msc, cs.dsc, t1, s1);
    trim_table((int)((sTv >> 15) & 0x7FFF), cs.msc, cs.dsc, t2, s2);
    const bool tbl_ok = t1 >= 0 && t2 + s1 >= 0;
    const bool m_ok = sm >= cs.pave;
    const bool any0 = REV ? bandc < besta : bandc > besta;
    if (any0) {
      const int kstar = low + krel;
      besty = floordiv(bandc - kstar, 2);
      besta = bandc;
    }
    if (trigger && m_ok && tbl_ok) {
      ltk = (dif << TRIM_RB) | (REV ? rel : Wm - rel);
      ltc = c;
      lty = y;
      ltha = wha;
      lthb = whb;
    }

    // store the band
    if (inb) {
      V = c;
      T = sTv;
      M = sm;
      HA = wha;
      HB = whb;
      MA = wma;
      MB = wmb;
    }
    WCLK(SEC_TRIGGER);

    // Round B: lastc, and the band prune's hi_rel and lo_rel as one packed
    // key (max rel + 1, max W - rel) per warp, combined over the warps by a
    // per-halfword max.  Unless the wave clips, the pruned band is this
    // wave's band, where V = c.
    auto prune_key = [&](bool okv, int r) -> unsigned {
      return (__reduce_max_sync(FULL, okv ? (unsigned)(r + 1) : 0u) << 16) |
             __reduce_max_sync(FULL, okv ? (unsigned)(W - r) : 0u);
    };
    const int lc = trigger && m_ok ? c : fill;
    const int lw = REV ? __reduce_min_sync(FULL, lc)
                       : __reduce_max_sync(FULL, lc);
    const unsigned pk = prune_key(inb && (REV ? c <= besta + WAVE_LAG
                                              : c >= besta - WAVE_LAG), rel);
    const int4* rbb = rd.meet(make_int4(lw, (int)pk, 0, 0),
                              make_int4(0, 0, 0, 0));
    int lastc = rbb[0].x;
    unsigned prune = (unsigned)rbb[0].y;
#pragma unroll
    for (int i = 1; i < NW; ++i) {
      const int u = rbb[2 * i].x;
      lastc = REV ? (u < lastc ? u : lastc) : (u > lastc ? u : lastc);
      prune = __vmaxu2(prune, (unsigned)rbb[2 * i].y);
    }
    if (lastc != fill) lasta = lastc;
    seq.advance(dif, abase + (long long)(besta - besty), bbase + besty);
    WCLK(SEC_ROUND_B);

    // boundary clip + REACH grab, then the prune on the post-clip band
    const bool clipped = clip_any && more;
    if (clipped) {
      int aclip, bclip;
      bool hit_a, hit_b;
      if (!REV) {
        aclip = rd.reduce(cA ? k : I32MAX, OpMin());
        bclip = rd.reduce(cB ? k : -I32MAX, OpMax());
        hit_a = hgh >= aclip;
        hit_b = low <= bclip;
      } else {
        aclip = rd.reduce(cA ? k : -I32MAX, OpMax());
        bclip = rd.reduce(cB ? k : I32MAX, OpMin());
        hit_a = low <= aclip;
        hit_b = hgh >= bclip;
      }
      for (int side = 0; side < 2; ++side) {
        const int kc = side == 0 ? aclip : bclip;
        const bool hit = side == 0 ? hit_a : hit_b;
        const bool sel = k == kc;
        const int Mv = rd.reduce(sel ? M : 0, OpSum());
        const int Vv = rd.reduce(sel ? V : 0, OpSum());
        const int HAv = rd.reduce(sel ? HA : 0, OpSum());
        const int HBv = rd.reduce(sel ? HB : 0, OpSum());
        if (hit && morem <= Mv) {
          morem = Mv;
          morea = Vv;
          morey = floordiv(Vv - kc, 2);
          mored = dif;
          moreha = HAv;
          morehb = HBv;
        }
      }
      if (!REV) {
        if (hit_a) hgh = aclip - 1;
        if (hit_b) low = bclip + 1;
      } else {
        if (hit_a) low = aclip + 1;
        if (hit_b) hgh = bclip - 1;
      }
      const int rel2 = floormod(t - low, W);
      const bool inb2 = low + rel2 <= hgh;
      const unsigned pk2 = prune_key(
          inb2 && (REV ? V <= besta + WAVE_LAG : V >= besta - WAVE_LAG),
          rel2);
      const int4* rc = rd.meet(make_int4(0, (int)pk2, 0, 0),
                               make_int4(0, 0, 0, 0));
      prune = (unsigned)rc[0].y;
#pragma unroll
      for (int i = 1; i < NW; ++i)
        prune = __vmaxu2(prune, (unsigned)rc[2 * i].y);
    }
    WCLK(SEC_CLIP);

    // band prune: hi_rel = (prune >> 16) - 1, lo_rel = W - (prune & 0xFFFF)
    if (prune >> 16) {
      const int lo0 = low;
      hgh = lo0 + (int)(prune >> 16) - 1;
      low = lo0 + W - (int)(prune & 0xFFFF);
    }

    // next wave?  A clipped lane first resolves its REACH rest test
    const bool go = REV ? lasta <= besta + TRIM_MLAG
                        : lasta >= besta - TRIM_MLAG;
    more = more_new;
    live = more && go && !overflow;
    if (clipped) {
      int mb = 0, ma = 0;
      const int rbv = seq.bchar(bbase + besty + soff, mb);
      const int rav = seq.achar(abase + (long long)(besta - besty) + soff,
                                ma);
      if (Seq::kWindowed && (mb | ((rbv != 4) & ma))) overflow = 1;
      const bool rest = rbv != 4 && rav != 4;
      more = rest;
      live = rest && go && !overflow;
    }
    if (live && dif >= cs.max_waves) {
      overflow = 1;
      live = 0;
    }
    WCLK(SEC_TAIL);
  }

  // trim point: the slot with the largest (dif, rel) key (_trim_extract)
  const int kmax = rd.reduce(ltk, OpMax());
  if (kmax > 0 && ltk == kmax) {
    pro[0] = ltc;
    pro[1] = lty;
    pro[2] = ltha;
    pro[3] = lthb;
  }
  __syncthreads();
  const bool have = kmax > 0;
  vals[0] = have ? pro[0] : trima0;
  vals[1] = have ? pro[1] : trimy0;
  vals[2] = have ? (kmax >> TRIM_RB) : 0;
  vals[3] = have ? pro[2] : trimha0;
  vals[4] = have ? pro[3] : trimhb0;
  vals[5] = morem;
  vals[6] = morea;
  vals[7] = morey;
  vals[8] = mored;
  vals[9] = moreha;
  vals[10] = morehb;
  vals[11] = avail;
  vals[12] = overflow;
  vals[13] = dif;
  WCLK_END;
}

// ---------------------------------------------------------------------------
// lane inputs and outputs
// ---------------------------------------------------------------------------

constexpr int NREC_IN = 8;     // abase bbase mida k0 aoffp boffp awst bwst
constexpr int NREC_OUT = 16;   // the NOUT fields and 2 pad words

// One int32 array per field (plain and lane-packed layouts).  awst/bwst:
// the window starts, read only by the window kernels.
struct SplitIO {
  const int* abase;
  const int* bbase;
  const int* mida;
  const int* k0;
  const int* aoffp;
  const int* boffp;
  const int* awst;
  const int* bwst;
  int* out;   // (NOUT, n)
  int n;

  __device__ __forceinline__ LaneIn load(int lane) const {
    return LaneIn{abase[lane], bbase[lane], mida[lane],
                  k0[lane],    aoffp[lane], boffp[lane]};
  }
  __device__ __forceinline__ void window(int lane, long long& aw,
                                         long long& bw) const {
    aw = awst[lane];
    bw = bwst[lane];
  }
  __device__ __forceinline__ void store(int lane,
                                        const int (&vals)[NOUT]) const {
#pragma unroll
    for (int f = 0; f < NOUT; ++f) out[(long long)f * n + lane] = vals[f];
  }
};

// One record per lane (packed layout): (n, NREC_IN) int32 in, read as two
// 16-byte loads, and (n, NREC_OUT) int32 out, written as four 16-byte
// stores, so the caller moves one array each way.
struct PackedIO {
  const int4* rin;
  int4* rout;
  int n;

  __device__ __forceinline__ LaneIn load(int lane) const {
    const int4 r0 = rin[2 * (long long)lane], r1 = rin[2 * (long long)lane + 1];
    return LaneIn{r0.x, r0.y, r0.z, r0.w, r1.x, r1.y};
  }
  __device__ __forceinline__ void window(int lane, long long& aw,
                                         long long& bw) const {
    const int4 r1 = rin[2 * (long long)lane + 1];
    aw = r1.z;
    bw = r1.w;
  }
  __device__ __forceinline__ void store(int lane,
                                        const int (&vals)[NOUT]) const {
    int4* o = rout + (NREC_OUT / 4) * (long long)lane;
    o[0] = make_int4(vals[0], vals[1], vals[2], vals[3]);
    o[1] = make_int4(vals[4], vals[5], vals[6], vals[7]);
    o[2] = make_int4(vals[8], vals[9], vals[10], vals[11]);
    o[3] = make_int4(vals[12], vals[13], 0, 0);
  }
};

}  // namespace wavebody

#ifdef WAVE_SECTION_CLOCKS
// The lanes' section clocks, (CLK_LANES, NSEC) int64, copied into host and
// then zeroed on the device.
extern "C" int wave_section_clocks_take(long long* host) {
  using wavebody::wave_section_clocks;
  cudaError_t e = cudaMemcpyFromSymbol(host, wave_section_clocks,
                                       sizeof(wave_section_clocks));
  void* p = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, wave_section_clocks);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(wave_section_clocks));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

extern "C" int wave_section_clocks_shape(int* dims) {
  dims[0] = wavebody::CLK_LANES;
  dims[1] = wavebody::NSEC;
  return 0;
}
#endif
