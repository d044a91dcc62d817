// Persistent wave lanes over their sequence windows, the windows cached in a
// TMA-fed ring of shared-memory chunks, for Hopper (sm_90a).
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
//                                      row on the TPU; here one lane a
//                                      64-thread block, as plain)
// The result is the driver's output contract (wave_pallas.py:2196-2206):
// trim point, REACH point, pebble pool, avail, overflow and wave count per
// lane, as wave.cu gives it; on every lane that no kernel flags as overflowed
// it equals wave.cu's.
//
// What bounds it on this card: latency, and how many lanes an SM holds.  The
// bytes are the two windows a lane reads and its pool rows (tens of
// kilobytes a lane, microseconds a round at 3.35 TB/s), the arithmetic a few
// hundred integer operations a slot a wave; but a lane's waves are a chain
// of dependent steps, each ending in barriers, and each snake step waits on
// the bytes before it.  So a launch takes its longest lane's waves times one
// wave's latency, and a launch of more lanes than the card holds at once
// takes that many times over: the lanes an SM holds (registers, and shared
// memory a lane) set the throughput of large launches.
//
// Design.  Each lane reads its A and B bases only from a window of L bases
// placed around its seed by the wrapper (ops/wave_persistent.py
// persistent_windows); a lane that needs a base outside its windows is
// flagged as overflowed and stops (the engine re-runs it on wave.cu).  The
// TPU kernel keeps both windows whole in VMEM, which holds megabytes, and
// reloads a plane AW = BW + 2W wide around the band for each segment
// (make_persistent_kernel, wave_pallas.py:1709-1760: rest-resolve -> plane
// reload -> segment).  Here shared memory is what is scarce: whole windows
// (2L bytes a lane, 32 KB at L = 16,384 and 128 KB at L = 65,536) capped an
// SM at six lanes, and at one for 40-45 kb reads.  So one block of W=64
// threads runs one lane, and keeps of each window only a ring of K chunks of
// C bytes near the band's front, 2KC bytes whatever L is (the wrapper's
// RING_CHUNK and RING_SLOTS): the Hopper form of the plane reload.
//   * Layout.  Chunk c of a window (window bytes [cC, (c+1)C)) lives in
//     slot c mod K, so a window byte r the ring holds is at r mod KC of the
//     ring's slots: one AND.  The ring holds the K chunks [clo, clo + K),
//     each slot with its mbarrier; every thread keeps clo and the parity of
//     each slot's latest fill (ph) in registers, the same in every thread,
//     and the window bytes it has seen filled, one range [rlo, rlo + rspan)
//     a ring, so the common read is one compare and one shared load.
//   * Filling by TMA.  A fill arms a slot's mbarrier with
//     mbarrier.arrive.expect_tx and copies the chunk with one
//     cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes of C
//     bytes.  At the lane's start thread s < 2K sets up barrier s and fills
//     slot s with its chunk of the K from the one SLACK bytes behind the
//     seed in the walk's direction (the TPU's first plane load); each thread
//     waits for the first of them only, and the rest of the copy overlaps
//     the first waves.
//   * Reads.  Every window read (the seed snake's bytes, the REACH bytes,
//     the snake's 8-byte words) goes through the ring and never waits: an
//     offset in the thread's range seen reads shared memory; any other
//     offset inside the window reads the sequence memory in place (__ldg;
//     bytes past its end read 4); an offset outside the window is a miss.
//     So the ring is only a cache: any placement gives the same bytes and
//     the same miss flags, and the outputs equal wave_lanes_persistent_ref's
//     bit for bit.
//   * Advancing.  After round B of every CHECK_EVERY-th wave (wave_body.cuh
//     calls Seq::advance with the band's best point, the same in every
//     thread) one compare a ring decides whether it steps: when the best
//     point has moved SLACK bytes past a chunk edge, every thread retires
//     the chunks behind it and one thread, after
//     fence.proxy.async.shared::cta (the reads of those slots came before
//     the barrier), refills their slots with the chunks ahead, each after
//     its slot's previous fill completed; and each thread widens its range
//     seen over the next chunks whose fills have completed
//     (mbarrier.test_wait.parity, which does not wait).  The wave gets no
//     new barrier; a long exact run that outruns the ring reads in place
//     until the range catches up.
//   * Cost.  The common read is one compare and one shared-memory load, as
//     in a whole window, and the hook one compare a ring every
//     CHECK_EVERY-th wave, its step out of line; the first designs measured
//     on the card waited in the read and widened the range there, or
//     stepped every wave, and each cost more than the shared-memory reads
//     saved (PERF.md §6).
//   * Edges.  Only chunks that lie whole inside the sequence memory are
//     filled (a bulk copy moves whole 16-byte units); a window's tail past
//     the memory's end reads in place.  A sequence memory whose address is
//     not 16-byte aligned (a tensor view) takes no bulk copy: every read is
//     in place.  A wait (before a refill, and for the last fills before the
//     block exits, so that no copy lands in a block that has left) that
//     does not complete in ~2^32 cycles traps, so a wrong parity fails
//     loudly and never hangs.
//   * plain:  one (N,) int32 array per lane field (SplitIO); lanepack runs
//             the plain kernel.
//   * packed: one (N, 8) int32 record per lane in (abase, bbase, mida, k0,
//             aoffp, boffp, awst, bwst), read as two 16-byte loads, and one
//             (N, 16) record out (the 14 fields and 2 pad words) written as
//             four 16-byte stores (PackedIO).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "wave_body.cuh"

constexpr int MAX_SLOTS = 32;             // slots a window (one mask word)

// The ring slots (2K chunks of C bytes, A's then B's: the dynamic shared
// memory) and one mbarrier a slot.
extern __shared__ __align__(128) uint8_t ring_slots[];
__shared__ uint64_t ring_bars[2 * MAX_SLOTS];

namespace {

using namespace wavebody;

constexpr int SLACK = 256;                // window bytes kept behind the front
constexpr int CHECK_EVERY = 16;           // waves between the hook's checks
constexpr long long WAIT_LIMIT = 1ll << 32;   // cycles before a wait traps
constexpr int SMEM_PER_BLOCK = 232448;    // shared memory a block may use

#ifdef WAVE_SECTION_CLOCKS
// Per lane: the cycles from the block's start until wave 0 may read (the
// ring's barriers set up and its first fills issued), the most cycles one
// thread of the lane waited for a fill (before refilling a slot, and at the
// end), and the window words its threads read from the ring and in place.
// Built only with -DWAVE_SECTION_CLOCKS (tools/wave_clocks.py), like the
// section clocks.
constexpr int NRING_CLK = 4;
__device__ unsigned long long wave_ring_clocks[CLK_LANES][NRING_CLK];
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool bar_done(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// The 8 bytes at shared address a (8-byte aligned).  A shared::cta address
// held in a register, so that the read does not rebuild a generic pointer's
// shared window (SR_CgaCtaId) at every step, as it did when ptxas chose to
// rematerialise the ring's base; volatile keeps it after the readiness test
// that guards it.
__device__ __forceinline__ uint64_t lds64(uint32_t a) {
  uint64_t v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(a));
  return v;
}

// Whether the phase of the given parity of the barrier at shared address bar
// has completed, without waiting.
__device__ __forceinline__ bool bar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of the given parity of the barrier at shared address
// bar has completed; trap after WAIT_LIMIT cycles.  Returns the cycles
// waited (0 when it had completed).
__device__ __forceinline__ long long bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_done(bar, parity)) return 0;
  const long long t0 = clock64();
  long long dt = 0;
  while (!bar_done(bar, parity)) {
    dt = clock64() - t0;
    if (dt > WAIT_LIMIT) __trap();
  }
  return dt;
}

// Arm the barrier for `bytes` and copy them from global src to shared dst.
__device__ __forceinline__ void fill(uint32_t bar, uint32_t dst,
                                     const uint8_t* src, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One window's ring.  Every field but rlo and rspan is the same in every
// thread of the block.
struct Ring {
  const uint8_t* mem;   // the sequence memory at the window start
  int wst;              // the window start in the sequence memory
  int len;              // window bytes in the sequence memory (rest read 4)
  int fend;             // chunks below fend >> lc can be filled; -1: none
                        // (the memory is not 16-byte aligned)
  int clo;              // the ring holds chunks [clo, clo + K)
  int edge;             // the front offset at which the hook steps it
  uint32_t ph;          // parity of each slot's latest fill (1: none yet)
  int rlo, rspan;       // window bytes [rlo, rlo + rspan) this thread has
                        // seen filled
  int npend;            // held chunks this thread has not seen filled
  uint32_t slots;       // shared address of the ring's K slots
  uint32_t bar0;        // shared address of its first slot's barrier
#ifdef WAVE_SECTION_CLOCKS
  long long waited;     // cycles this thread waited for the ring's fills
#endif
};

// The sequence policy of wave_body.cuh over the two rings (see the note
// above).  wave_lane takes it by const reference; the ring state it moves
// is mutable.
template <bool REV>
struct RingSeq {
  static constexpr bool kWindowed = true;
  mutable Ring ra, rb;
  int L, lc, K;         // window bytes, log2 C, slots a window
#ifdef WAVE_SECTION_CLOCKS
  mutable long long from_ring, in_place;
#endif

  __device__ __forceinline__ uint32_t bar(const Ring& R, int c) const {
    return R.bar0 + 8 * (c & (K - 1));
  }
  __device__ __forceinline__ uint32_t parity(const Ring& R, int c) const {
    return (R.ph >> (c & (K - 1))) & 1;
  }
  // the chunks [clo, cend) that the ring holds filled
  __device__ __forceinline__ int cend(const Ring& R) const {
    const int nf = R.fend >> lc;
    return R.clo + K < nf ? R.clo + K : nf;
  }

  // The 8 window bytes [q, q + 8), q a multiple of 8, byte j at bits 8j;
  // bytes outside the window or past the memory's end read 4.  A byte of the
  // range this thread has seen filled is one compare and one shared-memory
  // load away; any other byte is read in place.  No read waits.
  __device__ __forceinline__ uint64_t word(const Ring& R, int q) const {
    if (__builtin_expect((unsigned)(q - R.rlo) < (unsigned)R.rspan, 1)) {
#ifdef WAVE_SECTION_CLOCKS
      ++from_ring;
#endif
      return lds64(R.slots + (q & ((K << lc) - 1)));
    }
#ifdef WAVE_SECTION_CLOCKS
    in_place += (unsigned)q < (unsigned)L;
#endif
    if (R.fend >= 0 && q >= 0 && q <= R.len - 8)
      return (uint64_t)__ldg(
          reinterpret_cast<const unsigned long long*>(R.mem + q));
    uint64_t w = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = q + j;
      const uint64_t b =
          (unsigned)r < (unsigned)R.len ? (uint64_t)__ldg(R.mem + r) : 4;
      w |= b << (8 * j);
    }
    return w;
  }

  __device__ __forceinline__ int get(const Ring& R, long long i,
                                     int& miss) const {
    const long long r = i - R.wst;
    if ((unsigned long long)r >= (unsigned long long)L) {
      miss = 1;
      return 4;
    }
    return (int)(word(R, (int)r & ~7) >> (8 * ((int)r & 7))) & 0xFF;
  }
  __device__ __forceinline__ int achar(long long i, int& miss) const {
    return get(ra, i, miss);
  }
  __device__ __forceinline__ int bchar(long long i, int& miss) const {
    return get(rb, i, miss);
  }
  __device__ __forceinline__ bool amiss(long long i) const {
    return (unsigned long long)(i - ra.wst) >= (unsigned long long)L;
  }
  __device__ __forceinline__ bool bmiss(long long i) const {
    return (unsigned long long)(i - rb.wst) >= (unsigned long long)L;
  }

  // WordWalk's contract (wave_body.cuh) over a ring: the words are aligned
  // in window offsets, which the slots and the aligned memory share.
  template <bool WREV>
  struct Walk {
    const RingSeq* s;
    const Ring* R;
    int q;
    int s8;
    uint64_t w0, w1;

    __device__ __forceinline__ uint64_t bases() const {
      return (w0 >> s8) | ((w1 << 1) << (63 - s8));
    }
    __device__ __forceinline__ void next() {
      if (WREV) {
        q -= 8;
        w1 = w0;
        w0 = s->word(*R, q);
      } else {
        q += 8;
        w0 = w1;
        w1 = s->word(*R, q + 8);
      }
    }
  };
  template <bool WREV>
  __device__ __forceinline__ Walk<WREV> walk(const Ring& R,
                                             long long i) const {
    const int lo = (int)(i - R.wst) - (WREV ? 7 : 0);
    const int r = lo & 7;
    Walk<WREV> w{this, &R, lo - r, 8 * r, 0, 0};
    w.w0 = word(R, w.q);
    w.w1 = word(R, w.q + 8);
    return w;
  }
  template <bool WREV>
  __device__ __forceinline__ Walk<WREV> awalk(long long i) const {
    return walk<WREV>(ra, i);
  }
  template <bool WREV>
  __device__ __forceinline__ Walk<WREV> bwalk(long long i) const {
    return walk<WREV>(rb, i);
  }

  // The front offset at which a ring whose range starts at chunk clo moves:
  // forward when the front is SLACK bytes past the end of chunk clo,
  // reverse when it is SLACK bytes below the start of chunk clo + K - 1;
  // never where the range already reaches the window's end (start).
  __device__ __forceinline__ int edge_of(int clo) const {
    if (REV) return clo > 0 ? ((clo + K - 1) << lc) - SLACK : INT_MIN;
    return clo + K < (L >> lc) ? ((clo + 1) << lc) + SLACK : INT_MAX;
  }

  // The slots of the chunks [a, b) that a fill copies (those below fend).
  __device__ __forceinline__ uint32_t fills(const Ring& R, int a,
                                            int b) const {
    const int nf = R.fend >> lc;
    uint32_t m = 0;
    for (int c = a; c < b && c < nf; ++c) m |= 1u << (c & (K - 1));
    return m;
  }

  // Start one ring around the seed at window offset r0: the K chunks from
  // the one SLACK bytes behind it in the walk's direction.  Thread t < 2K
  // sets up barrier t and fills its slot; `mine` is this thread's slot, or
  // -1.
  __device__ __forceinline__ void start(Ring& R, long long r0,
                                        int mine) const {
    const int nc = L >> lc;
    long long r = r0 + (REV ? SLACK : -SLACK);
    r = r < 0 ? 0 : (r >= L ? L - 1 : r);
    int clo = REV ? (int)(r >> lc) - K + 1 : (int)(r >> lc);
    clo = min(clo, nc - K);
    R.clo = clo = max(clo, 0);
    R.rlo = (REV ? cend(R) : clo) << lc;
    R.rspan = 0;
    R.npend = max(cend(R) - clo, 0);
    const uint32_t m = fills(R, clo, clo + K);
    R.ph = ~m;
    if (mine >= 0) {
      const uint32_t b = R.bar0 + 8 * mine;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      // the chunk of [clo, clo + K) that lives in slot `mine`
      const int c = clo + ((mine - clo) & (K - 1));
      if ((m >> mine) & 1)
        fill(b, R.slots + (mine << lc), R.mem + ((long long)c << lc),
             1u << lc);
    }
  }

  // Wave 0 reads from the seed's chunk on: each thread waits for the
  // ring's first chunk in the walk's direction (the one fill the lane must
  // have before it starts), sees what else has landed, and sets its trigger.
  __device__ __forceinline__ void first(Ring& R) const {
    if (R.npend > 0) {
      const int c = REV ? (R.rlo >> lc) - 1 : R.rlo >> lc;
      const long long w = bar_wait(bar(R, c), parity(R, c));
#ifdef WAVE_SECTION_CLOCKS
      R.waited += w;
#else
      (void)w;
#endif
      see(R);
    }
    R.edge = trigger(R);
  }

  // Move one ring to the chunks around front offset rf (past its edge).
  // Every thread moves its state; thread 0, after fence.proxy.async (the
  // generic reads of the slots it refills came before the barrier this
  // follows), fills the new chunks, each after its slot's previous fill
  // completed.
  __device__ __forceinline__ void move(Ring& R, int rf) const {
    const int clo = R.clo;
    int nclo, a, b;   // the new range [nclo, nclo + K), new chunks [a, b)
    if (REV) {
      nclo = max(((rf + SLACK) >> lc) - K + 1, 0);
      a = nclo;
      b = min(clo, nclo + K);
    } else {
      nclo = min((rf - SLACK) >> lc, (L >> lc) - K);
      a = max(clo + K, nclo);
      b = nclo + K;
    }
    const uint32_t m = fills(R, a, b);
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int c = a; c < b; ++c) {
        if (!((m >> (c & (K - 1))) & 1)) continue;
        const long long w = bar_wait(bar(R, c), parity(R, c));
#ifdef WAVE_SECTION_CLOCKS
        R.waited += w;
#else
        (void)w;
#endif
        fill(bar(R, c), R.slots + ((c & (K - 1)) << lc),
             R.mem + ((long long)c << lc), 1u << lc);
      }
    }
    R.ph ^= m;
    R.clo = nclo;
    // keep of the range seen what is still held and was not refilled; an
    // empty range restarts at the walk's first chunk not seen filled
    int lo = R.rlo, hi = R.rlo + R.rspan;
    if (REV)
      hi = min(hi, (nclo + K) << lc);
    else
      lo = max(lo, nclo << lc);
    R.rlo = hi > lo ? lo : (REV ? cend(R) : nclo) << lc;
    R.rspan = hi > lo ? hi - lo : 0;
    R.npend = max(cend(R) - nclo, 0) - (R.rspan >> lc);
  }

  // Widen this thread's range seen over the next held chunks in the walk's
  // direction whose fills have completed (mbarrier.test_wait: no wait).
  __device__ __forceinline__ void see(Ring& R) const {
    while (R.npend > 0) {
      const int c = REV ? (R.rlo >> lc) - 1 : (R.rlo + R.rspan) >> lc;
      if (!bar_test(bar(R, c), parity(R, c))) return;
      if (REV) R.rlo -= 1 << lc;
      R.rspan += 1 << lc;
      --R.npend;
    }
  }

  // A ring's trigger once it has moved or widened: its edge, or, while this
  // thread has held chunks left to see, at once.
  __device__ __forceinline__ int trigger(const Ring& R) const {
    return R.npend > 0 ? (REV ? INT_MAX : INT_MIN) : edge_of(R.clo);
  }
  // The hook's rare path for one ring: move it if the front rf has passed
  // its edge, widen the range seen, and set the next trigger.
  __device__ __forceinline__ void step(Ring& R, int rf) const {
    const int e = edge_of(R.clo);
    if (REV ? rf < e : rf >= e) move(R, rf);
    if (R.npend > 0) see(R);
    R.edge = trigger(R);
  }

  // wave_lane's hook, after round B of wave d: fa / fb the A / B index of
  // the band's best point.  Every CHECK_EVERY waves, one compare a ring; a
  // ring steps when the front passes its edge or this thread has fills to
  // see.  The ring holds (K - 1) C bytes ahead of the front, far more than
  // a front moves in CHECK_EVERY waves.
  __device__ __forceinline__ void advance(int d, long long fa,
                                          long long fb) const {
    if (d % CHECK_EVERY) return;
    const int af = (int)fa - ra.wst, bf = (int)fb - rb.wst;
    if (REV ? af < ra.edge : af >= ra.edge) ra = stepped(ra, af, L, lc, K);
    if (REV ? bf < rb.edge : bf >= rb.edge) rb = stepped(rb, bf, L, lc, K);
  }
  // step() out of line, on values (the ring stays in registers): inline,
  // its code in the wave loop cost 1.4-3.7% a launch (PERF.md §6).
  __device__ __noinline__ static Ring stepped(Ring R, int rf, int L, int lc,
                                               int K) {
    const RingSeq s{R, R, L, lc, K};
    s.step(s.ra, rf);
    return s.ra;
  }

  // thread t < 2K: wait for slot t's latest fill, so that no copy lands in
  // the shared memory of a block that has left
  __device__ __forceinline__ void drain(int t) const {
    if (t < K)
      drain(ra, t);
    else if (t < 2 * K)
      drain(rb, t - K);
  }
  __device__ __forceinline__ void drain(Ring& R, int s) const {
    const long long w = bar_wait(bar(R, s), parity(R, s));
#ifdef WAVE_SECTION_CLOCKS
    R.waited += w;
#else
    (void)w;
#endif
  }
};

// One window's ring over memory mem[0, LM) from window start wst; its
// slots and barriers start at slot `first`.
__device__ __forceinline__ Ring make_ring(const uint8_t* mem, long long LM,
                                          long long wst, int L, int lc, int K,
                                          int first) {
  Ring R;
  R.mem = mem + wst;
  R.wst = (int)wst;
  const long long av = LM - wst;
  R.len = av >= L ? L : (av > 0 ? (int)av : 0);
  R.fend = (reinterpret_cast<uintptr_t>(R.mem) & 15)
               ? -1
               : (R.len >> lc) << lc;
  R.slots = smem_u32(ring_slots) + (first << lc);
  R.bar0 = smem_u32(ring_bars + first);
#ifdef WAVE_SECTION_CLOCKS
  R.waited = 0;
#endif
  return R;
}

// plain and packed: one block of W threads per lane
template <int W, bool REV, class IO>
__global__ void __launch_bounds__(W)
persistent_kernel(IO io, const uint8_t* __restrict__ A, long long LA,
                  const uint8_t* __restrict__ B, long long LB, int L, int lc,
                  int K, Consts cs, int* __restrict__ pool) {
  __shared__ LaneShared<W> sh;
#ifdef WAVE_SECTION_CLOCKS
  const long long clk0 = clock64();
#endif
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const LaneIn in = io.load(lane);
  long long awst, bwst;
  io.window(lane, awst, bwst);
  RingSeq<REV> seq;
  seq.L = L;
  seq.lc = lc;
  seq.K = K;
#ifdef WAVE_SECTION_CLOCKS
  seq.from_ring = seq.in_place = 0;
#endif
  seq.ra = make_ring(A, LA, awst, L, lc, K, 0);
  seq.rb = make_ring(B, LB, bwst, L, lc, K, K);
  // the seed: x0 = (mida + k0) / 2, y0 = (mida - k0) / 2, as
  // persistent_windows places the windows around it
  const long long x0 = in.abase + ((in.mida + in.k0) >> 1);
  const long long y0 = in.bbase + ((in.mida - in.k0) >> 1);
  seq.start(seq.ra, x0 - awst, t < K ? t : -1);
  seq.start(seq.rb, y0 - bwst, t >= K && t < 2 * K ? t - K : -1);
  __syncthreads();
  seq.first(seq.ra);
  seq.first(seq.rb);
#ifdef WAVE_SECTION_CLOCKS
  if (t == 0 && lane < CLK_LANES)
    wave_ring_clocks[lane][0] += clock64() - clk0;
#endif
  int vals[NOUT];
  wave_lane<W, REV>(in, seq, sh, t, cs,
                    reinterpret_cast<int4*>(pool) + (long long)lane * cs.P,
                    vals);
  seq.drain(t);
#ifdef WAVE_SECTION_CLOCKS
  if (lane < CLK_LANES) {
    atomicMax(&wave_ring_clocks[lane][1],
              (unsigned long long)(seq.ra.waited + seq.rb.waited));
    atomicAdd(&wave_ring_clocks[lane][2], (unsigned long long)seq.from_ring);
    atomicAdd(&wave_ring_clocks[lane][3], (unsigned long long)seq.in_place);
  }
#endif
  if (t == 0) io.store(lane, vals);
}

// The geometry a launch asks for: chunk and slots powers of two, a chunk a
// multiple of 128 bytes, 1-32 slots, and the 2K slots within a block's
// shared memory beside the static state.  Returns the dynamic shared memory
// (2 * slots * chunk bytes, whatever L is), or 0 if refused.
template <class Kern>
size_t ring_bytes(Kern kern, int chunk, int slots) {
  const bool pow2 = chunk > 0 && !(chunk & (chunk - 1)) && slots > 0 &&
                    !(slots & (slots - 1));
  if (!pow2 || chunk % 128 || slots > MAX_SLOTS) return 0;
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kern) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  const size_t dyn = 2 * (size_t)slots * (size_t)chunk;
  return dyn + fa.sharedSizeBytes <= (size_t)SMEM_PER_BLOCK ? dyn : 0;
}

// log2 of the chunk a window of L bytes uses: the ring's, or the largest
// power of two within a shorter window (L is a multiple of 128)
int chunk_log2(int L, int chunk) {
  int l = 0;
  while ((2 << l) <= chunk && (2 << l) <= L) ++l;
  return l;
}

// The instantiation of a launch: W=64 (the persistent engine's band), the
// direction and the lane-input layout.
template <class IO, class F>
cudaError_t with_kernel(int W, int reverse, F f) {
  if (W != 64) return cudaErrorInvalidValue;
  return reverse ? f(persistent_kernel<64, true, IO>)
                 : f(persistent_kernel<64, false, IO>);
}

template <class IO>
cudaError_t launch_lanes(IO io, int n, int W, int reverse,
                         const uint8_t* A, long long LA, const uint8_t* B,
                         long long LB, int L, int chunk, int slots, Consts cs,
                         int* pool, cudaStream_t st) {
  return with_kernel<IO>(W, reverse, [&](auto kern) {
    const size_t dyn = ring_bytes(kern, chunk, slots);
    if (dyn == 0 || L <= 0 || L % 128) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) {
      cudaGetLastError();   // leave no stale error for the next launch
      return e;
    }
    kern<<<n, 64, dyn, st>>>(io, A, LA, B, LB, L, chunk_log2(L, chunk), slots,
                             cs, pool);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" int wave_persistent_launch(
    const int* abase, const int* bbase, const int* mida, const int* k0,
    const int* aoffp, const int* boffp, const int* awst, const int* bwst,
    const uint8_t* A, long long LA, const uint8_t* B, long long LB, int n,
    int W, int P, int L, int reverse, int chunk, int slots, int ts, int pave,
    int msc, int dsc, int max_waves, int* out, int* pool, void* stream) {
  if (n <= 0) return 0;
  const SplitIO io{abase, bbase, mida, k0, aoffp, boffp, awst, bwst, out, n};
  return (int)launch_lanes(io, n, W, reverse, A, LA, B, LB, L, chunk, slots,
                           Consts{P, ts, pave, msc, dsc, max_waves}, pool,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int wave_persistent_packed_launch(
    const int* rec_in, const uint8_t* A, long long LA, const uint8_t* B,
    long long LB, int n, int W, int P, int L, int reverse, int chunk,
    int slots, int ts, int pave, int msc, int dsc, int max_waves,
    int* rec_out, int* pool, void* stream) {
  if (n <= 0) return 0;
  const PackedIO io{reinterpret_cast<const int4*>(rec_in),
                    reinterpret_cast<int4*>(rec_out), n};
  return (int)launch_lanes(io, n, W, reverse, A, LA, B, LB, L, chunk, slots,
                           Consts{P, ts, pave, msc, dsc, max_waves}, pool,
                           static_cast<cudaStream_t>(stream));
}

// Lanes an SM holds at once (blocks of the layout's kernel resident per SM)
// in a launch at window length L with the ring geometry; 0 where the launch
// would refuse it.
extern "C" int wave_persistent_occupancy(int packed, int reverse, int L,
                                         int chunk, int slots, int* lanes) {
  auto occ = [&](auto kern) {
    *lanes = 0;
    const size_t dyn = ring_bytes(kern, chunk, slots);
    if (dyn == 0 || L <= 0 || L % 128) return cudaSuccess;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(lanes, kern, 64, dyn);
    return e;
  };
  return (int)(packed ? with_kernel<PackedIO>(64, reverse, occ)
                      : with_kernel<SplitIO>(64, reverse, occ));
}

extern "C" const char* wave_persistent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef WAVE_SECTION_CLOCKS
// The lanes' ring clocks, (CLK_LANES, NRING_CLK) uint64 (stage cycles, most
// cycles a thread waited, window words read from the ring and in place),
// copied into host and then zeroed on the device.
extern "C" int wave_ring_clocks_take(unsigned long long* host) {
  cudaError_t e =
      cudaMemcpyFromSymbol(host, wave_ring_clocks, sizeof(wave_ring_clocks));
  void* p = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, wave_ring_clocks);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(wave_ring_clocks));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#endif
