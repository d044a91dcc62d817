// Batched O(nd) trace-point wave lanes for Hopper (sm_90a).
//
// Replaces the TPU wave segment kernel: damapper_tpu/ops/wave_pallas.py
// make_segment, launched by make_driver.segment_pallas (the pallas_call at
// wave_pallas.py:1524), together with its XLA companions make_prologue,
// make_reload, the REACH rest test, the drop-buffer flush and _trim_extract.
// The result is the driver's output contract (wave_pallas.py:1634-1640):
// trim point, REACH point, pebble pool, avail, overflow and wave count per
// lane, cell for cell.
//
// Design.  One thread block per lane, W threads; thread t owns ring slot t
// (diagonal k with k mod W == t) and keeps that slot's band state (V, M,
// NA, NB, HA, HB, MA, MB, the 61-bit match history T, the lazy trim
// candidate) in registers.  A lane runs from its prologue to its end in one
// launch.  Ring-neighbour reads of the wave start (border inheritance and
// pick3) go through shared memory; lane-wide maxima, minima and sums are
// warp shuffles plus a shared word per warp; the two trim-trigger scans run
// over the band in diagonal order with warp shuffles.  The snake reads the
// sequences straight from global memory (the TPU kernel's bitmask match
// planes, window reloads and reload stalls exist only because Mosaic had
// neither gathers nor DMA), pebbles go straight to the lane's pool rows in
// global memory (no drop buffer), and the REACH rest test reads its two
// bytes inline after the clip.
//
// What bounds it on this card: neither bytes nor arithmetic.  A lane reads
// each base of its A and B spans a few times and writes 16 bytes per
// pebble, which at the H100's 3.35 TB/s is microseconds per round; its
// integer work is a few hundred operations per slot per wave.  The waves of
// a lane are a chain of dependent steps, each ending in block barriers, and
// every snake step is a dependent byte load, so the kernel is bound by
// latency and instruction issue.  The design keeps everything but the
// sequence bytes and the pool on chip and runs many lanes per SM (one
// 64- or 128-thread block per lane) so that the SM can switch between
// lanes while one waits on a load or a barrier.
//
// Semantics that must match the JAX driver exactly: floor division and
// modulo on negative diagonals (floordiv/floormod below), the 61-bit T as
// one uint64 shifted by the whole snake run (the same bit stream as the
// JAX 16-column chunks), pebble drops in trips of DRANK ranks over the
// [A slots 0..W-1 | B slots 0..W-1] order, the band prune on the post-clip
// band, and the overflow tests at the wave start and after every trip.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// a byte of sequence memory; outside it every read is the sentinel 4
__device__ __forceinline__ int rd(const uint8_t* __restrict__ s, long long n,
                                  long long i) {
  return (i >= 0 && i < n) ? (int)__ldg(s + i) : 4;
}

struct OpMax { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct OpMin { __device__ int operator()(int a, int b) const { return a < b ? a : b; } };
struct OpSum { __device__ int operator()(int a, int b) const { return a + b; } };

template <int NW, class Op>
__device__ __forceinline__ int block_reduce(int v, int* red, Op op) {
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();                      // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) r = op(r, red[i]);
  return r;
}

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

template <int W, bool REV>
__global__ void __launch_bounds__(W)
wave_lanes_kernel(const int* __restrict__ g_abase,
                  const int* __restrict__ g_bbase,
                  const int* __restrict__ g_mida,
                  const int* __restrict__ g_k0,
                  const int* __restrict__ g_aoffp,
                  const int* __restrict__ g_boffp,
                  const uint8_t* __restrict__ A, long long LA,
                  const uint8_t* __restrict__ B, long long LB,
                  int n, int P, int TS, int pave, int msc, int dsc,
                  int max_waves, int* __restrict__ out,
                  int* __restrict__ pool) {
  constexpr int Wm = W - 1;
  constexpr int NW = W / 32;
  constexpr int sgn = REV ? -1 : 1;
  constexpr int soff = REV ? -1 : 0;
  constexpr int fill = REV ? I32MAX : NEG_BIG;

  __shared__ int sV[W], sNA[W], sNB[W], sM[W], sHA[W], sHB[W], sMA[W],
      sMB[W];
  __shared__ uint64_t sT[W];
  __shared__ int sbuf[W], sres[W];
  __shared__ int red[NW], wtot[NW];
  __shared__ unsigned balA[NW], balB[NW];
  __shared__ int pro[12];

  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  const int wl = t & 31, wi = t >> 5;
  const long long abase = g_abase[lane], bbase = g_bbase[lane];
  const int mida = g_mida[lane], k0 = g_k0[lane];
  const int aoffp = g_aoffp[lane], boffp = g_boffp[lane];
  int4* lpool = reinterpret_cast<int4*>(pool) + (long long)lane * P;

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
    int run = 0, ca = 0, cb = 0;
    while (true) {
      long long j = (long long)sgn * (run + wl);
      int b = rd(B, LB, pb + j), a = rd(A, LA, pa + j);
      bool stop = (b == 4) || (a != b);
      unsigned m = __ballot_sync(FULL, stop);
      if (m) {
        int f = __ffs(m) - 1;
        int bf = __shfl_sync(FULL, b, f), af = __shfl_sync(FULL, a, f);
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
    }
  }
  __syncthreads();
  const int y0f = pro[0];
  const bool clipA0 = pro[1], clipB0 = pro[2];
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
    const int rb = rd(B, LB, bbase + besty + soff);
    const int ra = rd(A, LA, abase + (long long)(besta - besty) + soff);
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
  int live = more;
  int overflow = 0;
  int dif = 0;

  // ---------------- waves 1, 2, ... ----------------
  while (live) {
    --low;
    ++hgh;
    ++dif;
    if (hgh - low + 4 >= W || avail + W >= P) overflow = 1;
    const int rel = floormod(t - low, W);
    const int k = low + rel;
    const bool inb = k <= hgh;
    const int sl = low & Wm, sh = hgh & Wm;

    // wave start: border init and pick3 inheritance from ring neighbours
    if (t == sl || t == sh) V = fill;
    sV[t] = V; sNA[t] = NA; sNB[t] = NB; sM[t] = M; sT[t] = T;
    sHA[t] = HA; sHB[t] = HB; sMA[t] = MA; sMB[t] = MB;
    __syncthreads();
    const int tp = (t + 1) & Wm, tm = (t - 1) & Wm;
    if (t == sl) {
      NA = sNA[tp];
      NB = sNB[tp];
    } else if (t == sh) {
      NA = sNA[tm];
      NB = sNB[tm];
    }
    int y = 0, sm = 0, wha = 0, whb = 0, wma = 0, wmb = 0;
    uint64_t sTv = 0;
    if (inb) {
      const int span = hgh - low;
      const int ap = floormod(tp - low, W) <= span ? sV[tp] : fill;
      const int am = floormod(tm - low, W) <= span ? sV[tm] : fill;
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
      sm = sM[src];
      sTv = sT[src];
      wha = sHA[src];
      whb = sHB[src];
      wma = sMA[src];
      wmb = sMB[src];
      sm -= (int)((sTv >> 60) & 1);
      sTv = (sTv << 1) & MASK61;
      // int32 wrap-around as in the JAX driver (only reachable from an
      // emptied band whose border slots hold the fill value)
      y = floordiv((int)((unsigned)cst - (unsigned)k), 2);
    }

    // snake: walk the diagonal to the first mismatch or sentinel
    bool sa = false, sb = false;
    if (inb) {
      const long long pb = bbase + y + soff;
      const long long pa = abase + (long long)y + k + soff;
      int run = 0;
      while (true) {
        const int b = rd(B, LB, pb + (long long)sgn * run);
        const int a = rd(A, LA, pa + (long long)sgn * run);
        if (b == 4) { sb = true; break; }
        if (a != b) { sa = a == 4; break; }
        ++run;
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

    // wave end: pebble drops, DRANK ranks per trip over [A | B] slot order
    const int c = (int)(2u * (unsigned)y + (unsigned)k);
    const bool cA = inb && sa, cB = inb && sb;
    const int clip_any = __syncthreads_or(cA || cB);
    const int more_new = clip_any ? 0 : more;
    {
      const long long Xa = (long long)y + k;
      const int Xb = y;
      const unsigned ltmask = (1u << wl) - 1;
      while (true) {
        const bool dA = inb && (REV ? Xa <= NA : Xa >= NA);
        const bool dB = inb && (REV ? Xb <= NB : Xb >= NB);
        if (!__syncthreads_or(dA || dB)) break;
        const bool nA = dA && (REV ? wma > NA : wma < NA);
        const bool nB = dB && (REV ? wmb > NB : wmb < NB);
        const unsigned bA = __ballot_sync(FULL, nA);
        const unsigned bB = __ballot_sync(FULL, nB);
        if (wl == 0) {
          balA[wi] = bA;
          balB[wi] = bB;
        }
        __syncthreads();
        int preA = 0, preB = 0, totA = 0, totB = 0;
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const int pa = __popc(balA[i]), pb = __popc(balB[i]);
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
      }
    }

    // best / trim triggers: exclusive suffix max (reverse: prefix min) of c
    // over the band in diagonal order, i.e. in rel order
    const int cm = inb ? c : fill;
    sbuf[rel] = cm;
    __syncthreads();
    {
      int v = sbuf[t];
      if (!REV) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_down_sync(FULL, v, o);
          if (wl + o < 32) v = u > v ? u : v;
        }
        int ex = __shfl_down_sync(FULL, v, 1);
        if (wl == 31) ex = NEG_BIG;
        if (wl == 0) wtot[wi] = v;
        __syncthreads();
        for (int i = wi + 1; i < NW; ++i) ex = wtot[i] > ex ? wtot[i] : ex;
        sres[t] = ex;
      } else {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(FULL, v, o);
          if (wl >= o) v = u < v ? u : v;
        }
        int ex = __shfl_up_sync(FULL, v, 1);
        if (wl == 0) ex = I32MAX;
        if (wl == 31) wtot[wi] = v;
        __syncthreads();
        for (int i = 0; i < wi; ++i) ex = wtot[i] < ex ? wtot[i] : ex;
        sres[t] = ex;
      }
    }
    __syncthreads();
    const int excl = sres[rel];
    bool trigger;
    if (!REV) {
      const int runbase = besta > excl ? besta : excl;
      trigger = inb && c > runbase;
    } else {
      const int runbase = besta < excl ? besta : excl;
      trigger = inb && c < runbase;
    }
    int t1, s1, t2, s2;
    trim_table((int)(sTv & 0x7FFF), msc, dsc, t1, s1);
    trim_table((int)((sTv >> 15) & 0x7FFF), msc, dsc, t2, s2);
    const bool tbl_ok = t1 >= 0 && t2 + s1 >= 0;
    const bool m_ok = sm >= pave;
    int bandc, lastc;
    bool any0, any1;
    if (!REV) {
      bandc = block_reduce<NW>(cm, red, OpMax());
      lastc = block_reduce<NW>(trigger && m_ok ? c : NEG_BIG, red, OpMax());
      any0 = bandc > besta;
      any1 = lastc != NEG_BIG;
    } else {
      bandc = block_reduce<NW>(cm, red, OpMin());
      lastc = block_reduce<NW>(trigger && m_ok ? c : I32MAX, red, OpMin());
      any0 = bandc < besta;
      any1 = lastc != I32MAX;
    }
    const int kstar = block_reduce<NW>(trigger && c == bandc ? k : 0, red,
                                       OpSum());
    if (any0) {
      besty = floordiv(bandc - kstar, 2);
      besta = bandc;
    }
    if (any1) lasta = lastc;
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

    // boundary clip + REACH grab
    const bool clipped = clip_any && more;
    if (clipped) {
      int aclip, bclip;
      bool hit_a, hit_b;
      if (!REV) {
        aclip = block_reduce<NW>(cA ? k : I32MAX, red, OpMin());
        bclip = block_reduce<NW>(cB ? k : -I32MAX, red, OpMax());
        hit_a = hgh >= aclip;
        hit_b = low <= bclip;
      } else {
        aclip = block_reduce<NW>(cA ? k : -I32MAX, red, OpMax());
        bclip = block_reduce<NW>(cB ? k : I32MAX, red, OpMin());
        hit_a = low <= aclip;
        hit_b = hgh >= bclip;
      }
      for (int side = 0; side < 2; ++side) {
        const int kc = side == 0 ? aclip : bclip;
        const bool hit = side == 0 ? hit_a : hit_b;
        const bool sel = k == kc;
        const int Mv = block_reduce<NW>(sel ? M : 0, red, OpSum());
        const int Vv = block_reduce<NW>(sel ? V : 0, red, OpSum());
        const int HAv = block_reduce<NW>(sel ? HA : 0, red, OpSum());
        const int HBv = block_reduce<NW>(sel ? HB : 0, red, OpSum());
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
    }

    // band prune on the post-clip band
    {
      const int rel2 = floormod(t - low, W);
      const bool inb2 = low + rel2 <= hgh;
      const bool ok = inb2 && (REV ? V <= besta + WAVE_LAG
                                   : V >= besta - WAVE_LAG);
      const int hi_rel = block_reduce<NW>(ok ? rel2 : -1, red, OpMax());
      const int lo_rel = block_reduce<NW>(ok ? rel2 : W, red, OpMin());
      if (hi_rel >= 0) {
        hgh = low + hi_rel;
        low = low + (lo_rel < hi_rel ? lo_rel : hi_rel);
      }
    }

    // next wave?  A clipped lane first resolves its REACH rest test
    const bool go = REV ? lasta <= besta + TRIM_MLAG
                        : lasta >= besta - TRIM_MLAG;
    more = more_new;
    live = more && go && !overflow;
    if (clipped) {
      const int rb = rd(B, LB, bbase + besty + soff);
      const int ra = rd(A, LA, abase + (long long)(besta - besty) + soff);
      const bool rest = rb != 4 && ra != 4;
      more = rest;
      live = rest && go && !overflow;
    }
    if (live && dif >= max_waves) {
      overflow = 1;
      live = 0;
    }
  }

  // trim point: the slot with the largest (dif, rel) key (_trim_extract)
  const int kmax = block_reduce<NW>(ltk, red, OpMax());
  if (kmax > 0 && ltk == kmax) {
    pro[0] = ltc;
    pro[1] = lty;
    pro[2] = ltha;
    pro[3] = lthb;
  }
  __syncthreads();
  if (t == 0) {
    const bool have = kmax > 0;
    const int vals[NOUT] = {
        have ? pro[0] : trima0, have ? pro[1] : trimy0,
        have ? (kmax >> TRIM_RB) : 0, have ? pro[2] : trimha0,
        have ? pro[3] : trimhb0, morem, morea, morey, mored, moreha, morehb,
        avail, overflow, dif};
#pragma unroll
    for (int f = 0; f < NOUT; ++f) out[(long long)f * n + lane] = vals[f];
  }
}

template <int W, bool REV>
void launch(const int* const* ins, const uint8_t* A, long long LA,
            const uint8_t* B, long long LB, int n, int P, int ts, int pave,
            int msc, int dsc, int max_waves, int* out, int* pool,
            cudaStream_t st) {
  wave_lanes_kernel<W, REV><<<n, W, 0, st>>>(
      ins[0], ins[1], ins[2], ins[3], ins[4], ins[5], A, LA, B, LB, n, P, ts,
      pave, msc, dsc, max_waves, out, pool);
}

}  // namespace

extern "C" int wave_lanes_launch(
    const int* abase, const int* bbase, const int* mida, const int* k0,
    const int* aoffp, const int* boffp, const uint8_t* A, long long LA,
    const uint8_t* B, long long LB, int n, int W, int P, int reverse, int ts,
    int pave, int msc, int dsc, int max_waves, int* out, int* pool,
    void* stream) {
  const int* ins[6] = {abase, bbase, mida, k0, aoffp, boffp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (W == 64) {
    if (reverse)
      launch<64, true>(ins, A, LA, B, LB, n, P, ts, pave, msc, dsc,
                       max_waves, out, pool, st);
    else
      launch<64, false>(ins, A, LA, B, LB, n, P, ts, pave, msc, dsc,
                        max_waves, out, pool, st);
  } else if (W == 128) {
    if (reverse)
      launch<128, true>(ins, A, LA, B, LB, n, P, ts, pave, msc, dsc,
                        max_waves, out, pool, st);
    else
      launch<128, false>(ins, A, LA, B, LB, n, P, ts, pave, msc, dsc,
                         max_waves, out, pool, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* wave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
