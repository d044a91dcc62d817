// Native trace walk: the pebble chains of a finished wave pass into (d, b)
// trace-point pair lists, for every lane of a pass in one call.
//
// Element-for-element the walk of ops/wave.py (extract_forward_traces,
// extract_reverse_traces; reference align.c:900-1007 and 1554-1708), which
// stays the plain version and the oracle's walk.  The pool is the pass's
// pulled (rows, top, 4) int32 block of (ptr, diag, diff, mark) pebbles;
// ``lane_rows`` names each walked lane's row of it.  Per-lane scalars are
// the lane's REACH-selected trim point.  Traces come back flat, one int32
// array a side with an (n + 1) offset array; every entry is masked to
// 16 bits as the reference's uint16 trace is.
//
// The reverse walk writes each lane's prefix in order (the Python walk
// prepends) and follows it with the lane's forward trace, whose first pair
// takes the junction edits the Python walk makes in place.  The reference's
// (b-a, b-a) pair at an empty forward junction (align.c:1669-1672) is kept.
//
// A chain that starts or steps outside [0, top), runs longer than top
// pebbles, or edits a pair that does not exist makes the call return the
// lane's index + 1 (the Python walk raises IndexError or never ends).

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

struct Cell {
    int32_t ptr, diag, diff, mark;
};

inline int64_t floordiv2(int64_t x) {
    return x >= 0 ? x / 2 : -((1 - x) / 2);
}

inline int64_t pymod(int64_t x, int64_t m) {
    int64_t r = x % m;
    return r < 0 ? r + m : r;
}

inline int32_t u16(int64_t x) { return static_cast<int32_t>(x & 0xFFFF); }

// The chain ending at pebble h, first pebble first; false if malformed.
bool chain_of(const Cell *cells, int64_t top, int64_t h,
              std::vector<int32_t> &out) {
    out.clear();
    if (h < 0 || h >= top)
        return false;
    while (h >= 0) {
        if (h >= top || static_cast<int64_t>(out.size()) >= top)
            return false;
        out.push_back(static_cast<int32_t>(h));
        h = cells[h].ptr;
    }
    for (std::size_t i = 0, j = out.size() - 1; i < j; ++i, --j)
        std::swap(out[i], out[j]);
    return true;
}

// Each side walks with a sign s, +1 for the A trace and -1 for the B
// trace: a pebble's b is mark - s * diag, and the trace ends against
// (endx, endy), which is (trimx, trimy) for A and (trimy, trimx) for B.

// One side of a forward pass.  Appends to tr; returns false if malformed.
// low gets the first pebble's diagonal.
bool forward_side(const Cell *cells, int64_t top, int64_t head, int sign,
                  int64_t mida, int64_t endx, int64_t endy, int64_t trimd,
                  std::vector<int32_t> &chain, int32_t *tr, int64_t &len,
                  int64_t *low) {
    if (!chain_of(cells, top, head, chain))
        return false;
    int64_t k = cells[chain[0]].diag;
    if (low)
        *low = k;
    int64_t b = floordiv2(mida - sign * k);
    int64_t e = 0;
    const int64_t start = len;
    for (std::size_t i = 1; i < chain.size(); ++i) {
        const Cell &c = cells[chain[i]];
        k = c.diag;
        int64_t a = c.mark - sign * k;
        tr[len++] = u16(c.diff - e);
        tr[len++] = u16(a - b);
        b = a;
        e = c.diff;
    }
    if (b + sign * k != endx) {
        tr[len++] = u16(trimd - e);
        tr[len++] = u16(endy - b);
    } else if (b != endy) {
        if (len == start)
            return false;
        tr[len - 1] = u16(tr[len - 1] + (endy - b));
        tr[len - 2] = u16(tr[len - 2] + (trimd - e));
    }
    return true;
}

// One side of a reverse pass.  Writes the prefix, then the forward trace
// fwd[0:nf] with its first pair edited at the junction, to tr; returns
// false if malformed.
bool reverse_side(const Cell *cells, int64_t top, int64_t head, int sign,
                  int64_t TS, int64_t off, int64_t endx, int64_t endy,
                  int64_t trimd, const int32_t *fwd, int64_t nf,
                  std::vector<int32_t> &chain, std::vector<int32_t> &pre,
                  int32_t *tr, int64_t &len) {
    if (!chain_of(cells, top, head, chain))
        return false;
    pre.clear();          // pairs in walking order; written out reversed
    int32_t f0 = nf > 0 ? fwd[0] : 0, f1 = nf > 0 ? fwd[1] : 0;
    const Cell &c0 = cells[chain[0]];
    int64_t k = c0.diag;
    int64_t b = c0.mark - sign * k;
    int64_t e = 0;
    std::size_t next = 1;  // the first pebble of the loop below
    bool h_valid = true;
    if (pymod(b + sign * k, TS) != off) {
        int64_t a, d;
        if (chain.size() < 2) {
            a = endy;
            d = trimd;
        } else {
            const Cell &c = cells[chain[1]];
            k = c.diag;
            d = c.diff;
            a = c.mark - sign * k;
        }
        if (nf == 0) {
            // the A side's pair is (d-e, b-a); the B side's repeats b-a
            pre.push_back(u16(sign > 0 ? d - e : b - a));
            pre.push_back(u16(b - a));
        } else {
            f1 = u16(f1 + (b - a));
            f0 = u16(f0 + (d - e));
        }
        b = a;
        e = d;
        h_valid = chain.size() >= 2;
        next = 2;
    }
    if (h_valid) {
        for (std::size_t i = next; i < chain.size(); ++i) {
            const Cell &c = cells[chain[i]];
            k = c.diag;
            int64_t a = c.mark - sign * k;
            pre.push_back(u16(c.diff - e));
            pre.push_back(u16(b - a));
            b = a;
            e = c.diff;
        }
        if (b + sign * k != endx) {
            pre.push_back(u16(trimd - e));
            pre.push_back(u16(b - endy));
        } else if (b != endy) {
            if (pre.empty())
                return false;
            std::size_t m = pre.size();
            pre[m - 1] = u16(pre[m - 1] + (b - endy));
            pre[m - 2] = u16(pre[m - 2] + (trimd - e));
        }
    }
    for (std::size_t m = pre.size(); m >= 2; m -= 2) {
        tr[len++] = pre[m - 2];
        tr[len++] = pre[m - 1];
    }
    if (nf > 0) {
        tr[len++] = f0;
        tr[len++] = f1;
        for (int64_t i = 2; i < nf; ++i)
            tr[len++] = fwd[i];
    }
    return true;
}

}  // namespace

extern "C" {

// Forward pass.  Capacity of atr and btr: 2 * top per lane.
int64_t trace_forward(int64_t n, int64_t top, const int32_t *pool,
                      const int64_t *lane_rows, const int32_t *trimx,
                      const int32_t *trimy, const int32_t *trimd,
                      const int32_t *trimha, const int32_t *trimhb,
                      const int32_t *mida, int32_t *atr, int64_t *aoff,
                      int32_t *btr, int64_t *boff, int32_t *low) {
    std::vector<int32_t> chain;
    chain.reserve(top);
    int64_t na = 0, nb = 0;
    aoff[0] = boff[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const Cell *cells =
            reinterpret_cast<const Cell *>(pool) + lane_rows[i] * top;
        int64_t lw = 0;
        if (!forward_side(cells, top, trimha[i], +1, mida[i], trimx[i],
                          trimy[i], trimd[i], chain, atr, na, nullptr) ||
            !forward_side(cells, top, trimhb[i], -1, mida[i], trimy[i],
                          trimx[i], trimd[i], chain, btr, nb, &lw))
            return i + 1;
        low[i] = static_cast<int32_t>(lw);
        aoff[i + 1] = na;
        boff[i + 1] = nb;
    }
    return 0;
}

// Reverse pass.  The lane's forward traces are fa[fa_lo[i]:fa_hi[i]] and
// fb[fb_lo[i]:fb_hi[i]].  Capacity of atr: 2 * top per lane plus the
// forward A traces' lengths; of btr likewise.
int64_t trace_reverse(int64_t n, int64_t top, const int32_t *pool,
                      const int64_t *lane_rows, const int32_t *trimx,
                      const int32_t *trimy, const int32_t *trimd,
                      const int32_t *trimha, const int32_t *trimhb,
                      int64_t TS, const int32_t *aoffp, const int32_t *boffp,
                      const int32_t *fa, const int64_t *fa_lo,
                      const int64_t *fa_hi, const int32_t *fb,
                      const int64_t *fb_lo, const int64_t *fb_hi,
                      int32_t *atr, int64_t *aoff, int32_t *btr,
                      int64_t *boff) {
    std::vector<int32_t> chain, pre;
    chain.reserve(top);
    pre.reserve(2 * top);
    int64_t na = 0, nb = 0;
    aoff[0] = boff[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const Cell *cells =
            reinterpret_cast<const Cell *>(pool) + lane_rows[i] * top;
        if (!reverse_side(cells, top, trimha[i], +1, TS, aoffp[i], trimx[i],
                          trimy[i], trimd[i], fa + fa_lo[i],
                          fa_hi[i] - fa_lo[i], chain, pre, atr, na) ||
            !reverse_side(cells, top, trimhb[i], -1, TS, boffp[i], trimy[i],
                          trimx[i], trimd[i], fb + fb_lo[i],
                          fb_hi[i] - fb_lo[i], chain, pre, btr, nb))
            return i + 1;
        aoff[i + 1] = na;
        boff[i + 1] = nb;
    }
    return 0;
}

}  // extern "C"
