// Native chain sweep: the per-(read, contig, orientation) k-mer chain DP.
//
// Semantics-parity redesign of the reference's splay-tree sweep
// (chain_thread, reference map.c:1020-1922) as an ordered-set sweep: the
// queries the splay tree answers are order statistics on the *set* of active
// hits, independent of tree shape (see ops/chain.py for the
// derivation), so a sorted vector keyed on (diag, apos) with short
// directional walks yields identical chains.
//
// For each hit (ascending apos, ties ascending bpos):
//   * expire active hits with apos < cur - MAX_GAP (chain-best expiries are
//     remembered for the end-of-group scan),
//   * pred   = smallest key > (diag,apos) with bpos >= bpos-MAX_GAP,
//     then the largest-apos active node on pred's diagonal,
//   * succ   = largest key < (diag,apos) with bpos <= bpos,
//   * extend the higher-cost predecessor (cost += min(kmer, advance), ties
//     prefer succ), track per-chain best via the origin's best pointer, and
//     absorb the predecessor when |ddiag| <= .2*dapos.
// At group end, scan active nodes in decreasing key order then expiries in
// order; chains with cost >= 3*kmer whose node is its chain's best are
// emitted as candidates with their compressed jump lists (chain_length
// semantics: same-diagonal steps < 100bp apart are spliced out).
//
// Emission order matches the reference scan order exactly, so the push
// pass can apply the MIN_PIECE/0.9 dominance rule incrementally.
//
// The push pass (chain_push) is the candidate step after the sweep: every
// emitted row, in emission order, adds to the read's -p cover and meets the
// read's candidate stack under the dominance rule (map.c:1641-1767), in a
// State that lives across a read block's passes (reads[].coff,
// map.c:1875).  ops/chain.py's _push_candidate is the same rule in Python,
// for the paths that sweep elsewhere; tests hold the two equal.

#include <cstdint>
#include <cstdlib>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr int MAX_GAP = 1000;   // map.c:36
constexpr int HITMIN = 3;       // map.c:34
constexpr int MIN_PIECE = 300;  // map.c:37
// a thread's least share of a pass (one thread sweeps it in ~10 ms;
// PERF.md)
constexpr int64_t MIN_THREAD_HITS = 1 << 16;

struct Node {
    int32_t apos, bpos, diag;
    int32_t cost;
    Node *frm, *orig, *best;
    bool absorbed;
};

struct Result {
    // candidate stream: [ar, br, cost, ab, ae, bb, be, njumps] per candidate
    std::vector<int32_t> meta;
    std::vector<int32_t> jumps;  // (adisp, bdisp) pairs, flattened
};

// The active set: its nodes sorted ascending on (diag, apos).  It holds
// the hits of one MAX_GAP window less the absorbed ones (47 a hit on
// average and 287 at most in a GRCh38-shaped sample, PERF.md); the walks
// below step through it in order, so a contiguous vector beats a tree at
// every size measured, up to 5,000.
using Active = std::vector<Node *>;

// the first position whose key is >= (diag, apos)
static size_t lower(const Active &v, int32_t diag, int32_t apos) {
    return std::lower_bound(v.begin(), v.end(), std::make_pair(diag, apos),
                            [](const Node *n, std::pair<int32_t, int32_t> k) {
                                return n->diag < k.first ||
                                       (n->diag == k.first &&
                                        n->apos < k.second);
                            }) - v.begin();
}

static bool at(const Active &v, size_t i, int32_t diag, int32_t apos) {
    return i < v.size() && v[i]->diag == diag && v[i]->apos == apos;
}

// erase the node of key (diag, apos), if any (std::map::erase(key))
static void erase_key(Active &v, int32_t diag, int32_t apos) {
    size_t i = lower(v, diag, apos);
    if (at(v, i, diag, apos)) v.erase(v.begin() + i);
}

// one group's buffers, kept across groups
struct Scratch {
    std::vector<Node> nodes;
    Active active;
    std::vector<Node *> queue, expired;
};

static int chain_length(Node *h) {
    int n = 0;
    Node *x = h;
    Node *y = x->frm;
    while (y) {
        int da = x->apos - y->apos;
        if (da == x->bpos - y->bpos && da < 100) {
            y = x->frm = y->frm;
        } else {
            n += 1;
            x = y;
            y = x->frm;
        }
    }
    return n;
}

static void sweep_group(int32_t ar, int32_t br,
                        const int32_t *apos, const int32_t *bpos,
                        int64_t count, int kmer, Result &res, Scratch &sc) {
    const int hithr = HITMIN * kmer;
    std::vector<Node> &nodes = sc.nodes;
    Active &active = sc.active;
    std::vector<Node *> &queue = sc.queue, &expired = sc.expired;
    nodes.clear();
    nodes.reserve(count);
    active.clear();
    queue.clear();
    expired.clear();
    size_t qhead = 0;

    for (int64_t i = 0; i < count; i++) {
        int32_t ap = apos[i];
        int32_t bp = bpos[i];

        while (qhead < queue.size() && queue[qhead]->apos < ap - MAX_GAP) {
            Node *nd = queue[qhead++];
            if (!nd->absorbed) {
                erase_key(active, nd->diag, nd->apos);
                if (nd->orig->best == nd) expired.push_back(nd);
            }
        }

        nodes.push_back(Node{ap, bp, ap - bp, 0, nullptr, nullptr, nullptr,
                             false});
        Node *nd = &nodes.back();
        nd->orig = nd;
        nd->best = nd;
        // std::map::emplace: a node of the same key stays in its place
        size_t it = lower(active, nd->diag, nd->apos);
        if (!at(active, it, nd->diag, nd->apos))
            active.insert(active.begin() + it, nd);
        const size_t na = active.size();

        int32_t thresh = bp - MAX_GAP;
        Node *l = nullptr;
        for (size_t j = it + 1; j < na; j++)
            if (active[j]->bpos >= thresh) { l = active[j]; break; }
        if (l) {
            // largest-apos active node on l's diagonal (always qualifies)
            size_t j = lower(active, l->diag + 1, INT32_MIN);
            if (active[j - 1]->diag == l->diag) l = active[j - 1];
        }
        Node *r = nullptr;
        for (size_t j = it; j-- > 0;)
            if (active[j]->bpos <= bp) { r = active[j]; break; }

        int32_t lcost = 0, rcost = 0;
        if (l) lcost = l->cost + (ap >= l->apos + kmer ? kmer : ap - l->apos);
        if (r) rcost = r->cost + (bp >= r->bpos + kmer ? kmer : bp - r->bpos);
        if (lcost > rcost) rcost = 0; else lcost = 0;

        Node *p = nullptr;
        int32_t cost = 0;
        if (lcost > 0) { p = l; cost = lcost; }
        else if (rcost > 0) { p = r; cost = rcost; }

        if (p) {
            nd->frm = p;
            nd->cost = cost;
            nd->orig = (p->frm == nullptr) ? p : p->orig;
            if (cost >= nd->orig->best->cost) {
                nd->orig->best = nd;
                int dd = p->diag - nd->diag;
                if (dd < 0) dd = -dd;
                if (dd <= .2 * (nd->apos - p->apos)) {
                    erase_key(active, p->diag, p->apos);
                    p->absorbed = true;
                }
            }
        } else {
            nd->frm = nullptr;
            nd->cost = kmer;
            nd->orig = nd;
        }
        queue.push_back(nd);
    }

    // end-of-group scan: active set in decreasing key order, then expiries
    // in REVERSE expiry order (the reference prepends each expiring node,
    // map.c:1790-1794, so its expired list is LIFO; the order decides which
    // of two equal-span LAs survives Handle_Redundancies)
    auto emit = [&](Node *h) {
        if (h->cost >= hithr && h->orig->best == h) {
            int32_t ab = h->orig->apos - kmer;
            int32_t bb = h->orig->bpos - kmer;
            int len = chain_length(h);
            res.meta.push_back(ar);
            res.meta.push_back(br);
            res.meta.push_back(h->cost);
            res.meta.push_back(ab);
            res.meta.push_back(h->apos);
            res.meta.push_back(bb);
            res.meta.push_back(h->bpos);
            res.meta.push_back(len);
            Node *g = h;
            for (Node *f = h->frm; f; f = f->frm) {
                res.jumps.push_back(g->apos - f->apos);
                res.jumps.push_back(g->bpos - f->bpos);
                g = f;
            }
        }
    };
    for (auto j = active.rbegin(); j != active.rend(); ++j) emit(*j);
    for (auto j = expired.rbegin(); j != expired.rend(); ++j) emit(*j);
}

// A candidate on a read's stack; its jumps are State::jumps[joff, +2*len).
struct Cand {
    int32_t score, bread, comp, ab, ae, bb, be, len;
    int64_t joff;
};

struct State {
    // each read's stack, oldest first: the newest candidate is at the back
    std::vector<std::vector<Cand>> stacks;
    std::vector<int32_t> jumps;
    int64_t ncands = 0;
    int32_t *cover = nullptr;        // the -p cover, flat; null without -p
    const int64_t *coff = nullptr;   // read r's cover starts at coff[r]
    int32_t spacing = 100;
};

// One candidate through the -p cover and the read's stack (_push_candidate).
static void push_one(State &st, const int32_t *row, const int32_t *jmp,
                     int32_t bread, int32_t comp) {
    const int32_t ar = row[0], cost = row[2], ab = row[3], ae = row[4];
    const int32_t len = row[7];
    if (st.cover) {
        // ab >= 0 and ae > ab: a chain starts at a k-mer's first base
        int32_t *cnt = st.cover + st.coff[ar];
        int32_t tb = ab / st.spacing;
        int32_t te = (ae - 1) / st.spacing + 1;
        if (cnt[tb] < 0x7FFF && cnt[te] > -0xFFFF) {
            cnt[tb] += 1;
            cnt[te] -= 1;
        }
    }
    std::vector<Cand> &stack = st.stacks[ar];
    // newest to oldest, deleting in place; a dominated candidate leaves the
    // deletions made before it
    for (int64_t d = (int64_t) stack.size() - 1; d >= 0; d--) {
        const Cand &D = stack[d];
        bool in_a = D.ab < ab + MIN_PIECE && D.ae > ae - MIN_PIECE;
        bool in_b = ab < D.ab + MIN_PIECE && ae > D.ae - MIN_PIECE;
        if (in_a && .9 * D.score >= cost) return;
        if (in_b && D.score <= .9 * cost) {
            stack.erase(stack.begin() + d);
            st.ncands -= 1;
        }
    }
    stack.push_back(Cand{cost, bread, comp, ab, ae, row[5], row[6], len,
                         (int64_t) st.jumps.size()});
    st.jumps.insert(st.jumps.end(), jmp, jmp + 2 * (int64_t) len);
    st.ncands += 1;
}

}  // namespace

extern "C" {

// The sweep of hits sorted by (aread, bread), 1-based end coords.  Groups
// are independent, so up to nthreads threads sweep contiguous runs of
// groups (at least MIN_THREAD_HITS hits each) into their own results,
// which are joined in group order: the emission order of one thread.
void *chain_sweep(int64_t n, const int32_t *aread, const int32_t *bread,
                  const int32_t *apos, const int32_t *bpos, int kmer,
                  int nthreads) {
    std::vector<int64_t> starts;
    for (int64_t s = 0; s < n;) {
        starts.push_back(s);
        int64_t e = s + 1;
        while (e < n && aread[e] == aread[s] && bread[e] == bread[s]) e++;
        s = e;
    }
    const int64_t ngroups = (int64_t) starts.size();
    starts.push_back(n);
    const int64_t nt = std::max<int64_t>(
        1, std::min<int64_t>({nthreads, ngroups, n / MIN_THREAD_HITS}));
    // part t sweeps the groups [cut[t], cut[t + 1]), about n / nt hits
    std::vector<int64_t> cut(nt + 1, ngroups);
    for (int64_t t = 0; t < nt; t++)
        cut[t] = std::lower_bound(starts.begin(), starts.end() - 1,
                                  t * n / nt) - starts.begin();
    std::vector<Result> parts(nt);
    auto sweep_part = [&](int64_t t) {
        Scratch sc;
        for (int64_t g = cut[t]; g < cut[t + 1]; g++) {
            int64_t s = starts[g];
            sweep_group(aread[s], bread[s], apos + s, bpos + s,
                        starts[g + 1] - s, kmer, parts[t], sc);
        }
    };
    std::vector<std::thread> threads;
    for (int64_t t = 1; t < nt; t++) threads.emplace_back(sweep_part, t);
    sweep_part(0);
    for (auto &th : threads) th.join();
    auto *res = new Result(std::move(parts[0]));
    for (int64_t t = 1; t < nt; t++) {
        res->meta.insert(res->meta.end(), parts[t].meta.begin(),
                         parts[t].meta.end());
        res->jumps.insert(res->jumps.end(), parts[t].jumps.begin(),
                          parts[t].jumps.end());
    }
    return res;
}

int64_t result_meta_len(void *h) {
    return (int64_t) ((Result *) h)->meta.size();
}
const int32_t *result_meta(void *h) { return ((Result *) h)->meta.data(); }
int64_t result_jumps_len(void *h) {
    return (int64_t) ((Result *) h)->jumps.size();
}
const int32_t *result_jumps(void *h) { return ((Result *) h)->jumps.data(); }
void result_free(void *h) { delete (Result *) h; }

// A read block's chain state: nreads empty stacks; cover/coff the flat -p
// cover and its per-read offsets (null without -p), owned by the caller and
// alive while the state is.
void *chain_state_new(int64_t nreads, int32_t *cover, const int64_t *coff,
                      int32_t spacing) {
    auto *st = new State();
    st->stacks.resize(nreads);
    st->cover = cover;
    st->coff = coff;
    st->spacing = spacing;
    return st;
}

// Push every row of a sweep result, in emission order, with bread offset by
// bstart and orientation comp; returns the rows pushed.
int64_t chain_push(void *s, void *h, int32_t bstart, int32_t comp) {
    State &st = *(State *) s;
    const Result &res = *(Result *) h;
    const int64_t nrows = (int64_t) res.meta.size() / 8;
    int64_t cur = 0;
    for (int64_t i = 0; i < nrows; i++) {
        const int32_t *row = res.meta.data() + 8 * i;
        push_one(st, row, res.jumps.data() + cur, row[1] + bstart, comp);
        cur += 2 * (int64_t) row[7];
    }
    return nrows;
}

int64_t chain_state_count(void *s) { return ((State *) s)->ncands; }

// The jump values (two a link) of every candidate on the stacks.
int64_t chain_state_jumps_len(void *s) {
    int64_t n = 0;
    for (const auto &stack : ((State *) s)->stacks)
        for (const Cand &c : stack) n += 2 * (int64_t) c.len;
    return n;
}

// The stacks, newest first a read: counts[r] candidates of read r, then one
// meta row [score, bread, comp, ab, ae, bb, be, len] a candidate in read
// order and its jumps, in the same order, each as the index of its
// (adisp, bdisp) pair in pairs, which holds each distinct pair once (far
// fewer than the jumps: a chain's steps are short); returns the number of
// distinct pairs.  pairs has room for every jump.
int64_t chain_state_export(void *s, int32_t *counts, int32_t *meta,
                           int32_t *index, int32_t *pairs) {
    const State &st = *(State *) s;
    // open addressing on the pair's 64-bit key, grown at half load
    std::vector<int64_t> keys(1 << 12);
    std::vector<int32_t> slot(1 << 12, -1);
    int64_t npairs = 0;
    auto grow = [&]() {
        std::vector<int64_t> k2(2 * keys.size());
        std::vector<int32_t> s2(2 * keys.size(), -1);
        const uint64_t mask = k2.size() - 1;
        for (size_t i = 0; i < keys.size(); i++) {
            if (slot[i] < 0) continue;
            uint64_t p = ((uint64_t) keys[i] * 0x9E3779B97F4A7C15ull) >> 20;
            while (s2[p & mask] >= 0) p++;
            k2[p & mask] = keys[i];
            s2[p & mask] = slot[i];
        }
        keys.swap(k2);
        slot.swap(s2);
    };
    for (size_t r = 0; r < st.stacks.size(); r++) {
        const auto &stack = st.stacks[r];
        counts[r] = (int32_t) stack.size();
        for (auto c = stack.rbegin(); c != stack.rend(); ++c) {
            const int32_t row[8] = {c->score, c->bread, c->comp, c->ab,
                                    c->ae, c->bb, c->be, c->len};
            for (int k = 0; k < 8; k++) *meta++ = row[k];
            const int32_t *j = st.jumps.data() + c->joff;
            for (int32_t k = 0; k < c->len; k++, j += 2) {
                const int64_t key = (int64_t) ((uint64_t) (uint32_t) j[0] << 32 |
                                               (uint32_t) j[1]);
                const uint64_t mask = keys.size() - 1;
                uint64_t p = ((uint64_t) key * 0x9E3779B97F4A7C15ull) >> 20;
                while (slot[p & mask] >= 0 && keys[p & mask] != key) p++;
                if (slot[p & mask] < 0) {
                    keys[p & mask] = key;
                    slot[p & mask] = (int32_t) npairs;
                    pairs[2 * npairs] = j[0];
                    pairs[2 * npairs + 1] = j[1];
                    *index++ = (int32_t) npairs++;
                    if (2 * npairs > (int64_t) keys.size()) grow();
                } else {
                    *index++ = slot[p & mask];
                }
            }
        }
    }
    return npairs;
}

void chain_state_free(void *s) { delete (State *) s; }

}  // extern "C"
