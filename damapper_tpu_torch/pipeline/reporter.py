"""Reporter: candidates -> local alignments -> fused/deduped LAs -> chain
graph -> zone selection -> .las records.

Semantics-parity reimplementation of report_thread and helpers (reference
map.c:1925-2871):

  * per candidate, run Local_Alignment at successive chain seed points not
    yet covered (map.c:2487-2576), keeping LAs spanning >= HITMIN*kmer,
  * per (bread, comp) run, fuse entwined LAs sharing a trace point and drop
    contained ones (Entwine map.c:1953, Fusion map.c:2065,
    Handle_Redundancies map.c:2116), then sort by descending abpos,
  * build the LA chain graph with gap/ratio feasibility (CHAIN_OVL=400,
    CHAIN_OFF=500, CHAIN_PLAY=1.4) and score = len - 2.3*diffs with the
    TIE_SCORE/TIE_GAP rules (map.c:2630-2710),
  * greedy zone partition of the read span keeping chains >= BEST_TIE of the
    zone top (map.c:2714-2816), emitting START/NEXT/BEST flags.

The batched path uploads each sequence section as it is (one uint8 copy to
the engine's device; DAMAPPER_PACK_UPLOAD=1: 2-bit packed and unpacked
there, ops.device_index.pack_upload) and aligns every round of seeds with
the wave engine (ops.wave_engine).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..io.las import (BEST_FLAG, COMP_FLAG, LA, NEXT_FLAG, START_FLAG,
                      TRACE_XOVR)
from ..ops import device_index as dix
from ..ops.chain import HITMIN
from ..ops.wave import ACOMP_FLAG, PathRec, local_alignment
from ..utils import spans

CHAIN_OFF = 500.   # map.c:42
CHAIN_OVL = 400.   # map.c:43
CHAIN_PLAY = 1.4   # map.c:44
DIFF_SCORE = 2.3   # map.c:47
TIE_SCORE = 50     # map.c:48
TIE_GAP = 500      # map.c:49


# process-level device copy of the full-reference align sequence: every
# read block of a job list aligns against the SAME reference memory, so it
# is uploaded once.  Keyed on the DB's identity (path, block, length, and
# the .bps file's mtime and size), the device and the upload format;
# bounded by DAMAPPER_SEQCACHE_MB (default 1600).  DAMAPPER_REFCACHE=0
# turns the cache off for both the get and the put.
_ref_seq_cache: dict = {}


def _upload_section(flat, boffs, rlens, device):
    """One sequence section (sentinel layout) on ``device``: the plain
    uint8 bytes (WaveEngine.upload); DAMAPPER_PACK_UPLOAD=1: 2-bit packed
    and unpacked there, bucket-padded with a tail that unpacks to
    sentinels (the wave kernels read the sentinel 4 past every read, and
    never past the memory's length)."""
    if not dix.packed_upload_on():
        return torch.from_numpy(np.ascontiguousarray(flat, np.uint8)).to(
            device)
    return dix.pack_upload(flat, boffs, rlens, dix._bucket(len(flat)),
                           device)


def align_memory_a(reads_db):
    """The A side of the wave's sequence memories, [reads | comp reads]:
    every read reverse-complemented at its own offset in a second copy.
    Returns (flat_a, comp_off, boffs, rlens): the uint8 memory, the
    offset of the complemented copy and the reads' offsets and lengths in
    flat_a (both copies), as _upload_section takes them.  The B side is
    the reference's ``seq`` as it is."""
    rd_seq = reads_db.seq
    rb = reads_db.reads["boff"]
    rl = reads_db.reads["rlen"]
    # the complement is one vectorized pass (3 - base, sentinels stay 4);
    # the per-read reversal a slice loop (reads are independent intervals)
    comp_seq = np.where(rd_seq <= 3, 3 - rd_seq, rd_seq).astype(np.uint8)
    for i in range(reads_db.nreads):
        o = int(rb[i])
        ln = int(rl[i])
        comp_seq[o:o + ln] = comp_seq[o:o + ln][::-1]
    comp_off = len(rd_seq)
    return (np.concatenate([rd_seq, comp_seq]), comp_off,
            np.concatenate([rb, rb + comp_off]), np.concatenate([rl, rl]))


def _ref_seq_cached(ref_db, device):
    def upload():
        return _upload_section(ref_db.seq, ref_db.reads["boff"],
                               ref_db.reads["rlen"], device)

    if os.environ.get("DAMAPPER_REFCACHE", "1") == "0":
        return upload()
    try:
        bps = ref_db.path + ".bps"
        key = (ref_db.path, ref_db.part, int(ref_db.totlen),
               os.path.getmtime(bps), os.path.getsize(bps), str(device),
               dix.packed_upload_on())
    except OSError:
        return upload()
    ent = _ref_seq_cache.get(key)
    if ent is not None:
        return ent
    dev = upload()
    budget = int(os.environ.get("DAMAPPER_SEQCACHE_MB", "1600")) << 20
    if int(dev.shape[0]) <= budget:
        _ref_seq_cache.clear()   # one reference at a time is the job
        _ref_seq_cache[key] = dev
    return dev


@dataclass
class _Match:
    aread: int
    bread: int
    flags: int
    path: PathRec


def entwine(jpath: PathRec, kpath: PathRec, spacing: int):
    """Minimum b-distance between two a-overlapping paths at shared trace
    ticks; returns (min_dist, where) with where = a-coordinate of a shared
    trace point if min_dist==0 (Entwine map.c:1953-2058)."""
    where = None
    minv = 10000
    y2 = jpath.bbpos
    j = jpath.abpos // spacing
    b2 = kpath.bbpos
    k = kpath.abpos // spacing

    if jpath.abpos == kpath.abpos:
        minv = abs(y2 - b2)
        if minv == 0:
            where = kpath.abpos

    jt, kt = jpath.trace, kpath.trace
    if j < k:
        ac = k * spacing
        j = 1 + 2 * (k - j)
        k = 1
        for i in range(1, j, 2):
            y2 += jt[i]
    else:
        ac = j * spacing
        k = 1 + 2 * (j - k)
        j = 1
        for i in range(1, k, 2):
            b2 += kt[i]

    ae = min(jpath.aepos, kpath.aepos)
    den = 0
    while True:
        ac += spacing
        if ac >= ae:
            break
        y2 += jt[j]
        b2 += kt[k]
        j += 2
        k += 2
        i = abs(y2 - b2)
        if i <= minv:
            minv = i
            if i == 0:
                where = ac
        den += 1

    if jpath.aepos == kpath.aepos:
        i = abs(jpath.bepos - kpath.bepos)
        if i <= minv:
            minv = i
            if i == 0:
                where = kpath.aepos

    if den == 0:
        return -1, where
    return minv, where


def fusion(path1: PathRec, ap: int, path2: PathRec, spacing: int) -> None:
    """Concatenate path1[..ap] with path2[ap..] into path1 (Fusion
    map.c:2065-2109)."""
    k1 = 2 * ((ap // spacing) - (path1.abpos // spacing))
    k2 = 2 * ((ap // spacing) - (path2.abpos // spacing))
    trace = []
    diff = 0
    if k1 > 0:
        t = path1.trace
        for k in range(0, k1, 2):
            trace.append(t[k])
            trace.append(t[k + 1])
            diff += t[k]
    if k2 < path2.tlen:
        t = path2.trace
        for k in range(k2, path2.tlen, 2):
            trace.append(t[k])
            trace.append(t[k + 1])
            diff += t[k]
    path1.aepos = path2.aepos
    path1.bepos = path2.bepos
    path1.diffs = diff
    path1.trace = trace


def handle_redundancies(amatch: list[_Match], bmatch, spacing: int, cm: int,
                        ) -> tuple[list, list]:
    """Fuse entwined LAs / drop contained ones (map.c:2116-2268).
    bmatch may be None (no -C)."""
    novls = len(amatch)
    has_b = bmatch is not None
    if not has_b:
        bmatch = amatch   # aliasing mirrors bmatch=amatch in report_thread

    for j in range(1, novls):
        jpath = amatch[j].path
        jmath = bmatch[j].path
        for k in range(j - 1, -1, -1):
            kpath = amatch[k].path
            kmath = bmatch[k].path
            if kpath.abpos < 0:
                continue
            if jpath.abpos < kpath.abpos:
                if kpath.abpos <= jpath.aepos and kpath.bbpos <= jpath.bepos:
                    dist, awhen = entwine(jpath, kpath, spacing)
                    if dist == 0:
                        if kpath.aepos > jpath.aepos:
                            if has_b:
                                if cm:
                                    dist, bwhen = entwine(kmath, jmath, spacing)
                                    if dist != 0:
                                        continue
                                    fusion(jpath, awhen, kpath, spacing)
                                    fusion(kmath, bwhen, jmath, spacing)
                                    bmatch[j] = _copy_match(bmatch[k])
                                else:
                                    dist, bwhen = entwine(jmath, kmath, spacing)
                                    if dist != 0:
                                        continue
                                    fusion(jpath, awhen, kpath, spacing)
                                    fusion(jmath, bwhen, kmath, spacing)
                            else:
                                fusion(jpath, awhen, kpath, spacing)
                        kpath.abpos = -1
                        break
            else:
                if jpath.abpos <= kpath.aepos and jpath.bbpos <= kpath.bepos:
                    dist, awhen = entwine(kpath, jpath, spacing)
                    if dist == 0:
                        if kpath.abpos == jpath.abpos:
                            if kpath.aepos > jpath.aepos:
                                amatch[j] = _copy_match_path(amatch[j], kpath)
                                jpath = amatch[j].path
                                if has_b:
                                    bmatch[j] = _copy_match_path(bmatch[j], kmath)
                        elif jpath.aepos > kpath.aepos:
                            if has_b:
                                if cm:
                                    dist, bwhen = entwine(jmath, kmath, spacing)
                                    if dist != 0:
                                        continue
                                    fusion(kpath, awhen, jpath, spacing)
                                    amatch[j] = _copy_match_path(amatch[j], kpath)
                                    jpath = amatch[j].path
                                    fusion(jmath, bwhen, kmath, spacing)
                                else:
                                    dist, bwhen = entwine(kmath, jmath, spacing)
                                    if dist != 0:
                                        continue
                                    fusion(kpath, awhen, jpath, spacing)
                                    amatch[j] = _copy_match_path(amatch[j], kpath)
                                    jpath = amatch[j].path
                                    fusion(kmath, bwhen, jmath, spacing)
                                    bmatch[j] = _copy_match_path(bmatch[j], kmath)
                            else:
                                fusion(kpath, awhen, jpath, spacing)
                                amatch[j] = _copy_match_path(amatch[j], kpath)
                                jpath = amatch[j].path
                        else:
                            amatch[j] = _copy_match_path(amatch[j], kpath)
                            jpath = amatch[j].path
                            if has_b:
                                bmatch[j] = _copy_match_path(bmatch[j], kmath)
                        kpath.abpos = -1
                        break

    out_a, out_b = [], []
    for j in range(novls):
        if amatch[j].path.abpos >= 0:
            out_a.append(amatch[j])
            if has_b:
                out_b.append(bmatch[j])
    return out_a, (out_b if has_b else None)


def _copy_path(p: PathRec) -> PathRec:
    return PathRec(p.abpos, p.bbpos, p.aepos, p.bepos, p.diffs, list(p.trace))


def _copy_match(m: _Match) -> _Match:
    return _Match(m.aread, m.bread, m.flags, _copy_path(m.path))


def _copy_match_path(m: _Match, p: PathRec) -> _Match:
    """*jpath = *kpath (struct copy of the path only; flags/ids keep j's)."""
    return _Match(m.aread, m.bread, m.flags, _copy_path(p))


class Reporter:
    """Drives alignment + selection for each read (report_thread
    map.c:2362-2871)."""

    def __init__(self, spec, kmer: int, spacing: int, best_tie: float,
                 do_a=True, do_b=False, engine=None):
        self.spec = spec
        self.kmer = kmer
        self.spacing = spacing
        self.best_tie = best_tie
        self.do_a = do_a
        self.do_b = do_b
        self.small = spacing <= TRACE_XOVR
        self.hithr = HITMIN * kmer
        self.engine = engine   # ops.wave_engine.WaveEngine, or None: oracle

    def run(self, reads_db, ref_db, state, astart: int = 0, profile_out=None):
        """Returns (a_records, b_records) lists of LA.

        reads_db: loaded reads block; ref_db: loaded FULL reference DB;
        state: ChainState with candidates; astart: global index of the block's
        first read (tfirst).

        Spans (utils.spans): the batched alignment's, then
        "reporter.select" (collation and selection of every read; with no
        engine, each read's alignment too) and "reporter.profile" (the -p
        values, which selection does not touch)."""
        a_out: list[LA] = []
        b_out: list[LA] = []
        if self.engine is not None:
            per_read = self._align_block_batched(reads_db, ref_db, state)
        else:
            per_read = None
        with spans.span("reporter.select"):
            for ar in range(reads_db.nreads):
                if per_read is None:
                    amatch, bmatch = self._align_read(ar, reads_db, ref_db,
                                                      state)
                else:
                    amatch, bmatch = self._collate_read(ar, per_read[ar],
                                                        state)
                self._select(ar + astart, amatch, bmatch, a_out, b_out)
        if profile_out is not None:
            with spans.span("reporter.profile"):
                for ar in range(reads_db.nreads):
                    c = np.cumsum(state.cover[ar])
                    profile_out.append(np.array(
                        [special_log(int(x)) for x in c], dtype=np.uint8))
        return a_out, b_out

    # -- alignment of all candidates of one read ------------------------------

    def _align_read(self, ar: int, reads_db, ref_db, state):
        alen = int(reads_db.reads["rlen"][ar])
        aseq = reads_db.read_seq(ar)
        acomp = None

        amatch: list[_Match] = []
        bmatch: list[_Match] = [] if self.do_b else None
        lovl = 0

        cands = state.cands[ar]
        for ci, cand in enumerate(cands):
            br = cand.bread
            cm = cand.comp
            blen = int(ref_db.reads["rlen"][br])
            bseq = ref_db.read_seq(br)
            if cm:
                if acomp is None:
                    from ..io.db import complement_numeric
                    acomp = complement_numeric(aseq)
                a_use = acomp
                flags = ACOMP_FLAG
            else:
                a_use = aseq
                flags = 0

            apos, bpos = cand.alast, cand.blast
            alast = alen + 1
            for (adisp, bdisp) in cand.jumps:
                apos -= adisp
                bpos -= bdisp
                if apos < alast:
                    if cm:
                        ac = alen - apos
                        bc = blen - bpos
                        dg, ad = ac - bc, ac + bc
                    else:
                        dg, ad = apos - bpos, apos + bpos
                    apath, bpath = local_alignment(a_use, bseq, self.spec,
                                                   dg, dg, ad, -1, -1, flags)
                    if apath.aepos - apath.abpos >= self.hithr:
                        alast = apath.abpos
                        amatch.append(_Match(ar, br, COMP_FLAG if cm else 0,
                                             apath))
                        if self.do_b:
                            bmatch.append(_Match(br, ar,
                                                 COMP_FLAG if cm else 0,
                                                 bpath))

            nxt = cands[ci + 1] if ci + 1 < len(cands) else None
            if nxt is None or nxt.bread != br or nxt.comp != cm:
                amatch, bmatch = self._flush_group(amatch, bmatch, lovl, cm)
                lovl = len(amatch)

        return amatch, bmatch

    def _flush_group(self, amatch, bmatch, lovl, cm):
        """Dedup + order one finished (bread, comp) run (map.c:2589-2606)."""
        seg_a = amatch[lovl:]
        seg_b = bmatch[lovl:] if self.do_b else None
        if len(seg_a) > 1:
            seg_a, seg_b = handle_redundancies(seg_a, seg_b,
                                               self.spacing, cm)
        if len(seg_a) > 1:
            order = sorted(range(len(seg_a)),
                           key=lambda i: (-seg_a[i].path.abpos, -i))
            seg_a = [seg_a[i] for i in order]
            if self.do_b:
                if cm:
                    order_b = sorted(range(len(seg_b)),
                                     key=lambda i: (seg_b[i].path.bepos, -i))
                else:
                    order_b = sorted(range(len(seg_b)),
                                     key=lambda i: (-seg_b[i].path.bbpos, -i))
                seg_b = [seg_b[i] for i in order_b]
        amatch = amatch[:lovl] + seg_a
        if self.do_b:
            bmatch = bmatch[:lovl] + seg_b
        return amatch, bmatch

    # -- batched block alignment on the device engine -------------------------

    def _align_block_batched(self, reads_db, ref_db, state):
        """Align every candidate of every read with the batched wave engine.

        Candidates are independent; seeds within one candidate are sequential
        (each successful LA moves the not-yet-covered boundary `alast`,
        map.c:2487-2576), so alignment proceeds in rounds: one pending seed
        per live candidate per round, batched across the whole block.

        The A side ([reads | comp reads]) and B side (reference) upload
        SEPARATELY: the reference section is identical for every read
        block of a job list, so its upload is served from a process-level
        cache (_ref_seq_cache) instead of being re-shipped per block (the
        upload analog of the ref-index cache).

        Spans: "reporter.upload", "reporter.tasks", then one
        "reporter.round" a round (the engine's spans inside it)."""
        nreads = reads_db.nreads
        with spans.span("reporter.upload"):
            flat_a, comp_off, boffs, rlens = align_memory_a(reads_db)
            ref_seq = ref_db.seq
            dev_a = _upload_section(flat_a, boffs, rlens, self.engine.device)
            dev_b = _ref_seq_cached(ref_db, self.engine.device)

        with spans.span("reporter.tasks"):
            tasks = []
            per_read = [[] for _ in range(nreads)]
            for ar in range(nreads):
                alen = int(reads_db.reads["rlen"][ar])
                aboff = int(reads_db.reads["boff"][ar])
                for ci, cand in enumerate(state.cands[ar]):
                    blen = int(ref_db.reads["rlen"][cand.bread])
                    bboff = int(ref_db.reads["boff"][cand.bread])
                    t = dict(ar=ar, ci=ci, cand=cand, alen=alen, blen=blen,
                             abase=(comp_off + aboff) if cand.comp else aboff,
                             bbase=bboff,
                             pos=0, apos=cand.alast, bpos=cand.blast,
                             alast=alen + 1, results=[])
                    tasks.append(t)
                    per_read[ar].append(t)

        active = tasks
        while active:
            with spans.span("reporter.round"):
                active = self._round(active, dev_a, dev_b, flat_a, ref_seq)
        return per_read

    def _round(self, active, dev_a, dev_b, flat_a, ref_seq) -> list:
        """One round: the next seed of every live task, aligned in one
        engine batch and folded into the tasks; returns the tasks still
        live."""
        seeds = []
        run_tasks = []
        nxt_active = []
        for t in active:
            jumps = t["cand"].jumps
            found = False
            while t["pos"] < len(jumps):
                adisp, bdisp = jumps[t["pos"]]
                t["pos"] += 1
                t["apos"] -= adisp
                t["bpos"] -= bdisp
                if t["apos"] < t["alast"]:
                    found = True
                    break
            if not found:
                continue
            if t["cand"].comp:
                ac = t["alen"] - t["apos"]
                bc = t["blen"] - t["bpos"]
                dg, ad = ac - bc, ac + bc
                fl = ACOMP_FLAG
            else:
                dg, ad = t["apos"] - t["bpos"], t["apos"] + t["bpos"]
                fl = 0
            seeds.append(dict(abase=t["abase"], alen=t["alen"],
                              bbase=t["bbase"], blen=t["blen"],
                              diag=dg, anti=ad, flags=fl))
            run_tasks.append(t)
        if not run_tasks:
            return []
        results = self.engine.local_alignment_batch(
            dev_a, dev_b, flat_a, ref_seq, seeds)
        for t, (apath, bpath) in zip(run_tasks, results):
            if apath.aepos - apath.abpos >= self.hithr:
                t["alast"] = apath.abpos
                t["results"].append((apath, bpath))
            nxt_active.append(t)
        return nxt_active

    def _collate_read(self, ar, read_tasks, state):
        """Assemble a read's batched results in candidate order and apply the
        per-(bread,comp)-group dedup, mirroring the sequential path."""
        amatch: list[_Match] = []
        bmatch: list[_Match] = [] if self.do_b else None
        lovl = 0
        cands = state.cands[ar]
        for ci, t in enumerate(read_tasks):
            cand = t["cand"]
            cm = cand.comp
            for (apath, bpath) in t["results"]:
                amatch.append(_Match(ar, cand.bread,
                                     COMP_FLAG if cm else 0, apath))
                if self.do_b:
                    bmatch.append(_Match(cand.bread, ar,
                                         COMP_FLAG if cm else 0, bpath))
            nxt = cands[ci + 1] if ci + 1 < len(cands) else None
            if nxt is None or nxt.bread != cand.bread or nxt.comp != cm:
                amatch, bmatch = self._flush_group(amatch, bmatch, lovl, cm)
                lovl = len(amatch)
        return amatch, bmatch

    # -- chain graph + zone selection (map.c:2630-2816) ----------------------

    def _select(self, aread_global: int, amatch, bmatch, a_out, b_out):
        novl = len(amatch)
        if novl == 0:
            return
        score = [0] * novl
        link = [-1] * novl
        mark = [1] * novl

        score[0] = int((amatch[0].path.aepos - amatch[0].path.abpos)
                       - DIFF_SCORE * amatch[0].path.diffs)
        br = amatch[0].bread
        lovl = 0
        for c in range(1, novl):
            cpath = amatch[c].path
            score[c] = int((cpath.aepos - cpath.abpos)
                           - DIFF_SCORE * cpath.diffs)
            if amatch[c].bread != br:
                br = amatch[c].bread
                lovl = c
                continue
            cor = amatch[c].flags & COMP_FLAG
            for d in range(c - 1, lovl - 1, -1):
                dor = amatch[d].flags & COMP_FLAG
                if dor != cor:
                    continue
                dpath = amatch[d].path
                if dor:
                    if dpath.bepos < cpath.bepos:
                        continue
                else:
                    if dpath.bbpos < cpath.bbpos:
                        continue
                if dpath.abpos <= cpath.aepos - CHAIN_OVL or \
                   dpath.bbpos <= cpath.bepos - CHAIN_OVL:
                    continue
                rat = ((dpath.abpos - cpath.aepos + CHAIN_OFF)
                       / (dpath.bbpos - cpath.bepos + CHAIN_OFF))
                if 1. > rat * CHAIN_PLAY or rat > CHAIN_PLAY:
                    continue
                scr = int(score[d] + (cpath.aepos - cpath.abpos)
                          - DIFF_SCORE * cpath.diffs)
                scr2 = score[c]
                if scr < scr2 - TIE_SCORE:
                    continue
                if scr <= scr2 + TIE_SCORE:
                    gap = dpath.abpos - cpath.aepos
                    if link[c] >= 0:
                        gap2 = amatch[link[c]].path.aepos - dpath.abpos
                    else:
                        gap2 = 0
                    if gap > gap2 + TIE_GAP:
                        continue
                    if gap >= gap2 - TIE_GAP:
                        if scr < scr2:
                            continue
                        if scr == scr2 and gap >= gap2:
                            continue
                link[c] = d
                score[c] = scr
                mark[d] = 0

        perm = sorted(range(novl), key=lambda c: -score[c])   # stable

        parts: list[list] = []   # [beg, end, top]
        for c in perm:
            if score[c] < 0:
                break
            if mark[c] != 1:
                continue
            b = e = c
            p = link[b]
            while p >= 0 and mark[p] >= 0:
                e = p
                p = link[p]

            for pi, part in enumerate(parts):
                if amatch[b].path.abpos < part[1] - 100 and \
                   amatch[e].path.aepos > part[0] + 100:
                    break
            else:
                pi = len(parts)
            if pi >= len(parts):
                parts.append([amatch[b].path.abpos, amatch[e].path.aepos,
                              score[b]])
                best = True
            else:
                if score[b] < self.best_tie * parts[pi][2]:
                    continue
                best = (score[b] == parts[pi][2])

            # emit the chain
            q_rev = []
            p = b
            while True:
                mark[p] = -1
                if self.do_a:
                    a_out.append(self._to_la(amatch[p], aread_global,
                                             start=(p == b), best=best,
                                             a_side=True))
                n = link[p]
                if self.do_b:
                    if bmatch[p].flags & COMP_FLAG:
                        q_rev.append(p)
                    else:
                        b_out.append(self._to_la(bmatch[p], aread_global,
                                                 start=(p == b), best=best,
                                                 a_side=False))
                if p == e:
                    break
                p = n
            if self.do_b and q_rev:
                # complemented b-chains come out in reverse order
                # (map.c:2759-2815)
                q_rev.reverse()
                for idx, p in enumerate(q_rev):
                    b_out.append(self._to_la(bmatch[p], aread_global,
                                             start=(idx == 0), best=best,
                                             a_side=False))

    def _to_la(self, m: _Match, aread_global: int, start: bool, best: bool,
               a_side: bool) -> LA:
        p = m.path
        flags = m.flags
        if start:
            flags |= START_FLAG
            if best:
                flags |= BEST_FLAG
        else:
            flags |= NEXT_FLAG
        trace = np.array(p.trace, np.int32)
        if self.small and trace.size and trace.max() > 255:
            raise ValueError("Compression of trace to bytes fails, value too "
                             "big")
        if a_side:
            return LA(aread=aread_global, bread=m.bread, flags=flags,
                      abpos=p.abpos, aepos=p.aepos, bbpos=p.bbpos,
                      bepos=p.bepos, diffs=p.diffs, trace=trace)
        return LA(aread=m.aread, bread=aread_global, flags=flags,
                  abpos=p.abpos, aepos=p.aepos, bbpos=p.bbpos,
                  bepos=p.bepos, diffs=p.diffs, trace=trace)


_SPOW = [10.0 ** (m / 10.0) for m in range(41)]


def special_log(cover: int) -> int:
    """Log-bucketed coverage value, cap 40 (special_log map.c:2270-2302)."""
    if cover <= 1:
        return cover
    if cover >= 10000:
        return 40
    lo, hi = 0, 41
    while lo < hi:
        m = (lo + hi) >> 1
        if _SPOW[m] <= cover:
            lo = m + 1
        else:
            hi = m
    return lo - 1
