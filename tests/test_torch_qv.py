"""The port's QV codec (damapper_tpu_torch.io.qv) against damapper_tpu.io.qv
on the same streams, tolerance 0 (bytes): the cases of tests/test_qv.py,
each encoded by both modules with the port's bytes (schemes, bit streams,
coding blocks, .qvs files) equal to JAX's, and the port decoding them
back to the input."""

import dataclasses
import io

import numpy as np
import pytest

from damapper_tpu.io import qv as JQ
from damapper_tpu_torch.io import qv as TQ
from tests.test_qv import sim_entry


def _same_scheme(j, t):
    assert t.type == j.type
    assert np.array_equal(t.codebits, j.codebits)
    assert np.array_equal(t.codelens, j.codelens)
    assert np.array_equal(t.lookup, j.lookup)


def _hist(data):
    hist = np.zeros(256, np.int64)
    np.add.at(hist, data, 1)
    return hist


def _encoded(Q, hist, data):
    s = Q.make_scheme(hist)
    w = Q.BitWriter()
    Q.encode(s, data, w)
    return s, w.finish()


def test_bitstream_equal():
    rng = np.random.default_rng(0)
    data = rng.choice([3, 7, 7, 7, 12, 12, 200], 5000).astype(np.uint8)
    (js, jb), (ts, tb) = (_encoded(Q, _hist(data), data) for Q in (JQ, TQ))
    _same_scheme(js, ts)
    assert tb == jb
    got = TQ.decode(ts, TQ.BitReader(io.BytesIO(tb)), len(data))
    assert np.array_equal(got, data)


def test_escape_codes_equal():
    """A near-degenerate histogram forces codes past HUFF_CUTOFF and the
    255-escape path."""
    assert TQ.HUFF_CUTOFF == JQ.HUFF_CUTOFF
    rng = np.random.default_rng(1)
    hist = np.zeros(256, np.int64)
    for i in range(30):
        hist[i] = 1 << i
    hist[255] = 1
    data = rng.choice(np.arange(30), 2000).astype(np.uint8)
    data[100] = 255
    (js, jb), (ts, tb) = (_encoded(Q, hist, data) for Q in (JQ, TQ))
    assert ts.type == 2
    _same_scheme(js, ts)
    assert tb == jb
    got = TQ.decode(ts, TQ.BitReader(io.BytesIO(tb)), len(data))
    assert np.array_equal(got, data)


def test_run_encoding_equal():
    rng = np.random.default_rng(2)
    data = np.full(4000, 9, np.uint8)
    mask = rng.random(4000) < 0.1
    data[mask] = rng.integers(0, 30, mask.sum())
    data[1000:1400] = 9       # a run past 255: the 16-bit escape
    hist = _hist(data[data != 9])
    hist[0] += 1
    run_hist = np.ones(256, np.int64)
    out = []
    for Q in (JQ, TQ):
        s, r = Q.make_scheme(hist), Q.make_scheme(run_hist)
        w = Q.BitWriter()
        Q.encode_run(s, r, data, 9, w)
        out.append((s, r, w.finish()))
    (js, jr, jb), (ts, tr, tb) = out
    _same_scheme(js, ts)
    _same_scheme(jr, tr)
    assert tb == jb
    got = TQ.decode_run(ts, tr, TQ.BitReader(io.BytesIO(tb)), len(data), 9)
    assert np.array_equal(got, data)


def _coding(Q, entries, **kw):
    sc = Q.QVScanner()
    for e in entries:
        sc.scan(*e)
    return sc.create(**kw)


def _same_coding(j, t):
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, JQ.HScheme):
            _same_scheme(a, b)
        else:
            assert b == a, f.name


@pytest.mark.parametrize("lossy", [False, True])
def test_entry_equal(lossy):
    rng = np.random.default_rng(3)
    entries = [sim_entry(rng, int(rng.integers(500, 3000)))
               for _ in range(20)]
    codings, raws = [], []
    for Q in (JQ, TQ):
        coding = _coding(Q, entries, lossy=lossy, prefix="@Sim")
        buf = io.BytesIO()
        offs = []
        for e in entries:
            offs.append(buf.tell())
            Q.compress_entry(buf, coding, *e, lossy=lossy)
        codings.append(coding)
        raws.append((offs, buf.getvalue()))
    _same_coding(*codings)
    assert raws[1] == raws[0]
    offs, raw = raws[1]
    buf = io.BytesIO(raw)
    for e, off in zip(entries, offs):
        buf.seek(off)
        got = TQ.uncompress_entry(buf, codings[1], len(e[0]))
        want = list(e)
        if lossy:
            want[2] = (e[2] >> 1) << 1
            want[3] = (e[3] >> 2) << 2
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_coding_serialization_equal(tmp_path):
    rng = np.random.default_rng(4)
    entries = [sim_entry(rng, 1500) for _ in range(10)]
    blobs = []
    for Q in (JQ, TQ):
        buf = io.BytesIO()
        Q.write_qvcoding(buf, _coding(Q, entries, prefix="@Movie/1"))
        blobs.append(buf.getvalue())
    assert blobs[1] == blobs[0]
    _same_coding(JQ.read_qvcoding(io.BytesIO(blobs[0])),
                 TQ.read_qvcoding(io.BytesIO(blobs[1])))


def test_qvs_track_equal(tmp_path):
    rng = np.random.default_rng(5)
    entries = [sim_entry(rng, int(rng.integers(800, 2500)))
               for _ in range(8)]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    joffs = JQ.write_qvs(str(tmp_path / "jax" / "reads"), entries)
    toffs = TQ.write_qvs(str(tmp_path / "torch" / "reads"), entries)
    assert toffs == joffs
    assert (tmp_path / "torch" / ".reads.qvs").read_bytes() == \
        (tmp_path / "jax" / ".reads.qvs").read_bytes()
    coding, fp = TQ.open_qvs(str(tmp_path / "torch" / "reads"))
    with fp:
        for e, off in zip(entries, toffs):
            got = TQ.load_qventry(fp, coding, off, len(e[0]))
            for g, w in zip(got, e):
                assert np.array_equal(g, w)
