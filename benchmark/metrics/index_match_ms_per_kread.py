"""index_match_ms_per_kread: the device index and seed match
(ops/device_index.py), ``times["index"] + times["match"]`` summed over the
window's blocks, in ms a 1,000 reads.  Only their sum: nothing
synchronises between the two, so the index's asynchronous tail is charged
to the match."""


def read(w):
    t = w.stats["times"]
    return w.per_kread(t["index"] + t["match"])
