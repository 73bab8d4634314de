"""The port's ProtoWIB processor against the benchmark's plain reference
(``tpgbench/reference/protowib``: the 12-bit decode, the FIR+IQR hit finder
and the WIB TP handler, written in plain PyTorch apart from the port) on
the CPU: ten ``WIBFrameProcessor``-style links cut to two, three batches of
64 superchunks, on the time2 and packed feeds, with the kernels' plain
versions.  TPSets, dropped and suppressed counts and the state rows are
equal; a fault planted in either side reads non-zero; the reference's own
pieces hold against frames packed and states worked by hand.  The
handler suppresses a TP only when it is longer than its timeout: each TP
is judged at the end of the superchunk its hit closed in, as upstream's
one handler call a superchunk judges it."""

import functools
from collections import Counter

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu_torch.formats import protowib
from fdreadoutlibs_tpu_torch.ops.tpg import unpack_state
from fdreadoutlibs_tpu_torch.stream import WIBFrameProcessor
from fdreadoutlibs_tpu_torch.testing import protowib_superchunks
from fdreadoutlibs_tpu_torch.tp.wib_tp_handler import WIBTPHandler
from tpgbench.reference.protowib import fir_iqr, frames, wib_tpsets

torch.set_num_threads(1)

L, SC, BATCHES = 2, 64, 3
T = SC * protowib.FRAMES_PER_SUPERCHUNK
TC = 256
TIMEOUT, WINDOW = 10000, 6400
MIN_COLL, MIN_IND = 9472, 7680
CASES = {"nominal": {}, "caps": {"tpg_k_slots": 1, "tpg_max_hits": 6},
         "gap": {}}
# the reference's state fields by the port's state names
STATE_NAMES = {"pedestal": "pedestals", "accum": "accum",
               "prev_over": "prev_was_over", "charge": "hit_charge",
               "tover": "hit_tover", "q25": "quantile25",
               "q75": "quantile75", "accum25": "accum25",
               "accum75": "accum75", "ring": "fir_prev"}
# (link, register position, first tick, ticks): saturating pulses longer
# than the handler's timeout of 400 ticks, one inside batch 0 and one
# closing in batch 1, whose TPs the handler suppresses
LONG_PULSES = ((1, 20, 100, 500), (0, 150, 700, 550))


class Sink:
    """A handler's TPSet sink: keeps what it is sent until drained."""

    def __init__(self):
        self.sets = []

    def try_send(self, tpset) -> bool:
        self.sets.append(tpset)
        return True

    def drain(self) -> list:
        out, self.sets = self.sets, []
        return out


def tpset_of(s) -> dict:
    """A program TPSet -> the reference's dict form."""
    return {"seqno": int(s.seqno), "type": int(s.type),
            "origin": int(s.origin), "run_number": int(s.run_number),
            "start_time": int(s.start_time), "end_time": int(s.end_time),
            "objects": {f: s.objects[f].astype(np.int64)
                        for f in wib_tpsets.TP_FIELDS}}


def records(tps: dict) -> Counter:
    return Counter(zip(*(np.asarray(tps[f]).tolist()
                         for f in wib_tpsets.TP_FIELDS)))


def tpsets_differing(prog: list, ref: list) -> int:
    """Records differing between one batch's TPSets, link by link: a set
    on one side only counts one and its TPs; a set on both its differing
    header fields and its TPs in one and not the other."""
    n = 0
    for p_sets, r_sets in zip(prog, ref):
        p = {s["seqno"]: s for s in p_sets}
        r = {s["seqno"]: s for s in r_sets}
        for seqno in p.keys() | r.keys():
            a, b = p.get(seqno), r.get(seqno)
            if a is None or b is None:
                n += 1 + len((a or b)["objects"]["time_start"])
                continue
            n += sum(a[k] != b[k] for k in ("type", "origin", "run_number",
                                            "start_time", "end_time"))
            ca, cb = records(a["objects"]), records(b["objects"])
            n += sum(((ca - cb) + (cb - ca)).values())
    return n


def states_differing(prog: dict, ref: dict) -> int:
    return sum(int((torch.as_tensor(prog[f]) != ref[f]).sum())
               for f in STATE_NAMES)


@functools.lru_cache(maxsize=None)
def stream(case: str):
    """Three batches of (L, 64, 5568) superchunks; ``caps`` adds a burst of
    closes inside one chunk and busy batches, ``gap`` skips one superchunk
    before batch 1."""
    sc, adcs = protowib_superchunks(L, BATCHES * SC, seed=2300 + len(case),
                                    n_pulses=160 if case == "caps" else None)
    order = np.concatenate([protowib.COLLECTION_INDEX_TO_CHAN,
                            protowib.INDUCTION_INDEX_TO_CHAN])
    for link, pos, t0, n in LONG_PULSES:
        adcs[link, t0:t0 + n, int(order[pos])] += 2500
    if case == "caps":
        chan = int(protowib.COLLECTION_INDEX_TO_CHAN[7])
        for t in (300, 330, 360, 390):
            adcs[0, t:t + 6, chan] += 2500
    adcs = np.clip(adcs, 0, (1 << protowib.ADC_BITS) - 1)
    for link in range(L):
        protowib.set_adcs(protowib.superchunk_frames(sc[link]),
                          adcs[link].reshape(BATCHES * SC, 12, 256))
    if case == "gap":
        flat = protowib.superchunk_frames(sc).reshape(L, -1, 464)
        for link in range(L):
            later = flat[link, T:]
            protowib.set_timestamp(later, protowib.get_timestamp(later)
                                   + protowib.SUPERCHUNK_TICK_DIFFERENCE)
    return [np.ascontiguousarray(sc[:, b * SC:(b + 1) * SC])
            for b in range(BATCHES)]


@functools.lru_cache(maxsize=None)
def program(feed: str, case: str):
    """The processors' TPSets, dropped and suppressed counts per batch, and
    the state after the last batch, in the reference's forms."""
    sinks = [Sink() for _ in range(L)]
    procs = []
    for link in range(L):
        p = WIBFrameProcessor(tp_handler=WIBTPHandler(
            tpset_sink=sinks[link], source_id=link), device="cpu")
        p.conf({"enable_tpg": True, "tpg_backend": "pallas", "link_id": link,
                "tpg_time2_feed": feed == "time2", **CASES[case]})
        p.start()
        procs.append(p)
    def counts():
        return np.array([[p.tpg_counts["num_hits_dropped_collection"],
                          p.tpg_counts["num_hits_dropped_induction"],
                          p.metrics.count("num_tps_suppressed_too_long")]
                         for p in procs])
    out = {"sets": {}, "dropped": {}, "suppressed": {}}
    for b, batch in enumerate(stream(case)):
        before = counts()
        for link, p in enumerate(procs):
            p.process(batch[link].copy())
        delta = counts() - before
        out["dropped"][b] = delta[:, :2]
        out["suppressed"][b] = delta[:, 2]
        out["sets"][b] = [[tpset_of(s) for s in sink.drain()]
                          for sink in sinks]
    out["state"] = [state_of(p._coll_stack, p._ind_stack) for p in procs]
    return out


def state_of(coll, ind) -> dict:
    """Both planes' state rows in the reference's names and layout:
    collection positions, then induction."""
    st = unpack_state(torch.cat([coll, ind], dim=1))
    return {f: st[name] for f, name in STATE_NAMES.items()}


def reference(case: str, *, taps=None, flip=None, batch_end=False):
    """The plain reference over the same superchunks; ``flip`` (link, tick,
    channel, bit) flips one sample bit of the decoded stream; ``batch_end``
    judges every TP at its batch's end, not at its superchunk's."""
    conf = CASES[case]
    k_slots = conf.get("tpg_k_slots", 4)
    batches = stream(case)
    order = frames.register_channels()
    raw = [torch.from_numpy(b).view(L, -1, frames.FRAME_BYTES)
           for b in batches]
    adcs = torch.cat([frames.decode(r)[..., order] for r in raw], dim=1)
    if flip is not None:
        link, tick, chan, bit = flip
        adcs[link, tick, chan] ^= 1 << bit
    x = adcs.permute(1, 0, 2).reshape(BATCHES * T, L * frames.CHANNELS)
    thresholds = torch.full((L * frames.CHANNELS,), 5, dtype=torch.int32)
    closes, nclose, end = fir_iqr.run(x, fir_iqr.seed_state(x[0]),
                                      thresholds, tc=TC, k_slots=k_slots,
                                      taps=taps)
    offline = frames.offline_channels(MIN_COLL, MIN_IND)
    handlers = [wib_tpsets.Handler(TIMEOUT, WINDOW, link)
                for link in range(L)]
    out = {"sets": {}, "dropped": {}, "suppressed": {}}
    for b in range(BATCHES):
        ts0 = int(frames.timestamps(raw[b][:, 0])[0])
        now = ts0 + frames.CLOCKS_PER_TICK * T
        out["dropped"][b] = np.zeros((L, 2), dtype=np.int64)
        out["suppressed"][b] = np.zeros(L, dtype=np.int64)
        for link in range(L):
            base = link * frames.CHANNELS
            for plane, (lo, hi) in enumerate(((0, 96), (96, 256))):
                cap = conf.get("tpg_max_hits", max(2048, 2 * (hi - lo)))
                hits, out["dropped"][b][link, plane] = fir_iqr.batch_hits(
                    closes, nclose, ticks=slice(b * T, (b + 1) * T),
                    channels=slice(base + lo, base + hi), tc=TC,
                    k_slots=k_slots, max_hits=cap)
                tps = wib_tpsets.assemble(hits, ts0, offline[plane], link)
                at = now if batch_end else wib_tpsets.judged_at(tps, ts0)
                out["suppressed"][b][link] += handlers[link].insert(tps, at)
        out["sets"][b] = [h.send(now) for h in handlers]
    out["state"] = [{f: v[..., link * 256:(link + 1) * 256]
                     for f, v in end.items()} for link in range(L)]
    return out


def readings(prog: dict, ref: dict) -> dict:
    return {
        "tpset_records_differing": sum(
            tpsets_differing(prog["sets"][b], ref["sets"][b])
            for b in range(BATCHES)),
        "dropped_differing": sum(
            int(np.abs(prog["dropped"][b] - ref["dropped"][b]).sum())
            for b in range(BATCHES)),
        "tps_suppressed_differing": sum(
            int(np.abs(prog["suppressed"][b] - ref["suppressed"][b]).sum())
            for b in range(BATCHES)),
        "state_words_differing": sum(
            states_differing(p, r)
            for p, r in zip(prog["state"], ref["state"]))}


MATCH = [(feed, case) for case in CASES for feed in ("time2", "packed")]


@pytest.mark.parametrize("feed,case", MATCH,
                         ids=[f"{f}-{c}" for f, c in MATCH])
def test_processor_matches_the_plain_reference(feed, case):
    prog, ref = program(feed, case), reference(case)
    assert readings(prog, ref) == dict.fromkeys(
        ("tpset_records_differing", "dropped_differing",
         "tps_suppressed_differing", "state_words_differing"), 0)
    sets = sum(len(s) for b in range(BATCHES) for s in ref["sets"][b])
    tps = sum(len(s["objects"]["time_start"])
              for b in range(BATCHES) for link in ref["sets"][b]
              for s in link)
    assert sets > 0 and tps > 0
    # the two long pulses' TPs and no other, where no cap drops them
    suppressed = sum(int(v.sum()) for v in ref["suppressed"].values())
    if case != "caps":
        assert suppressed == len(LONG_PULSES)
    dropped = sum(int(v.sum()) for v in ref["dropped"].values())
    assert (dropped > 0) == (case == "caps")
    if case == "caps":
        # both the K slots of a chunk and the batch cap drop
        assert all(int(ref["dropped"][b].sum()) > 0 for b in range(BATCHES))


def _shifted_window(prog):
    sets = {b: [[dict(s) for s in link] for link in prog["sets"][b]]
            for b in prog["sets"]}
    b = next(b for b in sets if sets[b][0])
    sets[b][0][0]["start_time"] += 1
    return dict(prog, sets=sets)


FAULTS = {
    "flipped_sample_bit": (lambda prog: prog,
                           dict(flip=(1, BATCHES * T - 1, 100, 2))),
    "fir_tap_changed": (lambda prog: prog,
                        dict(taps=[1, 6, 15, 21, 15, 6, 1, 0])),
    "tp_window_shifted": (_shifted_window, {}),
    "tps_judged_at_the_batch_end": (lambda prog: prog,
                                    dict(batch_end=True)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_reads_nonzero(fault):
    change_prog, ref_kw = FAULTS[fault]
    prog = change_prog(program("time2", "nominal"))
    got = readings(prog, reference("nominal", **ref_kw))
    assert sum(got.values()) > 0, got


# ---- the reference's own pieces --------------------------------------------

def test_decode_reads_hand_packed_frames():
    """Segment 3 of block 2, chip 1, packed byte by byte: channel 0 =
    0x5A3, channel 1 = 0x7C4 (pair 0), channel 2 = 0x001, channel 3 =
    0xFFF (pair 1); the header's timestamp and error bits by hand."""
    frame = np.zeros(frames.FRAME_BYTES, dtype=np.uint8)
    seg = frames.HEADER_BYTES + 2 * frames.BLOCK_BYTES \
        + frames.BLOCK_HEADER_BYTES + 3 * frames.SEGMENT_BYTES
    a = 1
    frame[seg + a] = 0xA3                 # ch0 bits 0-7
    frame[seg + 2 + a] = 0x45             # ch0 bits 8-11 | ch1 bits 0-3
    frame[seg + 4 + a] = 0x7C             # ch1 bits 4-11
    frame[seg + 6 + a] = 0x01             # ch2 bits 0-7
    frame[seg + 8 + a] = 0xF0             # ch2 bits 8-11 | ch3 bits 0-3
    frame[seg + 10 + a] = 0xFF            # ch3 bits 4-11
    frame[4:8] = [0, 0, 0x05, 0x80]       # word 1: errors 0x8005
    frame[8:12] = [0x78, 0x56, 0x34, 0x12]
    frame[12:16] = [0xCD, 0xAB, 0x03, 0x00]   # z clear: bits 48-62 = 3
    adcs = frames.decode(torch.from_numpy(frame))
    first = 2 * 64 + 3 * 8 + a * 4
    assert adcs[first:first + 4].tolist() == [0x5A3, 0x7C4, 0x001, 0xFFF]
    assert int(adcs.sum()) == 0x5A3 + 0x7C4 + 0x001 + 0xFFF
    t = torch.from_numpy(frame)
    assert int(frames.timestamps(t)) == (3 << 48) | (0xABCD << 32) \
        | 0x12345678
    assert int(frames.wib_errors(t)) == 0x8005
    frame[15] |= 0x80                     # z set: word 3 is a counter
    assert int(frames.timestamps(t)) == (0xABCD << 32) | 0x12345678
    # the port's codec packs what the reference reads
    x = np.random.default_rng(1).integers(0, 4096, (3, 256))
    f = protowib.empty_frames(3)
    protowib.set_adcs(f, x)
    assert frames.decode(torch.from_numpy(f)).tolist() == x.tolist()
    assert sorted(frames.COLLECTION_INDEX_TO_CHAN
                  + frames.INDUCTION_INDEX_TO_CHAN) == list(range(256))


def one_tick(state: dict, x: int, threshold: int = 5):
    st = {f: torch.tensor([v], dtype=torch.int32) for f, v in state.items()}
    st["ring"] = torch.zeros((8, 1), dtype=torch.int32)
    closes, nclose, end = fir_iqr.run(
        torch.tensor([[x]], dtype=torch.int32), st,
        torch.tensor([threshold], dtype=torch.int32), tc=1, k_slots=4)
    return {f: int(v[..., 0].reshape(-1)[-1]) for f, v in end.items()}


BASE = {"pedestal": 100, "accum": 10, "q25": 80, "q75": 120, "accum25": 0,
        "accum75": 10, "prev_over": 0, "charge": 0, "tover": 0}


def test_iqr_and_pedestal_worked_by_hand():
    # 130 > the pedestal 100: only the upper quantile steps; its
    # accumulator 10 + 1 passes 10, so q75 121 and a restart at 0; the
    # pedestal likewise 101; the capped sample 130 - 101 = 29 enters the
    # ring; sigma 41 gives the threshold 41 x 64 x 5 = 13120, the empty
    # ring filters to 0: not over
    end = one_tick(BASE, 130)
    assert (end["q25"], end["accum25"], end["q75"], end["accum75"]) == \
        (80, 0, 121, 0)
    assert (end["pedestal"], end["accum"]) == (101, 0)
    assert end["ring"] == 29 and end["tover"] == 0
    # 60 < 100: only the lower quantile's accumulator moves, by -1; the
    # pedestal's accumulator 10 - 1 = 9
    end = one_tick(BASE, 60)
    assert (end["q25"], end["accum25"], end["q75"], end["accum75"]) == \
        (80, -1, 120, 10)
    assert (end["pedestal"], end["accum"]) == (100, 9)
    assert end["ring"] == -40
    # a sample far above the cap: 4000 - 101 caps at 32767 >> 6 = 511
    assert one_tick(BASE, 4000)["ring"] == 511
    # sigma 200 caps at 102; at 6 sigma 102 x 64 x 6 = 39168 wraps to
    # -26368 in int16, so the empty ring's 0 is over the threshold
    wide = dict(BASE, q25=0, q75=200)
    assert one_tick(wide, 100, threshold=5)["tover"] == 0
    assert one_tick(wide, 100, threshold=6)["tover"] == 1


def test_firwin_taps_and_a_hit_by_hand():
    """DesignFIR's firwin(7, 0.1) x 64: 1.36, 5.74, 15.00, 19.80, ... rounds
    to the shipped taps; a step of 300 over a quiet channel opens a hit
    whose charge sums filt >> 6 while over."""
    assert fir_iqr.firwin_taps() == [1, 6, 15, 20, 15, 6, 1, 0]
    x = torch.full((40, 1), 100, dtype=torch.int32)
    x[10:18] += 300
    closes, nclose, end = fir_iqr.run(
        x, fir_iqr.seed_state(x[0]), torch.tensor([5], dtype=torch.int32),
        tc=40, k_slots=4)
    assert nclose.tolist() == [[1]]
    # the quantiles stay at 100 -/+ 20 but for the pulse's steps: sigma
    # about 40, threshold about 12800, reached once the filter holds
    # most of the pulse's 300 x 64
    s, filt = [], []
    for t in range(40):
        window = ([0] * 8 + s)[-8:]
        filt.append(sum(a * b for a, b in zip([1, 6, 15, 20, 15, 6, 1, 0],
                                              window)))
        s.append(min(int(x[t, 0]) - 100, 511))
    over = [f > 40 * 320 for f in filt]
    assert closes["end_tick"].tolist() == [over.index(False, over.index(True))]
    assert closes["tover"].tolist() == [sum(over)]
    assert closes["charge"].tolist() == [sum(f >> 6 for f, o in
                                             zip(filt, over) if o)]
