"""The port's SSP processor, the TP pass-through processor
(``stream/ssp.py``) and the variable-size payload adapter
(``formats/variable.py``) against the JAX package on the CPU: the same
frames or payloads, made by numpy from a seed, give the same timestamps,
counters, forwarded TPs and records (numpy, tolerance 0)."""

import numpy as np
import pytest

from fdreadoutlibs_tpu.formats import ssp as jssp
from fdreadoutlibs_tpu.formats import variable as jvariable
from fdreadoutlibs_tpu.formats.trigprim import TP_DTYPE
from fdreadoutlibs_tpu.stream import ssp as jstream_ssp
from fdreadoutlibs_tpu.stream.transport import QueueSender as JQueueSender
from fdreadoutlibs_tpu_torch import stream
from fdreadoutlibs_tpu_torch.formats import ssp, variable
from fdreadoutlibs_tpu_torch.stream.transport import QueueSender


def test_stream_package_exports_the_ssp_processors():
    from fdreadoutlibs_tpu_torch.stream import ssp as stream_ssp
    assert stream.SSPFrameProcessor is stream_ssp.SSPFrameProcessor
    assert stream.SWTriggerPrimitiveProcessor is \
        stream_ssp.SWTriggerPrimitiveProcessor


def test_ssp_processor_matches_jax():
    rng = np.random.default_rng(1)
    batches = []
    for b in range(3):
        frames = ssp.empty_frames(4)
        ssp.set_timestamp(frames, 1000 * b + np.sort(
            rng.integers(0, 1 << 40, size=4)))
        ssp.set_waveform(frames, rng.integers(0, 1 << 14, size=(4, 506),
                                              dtype=np.uint16))
        batches.append(frames)
    procs = [stream.SSPFrameProcessor(), jstream_ssp.SSPFrameProcessor()]
    for p in procs:
        p.conf({})
        p.start()
        for frames in batches:
            p.process(frames.copy())
    port, ref = procs
    assert port.previous_ts == ref.previous_ts == int(
        jssp.get_timestamp(batches[-1])[-1])
    assert port.last_processed_daq_ts == ref.last_processed_daq_ts
    assert port.metrics.count("num_payloads") == \
        ref.metrics.count("num_payloads") == 12


def test_tp_passthrough_matches_jax():
    rng = np.random.default_rng(2)
    tps = np.zeros(5, dtype=TP_DTYPE)
    tps["time_start"] = np.sort(rng.integers(0, 1 << 50, size=5))
    tps["channel"] = rng.integers(0, 2560, size=5)
    out = []
    for cls, sink in ((stream.SWTriggerPrimitiveProcessor, QueueSender()),
                      (jstream_ssp.SWTriggerPrimitiveProcessor,
                       JQueueSender())):
        p = cls(tp_sink=sink)
        p.conf({})
        p.start()
        p.process(tps[:3].copy())
        p.process(tps[:0].copy())
        p.process(tps[3:].copy())
        out.append((np.concatenate(sink.drain()), p.last_processed_daq_ts,
                    p.metrics.count("num_tps_forwarded")))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][0], tps)
    assert out[0][1:] == out[1][1:] == (int(tps["time_start"][-1]), 5)


def test_variable_payloads_match_jax():
    rng = np.random.default_rng(3)
    blobs = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
             for n in (0, 7, 64, 33)]
    ts = rng.integers(0, 1 << 60, size=len(blobs))
    port = [variable.VariableSizePayload(b, t) for b, t in zip(blobs, ts)]
    ref = [jvariable.VariableSizePayload(b, t) for b, t in zip(blobs, ts)]
    recs = variable.pack_batch(port, 64)
    jrecs = jvariable.pack_batch(ref, 64)
    assert recs.dtype == jrecs.dtype
    assert recs.tobytes() == jrecs.tobytes()
    back = variable.unpack_batch(recs)
    assert [(p.data, p.timestamp, p.size) for p in back] == \
        [(p.data, p.timestamp, p.size) for p in jvariable.unpack_batch(jrecs)]
    port[1].set_first_timestamp(5)
    assert port[1].get_first_timestamp() == 5
    for mod, payloads in ((variable, port), (jvariable, ref)):
        with pytest.raises(ValueError, match="exceeds max_size"):
            mod.pack_batch(payloads, 32)
