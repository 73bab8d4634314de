"""The hand-written CUDA kernel against its plain version on the card, and
the APA app on the card against the same app on the CPU.  Marked ``cuda``:
each test skips where torch finds no card.  This file imports no JAX, so on
the machine with the card (which has none) run it without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu.ops.chanstate import init_chanstate, seed_chanstate
from fdreadoutlibs_tpu.ops.config import Algorithm, TPGConfig
from fdreadoutlibs_tpu_torch.apps.apa_readout import APAReadoutApp, make_batch
from fdreadoutlibs_tpu_torch.ops import tpg
from fdreadoutlibs_tpu_torch.testing import time2_words, tpg_stream

pytestmark = pytest.mark.cuda

CONFIGS = [
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=120),
    TPGConfig(algorithm=Algorithm.SIMPLE_THRESHOLD, threshold=-5,
              peak_gated=True),                  # charge floor + gated peak
    TPGConfig.from_raw("AbsRS", threshold=150),
    TPGConfig(algorithm=Algorithm.STANDARD_RS, threshold=150),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=["Simple", "Simple-gated-neg", "AbsRS",
                              "StandardRS"])
@pytest.mark.parametrize("C,stride", [(2560, 2560), (200, 256)])
def test_kernel_matches_plain(card, cfg, C, stride):
    T, tc, k = 1024, 256, 4
    adcs, rmf = tpg_stream(T, C, tc, k, seed=C)
    words = np.zeros((T // 2, stride), np.int32)
    words[:, :C] = time2_words(adcs)
    feed = torch.from_numpy(words).to(card)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C, device=card)
    before = tpg.process_window.launches
    got = tpg.process_window(feed, state, cfg, tc=tc, k_slots=k)
    assert tpg.process_window.launches == before + 1
    want = tpg.process_window_plain(feed, state, cfg, tc, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].max()) > k                  # drops exercised


def test_app_on_card_matches_cpu(card):
    rng = np.random.default_rng(4)
    batches = [make_batch(rng, 4, 16, b, 0x1000000 + b * 16 * 2048)[0]
               for b in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        app = APAReadoutApp(n_links=4, algorithm="AbsRS", threshold=150,
                            threshold_on_collection=True, time2_feed=True,
                            device=dev)
        fetched = []
        fetch = app._fetch_hits

        def recording_fetch(packed, fetch=fetch, fetched=fetched):
            fetched.append(fetch(packed))
            return fetched[-1]

        app._fetch_hits = recording_fetch
        for frames in batches:
            app.process_batch(frames.copy())
        out[dev] = (fetched, app.handler.buffer.snapshot())
    for (ha, da), (hb, db) in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(ha, hb)
        assert da == db
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
