"""The synthetic training data: the port's NumPy copy against the
reference's, batch for batch and bit for bit."""

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as JP
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM


def _pair(arch: str, seq: int, batch: int, seed: int, micro: int):
    ref = JP.SyntheticLM(jget_config(arch).reduced(),
                         JShapeConfig("t", seq, batch, "train"), seed=seed,
                         microbatches=micro)
    port = SyntheticLM(get_config(arch).reduced(),
                       ShapeConfig("t", seq, batch, "train"), seed=seed,
                       microbatches=micro)
    return ref, port


@pytest.mark.parametrize("arch", ["minitron-8b", "llava-next-34b",
                                  "whisper-base"])
@pytest.mark.parametrize("seed,micro", [(0, 1), (3, 2), (11, 4)])
def test_batches_equal_the_reference_bit_for_bit(arch, seed, micro):
    ref, port = _pair(arch, 24, 8, seed, micro)
    for step in (0, 1, 7, 123):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), (k, step)
    keys = sorted(port.batch_at(0))
    if arch == "llava-next-34b":
        assert keys == ["embeds", "labels"]
    elif arch == "whisper-base":
        assert keys == ["enc_embeds", "labels", "tokens"]
    else:
        assert keys == ["labels", "tokens"]


def test_prefetcher_yields_steps_in_order_from_its_start():
    _, port = _pair("minitron-8b", 16, 4, 0, 1)
    pf = Prefetcher(port, start_step=5, depth=2)
    try:
        for want in range(5, 12):
            step, batch = pf.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          port.batch_at(want)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_labels_follow_the_bigram_chain_but_for_the_noise():
    _, port = _pair("minitron-8b", 256, 16, 2, 1)
    b = port.batch_at(0)
    tok, lab = b["tokens"][0], b["labels"][0]
    np.testing.assert_array_equal(tok[:, 1:], lab[:, :-1])
    follows = (port._next[tok] == lab).mean()
    # 10 % of positions draw a random token (which may hit the chain)
    assert 0.85 < follows < 0.95, follows
