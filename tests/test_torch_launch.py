"""The one-card parts of the reference's ``launch/``: ``apply_variant``,
the parameter accounting of ``launch/dryrun.py`` and the model FLOPs of
``launch/roofline.py``, against the reference's.

All exact: parameter counts of the ten full-size archs from the port's
meta-device tree (no weight allocated) against the reference's
``jax.eval_shape`` tree; configs field for field; integer and FLOP
arithmetic equal.
"""

import os

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.launch import roofline as JR
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.train.tree import flatten

from _torch_config_util import assert_same_fields


def _reference_dryrun():
    """The reference's ``launch/dryrun.py``, which sets ``XLA_FLAGS`` to
    512 host devices when imported: imported with JAX's backend already
    up (one device) and the environment put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_count_and_active_params_equal_the_reference(arch):
    JD = _reference_dryrun()
    tree = D.abstract_params(get_config(arch))
    leaves = flatten(tree)
    assert all(t.is_meta for t in leaves.values())
    jtree = JD.abstract_params(jget_config(arch))
    jleaves = flatten(jtree)
    assert list(leaves) == list(jleaves)
    for k, t in leaves.items():
        assert tuple(t.shape) == jleaves[k].shape, k
        assert str(t.dtype)[6:] == jleaves[k].dtype.name, k
    assert D.count_params(tree) == JD.count_params(jtree)
    assert D.active_params(get_config(arch), tree) == \
        JD.active_params(jget_config(arch), jtree)


def test_active_params_count_top_k_of_the_experts():
    cfg = get_config("granite-moe-3b-a800m")
    tree = D.abstract_params(cfg)
    expert = sum(t.numel() for k, t in flatten(tree).items()
                 if "/moe/w_" in k)
    assert expert > 0
    assert D.active_params(cfg, tree) == D.count_params(tree) - expert * (
        1 - cfg.moe.top_k / cfg.moe.num_experts)
    dense = get_config("minitron-8b")
    dense_tree = D.abstract_params(dense)
    assert D.active_params(dense, dense_tree) == D.count_params(dense_tree)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_apply_variant_equals_the_reference_for_every_shape(arch):
    JD = _reference_dryrun()
    for shape in [None, *SHAPES]:
        for variant in ("base", "opt"):
            got = D.apply_variant(get_config(arch), variant,
                                  SHAPES[shape] if shape else None)
            want = JD.apply_variant(jget_config(arch), variant,
                                    JD.SHAPES[shape] if shape else None)
            assert_same_fields(got, want)
    assert D.OPT_NOTES == JD.OPT_NOTES


def test_microbatches_for_equals_the_reference():
    JD = _reference_dryrun()
    for arch in ARCHS:
        for shape in SHAPES:
            for dp in (1, 2, 16, 32, 512):
                assert D.microbatches_for(get_config(arch), SHAPES[shape],
                                          dp) == \
                    JD.microbatches_for(jget_config(arch),
                                        JD.SHAPES[shape], dp)


def test_model_flops_equal_the_reference_on_the_h100_peaks():
    rng = np.random.default_rng(0)
    for n, tokens in zip(rng.uniform(1e6, 1e12, 20),
                         rng.integers(1, 1 << 20, 20)):
        assert R.model_flops_train(n, tokens) == \
            JR.model_flops_train(n, tokens)
        assert R.model_flops_decode(n, tokens) == \
            JR.model_flops_decode(n, tokens)
    assert (R.PEAK_FLOPS, R.HBM_BW) == (989e12, 3.35e12)
