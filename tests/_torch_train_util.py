"""Shared set-up of the port's training tests: the reference's
parameters and batches carried across to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as JM
from repro_torch import convert
from repro_torch.train.tree import flatten


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny; with a thread per core in each of
    several test workers, PyTorch's CPU threads wait on one another and
    a 0.5 s run takes tens of seconds.  Import this into a test module
    to run its tests on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(arch: str, seed: int = 0, **replace):
    """(reduced config, the reference's params, the port's copy)."""
    import dataclasses

    cfg = dataclasses.replace(jget_config(arch).reduced(), **replace)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, jp, convert.lm_params(jax.tree.map(np.asarray, jp))


def loss_batch(cfg, b: int = 2, s: int = 16, seed: int = 0) -> dict:
    """A NumPy batch with labels that include -100 (pad): tokens, or
    the vision stub's embeds, plus an encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -100
    labels[-1, -1] = -100
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": labels}
    if cfg.frontend == "vision_stub":
        batch = {"embeds": (rng.normal(size=(b, s, cfg.d_model)) * 0.02
                            ).astype(np.float32), "labels": labels}
    if cfg.enc_dec:
        batch["enc_embeds"] = (rng.normal(size=(b, s, cfg.d_model)) * 0.02
                               ).astype(np.float32)
    return batch


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def flat_np(tree) -> dict:
    """A reference tree (JAX arrays) or a port tree (tensors) as
    ``{"a/b": ndarray}`` in the reference's leaf order."""
    return {k: _np(v) for k, v in flatten(tree).items()}


def _np(v) -> np.ndarray:
    """float32 and integer leaves as themselves; bf16 ones as their
    int16 bit patterns (from either package)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return (v.view(torch.int16) if v.dtype == torch.bfloat16
                else v).numpy()
    v = np.asarray(v)
    return v.view(np.int16) if v.dtype.name == "bfloat16" else v
