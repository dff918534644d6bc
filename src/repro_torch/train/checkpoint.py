"""Fault-tolerant checkpointing: async writes, checksums, atomic publish.

Counterpart of the reference package's ``train/checkpoint.py``, with its
on-disk format, so either package reads the other's checkpoints:

  * ``step_XXXXXXXX/`` holds one ``.npy`` file per leaf (the leaf's
    ``/``-joined keys, ``/`` written ``__``) and a ``manifest.json`` of
    each leaf's ``file``, ``shape``, ``dtype`` and ``crc32`` (over the
    array's bytes);
  * a checkpoint is written to ``step_XXXXXXXX.tmp/`` and published by
    an atomic rename, so a torn write is never listed and restore falls
    back to the previous one;
  * the writer runs on a background thread (training continues) on a
    private host copy of every leaf, taken before the thread starts, so
    the caller may update its tensors in place meanwhile; ``wait()``
    joins it before the next save or exit.

A bfloat16 leaf goes to disk as its 16-bit patterns under the header
NumPy writes for the reference's bfloat16 (``descr`` ``<V2``, a 2-byte
void), with ``"bfloat16"`` in the manifest: the files are the
reference's byte for byte, and no ``ml_dtypes`` is needed.  Restore puts
each leaf on the device of the matching leaf of ``like``, or, given
``shardings`` (a :func:`repro_torch.dist.sharding.shardings` tree),
distributes it as they say, on the mesh that saved it or another.  An
error of the writer thread is raised by the next ``wait()``.

A tree of DTensors is saved whole: every rank gathers each leaf (a
collective), rank 0 of the default group writes, and ``wait()`` ends in
a barrier, so no rank reads a checkpoint before it is published.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.dist.sharding import distribute, full, is_dtensor

from .tree import flatten, unflatten

Params = Any
BF16_DESCR = "<V2"


def to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A private host copy of ``t`` (``.cpu()`` of a card tensor already
    is one; a CPU tensor is cloned) and the dtype name its manifest
    records (a bfloat16 tensor as its int16 bit patterns)."""
    t = t.detach()
    if t.device.type == "cpu":
        t = t.clone(memory_format=torch.contiguous_format)
    else:
        t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")       # keeps a 0-d array 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _save(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.data)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.require(arr, requirements="C"))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._barrier = False

    # ------------------------------ save ------------------------------ #
    def save(self, step: int, tree: Params, blocking: bool = False) -> None:
        """Copy ``tree`` to the host now, and write it as checkpoint
        ``step`` on the writer thread."""
        self.wait()
        leaves = flatten(tree)
        flat = {k: to_numpy(full(v)) for k, v in leaves.items()}
        if any(is_dtensor(v) for v in leaves.values()):
            import torch.distributed as dist

            self._barrier = True
            if dist.get_rank() != 0:
                flat = None
        if flat is not None:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the writer; an error it met is raised here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist

            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, flat: dict) -> None:
        try:
            self._publish(step, flat)
        except BaseException as e:  # handed to wait() on the caller's thread
            self._error = e

    def _publish(self, step: int, flat: dict) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        manifest: dict = {"step": step, "leaves": {}}
        for key, (arr, dtype) in flat.items():
            fn = key.replace("/", "__") + ".npy"
            _save(os.path.join(tmp, fn), arr, dtype)
            manifest["leaves"][key] = {
                "file": fn,
                "shape": list(arr.shape),
                "dtype": dtype,
                "crc32": _crc(arr),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----------------------------- restore ---------------------------- #
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    self._valid(os.path.join(self.dir, d)):
                out.append(int(d[5:]))
        return sorted(out)

    def _valid(self, path: str) -> bool:
        mf = os.path.join(path, "manifest.json")
        if not os.path.exists(mf):
            return False
        try:
            with open(mf) as f:
                manifest = json.load(f)
            for meta in manifest["leaves"].values():
                if not os.path.exists(os.path.join(path, meta["file"])):
                    return False
            return True
        except (json.JSONDecodeError, KeyError):
            return False

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Params,
                shardings: Params | None = None,
                verify: bool = True) -> Params:
        """Checkpoint ``step`` as a tree shaped like ``like``, each leaf
        on the device of ``like``'s, and distributed by the matching
        leaf of ``shardings`` when given (every rank reads the files and
        keeps its own pieces); a leaf whose bytes do not match its
        manifest's crc32 raises ``OSError``."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        shard = flatten(shardings) if shardings is not None else {}
        out = {}
        for key, leaf in flatten(like).items():
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(path, meta["file"]))
            if verify and _crc(arr) != meta["crc32"]:
                raise OSError(f"checksum mismatch for {key} in {path}")
            dev = (leaf.to_local() if is_dtensor(leaf) else leaf).device
            t = from_numpy(arr, meta["dtype"]).to(dev)
            if key in shard:
                t = distribute(t, shard[key], src_data_rank=None)
            out[key] = t
        return unflatten(out)
