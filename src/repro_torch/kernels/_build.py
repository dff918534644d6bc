"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface, so ``nvcc`` builds
it in seconds (no PyTorch headers) into ``build/lib<name>-<hash>.so``
beside this package, at first use.  The file name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header never loads a stale library.
Importing this module needs no ``nvcc``: the build happens when a
kernel is first called on a CUDA tensor (or when :func:`build_all` is
called), and only then can it fail.

Every C entry point returns ``cudaGetLastError()`` right after its
launch; :func:`check` raises when that is not ``cudaSuccess``, because
a refused launch never runs and a later synchronise would not report
it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C entry points per source, with their argument types (every pointer
#: and the stream as ``c_void_p``, so no pointer is cut to 32 bits).
SIGNATURES = {
    "temporal_encode": {
        "temporal_encode_launch": [_P, _I, _I, _P, _P],
    },
    "fused_query": {
        "compound_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                            _P, _P, _P],
        "range_count_launch": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
        "leafbits_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
        "leafsum_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "clutch_merge": {
        "merge_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    },
    "bitserial_cmp": {
        "bitserial_launch": [_P, _I, _U, _I, _P, _P],
    },
    "leaf_gather": {
        "leaf_gather_launch": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    },
    "minp_mask": {
        "minp_mask_launch": [_P, _P, _I, _I, _F, _P, _P],
    },
    "rmsnorm": {
        "rmsnorm_launch": [_P, _P, _P, _L, _L, _I, _I, _F, _I, _I, _P],
    },
    "selective_scan": {
        "selective_scan_launch": [_P] * 5 + [_L] * 5 + [_P] * 6
        + [_I] * 5 + [_P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch cannot be built on this machine")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for one source unless its library is built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent builder is safe


def build_all() -> None:
    """Build every source at once, one ``nvcc`` per file in parallel."""
    jobs = {name: _start(name) for name in SIGNATURES}
    errors = []
    for name, job in jobs.items():
        try:
            _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
