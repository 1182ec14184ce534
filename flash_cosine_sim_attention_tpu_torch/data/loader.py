"""Training data pipeline: random crops of a byte corpus, with a prefetch
thread.

Counterpart of ``flash_cosine_sim_attention_tpu/data/loader.py`` (copied,
not imported: that package is the reference and loads JAX).  A corpus
given as a path is sampled by the native C++ sampler of
``native/dataloader.cc``, compiled with ``g++`` into this package's
``build/`` directory at first use; where that build fails the Python
sampler takes the file, as in the JAX loader.  This fallback is on the
host only: it picks how crops are drawn, not where the model runs.  An
in-memory array always takes the Python sampler, whose crops equal the
JAX loader's for the same seed.
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import os
import queue
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "dataloader.cc"
_BUILD = Path(__file__).resolve().parents[1] / "build"


def _build_lib() -> Optional[Path]:
    """The native sampler's library, built from ``native/dataloader.cc``
    if missing; None when the source or the toolchain is absent."""
    if not _SRC.exists():
        return None
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    lib = _BUILD / f"libfcsa_data-{digest}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", str(_SRC), "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        os.unlink(tmp)
        print(f"native dataloader build failed ({e}); using python sampler")
        return None
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


class _NativeCorpus:
    def __init__(self, path: str):
        lib_path = _build_lib()
        if lib_path is None:
            raise RuntimeError("native loader unavailable")
        lib = ctypes.CDLL(str(lib_path))
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [ctypes.c_char_p]
        lib.dl_size.restype = ctypes.c_long
        lib.dl_size.argtypes = [ctypes.c_void_p]
        lib.dl_sample.restype = ctypes.c_int
        lib.dl_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.dl_close.argtypes = [ctypes.c_void_p]
        handle = lib.dl_open(path.encode())
        if not handle:
            raise RuntimeError(f"dl_open failed for {path}")
        self._lib, self._handle = lib, handle
        self.size = lib.dl_size(handle)

    def sample(self, start: int, end: int, batch: int, width: int,
               seed: int) -> np.ndarray:
        out = np.empty((batch, width), np.int32)
        rc = self._lib.dl_sample(
            self._handle, start, end, batch, width,
            seed & 0xFFFFFFFFFFFFFFFF, out)
        if rc != 0:
            raise ValueError("dl_sample: bad range")
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.dl_close(self._handle)


class _PythonCorpus:
    """Python sampler with the native one's semantics (another RNG stream)."""

    def __init__(self, data: np.ndarray):
        self._data = data
        self.size = len(data)

    def sample(self, start, end, batch, width, seed):
        rng = np.random.default_rng(seed)
        starts = rng.integers(start, end - width, size=batch)
        return np.stack(
            [self._data[s:s + width] for s in starts]).astype(np.int32)


class TextSampler:
    """Random-crop batch sampler over a train/valid byte-corpus split,
    with an N-deep background prefetch queue.  Batches are (batch,
    seq_len + 1) int32 numpy arrays."""

    def __init__(self, path_or_array, train_frac: float = 0.947,
                 seed: int = 0, prefetch: int = 2):
        if isinstance(path_or_array, str):
            try:
                self._c = _NativeCorpus(path_or_array)
                self.backend = "native"
            except RuntimeError:
                opener = gzip.open if path_or_array.endswith(".gz") else open
                with opener(path_or_array, "rb") as f:
                    data = np.frombuffer(f.read(), np.uint8)
                self._c = _PythonCorpus(data)
                self.backend = "python"
        else:
            self._c = _PythonCorpus(np.asarray(path_or_array, np.uint8))
            self.backend = "python"
        self._split = int(self._c.size * train_frac)
        self._seed = seed
        self._prefetch_depth = prefetch
        self._queues = {}
        self._threads = {}

    @property
    def size(self) -> int:
        return self._c.size

    def _range(self, split: str):
        return (0, self._split) if split == "train" else (
            self._split, self._c.size)

    def sample(self, split: str, batch: int, seq_len: int) -> np.ndarray:
        start, end = self._range(split)
        self._seed += 1
        return self._c.sample(start, end, batch, seq_len + 1, self._seed)

    def stream(self, split: str, batch: int, seq_len: int):
        """Generator backed by a background prefetch thread."""
        key = (split, batch, seq_len)
        if key not in self._queues:
            q: queue.Queue = queue.Queue(maxsize=self._prefetch_depth)
            self._queues[key] = q

            def worker():
                while True:
                    q.put(self.sample(split, batch, seq_len))

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            self._threads[key] = t
        q = self._queues[key]
        while True:
            yield q.get()


def synthetic_corpus(size: int = 8_000_000, seed: int = 0) -> np.ndarray:
    """The JAX trainer's stand-in corpus when enwik8 is absent
    (train.py:57-72): an order-1 Markov chain over a 30-letter alphabet,
    drawn byte by byte from numpy seed ``seed``.  The first ``size`` bytes
    equal the JAX trainer's for the same seed."""
    rng = np.random.default_rng(seed)
    vocab = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz .,\n", np.uint8)
    trans = rng.dirichlet(np.full(len(vocab), 0.1), size=len(vocab))
    cum = np.cumsum(trans, axis=1)
    u = rng.random(size)
    states = np.zeros(size, np.int64)
    st = 0
    for i in range(size):
        st = min(int(np.searchsorted(cum[st], u[i])), len(vocab) - 1)
        states[i] = st
    return vocab[states]
