"""ctypes bindings + batch loader for the native C++ input pipeline
(counterpart of `laudnet_tpu/data/native_loader.py`).

``data/csrc/loader.cpp`` decodes JPEGs (libjpeg) and runs the
PIL-compatible antialiased-bilinear RandomResizedCrop / center crop and the
normalisation for a whole batch across C++ threads in ONE Python call (no
per-image GIL round-trips). It is built with g++ at first use into
``data/csrc/_build/``; a machine without g++ or libjpeg's header has no
native library (`native_available` is false, `build_error` says why) and
the training CLI says it takes the PIL pipeline. A file the library cannot
decode (a PNG, a corrupt JPEG) goes through the PIL transform of
`data/transforms.py`, image by image, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from laudnet_tpu_torch.data.loader import batch_seeds, epoch_order, prefetched
from laudnet_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD,
                                               eval_transform, train_transform)

_CSRC = os.path.join(os.path.dirname(__file__), "csrc", "loader.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "csrc", "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libln_data.so")
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def build_native_lib(force: bool = False) -> Optional[str]:
    """Compile loader.cpp -> libln_data.so (cached by mtime). Returns the
    library path, or None if g++ or libjpeg is unavailable. The library is
    written under a temporary name and moved into place, so processes that
    build at once never load a half-written file."""
    global _build_error
    if (not force and os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_CSRC)):
        return _LIB_PATH
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _CSRC,
           "-o", tmp, "-ljpeg", "-lpthread"]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:  # no g++
            _build_error = str(e)
            return None
        if proc.returncode != 0:
            _build_error = proc.stderr[-2000:]
            return None
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _LIB_PATH


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            # the failure is cached: a retry would re-run a failing g++
            # compile under _lock on every batch
            return None
        path = build_native_lib()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.ln_load_batch.restype = ctypes.c_int
        lib.ln_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        lib.ln_decode.restype = ctypes.c_int
        lib.ln_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


def build_error() -> Optional[str]:
    return _build_error


def decode_image(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG to float32 HWC RGB in [0, 255] (testing hook)."""
    lib = _load_lib()
    if lib is None:
        return None
    cap = 64 * 1024 * 1024
    buf = np.empty(cap, np.float32)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.ln_decode(path.encode(), buf.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), cap, ctypes.byref(w),
        ctypes.byref(h))
    if rc != 0:
        return None
    return buf[: w.value * h.value * 3].reshape(h.value, w.value, 3).copy()


class NativeBatchTransform:
    """Batch-granular native decode + transform; the PIL transform for the
    images the library rejects.

    ``load(paths, seeds)`` returns a float32 (N, size, size, 3) array with
    the semantics of ``train_transform``/``eval_transform``; it raises
    where the library does not build (the JAX package's would run PIL on
    every image).
    """

    def __init__(self, size: int = 224, train: bool = True,
                 normalize: bool = True, crop_ratio: float = 0.875,
                 scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 num_threads: Optional[int] = None):
        self.size = size
        self.train = train
        self.normalize = normalize
        self.crop_ratio = crop_ratio
        self.scale = scale
        self.ratio = ratio
        self.num_threads = num_threads or min(16, os.cpu_count() or 4)
        self._mean = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
        self._std = np.ascontiguousarray(IMAGENET_STD, np.float32)
        self._fallback = (train_transform(size, normalize=normalize)
                          if train else
                          eval_transform(size, crop_ratio, normalize))

    def load(self, paths: Sequence[str],
             seeds: Sequence[int]) -> np.ndarray:
        n = len(paths)
        out = np.empty((n, self.size, self.size, 3), np.float32)
        ok = np.zeros(n, np.uint8)
        lib = _load_lib()
        if lib is None:
            # no silent PIL pipeline under the native one's name
            raise RuntimeError(f"the native loader does not build: "
                               f"{_build_error}")
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        c_seeds = np.ascontiguousarray(seeds, np.int64)
        lib.ln_load_batch(
            c_paths, n,
            c_seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.size, int(self.train), self.crop_ratio,
            self.scale[0], self.scale[1], self.ratio[0], self.ratio[1],
            int(self.normalize),
            self._mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.num_threads,
        )
        for i in np.nonzero(ok == 0)[0]:  # PNG, corrupt files: PIL
            from PIL import Image

            with Image.open(paths[i]) as img:
                out[i] = self._fallback(img, int(seeds[i]))
        return out


class NativeDataLoader:
    """`data.loader.DataLoader`'s contract (epoch-seeded shuffling, the
    ``shard`` split) with batches from the native pipeline."""

    def __init__(self, dataset, batch_size: int, *, train: bool = True,
                 size: int = 224, normalize: bool = True,
                 shuffle: Optional[bool] = None, drop_last: bool = True,
                 seed: int = 0, shard: Optional[Tuple[int, int]] = None,
                 num_threads: Optional[int] = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = train if shuffle is None else shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard = shard or (0, 1)
        self.prefetch = prefetch
        self.transform = NativeBatchTransform(
            size=size, train=train, normalize=normalize,
            num_threads=num_threads,
        )

    def __len__(self):
        # per-shard length after DistributedSampler-style wrap padding
        idx, count = self.shard
        n = -(-len(self.dataset) // count)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def epoch(self, epoch: int):
        order = epoch_order(len(self.dataset), self.seed, epoch,
                            self.shuffle, self.shard)

        # a background producer, so batch b+1 decodes (the GIL released
        # inside ln_load_batch) while the device steps on batch b
        def batch(b):
            chunk = order[b * self.batch_size:(b + 1) * self.batch_size]
            paths = [self.dataset.samples[i][0] for i in chunk]
            labels = np.asarray([self.dataset.samples[i][1] for i in chunk],
                                np.int32)
            seeds = batch_seeds(self.seed, epoch, chunk)
            return self.transform.load(paths, seeds.tolist()), labels

        return prefetched(batch, len(self), self.prefetch)
