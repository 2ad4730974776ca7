"""Builds the port's CUDA sources (``laudnet_tpu_torch/csrc``) into one
shared library with ``nvcc`` and binds its plain C interface with ctypes.

The library is built at first use into ``csrc/_build/``, named by a hash
of the sources and flags, so a changed source rebuilds and an unchanged
one loads the existing file. Each ``.cu`` is compiled to an object by an
``nvcc`` of its own, all started together, and one more ``nvcc`` links
them. Nothing here runs at import: the CPU test box has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every pointer and the stream are c_void_p: ctypes would pass a bare
# Python int as a 32-bit int and cut the address.
_SIGNATURES = {
    # x, x_is_f32, out, w, b, rows, d, eps, one_pass, tp_w, tp_b, mask,
    # seq_len, stream
    "lt_layernorm": (_P, _I, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _I, _P),
    # a, w, bias, m, n, k, epilogue, resid, rmask, fast_gelu, out, stream
    "lt_gemm": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P),
    # a, xs, w, ws, bias, m, n, k, epilogue, resid, rmask, out, stream
    "lt_gemm_s8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # qkv, key_mask, head_gate, out, b, l, num_heads, sm_scale, fast, stream
    "lt_attention": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # x, x_is_f32, q, scale, w, b, rows, d, eps, stream
    "lt_layernorm_quant": (_P, _I, _P, _P, _P, _P, _I, _I, _F, _P),
    # x, x_is_f32, q, scale, rows, d, stream
    "lt_rowquant": (_P, _I, _P, _P, _I, _I, _P),
    # qkv, key_mask, head_gate, dout, dqkv, dhead, b, l, num_heads, sm_scale,
    # stream
    "lt_attention_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # x1, identity, slots, n_valid, selected, w2t, a2, b2, w3t, a3, b3, mid,
    # out, b, h, w, c, co, patch, max_slots, stream
    "lt_masked_tail": (_P,) * 13 + (_I,) * 7 + (_P,),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's kernels build only where the CUDA "
                           "toolkit is installed")
    return str(candidate)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"laudnet_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build() -> tuple[Path, float, str]:
    """Compiles the sources unless the hashed library exists. Returns the
    library path, the seconds spent compiling (0 when it existed) and the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [s for s in _sources() if s.suffix == ".cu"]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log = []

    def start(args, log_path):
        # output to a file: a full pipe would stall a compile nobody reads
        with open(log_path, "w") as f:
            return subprocess.Popen(args, stdout=f, stderr=subprocess.STDOUT)

    def finish(proc, log_path, what):
        code = proc.wait()
        text = log_path.read_text()
        log.append(text)
        if code != 0:
            raise RuntimeError(f"nvcc failed on {what} ({code}):\n{text}")

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        objects = [tmp / f"{src.stem}.o" for src in cu]
        logs = [tmp / f"{src.stem}.log" for src in cu]
        procs = [start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                       lg) for src, obj, lg in zip(cu, objects, logs)]
        try:
            for src, proc, lg in zip(cu, procs, logs):
                finish(proc, lg, src.name)
        finally:
            for proc in procs:  # a failed source: stop the others
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tmp_lib = tmp / out.name
        finish(start([nvcc, "-shared", "-o", str(tmp_lib),
                      *map(str, objects)], tmp / "link.log"),
               tmp / "link.log", "the link")
        os.replace(tmp_lib, out)  # atomic: a reader never sees half a file
    return out, time.perf_counter() - t0, "".join(log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.lt_error_string.argtypes = [ctypes.c_int]
    lib.lt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raises if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.lt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
