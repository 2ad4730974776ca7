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
    # x, x_is_f32, out, w, b, rows, d, eps, ln_form, tp_w, tp_b, mask,
    # seq_len, stream
    "lt_layernorm": (_P, _I, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _I, _P),
    # a, w, bias, m, n, k, epilogue, resid, rmask, variant, out, stream
    "lt_gemm": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P),
    # a, xs, w, ws, bias, m, n, k, epilogue, resid, rmask, out, stream
    "lt_gemm_s8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # a, w, bias, m, n, k, epilogue, resid, rmask, variant, out, ln_form,
    # ln_w, ln_b, eps, out2, tp_w, tp_b, mask, seq_len, stream
    "lt_gemm_rows": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P,
                     _F, _P, _P, _P, _P, _I, _P),
    # a, xs, w, ws, bias, m, n, k, epilogue, resid, rmask, out, ln_w, ln_b,
    # eps, q, scale, stream
    "lt_gemm_s8_rows": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                        _P, _F, _P, _P, _P),
    # x, kmask, rmask, head_gate, h1, params, tp_w, tp_b, nxt_ln_w,
    # nxt_ln_b, nxt_tp_w, nxt_tp_b, b, l, d, hidden, num_heads, sm_scale,
    # eps, ln_form, gemm_var, softmax, proj_rows, ws_h1, ws_qkv, ws_attn,
    # ws_x2, ws_h2, ws_u, out, h1_out, stream
    "lt_vit_layer": (_P,) * 12 + (_I,) * 5 + (_F, _F) + (_I,) * 4
    + (_P,) * 9,
    # x, mask, n, params, policies, b, l, d, hidden, num_heads, sm_scale,
    # eps, ln_form, gemm_var, softmax, proj_rows, fc2_rows, ws, out, stream
    "lt_vit_segment": (_P, _P, _I, _P, _P) + (_I,) * 5 + (_F, _F)
    + (_I,) * 5 + (_P,) * 3,
    # kind, n (what cudaOccupancyMaxActiveClusters returns)
    "lt_gemm_clusters": (_I, _I),
    # qkv, key_mask, head_gate, out, b, l, num_heads, sm_scale, softmax,
    # stream
    "lt_attention": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "lt_attention_resident": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # x, x_is_f32, q, scale, w, b, rows, d, eps, stream
    "lt_layernorm_quant": (_P, _I, _P, _P, _P, _P, _I, _I, _F, _P),
    # x, x_is_f32, q, scale, rows, d, stream
    "lt_rowquant": (_P, _I, _P, _P, _I, _I, _P),
    # qkv, key_mask, head_gate, out, stats, b, l, num_heads, sm_scale,
    # deferred, f32, stream
    "lt_attn_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P),
    # qkv, key_mask, head_gate, dout, stats, dqkv, dhead, delta, dgate_part,
    # b, l, num_heads, sm_scale, f32, stream
    "lt_attn_bwd": (_P,) * 9 + (_I, _I, _I, _F, _I, _P),
    # x1, identity, mask, mask_type, w2, a2, b2, w3, a3, b3, slots, counts,
    # selected, mid, out, f32, b, h, w, c, co, patch, capacity, stream
    "lt_masked_tail": (_P, _P, _P, _I) + (_P,) * 11 + (_I,) * 8 + (_P,),
    # mask, mask_type, slots, counts, selected, b, n_cells, capacity, stream
    "lt_select_cells": (_P, _I, _P, _P, _P, _I, _I, _I, _P),
    # a, b, c, m, n, k, stream
    "lt_s8_gemm": (_P, _P, _P, _I, _I, _I, _P),
    # base, rows, k, reps (the host's cost of the GEMM core's descriptors)
    "lt_tma_encode": (_P, _I, _I, _I),
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


def compile_library(cu: list[Path], out: Path) -> tuple[float, str]:
    """Compiles the ``.cu`` sources ``cu`` (one ``nvcc`` each, all started
    together) and links them into the shared library ``out``. Returns the
    seconds spent and the compiler's output (``-Xptxas -v``: registers,
    shared memory, spills)."""
    out.parent.mkdir(parents=True, exist_ok=True)
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

    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
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
    return time.perf_counter() - t0, "".join(log)


@functools.lru_cache(maxsize=None)
def build() -> tuple[Path, float, str]:
    """Compiles the sources unless the hashed library exists. Returns the
    library path, the seconds spent compiling (0 when it existed) and the
    compiler's output."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    seconds, log = compile_library(
        [s for s in _sources() if s.suffix == ".cu"], out)
    return out, seconds, log


def load(path: Path, names=None) -> ctypes.CDLL:
    """Loads the library at ``path`` and binds the C entry points
    ``names`` (all of `_SIGNATURES` by default)."""
    lib = ctypes.CDLL(str(path))
    for name in names or _SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = list(_SIGNATURES[name])
        fn.restype = ctypes.c_int
    lib.lt_error_string.argtypes = [ctypes.c_int]
    lib.lt_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return load(build()[0])


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raises if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.lt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
