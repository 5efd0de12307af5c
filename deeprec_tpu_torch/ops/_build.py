"""Build and load the hand-written CUDA kernels.

Every ``deeprec_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one process per source started together, and linked into
one shared library with a plain C interface, at first use, under the
git-ignored ``deeprec_tpu_torch/build/``. The library's name
carries a hash of the sources, their headers (``csrc/*.cuh``) and the
flags, so an edited kernel is rebuilt and an unchanged one is reused. It
is loaded with ``ctypes``: pointers and the
CUDA stream go as ``c_void_p``, sizes as ``c_int64``, and every entry
returns ``cudaGetLastError()`` of its launch, which :func:`check` turns
into an exception.

Nothing here runs at import: the CPU tests import every module, and only
a CUDA tensor reaches :func:`library`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_float)
_SIGNATURES = {
    # values, ld_bytes, n_rows, slots, slots_are_64, n, row_bytes, out,
    # unit, stream
    "deeprec_gather_rows": [_P, _I64, _I64, _P, _I, _I64, _I64, _P, _I, _P],
    # values, ld, n_rows, d, slots, slots_are_64, s_b, s_k, valid, v_b,
    # v_k, n_bags, w, combiner, out, vec, bf16, stream
    "deeprec_fused_pooled_lookup": [_P, _I64, _I64, _I64, _P, _I, _I64,
                                    _I64, _P, _I64, _I64, _I64, _I64, _I, _P,
                                    _I, _I, _P],
    # d_pooled, d, slots, slots_are_64, s_b, s_k, valid, v_b, v_k, n_bags,
    # w, combiner, d_values, n_rows, vec, bf16, scratch, stream
    "deeprec_fused_pooled_lookup_bwd": [_P, _I64, _P, _I, _I64, _I64, _P,
                                        _I64, _I64, _I64, _I64, _I, _P, _I64,
                                        _I, _I, _P, _P],
    # n_bags, w, n_rows -> scratch bytes (int64)
    "deeprec_fused_pooled_lookup_bwd_scratch": [_I64, _I64, _I64],
    # create_steps, dest, versions, freqs, mdest, counts, idx_are_64, gs,
    # n, cap, stream (absent planes are NULL)
    "deeprec_meta_scatter": [_P, _P, _P, _P, _P, _P, _I, _I, _I64, _I64, _P],
    # uslots, counts, readonly, dest, create_steps, versions, freqs,
    # add_freqs, filter, filter_freq, admitted, idx_are_64, gs, n, cap,
    # stream (absent planes are NULL)
    "deeprec_lookup_meta": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I,
                            _I, _I64, _I64, _P],
    # plane, slots, slots_are_64, vals, n, cap, out, vec4, stream
    "deeprec_blocked_rmw_set": [_P, _P, _I, _P, _I64, _I64, _P, _I, _P],
    # plane, cap, keys, n, max_probes, slots, found, stream
    "deeprec_hash_lookup": [_P, _I64, _P, _I64, _I, _P, _P, _P],
    # plane, cap, ukeys, n, max_probes, size, overflow, slots, created,
    # key scratch, arbitration words, stream
    "deeprec_hash_lookup_or_insert": [_P, _I64, _P, _I64, _I, _P, _P, _P,
                                      _P, _P, _P, _P],
    # feats, b, f, d, out, stream
    "deeprec_dot_interaction": [_P, _I64, _I, _I, _P, _P],
    # feats, g, b, f, d, d_feats, stream
    "deeprec_dot_interaction_backward": [_P, _P, _I64, _I, _I, _P, _P],
    # xs, mask, att, wg, bg, wc, bc, order, span, hs, last, gates, n_rows,
    # L, d, g, stream (att, hs or last, gates may be NULL)
    "deeprec_gru_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I64, _I, _I, _I, _P],
    # mask, att, wg, wc, order, span, xs, hs, gates, grad, dx, d_pre, act,
    # d_att, n_rows, L, d, g, w_act, stream (att, d_att NULL for the GRU)
    "deeprec_gru_scan_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P],
    # n_rows, L, g, h1, h2, backward -> scratch bytes (int64; 0: refused)
    "deeprec_din_attention_scratch": [_I64, _I, _I, _I, _I, _I],
    # query, keys, mask, w1, b1, w2, b2, w3, b3, scale, out, scratch,
    # n_rows, L, g, h1, h2, stream
    "deeprec_din_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _P,
                              _P, _I64, _I, _I, _I, _I, _P],
    # query, keys, mask, w1, b1, w2, b2, w3, weights, grad, scale, d_query,
    # d_keys, d_params, scratch, n_rows, L, g, h1, h2, stream
    "deeprec_din_attention_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _F, _P, _P, _P, _P, _I64, _I, _I,
                                       _I, _I, _P],
}

_RESTYPES = {"deeprec_fused_pooled_lookup_bwd_scratch": _I64,
             "deeprec_din_attention_scratch": _I64}  # else c_int


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    found = path if os.path.isfile(path) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _library_path() -> Path:
    sources = sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libdeeprec_kernels_{h.hexdigest()[:16]}.so"


def _compile(path: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=str(BUILD)) as tmpdir:
        objs, procs = [], []
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *compile_flags, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(obj)
        failed = []
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode:
                failed.append(f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builders agree


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first call."""
    path = _library_path()
    if not path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
