"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled on first
use by ``nvcc`` into a shared library of its own, cached under ``build/``
by a hash of its sources and flags, and loaded with ``ctypes``. ``build()``
starts one ``nvcc`` per source, all at once. A kernel is named after its
C entry; its source is ``csrc/<name>.cu`` unless ``SOURCE`` names another
(a source may hold several entries that share device code). There is no CPU fallback
here: a wrapper reaches ``launch`` only for a CUDA tensor, and ``launch``
raises when the kernel cannot be built or launched.

Every C entry takes its tensors as raw device pointers, enqueues its kernel
on the stream it is given (PyTorch's current stream) without synchronising,
and returns ``cudaGetLastError()``. ``LAUNCHES`` counts the successful
launches per kernel (``LAUNCHES_BY_DEVICE`` the same by card), so a run
can show that its path went through them.
Building and loading hold one lock, so host threads that first need a
kernel at the same time (the mesh encoders' runs, the CLI's ``--threads``)
build each source once.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
_HEADERS = ("common.cuh", "butterfly.cuh", "qpel.cuh", "rd_tail.cuh",
            "angular.cuh", "dct2_coef.cuh")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# kernel name -> argtypes of its C entry (same name), the stream last
SIGNATURES = {
    # src, refsrc, F, H, W, w, h, x0, y0, sx, sy, gx, gy, refs, blocks
    "refs_blocks_grid": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P],
    # refs, B, w, h, max_pix, desc, ext_max, modes (or null), M, preds
    "predict67": [_P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P],
    # preds, src, B, M, w, h, out
    "satd67": [_P, _P, _I, _I, _I, _I, _P, _P],
    # preds, src, satds, B, M, w, h, mat_w, mat_h, wts, mode_bits,
    # bitdepth, q_bits, scale, add, iscale, dq_shift, lam, best, rd, satd
    "rd_cost": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                _I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P],
    # src, H, W, mat, bitdepth, q_bits, scale, add, dscale, dq_shift, out
    "pseudo_recon": [_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # preds, src, extra_bits, B, w, h, mat_w, mat_h, wts, bitdepth, q_bits,
    # scale, add, iscale, dq_shift, lam, rd
    "rd_cost_pred": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _F, _P, _P],
    # src, ref_pad, H, W, r, pen, bits_tab, classes (host), n_classes, ssd,
    # idx, pred, blk, extra
    "frame_inter": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                    _P],
    # windows, blocks, leaf_ids, nt, nl, pen, bitdepth, satd, best, cost, seg
    "leaf_qpel": [_P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P],
    # src, H, W, xs, ys, B, w, h, bitdepth, mat, preds
    "mip_preds": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # preds, src, B, w, h, mts_w, mts_h, keep (host), tr_idx (host), wts,
    # bitdepth, q_bits, scale, add, iscale, dq_shift, lam, tr, cost, dc_only
    "mts_search": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _I, _F, _P, _P, _P, _P],
    # src, H, W, xs, ys, B, w, h, refs, blocks
    "refs_blocks": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P],
    # ref, H, W, blocks, xs, ys, B, w, h, r, pen, mvx, mvy, cost
    "fullpel_search": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                       _P],
    # ref, H, W, blocks, xs, ys, mvx, mvy, B, w, h, bitdepth, fpen, best,
    # preds (all 49, or the winner's), costs, winner
    "frac_search": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                    _P, _P, _I, _P],
    # refs, modes, B, R, w, h, max_pix, desc (host, compact), ext_max,
    # n_top, n_left, n_ftop, n_fleft, preds
    "predict_modes": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P,
                      _P],
    # stage, B, n1, hw, lam, s1, s2, refine, mode_bits, m1, p1, p2,
    # best_mode, satd_best, extra, pred
    "rough_refine": [_I, _I, _I, _I, _F] + [_P] * 11 + [_P],
    # x, B, w, h, tr_w, tr_h, mat_w, mat_h (int32 M), s1, s2, keep_w,
    # keep_h, out
    "fwd_transform": [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                      _P],
    # c, B, w, h, tr_w, tr_h, mat_w, mat_h (int32 M^T), s1, s2, out
    "inv_transform": [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P],
    # coef, n, elem_bytes (2: int16, 4: int32), scale, add, q_bits, out
    "quant_levels": [_P, _L, _I, _I, _I, _I, _P, _P],
    # q, n, elem_bytes, scale, add, shift, out
    "dequant_levels": [_P, _L, _I, _I, _I, _I, _P, _P],
}
# kernels whose C entry lives in another kernel's source
SOURCE = {"refs_blocks": "refs_blocks_grid", "fwd_transform": "transform",
          "inv_transform": "transform", "quant_levels": "quant",
          "dequant_levels": "quant"}
LAUNCHES = dict.fromkeys(SIGNATURES, 0)
# the same counts by card ('cuda:i')
LAUNCHES_BY_DEVICE: dict = {}
_LIBS: dict = {}
# held while a source is built or a library loaded; the counts have their own
_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        LAUNCHES_BY_DEVICE.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def source_of(name: str) -> str:
    """The source (without .cu) that holds kernel ``name``'s C entry."""
    return SOURCE.get(name, name)


def lib_path(name: str) -> str:
    name = source_of(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + _HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD, f"{name}_{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the listed kernels (default: all) that are not cached yet,
    one nvcc per source, all started together. Returns the seconds each
    build took (0.0 when cached); raises with nvcc's output on failure.
    Callers on other threads wait for a build in progress."""
    with _LOCK:
        return _build(names)


def _build(names) -> dict:
    names = list(dict.fromkeys(
        source_of(n) for n in (SIGNATURES if names is None else names)))
    todo = [n for n in names if not os.path.exists(lib_path(n))]
    secs = dict.fromkeys(names, 0.0)
    if not todo:
        return secs
    nvcc = _nvcc()
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked for {nvcc}): the CUDA "
                           "kernels cannot be built")
    os.makedirs(BUILD, exist_ok=True)
    procs = []
    for n in todo:
        out = lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp,
                              os.path.join(CSRC, f"{n}.cu")],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append((n, p, tmp, out, time.perf_counter()))
    failed = []
    for n, p, tmp, out, t0 in procs:
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        with open(out + ".log", "w") as fh:
            fh.write(log)
        if p.returncode != 0:
            failed.append(f"nvcc failed for {n}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    cached build of ``name``."""
    with open(lib_path(name) + ".log") as fh:
        return fh.read()


def _load(name: str):
    found = _LIBS.get(name)
    if found is not None:
        return found
    with _LOCK:
        if name not in _LIBS:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"kernel {name}: no CUDA device to launch on")
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[name] = (fn, err)
        return _LIBS[name]


def launch(name: str, device: torch.device, *args) -> None:
    """Enqueue kernel ``name`` on the current stream of ``device``, with
    ``device`` the calling thread's current card for the call (a C entry
    launches on the current card, and a stream of another card is not
    its to use); raise if the launch was refused. Counts the launch, in
    all and on its card."""
    fn, err = _load(name)
    cuda = device.type == "cuda"
    with torch.cuda.device(device) if cuda else contextlib.nullcontext():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel {name}: {err(rc).decode()} (error {rc})")
    card = f"cuda:{torch.cuda.current_device()}" \
        if cuda and device.index is None else str(device)
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        by = LAUNCHES_BY_DEVICE.setdefault(card, dict.fromkeys(SIGNATURES, 0))
        by[name] += 1


def check_batch(name: str, n: int) -> None:
    """Refuse an empty batch on every device: a launch over zero blocks is
    an invalid configuration on the card, so no wrapper returns quietly
    there; callers drop a size class with no position before any launch
    (control/partition.py)."""
    if n <= 0:
        raise ValueError(f"{name}: empty batch ({n} blocks)")


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on, contiguous; raises
    otherwise (a wrapper never falls back to its plain version)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor not contiguous")
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    return dev
