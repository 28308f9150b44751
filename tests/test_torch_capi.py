"""The port's C-ABI vtable (uvg266_tpu_torch/native/capi.cpp
uvgtpu_api_get, the uvg_api_get shape, uvg266.h:707-869): build the shared
library, drive a full encode through the C function pointers from ctypes
with the config pair device=cpu, hold its headers and AUs byte for byte
against the JAX package's bridge (uvg266_tpu.capi_bridge, in-process, the
same pairs without ``device``) fed the same frames, and oracle-verify the
stream with the port's decoder. The twin of tests/test_capi.py; it builds
its library into its own temporary directory, so the two never race."""
import ctypes
import os
import subprocess
import sysconfig

import numpy as np
import pytest

_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "uvg266_tpu_torch", "native")


def _build(out_dir):
    so = os.path.join(str(out_dir), "libuvg266gpu_test.so")
    src = os.path.join(_DIR, "capi.cpp")
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = sysconfig.get_config_var("LDVERSION")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
           "-o", so, f"-I{inc}", f"-L{libdir}", f"-lpython{ver}"]
    subprocess.check_call(cmd)
    return so


class Chunk(ctypes.Structure):
    pass


Chunk._fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)),
                  ("len", ctypes.c_uint32),
                  ("next", ctypes.POINTER(Chunk))]


class Picture(ctypes.Structure):
    _fields_ = [("fulldata", ctypes.POINTER(ctypes.c_uint8)),
                ("y", ctypes.POINTER(ctypes.c_uint8)),
                ("u", ctypes.POINTER(ctypes.c_uint8)),
                ("v", ctypes.POINTER(ctypes.c_uint8)),
                ("width", ctypes.c_int32),
                ("height", ctypes.c_int32),
                ("pts", ctypes.c_int64)]


class Api(ctypes.Structure):
    _fields_ = [
        ("config_alloc", ctypes.CFUNCTYPE(ctypes.c_void_p)),
        ("config_init", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)),
        ("config_destroy", ctypes.CFUNCTYPE(ctypes.c_int,
                                            ctypes.c_void_p)),
        ("config_parse", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_char_p,
                                          ctypes.c_char_p)),
        ("picture_alloc", ctypes.CFUNCTYPE(ctypes.POINTER(Picture),
                                           ctypes.c_int32,
                                           ctypes.c_int32)),
        ("picture_free", ctypes.CFUNCTYPE(None, ctypes.POINTER(Picture))),
        ("chunk_free", ctypes.CFUNCTYPE(None, ctypes.POINTER(Chunk))),
        ("encoder_open", ctypes.CFUNCTYPE(ctypes.c_void_p,
                                          ctypes.c_void_p)),
        ("encoder_close", ctypes.CFUNCTYPE(None, ctypes.c_void_p)),
        ("encoder_headers", ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(
                ctypes.POINTER(Chunk)), ctypes.POINTER(ctypes.c_uint32))),
        ("encoder_encode", ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(Picture),
            ctypes.POINTER(ctypes.POINTER(Chunk)),
            ctypes.POINTER(ctypes.c_uint32))),
    ]


PAIRS = [("width", "64"), ("height", "64"), ("qp", "30"), ("gop_len", "0"),
         ("intra_period", "1"), ("wpp", "0")]


def _jax_bridge_stream(frames):
    """The JAX package's C-ABI bridge on the same pairs and frames: (headers,
    [the bytes of each encode call], the bytes of the flush)."""
    from uvg266_tpu import capi_bridge as jb
    h = jb.encoder_open(list(PAIRS))
    try:
        hdr = jb.encoder_headers(h)
        n = 64 * 64
        outs = [jb.encoder_encode(h, f[:n].tobytes(),
                                  f[n:n + n // 4].tobytes(),
                                  f[n + n // 4:].tobytes()) for f in frames]
        return hdr, outs, jb.encoder_flush(h)
    finally:
        jb.encoder_close(h)


def _take(api, out, ln) -> bytes:
    data = bytes(bytearray(out.contents.data[:ln.value])) if ln.value \
        else b""
    api.chunk_free(out)
    return data


def test_capi_vtable_encode(tmp_path):
    so = _build(tmp_path)
    lib = ctypes.CDLL(so)
    lib.uvgtpu_api_get.restype = ctypes.POINTER(Api)
    api = lib.uvgtpu_api_get(8).contents

    cfgp = api.config_alloc()
    assert api.config_init(cfgp)
    for k, v in PAIRS + [("device", "cpu")]:
        assert api.config_parse(cfgp, k.encode(), v.encode())
    enc = api.encoder_open(cfgp)
    assert enc

    out = ctypes.POINTER(Chunk)()
    ln = ctypes.c_uint32()
    assert api.encoder_headers(enc, ctypes.byref(out), ctypes.byref(ln))
    headers = _take(api, out, ln)

    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, 64 * 64 * 3 // 2, dtype=np.uint8)
              for _t in range(2)]
    aus = []
    for frame in frames:
        pic = api.picture_alloc(64, 64)
        ctypes.memmove(pic.contents.fulldata, frame.ctypes.data,
                       len(frame))
        out = ctypes.POINTER(Chunk)()
        ln = ctypes.c_uint32()
        assert api.encoder_encode(enc, pic, ctypes.byref(out),
                                  ctypes.byref(ln))
        aus.append(_take(api, out, ln))
        api.picture_free(pic)
    # drain
    out = ctypes.POINTER(Chunk)()
    ln = ctypes.c_uint32()
    assert api.encoder_encode(enc, None, ctypes.byref(out),
                              ctypes.byref(ln))
    drained = _take(api, out, ln)
    api.encoder_close(enc)
    api.config_destroy(cfgp)

    # the JAX package's bridge gives the same bytes, call for call
    want_hdr, want_aus, want_drained = _jax_bridge_stream(frames)
    assert len(headers) > 10 and headers == want_hdr
    assert aus == want_aus
    assert drained == want_drained

    stream = b"".join(aus) + drained
    assert len(stream) > 100
    # independently decode the C-API-produced stream
    from uvg266_tpu_torch.oracle.ref_decoder import decode_stream
    decoded = decode_stream(stream)
    assert len(decoded) == 2
    assert all(fr.checksum_ok for fr in decoded)


def test_capi_bridge_defaults_to_the_card():
    """Without a device pair the bridge asks for the CUDA device, which
    raises where there is none; device=cpu runs the plain versions."""
    import torch

    from uvg266_tpu_torch import capi_bridge
    kv = [("width", "64"), ("height", "64"), ("gop_len", "0"),
          ("intra_period", "1"), ("wpp", "0")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            capi_bridge.encoder_open(list(kv))
    h = capi_bridge.encoder_open(kv + [("device", "cpu")])
    try:
        enc = capi_bridge._handles[h].enc
        assert enc.slice_enc.device.type == "cpu"
        assert len(capi_bridge.encoder_headers(h)) > 10
    finally:
        capi_bridge.encoder_close(h)
