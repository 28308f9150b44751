"""Python side of the C-ABI vtable (native/capi.cpp).

The C API (uvgtpu_api_get, mirroring uvg266's uvg_api_get vtable,
src/uvg266.h:707-869) embeds or reuses a CPython interpreter and routes
every call through these functions; all state lives in the handle registry
so the C side only holds opaque ids. The encoder runs on the CUDA device
unless the config pair ``device`` names ``cpu`` (the C ABI's counterpart
of the CLI's --device).
"""
from __future__ import annotations

import numpy as np

_handles: dict[int, object] = {}
_next_id = [1]


class _CEncoder:
    def __init__(self, kv: dict):
        from .cfg import Config, PRESETS
        from .control.encoder import Encoder

        args: dict = {}
        device = kv.pop("device", "cuda")
        preset = kv.pop("preset", None)
        if preset:
            args.update(PRESETS.get(preset, {}))
        casts = {
            "width": int, "height": int, "qp": int, "gop_len": int,
            "intra_period": int, "ref_frames": int, "bipred": int,
            "target_bitrate": int, "vaq": int, "input_bitdepth": int,
        }
        bools = {"gop_lowdelay", "wpp", "deblock_enable", "rdoq_enable",
                 "signhide_enable", "dep_quant", "lfnst", "isp", "mrl",
                 "mip", "aud_enable"}
        for k, v in kv.items():
            if k in casts:
                args[k] = casts[k](v)
            elif k in bools:
                args[k] = v not in ("0", "false", "False", "")
            elif k in ("sao_type", "alf_type", "cclm", "jccr", "mts",
                       "ibc", "dual_tree"):
                args[k] = int(v)
        self.cfg = Config(**args)
        self.enc = Encoder(self.cfg, device=device)
        self.w = self.cfg.width
        self.h = self.cfg.height

    def encode(self, y: bytes, u: bytes | None, v: bytes | None) -> bytes:
        from .control.encoder import FramePlanes

        yp = np.frombuffer(y, dtype=np.uint8).reshape(
            self.h, self.w).astype(np.int32)
        up = vp = None
        if u is not None and len(u):
            up = np.frombuffer(u, dtype=np.uint8).reshape(
                self.h // 2, self.w // 2).astype(np.int32)
            vp = np.frombuffer(v, dtype=np.uint8).reshape(
                self.h // 2, self.w // 2).astype(np.int32)
        outs = self.enc.feed(FramePlanes(yp, up, vp))
        return b"".join(au for (au, *_r) in outs)

    def flush(self) -> bytes:
        return b"".join(au for (au, *_r) in self.enc.flush())


def encoder_open(pairs: list) -> int:
    kv = dict(pairs)
    h = _next_id[0]
    _next_id[0] += 1
    _handles[h] = _CEncoder(kv)
    return h


def encoder_headers(h: int) -> bytes:
    from .bitstream.bitwriter import Bitstream
    from .hls import headers

    enc = _handles[h]
    bs = Bitstream()
    headers.write_parameter_sets(bs, enc.enc.ctrl)
    return bs.bytes()


def encoder_encode(h: int, y: bytes, u: bytes, v: bytes) -> bytes:
    return _handles[h].encode(y, u or None, v or None)


def encoder_flush(h: int) -> bytes:
    return _handles[h].flush()


def encoder_close(h: int) -> None:
    _handles.pop(h, None)
