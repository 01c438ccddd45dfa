"""ctypes bindings for the native C++ frame codec (native/tunnel_frames.cc).

Loads ``native/build/libtunnelframes.so`` when present; every entry point
has a pure-Python fallback in protocol/frames.py, so the library is an
optimisation, never a requirement.  ``available()`` reports which path is
active; tests cross-check both implementations against each other.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "build", "libtunnelframes.so",
)

TF_OK = 0


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tf_encode_frame.restype = ctypes.c_int32
    lib.tf_encode_frame.argtypes = [
        ctypes.c_uint8, ctypes.c_uint32, u8p, ctypes.c_uint32, u8p, ctypes.c_uint32,
    ]
    lib.tf_decode_frame.restype = ctypes.c_int32
    lib.tf_decode_frame.argtypes = [
        u8p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.tf_chunk_body.restype = ctypes.c_int32
    lib.tf_chunk_body.argtypes = [
        ctypes.c_uint8, ctypes.c_uint32, u8p, ctypes.c_uint32, ctypes.c_uint32,
        u8p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.tf_batch_parse.restype = ctypes.c_int32
    lib.tf_batch_parse.argtypes = [
        u8p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _buf(data: bytes):
    return ctypes.cast(ctypes.create_string_buffer(data, len(data)),
                       ctypes.POINTER(ctypes.c_uint8))


def encode_frame(msg_type: int, stream_id: int, payload: bytes) -> Optional[bytes]:
    """Native frame encode; None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    cap = 5 + len(payload)
    out = (ctypes.c_uint8 * cap)()
    n = lib.tf_encode_frame(msg_type, stream_id, _buf(payload), len(payload),
                            out, cap)
    if n < 0:
        raise ValueError(f"tf_encode_frame failed: {n}")
    return bytes(out[:n])


def decode_frame(data: bytes) -> Optional[Tuple[int, int, bytes]]:
    """Native decode → (type, stream_id, payload); None when lib absent.

    Raises ValueError with the native status code on malformed frames.
    """
    lib = _load()
    if lib is None:
        return None
    mt = ctypes.c_uint8()
    sid = ctypes.c_uint32()
    plen = ctypes.c_uint32()
    rc = lib.tf_decode_frame(_buf(data), len(data), ctypes.byref(mt),
                             ctypes.byref(sid), ctypes.byref(plen))
    if rc != TF_OK:
        raise ValueError(f"tf_decode_frame failed: {rc}")
    return int(mt.value), int(sid.value), data[5 : 5 + plen.value]


def chunk_body(
    msg_type: int, stream_id: int, body: bytes, chunk_size: int
) -> Optional[List[bytes]]:
    """Split + encode a body into length-prefix-framed BODY records natively.

    Returns the list of raw frame bytes (no length prefix, ready for
    Channel.send), or None when the lib is absent.
    """
    lib = _load()
    if lib is None:
        return None
    n_chunks = (len(body) + chunk_size - 1) // chunk_size if body else 0
    cap = len(body) + n_chunks * 9 + 16
    out = (ctypes.c_uint8 * cap)()
    n_frames = ctypes.c_uint32()
    written = lib.tf_chunk_body(msg_type, stream_id, _buf(body), len(body),
                                chunk_size, out, cap, ctypes.byref(n_frames))
    if written < 0:
        raise ValueError(f"tf_chunk_body failed: {written}")
    raw = bytes(out[:written])
    frames: List[bytes] = []
    pos = 0
    for _ in range(n_frames.value):
        flen = int.from_bytes(raw[pos : pos + 4], "big")
        frames.append(raw[pos + 4 : pos + 4 + flen])
        pos += 4 + flen
    return frames
