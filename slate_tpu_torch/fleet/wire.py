"""Length-prefixed socket framing for the fleet tier's RPC (the JAX
package's ``fleet/wire.py``; the same frame, caps and taxonomy).

One message = a 4-byte big-endian header length, the JSON header, then
the raw bytes of each array the header's ``arrays`` manifest declares
(name, dtype string, shape — in manifest order, C-contiguous).  Both
directions use the same frame, so the router and worker share one
codec and one failure taxonomy:

* EOF mid-frame raises :class:`ConnectionError` — the peer died (the
  ``host_death`` signature: a SIGKILLed worker's kernel sends RST/FIN
  and the router's in-flight ``recv`` breaks immediately, not at the
  timeout).
* A frame exceeding the sanity caps raises :class:`ProtocolError` —
  garbage on the port must fail loudly, never allocate unbounded.
* Timeouts are the *socket's* (``settimeout`` by the caller): the
  router bounds every RPC, the worker bounds idle connections.

JSON carries control only; operands travel as raw buffers (no base64,
no pickling — pickles from a socket would be an RCE surface and the
operands dominate the payload anyway).
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ..exceptions import SlateError

#: frame sanity caps — a corrupt length prefix must not OOM the reader
MAX_HEADER_BYTES = 16 << 20
MAX_ARRAY_BYTES = 1 << 31

_LEN = struct.Struct(">I")


class ProtocolError(SlateError):
    """Malformed fleet RPC frame (bad length, manifest, or dtype)."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError on EOF (the
    socket's timeout applies per chunk; a stalled peer surfaces as
    ``socket.timeout`` from ``recv``)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError(
                f"fleet peer closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf += chunk
    return bytes(buf)


def send_msg(
    sock: socket.socket,
    header: dict,
    arrays: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Send one frame: header JSON (with an ``arrays`` manifest added)
    followed by each array's raw C-contiguous bytes."""
    arrays = arrays or {}
    manifest = []
    payloads = []
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        manifest.append([name, a.dtype.str, list(a.shape)])
        payloads.append(a.tobytes())
    head = dict(header)
    head["arrays"] = manifest
    hb = json.dumps(head).encode("utf-8")
    if len(hb) > MAX_HEADER_BYTES:
        raise ProtocolError(f"fleet header too large ({len(hb)} bytes)")
    sock.sendall(_LEN.pack(len(hb)) + hb + b"".join(payloads))


def recv_msg(
    sock: socket.socket,
) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Receive one frame; returns ``(header, arrays)``.  The header's
    ``arrays`` manifest is consumed into real ndarrays and removed."""
    (hlen,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if hlen > MAX_HEADER_BYTES:
        raise ProtocolError(f"fleet header length {hlen} over cap")
    try:
        header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    except ValueError as e:
        raise ProtocolError(f"fleet header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise ProtocolError("fleet header is not an object")
    arrays: Dict[str, np.ndarray] = {}
    for entry in header.pop("arrays", ()):
        try:
            name, dtype, shape = entry
            dt = np.dtype(dtype)
            shape = tuple(int(d) for d in shape)
        except (TypeError, ValueError) as e:
            raise ProtocolError(
                f"fleet array manifest entry {entry!r} malformed"
            ) from e
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        if not 0 <= nbytes <= MAX_ARRAY_BYTES:
            raise ProtocolError(
                f"fleet array {name!r} size {nbytes} over cap"
            )
        arrays[name] = np.frombuffer(
            _recv_exact(sock, nbytes), dtype=dt
        ).reshape(shape)
    return header, arrays
