"""The ISD1 wire protocol: ``DecoderServer`` and ``DecoderClient``.

Counterpart of ``imagined_speech_decoding_tpu/server.py``, byte for byte
on the wire (``tests/test_torch_server.py`` holds each package's client
against the other's server). Stdlib and numpy only. One long-lived
process owns the decoder on the device; acquisition and analysis clients
talk to it over TCP.

Wire protocol (version ``ISD1``, little-endian, length-prefixed):

    header   <4s B I   = magic b"ISD1", message type u8, payload bytes u32
    INFO     0x01      -> 0x81 + JSON {n_channels, seq_len, n_classes, ...}
    DECODE   0x02      payload <III (B, C, T) + B*C*T f32
                       -> 0x82 + <II (B, K) + B*K f32 posteriors
    RELOAD   0x03      payload utf-8 checkpoint path (live mode only)
                       -> 0x80 (weights hot-swapped)
    SHUTDOWN 0x04      -> 0x80, then the server stops accepting
    DECODE_ALL 0x05    same payload as DECODE (fleet mode only)
                       -> 0x83 + <III (M, B, K) + M*B*K f32 per-model posteriors
    error    0xFF      + utf-8 message (any request may fail)

Hardening, as in the JAX package: RELOAD paths are confined to
``reload_root`` after symlink and ``..`` resolution; with ``auth_token``
set, RELOAD and SHUTDOWN payloads must start with ``<token>\\n``
(constant-time compare), while INFO and DECODE stay open; once a frame's
header has arrived, its whole payload must arrive within ``io_timeout``
seconds. Connections are persistent, one thread each, and the decoder
calls are serialised by one lock: one decoder on one device.
``artifact_meta`` reads the served shapes from an exported decoder.
"""

from __future__ import annotations

import hmac
import json
import os
import socket
import socketserver
import struct
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

MAGIC = b"ISD1"
_HDR = struct.Struct("<4sBI")

MSG_INFO = 0x01
MSG_DECODE = 0x02
MSG_RELOAD = 0x03
MSG_SHUTDOWN = 0x04
MSG_DECODE_ALL = 0x05
RSP_OK = 0x80
RSP_INFO = 0x81
RSP_DECODE = 0x82
RSP_DECODE_ALL = 0x83
RSP_ERR = 0xFF

# Largest payload a server accepts (a ~2000-window batch at 64 x 800):
# a corrupt or hostile length field cannot make it allocate more.
MAX_PAYLOAD = 512 * 1024 * 1024


class ProtocolError(RuntimeError):
    """Malformed frame (bad magic, truncated payload, bogus lengths)."""


def _recv_exact(sock: socket.socket, n: int, deadline: Optional[float] = None) -> bytes:
    """Exactly ``n`` bytes, or ``ConnectionError`` on EOF. ``deadline`` (a
    ``time.monotonic()`` instant) bounds the whole read: the socket
    timeout is re-armed to the time left before every ``recv``, so a peer
    that drip-feeds bytes cannot keep resetting the clock."""
    buf = bytearray()
    while len(buf) < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("payload deadline exceeded")
            sock.settimeout(remaining)
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError(f"peer closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def _send_frame(sock: socket.socket, msg_type: int, payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(MAGIC, msg_type, len(payload)) + payload)


def _recv_frame(sock: socket.socket, max_payload: int = MAX_PAYLOAD,
                payload_timeout: Optional[float] = None) -> Tuple[int, bytes]:
    """One frame. ``payload_timeout`` bounds the whole payload once its
    header has arrived; the wait for the header keeps the socket's own
    timeout (idle connections are fine)."""
    magic, msg_type, n = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if n > max_payload:
        raise ProtocolError(f"payload {n} bytes exceeds limit {max_payload}")
    if not n:
        return msg_type, b""
    if payload_timeout is None:
        return msg_type, _recv_exact(sock, n)
    prev = sock.gettimeout()
    try:
        return msg_type, _recv_exact(sock, n, deadline=time.monotonic() + payload_timeout)
    except socket.timeout as e:
        raise ProtocolError(f"payload stalled (> {payload_timeout}s mid-frame)") from e
    finally:
        sock.settimeout(prev)


class DecoderServer:
    """Serve ``decode_fn(x (B, C, T) f32) -> (B, K)`` over TCP.

    ``decode_fn`` is an in-process decoder (``serving.make_online_decoder``).
    ``reload_fn(path)``, when given, services RELOAD and requires
    ``reload_root``, the directory RELOAD paths are confined to.
    ``decode_all_fn(x) -> (M, B, K)``, when given, services DECODE_ALL.
    ``auth_token`` gates RELOAD and SHUTDOWN behind a shared secret.

    ``with DecoderServer(...) as srv:`` serves on a daemon thread and
    stops on exit; ``serve_forever()`` blocks (the CLI does that).
    """

    def __init__(
        self,
        decode_fn: Callable[[np.ndarray], np.ndarray],
        *,
        n_channels: int,
        seq_len: int,
        n_classes: int,
        host: str = "127.0.0.1",
        port: int = 0,
        reload_fn: Optional[Callable[[str], None]] = None,
        reload_root: Optional[str] = None,
        decode_all_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        info_extra: Optional[Dict] = None,
        max_requests: Optional[int] = None,
        auth_token: Optional[str] = None,
        io_timeout: Optional[float] = 30.0,
    ):
        if reload_fn is not None and reload_root is None:
            raise ValueError(
                "reload_fn requires reload_root: RELOAD must be confined to "
                "a checkpoint directory, not the whole filesystem"
            )
        self._decode = decode_fn
        self._decode_all = decode_all_fn
        self._reload = reload_fn
        self._reload_root = os.path.realpath(reload_root) if reload_root is not None else None
        self._auth = auth_token
        self._io_timeout = io_timeout
        self._meta = {
            "protocol": MAGIC.decode(),
            "n_channels": int(n_channels),
            "seq_len": int(seq_len),
            "n_classes": int(n_classes),
            "reloadable": reload_fn is not None,
            "fleet": decode_all_fn is not None,
            "authenticated": auth_token is not None,
            **(info_extra or {}),
        }
        self._lock = threading.Lock()  # one decoder call at a time
        self._served = 0
        self._max_requests = max_requests
        self._thread: Optional[threading.Thread] = None
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one persistent connection
                while True:
                    try:
                        msg_type, payload = _recv_frame(
                            self.request, payload_timeout=outer._io_timeout)
                    except ConnectionError:
                        return  # the client hung up between frames
                    except ProtocolError as e:
                        # Frame boundaries are lost: report, then drop the connection.
                        try:
                            _send_frame(self.request, RSP_ERR, str(e).encode())
                        except OSError:
                            pass
                        return
                    try:
                        stop = outer._dispatch(self.request, msg_type, payload)
                    except BrokenPipeError:
                        return
                    except Exception as e:  # noqa: BLE001 (reported to the client)
                        try:
                            _send_frame(self.request, RSP_ERR,
                                        f"{type(e).__name__}: {e}".encode())
                        except OSError:
                            return
                        continue
                    if stop:
                        return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _Handler)

    def _dispatch(self, sock, msg_type: int, payload: bytes) -> bool:
        """Answer one request; True when the connection (and, for
        SHUTDOWN, the server) stops."""
        if msg_type == MSG_INFO:
            _send_frame(sock, RSP_INFO, json.dumps(self._meta).encode())
            return False
        if msg_type in (MSG_DECODE, MSG_DECODE_ALL):
            x = self._parse_windows(payload)
            if msg_type == MSG_DECODE_ALL and self._decode_all is None:
                raise RuntimeError("DECODE_ALL needs fleet mode (serve with --checkpoint-dir)")
            fn = self._decode_all if msg_type == MSG_DECODE_ALL else self._decode
            with self._lock:
                post = np.asarray(fn(x), dtype="<f4")
                self._served += 1
                done = self._max_requests is not None and self._served >= self._max_requests
            if msg_type == MSG_DECODE_ALL:
                rsp, hdr = RSP_DECODE_ALL, struct.pack("<III", *post.shape)
            else:
                rsp, hdr = RSP_DECODE, struct.pack("<II", *post.shape)
            _send_frame(sock, rsp, hdr + post.tobytes())
            if done:
                self._async_shutdown()
            return done
        if msg_type == MSG_RELOAD:
            payload = self._check_auth(payload)
            if self._reload is None:
                raise RuntimeError("server is immutable (artifact mode); RELOAD needs live weights")
            path = self._confine_reload_path(payload.decode())
            with self._lock:
                self._reload(path)
            _send_frame(sock, RSP_OK)
            return False
        if msg_type == MSG_SHUTDOWN:
            self._check_auth(payload)
            _send_frame(sock, RSP_OK)
            self._async_shutdown()
            return True
        raise ProtocolError(f"unknown message type 0x{msg_type:02x}")

    def _check_auth(self, payload: bytes) -> bytes:
        """The payload after its ``<token>\\n`` prefix; raises when a token
        is configured and the prefix does not match it."""
        if self._auth is None:
            return payload
        tok, sep, rest = payload.partition(b"\n")
        if not sep or not hmac.compare_digest(tok, self._auth.encode()):
            raise PermissionError("bad or missing auth token")
        return rest

    def _confine_reload_path(self, path: str) -> str:
        """``path`` resolved under the checkpoint root (relative paths are
        taken from it); raises when it escapes the root after symlink and
        ``..`` resolution. The check runs before ``reload_fn`` opens the
        file: it confines honest but wrong paths, not a peer that can
        write symlinks into the root."""
        root = self._reload_root
        assert root is not None  # the constructor requires it with reload_fn
        cand = path if os.path.isabs(path) else os.path.join(root, path)
        real = os.path.realpath(cand)
        if real != root and not real.startswith(root + os.sep):
            raise PermissionError(f"RELOAD path {path!r} escapes the checkpoint root")
        return real

    def _parse_windows(self, payload: bytes) -> np.ndarray:
        """A DECODE / DECODE_ALL payload as its (B, C, T) array."""
        if len(payload) < 12:
            raise ProtocolError("DECODE payload shorter than its (B, C, T) header")
        b, c, t = struct.unpack_from("<III", payload)
        want = 12 + 4 * b * c * t
        if len(payload) != want:
            raise ProtocolError(f"DECODE length {len(payload)} != {want} for shape ({b}, {c}, {t})")
        if (c, t) != (self._meta["n_channels"], self._meta["seq_len"]):
            raise ValueError(
                f"window shape ({c}, {t}) does not match the served model's "
                f"({self._meta['n_channels']}, {self._meta['seq_len']})"
            )
        if b == 0:
            raise ValueError("empty batch")
        return np.frombuffer(payload, "<f4", offset=12).reshape(b, c, t)

    def _async_shutdown(self):
        # shutdown() waits for serve_forever to return, so a handler thread
        # must not call it itself.
        threading.Thread(target=self._server.shutdown, daemon=True).start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    @property
    def info(self) -> Dict:
        return dict(self._meta)

    @property
    def decoders(self) -> Tuple[Callable, Optional[Callable]]:
        """The served ``(decode_fn, decode_all_fn)``."""
        return self._decode, self._decode_all

    @property
    def requests_served(self) -> int:
        return self._served

    def serve_forever(self) -> None:
        self._server.serve_forever(poll_interval=0.05)

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "DecoderServer":
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)


class DecoderClient:
    """Blocking client for :class:`DecoderServer` over one persistent socket.

    >>> with DecoderClient(host, port) as c:
    ...     c.info()["n_classes"]
    ...     posteriors = c.decode(raw)   # (B, C, T) f32 -> (B, K)
    """

    def __init__(self, host: str, port: int, timeout: float = 60.0,
                 auth_token: Optional[str] = None):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._auth = auth_token

    def _authed(self, payload: bytes) -> bytes:
        """The shared secret's prefix on a mutating request, when configured."""
        return payload if self._auth is None else self._auth.encode() + b"\n" + payload

    def _rpc(self, msg_type: int, payload: bytes, expect: int) -> bytes:
        _send_frame(self._sock, msg_type, payload)
        rsp, data = _recv_frame(self._sock)
        if rsp == RSP_ERR:
            raise RuntimeError(f"server error: {data.decode(errors='replace')}")
        if rsp != expect:
            raise ProtocolError(f"expected response 0x{expect:02x}, got 0x{rsp:02x}")
        return data

    def _windows(self, x: np.ndarray) -> bytes:
        x = np.ascontiguousarray(x, dtype="<f4")
        if x.ndim != 3:
            raise ValueError(f"expected (B, C, T), got shape {x.shape}")
        return struct.pack("<III", *x.shape) + x.tobytes()

    def info(self) -> Dict:
        return json.loads(self._rpc(MSG_INFO, b"", RSP_INFO))

    def decode(self, x: np.ndarray) -> np.ndarray:
        data = self._rpc(MSG_DECODE, self._windows(x), RSP_DECODE)
        b, k = struct.unpack_from("<II", data)
        return np.frombuffer(data, "<f4", offset=8).reshape(b, k).copy()

    def decode_all(self, x: np.ndarray) -> np.ndarray:
        """Fleet mode: every served model's posteriors, ``(M, B, K)``."""
        data = self._rpc(MSG_DECODE_ALL, self._windows(x), RSP_DECODE_ALL)
        m, b, k = struct.unpack_from("<III", data)
        return np.frombuffer(data, "<f4", offset=12).reshape(m, b, k).copy()

    def reload(self, checkpoint_path: str) -> None:
        self._rpc(MSG_RELOAD, self._authed(checkpoint_path.encode()), RSP_OK)

    def shutdown_server(self) -> None:
        self._rpc(MSG_SHUTDOWN, self._authed(b""), RSP_OK)

    def close(self) -> None:
        self._sock.close()

    def __enter__(self) -> "DecoderClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def artifact_meta(program) -> Dict[str, int]:
    """``(n_channels, seq_len, n_classes)`` of an exported decode program
    (``torch.export.ExportedProgram`` of ``(b, C, T) -> (b, K)``, as
    ``serving.load_decoder_artifact`` gives it in ``decode.program``), read
    from its input and output specs; the batch dimension may be symbolic."""
    nodes = {n.name: n for n in program.graph.nodes}
    sig = program.graph_signature
    in_shape = nodes[sig.user_inputs[0]].meta["val"].shape
    out_shape = nodes[sig.user_outputs[0]].meta["val"].shape
    return {
        "n_channels": int(in_shape[-2]),
        "seq_len": int(in_shape[-1]),
        "n_classes": int(out_shape[-1]),
    }
