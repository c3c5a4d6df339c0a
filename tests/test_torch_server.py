"""The port's ISD1 server and client against the JAX package's, on the wire.

The same requests, as raw frames, go to a JAX ``DecoderServer`` and to
the port's, each wrapping the same numpy decoder: every response must be
byte-equal, errors included. Then each package's client talks to the
other's server over INFO, DECODE, DECODE_ALL and RELOAD, with and
without an auth token.
"""

import os
import socket
import struct

import numpy as np
import pytest

from imagined_speech_decoding_tpu import server as jax_server
from imagined_speech_decoding_tpu_torch import server as port_server

C, T, K = 4, 16, 3
TOKEN = "s3cret"


def _decode(x):
    return np.stack([x.mean((1, 2)), x.std((1, 2)), x[:, 0, 0]], axis=1)


def _decode_all(x):
    return np.stack([_decode(x), -_decode(x)])


def _windows(b, seed=0):
    return np.random.default_rng(seed).normal(size=(b, C, T)).astype(np.float32)


def _frame(msg_type, payload=b""):
    return struct.pack("<4sBI", b"ISD1", msg_type, len(payload)) + payload


def _decode_payload(x):
    return struct.pack("<III", *x.shape) + x.tobytes()


class _Served:
    """One package's server on a free port, with the RELOAD paths it saw."""

    def __init__(self, module, root, auth_token=None, fleet=False):
        self.reloads = []
        self.server = module.DecoderServer(
            _decode, n_channels=C, seq_len=T, n_classes=K, port=0,
            reload_fn=self.reloads.append, reload_root=str(root),
            decode_all_fn=_decode_all if fleet else None,
            info_extra={"mode": "live", "device": "cpu"}, auth_token=auth_token,
            io_timeout=5.0,
        )

    def __enter__(self):
        self.server.__enter__()
        return self

    def __exit__(self, *exc):
        self.server.__exit__(*exc)


def _raw_responses(address, frames):
    """Send ``frames`` on one connection; every response frame, raw, as it
    came (b"" once the server has closed the connection)."""
    out = []
    with socket.create_connection(address, timeout=10) as sock:
        for frame in frames:
            try:
                sock.sendall(frame)
                head = jax_server._recv_exact(sock, 9)
            except ConnectionError:
                out.append(b"")
                break
            (n,) = struct.unpack_from("<I", head, 5)
            out.append(head + jax_server._recv_exact(sock, n))
    return out


x3 = _windows(3)
REQUESTS = {
    "info": [_frame(0x01)],
    "decode_b1": [_frame(0x02, _decode_payload(_windows(1, 1)))],
    "decode_b3_twice": [_frame(0x02, _decode_payload(x3))] * 2,
    "decode_all": [_frame(0x05, _decode_payload(x3))],
    "reload_relative": [_frame(0x03, b"sub-01/best_subject.npz"), _frame(0x01)],
    "reload_escape": [_frame(0x03, b"../outside.npz")],
    "wrong_window_shape": [_frame(0x02, _decode_payload(_windows(2)[:, :, :8].copy()))],
    "empty_batch": [_frame(0x02, struct.pack("<III", 0, C, T))],
    "truncated_decode": [_frame(0x02, struct.pack("<III", 2, C, T) + b"\0" * 8)],
    "unknown_type": [_frame(0x09), _frame(0x01)],
    "bad_magic": [b"XXXX" + _frame(0x01)[4:], _frame(0x01)],
    "shutdown": [_frame(0x04)],
}


@pytest.mark.parametrize("fleet", [False, True], ids=["live", "fleet"])
@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_responses_are_byte_equal(tmp_path, case, fleet):
    got = {}
    for name, module in (("jax", jax_server), ("port", port_server)):
        with _Served(module, tmp_path, fleet=fleet) as s:
            got[name] = (_raw_responses(s.server.address, REQUESTS[case]), s.reloads)
    assert got["port"] == got["jax"]
    assert got["port"][0] and got["port"][0][0][:4] == b"ISD1"


@pytest.mark.parametrize("client,server", [(jax_server, port_server), (port_server, jax_server)],
                         ids=["jax_client-port_server", "port_client-jax_server"])
@pytest.mark.parametrize("token", [None, TOKEN], ids=["open", "token"])
def test_clients_and_servers_interoperate(tmp_path, client, server, token):
    with _Served(server, tmp_path, auth_token=token, fleet=True) as s, \
            client.DecoderClient(*s.server.address, auth_token=token) as c:
        info = c.info()
        assert info["protocol"] == "ISD1" and info["authenticated"] == (token is not None)
        assert (info["n_channels"], info["seq_len"], info["n_classes"]) == (C, T, K)
        np.testing.assert_array_equal(c.decode(x3), _decode(x3).astype(np.float32))
        np.testing.assert_array_equal(c.decode_all(x3), _decode_all(x3).astype(np.float32))
        c.reload("sub-02/best_subject.npz")
        assert s.reloads == [os.path.join(os.path.realpath(tmp_path), "sub-02",
                                          "best_subject.npz")]
        with pytest.raises(RuntimeError, match="escapes the checkpoint root"):
            c.reload("/elsewhere/best_subject.npz")
        np.testing.assert_array_equal(c.decode(x3[:1]), _decode(x3[:1]).astype(np.float32))


@pytest.mark.parametrize("client,server", [(jax_server, port_server), (port_server, jax_server)],
                         ids=["jax_client-port_server", "port_client-jax_server"])
def test_wrong_token_is_refused_across_packages(tmp_path, client, server):
    with _Served(server, tmp_path, auth_token=TOKEN) as s, \
            client.DecoderClient(*s.server.address, auth_token="wrong") as c:
        with pytest.raises(RuntimeError, match="bad or missing auth token"):
            c.reload("sub-01/best_subject.npz")
        with pytest.raises(RuntimeError, match="bad or missing auth token"):
            c.shutdown_server()
        assert c.decode(x3).shape == (3, K)  # read-only requests stay open
        assert s.reloads == []
