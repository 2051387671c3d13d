"""Transport-layer tests including fault injection.

The reference's error-path testing was manual buffer-shrinking probes
(SURVEY §4); here the stop-and-wait ack/rewind protocol
(`dragonfly_cipher_client.py:100-117` semantics) is exercised with an
adversarial receiver that rejects chunks, and the SAE-over-socket
handshake is run over a real socketpair.
"""

import socket
import threading

import pytest

from ieache.codec import ber, schema
from ieache.mp import transport


def _pair():
    a, b = socket.socketpair()
    return a, b


def test_send_recv_msg_roundtrip():
    a, b = _pair()
    transport.send_msg(a, schema.DataFsize, {"data": 987654})
    assert transport.recv_msg(b, schema.DataFsize) == {"data": 987654}
    big = bytes(range(256)) * 40
    transport.send_msg(a, schema.DataContent, {"data": big})
    assert transport.recv_msg(b, schema.DataContent)["data"] == big
    a.close()
    b.close()


def test_blob_transfer_with_nacks():
    """Receiver nacks every other chunk; sender must rewind+resend."""
    a, b = _pair()
    data = bytes((i * 13) % 256 for i in range(10_000))
    result = {}

    def evil_receiver():
        size = transport.recv_msg(b, schema.DataFsize)["data"]
        transport.send_ack(b, True)
        buf = b""
        flip = True
        while len(buf) < size:
            values = transport.recv_msg(b, schema.DataContent)
            if flip:
                transport.send_ack(b, False)  # reject -> sender rewinds
            else:
                buf += values["data"]
                transport.send_ack(b, True)
            flip = not flip
        result["data"] = buf

    t = threading.Thread(target=evil_receiver)
    t.start()
    transport.send_blob(a, data, chunk=1024)
    t.join(10)
    assert result["data"] == data
    a.close()
    b.close()


def test_sae_over_socket_pair():
    a, b = _pair()
    out = {}

    def side(sock, mac, key):
        out[key] = transport.sae_handshake(sock, "pw123", mac)

    t1 = threading.Thread(target=side, args=(a, "02:aa", "a"))
    t2 = threading.Thread(target=side, args=(b, "02:bb", "b"))
    t1.start()
    t2.start()
    t1.join(30)
    t2.join(30)
    pmk_a, peer_a = out["a"]
    pmk_b, peer_b = out["b"]
    assert pmk_a == pmk_b
    assert peer_a == "02:bb" and peer_b == "02:aa"
    a.close()
    b.close()


def test_sae_wrong_password_fails():
    a, b = _pair()
    errors = []

    def side(sock, mac, pw):
        try:
            transport.sae_handshake(sock, pw, mac)
        except Exception as e:
            errors.append(e)

    t1 = threading.Thread(target=side, args=(a, "02:aa", "right"))
    t2 = threading.Thread(target=side, args=(b, "02:bb", "wrong"))
    t1.start()
    t2.start()
    t1.join(30)
    t2.join(30)
    assert errors  # at least one side must reject
    a.close()
    b.close()


def test_ack_coalesced_with_next_tlv():
    """An ack and the following message delivered in ONE TCP segment
    must not desync the stream (the reference's unframed 7-byte
    ``b"success"`` ack read with ``recv(16)`` would swallow the start
    of the next TLV, `dragonfly_cipher_client.py:100-117`)."""
    a, b = _pair()
    # peer sends ack + its next request back-to-back in one sendall
    ack = ber.encode_message(schema.DataIndicator, {"data": "success"})
    nxt = ber.encode_message(schema.DataFsize, {"data": 4242})
    a.sendall(ack + nxt)
    assert transport.recv_ack(b) is True
    assert transport.recv_msg(b, schema.DataFsize)["data"] == 4242
    # nack coalesced with a retransmission attempt marker
    nack = ber.encode_message(schema.DataIndicator, {"data": "fail"})
    a.sendall(nack + ack)
    assert transport.recv_ack(b) is False
    assert transport.recv_ack(b) is True
    a.close()
    b.close()


def test_recv_tlv_long_form():
    a, b = _pair()
    payload = b"z" * 70000
    a.sendall(ber.encode_tlv(ber.TAG_OCTET_STRING, payload))
    buf = transport.recv_tlv(b)
    tag, content, _ = ber.decode_tlv(buf)
    assert tag == ber.TAG_OCTET_STRING and content == payload
    a.close()
    b.close()
