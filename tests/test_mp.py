import pytest

from ieache import params as P
from ieache.mp import dragonfly, keywrap, scheduler


def test_dragonfly_handshake_derives_same_pmk():
    a, b = dragonfly.handshake_pair()
    assert a.pmk == b.pmk
    assert len(a.pmk) == 32
    # password element is deterministic per (password, macs)
    assert a.pe == dragonfly.Peer(
        dragonfly.DEFAULT_PASSWORD, a.mac_address
    ).initiate(b.mac_address)


def test_dragonfly_wrong_password_fails():
    mac_a, mac_b = "02:aa", "02:bb"
    a = dragonfly.Peer("abc1238", mac_a)
    b = dragonfly.Peer("wrong", mac_b)
    a.initiate(mac_b)
    b.initiate(mac_a)
    sa, ea = a.commit_exchange()
    sb, eb = b.commit_exchange()
    ta = a.compute_shared_secret(eb, sb, mac_b)
    b.compute_shared_secret(ea, sa, mac_a)
    with pytest.raises(ValueError):
        b.confirm_exchange(ta)


def test_curve_group_law():
    c = dragonfly.Curve()
    # toy check on the real curve: 2P + P == 3P, nP on curve
    p0 = dragonfly.Peer("x", "m1")
    pe = p0.initiate("m2")
    p2 = c.add(pe, pe)
    p3a = c.add(p2, pe)
    p3b = c.mul(3, pe)
    assert p3a == p3b
    assert c.valid(c.mul(12345, pe))


def test_keywrap_roundtrip():
    key = bytes(range(32))
    for n in [0, 1, 15, 16, 17, 1000, 70000]:
        data = bytes((i * 7) % 256 for i in range(n))
        blob = keywrap.encrypt_bytes(key, data)
        assert keywrap.decrypt_bytes(key, blob) == data


def test_scheduler_caps_and_parse():
    ops, operators = scheduler.parse_postfix("AB+C-")
    assert ops == ["A", "B", "C"]
    assert operators == ["+", "-"]
    with pytest.raises(scheduler.JobError):
        scheduler.parse_postfix("AB+CD+E+")  # 5 operands
    with pytest.raises(scheduler.JobError):
        scheduler.parse_postfix("AB+C-D*")  # 3 operators (wire cap 2)


def test_full_flow_two_operand():
    from ieache.mp import sim

    res = sim.run_full_flow(
        "AB+",
        {"A": [3, 100], "B": [5, 27]},
        width=8,
        params=P.TEST_TINY,
    )
    assert res.values == [8, 127]
    assert sorted(res.served_roles) == ["client-1", "client-2",
                                        "cloud", "output"]
    assert res.gate_count > 0


def test_full_flow_three_operand_chain():
    """BASELINE config 4: full Client1-3 -> Cloud -> Output flow."""
    from ieache.mp import sim

    res = sim.run_full_flow(
        "AB+C-",
        {"A": [30, 1], "B": [12, 2], "C": [50, 3]},
        width=8,
        params=P.TEST_TINY,
    )
    # (30+12)-50 = -8 ; (1+2)-3 = 0
    assert res.values == [-8, 0]
    # the left-fold job compiles to ONE chained circuit by default
    assert len(res.timings) == 1 and res.timings[0]["op"] == "+-"


def test_full_flow_three_operand_unchained():
    """IEACHE_CHAIN=0 forces the reference's per-op walk."""
    import os

    from ieache.mp import sim

    os.environ["IEACHE_CHAIN"] = "0"
    try:
        res = sim.run_full_flow(
            "AB+C-",
            {"A": [30], "B": [12], "C": [50]},
            width=8,
            params=P.TEST_TINY,
        )
    finally:
        del os.environ["IEACHE_CHAIN"]
    assert res.values == [-8]
    assert len(res.timings) == 2


def test_plan_postfix_shapes():
    letters, op_chars, steps = scheduler.plan_postfix("AB+C-")
    assert letters == ["A", "B", "C"] and op_chars == ["+", "-"]
    assert steps == [("+", ("opnd", 0), ("opnd", 1)),
                     ("-", ("step", 0), ("opnd", 2))]
    # mul-first tree: A - B*C
    letters, op_chars, steps = scheduler.plan_postfix("ABC*-")
    assert steps == [("*", ("opnd", 1), ("opnd", 2)),
                     ("-", ("opnd", 0), ("step", 0))]
    with pytest.raises(scheduler.JobError):
        scheduler.plan_postfix("AB+-")


def test_full_flow_mul_first_tree():
    """A - B * C through the six-role flow (postfix ABC*-)."""
    from ieache.mp import sim

    res = sim.run_full_flow(
        "ABC*-",
        {"A": [100], "B": [5], "C": [9]},
        width=8,
        params=P.TEST_TINY,
    )
    assert res.values == [100 - 5 * 9]
    assert res.timings[0]["op"] == "*-"


def test_key_transfer_digest_mismatch_detected():
    """Tampered key material must fail the md5 cross-check
    (`dragonfly_private_keygen.py:676-680` semantics, made automatic)."""
    import socket
    import threading

    from ieache.mp import keywrap as kw, nodes, transport
    from ieache.codec import schema

    a, b = socket.socketpair()
    pmk = bytes(range(32))
    blob_k, blob_n = b"K" * 1000, b"N" * 500
    errors = []

    def sender():
        # corrupt: send the digest of DIFFERENT content
        wrapped_k = kw.encrypt_bytes(pmk, blob_k)
        wrapped_n = kw.encrypt_bytes(pmk, blob_n)
        transport.send_msg(a, schema.DataFsize,
                           {"data": len(wrapped_k)})
        transport.recv_ack(a)
        transport.send_msg(a, schema.DataFsize,
                           {"data": len(wrapped_n)})
        transport.recv_ack(a)
        transport.send_msg(a, schema.DataKey,
                           {"key": wrapped_k, "nbit": wrapped_n})
        transport.recv_ack(a)
        transport.send_msg(a, schema.DataMd5,
                           {"data": "deadbeef,deadbeef"})
        if not transport.recv_ack(a):
            errors.append("sender saw mismatch")

    t = threading.Thread(target=sender)
    t.start()
    with pytest.raises(ConnectionError, match="digest mismatch"):
        nodes._recv_keypair(b, pmk)
    t.join(10)
    assert errors == ["sender saw mismatch"]
    a.close()
    b.close()


def test_key_transfer_digest_ok_roundtrip():
    import socket
    import threading

    from ieache.mp import nodes

    a, b = socket.socketpair()
    pmk = bytes(range(32))
    blob_k, blob_n = b"K" * 9000, b"N" * 500
    t = threading.Thread(
        target=nodes._send_keypair, args=(a, pmk, blob_k, blob_n),
        kwargs={"chunk": 4096},
    )
    t.start()
    got_k, got_n = nodes._recv_keypair(b, pmk)
    t.join(10)
    assert (got_k, got_n) == (blob_k, blob_n)
    a.close()
    b.close()


def test_submit_job_validates_liveness_and_ip():
    """Per-operand IPv4 + liveness gate (`output_dynamic.py:1096-1113`)."""
    from ieache.mp import nodes

    out = nodes.OutputNode("pw")
    with pytest.raises(ValueError, match="Invalid IP"):
        out.submit_job(("127.0.0.1", 1), "AB+",
                       {"A": ("not-an-ip", 5), "B": ("127.0.0.1", 5)})
    # a dead-but-valid address: port 1 on loopback is closed (and this
    # environment has no ping binary, so the fallback also fails)
    with pytest.raises(ValueError, match="not alive"):
        out.submit_job(("127.0.0.1", 1), "AB+",
                       {"A": ("127.0.0.1", 1), "B": ("127.0.0.1", 1)})


def test_keygen_discover_tcp_probe():
    import socket

    from ieache.mp import nodes

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    node = nodes.KeygenNode.__new__(nodes.KeygenNode)  # skip keygen
    up = node.discover(["127.0.0.1"], port=port)
    assert up == ["127.0.0.1"]
    srv.close()


def test_supervisor_bounded_restarts():
    """The respawn loop (C23, `client_dynamic.py:8-13` semantics) with
    bounded restarts returns the worker's last exit code."""
    import sys

    from ieache.mp import supervisor

    code = supervisor.supervise(
        [sys.executable, "-c", "import sys; sys.exit(3)"],
        max_restarts=2, delay=0.05, backoff=1.0, max_delay=0.1,
    )
    assert code == 3


def test_node_stop_before_start_is_safe():
    from ieache.mp import nodes

    nodes.OutputNode("pw").stop()
    nodes.CloudNode("pw").stop()
    nodes.ClientNode(1, "pw").stop()


def _mini_keygen(clients=None):
    from ieache.lwe import keygen as kg
    from ieache.mp import nodes

    if "kgpair" not in globals():
        globals()["kgpair"] = kg.generate_gate_keypair(P.TEST_TINY)
    node = nodes.KeygenNode(P.TEST_TINY, "pw",
                            pair=globals()["kgpair"])
    addr = node.start("127.0.0.1", 0, clients=clients,
                      admit_timeout=5.0)
    return node, addr


def _pull_keys(addr, role, password="pw"):
    from ieache.mp import nodes, transport

    s = transport.connect_retry(*addr, retries=20, delay=0.05)
    try:
        pmk, _ = transport.sae_handshake(s, password, role)
        return nodes._recv_keypair(s, pmk)
    finally:
        s.close()


def test_keygen_admission_unknown_role_refused():
    """A peer that knows the password but claims an unlisted role must
    NOT receive the secret keyset (reference: only ping-discovered
    clients are admitted, `dragonfly_private_keygen.py:704-728`)."""
    node, addr = _mini_keygen(clients=["client-1"])
    _pull_keys(addr, "output")  # admit output first
    with pytest.raises((ConnectionError, OSError)):
        _pull_keys(addr, "client-9")
    assert "client-9" in node.refused
    assert "client-9" not in node.served
    node.stop()


def test_keygen_admission_cloud_never_gets_secret():
    """The cloud role receives the evaluation keyset only — no lwe_s
    (`dragonfly_public_keygen.py:570-574` trust model)."""
    from ieache.codec import files

    node, addr = _mini_keygen(clients=[])
    _pull_keys(addr, "output")
    blob_k, _ = _pull_keys(addr, "cloud")
    params, arrays, _hdr = files.loads_container(
        blob_k, expect_kind="cloud_keyset"
    )
    assert "lwe_s" not in arrays and "trlwe_k" not in arrays
    # an impostor claiming a cloud-ish but unlisted role is refused
    with pytest.raises((ConnectionError, OSError)):
        _pull_keys(addr, "cloud-2")
    node.stop()


def test_keygen_admission_order_output_first():
    """Clients block until Output has been served; Cloud blocks until
    Output and every allowlisted client have been served
    (`dragonfly_private_keygen.py:704-728` admission order)."""
    import threading
    import time

    node, addr = _mini_keygen(clients=["client-1"])
    order = []

    def pull(role):
        _pull_keys(addr, role)
        order.append(role)

    tc = threading.Thread(target=pull, args=("client-1",))
    tcl = threading.Thread(target=pull, args=("cloud",))
    tc.start()
    tcl.start()
    time.sleep(0.5)
    assert order == []          # both waiting on output
    pull("output")
    tc.join(10)
    tcl.join(10)
    assert order[0] == "output"
    assert set(order) == {"output", "client-1", "cloud"}
    assert order.index("cloud") > order.index("client-1")
    node.stop()


def test_native_ec_matches_python():
    """The C scalar multiplication (native/src/ec.cc) is bit-identical
    to the pure-Python double-and-add across scalar edge cases (order
    boundaries, p-1) and random scalars on real SAE-derived points."""
    import random

    nlib = pytest.importorskip("ieache.native.lib")
    try:
        nlib.get_lib()
    except Exception:
        pytest.skip("native toolchain unavailable")

    c = dragonfly.Curve()
    peer = dragonfly.Peer(mac_address="02:00:00:00:00:01")
    pe = peer.initiate("02:00:00:00:00:02")

    def py_mul(scalar, pt):
        result = dragonfly.O
        addend = pt
        while scalar:
            if scalar & 1:
                result = c.add(result, addend)
            addend = c.add(addend, addend)
            scalar >>= 1
        return result

    rng = random.Random(7)
    scalars = [1, 2, 3, dragonfly.Q - 1, dragonfly.Q, dragonfly.Q + 1,
               dragonfly.P - 1] + [rng.randrange(1, dragonfly.P)
                                   for _ in range(10)]
    for pt in (pe, py_mul(12345, pe)):
        for s in scalars:
            got = nlib.ec_mul(s, pt.x, pt.y)
            want = py_mul(s, pt)
            if want is dragonfly.O:
                assert got is None
            else:
                assert got == (want.x, want.y), s
    assert nlib.ec_mul(0, pe.x, pe.y) is None


def test_keypair_transfer_at_reference_chunk_size():
    """The key fan-out still interoperates at the reference's 8192-byte
    DataKey chunks (`dragonfly_private_keygen.py:658-672`) — the larger
    production default (mp/config.py) is a buffer-size knob, not a
    protocol change."""
    import socket
    import threading

    from ieache.mp import nodes

    pmk = b"\x07" * 32
    blob_k = bytes(range(256)) * 300   # 76.8 kB -> ~10 chunks
    blob_n = b"\xA5" * 10_000
    a, b = socket.socketpair()
    err = []

    def sender():
        try:
            nodes._send_keypair(a, pmk, blob_k, blob_n, chunk=8192)
        except Exception as e:  # pragma: no cover
            err.append(e)

    t = threading.Thread(target=sender)
    t.start()
    got_k, got_n = nodes._recv_keypair(b, pmk)
    t.join(10)
    assert not err
    assert got_k == blob_k and got_n == blob_n
    a.close()
    b.close()


def test_sae_handshake_pure_python_fallback():
    """The pure-Python EC path (IEACHE_NATIVE_EC=0) still completes a
    full SAE handshake and derives matching PMKs — the fallback for
    hosts without a C toolchain stays alive."""
    import os

    saved = os.environ.get("IEACHE_NATIVE_EC")
    os.environ["IEACHE_NATIVE_EC"] = "0"
    try:
        a, b = dragonfly.handshake_pair()
        assert a.pmk == b.pmk and len(a.pmk) == 32
    finally:
        if saved is None:
            os.environ.pop("IEACHE_NATIVE_EC", None)
        else:
            os.environ["IEACHE_NATIVE_EC"] = saved
