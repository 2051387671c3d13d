import numpy as np
import pytest
import os
import tempfile

from ieache import params as P
from ieache.codec import ber, files, schema
from ieache.lwe import keygen


def test_ber_integer_roundtrip():
    for v in [0, 1, -1, 127, 128, -128, -129, 255, 256, 2**31 - 1,
              -(2**31), 16384, 1024 * 1024]:
        buf = ber.encode_integer(v)
        tag, content, end = ber.decode_tlv(buf)
        assert tag == ber.TAG_INTEGER
        assert end == len(buf)
        assert ber.decode_integer(content) == v


def test_ber_known_der_encodings():
    # X.690 canonical examples
    assert ber.encode_integer(0) == b"\x02\x01\x00"
    assert ber.encode_integer(127) == b"\x02\x01\x7f"
    assert ber.encode_integer(128) == b"\x02\x02\x00\x80"
    assert ber.encode_integer(-128) == b"\x02\x01\x80"
    # long-form length
    long = ber.encode_tlv(ber.TAG_OCTET_STRING, b"x" * 300)
    assert long[:4] == b"\x04\x82\x01\x2c"


def test_message_roundtrips():
    msgs = [
        (schema.DataFsize, {"data": 123456}),
        (schema.DataContent, {"data": os.urandom(1024)}),
        (schema.DataMd5, {"data": "d41d8cd98f00b204e9800998ecf8427e"}),
        (schema.DataKey, {"key": b"\x00" * 100, "nbit": b"\xff" * 50}),
        (schema.DataIndicator, {"data": "finished"}),
        (schema.DataAnsSize, {"data": 162304}),
    ]
    for sch, values in msgs:
        buf = ber.encode_message(sch, values)
        got, end = ber.decode_message(sch, buf)
        assert end == len(buf)
        assert got == values


def test_user_input_nested_with_optionals():
    values = {
        "ipaddress": {
            "ipaddress1": b"192.168.0.21",
            "ipaddress2": b"192.168.0.22",
            # ipaddress3 omitted (2-operand job)
        },
        "operation": {"operation1": b"1"},
        "postfix": {"postfix": b"AB+"},
    }
    buf = ber.encode_message(schema.DataUserInput, values)
    got, _ = ber.decode_message(schema.DataUserInput, buf)
    assert got["ipaddress"] == values["ipaddress"]
    assert got["operation"] == {"operation1": b"1"}
    assert got["postfix"] == {"postfix": b"AB+"}


def test_key_file_roundtrip():
    p = P.TEST_TINY
    ks = keygen.generate_secret_keyset(p)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "secret.key")
        files.save_secret_keyset(path, ks)
        ks2 = files.load_secret_keyset(path)
        assert ks2.params == p
        np.testing.assert_array_equal(ks2.lwe_key.s, ks.lwe_key.s)
        np.testing.assert_array_equal(ks2.cloud.bk, ks.cloud.bk)
        np.testing.assert_array_equal(ks2.cloud.ks, ks.cloud.ks)

        cpath = os.path.join(d, "cloud.key")
        files.save_cloud_keyset(cpath, ks.cloud)
        c2 = files.load_cloud_keyset(cpath)
        np.testing.assert_array_equal(c2.bk, ks.cloud.bk)


def test_lwe_array_file_roundtrip():
    p = P.TEST_TINY
    arr = np.arange(3 * 5 * (p.n + 1), dtype=np.int32).reshape(3, 5, -1)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cloud.data")
        files.save_lwe_array(path, p, arr, meta={"kind": "operand"})
        p2, arr2, meta = files.load_lwe_array(path)
        assert p2 == p
        assert meta == {"kind": "operand"}
        np.testing.assert_array_equal(arr2, arr)


def test_schema_matches_declaration_asn():
    """schema.py is verified against the shipped declaration.asn — the
    .asn module is the wire format's source of truth, the same
    artifact kind the reference deploys (`Output/declaration.asn`)."""
    from ieache.codec import asn_schema, schema

    parsed = asn_schema.load_module()
    assert parsed == schema.ALL


def test_asn_emit_parse_roundtrip_per_node():
    from ieache.codec import asn_schema

    full = asn_schema.load_module()
    for role, names in asn_schema.NODE_TYPES.items():
        text = asn_schema.node_module(role)
        parsed = asn_schema.parse_module(text)
        assert parsed == {n: full[n] for n in names}, role
    # the drift facts (SURVEY C14): clients carry the 10 common types,
    # Output everything (16 declarations incl. the 3 nested job types)
    assert len(asn_schema.NODE_TYPES["client"]) == 10
    assert len(asn_schema.NODE_TYPES["output"]) == 16
    assert "DataUserInput" not in asn_schema.NODE_TYPES["keygen"]


def test_asn1tools_crosscheck():
    """If asn1tools is available, the shipped module must compile and
    BER-encode DataFsize identically to our codec."""
    asn1tools = pytest.importorskip("asn1tools")
    from ieache.codec import asn_schema, ber, schema

    spec = asn1tools.compile_files([asn_schema.module_path()], "ber")
    for value in [0, 1, 127, 128, 162304, 2**31 - 1]:
        theirs = spec.encode("DataFsize", {"data": value})
        ours = ber.encode(schema.DataFsize, {"data": value})
        assert theirs == ours, value
