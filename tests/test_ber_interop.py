"""BER wire-format interop: byte-exact golden encodings.

The reference encodes with `asn1tools` compiled from `declaration.asn`
(`Client1/dragonfly_private_client.py:33`); that package is not
available in this image, so these golden byte strings are derived BY
HAND from ITU-T X.690 (the encoding asn1tools produces for the same
untagged-SEQUENCE schemas): definite lengths, universal tags
SEQUENCE=0x30 / INTEGER=0x02 / OCTET STRING=0x04 / IA5String=0x16,
minimal two's-complement integers, long-form lengths above 127.
`codec/ber.py` must produce exactly these bytes and decode them back —
this pins format compatibility at the external boundary (SURVEY §5.8)
independently of the codec's own round-trip.
"""

import pytest

from ieache.codec import ber, schema


def H(s):  # compact hex literal helper
    return bytes.fromhex(s.replace(" ", ""))


GOLDEN = [
    # INTEGER edge cases (X.690 §8.3: minimal two's complement)
    (schema.DataFsize, {"data": 0}, H("30 03 02 01 00")),
    (schema.DataFsize, {"data": 127}, H("30 03 02 01 7f")),
    # 128 needs a leading 0x00 so the sign bit reads positive
    (schema.DataFsize, {"data": 128}, H("30 04 02 02 00 80")),
    (schema.DataFsize, {"data": 987654}, H("30 05 02 03 0f 12 06")),
    (schema.DataFsize, {"data": -1}, H("30 03 02 01 ff")),
    (schema.DataFsize, {"data": 65536}, H("30 05 02 03 01 00 00")),
    # IA5String
    (schema.DataMac, {"data": "abc"}, H("30 05 16 03 61 62 63")),
    (schema.DataIndicator, {"data": "success"},
     H("30 09 16 07") + b"success"),
    (schema.DataStaAp, {"data": "02:aa"}, H("30 07 16 05") + b"02:aa"),
    # OCTET STRING pairs (DataKey chunk)
    (schema.DataKey, {"key": b"KK", "nbit": b"N"},
     H("30 07 04 02 4b 4b 04 01 4e")),
    # INTEGER-in-unused-types (declared for schema parity)
    (schema.DataDragonflyVerif, {"code": 1}, H("30 03 02 01 01")),
    (schema.DataInitate, {"code": 300}, H("30 04 02 02 01 2c")),
]


@pytest.mark.parametrize("sch,values,golden", GOLDEN,
                         ids=lambda x: getattr(x, "get", lambda *_: None)
                         and str(x)[:24])
def test_golden_encodings(sch, values, golden):
    assert ber.encode_message(sch, values) == golden
    decoded, end = ber.decode_message(sch, golden)
    assert end == len(golden)
    for k, v in values.items():
        assert decoded[k] == (v if not isinstance(v, str) else v)


def test_golden_long_form_length():
    """Content > 127 bytes uses long-form length (X.690 §8.1.3.5)."""
    payload = bytes(range(200 % 256)) + b"\x00" * 0
    payload = bytes((i * 3) % 256 for i in range(200))
    inner = H("04 81 c8") + payload          # OCTET STRING, len 200
    golden = H("30 81 cb") + inner           # SEQUENCE, len 203
    assert ber.encode_message(
        schema.DataContent, {"data": payload}
    ) == golden
    decoded, _ = ber.decode_message(schema.DataContent, golden)
    assert decoded["data"] == payload


def test_golden_nested_datauserinput_with_tail_optionals():
    """DataUserInput with one IP, one operator: nested SEQUENCEs with
    trailing OPTIONAL fields omitted (the only omission pattern the
    identical-tag OPTIONALs of `declaration.asn` can express in BER)."""
    values = {
        "ipaddress": {"ipaddress1": b"10.0.0.1"},
        "operation": {"operation1": b"1"},
        "postfix": {"postfix": b"AB+"},
    }
    ips = H("30 0a 04 08") + b"10.0.0.1"
    ops = H("30 03 04 01 31")
    pf = H("30 05 04 03") + b"AB+"
    golden = H("30 18") + ips + ops + pf
    assert ber.encode_message(schema.DataUserInput, values) == golden
    decoded, _ = ber.decode_message(schema.DataUserInput, golden)
    assert decoded["ipaddress"]["ipaddress1"] == b"10.0.0.1"
    assert "ipaddress2" not in decoded["ipaddress"]
    assert decoded["operation"]["operation1"] == b"1"
    assert decoded["postfix"]["postfix"] == b"AB+"


def test_golden_full_three_ip_job():
    """The wire-capped 3-IP/2-operator job (`Cloud/declaration.asn:8-18`)."""
    values = {
        "ipaddress": {
            "ipaddress1": b"192.168.0.21",
            "ipaddress2": b"192.168.0.22",
            "ipaddress3": b"192.168.0.23",
        },
        "operation": {"operation1": b"1", "operation2": b"2"},
        "postfix": {"postfix": b"AB+C-"},
    }
    ip = H("30 2a") + b"".join(
        H("04 0c") + values["ipaddress"][f"ipaddress{i}"]
        for i in (1, 2, 3)
    )
    ops = H("30 06 04 01 31 04 01 32")
    pf = H("30 07 04 05") + b"AB+C-"
    golden = H("30 3d") + ip + ops + pf  # content 44+8+9 = 61 bytes
    assert ber.encode_message(schema.DataUserInput, values) == golden
    decoded, _ = ber.decode_message(schema.DataUserInput, golden)
    assert decoded == values


# ---------------------------------------------------------------------------
# Second-source pin (r4): an independently written minimal encoder
# (tests/ber2.py — X.690 transcribed separately, different algorithms)
# must byte-agree with codec/ber.py on EVERY message type over a sweep
# of representative and edge values, with asn1tools still absent.
# ---------------------------------------------------------------------------

def _sample_values(sch, variant):
    """Generate a value dict for a schema; variant 0 = full, higher
    variants drop OPTIONAL tails / vary magnitudes."""
    ints = [0, 1, 127, 128, 255, 256, -1, -128, 162304, 2**31 - 1,
            -2**31][variant % 11]
    out = {}
    for i, field in enumerate(sch["fields"]):
        fname, ftype = field[0], field[1]
        optional = len(field) > 2 and field[2]
        if optional and variant == 1 and i >= len(sch["fields"]) - 1:
            continue                       # drop the optional tail
        if isinstance(ftype, dict):
            out[fname] = _sample_values(ftype, variant)
        elif ftype == "INTEGER":
            out[fname] = ints
        elif ftype == "OCTET STRING":
            out[fname] = bytes((i * 7 + j) % 256
                               for j in range(variant * 37 % 300))
        else:                              # IA5String
            out[fname] = "msg-%d-%d" % (i, variant) + "x" * (variant * 29)
    return out


def test_second_source_encoder_agrees_on_all_types():
    import ber2

    for name, sch in schema.ALL.items():
        for variant in range(11):  # cover every ints entry, incl. the
            # negative / 32-bit-boundary INTEGER encodings (ADVICE r4)
            values = _sample_values(sch, variant)
            ours = ber.encode_message(sch, values)
            theirs = ber2.encode(sch, values)
            assert ours == theirs, (name, variant)
            decoded, end = ber.decode_message(sch, ours)
            assert end == len(ours), (name, variant)


def test_second_source_matches_golden_fixtures():
    import ber2

    for sch, values, golden in GOLDEN:
        assert ber2.encode(sch, values) == golden
