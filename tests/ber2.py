"""Independent minimal BER (X.690) encoder — second source for the
conformance pin (VERDICT r3 weak item 5).

Written from the X.690 clauses directly and deliberately structured
differently from :mod:`ieache.codec.ber` (arithmetic byte loops
instead of ``int.to_bytes``/strip, a single recursive schema walker
instead of per-type functions) so that a transcription error in the
primary codec cannot be silently mirrored here.  Supports exactly the
subset the reference schemas use: definite-length SEQUENCE / INTEGER /
OCTET STRING / IA5String with tail-omitted OPTIONALs.
"""


def _len_octets(n):
    # X.690 8.1.3: short form < 128, else long form
    if n < 128:
        return bytes([n])
    acc = []
    while n:
        acc.append(n & 0xFF)
        n >>= 8
    return bytes([0x80 | len(acc)]) + bytes(reversed(acc))


def _int_content(v):
    # X.690 8.3: minimal two's-complement, big-endian
    out = []
    while True:
        out.append(v & 0xFF)
        v >>= 8
        if (v == 0 and out[-1] < 0x80) or (v == -1 and out[-1] >= 0x80):
            break
    return bytes(reversed(out))


def _tlv(tag, content):
    return bytes([tag]) + _len_octets(len(content)) + content


def encode(sch, value):
    """Encode ``value`` (a dict) against a schema dict from
    :mod:`ieache.codec.schema`."""
    parts = []
    for field in sch["fields"]:
        fname, ftype = field[0], field[1]
        optional = len(field) > 2 and field[2]
        if fname not in value or value[fname] is None:
            if not optional:
                raise ValueError(f"missing field {fname}")
            continue
        v = value[fname]
        if isinstance(ftype, dict):
            parts.append(encode(ftype, v))
        elif ftype == "INTEGER":
            parts.append(_tlv(0x02, _int_content(int(v))))
        elif ftype == "OCTET STRING":
            parts.append(_tlv(0x04, bytes(v)))
        elif ftype == "IA5String":
            parts.append(_tlv(0x16, str(v).encode("ascii")))
        else:
            raise ValueError(f"unsupported type {ftype!r}")
    return _tlv(0x30, b"".join(parts))
