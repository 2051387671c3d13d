"""Error/guard paths across the protocol (SURVEY §5.3 counterparts)."""

import pytest

from ieache import params as P
from ieache.mp import sim
from ieache.utils.trace import Timings, bootstraps_per_sec


def test_mul_width_guard_over_sockets():
    """256-bit multiply must surface the exit-126 guard through the
    whole socket flow (cloud.c:860-864 ->
    dragonfly_cipher_cloud error signalling)."""
    with pytest.raises(RuntimeError, match="Cannot multiply 256 bit"):
        sim.run_full_flow(
            "AB*",
            {"A": [3], "B": [5]},
            width=256,
            params=P.TEST_TINY,
        )


def test_malformed_postfix_over_sockets():
    with pytest.raises(RuntimeError, match="error"):
        sim.run_full_flow(
            "AB++",  # malformed: 2 operands, 2 operators
            {"A": [3], "B": [5]},
            width=8,
            params=P.TEST_TINY,
        )


def test_timings_recorder(tmp_path):
    t = Timings()
    with t.span("compute", op="+"):
        pass
    t.count("bootstraps", 160)
    t.count("bootstraps", 160)
    assert t.counters["bootstraps"] == 320
    assert t.total("compute") >= 0
    path = str(tmp_path / "timings.txt")
    t.dump(path)
    import json

    rec = json.loads(open(path).read())
    assert rec["counters"]["bootstraps"] == 320
    assert bootstraps_per_sec(100, 2.0) == 50.0
