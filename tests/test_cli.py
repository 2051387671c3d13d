import os
import subprocess
import sys

import pytest

from ieache.cli import convert, fixtures


def test_infix_to_postfix():
    assert convert.to_postfix("A + B") == "AB+"
    assert convert.to_postfix("A + B - C") == "AB+C-"
    assert convert.to_postfix("A * B * C") == "AB*C*"
    assert convert.to_postfix("A + B * C") == "ABC*+"
    assert convert.to_postfix("(A + B) * C") == "AB+C*"
    assert convert.to_postfix("A - B - C") == "AB-C-"


def test_validation_filters():
    # output_dynamic.py:1080-1085 rejections
    with pytest.raises(convert.ExpressionError):
        convert.validate(convert.to_postfix("A + B * C"))
    with pytest.raises(convert.ExpressionError):
        convert.validate(convert.to_postfix("A * B * C"))
    with pytest.raises(convert.ExpressionError):
        convert.validate("A")  # <2 operands
    with pytest.raises(convert.ExpressionError):
        convert.validate("AB+CD+E+"[:-1] + "+")  # >3 operands
    letters, ops = convert.validate("AB+C-")
    assert letters == ["A", "B", "C"]
    assert ops == ["+", "-"]


def test_validate_ipv4():
    assert convert.validate_ipv4("192.168.0.21")
    assert not convert.validate_ipv4("192.168.0")
    assert not convert.validate_ipv4("192.168.0.256")
    assert not convert.validate_ipv4("a.b.c.d")
    assert not convert.validate_ipv4("01.2.3.4")


def test_values_txt_roundtrip(tmp_path):
    path = str(tmp_path / "values.txt")
    for width in (32, 64, 128, 256):
        for v in (fixtures.canned_value(width),
                  fixtures.canned_value(width, True), 7, -12345):
            fixtures.write_values_txt(path, v, width)
            got, w = fixtures.read_values_txt(path)
            assert (got, w) == (v, width)
    # exact reference format for the 32-bit positive fixture
    fixtures.write_values_txt(path, fixtures.canned_value(32), 32)
    lines = open(path).read().splitlines()
    assert lines[0] == "0" * 32                          # process.c:80
    assert lines[1] == "00000000000000000000000000100000"  # :94
    assert lines[2] == "01000000000000000000000000000000"  # :96
    assert lines[3] == "0" * 32                          # :98


def test_cli_end_to_end(tmp_path):
    """keygen -> fixtures -> encrypt x2 -> cloud -> verify, tiny params."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", IEACHE_PLATFORM="cpu",
               PYTHONPATH=repo_root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    d = str(tmp_path)

    def run(*args):
        r = subprocess.run(
            [sys.executable, "-m", "ieache.cli.main", *args],
            cwd=d, env=env, capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    run("keygen", "--params", "test_tiny", "--out", d)
    run("fixtures", "--width", "32", "--value", "1000",
        "--out", os.path.join(d, "a.txt"))
    run("fixtures", "--width", "32", "--value", "-234",
        "--out", os.path.join(d, "b.txt"))
    run("encrypt", "--keys", d, "--values", os.path.join(d, "a.txt"),
        "--out", os.path.join(d, "a.data"))
    run("encrypt", "--keys", d, "--values", os.path.join(d, "b.txt"),
        "--out", os.path.join(d, "b.data"))
    run("cloud", os.path.join(d, "a.data"), os.path.join(d, "b.data"),
        "--keys", d, "--op", "1", "--out", os.path.join(d, "answer.data"))
    out = run("verify", "--keys", d, "--answer",
              os.path.join(d, "answer.data"), "--op", "1")
    assert "Answer: 766" in out  # 1000 + (-234)

    run("reset", "--dir", d)
    assert not os.path.exists(os.path.join(d, "answer.data"))


def test_cli_interactive_sim(tmp_path):
    """The reference-style interactive prompt loop
    (`output_dynamic.py:1055-1245`): expression prompt + postfix echo,
    re-prompt on a short expression, value prompts, answers printed."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", IEACHE_PLATFORM="cpu",
               PYTHONPATH=repo_root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "ieache.cli.main", "interactive",
         "--params", "test_tiny", "--width", "8"],
        input="A\nA + B - C\n30\n12\n50\n",
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Hello!" in r.stdout
    assert "at least 2 letters" in r.stdout        # re-prompt path
    assert "Postfix Expression: AB+C-" in r.stdout
    assert "Answer: -8" in r.stdout


def test_cli_interactive_rejects_mixed_ops(tmp_path):
    """The reference EXITS on the +/* filter (output_dynamic.py:1080)."""
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", IEACHE_PLATFORM="cpu",
               PYTHONPATH=repo_root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "ieache.cli.main", "interactive",
         "--params", "test_tiny"],
        input="A + B * C\n", cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 1
    assert ("addition and multiplication operation cannot be "
            "processed") in r.stdout
