"""Multi-process deployment: the six-role topology as REAL OS processes.

The reference deploys one script stack per host under systemd
(`README.md:63-71`, `Client1/Services/MP.service:1-10`); the
in-process sim (`mp/sim.py`) exercises the protocol but not process
isolation.  Here keygen, two clients, and cloud run as separate
`python -m ieache.cli.main serve` subprocesses on loopback (the
deployment path itself), and the Output role drives an expression
through them from the test process — key fan-out, SAE handshakes, BER
framing, ciphertext pulls, evaluation, and answer decryption all
cross real process + socket boundaries.
"""

import os
import socket
import subprocess
import sys
import time

import pytest

from ieache import params as P


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _spawn(args, cwd, env):
    return subprocess.Popen(
        [sys.executable, "-m", "ieache.cli.main", "serve"] + args,
        cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


@pytest.mark.slow
def test_multiprocess_expression_flow(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        IEACHE_PLATFORM="cpu",
        PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        PYTHONUNBUFFERED="1",
    )
    pk, pc1, pc2, pcl, po = _free_ports(5)
    kaddr = f"127.0.0.1:{pk}"

    procs = []
    try:
        procs.append(_spawn(
            ["--role", "keygen", "--params", "test_tiny",
             "--bind", "127.0.0.1", "--port", str(pk),
             "--expect-peers", "4",
             "--output-addr", f"127.0.0.1:{po}",
             "--clients", "127.0.0.1,127.0.0.1",
             "--discover-port", str(pk)],
            tmp_path, env,
        ))
        for idx, port, val in [(1, pc1, 30), (2, pc2, 12)]:
            procs.append(_spawn(
                ["--role", "client", "--index", str(idx),
                 "--keygen-addr", kaddr,
                 "--bind", "127.0.0.1", "--port", str(port),
                 "--value", str(val), "--width", "8"],
                tmp_path, env,
            ))
        procs.append(_spawn(
            ["--role", "cloud", "--keygen-addr", kaddr,
             "--bind", "127.0.0.1", "--port", str(pcl)],
            tmp_path, env,
        ))

        # Output role in this process: keys, 'finished', job, answer
        from ieache.mp import nodes

        out = nodes.OutputNode()
        out.start_indicator_server("127.0.0.1", po)
        out.receive_keys(("127.0.0.1", pk))
        out.wait_finished(timeout=120)
        got = out.submit_job(
            ("127.0.0.1", pcl), "AB-",
            {"A": ("127.0.0.1", pc1), "B": ("127.0.0.1", pc2)},
            timeout=120,
        )
        assert got == [30 - 12]

        # every serve process is still alive (long-lived role servers)
        for p in procs:
            assert p.poll() is None, p.stdout.read()
        out.stop()
    finally:
        for p in procs:  # kill exact PIDs we spawned, never by pattern
            p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


@pytest.mark.slow
def test_serve_keygen_prints_hostup_and_finished(tmp_path):
    """The keygen role's discovery + 'finished' sequencing
    (`keygen_dynamic.py:22-55`): hostup count printed before serving,
    'finished' sent once expected peers are served."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        IEACHE_PLATFORM="cpu",
        PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
        PYTHONUNBUFFERED="1",
    )
    pk, po, dead = _free_ports(3)
    p = _spawn(
        ["--role", "keygen", "--params", "test_tiny",
         "--bind", "127.0.0.1", "--port", str(pk),
         "--expect-peers", "1",
         "--output-addr", f"127.0.0.1:{po}",
         # a dead service: a just-freed loopback port refuses connects
         # (external IPs are unusable for this here — the sandbox's
         # transparent proxy accepts TCP to anything)
         "--clients", "127.0.0.1", "--discover-port", str(dead)],
        tmp_path, env,
    )
    try:
        from ieache.mp import nodes

        out = nodes.OutputNode()
        out.start_indicator_server("127.0.0.1", po)
        out.receive_keys(("127.0.0.1", pk))
        out.wait_finished(timeout=120)
        assert out.main_ks is not None
        out.stop()
        p.kill()
        stdout = p.stdout.read()
        assert "hostup: 0/1" in stdout
        assert f"keygen serving on 127.0.0.1:{pk}" in stdout
        assert "finished signal sent" in stdout
    finally:
        p.kill()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
