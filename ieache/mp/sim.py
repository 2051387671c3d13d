"""In-process multi-party simulation — the six-node topology on loopback.

The reference hardcodes six hosts and systemd services and has no way
to test without a cluster (SURVEY §4); this module runs the full
Keygen -> {Output, Clients, Cloud} key distribution and the
Output -> Cloud -> Clients expression flow in one process over real
sockets, exercising every protocol layer (SAE, AES key wrap, BER
messages, stop-and-wait transfers, postfix scheduling, homomorphic
evaluation, answer decryption).
"""

from __future__ import annotations

import dataclasses

from ieache.mp.config import NetworkConfig, localhost_config
from ieache.mp.nodes import (
    ClientNode,
    CloudNode,
    KeygenNode,
    OutputNode,
)


@dataclasses.dataclass
class SimResult:
    values: list           # decoded expression results (one per batch lane)
    timings: list          # per-op evaluator timings from the cloud
    served_roles: list     # keygen's key-distribution log
    gate_count: int        # total bootstrapped gates evaluated


def run_full_flow(
    postfix: str,
    client_values: dict,
    width: int,
    params,
    password: str | None = None,
    adder: str = "ripple",
    pair=None,
    cfg: NetworkConfig | None = None,
) -> SimResult:
    """Run the complete IE-ACHE flow in-process.

    postfix: e.g. "AB+C-"; client_values: {"A": [3, 4], ...} (all
    letters same batch length); width: operand bit width.
    """
    letters = sorted(client_values)
    cfg = cfg or localhost_config()

    keygen = KeygenNode(params, password, pair=pair, cfg=cfg)
    kaddr = keygen.start(cfg.keygen.host, cfg.keygen.key_port)

    output = OutputNode(password, cfg=cfg)
    oaddr = output.start_indicator_server(cfg.output.host,
                                          cfg.output.key_port)

    clients = {}
    for i, letter in enumerate(letters):
        c = ClientNode(i + 1, password, cfg=cfg)
        c.set_value(client_values[letter], width)
        clients[letter] = c

    # key plane: Output first, then clients, then Cloud
    # (`dragonfly_private_keygen.py:704-728` admission order)
    output.receive_keys(kaddr)
    for letter in letters:
        clients[letter].receive_keys(kaddr)
    cloud = CloudNode(password, adder=adder, cfg=cfg)
    cloud.receive_keys(kaddr)
    keygen.notify_finished(oaddr)
    output.wait_finished()

    # data plane
    client_addrs = {
        letter: clients[letter].start_data_server(
            cfg.clients[i].host, cfg.clients[i].data_port
        )
        for i, letter in enumerate(letters)
    }
    cloud_addr = cloud.start_job_server(cfg.cloud.host,
                                        cfg.cloud.data_port)
    try:
        values = output.submit_job(cloud_addr, postfix, client_addrs)
    finally:
        for c in clients.values():
            c.stop()
        cloud.stop()
        keygen.stop()
        output.stop()

    return SimResult(
        values=values,
        timings=cloud.timings,
        served_roles=keygen.served,
        gate_count=cloud.evaluator.gate_count if cloud.evaluator else 0,
    )
