"""The four protocol roles: Keygen, Client, Cloud, Output.

Counterparts of the reference's per-node script stacks
(components C15-C22; see SURVEY §2):

* KeygenNode — `Keygen/dragonfly_private_keygen.py:548-728` +
  `dragonfly_public_keygen.py:553-722` + `keygen_dynamic.py:22-55`:
  generates the two keysets once, serves secret keys to Output and
  clients and the cloud key to Cloud (SAE per peer, AES-wrapped
  DataKey chunks), then signals "finished" to Output.
* ClientNode — `Client1/dragonfly_private_client.py:548-669` (key
  receive) + `dragonfly_cipher_client.py:41-167` (ciphertext serve):
  on each Cloud pull it re-encrypts its value (the ./alice run) and
  streams the operand with stop-and-wait acks.
* CloudNode — `Cloud/dragonfly_public_cloud.py:541-651` (key receive)
  + `dragonfly_cipher_cloud.py:512-1456` (job orchestrator): receives
  the AES-wrapped job descriptor, walks the postfix expression pulling
  operands, evaluates on the accelerator, ships the answer.
* OutputNode — `Output/output_dynamic.py:26-1252` +
  `dragonfly_private_Output.py`: obtains secret keys, submits the job,
  receives and decrypts the answer.

All listeners bind dynamic loopback ports by default so the whole
six-role topology runs in-process (the multi-node test harness the
reference lacks, SURVEY §4); point them at real interfaces for a
multi-host deployment.
"""

from __future__ import annotations

import hashlib
import logging
import socket
import threading

import jax
import numpy as np

from ieache.circuits import evaluator as ev
from ieache.codec import files, schema
from ieache.lwe import keygen as kg
from ieache.lwe.types import CloudKeySet, GateKeyPair, SecretKeySet
from ieache.mp import keywrap, liveness, scheduler, transport, wire
from ieache.mp.config import NetworkConfig
from ieache.utils import prng, trace

DEFAULT_WIDTH = 32

log = logging.getLogger("ieache.mp.nodes")


def _listener(handler, host="127.0.0.1", port=0):
    """Start a threaded accept loop; returns (addr, server_socket)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(8)
    addr = srv.getsockname()

    def loop():
        while True:
            try:
                conn, peer = srv.accept()
            except OSError:
                return  # listener closed
            t = threading.Thread(
                target=handler, args=(conn, peer), daemon=True
            )
            t.start()

    threading.Thread(target=loop, daemon=True).start()
    return addr, srv


def _send_keypair(sock, pmk, key_blob: bytes, nbit_blob: bytes,
                  chunk: int = 8192, digest: str | None = None):
    """AES-wrap and stream both blobs as paired DataKey chunks
    (`dragonfly_private_keygen.py:644-682`), then cross-check the
    plaintext digests with the receiver (the reference prints md5sums
    on both ends for a *manual* compare,
    `dragonfly_private_keygen.py:676-680` /
    `dragonfly_private_client.py:665-669` — here the compare is part
    of the protocol and a mismatch aborts the transfer)."""
    wrapped_k = keywrap.encrypt_bytes(pmk, key_blob)
    wrapped_n = keywrap.encrypt_bytes(pmk, nbit_blob)
    transport.send_msg(
        sock, schema.DataFsize, {"data": len(wrapped_k)}
    )
    transport.recv_ack(sock)
    transport.send_msg(
        sock, schema.DataFsize, {"data": len(wrapped_n)}
    )
    transport.recv_ack(sock)
    nchunks = max(
        (len(wrapped_k) + chunk - 1) // chunk,
        (len(wrapped_n) + chunk - 1) // chunk,
    )
    for i in range(nchunks):
        transport.send_msg(
            sock, schema.DataKey,
            {
                "key": wrapped_k[i * chunk:(i + 1) * chunk],
                "nbit": wrapped_n[i * chunk:(i + 1) * chunk],
            },
        )
        if not transport.recv_ack(sock):
            raise ConnectionError("key chunk rejected")
    if digest is None:  # plaintext digests are constant across peers —
        # KeygenNode precomputes them once (md5 of 66 MB per peer was
        # ~25% of the fan-out's CPU, r5 keyplane profile)
        digest = (hashlib.md5(key_blob).hexdigest() + ","
                  + hashlib.md5(nbit_blob).hexdigest())
    transport.send_msg(sock, schema.DataMd5, {"data": digest})
    if not transport.recv_ack(sock):
        raise ConnectionError("key transfer digest mismatch")


def _recv_keypair(sock, pmk):
    size_k = transport.recv_msg(sock, schema.DataFsize)["data"]
    transport.send_ack(sock)
    size_n = transport.recv_msg(sock, schema.DataFsize)["data"]
    transport.send_ack(sock)
    # accumulate chunks in lists: quadratic bytes-append on ~33 MB of
    # lambda=110 key material in 8 KiB chunks cost ~13 s per peer
    # (measured r4, tools/keyplane_bench.py) vs ~0.4 s with join
    parts_k, parts_n = [], []
    got_k = got_n = 0
    while got_k < size_k or got_n < size_n:
        values = transport.recv_msg(sock, schema.DataKey)
        parts_k.append(values["key"])
        parts_n.append(values["nbit"])
        got_k += len(values["key"])
        got_n += len(values["nbit"])
        transport.send_ack(sock)
    key_blob = keywrap.decrypt_bytes(pmk, b"".join(parts_k)[:size_k])
    nbit_blob = keywrap.decrypt_bytes(pmk, b"".join(parts_n)[:size_n])
    want = transport.recv_msg(sock, schema.DataMd5)["data"]
    got = (hashlib.md5(key_blob).hexdigest() + ","
           + hashlib.md5(nbit_blob).hexdigest())
    ok = got == want
    transport.send_ack(sock, ok)
    if not ok:
        raise ConnectionError(
            f"key transfer digest mismatch: {got} != {want}"
        )
    log.info("key pair received (%d + %d bytes, md5 ok)",
             len(key_blob), len(nbit_blob))
    return key_blob, nbit_blob


class KeygenNode:
    """Key generation + distribution (C1, C15-C17)."""

    def __init__(self, params, password: str | None = None,
                 pair: GateKeyPair | None = None,
                 cfg: NetworkConfig | None = None):
        self.cfg = cfg or NetworkConfig()
        self.password = password or self.cfg.password
        self.pair = pair or kg.generate_gate_keypair(params)
        self.mac = "keygen"
        self._secret_blob = files.dumps_container(
            self.pair.main.params,
            {
                "lwe_s": self.pair.main.lwe_key.s,
                "trlwe_k": self.pair.main.trlwe_key.coefs,
                "bk": self.pair.main.cloud.bk,
                "ks": self.pair.main.cloud.ks,
            },
            kind="secret_keyset",
        )
        self._nbit_blob = files.dumps_container(
            self.pair.nbit.params,
            {
                "lwe_s": self.pair.nbit.lwe_key.s,
                "trlwe_k": self.pair.nbit.trlwe_key.coefs,
                "bk": self.pair.nbit.cloud.bk,
                "ks": self.pair.nbit.cloud.ks,
            },
            kind="secret_keyset",
        )
        self._cloud_blob = files.dumps_container(
            self.pair.main.params,
            {"bk": self.pair.main.cloud.bk, "ks": self.pair.main.cloud.ks},
            kind="cloud_keyset",
        )
        self._secret_digest = (
            hashlib.md5(self._secret_blob).hexdigest() + ","
            + hashlib.md5(self._nbit_blob).hexdigest()
        )
        self._cloud_digest = (
            hashlib.md5(self._cloud_blob).hexdigest() + ","
            + hashlib.md5(self._nbit_blob).hexdigest()
        )
        self.served = []
        self.refused = []

    def start(self, host="127.0.0.1", port=0,
              clients: list | None = None, cloud_role: str = "cloud",
              admit_timeout: float = 30.0,
              defer_clients: bool = False):
        """Key-plane server with enforced admission control.

        The reference's secret-key server admits Output FIRST, then
        exactly the ping-discovered clients, skipping Cloud
        (`dragonfly_private_keygen.py:704-728`), and its cloud-key
        server accepts only the configured Cloud identity
        (`dragonfly_public_keygen.py:570-574`).  Here:

        * role ``"output"`` — admitted immediately, served the secret
          keyset;
        * a role in the ``clients`` allowlist — served the secret
          keyset, but only AFTER Output has been served (admission
          order); feed :meth:`discover` results in for the reference's
          ping-gated list.  Default allowlist: the configured topology
          ``client-1..client-len(cfg.clients)``;
        * role == ``cloud_role`` — served the evaluation keyset (+ the
          nbit secret keyset: the reference hands Cloud the nbit
          *secret* key for metadata, SURVEY Appendix A), after Output
          (and, when an explicit allowlist was given, after every
          allowlisted client) has been served.  The cloud role can
          never obtain the main secret blob;
        * any other role — refused: the connection is closed after the
          SAE handshake with no key material sent.

        Identity is the SAE-declared role string (the reference's
        equivalent is the source IP); both are peer-asserted — the
        allowlist bounds *which asserted identities* are served, the
        password bounds who can assert one.

        ``defer_clients=True`` starts the listener with the allowlist
        pending: client/cloud connections wait until
        :meth:`set_admitted_clients` supplies it (so discovery can
        probe services that only come up once this server is bound).
        """
        self._allow_ready = threading.Event()
        self._output_served = threading.Event()
        self._clients_served = threading.Event()
        self._served_clients: set = set()
        self._admit_lock = threading.Lock()
        if defer_clients:
            self._allow = None
            self._gate_cloud_on_clients = True
        elif clients is None:
            self._allow = [f"client-{i + 1}"
                           for i in range(len(self.cfg.clients))]
            self._gate_cloud_on_clients = False
            self._allow_ready.set()
        else:
            self.set_admitted_clients(clients)

        def _record_client(role):
            with self._admit_lock:
                self._served_clients.add(role)
                if set(self._allow) <= self._served_clients:
                    self._clients_served.set()

        def handle(conn, peer):
            role = "?"
            try:
                pmk, role = transport.sae_handshake(
                    conn, self.password, self.mac
                )
                if role == "output":
                    _send_keypair(conn, pmk, self._secret_blob,
                                  self._nbit_blob,
                                  chunk=self.cfg.key_chunk_size,
                                  digest=self._secret_digest)
                    self.served.append(role)
                    self._output_served.set()
                elif role == cloud_role:
                    ok = (self._allow_ready.wait(admit_timeout)
                          and self._output_served.wait(admit_timeout))
                    if ok and self._gate_cloud_on_clients:
                        ok = self._clients_served.wait(admit_timeout)
                    if not ok:
                        raise PermissionError(
                            "cloud admission before output/clients")
                    _send_keypair(conn, pmk, self._cloud_blob,
                                  self._nbit_blob,
                                  chunk=self.cfg.key_chunk_size,
                                  digest=self._cloud_digest)
                    self.served.append(role)
                elif (self._allow_ready.wait(admit_timeout)
                      and role in self._allow):
                    if not self._output_served.wait(admit_timeout):
                        raise PermissionError(
                            "client admission before output")
                    _send_keypair(conn, pmk, self._secret_blob,
                                  self._nbit_blob,
                                  chunk=self.cfg.key_chunk_size,
                                  digest=self._secret_digest)
                    self.served.append(role)
                    _record_client(role)
                else:
                    raise PermissionError(f"role {role!r} not admitted")
                log.info("keygen: served %s keys to %s",
                         "cloud" if role == cloud_role else "secret",
                         role)
            except PermissionError as e:
                self.refused.append(role)
                log.warning("keygen: refused %s (%s)", role, e)
            except (ConnectionError, OSError, ValueError):
                # liveness probes are bare connect+close; a dropped
                # SAE handshake is not an admission event
                log.debug("keygen: connection dropped (probe?)")
            finally:
                conn.close()

        self.addr, self._srv = _listener(handle, host, port)
        return self.addr

    def set_admitted_clients(self, clients: list):
        """Supply the client allowlist (e.g. from :meth:`discover`)
        for a server started with ``defer_clients=True``; admission
        then gates Cloud on every listed client being served first
        (the reference's private-then-public server ordering)."""
        self._allow = list(clients)
        self._gate_cloud_on_clients = True
        if not self._allow:
            self._clients_served.set()
        self._allow_ready.set()

    def discover(self, hosts, port: int | None = None) -> list:
        """Ping-discovery of live client hosts before admission
        (`dragonfly_private_keygen.py:685-689` — the reference counts
        `hostup` over pings to 192.168.0.21-23)."""
        up = [h for h in hosts if liveness.host_alive(h, port)]
        log.info("keygen: discovery %d/%d hosts up", len(up), len(hosts))
        return up

    def notify_finished(self, output_addr):
        s = transport.connect_retry(
            *output_addr, retries=self.cfg.connect_retries,
            delay=self.cfg.connect_retry_s,
        )
        try:
            transport.send_msg(
                s, schema.DataIndicator, {"data": "finished"}
            )
        finally:
            s.close()

    def stop(self):
        if getattr(self, "_srv", None) is not None:
            self._srv.close()


class ClientNode:
    """Value holder + encryptor + ciphertext server (C2, C3, C18, C19)."""

    def __init__(self, index: int, password: str | None = None,
                 cfg: NetworkConfig | None = None):
        self.index = index
        self.cfg = cfg or NetworkConfig()
        self.password = password or self.cfg.password
        self.mac = f"client-{index}"
        self.main_ks: SecretKeySet | None = None
        self.nbit_ks: SecretKeySet | None = None
        self.values = None
        self.width = DEFAULT_WIDTH
        self._serve_count = 0

    def receive_keys(self, keygen_addr):
        s = transport.connect_retry(
            *keygen_addr, retries=self.cfg.connect_retries,
            delay=self.cfg.connect_retry_s,
        )
        try:
            pmk, _ = transport.sae_handshake(s, self.password, self.mac)
            secret_blob, nbit_blob = _recv_keypair(s, pmk)
        finally:
            s.close()
        self.main_ks = _secret_from_blob(secret_blob)
        self.nbit_ks = _secret_from_blob(nbit_blob)

    def set_value(self, values, width: int = DEFAULT_WIDTH):
        self.values = list(values)
        self.width = width

    def encrypt_operand(self) -> ev.Operand:
        """The ./alice run (`dragonfly_cipher_client.py:49`)."""
        self._serve_count += 1
        stream = prng.fresh_stream(0xC11E27, self.index,
                                   self._serve_count)
        return ev.encrypt_operand(
            self.main_ks, self.nbit_ks, self.values, self.width, stream
        )

    def start_data_server(self, host="127.0.0.1", port=0):
        def handle(conn, peer):
            try:
                # an explicit request precedes encryption so liveness
                # probes (bare connect+close) don't trigger an ./alice
                # run; the reference encrypts on accept
                # (`dragonfly_cipher_client.py:49`)
                req = transport.recv_msg(conn, schema.DataIndicator)
                if req["data"] != "request":
                    return
                op = self.encrypt_operand()
                blob = wire.operand_to_bytes(
                    op, self.main_ks.params, self.nbit_ks.params
                )
                transport.send_blob(conn, blob,
                                    chunk=self.cfg.chunk_size)
                log.info("client-%d: served operand (%d bytes) to %s",
                         self.index, len(blob), peer)
            except (ConnectionError, OSError):
                log.debug("client-%d: connection dropped (probe?)",
                          self.index)
            finally:
                conn.close()

        self.addr, self._srv = _listener(handle, host, port)
        return self.addr

    def stop(self):
        if getattr(self, "_srv", None) is not None:
            self._srv.close()


class CloudNode:
    """Evaluator + job orchestrator (C10, C20, C21)."""

    def __init__(self, password: str | None = None,
                 adder: str = "ripple",
                 cfg: NetworkConfig | None = None):
        self.cfg = cfg or NetworkConfig()
        self.password = password or self.cfg.password
        self.mac = "cloud"
        self.adder = adder
        self.evaluator: ev.CloudEvaluator | None = None
        self.client_addrs = {}
        self.timings = []
        #: structured spans/counters (utils.trace) — the reference's
        #: timings.txt role (`dragonfly_cipher_cloud.py:902-908`)
        self.trace = trace.Timings()

    def receive_keys(self, keygen_addr):
        import ieache.boot.bootstrap as boot

        s = transport.connect_retry(
            *keygen_addr, retries=self.cfg.connect_retries,
            delay=self.cfg.connect_retry_s,
        )
        try:
            pmk, _ = transport.sae_handshake(s, self.password, self.mac)
            cloud_blob, nbit_blob = _recv_keypair(s, pmk)
        finally:
            s.close()
        params, arrays, _ = files.loads_container(cloud_blob,
                                                  "cloud_keyset")
        cloud = CloudKeySet(
            params, arrays["bk"].astype(np.int32),
            arrays["ks"].astype(np.int32),
        )
        nbit_ks = _secret_from_blob(nbit_blob)
        self.evaluator = ev.CloudEvaluator(
            boot.pack_cloud_key(cloud), nbit_ks, adder=self.adder
        )

    def register_clients(self, letter_to_addr: dict):
        """letter ('A'..) -> client data-server address."""
        self.client_addrs = dict(letter_to_addr)

    def _fetch(self, letter):
        """Pull an operand stream (cipher()/cipher_ab() equivalent)."""
        addr = self.client_addrs[letter]
        with self.trace.span("data_request", letter=letter):
            s = transport.connect_retry(
                *addr, retries=self.cfg.connect_retries,
                delay=self.cfg.connect_retry_s,
            )
            try:
                transport.send_msg(s, schema.DataIndicator,
                                   {"data": "request"})
                blob = transport.recv_blob(s)
            finally:
                s.close()
        return wire.operand_from_bytes(blob)

    def run_job(self, postfix: str):
        """Walk the expression; returns (answer Operand, final op).

        Left-fold expressions (the only multi-op shape the wire cap
        admits) compile to ONE circuit via compute_chain; anything
        else falls back to the per-op postfix walk.  IEACHE_CHAIN=0
        forces the per-op walk (the reference's one-./cloud-run-per-op
        structure, `dragonfly_cipher_cloud.py:1219-1327`)."""
        import os

        log.info("cloud: running job %s", postfix)
        letters, op_chars, steps = scheduler.plan_postfix(postfix)
        if len(steps) > 1 and \
                os.environ.get("IEACHE_CHAIN", "1") != "0":
            operands = [self._fetch(letter) for letter in letters]
            ev_steps = [
                (scheduler.OPCODES[c], lhs, rhs) for c, lhs, rhs in steps
            ]
            before = self.evaluator.gate_count
            with self.trace.span("compute_chain", ops="".join(op_chars)):
                ans, info = self.evaluator.compute_steps(
                    ev_steps, operands
                )
                # fence, so the span is the compute time and not
                # the enqueue time
                jax.block_until_ready(ans.value)
            self.trace.count("bootstraps",
                             self.evaluator.gate_count - before)
            self.timings.append(
                {**info, "op": "".join(op_chars),
                 "seconds": self.trace.spans[-1]["seconds"]}
            )
            return ans, op_chars[-1]

        def compute(op_char, a, b):
            before = self.evaluator.gate_count
            with self.trace.span(f"compute:{op_char}"):
                ans, info = self.evaluator.compute(
                    scheduler.OPCODES[op_char], a, b
                )
                jax.block_until_ready(ans.value)  # fence (see above)
            self.trace.count("bootstraps",
                             self.evaluator.gate_count - before)
            self.timings.append(
                {"op": op_char,
                 "seconds": self.trace.spans[-1]["seconds"], **info}
            )
            return ans

        return scheduler.walk_postfix(postfix, self._fetch, compute)

    def start_job_server(self, host="127.0.0.1", port=0):
        """Accept a job from Output over SAE; reply with the answer."""
        def handle(conn, peer):
            try:
                # job_receive: SAE + descriptor decode — the Cloud half
                # of the reference's "user-input processing" phase
                # (`dragonfly_cipher_cloud.py:600-715`)
                with self.trace.span("job_receive"):
                    pmk, _ = transport.sae_handshake(
                        conn, self.password, self.mac
                    )
                    job = transport.recv_msg(conn, schema.DataUserInput)
                    postfix = keywrap.decrypt_bytes(
                        pmk, job["postfix"]["postfix"]
                    ).decode()
                    # client endpoints ride the ipaddress fields as
                    # "letter=host:port" (AES-wrapped like the
                    # reference's per-field blobs,
                    # output_dynamic.py:748-867)
                    for fld in ("ipaddress1", "ipaddress2",
                                "ipaddress3"):
                        raw = job["ipaddress"].get(fld)
                        if not raw:
                            continue
                        txt = keywrap.decrypt_bytes(pmk, raw).decode()
                        letter, hostport = txt.split("=", 1)
                        host, port = hostport.rsplit(":", 1)
                        self.client_addrs[letter] = (host, int(port))
                transport.send_ack(conn)
                try:
                    answer, last_op = self.run_job(postfix)
                except (scheduler.JobError, ev.MulWidthError) as e:
                    log.warning("cloud: job %s failed: %s", postfix, e)
                    transport.send_msg(
                        conn, schema.DataIndicator,
                        {"data": f"error: {e}"},
                    )
                    return
                with self.trace.span("answer_ship"):
                    blob = wire.operand_to_bytes(
                        answer,
                        self.evaluator.dck.params,
                        self.evaluator.nbit_ks.params,
                    )
                    transport.send_msg(
                        conn, schema.DataIndicator, {"data": "answer"}
                    )
                    transport.send_blob(
                        conn, blob,
                        size_schema=schema.DataAnsSize,
                        content_schema=schema.DataAnswer,
                        chunk=self.cfg.chunk_size,
                    )
                log.info("cloud: answer shipped (%d bytes)", len(blob))
            finally:
                conn.close()

        self.addr, self._srv = _listener(handle, host, port)
        return self.addr

    def stop(self):
        if getattr(self, "_srv", None) is not None:
            self._srv.close()


class OutputNode:
    """User-facing driver + decryptor (C11, C18, C22)."""

    def __init__(self, password: str | None = None,
                 cfg: NetworkConfig | None = None):
        self.cfg = cfg or NetworkConfig()
        self.password = password or self.cfg.password
        self.mac = "output"
        self.main_ks: SecretKeySet | None = None
        self.nbit_ks: SecretKeySet | None = None
        self._finished = threading.Event()
        #: structured spans — the reference Output's timings.txt role
        #: (`output_dynamic.py:736-743,849-857,1037-1041`)
        self.trace = trace.Timings()

    def receive_keys(self, keygen_addr):
        s = transport.connect_retry(
            *keygen_addr, retries=self.cfg.connect_retries,
            delay=self.cfg.connect_retry_s,
        )
        try:
            pmk, _ = transport.sae_handshake(s, self.password, self.mac)
            secret_blob, nbit_blob = _recv_keypair(s, pmk)
        finally:
            s.close()
        self.main_ks = _secret_from_blob(secret_blob)
        self.nbit_ks = _secret_from_blob(nbit_blob)

    def start_indicator_server(self, host="127.0.0.1", port=0):
        def handle(conn, peer):
            try:
                msg = transport.recv_msg(conn, schema.DataIndicator)
                if msg["data"] == "finished":
                    self._finished.set()
            finally:
                conn.close()

        self.addr, self._srv = _listener(handle, host, port)
        return self.addr

    def wait_finished(self, timeout=60):
        if not self._finished.wait(timeout):
            raise TimeoutError("keygen never signalled 'finished'")

    def submit_job(self, cloud_addr, postfix: str,
                   client_addrs: dict, timeout=600,
                   check_liveness: bool = True):
        """SAE with Cloud, send the job, receive + decode the answer.

        Every operand host is validated (IPv4 format + liveness probe)
        before the job is sent — the reference's per-operand
        `validateIP` + ping gate (`output_dynamic.py:1096-1113`)."""
        from ieache.cli import convert

        s = None
        try:
            # "user-input processing" (`AC058.pdf` p.4 §III.E, mean
            # 6.90 s; hook `output_dynamic.py:849-857`): validation +
            # SAE with Cloud + per-field AES wrap + BER job send + ack
            with self.trace.span("user_input_processing",
                                 postfix=postfix):
                for letter in sorted(client_addrs):
                    chost, cport = client_addrs[letter]
                    if not convert.validate_ipv4(chost):
                        raise ValueError(
                            f"Invalid IP address for operand "
                            f"{letter}: {chost!r}"
                        )
                    if check_liveness and not liveness.host_alive(
                            chost, cport):
                        raise ValueError(
                            f"Host for operand {letter} "
                            f"({chost}:{cport}) is not alive"
                        )
                s = transport.connect_retry(
                    *cloud_addr, retries=self.cfg.connect_retries,
                    delay=self.cfg.connect_retry_s,
                )
                s.settimeout(timeout)
                pmk, _ = transport.sae_handshake(s, self.password,
                                                 self.mac)
                letters, _ops = scheduler.parse_postfix(postfix)
                ipfields = {}
                for i, letter in enumerate(letters):
                    host, port = client_addrs[letter]
                    ipfields[f"ipaddress{i + 1}"] = \
                        keywrap.encrypt_bytes(
                            pmk, f"{letter}={host}:{port}".encode()
                        )
                opfields = {
                    f"operation{i + 1}": keywrap.encrypt_bytes(
                        pmk, str(scheduler.OPCODES[c]).encode()
                    )
                    for i, c in enumerate(_ops)
                }
                transport.send_msg(
                    s, schema.DataUserInput,
                    {
                        "ipaddress": ipfields,
                        "operation": opfields,
                        "postfix": {
                            "postfix": keywrap.encrypt_bytes(
                                pmk, postfix.encode()
                            )
                        },
                    },
                )
                if not transport.recv_ack(s):
                    raise ConnectionError("job rejected")
            with self.trace.span("answer_wait", postfix=postfix):
                status = transport.recv_msg(
                    s, schema.DataIndicator)["data"]
                if status != "answer":
                    raise RuntimeError(status)
                blob = transport.recv_blob(
                    s,
                    size_schema=schema.DataAnsSize,
                    content_schema=schema.DataAnswer,
                )
        finally:
            if s is not None:
                s.close()
        # the ./verif role (`Output/verif.c`)
        with self.trace.span("verify", postfix=postfix):
            answer = wire.operand_from_bytes(blob)
            last_op = _ops[-1]
            return ev.decrypt_answer(
                self.main_ks, self.nbit_ks, answer,
                scheduler.OPCODES[last_op],
            )

    def stop(self):
        if getattr(self, "_srv", None) is not None:
            self._srv.close()


def _secret_from_blob(blob: bytes) -> SecretKeySet:
    from ieache.lwe.types import LweKey, TrlweKey

    params, a, _ = files.loads_container(blob, "secret_keyset")
    return SecretKeySet(
        params,
        LweKey(params, a["lwe_s"].astype(np.int32)),
        TrlweKey(params, a["trlwe_k"].astype(np.int32)),
        CloudKeySet(params, a["bk"].astype(np.int32),
                    a["ks"].astype(np.int32)),
    )
