#!/usr/bin/env python
"""Full-system lambda=110 end-to-end benchmark (VERDICT r4 #2).

Six roles as REAL OS processes over loopback sockets at full
parameters, with the Cloud evaluator on the GPU (E2E_FORCE_CPU=1 for a
CPU smoke run) and every other role pinned to the CPU, so that one
process holds the card; driving the
reference's complete flow:

  keygen (keygen-once mode, .keycache) -> SAE key fan-out to Output +
  3 clients + Cloud -> 'finished' -> Output submits A+B-C and A-B*C ->
  Cloud pulls per-operand ciphertexts from the clients (the ./alice
  runs), evaluates homomorphically, ships the answer -> Output
  decrypts and VERIFIES the plaintext results.

Every phase maps row-for-row onto BASELINE.md (`AC058.pdf` p.4):

  key exchange            <-> Fig.9/Fig.10 (62.3-93.7 s)
  user-input processing   <-> SIII.E mean 6.90 s
                              (hooks `output_dynamic.py:849-857`,
                              `dragonfly_cipher_cloud.py:600-715`)
  data request / operand  <-> SIII.E mean 15.4 s
                              (hook `dragonfly_cipher_cloud.py:902-908`)
  compute A+B-C / A-B*C   <-> Fig.7 149 s / 359 s
  answer ship + verify    <-> `output_dynamic.py:901-1042` + ./verif
  end-to-end total        <-> `output_dynamic.py:1037-1041`

Each expression is submitted twice: the first job carries the one-time
XLA compile (the reference has no analog — its binaries are prebuilt),
the second is the steady-state number used for the Fig.7 speedup
column (cold totals are reported alongside).

Env: E2E_PARAMS (ieache_110_l2), E2E_BATCH (1 — one expression lane,
the reference's geometry; raise for batched lanes), E2E_WIDTH (32),
E2E_EXPRS ("AB+C-,AB*C-" postfix), E2E_FORCE_CPU=1 (smoke),
E2E_TIMEOUT (3600 s per job).  Writes one JSON line to stdout;
progress to stderr.
"""

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REF = {
    "key_exchange_opt_s": 71.7,
    "key_exchange_pre_opt_s": 93.7,
    "user_input_processing_s": 6.90,
    "data_request_s": 15.4,
    "compute_s": {"AB+C-": 149.0, "AB*C-": 359.0},  # A+B-C / A-B*C
    "source": "AC058.pdf p.4 Fig.7/Fig.9/SIII.E (BASELINE.md)",
}


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


def _say(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def main():
    pname = os.environ.get("E2E_PARAMS", "ieache_110_l2")
    batch = int(os.environ.get("E2E_BATCH", 1))
    width = int(os.environ.get("E2E_WIDTH", 32))
    exprs = os.environ.get("E2E_EXPRS", "AB+C-,AB*C-").split(",")
    timeout = float(os.environ.get("E2E_TIMEOUT", 3600))
    force_cpu = os.environ.get("E2E_FORCE_CPU") == "1"

    # the Output role runs in this process on CPU (decrypt is host
    # work); only the Cloud subprocess opens the GPU
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    rng = np.random.RandomState(11)
    # operand values at FULL declared width (the reference's canned
    # value is 2^(n-2), `process.c:80-204` — ~(w-1)-bit operands): the
    # evaluator's width-asymmetric circuits must run the real w x w
    # multiply, not a short one.  [2^(w-3), 2^(w-2)) keeps A+B-C
    # positive while A-B*C goes deeply negative (sign path covered).
    lo = 1 << max(width - 3, 1)
    hi = 1 << max(width - 2, 2)
    vals = {
        "A": [int(rng.randint(lo, hi)) for _ in range(batch)],
        "B": [int(rng.randint(lo, hi)) for _ in range(batch)],
        "C": [int(rng.randint(lo, hi)) for _ in range(batch)],
    }

    keycache = os.path.join(REPO, ".keycache")
    pk, pc1, pc2, pc3, pcl, po = _free_ports(6)
    kaddr = f"127.0.0.1:{pk}"

    base_env = dict(
        os.environ,
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        PYTHONUNBUFFERED="1",
    )
    cpu_env = dict(base_env, IEACHE_PLATFORM="cpu")
    cloud_env = dict(base_env,
                     IEACHE_PLATFORM="cpu" if force_cpu else "gpu")

    tag = os.environ.get("E2E_TAG", str(os.getpid()))

    def spawn(args, env, logname):
        logf = open(os.path.join(logdir, f"e2e_{tag}_{logname}.log"), "w")
        return subprocess.Popen(
            [sys.executable, "-m", "ieache.cli.main", "serve"]
            + args, cwd=REPO, env=env, stdout=logf,
            stderr=subprocess.STDOUT, text=True,
        ), logf

    logdir = os.environ.get("E2E_LOGDIR",
                            os.path.join(REPO, "chiprun_out", "e2e"))
    os.makedirs(logdir, exist_ok=True)
    procs, logs = [], []
    result = {"probe": "e2e_lambda110", "params": pname,
              "batch": batch, "width": width,
              "adder": os.environ.get("E2E_ADDER", "ripple"),
              "cloud_backend": cloud_env["IEACHE_PLATFORM"],
              "mode": "six OS processes over loopback sockets",
              "values": vals, "reference": REF}
    t_all0 = time.time()
    try:
        _say("spawning keygen + 3 clients + cloud ...")
        t0 = time.time()
        pr, lf = spawn(
            ["--role", "keygen", "--params", pname,
             "--bind", "127.0.0.1", "--port", str(pk),
             "--expect-peers", "5",
             "--output-addr", f"127.0.0.1:{po}",
             "--clients", "127.0.0.1,127.0.0.1,127.0.0.1",
             "--discover-port", str(pk),
             "--keycache", keycache], cpu_env, "keygen")
        procs.append(pr)
        logs.append(lf)
        for i, (port, letter) in enumerate(
                [(pc1, "A"), (pc2, "B"), (pc3, "C")]):
            pr, lf = spawn(
                ["--role", "client", "--index", str(i + 1),
                 "--keygen-addr", kaddr,
                 "--bind", "127.0.0.1", "--port", str(port),
                 "--values", ",".join(map(str, vals[letter])),
                 "--width", str(width)], cpu_env, f"client{i + 1}")
            procs.append(pr)
            logs.append(lf)
        cloud_pr, lf = spawn(
            ["--role", "cloud", "--keygen-addr", kaddr,
             "--bind", "127.0.0.1", "--port", str(pcl),
             "--print-spans",
             "--adder", os.environ.get("E2E_ADDER", "ripple")],
            cloud_env, "cloud")
        procs.append(cloud_pr)
        logs.append(lf)

        from ieache.mp import nodes
        from ieache.mp.config import NetworkConfig

        # generous connect window: the lambda=110 keygen process needs
        # jax import + 66 MB keyset load + blob build (~15-30 s)
        # before it binds its listener
        out = nodes.OutputNode(
            cfg=NetworkConfig(connect_retries=1500,
                              connect_retry_s=0.2)
        )
        out.start_indicator_server("127.0.0.1", po)
        with out.trace.span("key_exchange"):
            out.receive_keys(("127.0.0.1", pk))
            out.wait_finished(timeout=1800)
        t_keyx = time.time() - t0
        _say(f"key plane complete in {t_keyx:.1f}s "
             f"(ref optimized: {REF['key_exchange_opt_s']}s)")
        result["key_exchange_wall_s"] = round(t_keyx, 3)
        result["key_exchange_output_span_s"] = round(
            out.trace.total("key_exchange"), 3)

        caddrs = {"A": ("127.0.0.1", pc1), "B": ("127.0.0.1", pc2),
                  "C": ("127.0.0.1", pc3)}
        runs = []
        for postfix in exprs:
            for attempt in ("cold", "warm"):
                _say(f"submitting {postfix} ({attempt}) ...")
                t0 = time.time()
                got = out.submit_job(("127.0.0.1", pcl), postfix,
                                     caddrs, timeout=timeout)
                dt = time.time() - t0
                a, b, c = vals["A"], vals["B"], vals["C"]
                if postfix == "AB+C-":
                    want = [x + y - z for x, y, z in zip(a, b, c)]
                elif postfix == "AB*C-":
                    want = [x * y - z for x, y, z in zip(a, b, c)]
                elif postfix == "AB+C+":
                    want = [x + y + z for x, y, z in zip(a, b, c)]
                else:
                    want = None
                ok = (want is None) or (got == want)
                _say(f"  {postfix} {attempt}: {dt:.1f}s "
                     f"decrypt_ok={ok}")
                runs.append({"postfix": postfix, "attempt": attempt,
                             "total_s": round(dt, 3),
                             "decrypt_ok": bool(ok),
                             "answer_sample": got[:4]})
                assert ok, (postfix, got[:4], want[:4])
        result["runs"] = runs

        # Output-side spans (user-input processing / answer wait /
        # verify per submission)
        result["output_spans"] = [
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in s.items()} for s in out.trace.spans
        ]
        out.stop()

        # Cloud-side spans from the serve process (SPAN lines)
        _say("collecting cloud spans ...")
        time.sleep(2.0)  # let the span printer flush
        cloud_spans = []
        with open(os.path.join(logdir, f"e2e_{tag}_cloud.log")) as f:
            for line in f:
                if line.startswith("SPAN "):
                    cloud_spans.append(json.loads(line[5:]))
        result["cloud_spans"] = [
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in s.items()} for s in cloud_spans
        ]

        # --- BASELINE speedup columns -------------------------------
        def spans(name, src):
            return [s["seconds"] for s in src if s["name"] == name]

        uip_all = spans("user_input_processing", out.trace.spans)
        # the first submission waits on the cloud process still
        # binding its job server after the 66 MB key unpack; the
        # reference's 6.90 s row is a steady-state mean — use the
        # non-first submissions (all spans stay in output_spans)
        uip = uip_all[1:] or uip_all
        dreq = [s["seconds"] for s in cloud_spans
                if s["name"] == "data_request"]
        rows = {}
        rows["key_exchange"] = {
            "ours_s": round(t_keyx, 3),
            "ref_s": REF["key_exchange_opt_s"],
            "speedup": round(REF["key_exchange_opt_s"] / t_keyx, 1),
        }
        if uip:
            m = sum(uip) / len(uip)
            rows["user_input_processing"] = {
                "ours_mean_s": round(m, 3),
                "ref_s": REF["user_input_processing_s"],
                "speedup": round(REF["user_input_processing_s"] / m, 1),
            }
        if dreq:
            m = sum(dreq) / len(dreq)
            rows["data_request_per_operand"] = {
                "ours_mean_s": round(m, 3), "n": len(dreq),
                "ref_s": REF["data_request_s"],
                "speedup": round(REF["data_request_s"] / m, 1),
            }
        for postfix in exprs:
            warm = [r for r in runs
                    if r["postfix"] == postfix and r["attempt"] == "warm"]
            ref_s = REF["compute_s"].get(postfix)
            if warm and ref_s:
                # warm total includes operand pulls + compute + answer;
                # the per-phase compute spans are in cloud_spans
                rows[f"compute_total_warm[{postfix}]"] = {
                    "ours_s": warm[0]["total_s"], "ref_s": ref_s,
                    "speedup": round(ref_s / warm[0]["total_s"], 1),
                    "note": "whole warm job (pulls+compute+answer+verify) "
                            "vs the reference's Fig.7 compute row",
                }
        result["baseline_rows"] = rows
        result["total_wall_s"] = round(time.time() - t_all0, 3)
        result["decrypt_errors"] = 0 if all(
            r["decrypt_ok"] for r in runs) else 1
        print(json.dumps(result), flush=True)
    finally:
        for pr in procs:  # exact PIDs only — never kill by pattern
            pr.kill()
        for pr in procs:
            try:
                pr.wait(timeout=10)
            except Exception:
                pass
        for lf in logs:
            lf.close()


if __name__ == "__main__":
    main()
