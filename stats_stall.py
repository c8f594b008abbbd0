#!/usr/bin/env python3
"""The decode step a ``serve`` replica stalls on when its first
``stats`` heartbeat asks for the inter-token attribution, measured on the
card.

    python3 stats_stall.py [--root DIR] [--requests N]

Builds the serving path's three kernels of the checkout at ``--root``
(default: this one), then spawns that checkout's ``python -m
paddle_tpu_torch serve <LM> --precision bf16 --decode-slots 16
--profile`` (phase 4's LM, vocab 32000, 12 layers, d768, saved once
under build/stall/lm by this checkout).  From the moment its port file
appears a thread calls ``stats`` every 0.5 s, as a fleet heartbeat does,
timing each call.  Then N streamed generate requests (prompts of
8..1024 tokens, 64 new tokens, 8 client threads) go to the replica, and
the decode flight ring comes back through the ``trace`` verb: the first
decode step (the profiled one), the longest step, the step p50, the
slowest heartbeat round trip, the longest gap between two tokens of one
stream at the client, and whether the attribution was kept.  Prints one
JSON line with the card's name and power limit; the replica is stopped
before it exits.

To compare two versions on one card, unpack the other tree under build/
(``git archive``) and run parent, change, change, parent in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FULL_WIDTH = dict(vocab=32000, max_len=2048, n_layers=12, d_model=768,
                  n_heads=12, d_ff=3072)
SLOTS, NEW, PROMPT, CLIENTS, HEARTBEAT = 16, 64, (8, 1024), 8, 0.5


def _lm_dir(seed=0):
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.models import transformer as T
    d = os.path.join(HERE, "build", "stall", "lm")
    spec = T.generation_spec(**FULL_WIDTH)
    if os.path.exists(os.path.join(d, "__model__")) and \
            T.read_generation_spec(d) == spec:
        return d, spec
    scope = Scope()
    for name, arr in T.random_params(spec, seed).items():
        scope.set(name, arr)
    T.save_generation_model(d, **FULL_WIDTH, scope=scope, init=False)
    return d, spec


def _step_ms(records):
    """ms of each decode step in a decode flight ring: a record whose
    iteration count moved past the one before it ran a step (the
    others only admitted)."""
    out, prev = [], 0
    for r in records:
        if r["iteration"] > prev:
            out.append(r["step_s"] * 1e3)
        prev = r["iteration"]
    return out


def _env(root):
    return dict(os.environ, PYTHONPATH=root + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stats_stall.py")
    ap.add_argument("--root", default=HERE,
                    help="checkout whose paddle_tpu_torch serves")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from paddle_tpu_torch.ops import _build; _build.build_all(("
         "'paged_attention', 'flash_attention', 'layer_norm'))", root],
        check=True, env=_env(root), cwd=root)
    model_dir, spec = _lm_dir(args.seed)
    from paddle_tpu_torch.serving import ServingClient
    port_file = os.path.join(HERE, "build", "stall", f"port-{os.getpid()}")
    log = open(os.path.join(HERE, "build", "stall", "serve.log"), "w")
    t_spawn = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", model_dir,
         "--precision", "bf16", "--decode-slots", str(SLOTS), "--profile",
         "--port-file", port_file], stdout=log, stderr=subprocess.STDOUT,
        env=_env(root), cwd=root, start_new_session=True)
    beats, stop = [], threading.Event()
    try:
        while not os.path.exists(port_file):
            if proc.poll() is not None:
                raise SystemExit(f"serve exited {proc.returncode}")
            if time.monotonic() - t_spawn > 600:
                raise SystemExit("serve wrote no port file in 600 s")
            time.sleep(0.05)
        time.sleep(0.05)
        ep = f"127.0.0.1:{int(open(port_file).read().strip())}"
        boot_s = time.monotonic() - t_spawn
        t_first_beat = time.time()

        def heartbeat():
            with ServingClient(ep, timeout=30, retries=0) as c:
                while not stop.is_set():
                    t0 = time.perf_counter()
                    c.stats()
                    beats.append(time.perf_counter() - t0)
                    stop.wait(HEARTBEAT)

        hb = threading.Thread(target=heartbeat, daemon=True)
        hb.start()
        while not beats:
            time.sleep(0.01)
        rng = np.random.default_rng(args.seed + 20)
        lens = rng.integers(PROMPT[0], PROMPT[1] + 1, args.requests)
        prompts = [rng.integers(0, spec["vocab"], n).tolist() for n in lens]
        gaps = []

        def client(t):
            with ServingClient(ep, timeout=600) as c:
                for i in range(t, args.requests, CLIENTS):
                    last = None
                    for line in c.generate_stream(prompts[i],
                                                  max_new_tokens=NEW):
                        now = time.perf_counter()
                        if "token" in line and last is not None:
                            gaps.append(now - last)
                        last = now

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        stop.set()
        hb.join(30)
        with ServingClient(ep, timeout=120) as c:
            doc = c.raw_call({"method": "trace"})["trace"]
            st = c.stats()["decode"]
            c.raw_call({"method": "shutdown"})
        proc.wait(120)
    finally:
        stop.set()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)
        log.close()
        if os.path.exists(port_file):
            os.unlink(port_file)
    recs = sorted((r for p in doc["processes"]
                   for r in p.get("flight", {}).get("decode.default", ())
                   if r["ts"] >= t_first_beat), key=lambda r: r["ts"])
    ms = _step_ms(recs)
    print(json.dumps({
        "root": root, "card": smi, "boot_s": boot_s,
        "requests": args.requests, "wall_s": wall,
        "tokens_per_s": args.requests * NEW / wall,
        "first_step_ms": ms[0] if ms else None,
        "longest_step_ms": max(ms) if ms else None,
        "step_ms_p50": float(np.median(ms)) if ms else None,
        "steps_in_ring": len(ms),
        "heartbeats": len(beats),
        "slowest_heartbeat_ms": max(beats) * 1e3,
        "longest_token_gap_ms": max(gaps) * 1e3 if gaps else None,
        "attribution_kept": st.get("inter_token_attribution") is not None,
        "stats_step_ms": st.get("step_ms")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
