"""``python -m paddle_tpu_torch`` — the port's command line (counterpart
of ``paddle_tpu/__main__.py``; the serving and training verbs):

  train <script> [args]  run a training script as ``__main__`` with
                        the port importable (a script written for the
                        JAX package runs with its import changed)
  pserver               the elastic dataset master (distributed.master)
                        on --host/--port (--port-file gets the bound
                        port); it leases chunk tasks of
                        --chunks-per-task chunks with a --task-timeout
                        lease and a --failure-limit budget, and with
                        --snapshot FILE recovers its queues after a
                        restart; SIGTERM or SIGINT stops it
  checkpoints <dir>     list a training checkpoint directory (step,
                        age, size, reader position, fingerprint: the
                        manifests ``train_loop(resume_from=...)``
                        reads), or --json for the full listing; the
                        JAX verb's output for the same directory
  serve <model_dir>     serve saved inference model(s) over the
                        newline-JSON wire: --model NAME=DIR (repeatable)
                        mounts more models behind one port; a model whose
                        artifact ships __generation__.json also answers
                        ``generate`` through a DecodeEngine
                        (--decode-numerics fast|exact); lookup-only
                        tables can be served through a hot-row cache
                        (--embedding-cache-rows N).  Runs on the
                        card unless --device cpu.  --mesh dp=N serves
                        one model from N ranks (this process is rank 0
                        and spawns the others; gloo with --device cpu,
                        NCCL on the cards, one a rank).  SIGTERM or
                        SIGINT (or
                        the ``shutdown`` verb) drains in-flight requests,
                        then prints the engines' stats as one JSON line.
                        --profile keeps a live span log for the ``trace``
                        verb, --timeline PATH also writes the session's
                        Chrome trace at shutdown (with the
                        --metrics-jsonl counters), --xprof DIR captures
                        one torch.profiler window of --xprof-seconds
  fleet <model_dir>     replicated serving tier: spawn (or adopt with
                        --replica) N health-checked replica ``serve``
                        processes behind one routing frontend
                        (power-of-two-choices routing, admission control,
                        deadline propagation, retry on another replica,
                        crash restart); --autoscale min=N,max=M scales it
                        on p99/shed/queue pressure, --watch-checkpoints DIR
                        rolls new checkpoint weights replica by replica.
                        Replicas run on the card unless --replica-arg
                        --device --replica-arg cpu
  models [endpoint]     list a running server's models
  metrics [endpoint]    a running server's metrics (Prometheus text, or
                        --json for a snapshot); against a fleet frontend
                        the merged fleet view (every replica's series
                        labeled replica=<id>); --watch N refreshes every
                        N seconds (--count bounds it)
  top [endpoint]        live fleet view: per-replica state / queue / rps /
                        p99 / restarts plus SLO error-budget burn and the
                        autoscaler, refreshed in place
  inspect [dir|endpoint]
                        cost reports: of a saved model dir run once at
                        --batch-size here, or of every program a live
                        server has run; --roofline adds the verdict
                        against the card's roofs
  merge_model <model_dir> <out_dir>
                        re-save an exported inference model with all its
                        weights in ONE __params__.npz (--params-filename
                        names the source's own combined file)
  dump_config <script>  run a config script (not as ``__main__``: its
                        training guard does not fire) and print the
                        default main Program's JSON, the JAX package's
                        for the same script
  make_diagram <script> <out.dot>
                        the graphviz dot of that Program's global block
  version               the port's version, torch's, CUDA's and the
                        number of cards

The client verbs read the endpoint from HOST:PORT or from the port file
a local ``serve`` wrote.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys


def cmd_serve(args):
    specs = []
    if args.model_dir:
        specs.append(("default", args.model_dir))
    for spec in args.model or []:
        name, sep, d = spec.partition("=")
        if not sep or not name or not d:
            raise SystemExit(f"--model expects NAME=DIR, got {spec!r}")
        specs.append((name, d))
    if not specs:
        raise SystemExit("serve: give a model dir or --model NAME=DIR")
    mesh, size = _serve_mesh(args, specs)
    if size == 1:
        return _serve(args, specs, mesh, [])
    import shutil
    import subprocess
    import tempfile
    from paddle_tpu_torch.parallel import init_distributed
    if args.mesh_rank > 0:
        init_distributed(args.mesh_init, size, args.mesh_rank,
                         device=args.device)
        return _follow(args, specs[0][1], mesh)
    # rank 0 spawns the followers (this verb again with --mesh-rank) and
    # kills and reaps whichever is still running when it returns or fails
    store = tempfile.mkdtemp(prefix="paddle_tpu_torch_mesh_")
    init = "file://" + os.path.join(store, "store")
    followers = []
    try:
        for r in range(1, size):
            followers.append(subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch"] + args.argv
                + ["--mesh-rank", str(r), "--mesh-init", init]))
        init_distributed(init, size, 0, device=args.device)
        return _serve(args, specs, mesh, followers)
    finally:
        for proc in followers:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(store, ignore_errors=True)


def _serve(args, specs, mesh, followers):
    """``serve``'s server: rank 0's under a mesh (``followers`` are the
    other ranks' processes, which stop with the registry)."""
    import subprocess
    from paddle_tpu_torch.serving import InferenceServer, ModelRegistry

    if args.timeline or args.profile:
        # a live span log: the trace verb answers from it, --timeline
        # exports it at shutdown
        from paddle_tpu_torch import profiler
        profiler.start_profiler()
    exporter = None
    if args.metrics_jsonl:
        from paddle_tpu_torch.observability import JsonlExporter
        exporter = JsonlExporter(args.metrics_jsonl,
                                 interval_s=args.metrics_interval)
    buckets = ([int(b) for b in args.buckets.split(",") if b]
               if args.buckets else None)
    engine_opts = {"max_batch_size": args.max_batch_size,
                   "max_queue_delay_ms": args.max_queue_delay_ms,
                   "buckets": buckets,
                   "max_queue_depth": args.max_queue_depth}
    warm = [int(b) for b in args.warmup.split(",") if b]
    decode = False if args.no_decode else {
        "slots": args.decode_slots,
        "block_len": args.decode_block_len,
        "num_blocks": args.decode_blocks,
        "prefix_cache_blocks": args.decode_prefix_cache_blocks,
        "numerics": args.decode_numerics,
        "max_queue_depth": args.max_queue_depth,
        "warmup": True,
    }
    registry = ModelRegistry(device=args.device)
    for name, d in specs:
        entry = registry.load(name, d, params_filename=args.params_filename,
                              transpile=not args.no_transpile,
                              engine_opts=engine_opts, warmup=warm,
                              precision=args.precision, decode=decode,
                              embedding_cache_rows=args.embedding_cache_rows,
                              mesh=mesh)
        pred, eng = entry.predictor, entry.engine
        print(f"loaded model {name!r} from {d} "
              f"(feeds={pred.feed_names} fetch={pred.fetch_names} "
              f"buckets={eng.buckets} precision={args.precision} "
              f"device={pred.device}"
              + (f" mesh={mesh}" if mesh else "")
              + (f" decode_slots={entry.decode.slots}"
                 if entry.decode is not None else "") + ")", flush=True)
    if args.metrics_jsonl:
        # flight-recorder dumps land beside the metrics file
        base = os.path.abspath(args.metrics_jsonl)
        for n in registry.names():
            registry.get(n).engine.flight.dump_path = \
                f"{base}.flight.{n}.json"
    server = InferenceServer(registry, host=args.host, port=args.port,
                             port_file=args.port_file).start()
    # one event ends the process, whether a signal or the shutdown verb
    # (installed before the profiler window, whose start takes seconds)
    signal.signal(signal.SIGTERM, lambda *a: server.shutting_down.set())
    signal.signal(signal.SIGINT, lambda *a: server.shutting_down.set())
    xprof_stop = _start_xprof(args) if args.xprof else None
    print(f"paddle_tpu_torch serving {len(specs)} model(s) "
          f"{[n for n, _ in specs]} on {server.host}:{server.port} "
          f"(default={registry.default_model} "
          f"max_batch={args.max_batch_size} "
          f"delay={args.max_queue_delay_ms}ms)", flush=True)
    server.shutting_down.wait()
    server.drain_and_stop(timeout=args.drain_timeout)
    # the live registry, not the start-up list: the wire may have loaded
    # or unloaded models since; the series stay mounted for the
    # exporter's last snapshot
    entries = {n: registry.get(n) for n in registry.names()}
    registry.close(unmount=False)
    for proc in followers:
        # the registry's close ended their loops; one still running after
        # this wait is killed by cmd_serve
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            print(f"serve: follower pid {proc.pid} did not stop in 60 s",
                  file=sys.stderr, flush=True)
    stats = {n: registry.stats_for(e) for n, e in entries.items()}
    if xprof_stop is not None:
        from paddle_tpu_torch.observability import attribution
        xprof_stop()        # the timer may have fired already
        split = attribution.device_step_split(args.xprof)
        print(json.dumps({"xprof": {"logdir": args.xprof,
                                    "split": split}}), flush=True)
    if exporter is not None:
        exporter.close()
    if args.timeline:
        from paddle_tpu_torch import profiler
        from paddle_tpu_torch.observability import timeline as _timeline
        counters = (_timeline.read_metrics_jsonl(args.metrics_jsonl)
                    if args.metrics_jsonl else None)
        _timeline.export_profile(args.timeline, counters=counters)
        profiler.stop_profiler(quiet=True)
        print(f"wrote timeline {args.timeline}", flush=True)
    only = specs[0][0]
    print(json.dumps(stats[only] if list(stats) == [only] else stats),
          flush=True)
    return 0


def _serve_mesh(args, specs):
    """``serve --mesh``'s axes -> (axes dict or None, the mesh's size)."""
    if not args.mesh:
        return None, 1
    from paddle_tpu_torch.parallel.partitioner import parse_mesh_axes
    try:
        axes = parse_mesh_axes(args.mesh)
    except ValueError as e:
        raise SystemExit(f"serve: {e}")
    size = 1
    for n in (axes or {}).values():
        size *= n
    if size > 1 and len(specs) != 1:
        raise SystemExit("serve --mesh serves one model")
    return axes, size


def _follow(args, model_dir, mesh):
    """A follower rank of ``serve --mesh``: run rank 0's batches until it
    stops serving."""
    from paddle_tpu_torch.serving import ShardedPredictor
    pred = ShardedPredictor.from_model_dir(
        model_dir, params_filename=args.params_filename,
        transpile=not args.no_transpile, precision=args.precision,
        device=args.device, mesh=mesh)
    pred.follow()
    return 0


def cmd_fleet(args):
    from paddle_tpu_torch.serving import FleetFrontend

    specs = []
    if args.model_dir:
        specs.append(("default", args.model_dir))
    for spec in args.model or []:
        name, sep, d = spec.partition("=")
        if not sep or not name or not d:
            raise SystemExit(f"--model expects NAME=DIR, got {spec!r}")
        specs.append((name, d))
    if not specs and not args.replica:
        raise SystemExit("fleet: give a model dir (to spawn replicas) "
                         "or --replica endpoints to adopt")
    autoscale = None
    if args.autoscale:
        from paddle_tpu_torch.fleet_control import parse_autoscale_spec
        if not specs:
            raise SystemExit("fleet: --autoscale needs a model dir — "
                             "adopted replicas cannot be spawned")
        try:
            autoscale = parse_autoscale_spec(args.autoscale)
        except ValueError as e:
            raise SystemExit(f"fleet: {e}")
    if args.watch_checkpoints and not specs:
        raise SystemExit("fleet: --watch-checkpoints needs a model dir "
                         "to publish into")
    # 2 replicas when there is something to spawn; an adopt-only fleet
    # spawns none, an autoscaled one starts at its floor
    replicas = args.replicas
    if replicas is None:
        replicas = autoscale["min"] if autoscale else (2 if specs else 0)
    if replicas > 0 and not specs:
        raise SystemExit("fleet: spawning replicas needs a model dir")
    replica_args = list(args.replica_arg or [])
    if args.profile:
        # the frontend and every replica keep live span logs, so that
        # `trace <id>` stitches one request across the whole fleet
        from paddle_tpu_torch import profiler
        profiler.start_profiler()
        replica_args.append("--profile")
    try:
        fleet = FleetFrontend(
            specs, replicas=replicas,
            replica_endpoints=args.replica or [],
            host=args.host, port=args.port, port_file=args.port_file,
            compile_cache=args.compile_cache,
            health_interval=args.health_interval,
            max_retries=args.max_retries,
            route_timeout=args.route_timeout,
            admission_bound=args.admission_bound,
            sample_interval=args.sample_interval,
            slo=args.slo,
            replica_args=replica_args).start()
    except ValueError as e:
        raise SystemExit(f"fleet: {e}")
    # replicas run in their own sessions: any exception from here on
    # that skipped fleet.stop() would orphan them
    stats = None
    watcher = None
    try:
        if autoscale:
            from paddle_tpu_torch.fleet_control import Autoscaler
            tunables = {k: autoscale[k]
                        for k in ("queue_high", "window_s", "idle_s",
                                  "cooldown_up_s", "cooldown_down_s")
                        if k in autoscale}
            Autoscaler(fleet, min_replicas=autoscale["min"],
                       max_replicas=autoscale["max"],
                       p99_ms=(autoscale.get("slo") or {}).get("p99_ms"),
                       **tunables)
        if args.watch_checkpoints:
            from paddle_tpu_torch.fleet_control import (CheckpointWatcher,
                                                        ModelPublisher)
            # the served model dir is its own publish template
            name, model_dir = specs[0]
            watcher = CheckpointWatcher(
                fleet, ModelPublisher(args.watch_checkpoints, model_dir),
                model=name).start()
        print(f"paddle_tpu_torch fleet frontend on {fleet.host}:"
              f"{fleet.port} — {replicas} spawned + "
              f"{len(args.replica or [])} adopted replica(s), models "
              f"{[n for n, _ in specs]}"
              + (f", autoscale [{autoscale['min']}..{autoscale['max']}]"
                 if autoscale else "")
              + (f", watching {args.watch_checkpoints}"
                 if args.watch_checkpoints else ""), flush=True)
        signal.signal(signal.SIGTERM,
                      lambda *a: fleet.shutting_down.set())
        signal.signal(signal.SIGINT,
                      lambda *a: fleet.shutting_down.set())
        if args.wait_ready:
            fleet.wait_ready(timeout=args.wait_ready)
            print(f"fleet ready: {fleet.healthy_count()} replica(s) "
                  "healthy", flush=True)
        fleet.shutting_down.wait()
        stats = fleet.stats()
    finally:
        if watcher is not None:
            watcher.stop()
        fleet.stop()    # also closes an attached autoscaler
    print(json.dumps(stats), flush=True)
    return 0


def _start_xprof(args):
    """One bounded torch.profiler window of live serving (the card's
    events, or the host's without one) written under ``args.xprof``;
    -> the idempotent stop, which a timer calls after
    ``--xprof-seconds``.  A capture that cannot start is reported and
    serving goes on."""
    import threading
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import attribution
    try:
        profiler.start_trace(args.xprof,
                             activities=attribution.window_activities())
    except Exception as e:  # noqa: BLE001 — another profiler active etc.
        print(f"xprof capture unavailable: {e}", flush=True)
        return None
    lock = threading.Lock()
    done = []

    def stop():
        with lock:
            if done:
                return
            done.append(True)
            try:
                profiler.stop_trace()
            except Exception:  # noqa: BLE001
                pass
    timer = threading.Timer(args.xprof_seconds, stop)
    timer.daemon = True
    timer.start()
    return stop


def _resolve_endpoint(args, verb):
    """HOST:PORT from the argument, or from the port file a local
    ``serve`` wrote."""
    from paddle_tpu_torch.serving.server import SELECTED_PORT_FILE

    if args.endpoint is not None:
        return args.endpoint
    port_file = args.port_file or SELECTED_PORT_FILE
    try:
        with open(port_file) as f:
            return f"127.0.0.1:{int(f.read().strip())}"
    except (OSError, ValueError) as e:
        raise SystemExit(
            f"{verb}: no endpoint given and no port file at {port_file} "
            f"({e}); pass HOST:PORT or --port-file")


def cmd_models(args):
    from paddle_tpu_torch.serving import list_models

    listing = list_models(_resolve_endpoint(args, "models"),
                          timeout=args.timeout)
    if args.json:
        print(json.dumps(listing, indent=1))
        return 0
    default = listing.get("default")
    for name, info in sorted(listing.get("models", {}).items()):
        mark = "*" if name == default else " "
        print(f"{mark} {name} v{info['version']} "
              f"dir={info['model_dir'] or '<live engine>'} "
              f"feeds={info['feed_names']} fetch={info['fetch_names']}")
    return 0


def _poll_resilient(client, fetch, interval, bounded):
    """One fetch under the watch loops' failure policy (``metrics
    --watch`` and ``top``): a bounded run (one-shot, --count,
    --iterations) re-raises endpoint errors; an unbounded monitor
    outlives server restarts — drop the socket, note the gap, wait one
    interval and return None (retry)."""
    import time

    from paddle_tpu_torch.serving import ServingError

    try:
        return fetch()
    except (OSError, ServingError) as e:
        if bounded:
            raise
        client.close()
        print(f"(endpoint unavailable: {e}; retrying)")
        time.sleep(interval)
        return None


def cmd_metrics(args):
    # a plain serve and a fleet frontend both speak the metrics verb;
    # the fleet's reply is the merged view
    import time

    from paddle_tpu_torch.serving import ServingClient

    if args.watch is not None and args.watch <= 0:
        raise SystemExit(f"metrics: --watch must be a positive number "
                         f"of seconds, got {args.watch}")
    if args.count and args.watch is None:
        raise SystemExit("metrics: --count only bounds a --watch loop; "
                         "pass --watch N to refresh periodically")
    endpoint = _resolve_endpoint(args, "metrics")
    fmt = "json" if args.json else "prometheus"
    n = 0
    try:
        with ServingClient(endpoint, timeout=args.timeout) as client:
            while True:
                out = _poll_resilient(
                    client, lambda: client.metrics(format=fmt),
                    interval=args.watch or 0,
                    bounded=not args.watch or bool(args.count))
                if out is None:
                    continue
                n += 1
                if args.watch:
                    print(f"=== {endpoint} snapshot {n} "
                          f"{time.strftime('%H:%M:%S')} ===")
                if args.json:
                    print(json.dumps(out, indent=1))
                else:
                    print(out, end="")
                if not args.watch or (args.count and n >= args.count):
                    return 0
                sys.stdout.flush()
                time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0            # --watch runs until interrupted


def _metric_value(metrics, family, match, pick=max):
    """Best (default: max) plain-sample value of a snapshot family whose
    labels contain ``match`` — e.g. the p99 series of one replica."""
    from paddle_tpu_torch.observability import parse_series_key
    fam = (metrics or {}).get(family) or {}
    best = None
    for key, val in fam.get("series", {}).items():
        labels, part = parse_series_key(key)
        if part:
            continue
        if all(labels.get(k) == str(v) for k, v in match.items()):
            best = val if best is None else pick(best, val)
    return best


def _render_top(endpoint, desc, stats, metrics, prev, now):
    """One refresh of the live fleet view (the JAX verb's text).
    ``prev`` carries {replica: (ts, forwarded)} so per-replica rps is a
    delta between refreshes.  Returns (text, new_prev)."""
    lines = []
    new_prev = {}
    if desc is None:
        # a plain serve endpoint: its stats page
        lat = (stats or {}).get("latency") or {}
        lines.append(f"serve {endpoint}")
        lines.append(
            f"  requests {stats.get('requests', 0)}  "
            f"queue {stats.get('queue_depth', 0)}  "
            f"dispatches {stats.get('dispatches', 0)}  "
            f"avg_batch {stats.get('avg_batch', 0)}  "
            f"p99_ms {lat.get('p99_ms', '-')}")
        dec = _render_decode((stats or {}).get("decode"))
        if dec:
            lines.append("  " + dec)
        emb = _render_embcache(((stats or {}).get("predictor") or {})
                               .get("embedding_cache"))
        if emb:
            lines.append("  " + emb)
        return "\n".join(lines), new_prev
    reps = desc.get("replicas", [])
    healthy = sum(1 for r in reps if r.get("state") == "healthy")
    shed = sum((stats.get("shed") or {}).values())
    lines.append(
        f"fleet {endpoint} — {len(reps)} replica(s), {healthy} healthy   "
        f"requests {stats.get('requests', 0)}  "
        f"retries {stats.get('retries', 0)}  shed {shed}  "
        f"readmitted {stats.get('readmitted', 0)}")
    for objective, res in sorted((stats.get("slo") or {}).items()):
        burn = res.get("burn_rate")
        obs = res.get("observed")
        lines.append(
            f"  slo {objective}: "
            f"{'BREACH' if res.get('breached') else 'ok'}  "
            f"budget burn {burn if burn is None else round(burn, 3)}  "
            f"observed {obs if obs is None else round(obs, 4)}")
    asc = stats.get("autoscaler")
    if asc:
        last = asc.get("last_decision") or {}
        lines.append(
            f"  autoscaler [{asc.get('min')}..{asc.get('max')}] "
            f"replicas {asc.get('replicas')} "
            f"({asc.get('healthy')} healthy)  "
            f"last {last.get('decision', '-')}/{last.get('reason', '-')}  "
            f"ups {asc.get('scale_ups', 0)} "
            f"downs {asc.get('scale_downs', 0)}  "
            f"cooldown {float(asc.get('cooldown_remaining_s') or 0):.0f}s")
    hdr = (f"  {'replica':<8} {'state':<9} {'queue':>6} {'infl':>5} "
           f"{'rps':>8} {'p99_ms':>8} {'fwd':>9} {'restarts':>8}")
    lines.append(hdr)
    for r in reps:
        name = r.get("replica", "?")
        fwd = r.get("forwarded", 0)
        rps = "-"
        if name in prev:
            t0, f0 = prev[name]
            if now > t0:
                rps = f"{max(fwd - f0, 0) / (now - t0):.1f}"
        new_prev[name] = (now, fwd)
        p99 = _metric_value(metrics, "engine_request_latency_seconds",
                            {"quantile": "0.99", "replica": name})
        p99 = "-" if p99 is None else f"{p99 * 1e3:.1f}"
        lines.append(
            f"  {name:<8} {r.get('state', '?'):<9} "
            f"{int(r.get('queue_depth') or 0):>6} "
            f"{int(r.get('inflight') or 0):>5} {rps:>8} {p99:>8} "
            f"{fwd:>9} {int(r.get('restarts') or 0):>8}")
        dec = _render_decode(r.get("decode"))
        if dec:
            lines.append(f"  {'':<8} {dec}")
    return "\n".join(lines), new_prev


def _render_embcache(caches):
    """Hot-row embedding-cache columns: only when the endpoint's
    predictor serves tables through a HotRowCache."""
    if not caches:
        return None
    parts = []
    for name, c in sorted(caches.items()):
        parts.append(f"{name}: hit_rate {c.get('hit_rate', 0)}  "
                     f"rows {c.get('budget_rows', '?')}/"
                     f"{c.get('table_rows', '?')}  "
                     f"promotions {c.get('promotions', 0)}")
    return "embcache " + "   ".join(parts)


def _render_decode(dec):
    """Decode-engine columns: only when the endpoint reports a
    DecodeEngine in its stats page (the prefix hit rate only with a
    prefix cache)."""
    if not dec:
        return None
    ttft = (dec.get("ttft_ms") or {}).get("p99")
    occ = dec.get("occupancy_mean")
    tps = dec.get("tokens_per_sec")
    prefix = dec.get("prefix") or {}
    hit = prefix.get("hit_rate")
    return (f"decode: slots {dec.get('active_slots', 0)}/"
            f"{dec.get('slots', '?')}  "
            f"occ {occ if occ is not None else '-'}  "
            f"tok/s {tps if tps is not None else '-'}  "
            f"ttft_p99_ms {ttft if ttft is not None else '-'}  "
            f"blocks {(dec.get('blocks') or {}).get('in_use', 0)}/"
            f"{(dec.get('blocks') or {}).get('total', '?')}"
            + (f"  prefix_hit {hit if hit is not None else '-'}"
               if prefix else ""))


def cmd_top(args):
    """Live fleet view, refreshed every --interval seconds: the full
    view against a fleet frontend, the stats page against a serve."""
    import time

    from paddle_tpu_torch.serving import ServingClient

    if args.interval <= 0:
        raise SystemExit(f"top: --interval must be a positive number of "
                         f"seconds, got {args.interval}")
    endpoint = _resolve_endpoint(args, "top")
    prev = {}
    n = 0

    def fetch(client):
        return (client.raw_call({"method": "fleet"}).get("fleet"),
                client.raw_call({"method": "stats"}).get("stats", {}),
                client.raw_call({"method": "metrics",
                                 "format": "json"}).get("metrics", {}))

    try:
        with ServingClient(endpoint, timeout=args.timeout) as client:
            while True:
                fetched = _poll_resilient(
                    client, lambda: fetch(client),
                    interval=args.interval,
                    bounded=bool(args.iterations))
                if fetched is None:
                    continue
                desc, stats, metrics = fetched
                text, prev = _render_top(endpoint, desc, stats, metrics,
                                         prev, time.monotonic())
                if sys.stdout.isatty():
                    print("\x1b[2J\x1b[H", end="")
                print(text, flush=True)
                n += 1
                if args.iterations and n >= args.iterations:
                    return 0
                time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0            # the default --iterations 0 runs until ^C


def cmd_inspect(args):
    from paddle_tpu_torch.observability import attribution, introspect

    if args.target is not None and os.path.isdir(args.target):
        info = introspect.inspect_model_dir(
            args.target, batch_size=args.batch,
            params_filename=args.params_filename,
            transpile=not args.no_transpile, device=args.device)
        if args.json:
            if args.roofline and info.get("report"):
                info["roofline"] = attribution.roofline(info["report"])
            print(json.dumps(info, indent=1))
            return 0
        print(f"model {info['model_dir']}  "
              f"fingerprint {info['fingerprint']}")
        print(f"  feeds {info['feed_names']}  fetch {info['fetch_names']}")
        print(f"  param bytes     {info['param_bytes']:,}")
        print(f"  batch size      {info['batch_size']}")
        print(introspect.format_report(info["report"],
                                       roofline=args.roofline))
        return 0

    from paddle_tpu_torch.serving import serving_introspection
    args.endpoint = args.target
    summary = serving_introspection(_resolve_endpoint(args, "inspect"),
                                    timeout=args.timeout)
    if args.json:
        print(json.dumps(summary, indent=1))
        return 0
    for layer, agg in sorted(summary.get("layers", {}).items()):
        print(f"layer {layer}: {agg['programs']} program(s), "
              f"{agg['flops'] / 1e9:.3f} GFLOP total, "
              f"peak {agg['peak_bytes']:,} B, "
              f"compile {agg['compile_seconds']:.2f} s")
    for rep in summary.get("programs", []):
        print(f"- [{rep['layer']}] fingerprint {rep['fingerprint']} "
              f"fetch {rep['fetch_names']}")
        print(introspect.format_report(rep, indent="    ",
                                       roofline=args.roofline))
    return 0


def _client_parser(sub, verb, help):
    p = sub.add_parser(verb, help=help)
    p.add_argument("endpoint", nargs="?", default=None,
                   help="HOST:PORT of a live `serve` (default: read the "
                        "port file)")
    p.add_argument("--port-file", default=None,
                   help="port file to resolve the endpoint from")
    p.add_argument("--json", action="store_true",
                   help="JSON instead of text")
    p.add_argument("--timeout", type=float, default=30.0)
    return p


def cmd_train(args):
    import runpy
    sys.argv = [args.script] + list(args.script_args)
    runpy.run_path(args.script, run_name="__main__")
    return 0


def cmd_pserver(args):
    import threading
    from paddle_tpu_torch.distributed.master import (MasterServer,
                                                     MasterService)

    service = MasterService(chunks_per_task=args.chunks_per_task,
                            timeout_s=args.task_timeout,
                            failure_max=args.failure_limit,
                            snapshot_path=args.snapshot)
    server = MasterServer(service, host=args.host, port=args.port,
                          port_file=args.port_file)
    server.start()
    print(f"paddle_tpu_torch pserver (master service) on "
          f"{server.host}:{server.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    server.stop()
    return 0


def cmd_checkpoints(args):
    from .checkpoint import describe

    listing = describe(args.directory)
    if args.json:
        print(json.dumps(listing, indent=1))
        return 0
    if not listing:
        print(f"no committed checkpoints under {args.directory}")
        return 1
    import datetime
    for c in listing:
        when = (datetime.datetime.fromtimestamp(c["saved_at"])
                .strftime("%Y-%m-%d %H:%M:%S") if c["saved_at"] else "?")
        print(f"step {c['step']:>8}  {when}  "
              f"{c['num_vars']:>4} vars  {c['bytes']/1e6:8.2f} MB  "
              f"reader@{c['reader_position']}  "
              f"program={c['program_fingerprint']}")
    return 0


def _run_script_collect_program(script, script_args):
    """Run a config script as the JAX helper does, under the run name
    ``__paddle_tpu_config__`` (a script's ``if __name__ == "__main__":``
    training guard must not fire just to dump or draw its program) ->
    the port's default main Program."""
    import runpy
    sys.argv = [script] + list(script_args)
    runpy.run_path(script, run_name="__paddle_tpu_config__")
    from .core.program import default_main_program
    return default_main_program()


def cmd_merge_model(args):
    import paddle_tpu_torch as fluid
    fluid.core.program.reset_default_programs()
    exe = fluid.Executor(fluid.CPUPlace())
    program, feed_names, fetch_vars = fluid.io.load_inference_model(
        args.model_dir, exe, params_filename=args.params_filename)
    scope = fluid.global_scope()
    missing = [v.name for v in program.global_block().vars.values()
               if v.persistable and scope.get(v.name) is None]
    if missing:
        raise SystemExit(
            f"merge_model: {len(missing)} persistable vars did not load "
            f"from {args.model_dir} (e.g. {missing[:3]}); if the source "
            "was itself merged, pass --params-filename __params__.npz")
    fluid.io.save_inference_model(
        args.out_dir, feed_names, fetch_vars, exe, main_program=program,
        params_filename="__params__.npz")
    print(f"merged model -> {args.out_dir} (__model__ + __params__.npz)")
    return 0


def cmd_dump_config(args):
    prog = _run_script_collect_program(args.script, args.script_args)
    print(json.dumps(prog.to_dict(), indent=1))
    return 0


def cmd_make_diagram(args):
    prog = _run_script_collect_program(args.script, [])
    from .debuger import draw_block_graphviz
    draw_block_graphviz(prog.global_block(), path=args.output)
    print(f"wrote {args.output}")
    return 0


def cmd_version(args):
    import torch
    import paddle_tpu_torch
    print(f"paddle_tpu_torch {paddle_tpu_torch.__version__}")
    print(f"torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="run a training script")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("pserver", help="serve the distributed master")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--port-file", default=None,
                   help="write the bound port here")
    p.add_argument("--chunks-per-task", type=int, default=1)
    p.add_argument("--task-timeout", type=float, default=60.0)
    p.add_argument("--failure-limit", type=int, default=3)
    p.add_argument("--snapshot", default=None,
                   help="persist queue state here; a restarted master "
                        "recovers it (pending leases re-queue)")
    p.set_defaults(fn=cmd_pserver)

    p = sub.add_parser("checkpoints",
                       help="list a training checkpoint directory")
    p.add_argument("directory")
    p.add_argument("--json", action="store_true",
                   help="full JSON listing instead of the table")
    p.set_defaults(fn=cmd_checkpoints)

    p = sub.add_parser("serve", help="serve saved inference model(s)")
    p.add_argument("model_dir", nargs="?", default=None,
                   help="model dir mounted as the default model "
                        "(optional when --model is given)")
    p.add_argument("--model", action="append", metavar="NAME=DIR",
                   help="mount another named model (repeatable); route "
                        "with {'model': NAME} on the wire")
    p.add_argument("--device", default=None,
                   help="where the models run: the card by default "
                        "(raises without CUDA), or 'cpu'")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--port-file", default=None,
                   help="write the bound port here")
    p.add_argument("--params-filename", default=None,
                   help="combined params file (merged models)")
    p.add_argument("--max-batch-size", type=int, default=16)
    p.add_argument("--max-queue-delay-ms", type=float, default=2.0)
    p.add_argument("--buckets", default=None,
                   help="comma list of batch buckets (default powers of 2)")
    p.add_argument("--warmup", default="1",
                   help="comma list of batch sizes to run once at load "
                        "('' = none)")
    p.add_argument("--precision", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="serving precision: bf16 casts the weights and "
                        "the activation stream; int8 also quantizes "
                        "eligible matrices (per-column absmax scales), "
                        "the decode engine's too (its KV pools stay f32)")
    p.add_argument("--embedding-cache-rows", type=int, default=0,
                   metavar="N",
                   help="serve lookup-only embedding tables from a "
                        "device-resident hot-row cache of N rows: the "
                        "full table stays in host memory, replies are "
                        "bitwise the uncached predictor's, and "
                        "embedding_cache_{hits,misses,promotions}_total "
                        "track the skew; with --precision int8 the cache "
                        "holds int8 rows; 0 disables")
    p.add_argument("--no-transpile", action="store_true",
                   help="skip the inference transpiler (BatchNorm fold)")
    p.add_argument("--mesh", default=None, metavar="AXIS=N[,AXIS=N]",
                   help="serve one model from a mesh of ranks "
                        "(ShardedPredictor): this process is rank 0 and "
                        "spawns the followers")
    p.add_argument("--mesh-rank", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--mesh-init", default=None, help=argparse.SUPPRESS)
    p.add_argument("--metrics-jsonl", default=None,
                   help="append periodic registry snapshots to this file")
    p.add_argument("--metrics-interval", type=float, default=10.0,
                   help="seconds between JSONL snapshots")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="seconds to let in-flight requests finish on "
                        "SIGTERM before the listener stops")
    p.add_argument("--max-queue-depth", type=int, default=None,
                   help="admission bound: submits beyond this queue "
                        "depth get the retriable 'overloaded' code")
    p.add_argument("--no-decode", action="store_true",
                   help="build no DecodeEngine, even for models whose "
                        "artifact ships __generation__.json")
    p.add_argument("--decode-slots", type=int, default=4,
                   help="continuous-batching decode slots per model")
    p.add_argument("--decode-block-len", type=int, default=16,
                   help="tokens per KV-cache block")
    p.add_argument("--decode-blocks", type=int, default=None,
                   help="KV pool blocks (default: slots x "
                        "ceil(max_len/block_len))")
    p.add_argument("--decode-numerics", default="fast",
                   choices=["fast", "exact"],
                   help="decode numerics: fast = paged attention over "
                        "each slot's prefix; exact = the verification "
                        "mode, every token's logits bitwise the full-"
                        "prefix recompute's (row-stable products, "
                        "attention at the full max_len span)")
    p.add_argument("--decode-prefix-cache-blocks", type=int, default=0,
                   metavar="N",
                   help="let up to N KV pool blocks hold cached prompt "
                        "prefixes (radix tree); 0 disables")
    p.add_argument("--profile", action="store_true",
                   help="keep a live profiler span log (no export) so "
                        "the `trace <id>` verb can return this "
                        "process's slice of a distributed trace")
    p.add_argument("--timeline", default=None, metavar="PATH",
                   help="profile the serving session and write a Chrome "
                        "Trace Event Format timeline here on shutdown "
                        "(open in chrome://tracing / Perfetto)")
    p.add_argument("--xprof", default=None, metavar="DIR",
                   help="capture one bounded torch.profiler window of "
                        "live serving into DIR and print its compute/"
                        "collective/idle split at shutdown (None on the "
                        "CPU)")
    p.add_argument("--xprof-seconds", type=float, default=5.0,
                   help="length of the --xprof capture window")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "fleet",
        help="replicated serving tier: spawn/adopt N health-checked "
             "replica serve processes behind one routing frontend")
    p.add_argument("model_dir", nargs="?", default=None,
                   help="model dir replicas mount as their default model")
    p.add_argument("--model", action="append", metavar="NAME=DIR",
                   help="another named model on every replica "
                        "(repeatable)")
    p.add_argument("--replicas", type=int, default=None,
                   help="replica serve processes to spawn (default 2 "
                        "when a model dir is given, 0 for adopt-only "
                        "--replica invocations)")
    p.add_argument("--replica", action="append", metavar="HOST:PORT",
                   help="adopt an already-running serve endpoint "
                        "(repeatable; health-checked but never respawned)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--port-file", default=None,
                   help="write the frontend's bound port here")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="refused: it persists XLA executables, and eager "
                        "PyTorch has none")
    p.add_argument("--health-interval", type=float, default=0.5,
                   help="seconds between replica heartbeats")
    p.add_argument("--max-retries", type=int, default=3,
                   help="bounded retry-on-another-replica per request")
    p.add_argument("--route-timeout", type=float, default=30.0,
                   help="seconds a request may wait for a healthy replica")
    p.add_argument("--admission-bound", type=int, default=None,
                   help="per-model outstanding-request bound (shed with "
                        "'overloaded' beyond it; default unbounded)")
    p.add_argument("--replica-arg", action="append", metavar="ARG",
                   help="extra raw CLI arg passed to every spawned "
                        "replica serve process (repeatable), e.g. "
                        "--replica-arg=--device --replica-arg=cpu")
    p.add_argument("--wait-ready", type=float, default=None,
                   metavar="SECONDS",
                   help="block until every replica is healthy (prints "
                        "'fleet ready') before going quiet")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="SLO objectives evaluated against the fleet "
                        "time-series store, e.g. p99_ms=100:avail=0.999 "
                        "— slo_* gauges on the fleet metrics endpoint")
    p.add_argument("--sample-interval", type=float, default=1.0,
                   help="seconds between time-series store samples of "
                        "the frontend's own metric families")
    p.add_argument("--autoscale", default=None, metavar="SPEC",
                   help="autoscaling policy over the fleet time-series "
                        "store, e.g. min=1,max=4,slo=p99_ms=100 — scale "
                        "up on p99/shed/queue pressure, down on "
                        "sustained idle, with cooldown hysteresis "
                        "(extra knobs: queue_high, window_s, idle_s, "
                        "cooldown_up_s, cooldown_down_s)")
    p.add_argument("--watch-checkpoints", default=None, metavar="DIR",
                   help="watch a CheckpointManager directory: each new "
                        "committed step is re-exported into the served "
                        "model dir and rolled replica by replica "
                        "through the draining reload, health-gated "
                        "with rollback on a failed gate")
    p.add_argument("--profile", action="store_true",
                   help="profile the frontend AND every replica so "
                        "`trace <id>` stitches one request across the "
                        "whole fleet")
    p.set_defaults(fn=cmd_fleet)

    _client_parser(sub, "models", "list a running server's models"
                   ).set_defaults(fn=cmd_models)
    p = _client_parser(sub, "metrics", "a running server's metrics")
    p.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                   help="re-snapshot every N seconds over one "
                        "persistent connection (header line between "
                        "snapshots) instead of a one-shot pull")
    p.add_argument("--count", type=int, default=None,
                   help="with --watch: stop after this many snapshots "
                        "(default: until interrupted)")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "top",
        help="live fleet view: per-replica state/queue/rps/p99/restarts "
             "+ SLO budget burn, refreshed in place")
    p.add_argument("endpoint", nargs="?", default=None,
                   help="HOST:PORT of a fleet frontend (full view) or a "
                        "plain serve (its stats page); default: read "
                        "the port file")
    p.add_argument("--port-file", default=None,
                   help="port file to resolve the endpoint from")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between refreshes")
    p.add_argument("--iterations", type=int, default=0,
                   help="stop after N refreshes (0 = until interrupted)")
    p.add_argument("--timeout", type=float, default=30.0)
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("inspect",
                       help="cost reports of a saved model dir or a live "
                            "serve endpoint")
    p.add_argument("target", nargs="?", default=None,
                   help="model dir (run once here and report) or "
                        "HOST:PORT of a live `serve` (default: read the "
                        "port file)")
    p.add_argument("--port-file", default=None,
                   help="port file to resolve the endpoint from")
    p.add_argument("--batch", "--batch-size", dest="batch", type=int,
                   default=1, help="batch size to run a model dir at")
    p.add_argument("--device", default=None,
                   help="where a model dir runs: the card by default "
                        "(raises without CUDA), or 'cpu'")
    p.add_argument("--params-filename", default=None,
                   help="combined params file (merged models)")
    p.add_argument("--no-transpile", action="store_true",
                   help="skip the inference transpiler (BatchNorm fold)")
    p.add_argument("--json", action="store_true",
                   help="full JSON report instead of the table")
    p.add_argument("--roofline", action="store_true",
                   help="classify each program compute-/memory-/comms-"
                        "bound against the card's roofs")
    p.add_argument("--timeout", type=float, default=30.0)
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("merge_model",
                       help="combine an exported model's weights into one "
                            "file")
    p.add_argument("model_dir")
    p.add_argument("out_dir")
    p.add_argument("--params-filename", default=None,
                   help="combined params file of the SOURCE model (for "
                        "re-merging an already-merged dir)")
    p.set_defaults(fn=cmd_merge_model)

    p = sub.add_parser("dump_config", help="print a script's Program JSON")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_dump_config)

    p = sub.add_parser("make_diagram", help="graphviz of a script's program")
    p.add_argument("script")
    p.add_argument("output")
    p.set_defaults(fn=cmd_make_diagram)

    p = sub.add_parser("version", help="print version info")
    p.set_defaults(fn=cmd_version)

    args = ap.parse_args(argv)
    # the verb's own words, which serve --mesh gives its follower ranks
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
