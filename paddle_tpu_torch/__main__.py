"""``python -m paddle_tpu_torch`` — the port's command line (counterpart
of ``paddle_tpu/__main__.py``; the serving verbs only):

  serve <model_dir>     serve saved inference model(s) over the
                        newline-JSON wire: --model NAME=DIR (repeatable)
                        mounts more models behind one port; a model whose
                        artifact ships __generation__.json also answers
                        ``generate`` through a DecodeEngine
                        (--decode-numerics fast|exact); lookup-only
                        tables can be served through a hot-row cache
                        (--embedding-cache-rows N).  Runs on the
                        card unless --device cpu.  SIGTERM or SIGINT (or
                        the ``shutdown`` verb) drains in-flight requests,
                        then prints the engines' stats as one JSON line
  models [endpoint]     list a running server's models
  metrics [endpoint]    a running server's metrics (Prometheus text, or
                        --json for a snapshot)

The client verbs read the endpoint from HOST:PORT or from the port file
a local ``serve`` wrote.  ``fleet``, ``top``, ``inspect`` and the
training verbs are not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys


def cmd_serve(args):
    from paddle_tpu_torch.serving import InferenceServer, ModelRegistry

    exporter = None
    if args.metrics_jsonl:
        from paddle_tpu_torch.observability import JsonlExporter
        exporter = JsonlExporter(args.metrics_jsonl,
                                 interval_s=args.metrics_interval)
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
                              embedding_cache_rows=args.embedding_cache_rows)
        pred, eng = entry.predictor, entry.engine
        print(f"loaded model {name!r} from {d} "
              f"(feeds={pred.feed_names} fetch={pred.fetch_names} "
              f"buckets={eng.buckets} precision={args.precision} "
              f"device={pred.device}"
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
    print(f"paddle_tpu_torch serving {len(specs)} model(s) "
          f"{[n for n, _ in specs]} on {server.host}:{server.port} "
          f"(default={registry.default_model} "
          f"max_batch={args.max_batch_size} "
          f"delay={args.max_queue_delay_ms}ms)", flush=True)
    # one event ends the process, whether a signal or the shutdown verb
    signal.signal(signal.SIGTERM, lambda *a: server.shutting_down.set())
    signal.signal(signal.SIGINT, lambda *a: server.shutting_down.set())
    server.shutting_down.wait()
    server.drain_and_stop(timeout=args.drain_timeout)
    # the live registry, not the start-up list: the wire may have loaded
    # or unloaded models since; the series stay mounted for the
    # exporter's last snapshot
    entries = {n: registry.get(n) for n in registry.names()}
    registry.close(unmount=False)
    stats = {n: registry.stats_for(e) for n, e in entries.items()}
    if exporter is not None:
        exporter.close()
    only = specs[0][0]
    print(json.dumps(stats[only] if list(stats) == [only] else stats),
          flush=True)
    return 0


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


def cmd_metrics(args):
    from paddle_tpu_torch.serving import serving_metrics

    out = serving_metrics(_resolve_endpoint(args, "metrics"),
                          format="json" if args.json else "prometheus",
                          timeout=args.timeout)
    if args.json:
        print(json.dumps(out, indent=1))
    else:
        print(out, end="")
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


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

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
    p.set_defaults(fn=cmd_serve)

    _client_parser(sub, "models", "list a running server's models"
                   ).set_defaults(fn=cmd_models)
    _client_parser(sub, "metrics", "a running server's metrics"
                   ).set_defaults(fn=cmd_metrics)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
