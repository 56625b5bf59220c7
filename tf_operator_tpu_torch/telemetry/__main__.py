"""Flight-dump inspector + profile viewer: `python -m tf_operator_tpu_torch.telemetry`,
the port's copy of tf_operator_tpu/telemetry/__main__.py (the same seven
forms, options, printed formats and exit codes; it imports nothing of that
package).

Takes one or more JSONL flight dumps (from /debug/flightz, a crash
dump, or a SIGUSR2 snapshot), merges them into one timeline sorted by
wall-clock, and pretty-prints it — and/or exports the records as
Chrome/Perfetto instant events (one track per correlation ID) so a
postmortem loads the flight narrative next to the span tracer's
/debug/trace export in ui.perfetto.dev:

    python -m tf_operator_tpu_torch.telemetry crash.jsonl usr2.jsonl
    python -m tf_operator_tpu_torch.telemetry dump.jsonl --corr req-3
    python -m tf_operator_tpu_torch.telemetry dump.jsonl \
        --perfetto flight.json --trace debug-trace.json

--trace merges a saved /debug/trace JSON (span events) into the
Perfetto output, so spans and flight instants share one file.

The `profile` subcommand is the sampling profiler's viewer
(telemetry/profiler.py): capture from a live /debug/profilez endpoint
or load a saved snapshot, render top-N self/cumulative tables, write
folded/speedscope output, and merge the samples with span JSON and
flight dumps into one Perfetto file:

    python -m tf_operator_tpu_torch.telemetry profile \
        --url http://127.0.0.1:8443 --seconds 5
    python -m tf_operator_tpu_torch.telemetry profile \
        --input profile-usr2-123.json --top 20
    python -m tf_operator_tpu_torch.telemetry profile --input p.json \
        --perfetto merged.json --trace debug-trace.json \
        --flight flight-usr2-123.jsonl

The `tracez` subcommand is the fleet trace collector's CLI
(telemetry/collector.py): give it a trace id plus replica URLs (or a
running observatory) and it prints the per-hop TTFT decomposition and
exports the merged cross-process Perfetto timeline:

    python -m tf_operator_tpu_torch.telemetry tracez --trace <32-hex id> \
        http://127.0.0.1:8443 http://127.0.0.1:8444 --perfetto t.json
    python -m tf_operator_tpu_torch.telemetry tracez --trace <id> \
        --observatory http://127.0.0.1:9090

The `kvz` subcommand is the fleet KV observatory's viewer: it builds
the fleet prefix directory (digest -> replicas) from /kv/digest plus
each replica's /kv/statz residency split, or reads a running
observatory's /debug/slozz kv block (which adds the router's
re-prefill waste attribution):

    python -m tf_operator_tpu_torch.telemetry kvz \
        http://127.0.0.1:8443 http://127.0.0.1:8444
    python -m tf_operator_tpu_torch.telemetry kvz \
        --observatory http://127.0.0.1:9090

The `historyz` and `alertz` subcommands fan the matching /debug/
pages out fleet-wide (collector.collect_history / collect_alerts) or
ask a running observatory for its fleet-level ring; `alertz` exits 3
when anything is firing, so it scripts as a health probe:

    python -m tf_operator_tpu_torch.telemetry historyz \
        http://127.0.0.1:8443 --series tf_operator_tpu_serve_ttft \
        --window 300 --q 0.95
    python -m tf_operator_tpu_torch.telemetry alertz \
        --observatory http://127.0.0.1:9090 --firing
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from .flight import flight_chrome_events
from .profiler import (
    profile_chrome_events,
    speedscope_from_folded,
    top_table,
)


def load_dump(path: str) -> List[dict]:
    """Parse one JSONL dump; raises ValueError naming the bad line."""
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from e
            if not isinstance(rec, dict) or "kind" not in rec:
                raise ValueError(
                    f"{path}:{lineno}: not a flight record (no 'kind')"
                )
            rec.setdefault("_source", path)
            records.append(rec)
    return records


def merge_timeline(dumps: List[List[dict]]) -> List[dict]:
    """One timeline across dumps: wall-clock first (comparable across
    processes), seq as the tiebreak within a process."""
    merged = [r for d in dumps for r in d]
    merged.sort(key=lambda r: (r.get("wall", 0.0), r.get("seq", 0)))
    return merged


def format_record(rec: dict, multi_source: bool) -> str:
    fields = rec.get("fields") or {}
    parts = [f"{k}={fields[k]}" for k in sorted(fields)]
    corr = rec.get("corr")
    prefix = f"[{corr}] " if corr else ""
    src = f" <{rec['_source']}>" if multi_source and "_source" in rec else ""
    return (
        f"{rec.get('wall', 0.0):17.6f} {rec.get('kind', '?'):<10} "
        f"{prefix}{' '.join(parts)}{src}"
    )


def fetch_profile(
    url: str, seconds: float, hz: int, timeout: float = 120.0
) -> dict:
    """GET a to_json() snapshot from a live /debug/profilez endpoint
    (blocking-captures `seconds` when the profiler isn't running)."""
    from urllib.request import urlopen

    query = f"action=snapshot&format=json&seconds={seconds}&hz={hz}"
    full = url.rstrip("/") + "/debug/profilez?" + query
    with urlopen(full, timeout=max(timeout, seconds + 30.0)) as resp:
        return json.load(resp)


def print_profile_tables(payload: dict, n: int) -> None:
    folded = payload.get("folded") or {}
    total = sum(folded.values()) or 1
    tables = top_table(folded, n=n)
    print(
        f"# {payload.get('samples', total)} samples @ "
        f"{payload.get('hz', '?')} Hz over "
        f"{payload.get('duration_seconds', 0.0)}s"
    )

    def emit(title: str, rows) -> None:
        print(f"# {title}")
        for name, count in rows:
            print(f"{count:8d}  {100.0 * count / total:5.1f}%  {name}")

    emit("roles", tables["roles"])
    emit(f"top {n} self", tables["self"])
    emit(f"top {n} cumulative", tables["cumulative"])


def profile_main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.telemetry profile",
        description="Capture/inspect sampling-profiler snapshots.",
    )
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument(
        "--url", help="base URL of a server exposing /debug/profilez "
        "(a serve port behind --enable-debug-endpoints, or a train "
        "CLI's --monitoring-bind-addr)",
    )
    source.add_argument(
        "--input", help="saved profile JSON (a /debug/profilez "
        "format=json snapshot or a SIGUSR2 profile-usr2-<pid>.json)",
    )
    parser.add_argument(
        "--seconds", type=float, default=5.0,
        help="capture window when fetching from --url (blocking "
        "capture if the remote profiler is stopped)",
    )
    parser.add_argument(
        "--hz", type=int, default=99, help="sampling rate for --url"
    )
    parser.add_argument(
        "--top", type=int, default=15,
        help="rows in the self/cumulative tables",
    )
    parser.add_argument(
        "--out", metavar="PATH",
        help="also save the raw profile JSON payload here",
    )
    parser.add_argument(
        "--folded", metavar="PATH",
        help="write collapsed 'role;stack count' lines here "
        "(flamegraph.pl / speedscope importable)",
    )
    parser.add_argument(
        "--speedscope", metavar="PATH",
        help="write speedscope file-format JSON here",
    )
    parser.add_argument(
        "--perfetto", metavar="PATH",
        help="write Chrome/Perfetto trace-event JSON here (profile "
        "sample tracks; --trace/--flight merge into the same file)",
    )
    parser.add_argument(
        "--trace", metavar="PATH",
        help="merge a saved /debug/trace JSON's span events into "
        "--perfetto",
    )
    parser.add_argument(
        "--flight", metavar="PATH", action="append", default=[],
        help="merge a flight JSONL dump's instants into --perfetto "
        "(repeatable; fetch the overlapping window with "
        "/debug/flightz?since=<the payload's wall_start>)",
    )
    parser.add_argument(
        "--quiet", action="store_true",
        help="skip the top-N tables (export only)",
    )
    args = parser.parse_args(argv)

    try:
        if args.input:
            with open(args.input) as f:
                payload = json.load(f)
        else:
            payload = fetch_profile(args.url, args.seconds, args.hz)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not isinstance(payload, dict) or "folded" not in payload:
        print("error: not a profile payload (no 'folded')", file=sys.stderr)
        return 1

    if not args.quiet:
        print_profile_tables(payload, args.top)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.out}")
    if args.folded:
        lines = [
            f"{stack} {count}"
            for stack, count in sorted(
                (payload.get("folded") or {}).items()
            )
        ]
        with open(args.folded, "w") as f:
            f.write(("\n".join(lines) + "\n") if lines else "")
        print(f"wrote {args.folded} ({len(lines)} stacks)")
    if args.speedscope:
        with open(args.speedscope, "w") as f:
            json.dump(speedscope_from_folded(payload), f)
        print(f"wrote {args.speedscope}")

    if args.perfetto:
        events = profile_chrome_events(payload)
        if args.trace:
            try:
                with open(args.trace) as f:
                    trace = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                print(
                    f"error: --trace {args.trace}: {e}", file=sys.stderr
                )
                return 1
            events = list(trace.get("traceEvents", [])) + events
        for dump_path in args.flight:
            try:
                events += flight_chrome_events(load_dump(dump_path))
            except (OSError, ValueError) as e:
                print(
                    f"error: --flight {dump_path}: {e}", file=sys.stderr
                )
                return 1
        with open(args.perfetto, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"}, f
            )
        print(f"wrote {args.perfetto} ({len(events)} events)")

    return 0


def tracez_main(argv) -> int:
    """The fleet trace collector as a CLI (`tracez` subcommand): fan
    out to replica /debug/flightz endpoints (or ask a running
    observatory for its already-merged page), print the per-hop TTFT
    decomposition, and optionally export the merged Perfetto file."""
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.telemetry tracez",
        description="Merge one trace's flight records fleet-wide and "
        "decompose per-hop TTFT (telemetry/collector.py).",
    )
    parser.add_argument("--trace", required=True, help="32-hex trace id")
    parser.add_argument(
        "replicas", nargs="*", metavar="URL",
        help="replica base URLs to fan out to directly",
    )
    parser.add_argument(
        "--observatory", metavar="URL",
        help="fetch the merged page from a router observatory's "
        "/debug/tracez instead of fanning out from here",
    )
    parser.add_argument(
        "--samples", type=int, default=3,
        help="clock-handshake round trips per replica (default 3)",
    )
    parser.add_argument(
        "--perfetto", metavar="PATH",
        help="write the merged Perfetto trace-event JSON here",
    )
    parser.add_argument(
        "--quiet", action="store_true",
        help="skip the breakdown print (export only)",
    )
    args = parser.parse_args(argv)
    if bool(args.observatory) == bool(args.replicas):
        print(
            "error: give replica URLs or --observatory, not both/neither",
            file=sys.stderr,
        )
        return 2

    if args.observatory:
        import urllib.request

        url = (
            args.observatory.rstrip("/")
            + f"/debug/tracez?trace={args.trace}"
        )
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                page = json.loads(resp.read())
        except OSError as e:
            print(f"error: {url}: {e}", file=sys.stderr)
            return 1
    else:
        from ..serve.client import DecodeClient
        from .collector import collect_trace

        clients = {u: DecodeClient(u) for u in args.replicas}
        try:
            page = collect_trace(
                args.trace, clients, handshake_samples=args.samples
            )
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    if not args.quiet:
        bd = page["breakdown"]
        print(
            f"# trace {page['trace']}: {len(page['records'])} records, "
            f"mode {bd['mode']}, "
            f"ttft {bd['ttft_s']}s, clamped {bd['clamped_s']}s"
        )
        for name, info in sorted(page.get("replicas", {}).items()):
            print(
                f"#   {name}: rtt {info['rtt_s']}s "
                f"offset {info['offset_s']}s"
            )
        for hop in bd["hops"]:
            bar = "#" * max(1, int(hop["duration_s"] * 200))
            print(f"{hop['name']:>16} {hop['duration_s']:>10.6f}s {bar}")
        if bd["missing"]:
            print(f"missing boundaries: {', '.join(bd['missing'])}")
        if page["orphans"]:
            ops = sorted(
                {
                    str((r.get("fields") or {}).get("op"))
                    for r in page["orphans"]
                }
            )
            print(f"ORPHANS: {len(page['orphans'])} records, ops {ops}")
    if args.perfetto:
        with open(args.perfetto, "w") as f:
            json.dump(page["perfetto"], f)
        n = len(page["perfetto"]["traceEvents"])
        print(f"wrote {args.perfetto} ({n} events)")
    return 0


def historyz_main(argv) -> int:
    """Fleet history fan-out (`historyz` subcommand): fan
    /debug/historyz out to replica URLs (collector.collect_history)
    or fetch one page from a running observatory, and print windowed
    rates/quantiles per replica."""
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.telemetry historyz",
        description="Query the telemetry history rings fleet-wide "
        "(telemetry/history.py).",
    )
    parser.add_argument(
        "replicas", nargs="*", metavar="URL",
        help="replica base URLs to fan out to directly",
    )
    parser.add_argument(
        "--observatory", metavar="URL",
        help="fetch the fleet-level ring from a router observatory's "
        "/debug/historyz instead of fanning out from here",
    )
    parser.add_argument(
        "--series", help="series name or prefix filter",
    )
    parser.add_argument(
        "--window", type=float, default=300.0,
        help="query window in seconds (default 300)",
    )
    parser.add_argument(
        "--q", type=float, help="add this quantile for histogram series",
    )
    parser.add_argument(
        "--json", action="store_true", help="dump the raw JSON page",
    )
    args = parser.parse_args(argv)
    if bool(args.observatory) == bool(args.replicas):
        print(
            "error: give replica URLs or --observatory, not both/neither",
            file=sys.stderr,
        )
        return 2

    if args.observatory:
        import urllib.parse
        import urllib.request

        params = {"window": args.window}
        if args.series:
            params["series"] = args.series
        if args.q is not None:
            params["q"] = args.q
        url = (
            args.observatory.rstrip("/")
            + "/debug/historyz?"
            + urllib.parse.urlencode(params)
        )
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                inner = json.loads(resp.read())
        except OSError as e:
            print(f"error: {url}: {e}", file=sys.stderr)
            return 1
        page = {
            "replicas": {"observatory": inner},
            "scrape_errors": {},
            "partial": False,
        }
    else:
        from ..serve.client import DecodeClient
        from .collector import collect_history

        clients = {u: DecodeClient(u) for u in args.replicas}
        page = collect_history(
            clients, series=args.series, window_s=args.window, q=args.q
        )

    if args.json:
        print(json.dumps(page, indent=1))
    else:
        for name, doc in sorted(page["replicas"].items()):
            print(
                f"# {name}: {len(doc.get('series', []))} series, "
                f"{doc.get('ticks', 0)} ticks, window {args.window:g}s"
            )
            for row in doc.get("series", []):
                cells = [
                    f"{k}={row[k]}" for k in sorted(row)
                    if k not in ("series", "kind") and row[k] is not None
                ]
                print(f"  {row['series']:<50} [{row['kind']}] "
                      + " ".join(cells))
        for name, err in sorted(page["scrape_errors"].items()):
            print(f"# {name}: SCRAPE FAILED: {err}", file=sys.stderr)
    return 1 if page["partial"] else 0


def alertz_main(argv) -> int:
    """Fleet alert fan-out (`alertz` subcommand): merge every
    replica's /debug/alertz into one page (collector.collect_alerts)
    or fetch one from a running observatory."""
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.telemetry alertz",
        description="Collect alert rule states fleet-wide "
        "(telemetry/alerts.py).",
    )
    parser.add_argument(
        "replicas", nargs="*", metavar="URL",
        help="replica base URLs to fan out to directly",
    )
    parser.add_argument(
        "--observatory", metavar="URL",
        help="fetch the fleet-level alert page from a router "
        "observatory's /debug/alertz instead of fanning out",
    )
    parser.add_argument(
        "--firing", action="store_true",
        help="show only instances currently firing",
    )
    parser.add_argument(
        "--json", action="store_true", help="dump the raw JSON page",
    )
    args = parser.parse_args(argv)
    if bool(args.observatory) == bool(args.replicas):
        print(
            "error: give replica URLs or --observatory, not both/neither",
            file=sys.stderr,
        )
        return 2

    if args.observatory:
        import urllib.request

        url = args.observatory.rstrip("/") + "/debug/alertz"
        if args.firing:
            url += "?firing=1"
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                inner = json.loads(resp.read())
        except OSError as e:
            print(f"error: {url}: {e}", file=sys.stderr)
            return 1
        page = {
            "replicas": {"observatory": inner},
            "firing": inner.get("firing", []),
            "scrape_errors": {},
            "partial": False,
        }
    else:
        from ..serve.client import DecodeClient
        from .collector import collect_alerts

        clients = {u: DecodeClient(u) for u in args.replicas}
        page = collect_alerts(clients)

    if args.json:
        print(json.dumps(page, indent=1))
    else:
        print(
            f"# firing fleet-wide: "
            f"{', '.join(page['firing']) if page['firing'] else '(none)'}"
        )
        for name, doc in sorted(page["replicas"].items()):
            for inst in doc.get("instances", []):
                if args.firing and inst["state"] != "firing":
                    continue
                print(
                    f"  {name:<28} {inst['instance']:<28} "
                    f"{inst['state']:<9} value={inst['value']} "
                    f"fire>{inst['fire_above']}"
                )
        for name, err in sorted(page["scrape_errors"].items()):
            print(f"# {name}: SCRAPE FAILED: {err}", file=sys.stderr)
    if page["firing"]:
        return 3  # distinct from scrape failure: alerts ARE firing
    return 1 if page["partial"] else 0


def kvz_main(argv) -> int:
    """The fleet KV observatory as a CLI (`kvz` subcommand): build
    the fleet prefix directory from replica /kv/digest pages plus the
    per-replica /kv/statz residency split, or read a running
    observatory's /debug/slozz kv block (which adds the router's
    re-prefill waste attribution), and render it as tables."""
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.telemetry kvz",
        description="Fleet KV observatory: prefix directory, "
        "duplication, cached-idle split, and re-prefill waste "
        "(serve/observatory.py).",
    )
    parser.add_argument(
        "replicas", nargs="*", metavar="URL",
        help="replica base URLs to fan out to directly",
    )
    parser.add_argument(
        "--observatory", metavar="URL",
        help="read the kv block from a router observatory's "
        "/debug/slozz instead of fanning out from here",
    )
    parser.add_argument(
        "--top", type=int, default=10,
        help="rows in the hot-prefix / duplication tables",
    )
    parser.add_argument(
        "--json", action="store_true", help="dump the raw JSON page",
    )
    args = parser.parse_args(argv)
    if bool(args.observatory) == bool(args.replicas):
        print(
            "error: give replica URLs or --observatory, not both/neither",
            file=sys.stderr,
        )
        return 2

    if args.observatory:
        import urllib.request

        url = args.observatory.rstrip("/") + "/debug/slozz"
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                slozz = json.loads(resp.read())
        except OSError as e:
            print(f"error: {url}: {e}", file=sys.stderr)
            return 1
        kv = slozz.get("kv") or {}
        if args.json:
            print(json.dumps(kv, indent=1))
            return 0
        print(
            f"# fleet kv: duplication_factor="
            f"{kv.get('duplication_factor')} "
            f"unique_blocks={kv.get('unique_blocks')} "
            f"held_blocks={kv.get('held_blocks')} "
            f"cached_idle={kv.get('cached_idle_blocks')}"
        )
        print(
            f"# reprefill waste: "
            f"{kv.get('reprefill_waste_tokens_total', 0.0):g} tokens "
            f"over {kv.get('reprefill_waste_events', 0)} streams "
            f"(prefix_affinity="
            f"{'on' if kv.get('prefix_affinity', True) else 'off'})"
        )
        for row in kv.get("top_duplicated", [])[:args.top]:
            print(
                f"  {row['digest']}  x{len(row['replicas'])}  "
                f"{','.join(row['replicas'])}"
            )
        return 0

    from ..serve.client import DecodeClient

    directory: dict = {}
    statz: dict = {}
    errors: dict = {}
    for url in args.replicas:
        client = DecodeClient(url)
        try:
            dig = client.kv_digest()
            statz[url] = client.kv_statz(top=args.top)
            for digest in dig.get("digest") or []:
                directory.setdefault(digest, []).append(url)
        except Exception as err:  # noqa: BLE001 — a fleet page must
            # survive any one replica's failure mode
            errors[url] = str(err)
    unique = len(directory)
    held = sum(len(holders) for holders in directory.values())
    page = {
        "directory": directory,
        "unique_blocks": unique,
        "held_blocks": held,
        "duplication_factor": round(held / unique, 6) if unique else 0.0,
        "statz": statz,
        "scrape_errors": errors,
        "partial": bool(errors),
    }
    if args.json:
        print(json.dumps(page, indent=1))
    else:
        print(
            f"# fleet kv: duplication_factor="
            f"{page['duplication_factor']} unique_blocks={unique} "
            f"held_blocks={held} over {len(statz)} replica(s)"
        )
        dup_rows = sorted(
            (
                (digest, holders)
                for digest, holders in directory.items()
                if len(holders) > 1
            ),
            key=lambda kv_row: (-len(kv_row[1]), kv_row[0]),
        )
        for digest, holders in dup_rows[:args.top]:
            print(f"  {digest}  x{len(holders)}  {','.join(holders)}")
        for url, doc in sorted(statz.items()):
            if not doc.get("paged"):
                print(f"# {url}: not paged")
                continue
            split = doc.get("split") or {}
            frag = doc.get("fragmentation") or {}
            print(
                f"# {url}: free={split.get('free')} "
                f"cached_idle={split.get('cached_idle')} "
                f"cached_shared={split.get('cached_shared')} "
                f"private={split.get('private')} "
                f"frag_ratio={frag.get('ratio')}"
            )
            for row in doc.get("hot_prefixes", [])[:args.top]:
                print(
                    f"    {row['digest']}  hits={row['hits']} "
                    f"attaches={row['attaches']} "
                    f"age={row['age_ticks']}t "
                    f"{'idle' if row['idle'] else 'shared'}"
                )
        for url, err in sorted(errors.items()):
            print(f"# {url}: SCRAPE FAILED: {err}", file=sys.stderr)
    return 1 if page["partial"] else 0


def trainz_main(argv) -> int:
    """The training observatory as a CLI (`trainz` subcommand, kvz's
    train-plane mirror): fan out to worker /debug/slozz pages for the
    goodput ledger + phase split, or read a fleet observatory's
    train_fleet block for the straggler/stall view."""
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.telemetry trainz",
        description="Training observatory: per-worker goodput, step-"
        "phase split, straggler/stall skew (train/observe.py).",
    )
    parser.add_argument(
        "workers", nargs="*", metavar="URL",
        help="worker telemetry base URLs to fan out to directly",
    )
    parser.add_argument(
        "--observatory", metavar="URL",
        help="read the train_fleet block from a fleet observatory's "
        "/debug/slozz instead of fanning out from here",
    )
    parser.add_argument(
        "--json", action="store_true", help="dump the raw JSON page",
    )
    args = parser.parse_args(argv)
    if bool(args.observatory) == bool(args.workers):
        print(
            "error: give worker URLs or --observatory, not both/neither",
            file=sys.stderr,
        )
        return 2

    import urllib.request

    if args.observatory:
        url = args.observatory.rstrip("/") + "/debug/slozz"
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                slozz = json.loads(resp.read())
        except OSError as e:
            print(f"error: {url}: {e}", file=sys.stderr)
            return 1
        fleet = slozz.get("train_fleet") or {}
        if args.json:
            print(json.dumps(fleet, indent=1))
            return 0
        print(
            f"# train fleet: last_step={fleet.get('last_step')} "
            f"median_steps_per_sec={fleet.get('median_steps_per_sec')} "
            f"stragglers={fleet.get('stragglers')} "
            f"stalled={fleet.get('stalled')}"
        )
        for name, row in sorted((fleet.get("workers") or {}).items()):
            print(
                f"  {name:<20} step={row.get('steps')} "
                f"rate={row.get('steps_per_sec')}/s "
                f"slowdown={row.get('slowdown')} "
                f"stall_ratio={row.get('stall_ratio')} "
                f"phase={row.get('phase')}"
            )
        return 0

    pages: dict = {}
    errors: dict = {}
    for url in args.workers:
        try:
            with urllib.request.urlopen(
                url.rstrip("/") + "/debug/slozz", timeout=60
            ) as resp:
                pages[url] = json.loads(resp.read()).get("train") or {}
        except Exception as err:  # noqa: BLE001 — a fleet page must
            # survive any one worker's failure mode
            errors[url] = str(err)
    page = {
        "workers": pages,
        "scrape_errors": errors,
        "partial": bool(errors),
    }
    if args.json:
        print(json.dumps(page, indent=1))
    else:
        for url, block in sorted(pages.items()):
            health = block.get("healthz") or {}
            goodput = block.get("goodput") or {}
            phases = block.get("phases") or {}
            print(
                f"# {url}: phase={health.get('phase')} "
                f"steps={phases.get('steps')} "
                f"goodput={goodput.get('goodput_fraction')} "
                f"coverage={phases.get('coverage')}"
            )
            wasted = goodput.get("wasted") or {}
            if wasted:
                print(
                    "    wasted: " + " ".join(
                        f"{reason}={entry['seconds']:g}s"
                        for reason, entry in sorted(wasted.items())
                        if entry.get("seconds")
                    )
                )
            for phase, seconds in sorted(
                (phases.get("phase_seconds") or {}).items(),
                key=lambda row: -row[1],
            ):
                if seconds:
                    print(f"    {phase:<16} {seconds:g}s")
        for url, err in sorted(errors.items()):
            print(f"# {url}: SCRAPE FAILED: {err}", file=sys.stderr)
    return 1 if page["partial"] else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "profile":
        # subcommand dispatch; the bare form stays the flight-dump
        # inspector (serve --smoke invokes it with positional dumps)
        return profile_main(argv[1:])
    if argv and argv[0] == "tracez":
        return tracez_main(argv[1:])
    if argv and argv[0] == "historyz":
        return historyz_main(argv[1:])
    if argv and argv[0] == "alertz":
        return alertz_main(argv[1:])
    if argv and argv[0] == "kvz":
        return kvz_main(argv[1:])
    if argv and argv[0] == "trainz":
        return trainz_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m tf_operator_tpu_torch.telemetry",
        description="Merge and inspect flight-recorder JSONL dumps.",
    )
    parser.add_argument("dumps", nargs="+", help="flight JSONL dump path(s)")
    parser.add_argument("--kind", help="keep only records of this kind")
    parser.add_argument(
        "--corr", help="keep only records with this correlation ID"
    )
    parser.add_argument(
        "--limit", type=int, help="keep only the newest N records"
    )
    parser.add_argument(
        "--perfetto", metavar="PATH",
        help="write Chrome/Perfetto trace-event JSON here",
    )
    parser.add_argument(
        "--trace", metavar="PATH",
        help="merge a saved /debug/trace JSON's events into --perfetto",
    )
    parser.add_argument(
        "--quiet", action="store_true",
        help="skip the timeline print (export only)",
    )
    args = parser.parse_args(argv)

    try:
        dumps = [load_dump(p) for p in args.dumps]
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    timeline = merge_timeline(dumps)
    if args.kind:
        timeline = [r for r in timeline if r.get("kind") == args.kind]
    if args.corr:
        timeline = [r for r in timeline if r.get("corr") == args.corr]
    if args.limit and args.limit > 0:
        timeline = timeline[-args.limit:]

    if not args.quiet:
        multi = len(args.dumps) > 1
        corrs = {r.get("corr") for r in timeline if r.get("corr")}
        print(
            f"# {len(timeline)} records, {len(corrs)} correlation IDs, "
            f"{len(args.dumps)} dump(s)"
        )
        for rec in timeline:
            print(format_record(rec, multi))

    if args.perfetto:
        events = flight_chrome_events(timeline)
        if args.trace:
            try:
                with open(args.trace) as f:
                    trace = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                print(f"error: --trace {args.trace}: {e}", file=sys.stderr)
                return 1
            events = list(trace.get("traceEvents", [])) + events
        with open(args.perfetto, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"}, f
            )
        print(f"wrote {args.perfetto} ({len(events)} events)")

    return 0


if __name__ == "__main__":
    sys.exit(main())
