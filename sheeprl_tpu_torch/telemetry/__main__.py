"""``python -m sheeprl_tpu_torch.telemetry`` — run inspection CLIs
(counterpart of ``python -m sheeprl_tpu.telemetry``; the same renderings).

``tail <logdir>`` renders the current counters and throughput of a
(possibly still running) run straight from its ``telemetry.jsonl``: the
meta line, the most recent counters interval (with the ``*_per_s`` rates
when present), every ``health/*`` gauge and the trailing health events.
Pure stdlib and read-only: it tails the JSONL the run is appending to.
``--follow`` re-renders every ``--interval`` seconds until interrupted.

``flight <logdir>`` is the post-mortem side: it lists every flight dump
under the log dir (trip reason, processes, span counts, trace IDs), shows
one dump in detail, and with ``--merge OUT`` writes the cross-process
aggregated trace (every ``trace.json``, flight dump and spill file under
the dir on one wall-clock timeline; ``--trace`` filters to one trace ID).

The JAX package's ``mesh`` inspector and ``perf`` regression gate wait for
the port's multi-device layer and benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from sheeprl_tpu_torch.telemetry.telemetry import JSONL_FILENAME

def find_jsonl(path: str) -> Optional[str]:
    """Resolve a telemetry.jsonl from a file path, a run dir, or any
    ancestor dir (newest match wins — 'point me at logs/runs and show me
    the latest run' is the common case)."""
    if os.path.isfile(path):
        return path
    direct = os.path.join(path, JSONL_FILENAME)
    if os.path.isfile(direct):
        return direct
    newest: Optional[str] = None
    newest_mtime = -1.0
    for root, _dirs, files in os.walk(path):
        if JSONL_FILENAME in files:
            candidate = os.path.join(root, JSONL_FILENAME)
            mtime = os.path.getmtime(candidate)
            if mtime > newest_mtime:
                newest, newest_mtime = candidate, mtime
    return newest


def load_records(path: str) -> List[Dict[str, Any]]:
    records: List[Dict[str, Any]] = []
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # a concurrent writer may leave a torn last line
            if isinstance(rec, dict):
                records.append(rec)
    return records


def _fmt_value(value: Any) -> str:
    try:
        f = float(value)
    except (TypeError, ValueError):
        return str(value)
    if f.is_integer() and abs(f) < 1e12:
        return str(int(f))
    return f"{f:.6g}"


def render(records: List[Dict[str, Any]], max_events: int = 8) -> str:
    meta = next((r for r in records if r.get("type") == "meta"), None)
    intervals = [r for r in records if r.get("type") == "counters" and r.get("step", -1) >= 0]
    final = next((r for r in records if r.get("type") == "counters" and r.get("step") == -1), None)
    events = [r for r in records if r.get("type") == "health_event"]
    latest = intervals[-1] if intervals else final

    lines: List[str] = []
    if meta is not None:
        lines.append(
            f"run: backend={meta.get('backend', '?')} process={meta.get('process_index', '?')} "
            f"started={time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(meta.get('time', 0)))}"
        )
    if latest is None:
        lines.append("no counters intervals yet")
        return "\n".join(lines) + "\n"
    step = latest.get("step", -1)
    lines.append(f"step: {step}" + ("  (final)" if latest is final and step == -1 else ""))
    values: Dict[str, Any] = latest.get("values") or {}
    rates: Dict[str, Any] = latest.get("rates") or {}
    health = {k: v for k, v in values.items() if k.startswith("health/")}
    plain = {k: v for k, v in values.items() if not k.startswith("health/")}
    if plain:
        lines.append("counters:")
        for name in sorted(plain):
            suffix = f"  ({_fmt_value(rates[name])}/s)" if name in rates else ""
            lines.append(f"  {name:<32} {_fmt_value(plain[name])}{suffix}")
    if health:
        lines.append("health:")
        for name in sorted(health):
            lines.append(f"  {name:<32} {_fmt_value(health[name])}")
    if events:
        lines.append(f"health events ({len(events)} total, last {min(max_events, len(events))}):")
        for event in events[-max_events:]:
            lines.append(
                f"  [step {event.get('step', '?')}] {event.get('metric', '?')} "
                f"{event.get('kind', '?')} value={_fmt_value(event.get('value'))} "
                f"policy={event.get('policy', '?')} {event.get('message', '')}".rstrip()
            )
    else:
        lines.append("health events: none")
    return "\n".join(lines) + "\n"


def tail(path: str, follow: bool = False, interval: float = 2.0, out: Any = None) -> int:
    out = out if out is not None else sys.stdout
    jsonl = find_jsonl(path)
    if jsonl is None:
        print(f"no {JSONL_FILENAME} found under {path!r} (is telemetry enabled?)", file=sys.stderr)
        return 1
    while True:
        out.write(f"== {jsonl} ==\n")
        out.write(render(load_records(jsonl)))
        out.flush()
        if not follow:
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:  # pragma: no cover - interactive exit
            return 0


def find_flight_dumps(path: str) -> List[str]:
    """Every ``flight_*.json`` under ``path``, newest last."""
    dumps: List[str] = []
    if os.path.isfile(path):
        return [path]
    for root, _dirs, files in os.walk(path):
        for name in files:
            if name.startswith("flight_") and name.endswith(".json"):
                dumps.append(os.path.join(root, name))
    return sorted(dumps, key=os.path.getmtime)


def _load_dump(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as fp:
            doc = json.load(fp)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def render_flight_summary(path: str, doc: Dict[str, Any]) -> str:
    processes: Dict[str, Any] = doc.get("processes") or {}
    spans = sum(int(p.get("spans", 0)) for p in processes.values())
    events = sum(int(p.get("events", 0)) for p in processes.values())
    when = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(doc.get("wall_s", 0)))
    return (
        f"{path}\n  reason={doc.get('reason', '?')} at {when} (pid {doc.get('pid', '?')})"
        f"  processes={len(processes)} spans={spans} events={events}"
        f" trace_ids={len(doc.get('trace_ids') or {})}"
    )


def render_flight_detail(doc: Dict[str, Any], max_traces: int = 8) -> str:
    lines: List[str] = []
    lines.append(f"reason:  {doc.get('reason', '?')}")
    if doc.get("message"):
        lines.append(f"message: {doc['message']}")
    lines.append(f"tripped by pid {doc.get('pid', '?')}")
    processes: Dict[str, Any] = doc.get("processes") or {}
    lines.append(f"processes ({len(processes)}):")
    for pid in sorted(processes, key=lambda p: int(p) if str(p).isdigit() else 0):
        proc = processes[pid]
        info = proc.get("run_info") or {}
        label = " ".join(f"{k}={v}" for k, v in sorted(info.items())) or "-"
        lines.append(
            f"  pid {pid:<8} {label:<32} spans={proc.get('spans', 0)} events={proc.get('events', 0)}"
        )
        metrics = proc.get("metrics") or {}
        counters = metrics.get("counters") or {}
        for name in sorted(counters)[:6]:
            lines.append(f"    {name:<34} {_fmt_value(counters[name])}")
    trace_ids: Dict[str, int] = doc.get("trace_ids") or {}
    if trace_ids:
        ranked = sorted(trace_ids.items(), key=lambda kv: -kv[1])
        lines.append(f"trace ids ({len(trace_ids)} distinct, top {min(max_traces, len(ranked))}):")
        for tid, count in ranked[:max_traces]:
            lines.append(f"  {tid}  spans/events: {count}")
    return "\n".join(lines) + "\n"


def flight(
    path: str,
    merge: Optional[str] = None,
    trace_id: Optional[str] = None,
    show: Optional[str] = None,
    out: Any = None,
) -> int:
    out = out if out is not None else sys.stdout
    if merge is not None:
        from sheeprl_tpu_torch.telemetry.flight import aggregate_traces

        doc = aggregate_traces(path, trace_id=trace_id)
        with open(merge, "w") as fp:
            json.dump(doc, fp)
        meta = doc.get("metadata") or {}
        out.write(
            f"merged {len(doc.get('traceEvents') or [])} events from "
            f"{len(meta.get('sources') or [])} sources into {merge}\n"
        )
        if meta.get("trace_ids"):
            out.write(f"trace ids seen: {len(meta['trace_ids'])}\n")
        return 0
    dumps = find_flight_dumps(path)
    if not dumps:
        print(f"no flight_*.json found under {path!r} (nothing tripped yet?)", file=sys.stderr)
        return 1
    target = show or dumps[-1]
    for dump_path in dumps:
        doc = _load_dump(dump_path)
        if doc is not None:
            out.write(render_flight_summary(dump_path, doc) + "\n")
    doc = _load_dump(target)
    if doc is not None:
        out.write(f"\n== {target} ==\n")
        out.write(render_flight_detail(doc))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sheeprl_tpu_torch.telemetry",
        description="Inspect a run's telemetry.jsonl (counters, rates) and its flight dumps.",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_tail = sub.add_parser("tail", help="render current counters/throughput from a run's telemetry.jsonl")
    p_tail.add_argument("logdir", help="telemetry.jsonl path, a run dir, or any ancestor (newest run wins)")
    p_tail.add_argument("--follow", "-f", action="store_true", help="re-render until interrupted")
    p_tail.add_argument("--interval", type=float, default=2.0, help="seconds between renders with --follow")
    p_flight = sub.add_parser("flight", help="list/inspect flight dumps; --merge writes the cross-process trace")
    p_flight.add_argument("logdir", help="a run dir (or any ancestor) holding flight_*.json dumps")
    p_flight.add_argument("--show", help="specific dump to detail (default: the newest)")
    p_flight.add_argument("--merge", metavar="OUT", help="write the merged cross-process trace JSON here")
    p_flight.add_argument("--trace", dest="trace_id", help="with --merge: keep only this trace id")
    args = parser.parse_args(argv)
    if args.command == "tail":
        return tail(args.logdir, follow=args.follow, interval=args.interval)
    return flight(args.logdir, merge=args.merge, trace_id=args.trace_id, show=args.show)


if __name__ == "__main__":  # pragma: no cover
    try:
        raise SystemExit(main())
    except BrokenPipeError:
        # `... tail <dir> | head` closes the pipe mid-render: the reader's choice.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        raise SystemExit(0)
