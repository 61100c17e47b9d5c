"""Offline telemetry snapshots: ``python -m repro_torch.obs.dump``.

Two modes:

- ``--url http://host:port`` — scrape a live exposition endpoint
  (``/metrics`` and, unless ``--no-health``, ``/healthz``) and print
  what it returned.  This is the operator's one-liner for a store
  serving through ``VSS.start_metrics_server()`` or an `ObjectServer`.
- no ``--url`` — dump this process' default registry (useful from a
  REPL or a harness that imported repro_torch and ran a workload in-process).

``--format prom`` prints Prometheus text; ``--format json`` (default)
prints a JSON document with ``metrics`` and ``healthz`` keys."""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request


def _fetch(url: str, timeout: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dump",
        description="snapshot VSS telemetry (live endpoint or in-process)",
    )
    ap.add_argument("--url", default=None,
                    help="base URL of a /metrics+/healthz server")
    ap.add_argument("--format", choices=("json", "prom"), default="json")
    ap.add_argument("--no-health", action="store_true",
                    help="skip the /healthz probe")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)

    if args.url:
        base = args.url.rstrip("/")
        metrics_text = _fetch(base + "/metrics", args.timeout)
        if args.format == "prom":
            sys.stdout.write(metrics_text)
            if not args.no_health:
                sys.stdout.write("\n# healthz\n")
                try:
                    sys.stdout.write(_fetch(base + "/healthz", args.timeout))
                except urllib.error.HTTPError as exc:  # 503 = unhealthy
                    sys.stdout.write(exc.read().decode("utf-8"))
                sys.stdout.write("\n")
            return 0
        out = {"metrics_text": metrics_text}
        if not args.no_health:
            try:
                out["healthz"] = json.loads(
                    _fetch(base + "/healthz", args.timeout)
                )
            except urllib.error.HTTPError as exc:
                out["healthz"] = json.loads(exc.read().decode("utf-8"))
        json.dump(out, sys.stdout, indent=2)
        sys.stdout.write("\n")
        return 0

    from repro_torch.obs.registry import default_registry

    reg = default_registry()
    if args.format == "prom":
        sys.stdout.write(reg.render_prometheus())
    else:
        json.dump({"enabled": reg.enabled, "metrics": reg.snapshot()},
                  sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI shim
    raise SystemExit(main())
