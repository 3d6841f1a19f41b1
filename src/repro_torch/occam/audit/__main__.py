"""The ``make audit`` CI gate: ``python -m repro.occam.audit [paths...]``.

With no arguments, discovers every checked-in plan/frontier artifact
(``*.plan.json`` / ``*.frontier.json`` under the working tree) and
audits each, then runs the ``occam/serve`` concurrency lint. Exits
nonzero iff any error-severity finding survives. Explicit paths (files
or directories) restrict the artifact scan; ``--no-lint`` skips the
serve lint; ``--json`` emits the combined reports as one JSON document
instead of text.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .api import audit_path
from .concurrency import lint_serve

_SKIP_DIRS = {".git", "__pycache__", ".venv", "node_modules",
              ".pytest_cache", ".ruff_cache"}


def _is_artifact(name: str) -> bool:
    return name.endswith(".plan.json") or name.endswith(".frontier.json")


def discover(paths: list[str]) -> list[str]:
    found: list[str] = []
    for path in paths:
        if os.path.isfile(path):
            found.append(path)
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            found += (os.path.join(dirpath, f)
                      for f in sorted(filenames) if _is_artifact(f))
    return found


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.occam.audit", description=__doc__)
    parser.add_argument("paths", nargs="*", default=None,
                        help="artifact files or directories to scan "
                             "(default: the working tree)")
    parser.add_argument("--no-lint", action="store_true",
                        help="skip the occam/serve concurrency lint")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit reports as one JSON document")
    args = parser.parse_args(argv)

    artifacts = discover(args.paths or [os.getcwd()])
    reports = []
    for path in artifacts:
        reports.append(audit_path(path))
    if not args.no_lint:
        reports.append(lint_serve())

    if args.as_json:
        print(json.dumps([r.to_dict() for r in reports], indent=2))
    else:
        if not artifacts:
            print("audit: no *.plan.json / *.frontier.json artifacts "
                  "found (nothing to verify there); serve lint "
                  f"{'skipped' if args.no_lint else 'still runs'}")
        for rep in reports:
            print(rep.summary())
            for f in rep.findings:
                print(f"  {f.rule} [{f.severity}] {f.locus}: {f.message}")
    bad = [r for r in reports if not r.ok]
    if bad:
        print(f"audit: FAILED ({len(bad)} of {len(reports)} reports "
              f"carry error findings)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
