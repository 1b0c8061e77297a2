"""Summary-inspect CLI: browse and diff the scribe's acked summary commits.

A port of ``fluidframework_tpu/tools/summary_inspect.py``.  Operator
tooling over a port scribe's service directory (``server/scribe.py``
``SummaryRecordStore``; the console script is
``fftpu-torch-summary-inspect``):

    python -m fluidframework_tpu_torch.tools.summary_inspect list DIR [--doc ID]
    python -m fluidframework_tpu_torch.tools.summary_inspect show DIR --doc ID [--commit SHA]
    python -m fluidframework_tpu_torch.tools.summary_inspect diff DIR --doc ID [SHA_A SHA_B]

``list`` prints one JSON line per acked commit (doc, seq, sha, family) —
the whole version chain when the object log holds the parents.  ``diff``
walks two materialized summaries and reports added/removed/changed paths
(defaults to the latest commit against its parent).  Read-only: safe
against a live scribe.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any


def _open(directory: str):
    from ..server.scribe import SummaryRecordStore

    return SummaryRecordStore.open(directory)


def _chain(store, doc_id: str) -> list[dict]:
    """Latest-first (seq, commit) chain for a doc, following parents."""
    ref = store.refs.get(doc_id)
    out = []
    sha = None if ref is None else ref["commit"]
    while sha is not None and sha in store.store:
        kind, payload = store.store.get(sha)
        if kind != "commit":
            break
        out.append({"commit": sha, "seq": payload["seq"]})
        sha = payload.get("parent")
    return out


def _materialize(store, doc_id: str, sha: str | None) -> tuple[int, dict]:
    ref = store.refs.get(doc_id)
    if sha is None:
        if ref is None:
            raise SystemExit(f"no acked summary for doc {doc_id!r}")
        sha = ref["commit"]
    kind, payload = store.store.get(sha)
    if kind != "commit":
        raise SystemExit(f"{sha[:12]} is a {kind}, not a commit")
    return payload["seq"], store.store.read_snapshot(payload["tree"])


def _diff(a: Any, b: Any, path: str = "") -> list[dict]:
    """Structural diff of two materialized summaries (path, kind, values
    elided past a size cap — operators diff shape first, bytes second)."""
    def clip(v: Any) -> Any:
        s = json.dumps(v)
        return v if len(s) <= 120 else s[:117] + "..."

    if isinstance(a, dict) and isinstance(b, dict):
        out: list[dict] = []
        for k in sorted(set(a) | set(b)):
            p = f"{path}/{k}" if path else k
            if k not in a:
                out.append({"path": p, "kind": "added", "to": clip(b[k])})
            elif k not in b:
                out.append({"path": p, "kind": "removed", "from": clip(a[k])})
            else:
                out.extend(_diff(a[k], b[k], p))
        return out
    if a != b:
        return [{"path": path, "kind": "changed", "from": clip(a), "to": clip(b)}]
    return []


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="summary-inspect", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    p_list = sub.add_parser("list", help="list acked summary commits")
    p_list.add_argument("directory")
    p_list.add_argument("--doc", default=None)

    p_show = sub.add_parser("show", help="materialize one summary record")
    p_show.add_argument("directory")
    p_show.add_argument("--doc", required=True)
    p_show.add_argument("--commit", default=None)

    p_diff = sub.add_parser("diff", help="diff two summaries of one doc")
    p_diff.add_argument("directory")
    p_diff.add_argument("--doc", required=True)
    p_diff.add_argument("shas", nargs="*",
                        help="two commit shas (default: latest vs parent)")

    args = p.parse_args(argv)
    store = _open(args.directory)

    if args.cmd == "list":
        docs = [args.doc] if args.doc else store.docs()
        for doc in docs:
            ref = store.refs.get(doc)
            for entry in _chain(store, doc):
                print(json.dumps({
                    "doc": doc, **entry,
                    "family": (ref or {}).get("family"),
                    "latest": entry["commit"] == (ref or {}).get("commit"),
                }))
        return 0

    if args.cmd == "show":
        seq, record = _materialize(store, args.doc, args.commit)
        print(json.dumps({"doc": args.doc, "seq": seq, "record": record}))
        return 0

    # diff
    if len(args.shas) == 2:
        sha_a, sha_b = args.shas
    elif not args.shas:
        chain = _chain(store, args.doc)
        if len(chain) < 2:
            print(json.dumps({"error": "need two commits to diff",
                              "available": chain}))
            return 1
        sha_b, sha_a = chain[0]["commit"], chain[1]["commit"]
    else:
        p.error("diff takes exactly 0 or 2 commit shas")
    seq_a, rec_a = _materialize(store, args.doc, sha_a)
    seq_b, rec_b = _materialize(store, args.doc, sha_b)
    print(json.dumps({
        "doc": args.doc,
        "from": {"commit": sha_a, "seq": seq_a},
        "to": {"commit": sha_b, "seq": seq_b},
        "changes": _diff(rec_a, rec_b),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
