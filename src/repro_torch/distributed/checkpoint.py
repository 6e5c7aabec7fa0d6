"""Serving-side fault tolerance: :class:`RequestJournal` persists in-flight
request metadata so a restarted engine can re-enqueue them (a copy of the
reference's ``repro.distributed.checkpoint.RequestJournal``; the training
checkpoint manager is ROADMAP Queue 1 item 7)."""

from __future__ import annotations

import json
import pathlib


class RequestJournal:
    """Append-only journal of in-flight serving requests (crash recovery)."""

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def record_submit(self, request_id: str, adapter_id: str,
                      prompt: tuple, max_new_tokens: int) -> None:
        with self.path.open("a") as f:
            f.write(json.dumps({
                "event": "submit", "rid": request_id, "adapter": adapter_id,
                "prompt": list(prompt), "max_new": max_new_tokens,
            }) + "\n")

    def record_finish(self, request_id: str) -> None:
        with self.path.open("a") as f:
            f.write(json.dumps({"event": "finish", "rid": request_id}) + "\n")

    def replay(self) -> list[dict]:
        """Requests submitted but not finished (to re-enqueue on restart)."""
        if not self.path.exists():
            return []
        pending: dict[str, dict] = {}
        with self.path.open() as f:
            for line in f:
                if not line.strip():
                    continue
                ev = json.loads(line)
                if ev["event"] == "submit":
                    pending[ev["rid"]] = ev
                elif ev["event"] == "finish":
                    pending.pop(ev["rid"], None)
        return list(pending.values())
