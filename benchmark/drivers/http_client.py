"""The open-loop HTTP client, run as its own process: sends each request of
a schedule when it is due, whatever came back before, and records when it
was sent and answered (``time.monotonic``, shared with the server's
process), its status and its results. Prints ``T0 <monotonic>`` once the
window's clock starts."""

from __future__ import annotations

import argparse
import asyncio
import json
import time

KEEP = ("id", "name", "citation", "court", "decision_date")


def _slim(results: list) -> list:
    return [{"case_metadata": {k: r["case_metadata"][k] for k in KEEP}, "score": r["score"],
             "match_type": r["match_type"], "snippet": r["snippet"]} for r in results]


async def main(url: str, schedule: list, timeout: float) -> list:
    import aiohttp

    conn = aiohttp.TCPConnector(limit=0)
    async with aiohttp.ClientSession(base_url=url, connector=conn,
                                     timeout=aiohttp.ClientTimeout(total=timeout)) as c:
        for _ in range(4):
            async with c.get("/health") as r:
                await r.read()
        t0 = time.monotonic() + 0.5
        print(f"T0 {t0!r}", flush=True)

        async def one(i: int, due: float, body: dict):
            await asyncio.sleep(max(0.0, t0 + due - time.monotonic()))
            sent = time.monotonic()
            try:
                async with c.post("/search", json=body) as r:
                    status = r.status
                    # kept as text until the end: parsed replies would load
                    # this process's collector while it sends on time
                    payload = await r.text() if status == 200 else None
            except (aiohttp.ClientError, asyncio.TimeoutError):
                status, payload = -1, None
            done = time.monotonic()
            return [i, due, sent, done, status, payload]

        recs = await asyncio.gather(*(one(i, d, b) for i, (d, b) in enumerate(schedule)))
        for rec in recs:
            rec[5] = _slim(json.loads(rec[5])["results"]) if rec[5] is not None else None
        return recs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", required=True)
    ap.add_argument("--schedule", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=60.0)
    a = ap.parse_args()
    with open(a.schedule) as f:
        sched = json.load(f)
    recs = asyncio.run(main(a.url, sched, a.timeout))
    with open(a.out, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
