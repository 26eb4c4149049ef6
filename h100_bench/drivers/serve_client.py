"""The HTTP client of the serving cells, in a process of its own
(standard library only), so that its work does not share the server's
interpreter lock.

    python3 serve_client.py JOB.json RESULT.json

JOB holds the server's `url`, the warm-up `warmup` (lists of prompts sent
concurrently, one list after the other), `prompts` (one list of prompts a
request, sent in order) and `keep`, the requests whose images come back
in RESULT, and then either

- `due` (an open loop): each request is sent when it is due (seconds from
  the window's start), whatever is in flight, and timed from when it was
  due to the last byte of its response; or
- `concurrency` and `seconds` (a closed loop): that many requests are in
  flight at all times, each sent when one comes back, until `seconds`
  have passed; then nothing more is sent, and the window ends when the
  last answer is in. Each is timed from its send.

After the warm-up the client prints "ready" and waits for a line on
standard input; the window starts when it arrives. RESULT holds each
sent request's status (0: no response within `timeout_s`), latency and
end (seconds from the window's start), how late each was sent, the
window's length `end_s`, and the kept images (base64 PNG).
"""
from __future__ import annotations

import asyncio
import json
import sys
import time
from urllib.parse import urlsplit


async def _post(host: str, port: int, body: bytes, timeout: float):
    """(status, response body) of POST /generate; status 0 on a failure
    to connect or to answer in time."""
    async def exchange():
        reader, writer = await asyncio.open_connection(host, port)
        try:
            writer.write(b"POST /generate HTTP/1.1\r\nHost: %s\r\n"
                         b"Content-Type: application/json\r\n"
                         b"Content-Length: %d\r\nConnection: close\r\n\r\n"
                         % (host.encode(), len(body)) + body)
            await writer.drain()
            data = await reader.read()
        finally:
            writer.close()
        head, _, payload = data.partition(b"\r\n\r\n")
        return int(head.split(b" ", 2)[1]), payload

    try:
        return await asyncio.wait_for(exchange(), timeout)
    except (OSError, asyncio.TimeoutError, ValueError, IndexError):
        return 0, b""


async def _run(job: dict) -> dict:
    url = urlsplit(job["url"])
    host, port = url.hostname, url.port
    timeout = float(job["timeout_s"])
    loop = asyncio.get_running_loop()

    def body(prompts):
        return json.dumps({"prompts": prompts}).encode()

    for burst in job["warmup"]:
        got = await asyncio.gather(*(_post(host, port, body([p]), timeout)
                                     for p in burst))
        bad = [s for s, _ in got if s != 200]
        if bad:
            raise RuntimeError(f"warm-up requests failed: {bad}")
    print("ready", flush=True)
    await loop.run_in_executor(None, sys.stdin.readline)

    prompts = job["prompts"]
    keep = set(job["keep"])
    status, latency, late, ends = {}, {}, {}, {}
    kept = {}
    t0 = loop.time()
    wall0 = time.time()

    async def one(i: int, due: float):
        late[i] = loop.time() - (t0 + due)
        code, payload = await _post(host, port, body(prompts[i]), timeout)
        ends[i] = loop.time() - t0
        latency[i] = ends[i] - due
        status[i] = code
        if code == 200 and i in keep:
            kept[i] = json.loads(payload)["images"]

    if "due" in job:  # open loop
        tasks = []
        for i, due in enumerate(job["due"]):
            await asyncio.sleep(max(0.0, t0 + due - loop.time()))
            tasks.append(asyncio.create_task(one(i, due)))
        await asyncio.gather(*tasks)
    else:  # closed loop
        seconds, nxt = float(job["seconds"]), [0]

        async def worker():
            while loop.time() - t0 < seconds and nxt[0] < len(prompts):
                i = nxt[0]
                nxt[0] += 1
                await one(i, loop.time() - t0)

        await asyncio.gather(*(worker()
                               for _ in range(int(job["concurrency"]))))
    n = len(status)  # requests 0 .. n-1 were sent
    return {"start_wall": wall0, "end_s": loop.time() - t0,
            "status": [status[i] for i in range(n)],
            "latency_s": [latency[i] for i in range(n)],
            "late_s": [late[i] for i in range(n)],
            "end_at_s": [ends[i] for i in range(n)],
            "kept": {str(i): v for i, v in kept.items()}}


def main() -> int:
    with open(sys.argv[1]) as f:
        job = json.load(f)
    result = asyncio.run(_run(job))
    with open(sys.argv[2], "w") as f:
        json.dump(result, f)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
