"""Requests through ``repro_torch.serve.ServeEngine``: an open loop (due
times from the mix's rate) or a closed loop (each client sends its next
request when its last one ends), stepping the engine as fast as it goes.

The wall time of every token is stamped in ``Request.on_token``, which the
engine calls at the end of the step that emits it.  The traffic starts
``warm_s`` before the window (counted as set-up); the window is then
``seconds`` long.  Per step the driver counts, from the pipeline's state
and the tokens emitted, the prompt rows admitted and the rows decoded, with
their causal contexts, for the FLOP and DSLOT call accounting.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from portbench.harness import check, flops, traffic
from portbench.harness.program import setup_model
from portbench.harness.trace import DeviceTrace, Spans

REQUESTS_PER_CLIENT = 32     # a closed loop's specs; a client sends < 10


class _Admission:
    """Prompt rows each step admitted, from the pipeline's task offsets."""

    def __init__(self):
        self.done: dict[int, int] = {}     # uid -> prompt rows admitted
        self.reqs: dict[int, object] = {}

    def add(self, req) -> None:
        self.done[req.uid] = 0
        self.reqs[req.uid] = req

    def advance(self, eng) -> tuple[int, int, int]:
        """(rows, causal context sum, requests advanced) since the last
        call."""
        offsets = {t.req.uid: t.offset for t in eng.pipeline.active}
        rows = ctx = moved = 0
        for uid in list(self.done):
            req = self.reqs[uid]
            if uid in offsets:
                cur = offsets[uid]
            elif req.phase in ("pending", "new"):
                cur = 0
            else:
                cur = len(req.prompt)
            prev = self.done[uid]
            if cur > prev:
                rows += cur - prev
                ctx += flops.causal_ctx_sum(prev, cur)
                moved += 1
                self.done[uid] = cur
            if cur >= len(req.prompt) or req.phase not in (
                    "pending", "new", "prefilling"):
                del self.done[uid], self.reqs[uid]
        return rows, ctx, moved


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    import torch
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    mix, model_d = cell.traffic, cell.config["model"]
    cuda = device.type == "cuda"
    params, step, model = setup_model(cell, seed, device)
    eng = ServeEngine(model, params, ServeConfig(**mix["serve"]))
    planes = int(cell.config["dslot"]["n_planes"])
    vocab = model_d["vocab_size"]

    # warm-up: one full admission forward (every lane, a whole chunk, and a
    # second chunk) and decode steps, twice, at the cell's own shapes
    chunk = eng.pipeline.chunk or 1
    rng = np.random.default_rng([int(seed), 7])
    for rnd in range(2):
        for lane in range(eng.pipeline.lanes):
            eng.try_add(Request(uid=-1 - rnd * 64 - lane, max_new=3,
                                n_planes=planes,
                                prompt=rng.integers(0, vocab, chunk + 1)
                                .astype(np.int32)))
        eng.drain()
    if cuda:
        torch.cuda.synchronize()

    spans = Spans()
    dtrace = DeviceTrace() if trace else None
    if trace:
        eng._admission_tick = spans.wrap(eng._admission_tick, "admission")
        eng._decode = spans.wrap(eng._decode, "decode forward")
        eng.step = spans.wrap(eng.step, "sampling and host read", outer=True)

    horizon = float(mix.get("warm_s", 0.0)) + seconds
    closed = mix["loop"] == "closed"
    if closed:
        n = int(mix["clients"]) * REQUESTS_PER_CLIENT
    else:
        n = traffic.open_count(mix, horizon)
    specs = traffic.requests(mix, seed, n, vocab)
    recs: dict[int, dict] = {}
    decode = {"rows": 0, "ctx": 0}

    def on_token(req, tok, step_no):
        r = recs[req.uid]
        r["stamps"].append(time.perf_counter())
        decode["rows"] += 1
        decode["ctx"] += r["prompt_len"] + len(req.out)

    adm = _Admission()
    refused = []
    inflight: dict[int, dict] = {}
    next_spec = iter(specs)

    def submit(spec, t_ref):
        req = Request(uid=spec["uid"], prompt=spec["prompt"],
                      max_new=spec["max_new"], n_planes=planes,
                      on_token=on_token)
        recs[req.uid] = dict(t_ref=t_ref, stamps=[], req=req,
                             prompt_len=len(spec["prompt"]), end=None)
        inflight[req.uid] = recs[req.uid]
        if eng.try_add(req):
            adm.add(req)
        else:
            inflight.pop(req.uid)
            refused.append(req.uid)

    steps = []
    if dtrace is not None:
        dtrace.start()      # its start-up lands in the set-up
    t_base = time.perf_counter()
    w0_nominal = t_base + float(mix.get("warm_s", 0.0))
    w0 = None
    due = deque(specs) if not closed else None
    if closed:
        for _ in range(int(mix["clients"])):
            submit(next(next_spec), t_base)
    while True:
        now = time.perf_counter()
        if w0 is None and now >= w0_nominal:
            if cuda:
                torch.cuda.synchronize()
            w0 = time.perf_counter()
            w0_ns = time.time_ns()
            setup_s = w0 - t_start
            live_start = len(eng.live_requests())
        if w0 is not None and now >= w0 + seconds:
            break
        if not closed:
            while due and t_base + due[0]["due"] <= now:
                s = due.popleft()
                submit(s, t_base + s["due"])
        if not eng.live_requests():
            target = w0_nominal if w0 is None else w0 + seconds
            if due:
                target = min(target, t_base + due[0]["due"])
            time.sleep(max(0.0, target - now))
            continue
        f0 = eng.pipeline.forwards
        decode["rows"] = decode["ctx"] = 0
        t0 = time.perf_counter()
        eng.step()
        t1 = time.perf_counter()
        rows, ctx, moved = adm.advance(eng)
        fwd = eng.pipeline.forwards - f0
        # every request that reached an end this step (done, or evicted)
        for uid in [u for u, r in inflight.items() if r["req"].done]:
            inflight.pop(uid)["end"] = t1
            if closed:
                submit(next(next_spec), t1)
        if w0 is not None:
            f = 0.0
            if rows:
                f += flops.decoder_flops(model_d, rows, ctx, max(moved, fwd))
            if decode["rows"]:
                f += flops.decoder_flops(model_d, decode["rows"],
                                         decode["ctx"], decode["rows"])
            steps.append(dict(t0=t0, t1=t1, admit=fwd > 0, flops=f,
                              admit_rows=rows, admit_forwards=fwd,
                              decode_rows=decode["rows"]))
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    t_end_ns = w0_ns + int((t_end - w0) * 1e9)
    if dtrace is not None:
        dtrace.stop()
    window = (w0, w0 + seconds)

    # outcomes: the requests that reached an end in the window
    ended = [r for r in recs.values()
             if r["req"].done and r["end"] is not None
             and window[0] <= r["end"] < window[1]]
    failed = sum(r["req"].phase != "done" for r in ended) + len(refused)
    done = [r for r in ended if r["req"].phase == "done"]
    K, N = model_d["d_model"], model_d["d_ff"]
    calls = []
    for s in steps:
        if s["admit_rows"]:
            fw = max(1, s["admit_forwards"])
            calls.append((s["admit_rows"] / fw, K, N,
                          fw * model_d["n_layers"]))
        if s["decode_rows"]:
            calls.append((s["decode_rows"], K, N, model_d["n_layers"]))
    k = int(mix.get("check", {}).get("sample", 8))
    sample = check.pick(done, k, seed,
                        lambda r: r["prompt_len"] + len(r["req"].out))
    samples = [dict(prompt=r["req"].prompt, served=list(r["req"].out),
                    planes=planes) for r in sample]
    live_end = len(eng.live_requests())
    eng.close()
    out = dict(
        kind="engine", setup_s=setup_s, window=window, seconds=seconds,
        trace_window=(w0, t_end), steps=steps,
        requests=[dict(t_ref=r["t_ref"], stamps=r["stamps"],
                       phase=r["req"].phase, end=r["end"],
                       planes=(r["req"].dslot_stats or {}).get(
                           "planes_used_mean"))
                  for r in recs.values()],
        attempted=len(ended) + len(refused), failed=failed,
        live=(live_start, live_end),
        dslot_calls=calls, w_bytes=flops.weight_bytes(model_d),
        samples=samples, params=params, step=step)
    if dtrace is not None:
        out["trace"] = dtrace.summary(w0_ns, t_end_ns, spans)
    holder = {"eng": eng, "model": model}

    def release():
        holder.clear()
    out["release"] = release
    return out
