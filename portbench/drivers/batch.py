"""Offline batches through ``repro_torch.serve.engine.generate``, back to
back (a closed loop of one caller).

``generate`` hands a whole batch back at once, so the window is a whole
number of calls: it starts when the first timed batch starts and ends when
the first batch to finish after ``seconds`` finishes.  Each batch's inputs
are drawn from the seed and the batch's index, on the card, in the served
type: ``frames`` frontend frame embeddings and ``prompt_tokens`` tokens for
the decoder, ``src_tokens`` embeddings for the encoder.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import check, flops
from portbench.harness.program import setup_model
from portbench.harness.trace import DeviceTrace, Spans
from portbench.harness.weights import INPUT_SCALE, Drawer


def make_batch(mix: dict, model_d: dict, seed: int, index: int, device):
    import torch
    dr = Drawer(int(seed) * 1009 + index, device,
                getattr(torch, model_d["dtype"]))
    B, d = int(mix["batch"]), model_d["d_model"]
    batch = {"tokens": torch.randint(0, model_d["vocab_size"],
                                     (B, int(mix["prompt_tokens"])),
                                     generator=dr.gen, device=device)}
    if mix.get("frames"):
        batch["frontend"] = dr.normal((B, int(mix["frames"]), d),
                                       INPUT_SCALE)
    if mix.get("src_tokens"):
        batch["src_embeds"] = dr.normal((B, int(mix["src_tokens"]), d),
                                        INPUT_SCALE)
    return batch


def batch_flops(model_d: dict, mix: dict) -> float:
    B, new = int(mix["batch"]), int(mix["new_tokens"])
    S = int(mix.get("frames", 0)) + int(mix["prompt_tokens"])
    E = int(mix.get("src_tokens", 0))
    f = flops.encoder_flops(model_d, E, B) if E else 0.0
    f += flops.decoder_flops(model_d, B * S, B * flops.causal_ctx_sum(0, S),
                             B, E)
    f += flops.decoder_flops(model_d, B * new,
                             B * flops.causal_ctx_sum(S, S + new), B * new, E)
    return f


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    import torch
    from repro_torch.serve.engine import generate

    mix, model_d = cell.traffic, cell.config["model"]
    cuda = device.type == "cuda"
    params, step, model = setup_model(cell, seed, device)
    prepared = model.prepare_dslot(params)
    new = int(mix["new_tokens"])
    B = int(mix["batch"])
    S = int(mix.get("frames", 0)) + int(mix["prompt_tokens"])
    max_len = S + new

    def call(batch):
        res = generate(model, prepared, batch, new, max_len=max_len)
        toks = res.tokens.cpu()          # the batch is served: host read
        return toks, res
    call(make_batch(mix, model_d, seed, -1, device))       # warm-up
    if cuda:
        torch.cuda.synchronize()

    spans = Spans()
    dtrace = DeviceTrace() if trace else None
    if trace:
        model.prefill = spans.wrap(model.prefill, "prefill")
        model.decode_step = spans.wrap(model.decode_step, "decode forward")
        call = spans.wrap(call, "sampling and host read", outer=True)
        dtrace.start()

    per_batch = int(mix.get("check", {}).get("per_batch", 1))
    rng = np.random.default_rng([int(seed), 11])
    batches, samples = [], []
    if cuda:
        torch.cuda.synchronize()
    w0, w0_ns = time.perf_counter(), time.time_ns()
    setup_s = w0 - t_start
    j = 0
    while True:
        batch = make_batch(mix, model_d, seed, j, device)
        t0 = time.perf_counter()
        toks, res = call(batch)
        t1 = time.perf_counter()
        used = res.planes_used_mean
        batches.append(dict(t0=t0, t1=t1, tokens=int(toks.numel()),
                            decode_steps=new, flops=batch_flops(model_d, mix),
                            planes=None if used is None
                            else [float(v) for v in used.cpu()]))
        for i in rng.choice(B, size=min(per_batch, B), replace=False):
            s = dict(prompt=batch["tokens"][i].cpu().numpy(),
                     served=[int(t) for t in toks[i]],
                     planes=int(cell.config["dslot"]["n_planes"]))
            if "frontend" in batch:
                s["frontend"] = batch["frontend"][i].clone()
            if "src_embeds" in batch:
                s["src"] = batch["src_embeds"][i].clone()
            samples.append(s)
        j += 1
        if t1 - w0 >= seconds:
            break
    t_end = time.perf_counter()
    t_end_ns = w0_ns + int((t_end - w0) * 1e9)
    if dtrace is not None:
        dtrace.stop()
    k = int(mix.get("check", {}).get("sample", 12))
    samples = check.pick(samples, k, seed, lambda s: len(s["served"]))
    K, N, L = model_d["d_model"], model_d["d_ff"], model_d["n_layers"]
    E = int(mix.get("src_tokens", 0))
    calls = []
    for _ in batches:
        if E:
            calls.append((B * E, K, N, model_d["encoder_layers"]))
        calls.append((B * S, K, N, L))
        calls.append((B, K, N, L * new))
    out = dict(
        kind="batch", setup_s=setup_s, window=(w0, batches[-1]["t1"]),
        seconds=batches[-1]["t1"] - w0, trace_window=(w0, t_end),
        batches=batches, attempted=B * len(batches), failed=0,
        dslot_calls=calls, w_bytes=flops.weight_bytes(model_d),
        samples=samples, params=params, step=step,
        requests=[dict(planes=p) for b in batches for p in (b["planes"] or [])])
    if dtrace is not None:
        out["trace"] = dtrace.summary(w0_ns, t_end_ns, spans)
    holder = {"model": model, "prepared": prepared}
    out["release"] = holder.clear
    return out
